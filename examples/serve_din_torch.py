"""Serve a DIN CTR model with batched requests on the PyTorch port: brief
training on the planted-signal stream, then batched online scoring +
top-k retrieval against a candidate set — the recsys serving shapes in
miniature.  Step for step ``examples/serve_din.py``.

    PYTHONPATH=src python examples/serve_din_torch.py [--device cpu]

Runs on the card unless ``--device cpu`` is given.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_reduced
from repro_torch.data import din_batch_stream
from repro_torch.models import (DINBatch, DINModel, din_logits, init_din,
                                retrieval_scores)
from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state

TRAIN_STEPS = 300
N_CANDIDATES = 100_000


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(cfg, device: torch.device, steps: int = TRAIN_STEPS):
    """``steps`` AdamW steps on batches of 256 from the stream: the model
    (gradients off again) and each step's loss."""
    gen = torch.Generator(device=device).manual_seed(0)
    model = DINModel(cfg, init_din(gen, cfg, device)).requires_grad_(True)
    params = dict(model.named_parameters())
    opt = AdamWConfig(lr=2e-3, warmup_steps=10, total_steps=steps,
                      weight_decay=0.0)
    state = init_opt_state(params, opt)
    stream = din_batch_stream(cfg.n_items, cfg.n_cates, cfg.n_user_feats,
                              batch=256, seq_len=cfg.seq_len, seed=0,
                              n_steps=steps)
    losses = []
    for i, d in enumerate(stream):
        loss = model.loss(DINBatch.from_arrays(d, device))
        grads = torch.autograd.grad(loss, list(params.values()))
        adamw_update(params, dict(zip(params, grads)), state, opt)
        losses.append(float(loss.detach()))
        if i == 0 or (i + 1) % 100 == 0:
            print(f"train step {i+1}: loss {losses[-1]:.4f}")
    return model.requires_grad_(False), losses


def scoring_batch(cfg, device: torch.device) -> DINBatch:
    return DINBatch.from_arrays(next(iter(din_batch_stream(
        cfg.n_items, cfg.n_cates, cfg.n_user_feats, batch=512,
        seq_len=cfg.seq_len, seed=999))), device)


def serve_auc(model: DINModel, test: DINBatch) -> float:
    """Batched online scoring (serve_p99's shape in miniature): the AUC
    of the click probabilities on ``test``."""
    t0 = time.perf_counter()
    scores = torch.sigmoid(din_logits(model.params, model.cfg, test))
    _sync(test.labels.device)
    lat = (time.perf_counter() - t0) * 1e3
    scores, labels = scores.float().cpu().numpy(), test.labels.cpu().numpy()
    pos, neg = scores[labels > 0.5], scores[labels < 0.5]
    auc = (float((pos[:, None] > neg[None, :]).mean())
           if len(pos) and len(neg) else 0.5)
    print(f"serve: batch={len(labels)} in {lat:.1f}ms | AUC {auc:.3f}")
    return auc


def retrieve(model: DINModel, test: DINBatch, k: int = 10):
    """Retrieval: the first user of ``test`` scored against
    N_CANDIDATES candidates in one product, and the top ``k`` as
    ``(scores, ids)``."""
    user = DINBatch(**{f: t[:1] for f, t in vars(test).items()})
    cfg, device = model.cfg, test.labels.device
    cand = torch.arange(N_CANDIDATES, device=device) % cfg.n_items
    t0 = time.perf_counter()
    sc = retrieval_scores(model.params, cfg, user, cand, cand % cfg.n_cates)
    top = torch.topk(sc[0].float(), k)
    _sync(device)
    print(f"retrieval: {N_CANDIDATES // 1000}k candidates scored + "
          f"top-{k} in {(time.perf_counter()-t0)*1e3:.1f}ms; top ids "
          f"{np.asarray(top.indices.cpu())[:5]}")
    return top.values, top.indices


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    device = torch.device(ap.parse_args(argv).device)
    cfg = get_reduced("din")
    model, _ = train(cfg, device)
    test = scoring_batch(cfg, device)
    if not serve_auc(model, test) > 0.65:
        raise SystemExit("CTR model failed to learn the planted signal")
    retrieve(model, test)


if __name__ == "__main__":
    main()
