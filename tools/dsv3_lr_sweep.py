"""Train the train_dsv3 cell for 10 steps at several peak learning rates.

    python3 tools/dsv3_lr_sweep.py [--lr 1e-3 2.2e-4 1e-4 3e-5 1e-5 3e-6]
                                   [--plain-attention]

The cell is ``chip_smoke.py``'s phase 20: DeepSeek-V3 at its published
widths in bf16 with f32 AdamW moments, cut to its 3 dense layers plus the
MTP head, 2 sequences of 4,096 tokens a step from ``lm_token_stream``,
seeded weights.  For each peak rate (warm-up 5 steps, cosine to step 10,
as train_4k's schedule), and once for DeepSeek-V3's published schedule
(2.2e-4 reached after 2,000 warm-up steps), it prints one JSON line: the
10 losses, the gradient norms before clipping, and the loss of the first
step's batch after the 10 steps (``first_batch_after``).  With
``--plain-attention`` the kernels run their plain versions
(``chip_smoke._plain_kernels``; the cell's kernels are flash_attn's
forward and backward, whose plain versions here take 256 queries a chunk
so the score chunks fit beside the cell's 74 GB), so the two paths'
curves can be held side by side.  ``train_cell`` is one such run, which
``tools/flash_attn_bwd_ab.py`` times.  Needs one CUDA card and about 15 s
a rate (about 45 s with ``--plain-attention``).
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def train_cell(lr: float, warmup: int, steps: int, plain: bool = False):
    """Train the cell ``steps`` steps from seed 22 on ``lm_token_stream``
    seed 1 at peak rate ``lr`` after ``warmup`` warm-up steps, through
    the kernels or (``plain``) their plain versions.  Returns the
    trainer's record of each step (loss, grad_norm, secs) and the loss of
    the first step's batch after the steps.  Imports the port from
    ``sys.path``."""
    import torch
    from chip_smoke import _plain_kernels
    from repro_torch.configs import get_config
    from repro_torch.data import lm_token_stream
    from repro_torch.models import init_lm_params, lm_loss
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import Trainer, TrainerConfig

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("deepseek-v3-671b").model,
                              n_layers=3)

    def loss_fn(m, b):
        return lm_loss(m, torch.as_tensor(b["tokens"], device=dev),
                       torch.as_tensor(b["labels"], device=dev))

    first = next(lm_token_stream(cfg.vocab, 2, 4096, seed=1, n_steps=1))
    with _plain_kernels(plain, q_chunk=256):
        gen = torch.Generator(device=dev)
        gen.manual_seed(22)
        model = init_lm_params(gen, cfg, device=dev)
        tr = Trainer(loss_fn, model,
                     AdamWConfig(lr=lr, warmup_steps=warmup,
                                 total_steps=max(steps, warmup)),
                     TrainerConfig(ckpt_dir=os.path.join(
                         ROOT, "build", "lr_sweep_ckpt"), ckpt_every=1 << 30,
                         log_every=steps))
        data = lm_token_stream(cfg.vocab, 2, 4096, seed=1)
        hist = [tr.train_step(next(data)) for _ in range(steps)]
        with torch.no_grad():
            after = float(loss_fn(model, first))
    del model, tr
    gc.collect()
    torch.cuda.empty_cache()
    return hist, after


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--lr", type=float, nargs="+",
                    default=[1e-3, 2.2e-4, 1e-4, 3e-5, 1e-5, 3e-6])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--plain-attention", action="store_true")
    args = ap.parse_args(argv)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    schedules = [(lr, 5) for lr in args.lr] + [(2.2e-4, 2000)]
    for lr, warmup in schedules:
        hist, after = train_cell(lr, warmup, args.steps, args.plain_attention)
        print(json.dumps(dict(
            lr=lr, warmup_steps=warmup, plain_attention=args.plain_attention,
            losses=[h["loss"] for h in hist],
            grad_norm=[h["grad_norm"] for h in hist],
            first_batch_after=after)), flush=True)


if __name__ == "__main__":
    main()
