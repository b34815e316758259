"""Training launcher: ``python -m repro_torch.launch.train --arch
qwen1.5-0.5b --steps 200``.

Trains the chosen LM on the deterministic token stream with the whole
stack: AdamW with its schedule, asynchronous atomic checkpoints, the
fault-tolerant run loop, optional int8 error-feedback compression.  By
default a reduced config (``--reduced``); ``--full`` takes the published
one, and ``--n-layers`` / ``--d-model`` cut it, as
``--full --arch olmoe-1b-7b --n-layers 4 --batch 4 --seq 4096`` cuts
OLMoE-1B-7B to fit one 80 GB card.  It runs on the card unless
``--device cpu`` is given.  The reference's launcher,
``python -m repro.launch.train``, takes the same flags but ``--device``.
"""
from __future__ import annotations

import argparse
import dataclasses
import os


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="use the smoke-test reduced config (CPU-sized)")
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: build/ckpt/train beside the package")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-keep", type=int, default=0,
                    help="newest checkpoints to keep (0: all)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "int8_ef"])
    ap.add_argument("--d-model", type=int, default=0,
                    help="override width (e.g. ~100M model: 768)")
    ap.add_argument("--n-layers", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)
    # cuBLAS is deterministic on one stream with a fixed workspace; set it
    # before the first product so the trainer's deterministic step holds
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    import torch

    from repro_torch.configs import get_config, get_reduced
    from repro_torch.data import Prefetcher, lm_token_stream
    from repro_torch.device import resolve_device
    from repro_torch.models import init_lm_params, lm_loss
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import Trainer, TrainerConfig
    from repro_torch.runtime.trainer import DEFAULT_CKPT_DIR

    cfg = (get_reduced(args.arch) if args.reduced
           else get_config(args.arch).model)
    if cfg.family != "lm":
        raise SystemExit(f"train.py drives LM archs, not {args.arch!r}")
    over = {}
    if args.d_model:
        over["d_model"] = args.d_model
    if args.n_layers:
        over["n_layers"] = args.n_layers
    if over:
        cfg = dataclasses.replace(cfg, **over)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = init_lm_params(gen, cfg, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[train] arch={args.arch} layers={cfg.n_layers} d={cfg.d_model} "
          f"params={n_params / 1e6:.1f}M device={dev}"
          + (f" ({torch.cuda.get_device_name(dev)})"
             if dev.type == "cuda" else ""))

    def loss_fn(m, b):
        return lm_loss(m, torch.as_tensor(b["tokens"], device=dev),
                       torch.as_tensor(b["labels"], device=dev))

    opt = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                      total_steps=args.steps)
    tcfg = TrainerConfig(
        ckpt_dir=args.ckpt_dir or os.path.join(DEFAULT_CKPT_DIR, "train"),
        ckpt_every=args.ckpt_every, ckpt_keep=args.ckpt_keep,
        grad_compression=args.grad_compression)
    tr = Trainer(loss_fn, model, opt, tcfg)
    if args.resume and tr.restore():
        print(f"[train] resumed from step {tr.step}")
    data = Prefetcher(lm_token_stream(cfg.vocab, args.batch, args.seq,
                                      seed=1))
    hist = tr.run(data, args.steps)
    print(f"[train] done: loss {hist[0]['loss']:.4f} -> "
          f"{hist[-1]['loss']:.4f} median step "
          f"{1e3 * sorted(h['secs'] for h in hist)[len(hist)//2]:.0f}ms")
    tr.save(blocking=True)


if __name__ == "__main__":
    main()
