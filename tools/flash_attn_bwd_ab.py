"""Time flash_attn's backward kernels of one source tree on the card.

    python3 tools/flash_attn_bwd_ab.py [--src DIR] [--tag TAG]

Imports the port from ``--src`` (default: this checkout's ``src``; give
an unpacked older commit's ``src`` to time it in the same call, parent,
change, change, parent) and, through that tree:

- runs chip_smoke's timed backward case (``_flash_bwd_case``, with which
  phases 12 and 20 time their rows; here ``ITERS`` launches a kernel
  after one) at train_dsv3's shape (bf16, B = 2, S = 4,096, H = Hk = 128,
  D = 192, Dv = 128, causal), at train_4k's (bf16, B = 4, S = 4,096, H =
  Hk = 16, D = 128, causal) and at train_4k's tokens and width in heads
  of 64 (H = Hk = 32, D = Dv = 64: the (64, 64) instantiation, which no
  main path runs).  Each prints chip_smoke's row under the phase
  "flash_attn_bwd_ab:TAG": each kernel's ms (``kernel_ms``), the three
  together (``bwd_ms``), SDPA's backward (``library_ms``), the gradients
  held against the plain backward (``ratio``) and two calls bit-equal;
- trains the train_dsv3 cell for 10 steps (``dsv3_lr_sweep.train_cell``
  at chip_smoke's MLA_TRAIN_LR) and prints, under the same phase, each
  step's ms and loss, their median ms (``step_ms_p50``), and the
  compiler's register, shared-memory and spill lines of the tree's
  backward library (``ptxas``).

The inputs are drawn on the card from seed 29 and go through the tree's
own forward kernel for ``o`` and ``lse``.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ITERS = 20
# name -> (B, S, H, Hk, D, Dv), causal bf16
SHAPES = {"train_dsv3": (2, 4096, 128, 128, 192, 128),
          "train_4k": (4, 4096, 16, 16, 128, 128),
          "d64": (4, 4096, 32, 32, 64, 64)}
STEPS = 10


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        print("flash_attn_bwd_ab: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path[:0] = [os.path.abspath(args.src), ROOT]
    from chip_smoke import MLA_TRAIN_LR, _flash_bwd_case
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attn import kernel
    from tools.dsv3_lr_sweep import train_cell
    phase = f"flash_attn_bwd_ab:{args.tag}"
    gen = torch.Generator(device="cuda")
    gen.manual_seed(29)
    for name, (B, S, H, Hk, D, Dv) in SHAPES.items():
        _flash_bwd_case(phase, gen, name, B, S, S, H, Hk, D, "bfloat16",
                        timed=True, iters=ITERS, Dv=Dv)
    hist, _ = train_cell(MLA_TRAIN_LR, 5, STEPS)
    step_ms = [h["secs"] * 1e3 for h in hist]
    log = build.library_path(kernel.BWD_SOURCE).with_suffix(".log")
    ptxas = ([ln.strip() for ln in log.read_text().splitlines()
              if any(w in ln for w in ("entry function", "registers",
                                       "spill"))]
             if log.is_file() else [])
    print(json.dumps(dict(
        phase=phase, src=args.src, card=torch.cuda.get_device_name(0),
        step_ms=step_ms, step_ms_p50=statistics.median(step_ms),
        losses=[h["loss"] for h in hist], ptxas=ptxas)), flush=True)


if __name__ == "__main__":
    main()
