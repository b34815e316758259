"""Train the DIN example's recipe and read its AUC on several scoring
batches.

    PYTHONPATH=src python tools/din_auc_seeds.py [--device cpu] \
        [--steps 300 3000] [--seeds 999 1000 1001 1002]

``examples/serve_din_torch.py`` trains reduced DIN for 300 AdamW steps
(lr 2e-3, warm-up 10, no decay, batches of 256 from ``din_batch_stream``
with seed 0) and checks the AUC of one 512-row batch (seed 999) against
0.65.  For each step count this trains the same recipe (the cosine
schedule stretched to the count) and prints one JSON line: the last
loss, the label rate's entropy on the scoring batches (the loss of
predicting the base rate alone) and the AUC on each scoring seed.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os

import numpy as np
import torch

EXAMPLE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples", "serve_din_torch.py")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--steps", type=int, nargs="+", default=[300, 3000])
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=[999, 1000, 1001, 1002])
    args = ap.parse_args(argv)
    spec = importlib.util.spec_from_file_location("serve_din_torch", EXAMPLE)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    from repro_torch.configs import get_reduced
    from repro_torch.data import din_batch_stream
    from repro_torch.models import DINBatch

    cfg, device = get_reduced("din"), torch.device(args.device)
    batches = [DINBatch.from_arrays(next(din_batch_stream(
        cfg.n_items, cfg.n_cates, cfg.n_user_feats, batch=512,
        seq_len=cfg.seq_len, seed=s)), device) for s in args.seeds]
    rate = float(np.mean([b.labels.float().mean().item() for b in batches]))
    entropy = -(rate * math.log(rate) + (1 - rate) * math.log(1 - rate))
    for steps in args.steps:
        model, losses = ex.train(cfg, device, steps)
        aucs = {s: ex.serve_auc(model, b) for s, b in zip(args.seeds,
                                                          batches)}
        print(json.dumps(dict(steps=steps, last_loss=losses[-1],
                              base_rate_entropy=entropy, auc=aucs)),
              flush=True)


if __name__ == "__main__":
    main()
