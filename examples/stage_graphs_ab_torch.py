"""RADS on the card with its stages as CUDA graphs against the same stages
run eagerly, timed in turns: the full cell of ``chip_smoke.py`` (q1 on
``powerlaw_graph(310000, 6, seed=1)``, 8-way bfs, the default
``EngineConfig``: dense, raw wire, cache on, depth 2).

    PYTHONPATH=src python examples/stage_graphs_ab_torch.py [--n 310000]

A discarded eager call first (the first run in a process pays for
PyTorch's lazy set-up), then the turns eager, graphed, graphed, eager.
Each turn keeps one runner through ``runner_cache`` for ``--calls``
calls: the first captures the stages (graphed) or runs them cold, the
second starts from the capacities the first escalated to, the third
replays what the second left.  Prints one JSON line per call (wall
seconds, peak memory, captures, ``compile_s``, waves) and the card's
name and power limit.  The eager runner is ``StageRunner(eager=True)``,
put into ``runner_cache`` under the driver's key for the call.
"""
import argparse
import gc
import json
import os
import subprocess
import time

os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import torch  # noqa: E402

from repro_torch.configs.rads import DEFAULT_ENGINE, QUERIES  # noqa: E402
from repro_torch.core import Pattern, rads_enumerate  # noqa: E402
from repro_torch.core.cache import build_cache  # noqa: E402
from repro_torch.core.engine import build_plan_data  # noqa: E402
from repro_torch.core.exchange import Exchange  # noqa: E402
from repro_torch.core.plan import best_plan  # noqa: E402
from repro_torch.core.scheduler import StageRunner  # noqa: E402
from repro_torch.graph import partition, powerlaw_graph  # noqa: E402
from repro_torch.graph.storage import device_graph  # noqa: E402


def eager_runner_cache(pg, pat, cfg) -> dict:
    """A ``runner_cache`` whose runner, under the driver's key for this
    call, dispatches the stages eagerly."""
    exch = Exchange("sim", wire_format=cfg.wire_format)
    g = device_graph(pg, cfg.storage_format, "cuda")
    runner = StageRunner(g, build_plan_data(best_plan(pat, cfg.plan_rho)),
                         cfg, exch, cache=build_cache(cfg, g), eager=True)
    return {("sim", id(pg), pat, cfg, None, str(torch.device("cuda"))):
            (pg, None, runner)}


def turn(pg, pat, cfg, mode: str, label, calls: int) -> None:
    rc = eager_runner_cache(pg, pat, cfg) if mode == "eager" else {}
    for call in range(calls):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = rads_enumerate(pg, pat, cfg, return_embeddings=False,
                             runner_cache=rc, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if len(rc) != 1:
            raise SystemExit("the eager runner's key is not the driver's")
        st = res.stats
        print(json.dumps(dict(
            turn=label, mode=mode, call=call + 1, wall_s=wall,
            peak_bytes=torch.cuda.max_memory_allocated(), count=res.count,
            captures=st["compiles"], compile_s=st["compile_s"],
            n_waves=st["n_waves"], cap_escalations=st["cap_escalations"])),
            flush=True)
    del rc, res
    gc.collect()
    torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=310_000)
    ap.add_argument("--calls", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(json.dumps(dict(device=smi.stdout.strip(),
                          torch=torch.__version__)), flush=True)
    pg = partition(powerlaw_graph(args.n, 6, seed=1), 8, method="bfs")
    pat = Pattern.from_edges(QUERIES["q1"])
    turn(pg, pat, DEFAULT_ENGINE, "eager", "discarded", 1)
    for i, mode in enumerate(("eager", "graphed", "graphed", "eager")):
        turn(pg, pat, DEFAULT_ENGINE, mode, i, args.calls)


if __name__ == "__main__":
    main()
