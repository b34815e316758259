"""Production-mesh dry-run of the port: for every (arch x shape) cell on
the (16, 16) and (2, 16, 16) meshes, the argument plan and a shape check
of the step, on no device.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both
  python -m repro_torch.launch.dryrun --list

For each cell and mesh it builds the mesh over a fake process group of
256 or 512 ranks in this process (``mesh.plan_world``), places every
argument leaf (``specs.build_cell``'s placements, DTensor over meta
tensors) and records rank 0's exact argument bytes, split into params,
optimizer state, inputs and cache.

The step check runs the cell's step once at the cell's **global** shapes
on the ``meta`` device (no storage; the kernel wrappers run their plain
versions, which compute shapes alone) for every LM cell: training is
forward, backward and the AdamW update, serving the prefill or decode
step.  ``FlopCounterMode`` counts that global step's flops beside
``meta["model_flops"]``; the count is the plain versions' (the causal
attention counted whole) and not a per-device figure.  A step that reads
data on the host cannot run on meta: its record says ``"host-data"`` and
names the op.  The step is the same on both meshes, so a run checks it
once per cell and copies the result.

The reference's collective bytes come from XLA's partitioner; the port
runs no sharded step, so ``collectives`` is null, with the reason.

Artifacts: ``$DRYRUN_ARTIFACTS`` (default ``experiments/artifacts_torch/``),
one JSON per cell and mesh.  A failed cell is recorded with
``ok: false`` and makes the run exit 1.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

from repro_torch.configs import all_cells, get_config
from repro_torch.launch.mesh import (MULTI_POD, SINGLE_POD,
                                     make_production_mesh, plan_world)
from repro_torch.launch.specs import arg_bytes, build_cell

ARTIFACT_DIR = os.environ.get(
    "DRYRUN_ARTIFACTS",
    os.path.join(os.path.dirname(__file__), "../../../experiments/artifacts_torch"))
MESH_RANKS = {"single": 256, "multi": 512}
NO_COLLECTIVES = ("the port runs no sharded step (no TP/FSDP step over "
                  "DTensor), so no partitioner counts its collectives")
# the op of each host-data step that reads the data and so cannot run on
# the meta device
HOST_DATA_OPS = {
    "gnn": "GraphBatch.plan: segment_plan's bincount of edge_dst (its "
           "length) and its count of hub rows are read on the host",
    "din_train": "TableGather.backward: torch.unique of the looked-up "
                 "ids (a size that depends on the data)",
}


def _dump(path: str, rec: dict) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)


def _gib(n: int) -> str:
    return f"{n / 2**30:.2f} GiB"


def step_check(cell) -> dict:
    """Run ``cell.fn`` once on its meta arguments under
    ``FlopCounterMode``: ``{"step_check": "ok", "step_s", "flops_global_step"}``,
    or ``{"step_check": "host-data", "host_data_op"}`` for a step that
    reads data on the host."""
    cfg = get_config(cell.arch).model
    if cfg.family == "gnn":
        return dict(step_check="host-data", host_data_op=HOST_DATA_OPS["gnn"])
    if cfg.family == "recsys" and get_config(cell.arch).shape(
            cell.shape).kind == "train":
        return dict(step_check="host-data",
                    host_data_op=HOST_DATA_OPS["din_train"])
    from torch.utils.flop_counter import FlopCounterMode
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc:
        cell.fn(*cell.arg_specs)
    return dict(step_check="ok", step_s=time.perf_counter() - t0,
                flops_global_step=int(fc.get_total_flops()))


def plan_cell(arch: str, shape: str, mesh_kind: str,
              variant: str = "baseline"):
    """``(cell, record)``: the cell built on the production mesh inside
    its fake world, and the argument plan's record."""
    multi = mesh_kind == "multi"
    t0 = time.perf_counter()
    with plan_world(MESH_RANKS[mesh_kind]):
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
        cell = build_cell(arch, shape, mesh, variant=variant)
        nbytes = arg_bytes(cell)
    shape_, axes = MULTI_POD if multi else SINGLE_POD
    rec = dict(arch=arch, shape=shape, mesh=mesh_kind, variant=variant,
               mesh_shape=list(shape_), mesh_axes=list(axes),
               n_devices=MESH_RANKS[mesh_kind],
               plan_s=time.perf_counter() - t0,
               arg_bytes_per_device=nbytes,
               n_leaves=sum(1 for _ in cell.leaves()),
               collectives=None, collectives_reason=NO_COLLECTIVES,
               meta={k: (int(v) if isinstance(v, (int, float)) else v)
                     for k, v in cell.meta.items()})
    return cell, rec


def run_cell(arch: str, shape: str, mesh_kind: str,
             variant: str = "baseline", checked: dict | None = None) -> dict:
    """The record of one cell on one mesh, written to the artifact
    directory.  ``checked`` keeps each cell's step check for the other
    mesh."""
    cell, rec = plan_cell(arch, shape, mesh_kind, variant)
    key = (arch, shape, variant)
    if checked is not None and key in checked:
        rec.update(checked[key], step_check_copied=True)
    else:
        res = step_check(cell)
        if checked is not None:
            checked[key] = res
        rec.update(res)
    rec["ok"] = True
    suffix = "" if variant == "baseline" else f"_{variant}"
    _dump(os.path.join(ARTIFACT_DIR,
                       f"dryrun_{arch}_{shape}_{mesh_kind}{suffix}.json"), rec)
    step = rec["step_check"]
    if step == "ok":
        step = (f"step ok {rec['step_s']:.1f}s flops(global step) "
                f"{rec['flops_global_step']:.3e}")
    print(f"[dryrun] {arch} x {shape} x {mesh_kind} [{variant}]: OK "
          f"plan {rec['plan_s']:.2f}s args/dev "
          f"{_gib(rec['arg_bytes_per_device']['total'])} "
          f"({rec['arg_bytes_per_device']['total']} B) {step}",
          flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--variant", default="baseline",
                    choices=["baseline", "opt", "opt2", "opt3"])
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)

    if args.list:
        for a, s in all_cells():
            print(f"{a:20s} {s}")
        return 0
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = all_cells() if args.all else [(args.arch, args.shape)]
    failures = []
    checked: dict = {}
    for arch, shape in cells:
        for mk in meshes:
            try:
                run_cell(arch, shape, mk, variant=args.variant,
                         checked=checked)
            except Exception as e:  # noqa: BLE001 — record and continue
                traceback.print_exc()
                failures.append((arch, shape, mk, str(e)))
                suffix = ("" if args.variant == "baseline"
                          else f"_{args.variant}")
                _dump(os.path.join(
                    ARTIFACT_DIR, f"dryrun_{arch}_{shape}_{mk}{suffix}.json"),
                    dict(arch=arch, shape=shape, mesh=mk,
                         variant=args.variant, ok=False, error=str(e)))
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        return 1
    print("\nall dry-runs passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
