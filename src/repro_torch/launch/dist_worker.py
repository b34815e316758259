"""Per-process worker and local launcher for the ``dist`` exchange backend.

One OS process per graph partition, joined by ``torch.distributed``:

``python -m repro_torch.launch.dist_worker --coordinator HOST:PORT \
    --num-processes N --process-id I --dataset dblp_bench --query q1``

Every process loads the same deterministic dataset, computes the same
partition, and runs :func:`repro_torch.core.driver.rads_enumerate` with
``mode="dist"``: rank ``I`` holds machine ``I``'s adjacency, cache and
frontier, and the fetchV/verifyE exchanges are ``all_to_all_single`` calls
between the processes.  The finalize is replicated, so every rank returns
the same count and logical stats; each writes its stats JSON to ``--out``
and :func:`launch_local` hands the payloads back for
:func:`repro_torch.core.driver.merge_process_stats`, which checks that
identity.

``--device cuda`` (the default) puts rank ``I`` on ``cuda:{I % count}``,
so several ranks may share one card; ``--device cpu`` runs the plain
PyTorch path.  ``--backend gloo`` (the default) moves CUDA tensors through
the host, and works with ranks sharing a card.  ``--backend nccl`` needs a
card per rank and is refused otherwise; it has not been run (the port
has run on one-card machines only).

Exit code ``3`` (:data:`EXIT_BOOTSTRAP_UNAVAILABLE`) means that this
PyTorch build has no ``torch.distributed`` or no such backend.

:func:`launch_local` spawns N workers against a coordinator on a free
localhost port: the same flags drive a launch with one command per host.
"""
from __future__ import annotations

import datetime
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

# exit code contract with launch_local: "cannot run here"
EXIT_BOOTSTRAP_UNAVAILABLE = 3
# a rank waits at most this long in a collective: a hang fails the run
# instead of waiting out the 30-minute default
PG_TIMEOUT = datetime.timedelta(minutes=5)


def dist_available(backend: str = "gloo") -> bool:
    """Does this PyTorch build have ``torch.distributed`` and ``backend``?"""
    import torch.distributed as dist
    if not dist.is_available():
        return False
    return (dist.is_gloo_available() if backend == "gloo"
            else dist.is_nccl_available())


def build_argparser():
    import argparse

    ap = argparse.ArgumentParser(
        description="one process of a multi-process dist enumeration run")
    ap.add_argument("--coordinator", default="127.0.0.1:29500",
                    help="HOST:PORT of the process group's store (process 0 "
                         "binds it; all processes dial it)")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--dataset", default="dblp_bench")
    ap.add_argument("--query", default="q1")
    ap.add_argument("--partition", default="bfs",
                    choices=["bfs", "block", "hash"])
    ap.add_argument("--storage", default="dense",
                    choices=["dense", "bucketed"],
                    help="on-device adjacency format")
    ap.add_argument("--wire", default="raw",
                    choices=["raw", "varint", "auto"])
    ap.add_argument("--no-cache", action="store_true",
                    help="disable the foreign-adjacency cache")
    ap.add_argument("--comm-pipeline", action="store_true",
                    help="chunked back-to-back sub-exchanges per a2a")
    ap.add_argument("--comm-chunks", type=int, default=4)
    # engine capacities (0 = EngineConfig's default): callers pass these to
    # run an in-process sim run of the same configuration beside
    ap.add_argument("--frontier-cap", type=int, default=0,
                    help="0 = EngineConfig default")
    ap.add_argument("--fetch-cap", type=int, default=0)
    ap.add_argument("--verify-cap", type=int, default=0)
    ap.add_argument("--region-budget", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (rank i on cuda:{i %% device_count}) or cpu")
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"],
                    help="torch.distributed backend (nccl: a card per rank)")
    ap.add_argument("--out", default="",
                    help="write {count, wall_s, stats, ...} JSON here")
    ap.add_argument("--trace", default="",
                    help="write this process's Chrome trace-event JSON "
                         "(pid = rank; with >1 process the rank is inserted "
                         "before the extension: out.json -> out.p0.json)")
    ap.add_argument("--metrics-out", default="",
                    help="export this process's metrics registry (*.prom = "
                         "Prometheus textfile, else JSON; per-process path "
                         "as for --trace)")
    return ap


def _per_process_path(path: str, process_id: int, nproc: int) -> str:
    """launch_local hands every worker the same arguments, so per-process
    artifact paths derive from the shared one: ``t.json -> t.p2.json``."""
    if nproc <= 1:
        return path
    root, ext = os.path.splitext(path)
    return f"{root}.p{process_id}{ext or '.json'}"


def worker_config(args):
    """The EngineConfig a worker invocation resolves to, for in-process
    ``sim`` runs of the same configuration."""
    import dataclasses

    from repro_torch.configs.rads import DEFAULT_ENGINE

    cfg = dataclasses.replace(DEFAULT_ENGINE,
                              storage_format=args.storage,
                              wire_format=args.wire,
                              enable_cache=not args.no_cache,
                              comm_pipeline=args.comm_pipeline,
                              comm_chunks=args.comm_chunks)
    caps = dict(frontier_cap=args.frontier_cap, fetch_cap=args.fetch_cap,
                verify_cap=args.verify_cap,
                region_group_budget=args.region_budget)
    return dataclasses.replace(
        cfg, **{k: v for k, v in caps.items() if v})


def rank_device(device: str, rank: int):
    """The rank's torch device: ``cuda:{rank % device_count}`` or the
    CPU; raises if CUDA was asked for and there is none."""
    import torch

    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def kernel_launches() -> dict:
    """The RADS kernels' launch counts in this process."""
    from repro_torch.kernels.intersect import ops as inter
    from repro_torch.kernels.membership import ops as memb
    from repro_torch.kernels.varint import ops as varint

    return {"membership": memb.launches, "intersect": inter.launches,
            "varint": varint.launches}


def main(argv=None) -> int:
    ap = build_argparser()
    args = ap.parse_args(argv)
    if not dist_available(args.backend):
        print(f"[dist] torch.distributed with {args.backend} is not "
              f"available in this build", file=sys.stderr)
        return EXIT_BOOTSTRAP_UNAVAILABLE

    import torch
    import torch.distributed as dist

    dev = rank_device(args.device, args.process_id)
    if args.backend == "nccl" and (
            dev.type != "cuda"
            or torch.cuda.device_count() < args.num_processes):
        ap.error("--backend nccl needs a card per rank; use gloo to share "
                 "a card or to run on the CPU")
    dist.init_process_group(args.backend,
                            init_method=f"tcp://{args.coordinator}",
                            world_size=args.num_processes,
                            rank=args.process_id, timeout=PG_TIMEOUT)
    try:
        return _run(args, dev)
    finally:
        dist.destroy_process_group()


def _run(args, dev) -> int:
    import torch

    from repro_torch.configs.rads import CLIQUE_QUERIES, QUERIES
    from repro_torch.core import Pattern, rads_enumerate
    from repro_torch.graph import load_dataset, partition

    pattern = Pattern.from_edges({**QUERIES, **CLIQUE_QUERIES}[args.query])
    g = load_dataset(args.dataset)          # deterministic: identical on
    pg = partition(g, args.num_processes,   # every process by construction
                   method=args.partition)
    cfg = worker_config(args)
    tracer = None
    if args.trace:
        from repro_torch.obs import TraceRecorder

        tracer = TraceRecorder(pid=args.process_id)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    launches0 = kernel_launches()
    t0 = time.perf_counter()
    res = rads_enumerate(pg, pattern, cfg, mode="dist",
                         return_embeddings=False, tracer=tracer, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall_s = time.perf_counter() - t0
    launches = {k: v - launches0[k] for k, v in kernel_launches().items()}
    payload = dict(count=int(res.count), wall_s=wall_s,
                   process_id=args.process_id,
                   num_processes=args.num_processes,
                   dataset=args.dataset, query=args.query,
                   device=str(dev), backend=args.backend,
                   max_memory_allocated=(
                       torch.cuda.max_memory_allocated(dev)
                       if dev.type == "cuda" else None),
                   launches=launches, stats=res.stats)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(payload, f, default=float)
    if tracer is not None:
        tracer.save(_per_process_path(args.trace, args.process_id,
                                      args.num_processes))
    if args.metrics_out:
        mpath = _per_process_path(args.metrics_out, args.process_id,
                                  args.num_processes)
        if mpath.endswith(".prom"):
            res.registry.export_prometheus(mpath)
        else:
            res.registry.export_json(mpath)
    print(f"[dist] p{args.process_id}/{args.num_processes} {dev} "
          f"{args.dataset}/{args.query}: count={res.count} "
          f"wall={wall_s:.2f}s wire="
          f"{res.stats['bytes_wire_fetch'] + res.stats['bytes_wire_verify']:.0f}B | "
          + res.registry.summary(("wall_us", "comm_pipeline")))
    return 0


# --------------------------------------------------------------------------- #
# Local multi-process launcher
# --------------------------------------------------------------------------- #
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _src_dir() -> str:
    import repro_torch

    return os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))


def launch_local(nproc: int, worker_args: list[str],
                 timeout_s: float = 1200.0) -> list[dict] | None:
    """Run one ``dist`` enumeration across ``nproc`` local subprocesses
    (``python -m repro_torch.launch.dist_worker``, one intra-op thread
    each).  Returns the per-process payloads ordered by rank, or ``None``
    when a worker exited :data:`EXIT_BOOTSTRAP_UNAVAILABLE`; any other
    failure, or a run past ``timeout_s``, raises with the workers' output
    attached."""
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = _src_dir() + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    outs = [tempfile.NamedTemporaryFile(suffix=f".dist{i}.json",
                                        delete=False).name
            for i in range(nproc)]
    procs = []
    try:
        for i in range(nproc):
            cmd = [sys.executable, "-m", "repro_torch.launch.dist_worker",
                   "--coordinator", f"127.0.0.1:{port}",
                   "--num-processes", str(nproc), "--process-id", str(i),
                   *worker_args, "--out", outs[i]]
            procs.append(subprocess.Popen(
                cmd, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        deadline = time.monotonic() + timeout_s
        logs = []
        for p in procs:
            try:
                out, _ = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise RuntimeError(
                    f"dist workers timed out after {timeout_s:.0f}s") from None
            logs.append(out or "")
        codes = [p.returncode for p in procs]
        if any(c == EXIT_BOOTSTRAP_UNAVAILABLE for c in codes):
            return None
        if any(c != 0 for c in codes):
            detail = "\n".join(
                f"--- worker {i} (exit {codes[i]}) ---\n{logs[i][-3000:]}"
                for i in range(nproc) if codes[i] != 0)
            raise RuntimeError(f"dist workers failed:\n{detail}")
        results = []
        for path in outs:
            with open(path) as f:
                results.append(json.load(f))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for path in outs:
            try:
                os.remove(path)
            except OSError:
                pass


if __name__ == "__main__":
    sys.exit(main())
