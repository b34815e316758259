"""A rank of a spawned two-process ``dist`` run in the tests (importable by
a spawned child: it loads the port only, no JAX)."""
import datetime
import os
import pickle


def rank_main(rank: int, world: int, port: int, tpg, runs: list,
              device: str, out_dir: str) -> None:
    """Join the process group, run ``rads_enumerate(mode="dist")`` for
    each ``(query, EngineConfig kwargs)`` of ``runs`` with embeddings, and
    pickle ``[(count, embeddings, stats, membership launches), ...]`` to
    ``out_dir/rank.pkl``."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs.rads import QUERIES, EngineConfig
    from repro_torch.core import Pattern, rads_enumerate
    from repro_torch.kernels.membership import ops as memb

    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(minutes=3))
    try:
        out = []
        for q, kw in runs:
            launches = memb.launches
            res = rads_enumerate(tpg, Pattern.from_edges(QUERIES[q]),
                                 EngineConfig(**kw), mode="dist",
                                 return_embeddings=True, device=dev)
            out.append((res.count, res.embeddings, res.stats,
                        memb.launches - launches))
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def run_spawned(tpg, runs: list, device: str = "cpu", world: int = 2,
                timeout_s: float = 180.0) -> list:
    """Spawn ``world`` ranks of :func:`rank_main` and return each rank's
    results, ordered by rank; raises if a rank fails or outlives
    ``timeout_s``."""
    import multiprocessing as mp
    import socket
    import tempfile
    import time

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as out_dir:
        procs = [ctx.Process(target=rank_main,
                             args=(r, world, port, tpg, runs, device,
                                   out_dir))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            for p in procs:
                p.join(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            hung = [p for p in procs if p.is_alive()]
            for p in hung:
                p.kill()
                p.join()
        if hung:
            raise RuntimeError(f"dist ranks outlived {timeout_s:.0f}s")
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise RuntimeError(f"dist ranks failed: exit codes {codes}")
        out = []
        for r in range(world):
            with open(os.path.join(out_dir, f"{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
