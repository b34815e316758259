"""Ranks of spawned ``torch.distributed`` (gloo) runs in the tests: a
``dist`` enumeration, ``compressed_psum`` and a placement round trip
(importable by a spawned child: it loads the port only, no JAX)."""
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
    return spawn_ranks(rank_main, world, (tpg, runs, device), timeout_s)


def spawn_ranks(target, world: int, args: tuple,
                timeout_s: float = 180.0) -> list:
    """Spawn ``world`` processes of ``target(rank, world, port, *args,
    out_dir)``, each of which pickles its result to ``out_dir/rank.pkl``,
    and return the results ordered by rank; raises if a rank fails or
    outlives ``timeout_s``."""
    import multiprocessing as mp
    import socket
    import tempfile
    import time

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as out_dir:
        procs = [ctx.Process(target=target,
                             args=(r, world, port, *args, out_dir))
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
            raise RuntimeError(f"ranks outlived {timeout_s:.0f}s")
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise RuntimeError(f"ranks failed: exit codes {codes}")
        out = []
        for r in range(world):
            with open(os.path.join(out_dir, f"{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def _join_gloo(rank: int, world: int, port: int):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(minutes=3))
    return dist


def psum_rank_main(rank: int, world: int, port: int, cases: dict,
                   out_dir: str) -> None:
    """``compressed_psum`` of row ``rank`` of each array of ``cases``
    (stacked on a leading axis of ``world``; a name starting with "bf16"
    is cast to bfloat16) over a ``("pod",)`` mesh of the gloo world;
    pickles ``{name: result as float32 numpy}``."""
    import torch

    from repro_torch.distributed.compression import compressed_psum
    from repro_torch.launch.mesh import make_mesh

    dist = _join_gloo(rank, world, port)
    try:
        mesh = make_mesh((world,), ("pod",), device_type="cpu")
        out = {}
        for name, x in cases.items():
            t = torch.from_numpy(x[rank].copy())
            if name.startswith("bf16"):
                t = t.to(torch.bfloat16)
            out[name] = compressed_psum(t, "pod", mesh).float().numpy()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def placement_rank_main(rank: int, world: int, port: int, arch: str,
                        seed: int, out_dir: str) -> None:
    """The reduced ``arch``'s parameters (seeded) distributed by
    ``param_shardings`` over a ``(world, 1)`` ``("data", "model")`` mesh
    of the gloo world; pickles this rank's shard bytes, the parameters
    whose ``full_tensor()`` differs from the original in any bit, and how
    many parameters are split."""
    import torch
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.configs import get_reduced
    from repro_torch.distributed.sharding import param_shardings
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import init_lm_params

    dist = _join_gloo(rank, world, port)
    try:
        mesh = make_mesh((world, 1), ("data", "model"), device_type="cpu")
        cfg = get_reduced(arch)
        model = init_lm_params(torch.Generator().manual_seed(seed), cfg,
                               device="cpu")
        params = {n: p.detach() for n, p in model.named_parameters()}
        shardings = param_shardings(params, "lm", mesh)
        local_bytes, differ, n_split = 0, [], 0
        for name, p in params.items():
            pl = list(shardings[name].placements)
            n_split += any(q != Replicate() for q in pl)
            dt = distribute_tensor(p, mesh, pl)
            local_bytes += dt.to_local().numel() * p.element_size()
            full = dt.full_tensor()
            if not torch.equal(full.view(torch.uint8), p.view(torch.uint8)):
                differ.append(name)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(dict(local_bytes=local_bytes, differ=differ,
                         n_split=n_split, n_params=len(params)), f)
