"""Every RADS pipeline stage of the port runs without a fault on any
argument values.  On the card a stage graph's capture warms up on its
arguments as they stand, and a pre-warm takes those from other graphs'
outputs, which replays of graphs sharing the memory pool overwrite
between waves (``repro_torch.core.scheduler``).  A real wave on the small
graph gives each stage's arguments; each stage then runs on copies filled
with random values made from a seed (negative and out-of-range ids,
random flags and counts) and must return outputs of the real call's
shapes and dtypes.  On the CPU an index out of range raises; on the card
(``gpu``) it would be a device-side assert that ends the process."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.rads import QUERIES, EngineConfig
from repro_torch.core.cache import build_cache
from repro_torch.core.engine import (build_plan_data, expand_stage,
                                     fetch_stage, finalize_wave, init_wave,
                                     verify_stage)
from repro_torch.core.exchange import Exchange
from repro_torch.core.plan import best_plan
from repro_torch.core.query import Pattern
from repro_torch.graph import erdos_graph, partition
from repro_torch.graph.storage import device_graph

# tiny tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

CAPS = dict(frontier_cap=1 << 8, fetch_cap=64, verify_cap=256)
FORMATS = [("dense", "raw"), ("bucketed", "varint")]
QUERY_NAMES = ("q1", "q6", "q8")
TRIALS = 2


def _random_like(obj, gen: torch.Generator):
    """``obj`` with every tensor replaced by random values of its shape
    and dtype: ints over the whole int32 range, random flags, normal
    floats.  The device graph and the adjacency cache are not arguments
    a replay overwrites, and stay."""
    if isinstance(obj, torch.Tensor):
        if obj.dtype == torch.bool:
            x = torch.randint(0, 2, obj.shape, generator=gen).bool()
        elif obj.dtype.is_floating_point:
            x = torch.randn(obj.shape, generator=gen).to(obj.dtype)
        else:
            x = torch.randint(-2 ** 31, 2 ** 31 - 1, obj.shape,
                              generator=gen, dtype=torch.int64).to(obj.dtype)
        return x.to(obj.device)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _random_like(getattr(obj, f.name), gen)
            for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple):
        return tuple(_random_like(x, gen) for x in obj)
    return obj


def _layout(obj) -> list:
    """Shapes and dtypes of every tensor of ``obj``, in a fixed order."""
    if isinstance(obj, torch.Tensor):
        return [(tuple(obj.shape), obj.dtype)]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [t for f in dataclasses.fields(obj)
                for t in _layout(getattr(obj, f.name))]
    if isinstance(obj, (tuple, list)):
        return [t for x in obj for t in _layout(x)]
    return [type(obj).__name__]


def _check_stages(fmt: str, wire: str, q: str, device: str) -> int:
    """Run one wave of ``q`` through every stage, calling each stage first
    on random copies of its arguments.  Returns the stage calls made on
    random arguments."""
    pg = partition(erdos_graph(120, 5.0, seed=5), 8, method="bfs")
    cfg = EngineConfig(**CAPS, storage_format=fmt, wire_format=wire)
    g = device_graph(pg, fmt, device)
    exch = Exchange(mode="sim", wire_format=wire)
    pd = build_plan_data(best_plan(Pattern.from_edges(QUERIES[q]),
                                   cfg.plan_rho))
    cache = build_cache(cfg, g)
    # each machine's first 16 vertices seed the wave
    seeds = (np.arange(pg.ndev)[:, None] * pg.stride
             + np.arange(16)[None, :]).astype(np.int32)
    state = init_wave(g, seeds, np.ones(seeds.shape, bool))
    gen = torch.Generator().manual_seed(0)
    calls = 0

    def on_random(stage, *args):
        nonlocal calls
        want = _layout(stage(*args))
        for _ in range(TRIALS):
            got = stage(*_random_like(args, gen))
            if device == "cuda":
                torch.cuda.synchronize()
            assert _layout(got) == want
            calls += 1

    for ui in range(len(pd.unit_steps)):
        on_random(lambda s: fetch_stage(g, pd, cfg, exch, ui, s, False,
                                        cache), state)
        state, bufs, cache = fetch_stage(g, pd, cfg, exch, ui, state, False,
                                         cache)
        on_random(lambda s, b: expand_stage(g, pd, cfg, ui, s, b, False),
                  state, bufs)
        state = expand_stage(g, pd, cfg, ui, state, bufs, False)
        on_random(lambda s: verify_stage(g, pd, cfg, exch, ui, s, False),
                  state)
        state = verify_stage(g, pd, cfg, exch, ui, state, False)
    on_random(finalize_wave, state)
    return calls


@pytest.mark.parametrize("q", QUERY_NAMES)
@pytest.mark.parametrize("fmt,wire", FORMATS)
def test_stages_run_on_any_argument_values(fmt, wire, q):
    assert _check_stages(fmt, wire, q, "cpu") > 0


@pytest.mark.gpu
@pytest.mark.parametrize("q", QUERY_NAMES)
@pytest.mark.parametrize("fmt,wire", FORMATS)
def test_stages_run_on_any_argument_values_on_card(fmt, wire, q):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the stages' kernels have no CPU mode")
    assert _check_stages(fmt, wire, q, "cuda") > 0
