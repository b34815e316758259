"""Carry state from the reference package into the port.

Graphs, partitions and cache states play the part that weights play in
a model: a parity test builds them once and hands the same numbers to
both packages.  These functions take plain numpy arrays (the reference's
fields, read with ``np.asarray``), so the port needs nothing of the
reference to use them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.cache import AdjCache
from repro_torch.device import resolve_device
from repro_torch.graph.storage import PartitionedGraph

_PG_INTS = ("n", "n_real", "ndev", "stride", "max_degree")
_PG_ARRAYS = ("adj", "deg", "n_local", "border", "border_dist", "old2new",
              "new2old")


def partitioned_from_arrays(d: dict) -> PartitionedGraph:
    """The port's :class:`PartitionedGraph` from a dict of the reference's
    fields (``n, n_real, ndev, stride, max_degree, adj, deg, n_local,
    border, border_dist, old2new, new2old``)."""
    return PartitionedGraph(**{k: int(d[k]) for k in _PG_INTS},
                            **{k: np.array(d[k]) for k in _PG_ARRAYS})


def cache_from_arrays(d: dict, device=None, decay: int = 0) -> AdjCache:
    """An :class:`AdjCache` from ``keys (ndev, slots, ways)``, ``rows
    (ndev, slots, ways, line_width)``, ``benefit`` and ``tick`` arrays
    plus the sentinel ``n``; ``decay`` is the benefit decay period."""
    device = resolve_device(device)
    t = {k: torch.as_tensor(np.asarray(d[k], dtype=np.int32), device=device)
         for k in ("keys", "rows", "benefit", "tick")}
    ndev, slots, ways, line_width = t["rows"].shape
    return AdjCache(ndev=ndev, slots=slots, ways=ways, n=int(d["n"]),
                    line_width=line_width, decay=decay, **t)
