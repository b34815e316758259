"""Carry state from the reference package into the port.

Graphs, partitions, cache states and model weights: a parity test builds
them once and hands the same numbers to both packages.  These functions
take plain numpy arrays (the reference's fields or parameter pytree, read
with ``np.asarray``), so the port needs nothing of the reference to use
them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import TransformerConfig
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


def tensor_from_array(a, device: torch.device) -> torch.Tensor:
    """A tensor with ``a``'s values and dtype.  numpy's view of a JAX
    bfloat16 array (``ml_dtypes.bfloat16``) is not a dtype torch reads:
    it goes through float32, which holds every bfloat16 exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def lm_params_from_arrays(tree: dict, cfg: TransformerConfig, device=None):
    """The port's :class:`~repro_torch.models.TransformerLM` from the
    reference's parameter pytree as numpy arrays
    (``jax.tree.map(np.asarray, params)``): ``embed``, ``final_norm``,
    ``lm_head`` (untied), and ``dense_stack`` / ``moe_stack``, each a
    dict of per-layer weights stacked on axis 0 (or None)."""
    from repro_torch.models.transformer import Block, TransformerLM
    device = resolve_device(device)

    def layer(a, i):
        return tensor_from_array(np.asarray(a)[i], device)

    blocks = []
    for key, moe in (("dense_stack", False), ("moe_stack", True)):
        stack = tree.get(key)
        if stack is None:
            continue
        for i in range(np.asarray(stack["ln1"]).shape[0]):
            attn = {k: layer(v, i) for k, v in stack["attn"].items()}
            ffn = {k: layer(v, i) for k, v in stack["ffn"].items()}
            blocks.append(Block(attn, ffn, layer(stack["ln1"], i),
                                layer(stack["ln2"], i), moe))
    head = tree.get("lm_head")
    return TransformerLM(
        cfg, tensor_from_array(tree["embed"], device), blocks,
        tensor_from_array(tree["final_norm"], device),
        None if head is None else tensor_from_array(head, device))
