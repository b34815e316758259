"""Sharding rules: the reference's ``distributed/sharding.py`` over
DTensor placements.

Scheme (single pod (data=16, model=16); multi-pod adds a leading 'pod'
axis that joins the FSDP group):

* LM: Megatron TP over 'model' (column-parallel wq/wk/wv/wg/wu,
  row-parallel wo/wd), FSDP (ZeRO-3 style) over 'data' (+'pod') on the
  complementary dim, experts EP over 'model' (with ``ctx`` flag
  ``moe_tp``: every device holds all experts' d_ff shard instead),
  embeddings vocab-sharded over 'model'.
* GNN: parameters replicated (tiny); node and edge arrays over 'data'.
* RecSys: embedding tables row-sharded over every axis, dense MLPs
  replicated.

A :class:`Sharding` keeps a spec in both spellings: the reference's
``PartitionSpec`` as a tuple with one entry per tensor dim (None, a mesh
axis, or a tuple of axes, major first), and DTensor's ``placements``, one
per mesh dim (``Shard(d)`` or ``Replicate()``).  An axis tuple such as
``("pod", "data")`` on dim d is ``Shard(d)`` on both mesh dims, and
DTensor splits in mesh-dim order, so 'pod' is major there too, as in
JAX.

The port's LM holds per-layer tensors (``Block``), where the reference
stacks every layer's weights on a leading axis and keys its rule on that
rank: a per-layer tensor is judged as its stack is (one dim more) and
the layer axis, never sharded, is dropped from the spec.  A per-layer
expert weight (E, d, f) thus takes the stacked (L, E, d, f) rule.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch.distributed import ctx

COL = ("wq", "wk", "wv", "wg", "wu", "w_uq", "w_uk", "w_uv", "w_dq",
       "w_dkv", "w_kr", "shared_wg", "shared_wu", "proj")
ROW = ("wo", "wd", "shared_wd")


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclass(frozen=True)
class Sharding:
    """A tensor's layout on ``mesh``: ``spec[d]`` names the mesh axes
    that split tensor dim d (None: whole on every device)."""

    mesh: DeviceMesh
    spec: tuple = ()

    @property
    def placements(self) -> tuple:
        """DTensor's spelling: per mesh dim ``Shard(d)`` or
        ``Replicate()``."""
        names = self.mesh.mesh_dim_names
        out = [Replicate()] * len(names)
        for d, entry in enumerate(self.spec):
            idx = [names.index(a) for a in _axes(entry)]
            if idx != sorted(idx):
                raise ValueError(f"spec entry {entry} is not in the mesh's "
                                 f"axis order {names}")
            for i in idx:
                if out[i] != Replicate():
                    raise ValueError(f"mesh axis {names[i]!r} splits two "
                                     f"dims of {self.spec}")
                out[i] = Shard(d)
        return tuple(out)

    def local_shape(self, shape, dtype: torch.dtype, memo: dict
                    ) -> tuple[int, ...]:
        """The shape of this rank's shard of a ``shape`` tensor (rank 0's
        in a plan world): a meta tensor placed with
        :func:`distribute_tensor` (no storage, and no data moves over a
        plan's fake group).  ``memo``, one dict for one mesh, keeps the
        answer per (shape, dtype, placements)."""
        key = (tuple(shape), dtype, self.placements)
        if key not in memo:
            t = torch.empty(tuple(shape), dtype=dtype, device="meta")
            memo[key] = tuple(distribute_tensor(
                t, self.mesh, list(self.placements)).to_local().shape)
        return memo[key]


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def dp_axes(mesh: DeviceMesh) -> tuple[str, ...]:
    """All data-parallel axes: ('pod', 'data') on multi-pod, ('data',)
    else."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def dp_entry(mesh: DeviceMesh):
    """The data-parallel axes as one spec entry: a tuple of several, or
    the one axis itself."""
    dp = dp_axes(mesh)
    return dp if len(dp) > 1 else (dp[0] if dp else None)


def _lm_spec(path: str, ndim: int, fsdp) -> tuple:
    """The reference's rule on its own tree: ``path`` the '/'-joined
    leaf path, ``ndim`` the leaf's rank there.  The leading axis of a
    stacked-layer param is the layer axis (unsharded)."""
    lead = (None,) * (ndim - 2)
    if "router" in path or path.endswith("_norm") or "ln" in path \
            or "norm" in path or path.endswith(("bq", "bk", "bv")) \
            or ndim <= 1 + len(lead):
        return ()
    if "embed" in path or "lm_head" in path:
        return ("model", None) if "embed" in path else (None, "model")
    name = path.rsplit("/", 1)[-1]
    if ndim == 4:  # stacked experts (L, E, d, f)
        if ctx.CURRENT.moe_tp:
            # TP-MoE: every device holds all experts' f-shard
            if name in ("wg", "wu"):
                return (None, None, fsdp, "model")
            if name == "wd":
                return (None, None, "model", fsdp)
            return ()
        if name in ("wg", "wu"):
            return (None, "model", fsdp, None)
        if name == "wd":
            return (None, "model", None, fsdp)
        return ()
    if name in COL:
        return (*lead, fsdp, "model")
    if name in ROW:
        return (*lead, "model", fsdp)
    return ()


def lm_param_spec(name: str, ndim: int, fsdp) -> tuple:
    """The rule for the port's parameter ``name`` (``named_parameters``)
    of rank ``ndim``: a ``blocks.<i>.`` tensor is judged as its stack in
    the reference (rank ``ndim + 1``), and the layer axis dropped."""
    if name.startswith("blocks."):
        rest = name.split(".", 2)[2].replace(".", "/")
        return _lm_spec("blocks/" + rest, ndim + 1, fsdp)[1:]
    return _lm_spec(name.replace(".", "/"), ndim, fsdp)


def _fit(spec: tuple, shape, mesh: DeviceMesh) -> tuple:
    """Drop each axis entry that does not divide its dim (the
    reference's safety for reduced configs)."""
    fixed = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            fixed.append(None)
            continue
        size = 1
        for a in _axes(entry):
            size *= axis_size(mesh, a)
        fixed.append(entry if shape[i] % size == 0 else None)
    return tuple(fixed)


def param_shardings(params: dict, family: str,
                    mesh: DeviceMesh) -> dict[str, Sharding]:
    """``params`` name -> tensor (``dict(model.named_parameters())``, or
    AdamW's moments keyed the same) -> name -> :class:`Sharding`."""
    fsdp = dp_entry(mesh)
    out = {}
    for name, t in params.items():
        if family == "lm":
            spec = lm_param_spec(name, t.ndim, fsdp)
        elif family == "recsys":
            spec = ((tuple(mesh.mesh_dim_names), None)
                    if "table" in name and t.ndim == 2 else ())
        else:  # gnn: replicated
            spec = ()
        out[name] = Sharding(mesh, _fit(spec, t.shape, mesh))
    return out


def data_shardings(family: str, kind: str, mesh: DeviceMesh):
    """A function of an input's rank -> its :class:`Sharding`: the batch
    (leading) dim over the DP axes.  ``launch/specs.py`` wires each
    cell's inputs."""
    batch_axes = dp_entry(mesh)

    def batch0(ndim: int) -> Sharding:
        return Sharding(mesh, (batch_axes, *([None] * (ndim - 1))))

    return batch0


def replicated(mesh: DeviceMesh) -> Sharding:
    return Sharding(mesh, ())
