"""Optimization-flag context: the flags of the reference's
``distributed/ctx.py``, which ``moe_block`` and ``gat_forward`` read.

``moe_capacity_factor`` overrides the config's capacity factor (the
dispatch volume) and means the same on one card as on a mesh.
``gnn_bf16_msgs`` keeps GAT's edge messages and their segment sums in
bfloat16 (``gat_forward``).  ``dp_axes``, ``moe_ep_constrain``, ``moe_tp``
and ``gnn_replicate_nodes`` are sharding hints for a mesh; they are kept
as fields so a flag set reads the same in both packages, but on one card
they have no meaning: no model reads them, and :func:`constrain` is the
identity.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class OptFlags:
    dp_axes: tuple = ("data",)      # data-parallel mesh axes
    moe_ep_constrain: bool = False  # explicit EP dispatch shardings (MoE)
    gnn_bf16_msgs: bool = False     # bf16 edge messages/partials (GNN)
    moe_capacity_factor: float | None = None  # override cf (dispatch volume)
    moe_tp: bool = False            # TP-MoE: shard experts over d_ff, not E
    gnn_replicate_nodes: bool = False  # replicate node feats (kill gathers)


CURRENT = OptFlags()


def set_flags(**kw):
    global CURRENT
    for k, v in kw.items():
        if not hasattr(CURRENT, k):
            raise AttributeError(f"unknown optimization flag {k!r}")
        setattr(CURRENT, k, v)


def reset():
    global CURRENT
    CURRENT = OptFlags()


def constrain(x, *spec):
    """The identity: one card has no mesh to constrain a layout to."""
    return x
