"""Optimization-flag context: the flags of the reference's
``distributed/ctx.py``, which ``moe_block``, ``gat_forward`` and the
mesh plan read.

``moe_capacity_factor`` overrides the config's capacity factor (the
dispatch volume) and means the same on one card as on a mesh.
``gnn_bf16_msgs`` keeps GAT's edge messages and their segment sums in
bfloat16 (``gat_forward``).  ``moe_tp`` selects the experts' sharding
rule (``distributed/sharding.py``) and ``gnn_replicate_nodes`` the GNN
node arrays' placement (``launch/specs.py``).  ``dp_axes`` and
``moe_ep_constrain`` are the reference's hints for layouts inside a
sharded step; the port runs no sharded step, so nothing reads them, and
:func:`constrain` is the identity.  :func:`set_flags` lasts until
:func:`reset`; :func:`scope` holds a flag set only inside its block
(``launch/specs.py`` builds a variant's cell, and runs its step, so).
"""
from __future__ import annotations

import contextlib
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


@contextlib.contextmanager
def scope(**kw):
    """Inside the block the flags are the defaults with ``kw`` set; on
    exit the flags in force before come back."""
    global CURRENT
    before = CURRENT
    CURRENT = OptFlags()
    try:
        set_flags(**kw)
        yield CURRENT
    finally:
        CURRENT = before


def constrain(x, *spec):
    """The identity: one card has no mesh to constrain a layout to."""
    return x
