"""Optimization-flag context: the flags of the reference's
``distributed/ctx.py`` that ``moe_block`` reads.

``moe_capacity_factor`` overrides the config's capacity factor (the
dispatch volume) and means the same on one card as on a mesh.
``dp_axes``, ``moe_ep_constrain`` and ``moe_tp`` are sharding hints for a
mesh; they are kept as fields so a flag set reads the same in both
packages, but on one card they have no meaning: ``moe_block`` reads none
of them, and :func:`constrain` is the identity.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class OptFlags:
    dp_axes: tuple = ("data",)      # data-parallel mesh axes
    moe_ep_constrain: bool = False  # explicit EP dispatch shardings (MoE)
    moe_capacity_factor: float | None = None  # override cf (dispatch volume)
    moe_tp: bool = False            # TP-MoE: shard experts over d_ff, not E


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
