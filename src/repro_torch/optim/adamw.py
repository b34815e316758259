"""AdamW and its warmup-cosine schedule, with the reference's formulas
(``src/repro/optim/adamw.py``), not ``torch.optim.AdamW``'s, which differ
in three ways: the gradients are clipped by their global norm before the
moments are updated; weight decay ``lr * weight_decay * p`` is added to
the Adam step only for tensors with ``ndim >= 2`` (norms and biases are
spared), or for the names the caller lists where its tensors' shapes are
not the reference's (a GNN whose per-layer weights the reference stacks:
``GNNModel.decayed_params``); and each parameter is updated in float32
from its old value and rounded to its own dtype once.

Parameters, gradients and moments are dicts of tensors keyed by name
(``dict(model.named_parameters())``).  Moments are float32, or bfloat16
under ``moment_dtype``.  Where the reference returns new pytrees,
:func:`adamw_update` writes the new parameters and moments into the
tensors it was given, which saves a second copy of the model's state,
and each tensor's update makes about a dozen passes over it.
Plain tensor code, elementwise on the card: no kernel of the TPU package.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step``: linear warmup, then cosine decay to
    ``min_lr_frac`` of ``lr``, in float32 as the reference computes it."""
    step = _f32(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init_opt_state(params: dict, cfg: AdamWConfig) -> dict:
    """Zero moments beside each parameter, and the step count (an int32
    scalar on the host)."""
    dt = torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32

    def zeros():
        return {k: torch.zeros(p.shape, dtype=dt, device=p.device)
                for k, p in params.items()}

    return dict(mu=zeros(), nu=zeros(),
                step=torch.zeros((), dtype=torch.int32))


def global_norm(tensors: dict) -> torch.Tensor:
    """sqrt of the sum of every tensor's squares, in float32 (the sums
    taken in the dict's order)."""
    total = None
    for g in tensors.values():
        sq = torch.sum(torch.square(g.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: dict, cfg: AdamWConfig,
                 decay: set[str] | None = None):
    """One AdamW step: ``(params, state, info)`` with ``info`` holding the
    gradients' global norm (before clipping) and the learning rate.  The
    parameters and moments are updated in place (the returned dicts are
    the ones given, with ``state["step"]`` advanced).  ``decay`` names the
    parameters that take weight decay; by default those with ``ndim >=
    2``."""
    step = state["step"] + 1
    lr = float(schedule(cfg, step))
    gn = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
    bc1 = float(1 - _f32(cfg.b1) ** step.float())
    bc2 = float(1 - _f32(cfg.b2) ** step.float())
    for name, p in params.items():
        # each line one pass over the tensor, in place where it can be
        g = grads[name].to(torch.float32, copy=True).mul_(scale)
        mu, nu = state["mu"][name], state["nu"][name]
        mu32 = mu if mu.dtype == torch.float32 else mu.float()
        nu32 = nu if nu.dtype == torch.float32 else nu.float()
        mu32.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        nu32.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        delta = torch.div(nu32, bc2, out=g).sqrt_().add_(cfg.eps)
        delta = torch.div(mu32, bc1).div_(delta)
        p32 = p.float()                # p itself when it is float32
        if (p.ndim >= 2) if decay is None else (name in decay):
            delta.add_(p32, alpha=cfg.weight_decay)
        p32.sub_(delta, alpha=lr)
        if p32 is not p:
            p.copy_(p32)
        if mu32 is not mu:
            mu.copy_(mu32)
            nu.copy_(nu32)
    state["step"] = step
    return params, state, dict(grad_norm=gn, lr=lr)
