"""Checkpoints in the reference's layout (``checkpoint/checkpoint.py``):
``path/step_XXXXXXXX/leaves.npz`` plus ``manifest.json``, written into a
``.tmp`` directory and renamed into place, so a reader sees a whole
checkpoint or none; on a thread when not blocking.

A restore reads ``leaves.npz`` one leaf at a time with ``np.load``
(which checks each zip member's CRC) and copies the leaf to its device.

A tree is a nested dict of tensors (``None`` leaves are skipped), such as
``dict(params=model.state_dict(), opt_state=..., err_fb=...)``.  Leaves
are named by their keys joined with "/" (``params/blocks.0.attn.wq``),
not by a pytree's order.  The tensors are copied to the host before
:func:`save_checkpoint` returns, so the caller may update them while the
thread writes.  npz has no bfloat16: such a leaf is upcast to float32 on
disk (exactly) and cast back on load.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

_NPZ_DTYPES = {torch.float32, torch.float64, torch.float16, torch.int64,
               torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool}


def _flatten(tree, prefix: str = "") -> list:
    """``[(name, tensor)]`` in the dict's order, ``None`` leaves left out."""
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += _flatten(v, f"{prefix}{k}/")
        return out
    if tree is None:
        return []
    return [(prefix[:-1], tree)]


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` that later updates of ``t`` do not reach (a
    CPU tensor is copied too), bfloat16 upcast to float32."""
    t = t.detach()
    if t.dtype not in _NPZ_DTYPES:
        t = t.float()
    return t.to("cpu", copy=True).numpy()


def _prune(path: str, keep: int) -> None:
    """Delete all but the newest ``keep`` complete checkpoints."""
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(path)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(path, f"step_{s:08d}"))


def save_checkpoint(path: str, step: int, tree, blocking: bool = True,
                    keep: int = 0):
    """Write ``tree`` to ``path/step_<step>/`` (atomic rename).  With
    ``keep`` > 0, the older checkpoints beyond the newest ``keep`` are
    deleted once this one is in place (0 keeps every one, as the
    reference does).  Returns the writing thread when not ``blocking``,
    else None."""
    tgt = os.path.join(path, f"step_{step:08d}")
    tmp = tgt + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    leaves = [(name, _host(t)) for name, t in _flatten(tree)]

    def write():
        manifest = dict(step=step, n_leaves=len(leaves),
                        names=[n for n, _ in leaves],
                        shapes=[list(a.shape) for _, a in leaves],
                        dtypes=[str(a.dtype) for _, a in leaves])
        np.savez(os.path.join(tmp, "leaves.npz"), **dict(leaves))
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(tgt):
            shutil.rmtree(tgt)
        os.rename(tmp, tgt)
        if keep > 0:
            _prune(path, keep)

    if blocking:
        write()
        return None
    th = threading.Thread(target=write, daemon=True)
    th.start()
    return th


def latest_step(path: str) -> int | None:
    """The newest complete checkpoint's step under ``path``, or None."""
    if not os.path.isdir(path):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(path)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def load_checkpoint(path: str, like_tree, step: int | None = None,
                    into: bool = False):
    """Restore into the structure of ``like_tree``: each leaf takes the
    dtype and device of the tensor of the same name there, or with
    ``into`` is copied into that tensor in place (no second copy of the
    state on the device).  Returns ``(tree, step)``."""
    step = step if step is not None else latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {path}")
    src = os.path.join(path, f"step_{step:08d}")

    def restore(like, prefix):
        if isinstance(like, dict):
            return {k: restore(v, f"{prefix}{k}/") for k, v in like.items()}
        if like is None:
            return None
        name = prefix[:-1]
        if name not in data.files:
            raise KeyError(f"checkpoint step {step} has no leaf {name!r}")
        arr = data[name]
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"leaf {name!r}: checkpoint {arr.shape} vs "
                             f"tree {tuple(like.shape)}")
        t = torch.from_numpy(arr)
        if into:
            with torch.no_grad():
                return like.copy_(t)
        return t.to(device=like.device, dtype=like.dtype, copy=True)

    with np.load(os.path.join(src, "leaves.npz")) as data:
        n_like = len(_flatten(like_tree))
        if n_like != len(data.files):
            raise ValueError(f"checkpoint step {step} has {len(data.files)} "
                             f"leaves, the tree wants {n_like}")
        tree = restore(like_tree, "")
    return tree, step
