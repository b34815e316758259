"""Trainer: one training step (gradients, optional int8 error-feedback
compression, AdamW), periodic asynchronous checkpoints, crash-restart
recovery, a straggler watchdog and gradient accumulation, with the
contract of the reference's ``runtime/trainer.py``:

* every ``ckpt_every`` steps the parameters, optimizer state and step
  are saved asynchronously and atomically;
* :meth:`Trainer.restore` resumes from the newest checkpoint;
* a :class:`FaultInjector` can kill any step; :meth:`Trainer.run`
  catches the fault, restores and replays, and the losses after recovery
  equal an uninterrupted run's bit for bit (the data is keyed by step).

Bit-exact replay needs a deterministic step.  The kernels of the path use
no atomics; PyTorch's index backward (the embedding gather and the MoE
dispatch) accumulates with atomics unless deterministic algorithms are
on, so each step runs under :func:`deterministic`, which turns them on
(and sets ``CUBLAS_WORKSPACE_CONFIG`` if the process has not) for the
step only.  The trainer runs where its model is and never moves to the
CPU on its own.
"""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.checkpoint.checkpoint import (latest_step, load_checkpoint,
                                               save_checkpoint)
from repro_torch.distributed.compression import (compress_roundtrip,
                                                 init_error_feedback)
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state

DEFAULT_CKPT_DIR = str(Path(__file__).resolve().parents[3] / "build" / "ckpt")


class FaultInjector:
    """Deterministic fault schedule for tests: raises at given steps."""

    def __init__(self, fail_at: set[int] | None = None):
        self.fail_at = set(fail_at or ())
        self.tripped: set[int] = set()

    def check(self, step: int):
        if step in self.fail_at and step not in self.tripped:
            self.tripped.add(step)
            raise RuntimeError(f"injected fault at step {step}")


@dataclass
class TrainerConfig:
    ckpt_dir: str = DEFAULT_CKPT_DIR     # build/ckpt beside the package
    ckpt_every: int = 50
    ckpt_keep: int = 0                   # newest checkpoints kept; 0: all
    grad_accum: int = 1
    grad_compression: str = "none"       # none | int8_ef
    straggler_threshold: float = 2.0     # x median step time
    log_every: int = 10


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms on for the block, as they were after it."""
    prev = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=warn)


class Trainer:
    """Trains ``model`` (an ``nn.Module``) on ``loss_fn(model, batch)``, a
    scalar loss tensor: every parameter's gradient is turned on.  With
    ``grad_accum > 1`` every array of a batch carries the microbatches on
    its leading axis.  A model with a ``decayed_params()`` method names
    the parameters AdamW decays (``GNNModel``); else AdamW decays those
    with ``ndim >= 2``."""

    def __init__(self, loss_fn: Callable, model: torch.nn.Module,
                 opt_cfg: AdamWConfig, tcfg: TrainerConfig):
        self.loss_fn = loss_fn
        self.model = model.requires_grad_(True)
        self.params = dict(model.named_parameters())
        self.decay = (model.decayed_params()
                      if hasattr(model, "decayed_params") else None)
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self.opt_state = init_opt_state(self.params, opt_cfg)
        self.err_fb = (init_error_feedback(self.params)
                       if tcfg.grad_compression == "int8_ef" else None)
        self.step = 0
        self.step_times: list[float] = []
        self._ckpt_thread = None
        self._last_ckpt_step = 0

    # ------------------------------------------------------------------ #
    def _value_and_grad(self, batch):
        ps = list(self.params.values())
        loss = self.loss_fn(self.model, batch)
        gs = torch.autograd.grad(loss, ps, allow_unused=True)
        return loss.detach(), {n: torch.zeros_like(p) if g is None else g
                               for (n, p), g in zip(self.params.items(), gs)}

    def _one_step(self, batch):
        """Gradients, compression, AdamW.  AdamW runs inside a
        ``torch.profiler.record_function`` range, "trainer.adamw", which a
        profile of a step reads; outside a profile it costs a few
        microseconds."""
        ga = self.tcfg.grad_accum
        with deterministic():
            if ga > 1:
                lsum = None
                gsum = {n: torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device)
                        for n, p in self.params.items()}
                for i in range(ga):
                    loss, grads = self._value_and_grad(
                        {k: v[i] for k, v in batch.items()})
                    lsum = loss.float() if lsum is None else lsum + loss
                    for n, g in grads.items():
                        gsum[n] += g.float()
                    del grads
                loss = lsum / ga
                grads = {n: g / ga for n, g in gsum.items()}
            else:
                loss, grads = self._value_and_grad(batch)
            if self.err_fb is not None:
                grads, self.err_fb = compress_roundtrip(grads, self.err_fb)
            with record_function("trainer.adamw"):
                _, self.opt_state, info = adamw_update(
                    self.params, grads, self.opt_state, self.opt_cfg,
                    self.decay)
        return loss, info

    def train_step(self, batch, fault: FaultInjector | None = None) -> dict:
        t0 = time.perf_counter()
        if fault is not None:
            fault.check(self.step)
        loss, info = self._one_step(batch)
        loss = float(loss)
        self.step += 1
        dt = time.perf_counter() - t0
        self.step_times.append(dt)
        out = dict(step=self.step, loss=loss, secs=dt,
                   grad_norm=float(info["grad_norm"]), lr=info["lr"],
                   straggler=self.is_straggler(dt))
        if self.step % self.tcfg.ckpt_every == 0:
            self.save()
            self._last_ckpt_step = self.step
        return out

    def is_straggler(self, dt: float) -> bool:
        """Step-time watchdog: a step slower than ``straggler_threshold``
        times the median of the last 50 is flagged in its record
        (``straggler``) and in ``run``'s log."""
        if len(self.step_times) < 5:
            return False
        med = float(np.median(self.step_times[-50:]))
        return dt > self.tcfg.straggler_threshold * med

    # ------------------------------------------------------------------ #
    def _tree(self) -> dict:
        return dict(params=self.params, opt_state=self.opt_state,
                    err_fb=self.err_fb)

    def save(self, blocking: bool = False):
        """Checkpoint the current step (the tensors are copied to the host
        before this returns; the file is written on a thread unless
        ``blocking``)."""
        if self._ckpt_thread is not None:
            self._ckpt_thread.join()
        self._ckpt_thread = save_checkpoint(
            self.tcfg.ckpt_dir, self.step, self._tree(), blocking=blocking,
            keep=self.tcfg.ckpt_keep)

    def restore(self) -> bool:
        """Resume from the newest checkpoint, copied into the model's
        parameters and the optimizer state in place; True if one was
        found."""
        if self._ckpt_thread is not None:
            self._ckpt_thread.join()
            self._ckpt_thread = None
        if latest_step(self.tcfg.ckpt_dir) is None:
            return False
        _, step = load_checkpoint(self.tcfg.ckpt_dir, self._tree(), into=True)
        self.step = step
        self._last_ckpt_step = step
        return True

    # ------------------------------------------------------------------ #
    def run(self, data_iter, n_steps: int, fault: FaultInjector | None = None,
            max_restarts: int = 3, log: Callable = print) -> list[dict]:
        """Fault-tolerant run loop: crash -> restore -> replay."""
        history: list[dict] = []
        restarts = 0
        data_by_step: dict[int, Any] = {}
        it = iter(data_iter)
        if latest_step(self.tcfg.ckpt_dir) is None:
            self.save(blocking=True)      # step-0 anchor for crash-before-ckpt
        while self.step < n_steps:
            s = self.step
            if s not in data_by_step:
                data_by_step[s] = next(it)
            try:
                out = self.train_step(data_by_step[s], fault)
            except RuntimeError as e:
                restarts += 1
                if restarts > max_restarts:
                    raise
                log(f"[trainer] fault at step {s}: {e}; restoring...")
                if not self.restore():
                    raise
                continue
            history.append(out)
            if out["step"] % self.tcfg.log_every == 0:
                log(f"[trainer] step {out['step']} loss {out['loss']:.4f} "
                    f"lr {out['lr']:.2e} {out['secs']*1e3:.0f}ms"
                    + (" STRAGGLER" if out["straggler"] else ""))
            # free data older than the restore horizon (last checkpoint):
            # a crash can rewind at most to _last_ckpt_step, so batches for
            # steps >= that must stay replayable
            for k in [k for k in data_by_step if k < self._last_ckpt_step]:
                del data_by_step[k]
        return history

    def finish(self) -> None:
        """Wait for the checkpoint being written, if any."""
        if self._ckpt_thread is not None:
            self._ckpt_thread.join()
            self._ckpt_thread = None
