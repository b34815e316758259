"""Persistent stage-executable store: the port of the reference's
``runtime/compile_cache.py``, with the same public names.

On the card a RADS stage executable is a CUDA graph of one stage call
(:class:`~repro_torch.core.scheduler.StageRunner`).  Making one costs
two things: building the kernels the stage launches with ``nvcc`` (the
first launch of a library builds it, seconds per source) and capturing
the stage's launch sequence.  The runner keeps the captured graphs in an
in-process slot table, the counterpart of the reference's ``Compiled``
objects.  A CUDA graph cannot be serialised, so this per-host store
keeps what can outlive a process: the kernel libraries a stage's
capture loaded, by content hash (the ``lib<source>-<hash>.so`` names of
:func:`repro_torch.kernels.build.library_path`).  A hit writes any
library missing from ``build/kernels`` into place, so the capture that
follows runs no ``nvcc``; a warm store makes a whole run free of
compiles (``stats["compiles"] == 0``).

Key schema
----------
An entry's digest is ``sha256`` over four layers, any of which changing
invalidates the entry, as in the reference:

1. **environment stamp** (:func:`version_stamp`): PyTorch's version and
   CUDA build, the ``nvcc`` release (read once, lazily), the device's
   name and compute capability, and the number of visible devices;
2. **code fingerprint** (:func:`code_fingerprint`): sha256 over the
   source of every module a stage capture runs (engine, wire codecs,
   adjacency cache, exchange backends, storage formats, the RADS kernels'
   ops, bindings and plain versions), over every RADS CUDA source with
   the local headers it includes, and over ``build.NVCC_FLAGS``;
3. **stage context** (:func:`stage_context`): the stage key, the plan's
   repr, the exchange mode and the stage-relevant ``EngineConfig``
   fields, relevance per stage kind (an ``expand`` entry does not depend
   on ``wire_format``);
4. **argument signature** (:func:`arg_signature`): the nested structure
   of the arguments (``WaveState``, fetch buffers, ``AdjCache`` and
   ``DeviceGraph`` with their static geometry) and every tensor's shape
   and dtype.

Invalidation
------------
Every variation lands on another digest.  The pickled envelope records
the key material and :meth:`StageExecCache.load` refuses an envelope
whose material differs; a corrupt, truncated or stale file is warned
about ("unusable entry"), removed and counted as a miss, and the runner
then captures afresh and stores a new entry.  ``budget_bytes > 0``
bounds the store: after every store the least-recently-used envelopes
(file mtime, refreshed by every disk hit) are evicted until it fits.
Writes go through ``tempfile`` and ``os.replace``, so concurrent runs on
one host never see a torn file.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import importlib
import os
import pickle
import re
import subprocess
import tempfile
import warnings
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from repro_torch.obs.metrics import COUNTER, Instrument, MetricsRegistry

__all__ = ["StageExecCache", "arg_signature", "code_fingerprint",
           "stage_context", "build_exec_cache", "version_stamp",
           "install_libraries", "library_payload"]

_ENVELOPE_VERSION = 1
_SUFFIX = ".stagex"
# what a payload may name: a library of repro_torch.kernels.build
_LIB_NAME = re.compile(r"^lib[A-Za-z0-9_]+-[0-9a-f]{16}\.so$")

# in-process memo of loaded payloads: (store path, digest) -> payload
_LOADED_MEMO: dict[tuple[str, str], dict] = {}


def _store_stats_registry() -> MetricsRegistry:
    """The store's counters, each starting at 0 so that ``dict(stats)``
    and counter deltas see every key."""
    reg = MetricsRegistry(Instrument(n, COUNTER, "", d) for n, d in (
        ("hits", "entries loaded (memo or disk)"),
        ("misses", "lookups with no entry"),
        ("stores", "fresh entries persisted"),
        ("errors", "corrupt/stale/unwritable entries degraded"),
        ("evictions", "LRU garbage-collected envelopes")))
    for ins in reg.instruments():
        reg[ins.name] = 0
    return reg


# --------------------------------------------------------------------------- #
# Layer 4: argument signature
# --------------------------------------------------------------------------- #
def arg_signature(args) -> tuple:
    """Hashable signature of a stage call's arguments: their nested
    structure (dataclass fields, tuples, ``None``, static Python values
    such as a device graph's geometry) and every tensor's or array's
    shape and dtype.  The device is not part of it, so tensors on the
    ``meta`` device give a real call's signature."""
    if isinstance(args, torch.Tensor):
        return ("T", tuple(args.shape), str(args.dtype))
    if isinstance(args, np.ndarray):
        return ("A", tuple(args.shape), str(args.dtype))
    if dataclasses.is_dataclass(args) and not isinstance(args, type):
        return (type(args).__name__,
                tuple((f.name, arg_signature(getattr(args, f.name)))
                      for f in dataclasses.fields(args)))
    if isinstance(args, (tuple, list)):
        return ("tuple", tuple(arg_signature(a) for a in args))
    if args is None or isinstance(args, (bool, int, float, str)):
        return ("py", type(args).__name__, args)
    raise TypeError(f"no signature for a stage argument of type "
                    f"{type(args).__name__}")


# --------------------------------------------------------------------------- #
# Layers 1 and 2: environment stamp and code fingerprint
# --------------------------------------------------------------------------- #
_NVCC_RELEASE: str | None = None


def _nvcc_release() -> str:
    """The last line of ``nvcc --version`` (its release), read once;
    ``"none"`` where there is no compiler."""
    global _NVCC_RELEASE
    if _NVCC_RELEASE is None:
        from repro_torch.kernels import build
        try:
            out = subprocess.run([build.nvcc_path(), "--version"],
                                 capture_output=True, text=True, timeout=60)
            lines = out.stdout.strip().splitlines()
            _NVCC_RELEASE = lines[-1] if lines else "unknown"
        except (RuntimeError, OSError, subprocess.SubprocessError):
            _NVCC_RELEASE = "none"
    return _NVCC_RELEASE


def version_stamp() -> tuple:
    """Layer 1: what a stored library and a capture are only valid on."""
    if torch.cuda.is_available():
        i = torch.cuda.current_device()
        dev = (torch.cuda.get_device_name(i),
               tuple(torch.cuda.get_device_capability(i)))
    else:
        dev = ("cpu",)
    return (torch.__version__, torch.version.cuda, _nvcc_release(), dev,
            torch.cuda.device_count())


# the modules whose code a stage capture runs
_TRACED_MODULES = (
    "repro_torch.core.engine", "repro_torch.core.wire",
    "repro_torch.core.cache", "repro_torch.core.exchange",
    "repro_torch.graph.storage",
    "repro_torch.kernels.membership.ops",
    "repro_torch.kernels.membership.kernel",
    "repro_torch.kernels.membership.ref",
    "repro_torch.kernels.intersect.ops",
    "repro_torch.kernels.intersect.kernel",
    "repro_torch.kernels.intersect.ref",
    "repro_torch.kernels.varint.ops", "repro_torch.kernels.varint.kernel",
    "repro_torch.kernels.varint.ref",
)
_RADS_KERNELS = ("membership", "intersect", "varint")
_CODE_FP: str | None = None


def _kernel_sources() -> list[Path]:
    root = Path(__file__).resolve().parents[1] / "kernels"
    return sorted(p for k in _RADS_KERNELS
                  for p in (root / k / "csrc").glob("*.cu"))


def code_fingerprint() -> str:
    """Layer 2: sha256 over the traced modules' sources, the RADS CUDA
    sources with their local headers, and the ``nvcc`` flags.  Memoized
    per process."""
    global _CODE_FP
    if _CODE_FP is None:
        from repro_torch.kernels import build
        h = hashlib.sha256()
        for name in _TRACED_MODULES:
            src = getattr(importlib.import_module(name), "__file__", None)
            h.update(name.encode())
            if src and os.path.exists(src):
                h.update(Path(src).read_bytes())
        for src in _kernel_sources():
            h.update(src.name.encode() + b"\0" + src.read_bytes())
            for header in build.local_headers(src):
                h.update(header.name.encode() + b"\0" + header.read_bytes())
        h.update(" ".join(build.NVCC_FLAGS).encode())
        _CODE_FP = h.hexdigest()
    return _CODE_FP


# --------------------------------------------------------------------------- #
# Layer 3: stage context
# --------------------------------------------------------------------------- #
def stage_context(stage_key, cfg, exch_mode: str, plan_repr: str) -> tuple:
    """Everything a stage's capture reads that the argument signature
    does not show, field by field as the reference chooses them (a
    spurious miss costs one capture, a spurious hit a wrong result).
    ``use_pallas_kernels`` stays in the tuple because the config has the
    field, though the port does not read it."""
    kind = stage_key if isinstance(stage_key, str) else stage_key[0]
    comm = (bool(getattr(cfg, "comm_pipeline", False)),
            int(getattr(cfg, "comm_chunks", 1)))
    if kind == "fetch":
        knobs = (cfg.fetch_cap, cfg.wire_format, cfg.use_pallas_kernels,
                 cfg.enable_cache, cfg.cache_slots, cfg.cache_ways,
                 cfg.cache_decay) + comm
    elif kind == "expand":
        knobs = (cfg.frontier_cap, cfg.use_pallas_kernels)
    elif kind == "verify":
        knobs = (cfg.verify_cap, cfg.wire_format,
                 cfg.use_pallas_kernels) + comm
    else:                      # init / finalize: pure shape transformers
        knobs = ()
    return (repr(stage_key), plan_repr, exch_mode, kind, knobs)


# --------------------------------------------------------------------------- #
# Payload: the kernel libraries of a stage
# --------------------------------------------------------------------------- #
def library_payload(paths) -> dict[str, bytes]:
    """The bytes of the built libraries ``paths``, by file name."""
    return {Path(p).name: Path(p).read_bytes() for p in sorted(paths)}


def install_libraries(payload: dict[str, bytes]) -> int:
    """Write every library of ``payload`` that is missing from the build
    directory into place (``tempfile`` + ``os.replace``).  Returns the
    number written."""
    from repro_torch.kernels import build
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    wrote = 0
    for name, blob in payload.items():
        dst = build.BUILD_DIR / name
        if dst.is_file():
            continue
        fd, tmp = tempfile.mkstemp(dir=build.BUILD_DIR, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(blob)
            os.replace(tmp, dst)
        except OSError:
            with contextlib.suppress(OSError):
                os.remove(tmp)
            raise
        wrote += 1
    return wrote


def _check_payload(payload) -> dict:
    if not isinstance(payload, dict) or not all(
            isinstance(k, str) and _LIB_NAME.match(k)
            and isinstance(v, bytes) for k, v in payload.items()):
        raise ValueError("payload is not a set of kernel libraries")
    return payload


# --------------------------------------------------------------------------- #
# The store
# --------------------------------------------------------------------------- #
@dataclass
class StageExecCache:
    """Per-host on-disk store of stage entries (module docstring).

    ``stats`` counts ``hits`` (entry loaded, memo or disk), ``misses``
    (no entry), ``stores`` (entries persisted), ``errors`` (corrupt,
    stale or unwritable entries, degraded to a miss or a skipped store)
    and ``evictions`` (LRU garbage collection).  ``budget_bytes > 0``
    bounds the store's size on disk; ``0`` keeps it unbounded."""

    path: str
    budget_bytes: int = 0
    stats: MetricsRegistry = field(default_factory=_store_stats_registry)

    def __post_init__(self):
        self.path = os.path.abspath(self.path)
        # libraries are plain files: the store can always persist them
        self.enabled = True
        os.makedirs(self.path, exist_ok=True)

    # -- keying ------------------------------------------------------------- #
    def digest(self, stage_key, sig: tuple, context: tuple) -> str:
        """sha256 of the four key layers (module docstring)."""
        return hashlib.sha256(
            self._material(sig, context).encode()).hexdigest()

    def _material(self, sig: tuple, context: tuple) -> str:
        return repr((_ENVELOPE_VERSION, version_stamp(), code_fingerprint(),
                     context, sig))

    def _file(self, digest: str) -> str:
        return os.path.join(self.path, digest + _SUFFIX)

    # -- load / store ------------------------------------------------------- #
    def load(self, digest: str, sig: tuple, context: tuple):
        """The entry's payload (libraries by name) or ``None`` (miss).
        A corrupt, truncated or stale file is demoted to a miss with a
        warning and removed."""
        memo_key = (self.path, digest)
        payload = _LOADED_MEMO.get(memo_key)
        if payload is not None:
            self.stats["hits"] += 1
            return payload
        fname = self._file(digest)
        if not os.path.exists(fname):
            self.stats["misses"] += 1
            return None
        try:
            with open(fname, "rb") as f:
                env = pickle.load(f)
            if (not isinstance(env, dict)
                    or env.get("version") != _ENVELOPE_VERSION
                    or env.get("material") != self._material(sig, context)):
                raise ValueError("stale or mismatched cache envelope")
            payload = _check_payload(env.get("payload"))
        except Exception as e:   # corrupt pickle, stale build, bad envelope
            self.stats["errors"] += 1
            self.stats["misses"] += 1
            warnings.warn(
                f"compile cache: dropping unusable entry {fname}: {e!r} "
                f"(capturing afresh)", RuntimeWarning, stacklevel=2)
            with contextlib.suppress(OSError):
                os.remove(fname)
            return None
        with contextlib.suppress(OSError):
            os.utime(fname, None)   # LRU touch: a disk hit is recent use
        _LOADED_MEMO[memo_key] = payload
        self.stats["hits"] += 1
        return payload

    def store(self, digest: str, sig: tuple, context: tuple,
              payload: dict) -> bool:
        """Persist a fresh entry (atomic replace)."""
        blob = pickle.dumps(dict(version=_ENVELOPE_VERSION,
                                 material=self._material(sig, context),
                                 payload=_check_payload(payload)))
        fd, tmp = tempfile.mkstemp(dir=self.path, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(blob)
            os.replace(tmp, self._file(digest))
        except OSError:
            self.stats["errors"] += 1
            with contextlib.suppress(OSError):
                os.remove(tmp)
            return False
        self.stats["stores"] += 1
        self._gc()
        return True

    # -- maintenance -------------------------------------------------------- #
    def _gc(self) -> int:
        """Evict least-recently-used envelopes until the store fits
        ``budget_bytes``; the entry just stored is the freshest, so it
        goes last.  A file another run removed is already evicted."""
        if self.budget_bytes <= 0:
            return 0
        stats = []
        try:
            names = os.listdir(self.path)
        except OSError:
            return 0
        for name in names:
            if not name.endswith(_SUFFIX):
                continue
            fname = os.path.join(self.path, name)
            with contextlib.suppress(OSError):
                st = os.stat(fname)
                stats.append((st.st_mtime, st.st_size, fname))
        total = sum(s for _, s, _ in stats)
        evicted = 0
        for _, size, fname in sorted(stats):          # oldest first
            if total <= self.budget_bytes:
                break
            try:
                os.remove(fname)
            except OSError:
                continue
            total -= size
            evicted += 1
        self.stats["evictions"] += evicted
        return evicted

    @staticmethod
    def clear_memory_memo() -> None:
        """Drop the in-process memo of loaded payloads (forces the disk
        path; tests and the warm-store check use it)."""
        _LOADED_MEMO.clear()

    def entries(self) -> list[str]:
        """Digests currently stored on disk (sorted)."""
        if not os.path.isdir(self.path):
            return []
        return sorted(f[:-len(_SUFFIX)] for f in os.listdir(self.path)
                      if f.endswith(_SUFFIX))


def build_exec_cache(cfg) -> StageExecCache | None:
    """The store ``EngineConfig`` asks for (``None`` = disabled)."""
    if not getattr(cfg, "compile_cache_dir", ""):
        return None
    return StageExecCache(
        cfg.compile_cache_dir,
        budget_bytes=int(getattr(cfg, "compile_cache_budget_bytes", 0)))
