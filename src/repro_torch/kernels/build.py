"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/*.cu`` file exports a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own ``.so`` under ``build/kernels/`` at
the repository root (listed in ``.gitignore``), named by the hash of the
source so an edited kernel is rebuilt and an unchanged one is reused.
The libraries are loaded with :mod:`ctypes`: no PyTorch headers are
compiled, which keeps a build to seconds.  Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[Path, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are built on the machine that has the card")
    return found


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{source.stem}-{digest[:16]}.so"


def build(sources: list[Path]) -> dict[Path, float]:
    """Compile every source whose library is missing, all ``nvcc``
    processes started together.  Returns seconds per source built; the
    compiler's report (``-Xptxas -v``: registers, shared memory, spills)
    lands beside each library as ``.log``.  Raises on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in sources:
        lib = library_path(src)
        if lib.is_file():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, lib, time.perf_counter())
    took = {}
    failed = []
    for src, (proc, tmp, lib, t0) in procs.items():
        out, _ = proc.communicate()
        took[src] = time.perf_counter() - t0
        lib.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return took


def load(source: Path) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if it is missing."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            build([source])
            lib = _loaded[source] = ctypes.CDLL(str(library_path(source)))
        return lib
