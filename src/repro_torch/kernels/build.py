"""Build and load the port's CUDA kernels: ``nvcc`` into ``build/kernels/``.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface.  At
first CUDA use ``nvcc`` compiles it for ``sm_90a`` into a shared library
under ``build/kernels/`` at the root of the checkout, named by a hash of the
source and the flags, and ``ctypes`` loads it.  Nothing here runs at import
time, so the kernel modules import on machines without CUDA; a missing
``nvcc`` or a failed compile raises with the compiler's output.  Libraries
are written to a temporary name and renamed into place, so two processes
building at once never load half a file.  Builds of different kernels may
run at the same time (``nvcc`` runs outside any lock of this module).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict, List, Tuple

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    """The CUDA compiler: on ``PATH`` or under ``/usr/local/cuda``."""
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                       "compiled from source at first CUDA use and need "
                       "the CUDA toolkit")


def library_path(name: str) -> pathlib.Path:
    """Where ``lib<name>`` lives, keyed by a hash of its source and flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Tuple[pathlib.Path, str, float]:
    """Compile ``csrc/<name>.cu`` unless this source was already built.

    Returns the library's path, what ``nvcc`` printed (``-Xptxas -v``:
    registers, shared memory, spills) and the seconds it took; ``""`` and
    0.0 when the library was already there.
    """
    path = library_path(name)
    if path.exists():
        return path, "", 0.0
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}: "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)      # atomic: a concurrent loader sees all or none
    return path, proc.stdout + proc.stderr, time.perf_counter() - t0


def load(name: str, signatures: Dict[str, List]) -> Tuple[ctypes.CDLL, str,
                                                          float]:
    """Build (if needed) and bind ``lib<name>``.

    ``signatures`` maps each C entry point to its ``argtypes``; every entry
    returns an ``int`` (a ``cudaError_t``, 0 on success).  Returns the
    library, the build log and the build seconds, as ``build`` does.  The
    caller keeps the library and serialises calls to this function.
    """
    path, log, secs = build(name)
    lib = ctypes.CDLL(str(path))
    for fn_name, argtypes in signatures.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib, log, secs
