"""RIR matmul on Hopper: the CUDA kernel's build, binding and launch wrapper.

The kernel (``csrc/rir_matmul.cu``) is the Hopper counterpart of the JAX
package's Pallas ``rir_matmul_p``: ``a @ b`` with an fp32 accumulator whose
epilogue stores output column block ``j`` at block slot ``perm[j]``, so the
producing GEMM writes the consumer's layout directly (Reorder-In-Reduction),
with an optional residual read through the same permuted map.

Build: at first CUDA use ``nvcc`` compiles the source for ``sm_90a`` into a
shared library with a plain C interface under ``build/kernels/`` at the root
of the checkout, named by a hash of the source and flags, and ``ctypes``
loads it.  Importing this module builds nothing, so it imports on machines
without CUDA; a missing ``nvcc`` or a failed compile raises with the
compiler's output.  There is no fallback: a CUDA tensor gets the kernel or an
exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
import weakref
from typing import Dict, Optional, Tuple

import torch

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "rir_matmul.cu"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: the kernel's output tile width: ``block_n`` must be a multiple of it
TILE_N = 64
DTYPES = (torch.float32, torch.bfloat16)

_lock = threading.Lock()
_lib = None
_launches = 0
#: what the last build in this process printed (``-Xptxas -v``: registers,
#: shared memory, spills) and how long it took; empty / 0 when the library
#: was already built
build_log = ""
build_seconds = 0.0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the rir_matmul CUDA kernel is "
                       "compiled from source at first CUDA use and needs "
                       "the CUDA toolkit")


def library_path() -> pathlib.Path:
    """Where the built library lives, keyed by a hash of source + flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"librir_matmul-{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the kernel unless this source was already built; its path."""
    global build_log, build_seconds
    path = library_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}: "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)      # atomic: a concurrent loader sees all or none
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    return path


def load() -> ctypes.CDLL:
    """Build (if needed) and bind the library; thread-safe, once a process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name in ("rir_matmul_f32", "rir_matmul_bf16"):
                fn = getattr(lib, name)
                fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
                    + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


#: id -> (weak reference, version) of every perm tensor whose values were
#: checked as a permutation: the kernel stores at ``perm[j] * block_n``, so
#: an unchecked value would write outside the output
_checked_perms: Dict[int, Tuple[weakref.ref, int]] = {}


def register_perm(perm: torch.Tensor) -> torch.Tensor:
    """Mark ``perm``, whose values the caller has checked, as launchable."""
    key = id(perm)
    ref = weakref.ref(perm, lambda _, k=key: _checked_perms.pop(k, None))
    with _lock:
        _checked_perms[key] = (ref, perm._version)
    return perm


def _is_checked_perm(perm: torch.Tensor) -> bool:
    """Registered, and not written in place since (``_version`` moves on)."""
    entry = _checked_perms.get(id(perm))
    return entry is not None and entry[0]() is perm \
        and entry[1] == perm._version


def launch_count() -> int:
    """Kernel launches since the last ``reset_launch_count``."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    with _lock:
        _launches = 0


def _check(a: torch.Tensor, b: torch.Tensor, perm: torch.Tensor,
           residual: Optional[torch.Tensor], block_n: int) -> None:
    if a.device.type != "cuda":
        raise ValueError(f"rir_matmul_cuda needs CUDA tensors, got {a.device}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"bad GEMM shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    M, K = a.shape
    N = b.shape[1]
    if min(M, K, N) < 1 or max(M, K, N) >= 2 ** 31:
        raise ValueError(f"GEMM extents out of range: M={M} K={K} N={N}")
    if a.dtype not in DTYPES or b.dtype != a.dtype:
        raise TypeError(f"dtypes {a.dtype}/{b.dtype}: need both float32 or "
                        f"both bfloat16")
    if block_n < TILE_N or block_n % TILE_N or N % block_n:
        raise ValueError(f"N={N} must be a multiple of block_n={block_n}, "
                         f"itself a multiple of {TILE_N}")
    if perm.dtype != torch.int32 or perm.shape != (N // block_n,):
        raise ValueError(f"perm must be int32[{N // block_n}], got "
                         f"{perm.dtype}{list(perm.shape)}")
    if not _is_checked_perm(perm):
        raise ValueError("perm tensor was not made by ops.device_perm: its "
                         "values are unchecked, and the kernel stores at "
                         "perm[j] * block_n")
    tensors = [a, b, perm]
    if residual is not None:
        if residual.shape != (M, N) or residual.dtype != a.dtype:
            raise ValueError(f"residual {residual.dtype}"
                             f"{list(residual.shape)} != {a.dtype}[{M}, {N}]")
        tensors.append(residual)
    for t in tensors:
        if t.device != a.device:
            raise ValueError(f"operands on {t.device} and {a.device}")
        if not t.is_contiguous():
            raise ValueError("rir_matmul_cuda operands must be contiguous")


def rir_matmul_cuda(a: torch.Tensor, b: torch.Tensor, perm: torch.Tensor, *,
                    residual: Optional[torch.Tensor] = None,
                    block_n: int = 128) -> torch.Tensor:
    """Launch the kernel: ``(M, N)`` output, block ``j`` stored at ``perm[j]``.

    ``perm`` is a device int32 tensor from ``ops.device_perm``, which checks
    its values (the executor caches one per step at prepare time, so a launch
    copies nothing from the host); any other tensor raises.  The launch goes
    on PyTorch's current stream and does not synchronise; a launch the driver
    refuses raises here.
    """
    _check(a, b, perm, residual, block_n)
    global _launches
    M, K = a.shape
    N = b.shape[1]
    lib = load()
    fn = lib.rir_matmul_f32 if a.dtype == torch.float32 \
        else lib.rir_matmul_bf16
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), perm.data_ptr(),
                 residual.data_ptr() if residual is not None else None,
                 out.data_ptr(), M, K, N, block_n,
                 torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rir_matmul launch failed: cudaError_t {err} "
                           f"(M={M} K={K} N={N} block_n={block_n})")
    with _lock:
        _launches += 1
    return out
