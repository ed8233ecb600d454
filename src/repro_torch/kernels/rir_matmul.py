"""RIR matmul on Hopper: the CUDA kernel's build, binding and launch wrapper.

The kernel (``csrc/rir_matmul.cu``) is the Hopper counterpart of the JAX
package's Pallas ``rir_matmul_p``: ``a @ b`` with an fp32 accumulator whose
epilogue stores output column block ``j`` at block slot ``perm[j]``, so the
producing GEMM writes the consumer's layout directly (Reorder-In-Reduction),
with an optional residual read through the same permuted map.

Build: at first CUDA use ``build.load`` compiles the source with ``nvcc``
for ``sm_90a`` into ``build/kernels/`` and binds it with ``ctypes``.
Importing this module builds nothing, so it imports on machines without
CUDA.  There is no fallback: a CUDA tensor gets the kernel or an
exception.
"""
from __future__ import annotations

import ctypes
import threading
import weakref
from typing import Dict, Optional, Tuple

import torch

from . import build as _build
from .build import BUILD_DIR  # noqa: F401  (re-exported: where it builds)

NAME = "rir_matmul"
SOURCE = _build.CSRC / f"{NAME}.cu"
#: the kernel's output tile width: ``block_n`` must be a multiple of it
TILE_N = 64
DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]

_lock = threading.Lock()
_lib = None
_launches = 0
#: what the last build in this process printed (``-Xptxas -v``: registers,
#: shared memory, spills) and how long it took; empty / 0 when the library
#: was already built
build_log = ""
build_seconds = 0.0


def library_path():
    """Where the built library lives, keyed by a hash of source + flags."""
    return _build.library_path(NAME)


def load() -> ctypes.CDLL:
    """Build (if needed) and bind the library; thread-safe, once a process."""
    global _lib, build_log, build_seconds
    with _lock:
        if _lib is None:
            _lib, build_log, build_seconds = _build.load(
                NAME, {"rir_matmul_f32": _ARGTYPES,
                       "rir_matmul_bf16": _ARGTYPES})
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
