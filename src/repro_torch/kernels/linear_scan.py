"""Chunked gated linear attention on Hopper: the CUDA kernel's binding and
launch.

The kernel (``csrc/linear_scan.cu``) is the Hopper counterpart of the JAX
package's Pallas ``linear_scan``: per (b, h) the recurrence
``h_t = exp(logw_t) * h_{t-1} + k_t^T v_t``, ``y_t = q_t h_t`` with an f32
``(dk, dv)`` state, computed in chunks of 64 steps (three small products a
chunk, intra-chunk scores through 16-row blocks, every exponent <= 0).
Where the TPU grid walks the chunks of one (b, h) in order and carries the
state in VMEM scratch, one CTA takes one (b, h) and walks its chunks in a
loop with the state in shared memory; at bf16 64/64 its buffers take 99 KB,
so two CTAs share an SM.  The last chunk of a T that 64 does not divide is
masked (its padding counts as k = v = 0, log decay 0), so any T runs the
kernel.  There is no backward kernel: ``ops.linear_scan`` recomputes
through the plain chunked version, as the JAX package does.

Build: at first CUDA use ``build.load`` compiles the source with ``nvcc``
for ``sm_90a`` into ``build/kernels/`` and binds it with ``ctypes``.
Importing this module builds nothing.  There is no fallback: a CUDA tensor
gets the kernel or an exception.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.core.gpu_cost import Work

from . import build as _build
from .ref import CHUNK, SUB  # noqa: F401  (the kernel's kChunk / kSub)

NAME = "linear_scan"
SOURCE = _build.CSRC / f"{NAME}.cu"
#: the kernel's name in a profile
KERNEL = "linear_scan_kernel"
#: head dims the kernel is instantiated for (dk and dv each)
HEAD_DIMS = (16, 32, 64)
DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]

_lock = threading.Lock()
_lib = None
_launches = 0
#: what the last build in this process printed (``-Xptxas -v``) and how
#: long it took; empty / 0 when the library was already built
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
                NAME, {"linear_scan_f32": _ARGTYPES,
                       "linear_scan_bf16": _ARGTYPES})
    return _lib


def launch_count() -> int:
    """Kernel launches since the last ``reset_launch_count``."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    with _lock:
        _launches = 0


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           log_decay: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"linear_scan_cuda needs CUDA tensors, got "
                         f"{q.device}")
    if q.dim() != 4 or k.shape != q.shape or log_decay.shape != q.shape \
            or v.dim() != 4 or v.shape[:3] != q.shape[:3]:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} log_decay"
                         f"{tuple(log_decay.shape)}: need q, k, log_decay "
                         f"(B, H, T, dk) and v (B, H, T, dv)")
    B, H, T, dk = q.shape
    dv = v.shape[-1]
    if min(B, H, T) < 1 or max(B * H, T) >= 2 ** 31:   # int32 arguments
        raise ValueError(f"extents out of range: B={B} H={H} T={T}")
    if dk not in HEAD_DIMS or dv not in HEAD_DIMS:
        raise ValueError(f"head dims dk={dk}, dv={dv}: the kernel takes "
                         f"{HEAD_DIMS} each")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: need q, k, v"
                        f" all float32 or all bfloat16")
    if log_decay.dtype != torch.float32:
        raise TypeError(f"log_decay must be float32, got {log_decay.dtype}")
    for t in (q, k, v, log_decay):
        if t.device != q.device:
            raise ValueError(f"operands on {t.device} and {q.device}")
        if not t.is_contiguous():
            raise ValueError("linear_scan_cuda operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("linear_scan_cuda operands must be 16-byte "
                             "aligned (the kernel stages 16 bytes at a "
                             "time)")


def linear_scan_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     log_decay: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: ``(B, H, T, dv)`` in v's dtype.

    The launch goes on PyTorch's current stream and does not synchronise;
    a launch the CUDA runtime refuses raises here.
    """
    _check(q, k, v, log_decay)
    global _launches
    B, H, T, dk = q.shape
    dv = v.shape[-1]
    lib = load()
    fn = lib.linear_scan_f32 if q.dtype == torch.float32 \
        else lib.linear_scan_bf16
    out = torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 log_decay.data_ptr(), out.data_ptr(), B * H, T, dk, dv,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"linear_scan launch failed: cudaError_t {err} "
                           f"(B={B} H={H} T={T} dk={dk} dv={dv})")
    with _lock:
        _launches += 1
    return out


def work(B: int, H: int, T: int, dk: int, dv: int, itemsize: int,
         decay_itemsize: int = 4) -> Work:
    """One call's work from its shapes alone: q, k, v and the log decay
    read once and the output (v's type) written once; the f32 operations
    the chunked scan needs, 2 for each multiply-add of its four products
    in every chunk of ``CHUNK`` steps: ``(q e^cum) h`` and the state
    update ``(k e^(cum_L - cum))^T v`` (L dk dv each), the masked scores
    over the pairs s <= t (L (L + 1) / 2 dk) and ``S v`` (the same pairs,
    dv).  Exps, the decay factors and the kernel's sub-chunk
    factorisation are left out; a ragged last chunk counts its real steps
    only."""
    ops_ = 0
    for lo in range(0, T, CHUNK):
        n = min(CHUNK, T - lo)
        ops_ += 2 * (2 * n * dk * dv + n * (n + 1) // 2 * (dk + dv))
    nbytes = B * H * T * ((2 * dk + 2 * dv) * itemsize
                          + dk * decay_itemsize)
    return Work(float(B * H * ops_), float(nbytes), "fp32")
