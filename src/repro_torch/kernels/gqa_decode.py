"""Flash-decode GQA attention on Hopper: the CUDA kernel's binding and launch.

The kernel (``csrc/gqa_decode.cu``) is the Hopper counterpart of the JAX
package's Pallas ``gqa_decode``: one query token per sequence attends over
a ``(B, S, Hkv, D)`` KV cache, the ``G = Hq / Hkv`` query heads of a KV head
sharing each K/V row, positions ``>= lengths[b]`` taking no part, with an
online softmax in f32.  Where the TPU kernel walks S in order inside one
program per (b, h), the CUDA kernel splits S into fixed 128-position splits
(one CTA each, skipped past the row's length) and merges the splits of each
query row in order in a second kernel.  The split length depends on nothing
else, so a row's output does not depend on the batch it is decoded in.

Build: at first CUDA use ``build.load`` compiles the source with ``nvcc``
for ``sm_90a`` into ``build/kernels/`` and binds it with ``ctypes``.
Importing this module builds nothing.  There is no fallback: a CUDA tensor
gets the kernel or an exception.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import build as _build

NAME = "gqa_decode"
SOURCE = _build.CSRC / f"{NAME}.cu"
#: positions per split (one CTA each) and K/V rows per shared-memory tile;
#: mirrors ``kSplit`` / ``kTile`` in the source
SPLIT = 128
TILE = 32
#: head dims the kernel takes: multiples of 16 in [16, 256]
D_MIN, D_MAX = 16, 256
#: shared memory a block may opt in to on Hopper
MAX_SMEM = 232448
DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 \
    + [ctypes.c_float, ctypes.c_void_p]

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
                NAME, {"gqa_decode_f32": _ARGTYPES,
                       "gqa_decode_bf16": _ARGTYPES})
    return _lib


def launch_count() -> int:
    """Kernel launches since the last ``reset_launch_count``."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    with _lock:
        _launches = 0


def n_splits(S: int) -> int:
    """Splits (CTAs per (b, h)) the kernel launches for a cache of S."""
    return -(-S // SPLIT)


def smem_bytes(G: int, D: int) -> int:
    """The split kernel's dynamic shared memory: q and acc (G x D), the K
    and V tiles (TILE x D), the scores (G x TILE) and m, l, alpha (G)."""
    return 4 * (2 * G * D + 2 * TILE * D + G * TILE + 3 * G)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           lengths: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"gqa_decode_cuda needs CUDA tensors, got {q.device}")
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}: need q (B, Hq, D) and k, v "
                         f"(B, S, Hkv, D)")
    B, Hq, D = q.shape
    _, S, Hkv, Dk = k.shape
    if k.shape[0] != B or Dk != D:
        raise ValueError(f"q{tuple(q.shape)} and k{tuple(k.shape)} disagree "
                         f"on B or D")
    # grid (splits, Hkv, B) for the split kernel, B * Hq blocks for the merge
    if min(B, Hq, Hkv, S) < 1 or max(B, Hkv) > 65535 \
            or max(S, B * Hq) >= 2 ** 31:
        raise ValueError(f"extents out of range: B={B} Hq={Hq} Hkv={Hkv} "
                         f"S={S} D={D}")
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if not (D_MIN <= D <= D_MAX) or D % 16:
        raise ValueError(f"head dim D={D}: the kernel takes multiples of 16 "
                         f"in [{D_MIN}, {D_MAX}]")
    if smem_bytes(Hq // Hkv, D) > MAX_SMEM:
        raise ValueError(f"G={Hq // Hkv}, D={D} needs "
                         f"{smem_bytes(Hq // Hkv, D)} bytes of shared memory,"
                         f" more than {MAX_SMEM}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: need all "
                        f"float32 or all bfloat16")
    if lengths.dtype != torch.int32 or lengths.shape != (B,):
        raise ValueError(f"lengths must be int32[{B}], got "
                         f"{lengths.dtype}{list(lengths.shape)}")
    for t in (q, k, v, lengths):
        if t.device != q.device:
            raise ValueError(f"operands on {t.device} and {q.device}")
        if not t.is_contiguous():
            raise ValueError("gqa_decode_cuda operands must be contiguous")
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("gqa_decode_cuda operands must be 16-byte "
                             "aligned (the kernel loads 16 bytes at a time)")


def gqa_decode_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: ``(B, Hq, D)`` in q's dtype.

    ``lengths`` is a device int32 tensor, read by the kernel (no host
    copy).  The launch goes on PyTorch's current stream and does not
    synchronise; a launch the CUDA runtime refuses raises here.
    """
    _check(q, k, v, lengths)
    global _launches
    B, Hq, D = q.shape
    _, S, Hkv, _ = k.shape
    G = Hq // Hkv
    ns = n_splits(S)
    lib = load()
    fn = lib.gqa_decode_f32 if q.dtype == torch.float32 \
        else lib.gqa_decode_bf16
    part_ml = torch.empty((B, Hkv, ns, G, 2), dtype=torch.float32,
                          device=q.device)
    part_acc = torch.empty((B, Hkv, ns, G, D), dtype=torch.float32,
                           device=q.device)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                 part_ml.data_ptr(), part_acc.data_ptr(), out.data_ptr(),
                 B, Hq, Hkv, S, D, ns, 1.0 / (D ** 0.5),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gqa_decode launch failed: cudaError_t {err} "
                           f"(B={B} Hq={Hq} Hkv={Hkv} S={S} D={D})")
    with _lock:
        _launches += 1
    return out
