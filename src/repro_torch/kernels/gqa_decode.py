"""Flash-decode GQA attention on Hopper: the CUDA kernel's binding and launch.

The kernel (``csrc/gqa_decode.cu``) is the Hopper counterpart of the JAX
package's Pallas ``gqa_decode``: one query token per sequence attends over
a ``(B, S, Hkv, D)`` KV cache, the ``G = Hq / Hkv`` query heads of a KV head
sharing each K/V row, positions ``>= lengths[b]`` taking no part, with an
online softmax in f32.  Where the TPU kernel walks S in order inside one
program per (b, h), the CUDA kernel splits S into fixed splits of two
32-row tiles a warp (``split_len``: 256, or 128 for f32 rows wider than
128), one CTA each, skipped past the row's length, each warp streaming its
tiles through a three-slot ring; the CTA that finishes a row's last split
merges the row's splits in order, in the same launch.  The split length
depends on D and the type only, so a row's output does not depend on the
batch it is decoded in.

The merge's arrival counters and partials live in a workspace that this
module keeps per (device, stream), grown on demand and never shared by two
streams; the kernel leaves the counters at 0, so after the first call on a
stream the output is the only allocation a call makes.

``gqa_decode_partial_cuda`` is the same launch asked also for each row's
``(m, l)`` (f32 ``(B, Hq)``: the largest scaled score and ``sum exp(s -
m)``), which the kernel stores on every exit, ``(-inf, 0)`` beside the
zero output of a row of length 0: what ranks holding a cache split by
sequence need to merge their outputs by log-sum-exp.  It counts its
launches apart (``partial_launch_count``).

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

NAME = "gqa_decode"
SOURCE = _build.CSRC / f"{NAME}.cu"
#: the kernel's name in a profile (one launch a call)
KERNEL = "gqa_decode_kernel"
#: rows a tile (one a lane), tiles a warp takes in a split, tile slots in
#: a warp's ring, warps a CTA at most, query heads a CTA at most and the
#: bytes after each shared-memory K/V row; mirror ``kWarpRows``,
#: ``kWarpTiles``, ``kSlots``, ``kMaxWarps``, ``kMaxGroup`` and ``kRowPad``
#: in the source
WARP_ROWS = 32
WARP_TILES = 2
SLOTS = 3
MAX_WARPS = 4
MAX_GROUP = 8
ROW_PAD = 16
#: the split length at every shape the port serves (bf16, and f32 with
#: D <= 128)
SPLIT = WARP_ROWS * WARP_TILES * MAX_WARPS
#: head dims the kernel takes: multiples of 16 in [16, 256]
D_MIN, D_MAX = 16, 256
#: shared memory a block may opt in to on Hopper
MAX_SMEM = 232448
DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 \
    + [ctypes.c_float, ctypes.c_void_p]

_lock = threading.Lock()
_lib = None
_launches = 0
_partial_launches = 0
#: workspace per (device index, stream handle): the int32 arrival
#: counters (kept at 0 by the kernel) and the f32 partials
_workspaces: dict = {}
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
    """``gqa_decode_cuda`` launches since the last ``reset_launch_count``."""
    return _launches


def partial_launch_count() -> int:
    """``gqa_decode_partial_cuda`` launches since the last
    ``reset_launch_count``."""
    return _partial_launches


def reset_launch_count() -> None:
    """Set both counts to 0."""
    global _launches, _partial_launches
    with _lock:
        _launches = _partial_launches = 0


def group_width(G: int) -> int:
    """Query heads a CTA takes: the smallest of 1, 2, 4, 8 that holds
    ``min(G, MAX_GROUP)``; a G above 8 runs in groups of 8."""
    return next(c for c in (1, 2, 4, MAX_GROUP) if c >= min(G, MAX_GROUP))


def _smem(nw: int, gc: int, D: int, itemsize: int) -> int:
    """nw warps' rings (SLOTS tiles of 32 padded rows), q (gc x D f32), p
    (nw x gc x 32 f32), (m, l) (nw x gc f32) and a 16-byte flag."""
    return nw * SLOTS * WARP_ROWS * (D * itemsize + ROW_PAD) \
        + 4 * (gc * D + nw * gc * WARP_ROWS + nw * gc * 2) + 16


def warps(D: int, itemsize: int) -> int:
    """Warps a CTA: four where four warps' rings fit beside the largest
    group, else two."""
    return MAX_WARPS if _smem(MAX_WARPS, MAX_GROUP, D, itemsize) <= MAX_SMEM \
        else MAX_WARPS // 2


def split_len(D: int, itemsize: int) -> int:
    """Positions a split (one CTA) holds."""
    return WARP_ROWS * WARP_TILES * warps(D, itemsize)


def n_splits(S: int, D: int, itemsize: int) -> int:
    """Splits (CTAs per (b, h, group)) the kernel launches for a cache of S."""
    return -(-S // split_len(D, itemsize))


def smem_bytes(G: int, D: int, itemsize: int) -> int:
    """The kernel's dynamic shared memory for G query heads a KV head."""
    return _smem(warps(D, itemsize), group_width(G), D, itemsize)


def workspace_sizes(B: int, Hq: int, Hkv: int, S: int, D: int,
                    itemsize: int) -> tuple:
    """``(counters, ml floats, acc floats)`` a call needs: an int32 counter
    a (b, h, group), and (m, l) and the acc of every (b, h, split, query
    head) in f32."""
    G = Hq // Hkv
    parts = B * Hkv * n_splits(S, D, itemsize) * G
    return B * Hkv * -(-G // group_width(G)), 2 * parts, parts * D


def _workspace(device: torch.device, stream, counters: int,
               floats: int) -> tuple:
    """The (counters, partials) of (device, stream), at least ``counters``
    int32 and ``floats`` f32 long; either is replaced when too short, the
    counters by zeros (the kernel keeps them 0 from then on).  Allocated on
    ``stream``, which is the current stream."""
    key = (device.index, stream.cuda_stream)
    with _lock:
        cnt, part = _workspaces.get(key, (None, None))
        if cnt is None or cnt.numel() < counters:
            cnt = torch.zeros(counters, dtype=torch.int32, device=device)
        if part is None or part.numel() < floats:
            part = torch.empty(floats, dtype=torch.float32, device=device)
        _workspaces[key] = (cnt, part)
    return cnt, part


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
    if min(B, Hq, Hkv, S) < 1:
        raise ValueError(f"empty extents: B={B} Hq={Hq} Hkv={Hkv} S={S}")
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    G = Hq // Hkv
    # grid (splits, Hkv * groups, B)
    if B > 65535 or Hkv * -(-G // group_width(G)) > 65535 \
            or max(S, B * Hq) >= 2 ** 31:
        raise ValueError(f"extents out of range: B={B} Hq={Hq} Hkv={Hkv} "
                         f"S={S} D={D}")
    if not (D_MIN <= D <= D_MAX) or D % 16:
        raise ValueError(f"head dim D={D}: the kernel takes multiples of 16 "
                         f"in [{D_MIN}, {D_MAX}]")
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


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            lengths: torch.Tensor, ml: bool) -> tuple:
    """One launch; returns ``(out, m, l)``, ``m`` and ``l`` None unless
    ``ml``."""
    _check(q, k, v, lengths)
    B, Hq, D = q.shape
    _, S, Hkv, _ = k.shape
    item = q.element_size()
    lib = load()
    fn = lib.gqa_decode_f32 if q.dtype == torch.float32 \
        else lib.gqa_decode_bf16
    n_cnt, n_ml, acc = workspace_sizes(B, Hq, Hkv, S, D, item)
    stream = torch.cuda.current_stream(q.device)
    cnt, part = _workspace(q.device, stream, n_cnt, n_ml + acc)
    out = torch.empty_like(q)
    m = l = None
    if ml:
        m = torch.empty((B, Hq), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                 cnt.data_ptr(), part.data_ptr(), part.data_ptr() + 4 * n_ml,
                 out.data_ptr(), None if m is None else m.data_ptr(),
                 None if l is None else l.data_ptr(),
                 B, Hq, Hkv, S, D, n_splits(S, D, item), 1.0 / (D ** 0.5),
                 stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"gqa_decode launch failed: cudaError_t {err} "
                           f"(B={B} Hq={Hq} Hkv={Hkv} S={S} D={D})")
    return out, m, l


def gqa_decode_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: ``(B, Hq, D)`` in q's dtype.

    ``lengths`` is a device int32 tensor, read by the kernel (no host
    copy).  The launch goes on PyTorch's current stream and does not
    synchronise; a launch the CUDA runtime refuses raises here.  The
    output is the call's only allocation once the stream has a workspace
    large enough.
    """
    global _launches
    out, _, _ = _launch(q, k, v, lengths, False)
    with _lock:
        _launches += 1
    return out


def gqa_decode_partial_cuda(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, lengths: torch.Tensor
                            ) -> tuple:
    """The kernel with each row's ``(m, l)``: ``(out (B, Hq, D) in q's
    dtype, m (B, Hq) f32, l (B, Hq) f32)``; a row of length <= 0 gives
    ``(0, -inf, 0)``.  Launched as ``gqa_decode_cuda`` is."""
    global _partial_launches
    out = _launch(q, k, v, lengths, True)
    with _lock:
        _partial_launches += 1
    return out


def work(B: int, Hq: int, Hkv: int, D: int, rows: int, itemsize: int,
         ml: bool = False) -> Work:
    """One call's work from its shapes alone: ``rows`` K/V rows read over
    the batch (the sum of the lengths where the caller knows them; ``B
    S``, every cache row, an upper bound, where it does not), q and the
    output moved once and the int32 lengths read; q.k and p.v over those
    rows, 2 operations a multiply-add, on the tensor cores for a 2-byte
    type.  ``ml``: the partial variant, which also writes each row's f32
    ``(m, l)``, 8 bytes a (b, query head)."""
    nbytes = itemsize * (2 * rows * Hkv * D + 2 * B * Hq * D) + 4 * B \
        + (8 * B * Hq if ml else 0)
    return Work(4.0 * rows * Hq * D, float(nbytes),
                "bf16" if itemsize == 2 else "fp32")
