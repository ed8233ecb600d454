"""RIR matmul on Hopper: the CUDA kernel's launch plan, build, binding and
launch wrapper.

The kernel (``csrc/rir_matmul.cu``) is the Hopper counterpart of the JAX
package's Pallas ``rir_matmul_p``: ``a @ b`` with an fp32 accumulator whose
epilogue stores output column block ``j`` at block slot ``perm[j]``, so the
producing GEMM writes the consumer's layout directly (Reorder-In-Reduction),
with an optional residual read through the same permuted map.

It is an fp32 SIMT GEMM (no tensor cores: TF32 would keep about 3 digits
where the path's tolerances are fp32 ones): 128x64 CTA tiles (128x128 on
long-K steps where N allows), an 8x8 register tile a thread, a 4-stage
``cp.async`` ring of 16-deep K slices, and split-K for the deep layers'
short grids, each split's partial sums stored to an f32 workspace and
added in split order by a second kernel.  How a GEMM is cut is
``launch_plan``'s choice, a pure function the wrapper passes to the
kernel: the splits and their K ranges depend on K and N, never on M, so a
row's bits do not depend on the rows it is batched with.

Build: at first CUDA use ``build.load`` compiles the source with ``nvcc``
for ``sm_90a`` into ``build/kernels/`` and binds it with ``ctypes``.
Importing this module builds nothing, so it imports on machines without
CUDA.  There is no fallback: a CUDA tensor gets the kernel or an
exception.
"""
from __future__ import annotations

import ctypes
import dataclasses
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
#: the device kernels, as the profiler names them: the GEMM, and the sum of
#: the K-splits' partials where a launch splits K
KERNELS = ("rir_matmul_kernel", "rir_splitk_reduce_kernel")
#: a CTA tile's rows (it is 128 x 128, or 128 x 64 where N is not a
#: multiple of 128) and the depth of a K slice (``kTileM``, ``kTileK``)
TILE_M = 128
TILE_K = 16
#: K-splits: at most ``MAX_SPLITS``, each walking at least
#: ``SPLIT_MIN_SLICES`` K slices
MAX_SPLITS = 8
SPLIT_MIN_SLICES = 16
#: the least K that takes 128-wide tiles
WIDE_TILE_MIN_K = 2048
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]

_lock = threading.Lock()
_lib = None
_launches = 0
#: what the last build in this process printed (``-Xptxas -v``: registers,
#: shared memory, spills) and how long it took; empty / 0 when the library
#: was already built
build_log = ""
build_seconds = 0.0


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one GEMM is cut: the CTA tile's width, the K-splits of a tile
    and the K range each split walks."""

    tile_n: int
    splits: int
    k_bounds: Tuple[int, ...]     # splits + 1 boundaries, 0 ... K

    @property
    def kernels(self) -> Tuple[str, ...]:
        """The device kernels a launch at this cut runs."""
        return KERNELS if self.splits > 1 else KERNELS[:1]


def launch_plan(M: int, K: int, N: int, block_n: int) -> LaunchPlan:
    """The kernel's cut of an ``(M, K) @ (K, N)`` GEMM, from K and N alone.

    The CTA tile is 128 x 64 (128 threads, two or three CTAs an SM, so one
    CTA's loads and stores overlap another's FMAs), or 128 x 128 (256
    threads, one CTA an SM) where N is a multiple of 128 and K is at least
    ``WIDE_TILE_MIN_K``.  K is split only where K >= 2 N, into the largest
    power of two up to ``MAX_SPLITS``, twice the tile columns and K over
    ``SPLIT_MIN_SLICES`` slices: in a conv net the layers with K >= 2 N are the
    3x3 and reduce layers, and the wider their output the fewer their rows
    (ResNet-50's rows times N squared is about constant), so N stands in
    for the short grid the cut may not look at.  Split ``j`` walks slices
    ``[j * per, (j + 1) * per)``, ``per`` the slices over the splits rounded
    up.  ``M`` and ``block_n`` do not enter: a row's sums are taken in an
    order that depends on K and N alone, so a request gives the same bits
    alone or batched, and the epilogue maps any ``block_n``.  The rule was
    read off ``tools/kernel_bench.py --sweep`` at the ResNet-50 steps.
    """
    del M, block_n
    tile_n = 128 if N % 128 == 0 and K >= WIDE_TILE_MIN_K else 64
    cap = min(MAX_SPLITS, 2 * N // tile_n,
              K // (SPLIT_MIN_SLICES * TILE_K)) if K >= 2 * N else 1
    splits = 1
    while 2 * splits <= cap:
        splits *= 2
    return LaunchPlan(tile_n, splits, _k_bounds(K, splits))


def _k_bounds(K: int, splits: int) -> Tuple[int, ...]:
    """Split ``j``'s K range is ``[bounds[j], bounds[j + 1])`` (the
    kernel's ``kt0``/``nkt``)."""
    slices = -(-K // TILE_K)
    per = -(-slices // splits)
    return tuple(min(j * per * TILE_K, K) for j in range(splits)) + (K,)


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
    # the kernel reads b and the residual by 16-byte cp.async / vector loads
    # (a takes any alignment: an unaligned a goes in by smaller copies)
    for name, t in (("b", b), ("residual", residual)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"rir_matmul_cuda: {name} must start on a "
                             f"16-byte boundary")


def rir_matmul_cuda(a: torch.Tensor, b: torch.Tensor, perm: torch.Tensor, *,
                    residual: Optional[torch.Tensor] = None,
                    block_n: int = 128) -> torch.Tensor:
    """Launch the kernel: ``(M, N)`` output, block ``j`` stored at ``perm[j]``.

    ``perm`` is a device int32 tensor from ``ops.device_perm``, which checks
    its values (the executor caches one per step at prepare time, so a launch
    copies nothing from the host); any other tensor raises.  The GEMM is cut
    as ``launch_plan`` says.  The launch goes on PyTorch's current stream and
    does not synchronise; a launch the driver refuses raises here.
    """
    _check(a, b, perm, residual, block_n)
    M, K = a.shape
    return _launch(a, b, perm, residual, block_n,
                   launch_plan(M, K, b.shape[1], block_n))


def _launch(a: torch.Tensor, b: torch.Tensor, perm: torch.Tensor,
            residual: Optional[torch.Tensor], block_n: int,
            plan: LaunchPlan) -> torch.Tensor:
    """One launch at the cut ``plan`` (checked operands): the GEMM, and
    with several K-splits the sum of their partials, from a workspace
    allocated here."""
    global _launches
    M, K = a.shape
    N = b.shape[1]
    lib = load()
    fn = lib.rir_matmul_f32 if a.dtype == torch.float32 \
        else lib.rir_matmul_bf16
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    ws = torch.empty((plan.splits, M, N), dtype=torch.float32,
                     device=a.device) if plan.splits > 1 else None
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), perm.data_ptr(),
                 residual.data_ptr() if residual is not None else None,
                 out.data_ptr(), ws.data_ptr() if ws is not None else None,
                 M, K, N, block_n, plan.tile_n, plan.splits,
                 torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rir_matmul launch failed: cudaError_t {err} "
                           f"(M={M} K={K} N={N} block_n={block_n} "
                           f"{plan})")
    with _lock:
        _launches += 1
    return out
