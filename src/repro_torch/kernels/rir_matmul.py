"""RIR matmul on Hopper: the CUDA kernel's launch plan, build, binding and
launch wrapper.

The kernel (``csrc/rir_matmul.cu``) is the Hopper counterpart of the JAX
package's Pallas ``rir_matmul_p``: ``a @ b`` with an fp32 accumulator whose
epilogue stores output column block ``j`` at block slot ``perm[j]``, so the
producing GEMM writes the consumer's layout directly (Reorder-In-Reduction),
with an optional residual read through the same permuted map.

It has two designs, one launch a call.  The 3xTF32 design runs an fp32
GEMM on the tensor cores (``wgmma``) at fp32's accuracy: the weight is
split once, at preparation (``prepare_weight``), into two transposed
planes, ``tf32(b)`` and ``tf32(b - tf32(b))``, which the caller hands to
each launch in the weight's place; the kernel splits A in
registers and sums three TF32 products a k-step, each 32-deep K slice's
partial added into fp32 accumulators rounded to nearest.  The SIMT design
is an fp32 GEMM on the CUDA cores: 128x64 CTA tiles (128x128 on long-K
steps where N allows), an 8x8 register tile a thread, a 4-stage
``cp.async`` ring of 16-deep K slices, and split-K for the deep layers'
short grids, each split's partial sums stored to an f32 workspace and
added in split order by a second kernel.  Which design runs and how a GEMM
is cut is ``launch_plan``'s choice, a pure function of the dtype, K and N
that the wrapper passes to the kernel, never of M, so a row's bits do not
depend on the rows it is batched with.  ``launch_count(design)`` counts
each design's launches.

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

from repro_torch.core.gpu_cost import Work

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
#: the two designs: fp32 FMAs on the CUDA cores, and 3xTF32 on the tensor
#: cores (``wgmma``)
SIMT, TF32X3 = "simt", "tf32x3"
DESIGNS = (SIMT, TF32X3)
#: the 3xTF32 design's CTA tile, 128 x 128 (``tc::kBM``, ``tc::kBN``)
TC_TILE = 128
#: the least K and N that take the 3xTF32 design
TC_MIN_K = TC_MIN_N = 1024
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_TC_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]

_lock = threading.Lock()
_lib = None
_launches = dict.fromkeys(DESIGNS, 0)
#: what the last build in this process printed (``-Xptxas -v``: registers,
#: shared memory, spills) and how long it took; empty / 0 when the library
#: was already built
build_log = ""
build_seconds = 0.0


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one GEMM is cut: the design, the CTA tile's width, the K-splits
    of a tile and the K range each split walks."""

    tile_n: int
    splits: int
    k_bounds: Tuple[int, ...]     # splits + 1 boundaries, 0 ... K
    design: str = SIMT

    @property
    def kernels(self) -> Tuple[str, ...]:
        """The device kernels a launch at this cut runs (as names the
        profiler's contain: the 3xTF32 kernel is
        ``rir_matmul_kernel_tf32x3``)."""
        return KERNELS if self.splits > 1 else KERNELS[:1]


def takes_tf32x3(K: int, N: int, dtype: torch.dtype = torch.float32
                 ) -> bool:
    """Whether an ``(M, K) @ (K, N)`` GEMM runs on the 3xTF32 design: fp32,
    K a multiple of 4 (TMA reads A's rows at a 16-byte stride), N a
    multiple of its 128-wide tile, and both at least ``TC_MIN_K`` /
    ``TC_MIN_N``.  The widths stand in for the grid, which the rule may
    not read from M: the design has one 128 x 128 tile a CTA and no
    split-K, so it wins where there are many tiles (BERT-Large's four
    GEMMs, 2.2-2.4x the SIMT design at 64 sequences) and loses or ties at
    ResNet-50 batch 8's steps, whose widths are under 1024 and whose deep
    layers have few rows (``tools/kernel_bench.py``; PERF.md)."""
    return dtype == torch.float32 and K % 4 == 0 and N % TC_TILE == 0 \
        and K >= TC_MIN_K and N >= TC_MIN_N


def launch_plan(M: int, K: int, N: int, block_n: int,
                dtype: torch.dtype = torch.float32) -> LaunchPlan:
    """The kernel's design and cut of an ``(M, K) @ (K, N)`` GEMM, from
    the dtype, K and N alone.

    ``takes_tf32x3`` picks the design.  The 3xTF32 design walks K whole
    in one CTA a tile.  On the SIMT design the CTA tile is 128 x 64 (128
    threads, two or three CTAs an SM, so one CTA's loads and stores overlap
    another's FMAs), or 128 x 128 (256 threads, one CTA an SM) where N is a
    multiple of 128 and K is at least ``WIDE_TILE_MIN_K``.  K is split only
    where K >= 2 N, into the largest power of two up to ``MAX_SPLITS``,
    twice the tile columns and K over ``SPLIT_MIN_SLICES`` slices: in a
    conv net the layers with K >= 2 N are the 3x3 and reduce layers, and
    the wider their output the fewer their rows (ResNet-50's rows times N
    squared is about constant), so N stands in for the short grid the cut
    may not look at.  Split ``j`` walks slices ``[j * per, (j + 1) *
    per)``, ``per`` the slices over the splits rounded up.  ``M`` and
    ``block_n`` do not enter: a row's sums are taken in an order that
    depends on K and N alone, so a request gives the same bits alone or
    batched, and the epilogue maps any ``block_n``.  The SIMT cut was read
    off ``tools/kernel_bench.py --sweep`` at the ResNet-50 steps.
    """
    del M, block_n
    if takes_tf32x3(K, N, dtype):
        return LaunchPlan(TC_TILE, 1, (0, K), TF32X3)
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
                       "rir_matmul_bf16": _ARGTYPES,
                       "rir_matmul_tf32x3": _TC_ARGTYPES})
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


def launch_count(design: Optional[str] = None) -> int:
    """Kernel launches since the last ``reset_launch_count``: all of them,
    or those of one design (``SIMT`` or ``TF32X3``)."""
    return sum(_launches.values()) if design is None else _launches[design]


def reset_launch_count() -> None:
    with _lock:
        for d in DESIGNS:
            _launches[d] = 0


# ------------------------------------------------- the 3xTF32 weight planes
def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``hi = tf32(x)`` and ``lo = tf32(x - hi)``, each rounded to the
    nearest tf32 with ties away from zero (``cvt.rna.tf32.f32``: the low
    13 mantissa bits cleared after adding half of them), as fp32 tensors.
    ``x - hi`` is exact in fp32.  NaN passes through."""
    if x.dtype != torch.float32:
        raise TypeError(f"split_tf32 takes float32, got {x.dtype}")

    def rna(v: torch.Tensor) -> torch.Tensor:
        r = ((v.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
        return torch.where(torch.isnan(v), v, r)

    hi = rna(x)
    return hi, rna(x - hi)


def weight_planes(b: torch.Tensor) -> torch.Tensor:
    """The 3xTF32 design's B: ``(2N, K)`` fp32, the hi plane of ``b`` (K,
    N) transposed above its lo plane (``split_tf32``), K-major as the
    tensor cores read it."""
    hi, lo = split_tf32(b)
    return torch.cat((hi.t(), lo.t())).contiguous()


def prepare_weight(b: torch.Tensor) -> Optional[torch.Tensor]:
    """The planes of a ``(K, N)`` CUDA weight whose GEMMs take the 3xTF32
    design (``weight_planes``), made where the weight is prepared, once and
    ahead of its launches; the split is waited for, so any stream may
    launch with them.  The caller keeps them and hands them to each launch
    (``planes=``), in the weight's place: that design reads nothing else
    of it.  None where the design does not read them (a CPU tensor, another
    dtype, K or N)."""
    if b.device.type != "cuda" or b.dim() != 2 or \
            not takes_tf32x3(b.shape[0], b.shape[1], b.dtype):
        return None
    planes = weight_planes(b)
    torch.cuda.current_stream(b.device).synchronize()
    return planes


def _check(a: torch.Tensor, b: Optional[torch.Tensor], perm: torch.Tensor,
           residual: Optional[torch.Tensor], block_n: int,
           planes: Optional[torch.Tensor] = None) -> Tuple[int, int]:
    """Check the operands; the weight's ``(K, N)``, from ``b`` or, where
    ``b`` is None, from its planes."""
    if a.device.type != "cuda":
        raise ValueError(f"rir_matmul_cuda needs CUDA tensors, got {a.device}")
    if b is not None:
        if b.dim() != 2:
            raise ValueError(f"bad weight shape {tuple(b.shape)}")
        K, N = b.shape
    elif planes is not None and planes.dim() == 2 and planes.shape[0] % 2 == 0:
        K, N = planes.shape[1], planes.shape[0] // 2
    else:
        raise ValueError("rir_matmul_cuda needs the weight b or its 3xTF32 "
                         "planes")
    if a.dim() != 2 or a.shape[1] != K:
        raise ValueError(f"bad GEMM shapes {tuple(a.shape)} @ ({K}, {N})")
    M = a.shape[0]
    if min(M, K, N) < 1 or max(M, K, N) >= 2 ** 31:
        raise ValueError(f"GEMM extents out of range: M={M} K={K} N={N}")
    if a.dtype not in DTYPES or (b is not None and b.dtype != a.dtype):
        raise TypeError(f"dtypes {a.dtype}/{None if b is None else b.dtype}"
                        f": need both float32 or both bfloat16")
    if planes is not None and (planes.dtype != torch.float32
                               or planes.shape != (2 * N, K)):
        raise ValueError(f"planes {planes.dtype}{list(planes.shape)} are not "
                         f"the 3xTF32 planes of a float32 ({K}, {N}) weight")
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
    tensors = [t for t in (a, b, perm, planes) if t is not None]
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
    # and the planes by TMA (a takes any alignment: an unaligned a goes in
    # by smaller copies, or is copied before a TMA launch)
    for name, t in (("b", b), ("residual", residual), ("planes", planes)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"rir_matmul_cuda: {name} must start on a "
                             f"16-byte boundary")
    return K, N


def rir_matmul_cuda(a: torch.Tensor, b: Optional[torch.Tensor],
                    perm: torch.Tensor, *,
                    residual: Optional[torch.Tensor] = None,
                    block_n: int = 128,
                    planes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the kernel: ``(M, N)`` output, block ``j`` stored at ``perm[j]``.

    ``perm`` is a device int32 tensor from ``ops.device_perm``, which checks
    its values (the executor caches one per step at prepare time, so a launch
    copies nothing from the host); any other tensor raises.  The GEMM is cut
    as ``launch_plan`` says.  ``planes`` are the weight's 3xTF32 planes
    (``prepare_weight``), which that design reads in ``b``'s place: with
    them ``b`` may be None (the SIMT design reads ``b`` and raises without
    it); a 3xTF32 launch without them splits ``b`` on the current stream
    first, for that call alone.  The launch goes on PyTorch's current
    stream and does not synchronise; a launch the driver refuses raises
    here.
    """
    K, N = _check(a, b, perm, residual, block_n, planes)
    return _launch(a, b, perm, residual, block_n,
                   launch_plan(a.shape[0], K, N, block_n, a.dtype), planes)


def _launch(a: torch.Tensor, b: Optional[torch.Tensor], perm: torch.Tensor,
            residual: Optional[torch.Tensor], block_n: int,
            plan: LaunchPlan,
            planes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch at the cut ``plan`` (checked operands): the GEMM, and
    with several K-splits the sum of their partials, from a workspace
    allocated here; on the 3xTF32 design from the weight's planes (split
    here where none are given) and an A that starts on a 16-byte boundary
    (TMA's; an unaligned A is copied first)."""
    M, K = a.shape
    N = b.shape[1] if b is not None else planes.shape[0] // 2
    lib = load()
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    res = residual.data_ptr() if residual is not None else None
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if plan.design == TF32X3:
            if a.dtype != torch.float32:
                raise TypeError(f"the 3xTF32 design takes float32, not "
                                f"{a.dtype}")
            if planes is None:
                planes = weight_planes(b)
            if a.data_ptr() % 16:
                a = a.clone()
            err = lib.rir_matmul_tf32x3(
                a.data_ptr(), planes.data_ptr(), perm.data_ptr(), res,
                out.data_ptr(), M, K, N, block_n, stream)
        else:
            if b is None:
                raise ValueError(f"the SIMT design reads the weight b, not "
                                 f"its planes ({plan})")
            fn = lib.rir_matmul_f32 if a.dtype == torch.float32 \
                else lib.rir_matmul_bf16
            ws = torch.empty((plan.splits, M, N), dtype=torch.float32,
                             device=a.device) if plan.splits > 1 else None
            err = fn(a.data_ptr(), b.data_ptr(), perm.data_ptr(), res,
                     out.data_ptr(), ws.data_ptr() if ws is not None
                     else None, M, K, N, block_n, plan.tile_n, plan.splits,
                     stream)
    if err != 0:
        raise RuntimeError(f"rir_matmul launch failed: cudaError_t {err} "
                           f"(M={M} K={K} N={N} block_n={block_n} "
                           f"{plan})")
    with _lock:
        _launches[plan.design] += 1
    return out


def work(M: int, K: int, N: int, itemsize: int = 4, residual: bool = False,
         n_blocks: int = 0, design: Optional[str] = None) -> Work:
    """One call's work from its shapes alone: the ``2 M K N`` operations
    the GEMM needs, on the unit its design runs them on, the CUDA cores
    (``"fp32"``) for the SIMT design, which multiplies in fp32 whatever its
    inputs' type, and the TF32 tensor cores three products a multiply-add
    (``"tf32x3"``, at a third of their rate) for the 3xTF32 one; A, B, the
    residual and the output moved once, with the ``n_blocks`` int32 perm
    entries read.  A caller that knows the layer's own output width passes
    it as ``N`` (the weight's columns may be padded to whole perm blocks)
    and the launch's ``design``; without it the design is
    ``launch_plan``'s for ``N``."""
    if design is None:
        design = launch_plan(M, K, N, N, torch.float32 if itemsize == 4
                             else torch.bfloat16).design
    nbytes = itemsize * (M * K + K * N + M * N + (M * N if residual else 0)
                         + n_blocks)
    return Work(2.0 * M * K * N, float(nbytes),
                "tf32x3" if design == TF32X3 else "fp32")
