"""BIRRD reduce on Hopper: the switch program's compiler and the CUDA
kernel's binding and launch.

The PyTorch port of ``repro.kernels.birrd_reduce``.  Each of the
``2*log2(AW)`` stages of the Egg-switch network (paper Fig. 8) is lowered to
a small stage matrix

    M_s = W_s @ (diag(alpha_s) + diag(beta_s) @ E)

where E is the switch-partner exchange, (alpha, beta) encode the Egg config
(Pass/Swap/Add-Left/Add-Right) per wire and W_s is the Alg. 1 inter-stage
wiring.  The stage matrices are the program (FEATHER's Instruction Buffer):
reconfiguring a layer swaps the program, not the kernel.  The compiler is
the JAX package's numpy code, kept verbatim.

The kernel (``csrc/birrd_apply.cu``) is the Hopper counterpart of the
Pallas ``birrd_apply_p``: one thread a column of ``x (aw, d)``, its ``aw``
values in f32 registers through every stage, the current stage matrix in
shared memory; an optional port mask stores 0 on the rows no group targets,
so ``ops.birrd_reduce`` is one launch.  Any ``d`` runs (the ragged edge is
masked); ``aw`` is 2, 4, 8, 16, 32 or 64.

Build: at first CUDA use ``build.load`` compiles the source with ``nvcc``
for ``sm_90a`` into ``build/kernels/`` and binds it with ``ctypes``.
Importing this module builds nothing.  There is no fallback: a CUDA tensor
gets the kernel or an exception.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.birrd import ADD_LEFT, ADD_RIGHT, PASS, SWAP, Birrd

from . import build as _build

NAME = "birrd_apply"
SOURCE = _build.CSRC / f"{NAME}.cu"
#: array widths the kernel is instantiated for
WIDTHS = (2, 4, 8, 16, 32, 64)
DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_int, ctypes.c_void_p]

_lock = threading.Lock()
_lib = None
_launches = 0
#: what the last build in this process printed (``-Xptxas -v``) and how
#: long it took; empty / 0 when the library was already built
build_log = ""
build_seconds = 0.0


@functools.lru_cache(maxsize=64)
def _birrd(aw: int) -> Birrd:
    """One shared (stateless-after-init) network model per width."""
    return Birrd(aw)


def compile_switch_program(aw: int, configs: Sequence[Sequence[int]]
                           ) -> np.ndarray:
    """Lower per-stage Egg configs to stacked stage matrices (S, aw, aw).

    Memoized per ``(aw, configs)``: a layer's switch program is compiled
    once and reused by every subsequent call (FEATHER reprograms the
    Instruction Buffer per layer, not per tile).  Callers must not mutate
    the returned array.
    """
    return _compile_switch_program(aw, tuple(tuple(row) for row in configs))


@functools.lru_cache(maxsize=1024)
def _compile_switch_program(aw: int, configs: Tuple[Tuple[int, ...], ...]
                            ) -> np.ndarray:
    net = _birrd(aw)
    mats = []
    for stage, row in enumerate(configs):
        alpha = np.zeros(aw, np.float32)
        beta = np.zeros(aw, np.float32)
        for sw, cfg in enumerate(row):
            l, r = 2 * sw, 2 * sw + 1
            if cfg == PASS:
                alpha[l] = alpha[r] = 1.0
            elif cfg == SWAP:
                beta[l] = beta[r] = 1.0
            elif cfg == ADD_LEFT:   # left out = l + r; right out = r
                alpha[l], beta[l] = 1.0, 1.0
                alpha[r] = 1.0
            elif cfg == ADD_RIGHT:  # right out = l + r; left out = l
                alpha[l] = 1.0
                alpha[r], beta[r] = 1.0, 1.0
            else:
                raise ValueError(f"bad config {cfg}")
        sw_mat = np.diag(alpha)
        for w in range(aw):
            sw_mat[w, w ^ 1] += beta[w]
        wiring = np.zeros((aw, aw), np.float32)
        for j in range(aw):
            wiring[net.perms[stage][j], j] = 1.0
        mats.append(wiring @ sw_mat)
    return np.stack(mats)


@functools.lru_cache(maxsize=1024)
def _routed_stage_mats(aw: int, group_ids: Tuple[int, ...],
                       out_ports: Tuple[int, ...], device: torch.device
                       ) -> torch.Tensor:
    """Route + lower + upload, memoized per reduction/reorder pattern and
    device: the backtracking search, the stage-matrix lowering AND the
    host-to-device copy run once per ``(aw, group_ids, out_ports,
    device)``; repeat calls are dict hits.  Callers must not mutate the
    returned tensor."""
    cfg = _birrd(aw).route(list(group_ids), list(out_ports))
    if cfg is None:
        raise ValueError("BIRRD routing failed for the requested pattern")
    mats = _compile_switch_program(aw, tuple(tuple(r) for r in cfg))
    return torch.from_numpy(np.array(mats, np.float32)).to(device)


@functools.lru_cache(maxsize=1024)
def _out_port_mask(aw: int, out_ports: Tuple[int, ...],
                   device: torch.device) -> torch.Tensor:
    """(aw,) bool: True on the ports a group's sum lands on."""
    mask = torch.zeros(aw, dtype=torch.bool)
    for p in out_ports:
        mask[int(p)] = True
    return mask.to(device)


def library_path():
    """Where the built library lives, keyed by a hash of source + flags."""
    return _build.library_path(NAME)


def load() -> ctypes.CDLL:
    """Build (if needed) and bind the library; thread-safe, once a process."""
    global _lib, build_log, build_seconds
    with _lock:
        if _lib is None:
            _lib, build_log, build_seconds = _build.load(
                NAME, {"birrd_apply_f32": _ARGTYPES,
                       "birrd_apply_bf16": _ARGTYPES})
    return _lib


def launch_count() -> int:
    """Kernel launches since the last ``reset_launch_count``."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    with _lock:
        _launches = 0


def _check(x: torch.Tensor, stage_mats: torch.Tensor,
           port_mask: Optional[torch.Tensor]) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"birrd_apply_cuda needs CUDA tensors, got "
                         f"{x.device}")
    if x.dim() != 2 or stage_mats.dim() != 3 or \
            stage_mats.shape[1:] != (x.shape[0], x.shape[0]):
        raise ValueError(f"bad shapes x{tuple(x.shape)} stage_mats"
                         f"{tuple(stage_mats.shape)}: need x (aw, d) and "
                         f"stage_mats (S, aw, aw)")
    aw, d = x.shape
    if aw not in WIDTHS:
        raise ValueError(f"aw={aw}: the kernel takes {WIDTHS}")
    if d < 1 or stage_mats.shape[0] < 1:
        raise ValueError(f"d={d}, S={stage_mats.shape[0]}: need both >= 1")
    if x.dtype not in DTYPES:
        raise TypeError(f"x dtype {x.dtype}: need float32 or bfloat16")
    if stage_mats.dtype != torch.float32:
        raise TypeError(f"stage_mats must be float32, got {stage_mats.dtype}")
    ts = [x, stage_mats]
    if port_mask is not None:
        if port_mask.dtype != torch.bool or tuple(port_mask.shape) != (aw,):
            raise ValueError(f"port_mask {port_mask.dtype} "
                             f"{tuple(port_mask.shape)}: need ({aw},) bool")
        ts.append(port_mask)
    for t in ts:
        if t.device != x.device:
            raise ValueError(f"operands on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError("birrd_apply_cuda operands must be contiguous")


def birrd_apply_cuda(x: torch.Tensor, stage_mats: torch.Tensor,
                     port_mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Launch the kernel: ``(aw, d)`` in x's dtype, rows where ``port_mask``
    is False stored as 0.

    The launch goes on PyTorch's current stream and does not synchronise;
    a launch the CUDA runtime refuses raises here.
    """
    _check(x, stage_mats, port_mask)
    global _launches
    aw, d = x.shape
    S = stage_mats.shape[0]
    lib = load()
    fn = lib.birrd_apply_f32 if x.dtype == torch.float32 \
        else lib.birrd_apply_bf16
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), stage_mats.data_ptr(),
                 None if port_mask is None else port_mask.data_ptr(),
                 out.data_ptr(), aw, d, S,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"birrd_apply launch failed: cudaError_t {err} "
                           f"(aw={aw} d={d} S={S})")
    with _lock:
        _launches += 1
    return out
