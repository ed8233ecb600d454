"""BIRRD reduce on Hopper: the switch program's encodings and the CUDA
kernels' binding and launch.

The PyTorch port of ``repro.kernels.birrd_reduce``.  A BIRRD program is one
Egg config (Pass/Swap/Add-Left/Add-Right, paper Fig. 8) per switch and
stage; the inter-stage wiring (Alg. 1) is fixed for each width.  The
program has two encodings:

- its **codes**, one byte a switch and stage (``encode_program``): what the
  switch kernel runs, for routed programs (``ops.birrd_reduce`` and
  ``ops.birrd_apply``);
- its **stage matrices** (``compile_switch_program``), each stage lowered to

      M_s = W_s @ (diag(alpha_s) + diag(beta_s) @ E)

  where E is the switch-partner exchange, (alpha, beta) encode the Egg
  config per wire and W_s is the wiring: the form the JAX API's
  ``birrd_apply_p`` takes, run by the dense kernel for arbitrary matrices.

Either way the program is FEATHER's Instruction Buffer: reconfiguring a
layer swaps the program, not the kernel.  The matrix compiler is the JAX
package's numpy code, kept verbatim.

The kernels (``csrc/birrd_apply.cu``) are the Hopper counterparts of the
Pallas ``birrd_apply_p``.  The switch kernel keeps 1-4 columns of ``x (aw,
d)`` a thread in f32 registers through every stage, each stage a select
and at most one addition a wire with the wiring compiled in, so it moves
``x`` in and the output out once and does little else; the dense kernel
does ``aw`` FMAs a wire and stage with the stage matrix in shared memory.
On a routed program the two agree bit for bit (every stage output is an
exact copy or one f32 sum of two values).  An optional port mask stores 0
on the rows no group targets, so ``ops.birrd_reduce`` is one launch.  Any
``d`` runs (the ragged edge is masked); ``aw`` is 2, 4, 8, 16, 32 or 64.

Build: at first CUDA use ``build.load`` compiles the source with ``nvcc``
for ``sm_90a`` into ``build/kernels/`` and binds it with ``ctypes``.
Importing this module builds nothing.  There is no fallback: a CUDA tensor
gets a kernel or an exception.
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

#: the device kernels, as the profiler names them: the switch kernel (routed
#: programs) and the dense one (stage matrices)
SWITCH_KERNEL = "birrd_switch_kernel"
DENSE_KERNEL = "birrd_apply_kernel"

_lock = threading.Lock()
_lib = None
_launches = 0            # dense kernel
_switch_launches = 0     # switch kernel
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


def encode_program(aw: int, configs: Sequence[Sequence[int]]) -> np.ndarray:
    """The switch kernel's form of a program: its Egg codes as uint8
    ``(S, aw/2)``, stage-major, checked (S stages of aw/2 codes in 0-3)."""
    codes = np.asarray(configs, dtype=np.int64)
    S = len(_birrd(aw).perms)
    if codes.shape != (S, aw // 2):
        raise ValueError(f"a program for aw={aw} is {S} stages of {aw // 2} "
                         f"switches, got shape {codes.shape}")
    if codes.size and (codes.min() < PASS or codes.max() > ADD_RIGHT):
        raise ValueError(f"bad config in {configs}")
    return codes.astype(np.uint8)


def decode_program(codes: np.ndarray) -> list:
    """The configs (one list a stage) back from ``encode_program``'s
    codes."""
    return [[int(c) for c in row] for row in np.asarray(codes)]


@functools.lru_cache(maxsize=1024)
def _program_codes(aw: int, configs: Tuple[Tuple[int, ...], ...],
                   device: torch.device) -> torch.Tensor:
    """Encode + upload a config program, memoized per device: the
    host-to-device copy runs once per program.  Callers must not mutate
    the returned tensor."""
    return torch.from_numpy(encode_program(aw, configs)).to(device)


@functools.lru_cache(maxsize=1024)
def _routed_configs(aw: int, group_ids: Tuple[int, ...],
                    out_ports: Tuple[int, ...]
                    ) -> Tuple[Tuple[int, ...], ...]:
    """The backtracking route of a reduction/reorder pattern, memoized."""
    cfg = _birrd(aw).route(list(group_ids), list(out_ports))
    if cfg is None:
        raise ValueError("BIRRD routing failed for the requested pattern")
    return tuple(tuple(int(c) for c in row) for row in cfg)


@functools.lru_cache(maxsize=1024)
def _routed_program(aw: int, group_ids: Tuple[int, ...],
                    out_ports: Tuple[int, ...], device: torch.device
                    ) -> Tuple[Tuple[Tuple[int, ...], ...], torch.Tensor]:
    """Route + encode + upload, memoized per reduction/reorder pattern and
    device: the search and the host-to-device copy of the codes run once
    per ``(aw, group_ids, out_ports, device)``; repeat calls are dict hits.
    Returns the configs and the device codes."""
    cfg = _routed_configs(aw, group_ids, out_ports)
    return cfg, _program_codes(aw, cfg, device)


@functools.lru_cache(maxsize=1024)
def _routed_stage_mats(aw: int, group_ids: Tuple[int, ...],
                       out_ports: Tuple[int, ...], device: torch.device
                       ) -> torch.Tensor:
    """Route + lower + upload, memoized per reduction/reorder pattern and
    device: the backtracking search, the stage-matrix lowering AND the
    host-to-device copy run once per ``(aw, group_ids, out_ports,
    device)``; repeat calls are dict hits.  Callers must not mutate the
    returned tensor."""
    mats = _compile_switch_program(aw, _routed_configs(aw, group_ids,
                                                       out_ports))
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
                       "birrd_apply_bf16": _ARGTYPES,
                       "birrd_switch_f32": _ARGTYPES,
                       "birrd_switch_bf16": _ARGTYPES})
    return _lib


def launch_count() -> int:
    """Dense-kernel launches since the last ``reset_launch_count``."""
    return _launches


def switch_launch_count() -> int:
    """Switch-kernel launches since the last ``reset_launch_count``."""
    return _switch_launches


def reset_launch_count() -> None:
    """Set both kernels' counts to 0."""
    global _launches, _switch_launches
    with _lock:
        _launches = _switch_launches = 0


def _check(x: torch.Tensor, program: torch.Tensor,
           port_mask: Optional[torch.Tensor], switch: bool) -> None:
    """``program``: codes (S, aw/2) uint8 for the switch kernel, stage
    matrices (S, aw, aw) f32 for the dense one."""
    name = "birrd_switch_cuda" if switch else "birrd_apply_cuda"
    if x.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {x.device}")
    aw = x.shape[0] if x.dim() == 2 else -1
    want = (aw // 2,) if switch else (aw, aw)
    form = "codes (S, aw/2)" if switch else "stage_mats (S, aw, aw)"
    if x.dim() != 2 or program.dim() != 1 + len(want) or \
            tuple(program.shape[1:]) != want:
        raise ValueError(f"bad shapes x{tuple(x.shape)} program"
                         f"{tuple(program.shape)}: need x (aw, d) and {form}")
    d = x.shape[1]
    if aw not in WIDTHS:
        raise ValueError(f"aw={aw}: the kernel takes {WIDTHS}")
    S = program.shape[0]
    if d < 1 or S < 1:
        raise ValueError(f"d={d}, S={S}: need both >= 1")
    if switch and S != len(_birrd(aw).perms):
        raise ValueError(f"codes for {S} stages: aw={aw} has "
                         f"{len(_birrd(aw).perms)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"x dtype {x.dtype}: need float32 or bfloat16")
    if switch and program.dtype != torch.uint8:
        raise TypeError(f"codes must be uint8, got {program.dtype}")
    if not switch and program.dtype != torch.float32:
        raise TypeError(f"stage_mats must be float32, got {program.dtype}")
    ts = [x, program]
    if port_mask is not None:
        if port_mask.dtype != torch.bool or tuple(port_mask.shape) != (aw,):
            raise ValueError(f"port_mask {port_mask.dtype} "
                             f"{tuple(port_mask.shape)}: need ({aw},) bool")
        ts.append(port_mask)
    for t in ts:
        if t.device != x.device:
            raise ValueError(f"operands on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} operands must be contiguous")


def _launch(x: torch.Tensor, program: torch.Tensor,
            port_mask: Optional[torch.Tensor], switch: bool) -> torch.Tensor:
    global _launches, _switch_launches
    aw, d = x.shape
    S = program.shape[0]
    lib = load()
    f32 = x.dtype == torch.float32
    if switch:
        fn = lib.birrd_switch_f32 if f32 else lib.birrd_switch_bf16
    else:
        fn = lib.birrd_apply_f32 if f32 else lib.birrd_apply_bf16
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), program.data_ptr(),
                 None if port_mask is None else port_mask.data_ptr(),
                 out.data_ptr(), aw, d, S,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{'birrd_switch' if switch else 'birrd_apply'} "
                           f"launch failed: cudaError_t {err} (aw={aw} "
                           f"d={d} S={S})")
    with _lock:
        if switch:
            _switch_launches += 1
        else:
            _launches += 1
    return out


def birrd_switch_cuda(x: torch.Tensor, codes: torch.Tensor,
                      port_mask: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Launch the switch kernel on a program's codes (``encode_program``,
    uint8 ``(S, aw/2)`` on x's device): ``(aw, d)`` in x's dtype, rows
    where ``port_mask`` is False stored as 0.

    The launch goes on PyTorch's current stream and does not synchronise;
    a launch the CUDA runtime refuses raises here.
    """
    _check(x, codes, port_mask, switch=True)
    return _launch(x, codes, port_mask, switch=True)


def birrd_apply_cuda(x: torch.Tensor, stage_mats: torch.Tensor,
                     port_mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Launch the dense kernel on stage matrices ``(S, aw, aw)`` f32:
    ``(aw, d)`` in x's dtype, rows where ``port_mask`` is False stored as 0.

    The launch goes on PyTorch's current stream and does not synchronise;
    a launch the CUDA runtime refuses raises here.
    """
    _check(x, stage_mats, port_mask, switch=False)
    return _launch(x, stage_mats, port_mask, switch=False)
