"""Public kernel entry points: dispatch by the tensor's device.

A CPU tensor runs the plain PyTorch version (``ref``); a CUDA tensor
launches the hand-written Hopper kernel, or raises.  There is no toggle and
no fallback: nothing routes a CUDA tensor around its kernel.

``birrd_reduce`` routes a grouped-reduction/reorder pattern through the
BIRRD switch model once per pattern and device (memoized), then pushes
``x`` through the routed switch program: on the CPU the plain switch walk
with the non-target ports zeroed, on the card one launch of the switch
kernel with the port mask in its store.  ``birrd_apply`` runs a config
program the same way; ``birrd_apply_p`` takes arbitrary stage matrices, as
the JAX API does, and runs the dense kernel.  The JAX wrappers'
``block_d`` grid hint and ``interpret`` flag have no counterpart: the
kernels take any ``d``.

Each entry point is one registered operator (``torch.library``, under the
``repro_torch`` namespace) with a fake implementation, so a
``TorchDispatchMode`` sees ``repro_torch.gqa_decode`` as one op (not the
plain version's inner ops) and a ``FakeTensorMode`` gives a fake tensor
its output's shape without reaching ``ctypes``, a build or the CUDA
runtime.  ``WORK`` states each operator's work from its arguments' shapes
alone (the kernel modules' ``work``), for ``repro_torch.core.trace_cost``.
The device dispatch happens inside each operator's one implementation.

``linear_scan`` is differentiable.  Its backward is not a kernel, because
the JAX package has none: ``repro``'s ``custom_vjp`` recomputes through
``ref.linear_scan_chunked`` in XLA, and the port recomputes through its own
``ref.linear_scan_chunked`` under autograd, on whichever device the
operands lie.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.gpu_cost import Work

from . import birrd_reduce as _birrd
from . import gqa_decode as _gqa
from . import linear_scan as _scan
from . import ref
from . import rir_matmul as _rir
from .birrd_reduce import (_out_port_mask, _program_codes, _routed_configs,
                           _routed_program, birrd_apply_cuda,
                           birrd_switch_cuda, program_adds)
from .gqa_decode import gqa_decode_cuda, gqa_decode_partial_cuda
from .linear_scan import linear_scan_cuda
from .rir_matmul import TILE_N, register_perm, rir_matmul_cuda

Perm = Union[Sequence[int], torch.Tensor, None]
#: the ``torch.profiler`` range around ``linear_scan``'s backward
BACKWARD_RANGE = "linear_scan.backward"


def _check_perm(perm: Tuple[int, ...], n_blocks: int) -> Tuple[int, ...]:
    if sorted(perm) != list(range(n_blocks)):
        raise ValueError(f"{perm} is not a permutation of {n_blocks} blocks")
    return perm


@functools.lru_cache(maxsize=4096)
def _device_perm(perm: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    return register_perm(torch.tensor(perm, dtype=torch.int32, device=device))


def device_perm(perm: Sequence[int], device: torch.device | str
                ) -> torch.Tensor:
    """The int32 device tensor the kernel reads ``perm`` from (memoized, so
    the host-to-device copy happens once per (perm, device)).  Its values
    are checked here, so it is the only perm tensor the kernel accepts."""
    p = tuple(int(x) for x in perm)
    return _device_perm(_check_perm(p, len(p)), torch.device(device))


def _device_check(name: str, x: torch.Tensor) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")


#: the operators' library; each is defined with one implementation for
#: every backend (``CompositeExplicitAutograd``: the dispatcher calls it
#: once, below a dispatch mode) and a fake one.  ``torch.library
#: .custom_op`` would do the same at about five times the host cost a
#: call (its autograd wrapper runs in Python on every call).
_LIB = torch.library.Library("repro_torch", "DEF")


def _define(schema: str, impl: Callable, fake: Callable):
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, impl, "CompositeExplicitAutograd")
    torch.library.register_fake(f"repro_torch::{name}", fake, lib=_LIB)
    return getattr(torch.ops.repro_torch, name).default


# ------------------------------------------------------------- rir_matmul
def _rir_matmul_impl(a: torch.Tensor, b: torch.Tensor, perm: torch.Tensor,
                     residual: Optional[torch.Tensor], block_n: int
                     ) -> torch.Tensor:
    _device_check("rir_matmul", a)
    if a.device.type == "cpu":
        p = tuple(int(x) for x in perm.tolist())
        return ref.rir_matmul(a, b, _check_perm(p, len(p)), block_n,
                              residual=residual)
    return rir_matmul_cuda(a, b, perm, residual=residual, block_n=block_n)


def _rir_matmul_fake(a, b, perm, residual, block_n):
    return a.new_empty((a.shape[0], b.shape[1]))


_rir_op = _define("rir_matmul(Tensor a, Tensor b, Tensor perm, "
                  "Tensor? residual, int block_n) -> Tensor",
                  _rir_matmul_impl, _rir_matmul_fake)


def rir_matmul(a: torch.Tensor, b: torch.Tensor, out_block_perm: Perm = None,
               *, residual: Optional[torch.Tensor] = None,
               block_n: int = 128) -> torch.Tensor:
    """``a @ b`` with output N-block ``j`` stored at block slot ``perm[j]``.

    ``out_block_perm``: a sequence, a ``device_perm`` tensor on ``a``'s
    device (as the executor passes it), or None for the identity.
    ``residual`` (M, N) is stored in the output block order and added in the
    epilogue.  N must be a multiple of ``block_n``.  The JAX signature's
    ``block_m``/``block_k`` grid hints have no counterpart: the CUDA kernel
    tiles M and K on its own, so that its summation order depends on neither.
    """
    N = b.shape[1]
    if N % block_n:
        raise ValueError(f"N={N} is not a multiple of block_n={block_n}")
    n_blocks = N // block_n
    _device_check("rir_matmul", a)
    if torch.is_tensor(out_block_perm):
        perm_t = out_block_perm
    elif a.device.type == "cpu":
        perm = range(n_blocks) if out_block_perm is None else out_block_perm
        perm_t = torch.tensor([int(p) for p in perm], dtype=torch.int32)
    else:
        perm_t = device_perm(range(n_blocks) if out_block_perm is None
                             else out_block_perm, a.device)
    return _rir_op(a, b, perm_t, residual, block_n)


# ----------------------------------------------------------------- BIRRD
def _birrd_apply_p_impl(x: torch.Tensor, stage_mats: torch.Tensor
                        ) -> torch.Tensor:
    _device_check("birrd_apply", x)
    if x.device.type == "cpu":
        return ref.birrd_apply(x, stage_mats)
    return birrd_apply_cuda(x, stage_mats)


def _birrd_apply_p_fake(x, stage_mats):
    return torch.empty_like(x)


_birrd_p_op = _define("birrd_apply_p(Tensor x, Tensor stage_mats) -> Tensor",
                      _birrd_apply_p_impl, _birrd_apply_p_fake)


def birrd_apply_p(x: torch.Tensor, stage_mats: torch.Tensor) -> torch.Tensor:
    """Push ``x`` (aw, d) through a compiled BIRRD switch program
    ``stage_mats`` (S, aw, aw) f32 on x's device, any matrices (the dense
    kernel): ``(aw, d)`` in x's dtype."""
    return _birrd_p_op(x, stage_mats)


def _configs(aw: int, flat: Sequence[int]) -> Tuple[Tuple[int, ...], ...]:
    w = aw // 2
    return tuple(tuple(int(c) for c in flat[i:i + w])
                 for i in range(0, len(flat), w))


def _birrd_apply_impl(x: torch.Tensor, configs: List[int]) -> torch.Tensor:
    _device_check("birrd_apply", x)
    cfg = _configs(x.shape[0], configs)
    if x.device.type == "cpu":
        return ref.birrd_switch(x, cfg)
    return birrd_switch_cuda(x, _program_codes(x.shape[0], cfg, x.device))


def _birrd_apply_fake(x, configs):
    return torch.empty_like(x)


_birrd_op = _define("birrd_apply(Tensor x, int[] configs) -> Tensor",
                    _birrd_apply_impl, _birrd_apply_fake)


def birrd_apply(x: torch.Tensor, configs: Sequence[Sequence[int]]
                ) -> torch.Tensor:
    """Route ``x`` (aw, d) through BIRRD configured by ``configs`` (one
    row of Egg configs a stage): the switch kernel on the card, its codes
    uploaded once per program and device."""
    return _birrd_op(x, [int(c) for row in configs for c in row])


def _birrd_reduce_impl(x: torch.Tensor, group_ids: List[int],
                       out_ports: List[int]) -> torch.Tensor:
    _device_check("birrd_reduce", x)
    aw = x.shape[0]
    ports = tuple(out_ports)
    cfg, codes = _routed_program(aw, tuple(group_ids), ports, x.device)
    mask = _out_port_mask(aw, ports, x.device)
    if x.device.type == "cpu":
        return ref.birrd_switch(x, cfg, mask)
    return birrd_switch_cuda(x, codes, port_mask=mask)


def _birrd_reduce_fake(x, group_ids, out_ports):
    return torch.empty_like(x)


_reduce_op = _define("birrd_reduce(Tensor x, int[] group_ids, "
                     "int[] out_ports) -> Tensor",
                     _birrd_reduce_impl, _birrd_reduce_fake)


def birrd_reduce(x: torch.Tensor, group_ids: Sequence[int],
                 out_ports: Sequence[int]) -> torch.Tensor:
    """Route + execute: grouped reduction with arbitrary output reorder.

    x: (aw, d).  Returns (aw, d) with group sums at their target ports and
    zeros elsewhere (junk/bubble ports are masked, as the output buffer's
    write-enable does in hardware).
    """
    return _reduce_op(x, [int(g) for g in group_ids],
                      [int(p) for p in out_ports])


# ------------------------------------------------------------- gqa_decode
def _gqa_decode_impl(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    _device_check("gqa_decode", q)
    if q.device.type == "cpu":
        return ref.gqa_decode(q, k, v, lengths)
    return gqa_decode_cuda(q, k, v, lengths)


def _gqa_decode_fake(q, k, v, lengths):
    return torch.empty_like(q)


_gqa_op = _define("gqa_decode(Tensor q, Tensor k, Tensor v, "
                  "Tensor lengths) -> Tensor",
                  _gqa_decode_impl, _gqa_decode_fake)


def gqa_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               lengths: torch.Tensor) -> torch.Tensor:
    """Single-token GQA decode attention: ``(B, Hq, D)`` in q's dtype.

    q (B, Hq, D); k/v (B, S, Hkv, D); lengths (B,) valid KV length, on q's
    device.  Any S runs the kernel: it masks a ragged last tile itself, so
    the JAX wrapper's route to the plain version for an S its block does
    not tile has no counterpart, and neither has its ``block_s`` hint.
    """
    if q.device.type == "cuda":
        lengths = lengths.to(torch.int32)
    return _gqa_op(q, k, v, lengths)


def _gqa_partial_impl(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      lengths: torch.Tensor):
    _device_check("gqa_decode_partial", q)
    if q.device.type == "cpu":
        return ref.gqa_decode_partial(q, k, v, lengths)
    return gqa_decode_partial_cuda(q, k, v, lengths)


def _gqa_partial_fake(q, k, v, lengths):
    ml = q.new_empty(q.shape[:2], dtype=torch.float32)
    return torch.empty_like(q), ml, torch.empty_like(ml)


_gqa_partial_op = _define("gqa_decode_partial(Tensor q, Tensor k, Tensor v, "
                          "Tensor lengths) -> (Tensor, Tensor, Tensor)",
                          _gqa_partial_impl, _gqa_partial_fake)


def gqa_decode_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       lengths: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``gqa_decode`` with each row's softmax statistics, for attention
    over a cache split by sequence: ``(out (B, Hq, D) in q's dtype, m (B,
    Hq) f32, l (B, Hq) f32)``, ``m`` the row's largest scaled score and
    ``l = sum exp(s - m)`` over its first ``lengths[b]`` positions; a row
    of length 0 gives ``(0, -inf, 0)``.  The splits' outputs merge by
    log-sum-exp (``models.common.merge_partials``)."""
    if q.device.type == "cuda":
        lengths = lengths.to(torch.int32)
    return _gqa_partial_op(q, k, v, lengths)


# ------------------------------------------------------------ linear_scan
def _linear_scan_impl(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      log_decay: torch.Tensor) -> torch.Tensor:
    """The kernel (or, on the CPU, the plain chunked version)."""
    _device_check("linear_scan", q)
    if q.device.type == "cpu":
        return ref.linear_scan_chunked(q, k, v, log_decay)
    return linear_scan_cuda(q, k, v, log_decay)


def _linear_scan_fake(q, k, v, log_decay):
    return torch.empty_like(v)


_scan_op = _define("linear_scan(Tensor q, Tensor k, Tensor v, "
                   "Tensor log_decay) -> Tensor",
                   _linear_scan_impl, _linear_scan_fake)


def _scan_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _scan_backward(ctx, g):
    """Through the plain chunked version, recomputed."""
    ins = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
    # a profiler label (BACKWARD_RANGE), so that a profiled train step
    # can tell this plain backward's device time from the rest
    with torch.profiler.record_function(BACKWARD_RANGE), \
            torch.enable_grad():
        out = ref.linear_scan_chunked(*ins)
        return torch.autograd.grad(out, ins, g)


torch.library.register_autograd("repro_torch::linear_scan", _scan_backward,
                                setup_context=_scan_setup, lib=_LIB)


def linear_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_decay: torch.Tensor) -> torch.Tensor:
    """Chunked gated linear attention: ``(B, H, T, dv)`` in v's dtype.

    q/k (B, H, T, dk), v (B, H, T, dv), log_decay (B, H, T, dk) <= 0 (f32
    on the card), all on one device.  Any T runs the kernel: it masks a
    ragged last chunk itself, so the JAX kernel's ``T % 64`` assert, its
    ``chunk=`` argument (ignored on its kernel path) and the
    ``use_kernels``/``REPRO_SCAN_CHUNK`` switches have no counterpart.
    """
    return _scan_op(q, k, v, log_decay)


# ------------------------------------------------------------------ work
def _rir_work(a, b, perm, residual, block_n) -> Work:
    M, K = a.shape
    N = b.shape[1]
    return _rir.work(M, K, N, a.element_size(), residual is not None,
                     N // block_n)


def _gqa_work(q, k, v, lengths) -> Work:
    B, Hq, D = q.shape
    _, S, Hkv, _ = k.shape
    return _gqa.work(B, Hq, Hkv, D, B * S, q.element_size())


def _gqa_partial_work(q, k, v, lengths) -> Work:
    B, Hq, D = q.shape
    _, S, Hkv, _ = k.shape
    return _gqa.work(B, Hq, Hkv, D, B * S, q.element_size(), ml=True)


def _scan_work(q, k, v, log_decay) -> Work:
    B, H, T, dk = q.shape
    return _scan.work(B, H, T, dk, v.shape[-1], q.element_size(),
                      log_decay.element_size())


def _birrd_work(x, configs) -> Work:
    aw = x.shape[0]
    return _birrd.work(aw, x.shape[1], x.element_size(),
                       program_adds(aw, _configs(aw, configs)))


def _reduce_work(x, group_ids, out_ports) -> Work:
    aw = x.shape[0]
    cfg = _routed_configs(aw, tuple(group_ids), tuple(out_ports))
    return _birrd.work(aw, x.shape[1], x.element_size(),
                       program_adds(aw, cfg))


def _birrd_p_work(x, stage_mats) -> Work:
    return _birrd.dense_work(stage_mats.shape[0], x.shape[0], x.shape[1],
                             x.element_size())


#: operator name (as ``OpOverload.name()`` gives it) -> (the kernel it
#: launches on the card, its work from the call's arguments)
WORK: Dict[str, Tuple[str, Callable[..., Work]]] = {
    "repro_torch::rir_matmul": ("rir_matmul", _rir_work),
    "repro_torch::gqa_decode": ("gqa_decode", _gqa_work),
    "repro_torch::gqa_decode_partial": ("gqa_decode_partial",
                                        _gqa_partial_work),
    "repro_torch::linear_scan": ("linear_scan", _scan_work),
    "repro_torch::birrd_apply": ("birrd_apply", _birrd_work),
    "repro_torch::birrd_reduce": ("birrd_apply", _reduce_work),
    "repro_torch::birrd_apply_p": ("birrd_apply", _birrd_p_work),
}


__all__ = ["rir_matmul", "device_perm", "birrd_apply", "birrd_apply_p",
           "birrd_reduce", "gqa_decode", "gqa_decode_partial", "linear_scan",
           "TILE_N", "WORK"]
