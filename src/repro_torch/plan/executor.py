"""Plan-driven execution: run an ``ExecutionPlan`` through the RIR kernel.

The PyTorch counterpart of ``repro.plan.executor``: GEMM chains
(``execute_plan``) and whole networks (``execute_network``).  Every layer's
output is written by the ``rir_matmul`` epilogue *directly in
the layout the next layer wants* (RIR — the reorder rides the reduction), so
no standalone relayout pass runs between layers:

* A boundary layout reduces, at kernel granularity, to a permutation of
  128-wide feature blocks (``plan.layout_block_perm``); step *i*'s epilogue
  permutation is the block order of ``steps[i].out_layout``.
* Convolutions lower to implicit GEMM: an im2col patch gather whose row map
  composes the boundary adapter with the tap offsets, and whose column order
  is the producer's stored order.  The layout choice is folded into the
  effective weight offline; depthwise layers use its block-diagonal form.
* Skip edges buffer the source activation in its boundary layout.  When the
  two boundary layouts agree the residual add is FUSED into the consumer's
  epilogue (the kernel's ``residual`` operand); otherwise the join goes
  through canonical order and ``adapt_activation``.
* Fused layer groups (``PlanStep.fused_with``) are fenced and measured as
  one unit; the math is left identical to the unfused schedule.
* A GEMM chain pre-arranges each weight offline (``permute_weight_blocks``)
  to contract against an activation stored in the incoming boundary
  layout, so each step is one kernel launch.

The numpy index builders are kept verbatim from the JAX package, so both
backends use identical index maps.  Everything that depends only on
``(plan, graph, weights, device)`` — row maps, effective weights, biases,
perms as device tensors — is built once in ``PreparedNetwork``; a batch pays
only its gathers and kernel launches.  On a CPU device ``ops.rir_matmul``
runs its plain version; on CUDA, the hand-written kernel.

All of it validates against ``execute_network_reference``, built on the
``kernels/ref.py`` conv/depthwise versions.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.core.workloads import (input_channels, is_depthwise,
                                        weight_shape)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops, ref
from repro_torch.runtime import faults

from .graph import LayerGraph
from .plan import RIR_BLOCK, ExecutionPlan, PlanStep, layout_block_perm

# the smallest kernel block the tile-derived grid may shrink to
MIN_KERNEL_BLOCK = 64

Activation = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _plan_provenance(plan: ExecutionPlan) -> Dict[str, object]:
    """Span attributes joining a measured interval back to its plan artifact."""
    return {"plan_id": plan.plan_id, "graph_hash": plan.graph_hash,
            "schema_version": plan.version, "graph": plan.graph_name}


def _step_attrs(prov: Dict[str, object], i: int, step: PlanStep
                ) -> Dict[str, object]:
    """Per-step span attributes: provenance + the step's MODELED numbers
    (cycles, energy, exposed-DRAM stall), next to the measured ``dur``."""
    d = dict(prov)
    d.update(step=i, layer=step.layer, lowering=step.lowering,
             reorder=step.reorder, double_buffer=step.double_buffer,
             modeled_cycles=step.cycles, modeled_energy_pj=step.energy_pj,
             modeled_stall_cycles=step.dram_stall_cycles,
             buffer_alloc="+".join(step.buffer_alloc))
    if step.fused_with is not None:
        d["fused_with"] = step.fused_with
    return d


def _f32(x) -> torch.Tensor:
    """``x`` as a float32 tensor; numpy input is copied (jax arrays come
    read-only, and a tensor over read-only memory is undefined behaviour)."""
    if torch.is_tensor(x):
        return x.float()
    return torch.from_numpy(np.array(x, dtype=np.float32))


class PlanError(ValueError):
    """A plan is internally inconsistent or doesn't fit the given tensors."""


def _pow2_floor(x: int) -> int:
    return 1 << (max(1, int(x)).bit_length() - 1)


def _pow2_ceil(x: int) -> int:
    return 1 << (max(1, int(x)) - 1).bit_length()


# the smallest row block the tile-derived grid may shrink to when the tile
# itself is tiny (the f32 sublane tile height of the TPU grid)
_SUBLANE_MIN = 8


def _clamp_block(extent: int, block: int) -> int:
    """Kernel block for one axis of a tiled extent (see the JAX executor)."""
    return max(_SUBLANE_MIN,
               min(block, _pow2_ceil(extent),
                   max(MIN_KERNEL_BLOCK, _pow2_floor(extent))))


def step_kernel_blocks(step: PlanStep, block: int = RIR_BLOCK
                       ) -> Tuple[int, int]:
    """(block_m, block_k) the plan's tiling derives for this step.

    The rule of the JAX executor, where it sizes the TPU kernel's grid: the
    plan's on-chip tile bounds how many GEMM rows and reduction elements one
    pass keeps resident, halved on the rows when the iActs are ping-pong
    buffered; tile-less single-buffered steps keep the full ``block``.  The
    Hopper kernel tiles on its own (its summation order must not depend on
    the plan), so the port reports these blocks but does not launch by them.
    """
    if not step.tiles and not step.double_buffer:
        return block, block
    wl = step.workload
    t = dict(step.tiles)

    def ext(d: str, size: int) -> int:
        return max(1, min(size, t.get(d, size)))

    rows = ext("N", wl.N) * ext("P", wl.P) * ext("Q", wl.Q)
    kdim = ext("C", wl.C) * wl.R * wl.S
    db_iact = ("iact" in step.buffer_alloc) if step.buffer_alloc \
        else step.double_buffer
    if db_iact:
        rows = max(1, rows // 2)
    return _clamp_block(rows, block), _clamp_block(kdim, block)


def fold_batchnorm(w, gamma, beta, mean, var, eps: float = 1e-5,
                   conv_bias=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold inference batch-norm (+ optional conv bias) into the weights.

    ``BN(conv(x, w) + conv_bias)`` == ``conv(x, w * s) + b`` with
    ``s = gamma / sqrt(var + eps)`` (per output channel) and
    ``b = beta + (conv_bias - mean) * s``.  The returned bias goes in via
    ``biases=``.  Works for dense ``(R, S, C, M)`` and depthwise ``(R, S, M)``
    weights — the output channel is the last axis of each.
    """
    w = _f32(w)
    gamma, beta, mean, var = (_f32(a) for a in (gamma, beta, mean, var))
    scale = gamma / torch.sqrt(var + eps)
    bias = beta - mean * scale
    if conv_bias is not None:
        bias = bias + _f32(conv_bias) * scale
    return w * scale, bias


@functools.lru_cache(maxsize=4096)
def _gather_indices(perm: Tuple[int, ...], block: int) -> np.ndarray:
    """Flat gather such that ``x[..., idx]`` stores canonical block j at slot
    ``perm[j]`` (equivalently: prepares weights stored per ``perm``)."""
    n = len(perm)
    cols = np.zeros(n, np.int64)
    cols[np.asarray(perm)] = np.arange(n)
    return (cols[:, None] * block + np.arange(block)[None, :]).reshape(-1)


@functools.lru_cache(maxsize=4096)
def _scatter_indices(perm: Tuple[int, ...], block: int) -> np.ndarray:
    """Flat gather recovering canonical order from a ``perm``-stored tensor."""
    return (np.asarray(perm)[:, None] * block
            + np.arange(block)[None, :]).reshape(-1)


@functools.lru_cache(maxsize=4096)
def _index_tensor(kind: str, perm: Tuple[int, ...], block: int,
                  device: torch.device) -> torch.Tensor:
    """A gather/scatter index map as a device tensor, copied over once."""
    idx = _gather_indices(perm, block) if kind == "gather" \
        else _scatter_indices(perm, block)
    return torch.from_numpy(idx).to(device)


def apply_block_perm(x: torch.Tensor, perm: Sequence[int],
                     block: int = RIR_BLOCK) -> torch.Tensor:
    """Store canonical column-block j at slot ``perm[j]`` (RIR write order)."""
    n = len(perm)
    if n * block != x.shape[-1]:
        raise PlanError(f"perm of {n} blocks x {block} != dim {x.shape[-1]}")
    return x.index_select(-1, _index_tensor("gather", tuple(perm), block,
                                            x.device))


def invert_block_perm(x: torch.Tensor, perm: Sequence[int],
                      block: int = RIR_BLOCK) -> torch.Tensor:
    """Recover canonical order from a ``perm``-stored tensor."""
    return x.index_select(-1, _index_tensor("scatter", tuple(perm), block,
                                            x.device))


def permute_weight_blocks(w: torch.Tensor, in_perm: Sequence[int],
                          block: int = RIR_BLOCK) -> torch.Tensor:
    """Offline weight prep: scatter K-blocks so ``w_eff`` contracts against an
    activation stored in the incoming boundary layout."""
    n = len(in_perm)
    if n * block != w.shape[0]:
        raise PlanError(f"in_perm of {n} blocks x {block} != K {w.shape[0]}")
    return w.index_select(0, _index_tensor("gather", tuple(in_perm), block,
                                           w.device))


def _derive_boundary_perms(plan: ExecutionPlan, dims: Sequence[int],
                           block: int) -> List[tuple]:
    """Derive every boundary's block permutation from consecutive entries.

    ``dims[b]`` is the feature width of boundary ``b`` (network input for
    b=0, layer b-1's output after).
    """
    steps = plan.steps
    for i in range(len(steps) - 1):
        if steps[i].out_layout != steps[i + 1].in_layout:
            raise PlanError(
                f"plan discontinuity at {steps[i].layer} -> "
                f"{steps[i + 1].layer}: {steps[i].out_layout} != "
                f"{steps[i + 1].in_layout}")
    perms = []
    for b, dim in enumerate(dims):
        name = steps[b].in_layout if b < len(steps) else steps[-1].out_layout
        n_blocks = dim // block if dim % block == 0 else 1
        if n_blocks <= 1:
            perms.append((0,))
            continue
        # honour the perm the artifact recorded (boundary b is written by
        # step b-1's epilogue) when it fits this tensor's block count;
        # otherwise derive it from the boundary layout name
        recorded = steps[b - 1].epilogue_perm if b > 0 else None
        if recorded is not None and len(recorded) == n_blocks:
            perms.append(tuple(recorded))
        else:
            perms.append(layout_block_perm(name, n_blocks))
    return perms


def _prepared_is_stale(prepared, plan: ExecutionPlan, block: int,
                       weights: Sequence) -> bool:
    """(plan, block, weights-identity) staleness test for a prepared object —
    a stale one must fail loudly, never compute with old state."""
    return (prepared.plan != plan or prepared.block != block
            or len(prepared.weights) != len(weights)
            or any(got is not want for got, want
                   in zip(prepared.weights, weights)))


# =========================================================================
# GEMM chains: one rir_matmul launch per plan step
# =========================================================================
def _tensor(x) -> torch.Tensor:
    """``x`` as a tensor: tensors keep their dtype and device; anything else
    is copied to a float32 CPU tensor (see ``_f32``)."""
    return x if torch.is_tensor(x) else _f32(x)


def _boundary_perms(plan: ExecutionPlan, x_dim: int, weights: Sequence,
                    block: int) -> List[tuple]:
    """GEMM-chain form: boundary widths come from the 2D weight shapes."""
    return _derive_boundary_perms(
        plan, [x_dim] + [int(np.shape(w)[1]) for w in weights], block)


class PreparedPlan:
    """Everything ``execute_plan`` derives from ``(plan, shapes, device)``.

    Boundary perms, the pre-permuted (effective) weight matrices on
    ``device`` and the perms as device tensors are computed once here;
    calling the object runs only the per-batch matmul chain.  Reuse one
    instance across ``execute_plan`` calls that share the plan and weights
    (e.g. every serving batch).
    """

    def __init__(self, plan: ExecutionPlan, x_dim: int, weights: Sequence,
                 *, block: int = RIR_BLOCK,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        if len(weights) != len(plan.steps):
            raise PlanError(
                f"{len(weights)} weights for {len(plan.steps)} steps")
        for i, w in enumerate(weights):
            k_prev = x_dim if i == 0 else np.shape(weights[i - 1])[1]
            if np.shape(w)[0] != k_prev:
                raise PlanError(
                    f"weight {i} K={np.shape(w)[0]} != producer M={k_prev}")
        self.plan = plan
        self.block = block
        self.x_dim = x_dim
        self.weights = tuple(weights)
        for step in plan.steps:
            if step.kernel != "rir_matmul":
                raise PlanError(f"step {step.layer}: kernel "
                                f"{step.kernel!r} is not one the port runs "
                                f"(every step is an rir_matmul launch)")
        self.perms = _boundary_perms(plan, x_dim, weights, block)
        # every step is one kernel launch.  A boundary that is not whole
        # blocks has one block (nothing to permute): its weight is padded to
        # the kernel's tile and launched as one block that wide, as the
        # network path does, and the output is cut back to its width
        self.w_eff, self.block_n = [], []
        for i, w in enumerate(weights):
            w = _tensor(w).to(self.device)
            if len(self.perms[i]) > 1:
                w = permute_weight_blocks(w, self.perms[i], block)
            if w.shape[1] % block:
                w = _pad_cols(w, ops.TILE_N)
                self.block_n.append(w.shape[1])
            else:
                self.block_n.append(block)
            self.w_eff.append(w.contiguous())
        self.widths = [int(np.shape(w)[1]) for w in weights]
        self.perm_dev = [ops.device_perm(p, self.device) if len(p) > 1
                         else None for p in self.perms]
        self._prov: Optional[Dict[str, object]] = None

    def _provenance(self) -> Dict[str, object]:
        if self._prov is None:
            self._prov = _plan_provenance(self.plan)
        return self._prov

    def __call__(self, x, *, activation: Activation = None) -> torch.Tensor:
        plan, block, perms = self.plan, self.block, self.perms
        # traced executions fence every step with a device sync and record
        # the measured wall-clock next to the plan's modeled numbers; values
        # are untouched, so outputs are bit-identical traced or not
        traced = obs.enabled()
        x = _tensor(x).to(self.device)
        with obs.span("exec.chain",
                      dict(self._provenance(), device=self.device.type,
                           rows=int(x.shape[0])) if traced else None):
            cur = apply_block_perm(x, perms[0], block) \
                if len(perms[0]) > 1 else x
            for i, (step, w_eff) in enumerate(zip(plan.steps, self.w_eff)):
                faults.site(faults.EXEC_DISPATCH)
                if traced:
                    t0 = obs.now_us()
                cur = ops.rir_matmul(cur.contiguous(), w_eff,
                                     self.perm_dev[i + 1],
                                     block_n=self.block_n[i])
                if cur.shape[1] != self.widths[i]:
                    cur = cur[:, :self.widths[i]]
                if activation is not None and i < len(plan.steps) - 1:
                    # elementwise: commutes with block perms
                    cur = activation(cur)
                if traced:
                    if cur.is_cuda:
                        torch.cuda.synchronize(cur.device)
                    obs.record_span("exec.step", t0,
                                    _step_attrs(self._provenance(), i, step))
            out = invert_block_perm(cur, perms[-1], block) \
                if len(perms[-1]) > 1 else cur
        return out


def prepare_plan(plan: ExecutionPlan, x_dim: int, weights: Sequence, *,
                 block: int = RIR_BLOCK,
                 device: str | torch.device = "cuda") -> PreparedPlan:
    """Hoist boundary perms + effective weights out of the per-call path."""
    return PreparedPlan(plan, x_dim, weights, block=block, device=device)


def execute_plan(plan: ExecutionPlan, x, weights: Sequence, *,
                 block: int = RIR_BLOCK, activation: Activation = None,
                 prepared: Optional[PreparedPlan] = None,
                 device: str | torch.device = "cuda") -> torch.Tensor:
    """Execute a planned GEMM chain end-to-end; returns canonical output.

    x: (tokens, K0); weights[i]: (K_i, M_i) with M_i == K_{i+1}.  Each step
    is one ``ops.rir_matmul`` launch (the CUDA kernel on the card, its plain
    version on the CPU) with the epilogue permutation derived from the
    plan's consecutive boundary layouts; intermediate activations only ever
    exist in their planned boundary layouts.  The JAX ``use_pallas`` switch
    has no counterpart: the device decides.  A ``prepared`` ``PreparedPlan``
    skips the per-call setup; it must come from THIS plan, these weights,
    this block and this device (checked, so a stale one raises
    ``PlanError`` instead of computing with old weights).
    """
    if prepared is None:
        prepared = PreparedPlan(plan, int(np.shape(x)[-1]), weights,
                                block=block, device=device)
    elif _prepared_is_stale(prepared, plan, block, weights) \
            or prepared.x_dim != np.shape(x)[-1] \
            or prepared.device != resolve_device(device):
        raise PlanError("prepared= was built from a different "
                        "(plan, weights, block, device) than this call's "
                        "arguments")
    return prepared(x, activation=activation)


def execute_plan_reference(plan: ExecutionPlan, x, weights: Sequence, *,
                           block: int = RIR_BLOCK,
                           activation: Activation = None,
                           device: str | torch.device = "cuda"
                           ) -> torch.Tensor:
    """Same schedule through the ``kernels/ref.py`` plain versions — the
    ground truth ``execute_plan`` is held against."""
    dev = resolve_device(device)
    perms = _boundary_perms(plan, int(np.shape(x)[-1]), weights, block)
    x = _tensor(x).to(dev)
    cur = apply_block_perm(x, perms[0], block) if len(perms[0]) > 1 else x
    for i, (step, w) in enumerate(zip(plan.steps, weights)):
        in_perm, out_perm = perms[i], perms[i + 1]
        w = _tensor(w).to(dev)
        w_eff = permute_weight_blocks(w, in_perm, block) \
            if len(in_perm) > 1 else w
        if len(out_perm) > 1:
            cur = ref.rir_matmul(cur, w_eff, out_perm, block)
        else:
            cur = torch.matmul(cur.float(), w_eff.float()).to(cur.dtype)
        if activation is not None and i < len(plan.steps) - 1:
            cur = activation(cur)
    return invert_block_perm(cur, perms[-1], block) \
        if len(perms[-1]) > 1 else cur


# =========================================================================
# Whole-network execution: convolutions + residual joins through rir_matmul
# =========================================================================
def adapt_activation(a: torch.Tensor, H: int, W: int, C: int) -> torch.Tensor:
    """Deterministic boundary adapter between sampled (non-chaining) layers.

    * spatial larger-than-wanted: integer-stride subsample then crop
      (the pooling stand-in),
    * spatial smaller-than-wanted: symmetric zero pad (SAME padding),
    * channels: truncate or zero-pad at the end (projection-free bridge).

    ``F.pad`` takes its (low, high) pairs last axis first: (C, W, H).
    """
    N, h, w, c = a.shape
    if h > H:
        a = a[:, ::h // H, :, :][:, :H]
    elif h < H:
        lo = (H - h) // 2
        a = F.pad(a, (0, 0, 0, 0, lo, H - h - lo))
    if w > W:
        a = a[:, :, ::w // W, :][:, :, :W]
    elif w < W:
        lo = (W - w) // 2
        a = F.pad(a, (0, 0, lo, W - w - lo))
    if c > C:
        a = a[..., :C]
    elif c < C:
        a = F.pad(a, (0, C - c))
    return a


def _adapt_src_coords(coords: np.ndarray, have: int, want: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Index form of the spatial half of ``adapt_activation``: for canvas
    coordinates in [0, want) return (source index, in-bounds mask)."""
    if have > want:
        return coords * (have // want), np.ones_like(coords, bool)
    if have < want:
        lo = (want - have) // 2
        c = coords - lo
        return np.clip(c, 0, have - 1), (c >= 0) & (c < have)
    return coords, np.ones_like(coords, bool)


@functools.lru_cache(maxsize=1024)
def _patch_row_map(N: int, h_in: int, w_in: int, H: int, W: int,
                   P: int, Q: int, R: int, S: int, stride: int) -> np.ndarray:
    """Fused (boundary adapter ∘ im2col) row gather.

    Maps each output position x tap to a flat row of the producer's stored
    2D activation ``(N*h_in*w_in, F)``; out-of-bounds (SAME-pad) taps point
    at the appended zero row ``N*h_in*w_in``.  Returns (N*P*Q, R*S) int32.
    """
    h = np.arange(P)[:, None] * stride + np.arange(R)[None, :]      # (P, R)
    w = np.arange(Q)[:, None] * stride + np.arange(S)[None, :]      # (Q, S)
    src_h, ok_h = _adapt_src_coords(h, h_in, H)
    src_w, ok_w = _adapt_src_coords(w, w_in, W)
    n = np.arange(N)[:, None, None, None, None]
    rows = ((n * h_in + src_h[None, :, None, :, None]) * w_in
            + src_w[None, None, :, None, :])                # (N, P, Q, R, S)
    ok = ok_h[None, :, None, :, None] & ok_w[None, None, :, None, :]
    rows = np.where(ok, rows, N * h_in * w_in)
    return np.ascontiguousarray(
        rows.reshape(N * P * Q, R * S).astype(np.int32))


def _stored_col_canon(perm: Tuple[int, ...], width: int,
                      block: int) -> np.ndarray:
    """Canonical channel held by each stored column of a boundary tensor."""
    if len(perm) > 1:
        return _gather_indices(perm, block)
    return np.arange(width, dtype=np.int64)


def _effective_conv_weight(wl, w, in_width: int, in_perm: Tuple[int, ...],
                           block: int) -> torch.Tensor:
    """Dense (taps*in_width, M) weight aligned to the producer's stored cols.

    Folds the im2col weight reshape, the boundary-layout K-block alignment
    (stored column j holds canonical channel ``gidx[j]``) and the channel
    half of the boundary adapter (stored channels beyond the layer's fan-in
    get zero rows; missing channels have no column) into one offline tensor.
    Depthwise layers use the block-diagonal dense form.  Built on the CPU.
    """
    taps = wl.R * wl.S
    c_eff = input_channels(wl)
    w = _f32(w).cpu()
    if is_depthwise(wl):
        flat = w.reshape(taps, wl.M)                        # (taps, M)
        canon = torch.zeros((taps, c_eff, wl.M), dtype=torch.float32)
        idx = torch.arange(wl.M)
        canon[:, idx, idx] = flat
    else:
        if w.dim() == 2:                                    # squeezed 1x1
            w = w.reshape(wl.R, wl.S, wl.C, wl.M)
        canon = w.reshape(taps, c_eff, wl.M)
    gidx = _stored_col_canon(in_perm, in_width, block)
    valid = gidx < c_eff
    safe = np.where(valid, np.minimum(gidx, c_eff - 1), 0)
    w_eff = canon[:, torch.from_numpy(safe), :] \
        * torch.from_numpy(valid.astype(np.float32))[None, :, None]
    return w_eff.reshape(taps * in_width, wl.M)


def _pad_cols(x: torch.Tensor, mult: int) -> torch.Tensor:
    """Zero-pad the last axis up to a multiple of ``mult``."""
    pad = (-x.shape[-1]) % mult
    return F.pad(x, (0, pad)) if pad else x


@dataclasses.dataclass
class _JoinExec:
    """Resolved execution of one skip join at a step's output boundary."""

    src: int
    fused: bool                    # stored shapes+perms agree: epilogue add
    src_perm: Tuple[int, ...]
    src_shape: Tuple[int, int, int, int]       # (N, P, Q, M) of the source


@dataclasses.dataclass
class _NetStep:
    """Everything layer execution needs, derived once at prepare time."""

    wl: object
    row_map: Optional[torch.Tensor]  # flat int64 rows; None = pure GEMM
    w_eff: torch.Tensor              # (K, M_pad) kernel-ready weight
    block_n: int                     # the kernel's output block width
    k_width: int                     # taps * in_width
    rows_out: int
    out_perm: Tuple[int, ...]
    perm_dev: Optional[torch.Tensor]  # out_perm as a device int32 tensor
    joins: Tuple[_JoinExec, ...]
    out_shape: Tuple[int, int, int, int]       # (N, P, Q, M)
    bias: Optional[torch.Tensor] = None   # (M,), stored in out_perm order


class PreparedNetwork:
    """``execute_network``'s per-(plan, graph, weights, device) setup, hoisted.

    Derives every boundary's block permutation, every layer's fused
    (adapter ∘ im2col) patch-gather row map, the layout-aligned effective
    weights and the resolved join strategy, and places them on ``device`` —
    so a serving loop pays only the per-batch gathers and kernel launches.
    """

    def __init__(self, plan: ExecutionPlan, graph: LayerGraph,
                 weights: Sequence, *, block: int = RIR_BLOCK,
                 biases: Optional[Sequence] = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        if len(plan.steps) != len(graph.layers):
            raise PlanError(f"plan has {len(plan.steps)} steps for "
                            f"{len(graph.layers)}-layer graph")
        if len(weights) != len(graph.layers):
            raise PlanError(f"{len(weights)} weights for "
                            f"{len(graph.layers)} layers")
        if biases is not None and len(biases) != len(graph.layers):
            raise PlanError(f"{len(biases)} biases for "
                            f"{len(graph.layers)} layers")
        for step, wl in zip(plan.steps, graph.layers):
            if step.workload.dims() != wl.dims() or \
                    step.workload.stride != wl.stride:
                raise PlanError(f"plan step {step.layer} does not match "
                                f"graph layer {wl.name}")
        self.plan = plan
        self.graph = graph
        self.block = block
        self.weights = tuple(weights)
        self.biases = None if biases is None else tuple(biases)
        self.input_shape = graph.input_shape()
        dev = self.device

        # boundary feature widths + block perms: boundary 0 is the network
        # input, boundary i+1 carries layer i's output
        widths = [input_channels(graph.layers[0])] + \
            [wl.M for wl in graph.layers]
        self.perms: List[Tuple[int, ...]] = \
            _derive_boundary_perms(plan, widths, block)

        self.steps: List[_NetStep] = []
        for i, (step, wl, w) in enumerate(zip(plan.steps, graph.layers,
                                              weights)):
            in_width = widths[i]
            shape = weight_shape(wl)
            got = tuple(np.shape(w))
            if got not in (shape, shape[-2:] if wl.R == wl.S == 1 else shape):
                raise PlanError(f"layer {wl.name}: weight shape {got} != "
                                f"expected {shape}")
            prev_wl = graph.layers[i - 1] if i > 0 else None
            h_in, w_in = (prev_wl.P, prev_wl.Q) if prev_wl else \
                (wl.H, wl.W)
            passthrough = (wl.R == 1 and wl.S == 1 and wl.stride == 1
                           and h_in == wl.H and w_in == wl.W)
            row_map = None if passthrough else torch.from_numpy(
                _patch_row_map(wl.N, h_in, w_in, wl.H, wl.W, wl.P, wl.Q,
                               wl.R, wl.S, wl.stride).reshape(-1)
            ).to(dev, torch.int64)
            # only N is padded, once, here: the kernel masks ragged M and K
            # itself.  A multi-block output pads to whole perm blocks; a
            # single block (nothing to permute) only to the kernel's tile, and
            # launches as one block of that width
            out_perm = self.perms[i + 1]
            w_eff = _pad_cols(_effective_conv_weight(
                wl, w, in_width, self.perms[i], block),
                block if len(out_perm) > 1 else ops.TILE_N)
            block_n = block if len(out_perm) > 1 else w_eff.shape[1]
            bias = None
            if biases is not None and biases[i] is not None:
                bias = _f32(biases[i])
                if tuple(bias.shape) != (wl.M,):
                    raise PlanError(f"layer {wl.name}: bias shape "
                                    f"{tuple(bias.shape)} != ({wl.M},)")
                bias = bias.to(dev)
                if len(out_perm) > 1:
                    # the bias joins the output in its stored (boundary-
                    # layout) block order, like the fused residual
                    bias = apply_block_perm(bias, out_perm, block)
            joins = []
            for j in step.joins:
                src = j.src
                if not 0 <= src < i:
                    raise PlanError(f"step {step.layer}: bad join src {src}")
                swl = graph.layers[src]
                fused = (swl.P, swl.Q) == (wl.P, wl.Q) and swl.M == wl.M \
                    and self.perms[src + 1] == out_perm and swl.N == wl.N
                joins.append(_JoinExec(
                    src=src, fused=fused, src_perm=self.perms[src + 1],
                    src_shape=(swl.N, swl.P, swl.Q, swl.M)))
            self.steps.append(_NetStep(
                wl=wl, row_map=row_map, w_eff=w_eff.to(dev).contiguous(),
                block_n=block_n, k_width=wl.R * wl.S * in_width,
                rows_out=wl.N * wl.P * wl.Q, out_perm=out_perm,
                perm_dev=(ops.device_perm(out_perm, dev)
                          if len(out_perm) > 1 else None),
                joins=tuple(joins), out_shape=(wl.N, wl.P, wl.Q, wl.M),
                bias=bias))
        self._buffer_set = set(graph.buffer_sources())
        # fused groups (schema v4): ``fused_with`` chains a step into its
        # immediate consumer, so the group is fenced (and its wall-clock
        # measured) as ONE unit.  ``_group_start[i]`` is the first member of
        # the group step i closes; unfused steps are their own group.
        for i, step in enumerate(plan.steps):
            if step.fused_with is not None and step.fused_with != i + 1:
                raise PlanError(f"step {step.layer}: fused_with="
                                f"{step.fused_with} is not the next layer")
        if plan.steps and plan.steps[-1].fused_with is not None:
            raise PlanError("last step cannot fuse into a consumer")
        self._group_start: List[int] = []
        start = 0
        for i, step in enumerate(plan.steps):
            self._group_start.append(start)
            if step.fused_with is None:
                start = i + 1
        self._prov: Optional[Dict[str, object]] = None

    def _provenance(self) -> Dict[str, object]:
        if self._prov is None:
            self._prov = _plan_provenance(self.plan)
        return self._prov

    # ------------------------------------------------- batch assembly hooks
    # The serving engine's contract: requests are single samples, the plan
    # is built at the serve batch extent, and a partial batch is padded with
    # zero samples.  Every operation is per-sample (a gathered patch row of
    # sample ``b`` reads only sample ``b``'s rows, a GEMM output row is a
    # function of its own input row, and the kernel's summation order does
    # not depend on the other rows), so request ``b``'s output is
    # bit-identical whether it shares the batch with real samples, zero
    # padding, or nothing.
    @property
    def max_batch(self) -> int:
        """The plan tile's batch extent — the most requests one batch holds."""
        return self.input_shape[0]

    def assemble_batch(self, samples: Sequence) -> torch.Tensor:
        """Stack 1..max_batch single samples, zero-padded to the plan's N.

        The batch is assembled on the host and moved to the device in one
        copy.  Each sample must match ``input_shape()[1:]`` exactly.
        """
        n = self.max_batch
        k = len(samples)
        if not 1 <= k <= n:
            raise PlanError(f"{k} samples for max_batch={n}")
        shp = tuple(self.input_shape[1:])
        x = torch.zeros((n,) + shp, dtype=torch.float32)
        for i, s in enumerate(samples):
            a = _f32(s)
            if tuple(a.shape) != shp:
                raise PlanError(f"sample {i} shape {tuple(a.shape)} != "
                                f"planned per-sample shape {shp}")
            x[i] = a
        return x.to(self.device)

    def execute_requests(self, samples: Sequence, *,
                         activation: Activation = None
                         ) -> List[torch.Tensor]:
        """Run a padded request batch; return each request's own output."""
        y = self(self.assemble_batch(samples), activation=activation)
        return [y[i] for i in range(len(samples))]

    # ------------------------------------------------------------- execution
    def _join_term(self, st: _NetStep, je: _JoinExec, buf: torch.Tensor,
                   block: int) -> torch.Tensor:
        """Bring a buffered skip tensor into this step's output layout.

        Fused joins return the buffer unchanged (already concordant); the
        relayout path canonicalizes, runs the boundary adapter, and re-stores
        in the consumer's layout — the pass the planner costed as
        ``JoinSpec.relayout``.
        """
        if je.fused:
            return buf
        canon = invert_block_perm(buf, je.src_perm, block) \
            if len(je.src_perm) > 1 else buf
        canon = canon.reshape(je.src_shape)
        N, P, Q, M = st.out_shape
        canon = adapt_activation(canon, P, Q, M).reshape(N * P * Q, M)
        return apply_block_perm(canon, st.out_perm, block) \
            if len(st.out_perm) > 1 else canon

    def __call__(self, x, *, activation: Activation = None) -> torch.Tensor:
        block = self.block
        N, H, W, C = self.input_shape
        # traced executions fence every layer (group) with a device sync and
        # record the measured wall-clock next to the plan's modeled numbers;
        # values are untouched, so outputs are bit-identical traced or not
        traced = obs.enabled()
        with obs.span("exec.network",
                      dict(self._provenance(), batch=int(N))
                      if traced else None):
            a = adapt_activation(_f32(x).to(self.device), H, W, C)
            if a.shape[0] != N:
                raise PlanError(f"batch {a.shape[0]} != planned N={N}")
            cur = a.reshape(N * H * W, C)
            if len(self.perms[0]) > 1:
                cur = apply_block_perm(cur, self.perms[0], block)
            buffers: Dict[int, torch.Tensor] = {}
            last = len(self.steps) - 1
            t0 = None
            for i, st in enumerate(self.steps):
                faults.site(faults.EXEC_DISPATCH)
                if traced and self._group_start[i] == i:
                    t0 = obs.now_us()
                if st.row_map is None:
                    patches = cur
                else:
                    padded = torch.cat([cur, cur.new_zeros((1, cur.shape[1]))])
                    patches = padded.index_select(0, st.row_map).reshape(
                        st.rows_out, st.k_width)
                fused_res = None
                for je in st.joins:
                    if not je.fused:
                        continue
                    term = buffers[je.src]
                    fused_res = term if fused_res is None \
                        else fused_res + term
                if fused_res is not None:
                    fused_res = _pad_cols(fused_res, st.block_n).contiguous()
                y = ops.rir_matmul(patches.contiguous(), st.w_eff,
                                   st.perm_dev, residual=fused_res,
                                   block_n=st.block_n)
                y = y[:, :st.wl.M]
                if st.bias is not None:
                    y = y + st.bias[None, :]
                for je in st.joins:
                    if je.fused:
                        continue
                    y = y + self._join_term(st, je, buffers[je.src], block)
                if activation is not None and i < last:
                    y = activation(y)
                # a fused step's output stays inside the group: no fence, no
                # span — the group's tail measures the whole chain
                if traced and self.plan.steps[i].fused_with is None:
                    if y.is_cuda:
                        torch.cuda.synchronize(y.device)
                    gs = self._group_start[i]
                    attrs = _step_attrs(self._provenance(), i,
                                        self.plan.steps[i])
                    if gs != i:
                        members = self.plan.steps[gs:i + 1]
                        attrs.update(
                            fused_group=f"{gs}-{i}",
                            modeled_cycles=sum(s.cycles for s in members),
                            modeled_energy_pj=sum(s.energy_pj
                                                  for s in members),
                            modeled_stall_cycles=sum(s.dram_stall_cycles
                                                     for s in members))
                    obs.record_span("exec.step", t0, attrs)
                if i in self._buffer_set:
                    buffers[i] = y
                cur = y
            out_perm = self.perms[-1]
            if len(out_perm) > 1:
                cur = invert_block_perm(cur, out_perm, block)
            out = cur.reshape(self.steps[-1].out_shape)
        return out


def prepare_network(plan: ExecutionPlan, graph: LayerGraph,
                    weights: Sequence, *, block: int = RIR_BLOCK,
                    biases: Optional[Sequence] = None,
                    device: str | torch.device = "cuda") -> PreparedNetwork:
    """Hoist gathers/weights/join strategy out of the per-batch path."""
    return PreparedNetwork(plan, graph, weights, block=block, biases=biases,
                           device=device)


def _biases_stale(prepared_biases, biases) -> bool:
    want = None if biases is None else tuple(biases)
    if (prepared_biases is None) != (want is None):
        return True
    if want is None:
        return False
    return len(prepared_biases) != len(want) or any(
        a is not b for a, b in zip(prepared_biases, want))


def execute_network(plan: ExecutionPlan, graph: LayerGraph, x,
                    weights: Sequence, *, block: int = RIR_BLOCK,
                    activation: Activation = None,
                    prepared: Optional[PreparedNetwork] = None,
                    biases: Optional[Sequence] = None,
                    device: str | torch.device = "cuda") -> torch.Tensor:
    """Execute a complete planned ``LayerGraph`` — convs, depthwise layers
    and residual joins included — through ``ops.rir_matmul``.

    x: canonical NHWC input (run through the boundary adapter if it does not
    match ``graph.input_shape()`` exactly).  Returns the last layer's output
    in canonical NHWC order, on ``device``.  ``biases`` (per-layer, e.g. from
    ``fold_batchnorm``) are added to each layer's output before joins and
    activation.  A ``prepared`` network must come from this call's plan,
    graph, weights, biases, block and device.
    """
    if prepared is None:
        prepared = PreparedNetwork(plan, graph, weights, block=block,
                                   biases=biases, device=device)
    elif _prepared_is_stale(prepared, plan, block, weights) \
            or prepared.graph != graph \
            or _biases_stale(prepared.biases, biases) \
            or prepared.device != resolve_device(device):
        raise PlanError("prepared= was built from a different "
                        "(plan, graph, weights, biases, block, device) than "
                        "this call")
    return prepared(x, activation=activation)


def execute_network_reference(graph: LayerGraph, x, weights: Sequence, *,
                              activation: Activation = None,
                              biases: Optional[Sequence] = None,
                              device: str | torch.device = "cuda"
                              ) -> torch.Tensor:
    """Canonical-layout oracle for ``execute_network``.

    Plain ``kernels/ref.py`` conv/depthwise semantics plus the same boundary
    adapter, per-layer biases and residual joins; no layouts, no plans —
    every valid plan for ``graph`` must reproduce this function's output.
    """
    dev = resolve_device(device)
    outs: List[torch.Tensor] = []
    cur = _f32(x).to(dev)
    last = len(graph.layers) - 1
    for i, (wl, w) in enumerate(zip(graph.layers, weights)):
        a = adapt_activation(cur, wl.H, wl.W, input_channels(wl))
        w = _f32(w).to(dev)
        if is_depthwise(wl):
            y = ref.depthwise_conv2d(a, w, wl.stride)
        else:
            if w.dim() == 2:
                w = w.reshape(wl.R, wl.S, wl.C, wl.M)
            y = ref.conv2d(a, w, wl.stride)
        if biases is not None and biases[i] is not None:
            y = y + _f32(biases[i]).to(dev)[None, None, None, :]
        for src in graph.skips_into(i):
            y = y + adapt_activation(outs[src], wl.P, wl.Q, wl.M)
        if activation is not None and i < last:
            y = activation(y)
        outs.append(y)
        cur = y
    return outs[-1]
