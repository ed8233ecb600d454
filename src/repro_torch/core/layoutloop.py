"""Layoutloop — dataflow x layout co-evaluation and co-search (paper §V).

Extends the Timeloop-style analytical model with:
  (1) physical storage modeling  (``core.layout.Buffer``: lines, banks, ports),
  (2) bank-conflict slowdown     (``core.conflicts``),
  (3) layout-aware energy        (line-level access counting),
  (4) reordering implementations (none / off-chip / RAR variants / RIR),
  (5) (dataflow, layout) co-search minimizing EDP per layer.

Two evaluation paths produce bit-identical numbers:

* ``evaluate``          — one (dataflow, tiling, layout, mode) point; the
  scalar oracle, kept deliberately simple.  The on-chip tiling rides on
  ``Dataflow.tiles`` and drives the DRAM reuse/capacity terms
  (``tile_dram_terms``) plus the conflict sample bases.

**The tile pipeline model** (``tile_dram_terms`` + ``exposed_stall_cycles``):
off-chip traffic splits into the mandatory one-pass stream (``tensor`` bytes,
assumed hidden under the compute pipeline — the streaming the Nest is
designed for) and the refetch beyond it.  Single-buffered tilings
(``Dataflow.double_buffer`` False) expose ALL refetch serially at the layer
end — the PR 4 model, preserved bit-for-bit.  Double-buffered (ping-pong)
tilings devote half the buffer to the next tile's fetch, so execution is a
steady-state pipeline over the ``n_tiles`` outer-tile steps: the exposed
stall is one **prologue fill** (the first tile's fetch beyond its hidden
stream share, ``tile_mem - tile_base``) plus, per steady tile, only the
overhang ``max(0, tile_mem - max(tile_base, tile_compute))`` that neither
the hidden stream credit nor the overlapped compute covers.  Because the
steady overhang never exceeds the serial per-tile charge, a double-buffered
tiling is never costlier than the same tiling single-buffered whenever its
working set still fits the halved resident capacity — the planner's argmin
moves toward aggressive tilings whose refetch streams for free, exactly the
"switching under the hood" the paper argues for (§IV's ping-pong Nest
buffers).

**Per-tensor buffer allocation** (``Dataflow.buffer_alloc``): the uniform
ping-pong split halves the whole buffer even though weights, iActs and
partial sums have completely different revisit phases.  A per-tensor
allocation double-buffers only a subset of the three tensors: each tensor
in the subset claims a ping-pong pair (2x its tile footprint), the rest a
single tile, and the spill factor is taken against the full capacity with
that *allocation-weighted* working set.  The stall model then charges each
regime its own exposure — the single-buffered tensors' refetch is serial
(``sb_stall_cycles``, their PR 4 charge), while the double-buffered subset
runs the steady-state tile pipeline (prologue + per-steady-tile overhang)
computed from that subset's traffic alone.  The two uniform endpoints
(no tensor / every tensor double-buffered) bypass the split entirely and
reproduce the PR 4 / PR 5 numbers bit-for-bit (golden-tested).

**Fusion boundary contract** (``fused_in`` / ``fused_out`` on
``tile_dram_terms``): a fused layer boundary keeps the boundary tensor
entirely on chip — the producer's oAct write and the consumer's iAct read
never touch DRAM, so both their one-pass stream and their refetch traffic
drop out of the fused side's terms.  This is only sound when the boundary
tensor actually stays resident: a side that revisits the boundary tensor
(oAct partial-sum round trips ``n_C*n_R*n_S > 1``; iAct rereads
``n_M > 1``) must pin the FULL tensor, a single-pass side only stages one
tile.  ``fusion_feasible`` checks that the pinned residency plus the side's
allocation-weighted working set fits HALF the buffer, so any producer +
consumer pair that both pass share the buffer soundly (their combined
working set fits it whole).  Off-chip reorder modes are incompatible with a
fused output boundary — relayout there must ride the reduction (RIR) or
keep the layout.
* ``evaluate_lattice``  — the full 4-D (dataflow x tile x layout x mode)
  candidate lattice in a handful of vectorized numpy passes: conflict
  statistics come from ``conflicts.assess_iact_conflicts_lattice`` (temporal
  samples shared per tiled dataflow, one relief evaluation shared by every
  mode that maps to it) and the nest timing / reorder overhead / DRAM tile
  terms / energy rollup are array expressions over the whole lattice.
  ``cosearch_layer`` / ``network_eval`` and the network planner reduce over
  the resulting ``LatticeMetrics`` table instead of looping scalar
  ``evaluate`` calls.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .conflicts import assess_iact_conflicts, assess_iact_conflicts_lattice
from .dataflow import (BUFFER_TENSORS, ConvWorkload, Dataflow,
                       enumerate_dataflows, tensor_words_split, tile_extents,
                       tile_footprint_split, tile_traffic_split,
                       tile_traffic_words, tile_working_set)
from .energy import DEFAULT_ENERGY, EnergyModel
from .layout import Buffer, Layout, conv_layout_space
from .nest import NestConfig, nest_cycle_terms, nest_cycles

# Read-side conflict relief each reorder implementation provides (paper
# Fig. 5); modes sharing a relief share one conflict assessment in the
# lattice path.
READ_RELIEF = {"none": "none", "offchip": "none",
               "line_rotation": "line_rotation", "transpose": "transpose",
               "row_reorder": "none", "rir": "arbitrary"}


@dataclasses.dataclass(frozen=True)
class Metrics:
    cycles: float
    compute_cycles: float
    reorder_cycles: float          # exposed (critical-path) reorder latency
    slowdown: float                # bank-conflict stretch (>= 1)
    utilization: float             # practical steady-state PE utilization
    energy_pj: float
    dram_bytes: float
    line_reads: float
    pj_per_mac: float = float("nan")
    dram_stall_cycles: float = 0.0   # exposed off-chip refetch/spill latency

    @property
    def edp(self) -> float:
        return self.energy_pj * self.cycles


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    nest: NestConfig = NestConfig()
    buffer: Buffer = Buffer(num_lines=512, line_size=32, conflict_depth=8, ports=2)
    reorder: str = "none"     # none|offchip|line_rotation|transpose|row_reorder|rir
    dram_bytes_per_cycle: float = 16.0   # off-chip BW in bytes/cycle
    energy: EnergyModel = DEFAULT_ENERGY
    dtype_bytes: int = 1      # int8


@dataclasses.dataclass(frozen=True)
class ReorderOverhead:
    """Cost of materializing a layer's oActs in a *different* layout than the
    dataflow naturally produces, under one reorder implementation.

    This is the layer-boundary *transition cost* the network planner
    (``repro.plan.search``) charges when consecutive layers disagree on the
    boundary layout; ``evaluate`` charges the same quantity inline.
    """

    cycles: float          # exposed (non-overlapped) latency
    energy_pj: float
    dram_bytes: float      # extra off-chip traffic (off-chip reorder only)
    line_reads: float      # extra on-chip line reads (RAR pass)
    line_writes: float


def reorder_overhead(wl: ConvWorkload, cfg: EvalConfig, mode: str,
                     compute_cycles: float = 0.0) -> ReorderOverhead:
    """Overhead of relayouting ``wl``'s oAct tensor via ``mode``.

    ``compute_cycles`` is the producing layer's compute time; off-chip
    round-trips overlap with it and only the remainder is exposed (pass 0.0
    for a standalone transition, e.g. a residual-edge relayout).
    """
    e = cfg.energy
    oact_words = math.prod(wl.oact_dims().values())
    oact_lines = max(1.0, oact_words / cfg.buffer.line_size)
    if mode == "offchip":
        # oActs round-trip through DRAM for relayout (paper Fig. 6a); latency
        # overlaps with compute of the next tile, the remainder is exposed.
        rt_bytes = 2.0 * oact_words * cfg.dtype_bytes
        rt_cycles = rt_bytes / cfg.dram_bytes_per_cycle
        return ReorderOverhead(
            cycles=max(0.0, rt_cycles - 0.9 * compute_cycles),
            energy_pj=e.dram_bytes_pj(rt_bytes), dram_bytes=rt_bytes,
            line_reads=0.0, line_writes=0.0)
    if mode in ("line_rotation", "transpose", "row_reorder"):
        # RAR (paper Fig. 6b): oActs are re-read, pushed through the reorder
        # unit and re-written — an exposed on-chip pass over the tensor.
        return ReorderOverhead(
            cycles=max(1.0, oact_lines / cfg.buffer.ports),
            energy_pj=oact_lines * (e.sram_line_read_pj + e.sram_line_write_pj),
            dram_bytes=0.0, line_reads=oact_lines, line_writes=oact_lines)
    if mode == "rir":
        # BIRRD hop energy: each oAct word traverses 2*log2(AW) Egg stages;
        # the reorder rides the reduction, so no cycles are exposed.
        stages = 2 * int(math.log2(cfg.nest.aw))
        return ReorderOverhead(
            cycles=0.0,
            energy_pj=oact_words * stages * (e.noc_hop_pj + e.adder_pj / 2),
            dram_bytes=0.0, line_reads=0.0, line_writes=0.0)
    if mode == "none":
        return ReorderOverhead(0.0, 0.0, 0.0, 0.0, 0.0)
    raise ValueError(f"unknown reorder mode {mode!r}")


@dataclasses.dataclass(frozen=True)
class TileDramTerms:
    """Memory-side pipeline terms of one (workload, tiled dataflow) point.

    ``exposed_stall_cycles`` turns these into the exposed latency given the
    point's compute cycles; keeping the two separate lets the 4-D lattice
    compute the (layout, mode)-dependent overlap as one array expression
    while sharing these per-(dataflow, tile) scalars with the scalar path.
    """

    traffic_bytes: float        # total off-chip traffic incl. spill factor
    serial_stall_cycles: float  # PR-4 charge: all beyond-one-pass, serial
    n_tiles: int                # outer-tile iterations of the tile loop
    tile_mem_cycles: float      # per-tile DRAM cycles of the *pipelined*
    # (double-buffered) tensor subset — all traffic on uniform points
    tile_base_cycles: float     # per-tile share of that subset's hidden
    # one-pass stream
    prologue_cycles: float      # first tile's fetch beyond its stream share
    double_buffer: bool         # True iff any tensor's refetch pipelines
    sb_stall_cycles: float = 0.0   # serial exposure of the single-buffered
    # tensor subset under a per-tensor allocation (0.0 on uniform points)


def _fused_residency_words(wl: ConvWorkload, ext, n) -> dict:
    """Buffer words each fused boundary tensor pins (the fusion contract):
    the FULL tensor when the tiling revisits it, one tile otherwise."""
    fp = tile_footprint_split(wl, ext)
    full = tensor_words_split(wl)
    return {
        "iact": full["iact"] if n["M"] > 1 else fp["iact"],
        "oact": full["oact"] if n["C"] * n["R"] * n["S"] > 1 else fp["oact"],
    }


def tile_dram_terms(wl: ConvWorkload, df: Dataflow, cfg: EvalConfig,
                    fused_in: bool = False, fused_out: bool = False
                    ) -> TileDramTerms:
    """Off-chip traffic + steady-state pipeline terms for ``df``'s tiling.

    The layer's effective tile (``dataflow.tile_extents``: declared tiles
    clamped into [spatial factor, dim]) determines two things the untiled
    model ignored:

    * **reuse** — each tensor is re-fetched per outer-tile iteration over
      the dims it does not index (``tile_traffic_words``), and
    * **capacity** — a tile whose working set overflows the on-chip buffer
      thrashes: all traffic is scaled by the overflow factor.  A ping-pong
      tiling (``df.double_buffer``) only has HALF the buffer resident — the
      other half holds the next tile in flight — so its spill factor is
      taken against the halved capacity.

    The mandatory one-pass stream (``tensor_bytes``) is hidden under the
    compute pipeline in both buffering regimes.  ``serial_stall_cycles`` is
    the single-buffered exposure (all refetch at the layer end, the PR 4
    model, preserved bit-for-bit); the per-tile terms feed
    ``exposed_stall_cycles`` for the double-buffered pipeline.  Both the
    scalar ``evaluate`` and the 4-D lattice call these helpers, so the two
    paths stay bit-identical by construction.

    A *per-tensor* allocation (``df.buffer_alloc``) or a fused boundary
    (``fused_in`` / ``fused_out``, see the module docstring's fusion
    contract) takes the general split below instead: per-tensor traffic,
    per-regime stalls, fused tensors elided from DRAM entirely.  The two
    uniform endpoints keep the exact float operations above so the PR 4 /
    PR 5 goldens reproduce bit-for-bit.
    """
    ext = tile_extents(wl, df)
    capacity = cfg.buffer.num_lines * cfg.buffer.line_size
    db = df.db_tensors()
    uniform = not db or len(db) == len(BUFFER_TENSORS)
    if uniform and not fused_in and not fused_out:
        traffic_words = tile_traffic_words(wl, ext)
        if df.double_buffer:
            capacity = capacity / 2    # ping-pong: half holds the live tile
        spill = max(1.0, tile_working_set(wl, ext) / capacity)
        traffic_bytes = traffic_words * cfg.dtype_bytes * spill
        iact_words = math.prod(wl.iact_dims().values())
        w_words = math.prod(wl.weight_dims().values())
        oact_words = math.prod(wl.oact_dims().values())
        tensor_bytes = (iact_words + w_words + oact_words) * cfg.dtype_bytes
        serial = max(0.0, (traffic_bytes - tensor_bytes)
                     / cfg.dram_bytes_per_cycle)
        dims = wl.dims()
        n_tiles = math.prod(math.ceil(dims[d] / ext[d]) for d in dims)
        tile_mem = traffic_bytes / n_tiles / cfg.dram_bytes_per_cycle
        tile_base = tensor_bytes / n_tiles / cfg.dram_bytes_per_cycle
        return TileDramTerms(
            traffic_bytes=traffic_bytes, serial_stall_cycles=serial,
            n_tiles=n_tiles, tile_mem_cycles=tile_mem,
            tile_base_cycles=tile_base,
            prologue_cycles=max(0.0, tile_mem - tile_base),
            double_buffer=df.double_buffer)

    # ---- general per-tensor split (mixed allocation and/or fused boundary)
    dims = wl.dims()
    n = {d: math.ceil(dims[d] / ext[d]) for d in dims}
    fused = frozenset(t for t, f in (("iact", fused_in), ("oact", fused_out))
                      if f)
    live = [t for t in BUFFER_TENSORS if t not in fused]
    fp = tile_footprint_split(wl, ext)
    full = tensor_words_split(wl)
    need = _fused_residency_words(wl, ext, n)
    claim = sum(need[t] if t in fused else fp[t] * (2 if t in db else 1)
                for t in BUFFER_TENSORS)
    spill = max(1.0, claim / capacity)
    tr = tile_traffic_split(wl, ext)
    bw = cfg.dram_bytes_per_cycle
    traffic_bytes = sum(tr[t] for t in live) * cfg.dtype_bytes * spill
    tensor_bytes = sum(full[t] for t in live) * cfg.dtype_bytes
    serial = max(0.0, (traffic_bytes - tensor_bytes) / bw)
    sb_live = [t for t in live if t not in db]
    db_live = [t for t in live if t in db]
    sb_traffic = sum(tr[t] for t in sb_live) * cfg.dtype_bytes * spill
    sb_base = sum(full[t] for t in sb_live) * cfg.dtype_bytes
    sb_stall = max(0.0, (sb_traffic - sb_base) / bw)
    db_traffic = sum(tr[t] for t in db_live) * cfg.dtype_bytes * spill
    db_base = sum(full[t] for t in db_live) * cfg.dtype_bytes
    n_tiles = math.prod(n.values())
    tile_mem = db_traffic / n_tiles / bw
    tile_base = db_base / n_tiles / bw
    return TileDramTerms(
        traffic_bytes=traffic_bytes, serial_stall_cycles=serial,
        n_tiles=n_tiles, tile_mem_cycles=tile_mem, tile_base_cycles=tile_base,
        prologue_cycles=max(0.0, tile_mem - tile_base),
        double_buffer=bool(db_live), sb_stall_cycles=sb_stall)


def fusion_feasible(wl: ConvWorkload, df: Dataflow, cfg: EvalConfig,
                    fused_in: bool = False, fused_out: bool = False) -> bool:
    """Whether this side of a fused edge fits HALF the buffer: the fused
    boundary tensors' pinned residency plus the allocation-weighted tiles of
    everything else.  Producer and consumer each passing their own check
    guarantees the pair's combined working set fits the whole buffer."""
    if not fused_in and not fused_out:
        return True
    ext = tile_extents(wl, df)
    dims = wl.dims()
    n = {d: math.ceil(dims[d] / ext[d]) for d in dims}
    fused = frozenset(t for t, f in (("iact", fused_in), ("oact", fused_out))
                      if f)
    fp = tile_footprint_split(wl, ext)
    need = _fused_residency_words(wl, ext, n)
    db = df.db_tensors()
    claim = sum(need[t] if t in fused else fp[t] * (2 if t in db else 1)
                for t in BUFFER_TENSORS)
    return claim <= cfg.buffer.num_lines * cfg.buffer.line_size / 2


def refused_metrics(wl: ConvWorkload, df: Dataflow, cfg: EvalConfig,
                    m: Metrics, fused_in: bool = False,
                    fused_out: bool = False) -> Metrics:
    """``m`` (an unfused ``evaluate`` result for this lattice point) with
    the fused boundary's DRAM terms elided: the stall is re-derived from the
    fused ``tile_dram_terms`` and the energy/traffic swap the old DRAM
    charge for the fused one (``EnergyModel.dram_bytes_pj`` is linear, so
    the swap is exact).  Reorder terms are untouched — callers must not
    combine ``fused_out`` with the off-chip reorder mode."""
    if not fused_in and not fused_out:
        return m
    e = cfg.energy
    t0 = tile_dram_terms(wl, df, cfg)
    t1 = tile_dram_terms(wl, df, cfg, fused_in=fused_in, fused_out=fused_out)
    stall = exposed_stall_cycles(t1, m.compute_cycles)
    cycles = m.compute_cycles + m.reorder_cycles + stall
    energy = m.energy_pj - e.dram_bytes_pj(t0.traffic_bytes) \
        + e.dram_bytes_pj(t1.traffic_bytes)
    dram_bytes = m.dram_bytes - t0.traffic_bytes + t1.traffic_bytes
    return dataclasses.replace(
        m, cycles=cycles, energy_pj=energy, dram_bytes=dram_bytes,
        dram_stall_cycles=stall, pj_per_mac=energy / max(wl.macs(), 1))


def exposed_stall_cycles(terms: TileDramTerms, compute_cycles: float
                         ) -> float:
    """Exposed DRAM stall of one lattice point, given its compute cycles.

    Single-buffered: the PR 4 serial charge (all refetch traffic exposed at
    the layer end).  Double-buffered: a steady-state ping-pong pipeline over
    the ``n_tiles`` outer-tile steps — one prologue fill (the first tile's
    fetch cannot overlap anything) plus, per steady tile, only the overhang
    of the tile's fetch beyond what the hidden one-pass stream credit and
    the overlapped compute cover.  The steady overhang is bounded by the
    serial per-tile charge (``max(tile_base, c) >= tile_base``), so for the
    same traffic the double-buffered exposure never exceeds the serial one.

    Under a per-tensor allocation the pipeline terms cover only the
    double-buffered tensor subset; the single-buffered tensors' serial
    charge (``sb_stall_cycles``, 0.0 on uniform points) is added on top.
    """
    if not terms.double_buffer:
        return terms.serial_stall_cycles
    per_tile_compute = compute_cycles / terms.n_tiles
    hidden = max(terms.tile_base_cycles, per_tile_compute)
    steady = max(0.0, terms.tile_mem_cycles - hidden)
    return terms.sb_stall_cycles + terms.prologue_cycles \
        + (terms.n_tiles - 1) * steady


def evaluate(wl: ConvWorkload, df: Dataflow, layout: Layout,
             cfg: EvalConfig, reorder: Optional[str] = None) -> Metrics:
    """Latency + energy of one layer under one (dataflow, tiling, layout)
    point — the tiling rides on ``df.tiles``.

    ``reorder`` overrides ``cfg.reorder`` for this call (the planner sweeps
    per-boundary reorder modes without rebuilding configs).
    """
    e = cfg.energy
    mode = cfg.reorder if reorder is None else reorder
    read_relief = READ_RELIEF.get(mode)
    if read_relief is None:
        raise ValueError(f"unknown reorder mode {mode!r}")
    rep = assess_iact_conflicts(wl, df, layout, cfg.buffer, reorder=read_relief)
    timing = nest_cycles(cfg.nest, wl, df, slowdown=rep.slowdown)
    compute_cycles = timing.total_cycles
    util = timing.steady_utilization / rep.slowdown

    oact_words = math.prod(wl.oact_dims().values())
    terms = tile_dram_terms(wl, df, cfg)
    traffic_bytes = terms.traffic_bytes
    dram_stall = exposed_stall_cycles(terms, compute_cycles)

    active_cycles = max(1.0, timing.total_cycles - timing.weight_load_cycles)
    line_reads = rep.avg_lines_per_cycle * active_cycles          # iActs
    line_reads += active_cycles                                   # StrB stream
    oact_lines = max(1.0, oact_words / cfg.buffer.line_size)
    line_writes = oact_lines

    ro = reorder_overhead(wl, cfg, mode, compute_cycles)
    reorder_cycles = ro.cycles
    line_reads += ro.line_reads
    line_writes += ro.line_writes
    dram_bytes = traffic_bytes + ro.dram_bytes

    energy = (
        wl.macs() * (e.mac_pj + 2 * e.reg_access_pj)
        + line_reads * e.sram_line_read_pj
        + line_writes * e.sram_line_write_pj
        + e.dram_bytes_pj(traffic_bytes)
        + ro.energy_pj
    )
    cycles = compute_cycles + reorder_cycles + dram_stall
    return Metrics(cycles=cycles, compute_cycles=compute_cycles,
                   reorder_cycles=reorder_cycles, slowdown=rep.slowdown,
                   utilization=util, energy_pj=energy, dram_bytes=dram_bytes,
                   line_reads=line_reads,
                   pj_per_mac=energy / max(wl.macs(), 1),
                   dram_stall_cycles=dram_stall)


# ------------------------------------------------------------ batched lattice
@dataclasses.dataclass(frozen=True)
class LatticeMetrics:
    """Dense per-layer cost table over a 4-D
    ``(dataflow x tile x layout x mode)`` lattice.

    Every array is indexed ``[dataflow, tile, layout, mode]``; ``metrics``
    slices one lattice point back to a ``Metrics`` bit-identical to the
    scalar ``evaluate`` call it replaces — the scalar equivalent of point
    ``(d, t, l, m)`` is ``evaluate(wl, dataflows[d].with_tiles(tilings[t]),
    layouts[l], cfg, reorder=modes[m])`` (asserted field-by-field in
    ``tests/test_lattice.py``).
    """

    workload: ConvWorkload
    dataflows: Tuple[Dataflow, ...]
    tilings: Tuple[Tuple[Tuple[str, int], ...], ...]
    layouts: Tuple[Layout, ...]
    modes: Tuple[str, ...]
    cycles: "np.ndarray"
    compute_cycles: "np.ndarray"
    reorder_cycles: "np.ndarray"
    slowdown: "np.ndarray"
    utilization: "np.ndarray"
    energy_pj: "np.ndarray"
    dram_bytes: "np.ndarray"
    line_reads: "np.ndarray"
    pj_per_mac: "np.ndarray"
    dram_stall_cycles: "np.ndarray"

    @property
    def shape(self) -> Tuple[int, int, int, int]:
        return (len(self.dataflows), len(self.tilings), len(self.layouts),
                len(self.modes))

    def key(self, objective: str) -> "np.ndarray":
        """Per-point cost under an additive objective (the planner's axes)."""
        if objective == "cycles":
            return self.cycles
        if objective == "energy":
            return self.energy_pj
        if objective in ("edp", "edp_sum"):
            return self.energy_pj * self.cycles
        raise ValueError(f"objective {objective!r} is not additive")

    def point_dataflow(self, d: int, t: int) -> Dataflow:
        """The concrete (tiled) dataflow of lattice column ``(d, t)``."""
        df = self.dataflows[d]
        return df.with_tiles(self.tilings[t]) if self.tilings[t] else df

    def metrics(self, d: int, t: int, l: int, m: int) -> Metrics:
        idx = (d, t, l, m)
        return Metrics(
            cycles=float(self.cycles[idx]),
            compute_cycles=float(self.compute_cycles[idx]),
            reorder_cycles=float(self.reorder_cycles[idx]),
            slowdown=float(self.slowdown[idx]),
            utilization=float(self.utilization[idx]),
            energy_pj=float(self.energy_pj[idx]),
            dram_bytes=float(self.dram_bytes[idx]),
            line_reads=float(self.line_reads[idx]),
            pj_per_mac=float(self.pj_per_mac[idx]),
            dram_stall_cycles=float(self.dram_stall_cycles[idx]))


DEFAULT_TILINGS: Tuple[Tuple[Tuple[str, int], ...], ...] = ((),)


def evaluate_lattice(wl: ConvWorkload, dataflows: Sequence[Dataflow],
                     layouts: Sequence[Layout], modes: Sequence[str],
                     cfg: EvalConfig,
                     tilings: Sequence[Tuple[Tuple[str, int], ...]]
                     = DEFAULT_TILINGS) -> LatticeMetrics:
    """Evaluate the full 4-D candidate lattice in vectorized numpy passes.

    Replaces ``len(dataflows) * len(tilings) * len(layouts) * len(modes)``
    scalar ``evaluate`` calls: temporal samples are derived once per
    (dataflow, tiling) — ``Dataflow.sample_table`` memoizes on the tiled
    dataflow — conflict statistics once per (dataflow, tiling, layout,
    *relief*) with every mode mapping to the same read-side relief sharing
    them, the per-(dataflow, tiling) DRAM pipeline terms come from the same
    ``tile_dram_terms`` helper the scalar path calls (the double-buffered
    overlap against each point's compute cycles is one array expression
    mirroring ``exposed_stall_cycles``), and the nest
    timing, reorder overhead and energy rollup are single array expressions
    over the whole lattice, written to mirror the scalar path's float
    operations exactly.  ``tilings`` defaults to the single whole-tensor
    tiling, which reproduces the pre-tile-axis 3-D lattice.
    """
    dataflows = tuple(dataflows)
    tilings = tuple(tuple(t) for t in tilings)
    layouts = tuple(layouts)
    modes = tuple(modes)
    for mode in modes:
        if mode not in READ_RELIEF:
            raise ValueError(f"unknown reorder mode {mode!r}")
    e = cfg.energy
    nd, nt, nl, nm = len(dataflows), len(tilings), len(layouts), len(modes)
    reliefs = tuple(dict.fromkeys(READ_RELIEF[m] for m in modes))

    stats = assess_iact_conflicts_lattice(wl, dataflows, tilings, layouts,
                                          cfg.buffer, reliefs)
    slowdown = np.ones((nd, nt, nl, nm))
    avg_lines = np.zeros((nd, nt, nl, nm))
    for mi, mode in enumerate(modes):
        sd, al = stats[READ_RELIEF[mode]]
        slowdown[:, :, :, mi] = sd
        avg_lines[:, :, :, mi] = al
    traffic_b = np.zeros((nd, nt))          # off-chip bytes incl. spill
    dram_pj = np.zeros((nd, nt))            # e.dram_bytes_pj(traffic_b)
    serial_stall = np.zeros((nd, nt))       # single-buffered exposure
    tile_mem = np.zeros((nd, nt))           # per-tile pipeline terms
    tile_base = np.zeros((nd, nt))
    prologue = np.zeros((nd, nt))
    sb_stall = np.zeros((nd, nt))           # per-tensor sb-subset exposure
    n_tiles = np.ones((nd, nt))
    db_mask = np.zeros((nd, nt), bool)
    for di, df in enumerate(dataflows):
        for ti, tiling in enumerate(tilings):
            df_t = df.with_tiles(tiling) if tiling else df
            terms = tile_dram_terms(wl, df_t, cfg)
            traffic_b[di, ti] = terms.traffic_bytes
            dram_pj[di, ti] = e.dram_bytes_pj(terms.traffic_bytes)
            serial_stall[di, ti] = terms.serial_stall_cycles
            tile_mem[di, ti] = terms.tile_mem_cycles
            tile_base[di, ti] = terms.tile_base_cycles
            prologue[di, ti] = terms.prologue_cycles
            sb_stall[di, ti] = terms.sb_stall_cycles
            n_tiles[di, ti] = terms.n_tiles
            db_mask[di, ti] = terms.double_buffer

    # nest timing (``nest_cycles`` in array form over the slowdown axis);
    # the tile axis does not move the steady/utilization terms
    macs = wl.macs()
    terms = [nest_cycle_terms(cfg.nest, wl, df) for df in dataflows]
    steady = np.array([t[0] for t in terms])                   # (D,)
    util_theo = np.array([t[3] for t in terms])
    fill = cfg.nest.ah
    load = cfg.nest.ah ** 2
    compute = (steady[:, None, None, None] + fill) * slowdown + load
    util = util_theo[:, None, None, None] / slowdown

    # ``exposed_stall_cycles`` in array form: the double-buffered overlap
    # depends on the point's compute cycles, so the stall is a true 4-D
    # quantity; the op order mirrors the scalar helper exactly
    per_tile_compute = compute / n_tiles[:, :, None, None]
    hidden = np.maximum(tile_base[:, :, None, None], per_tile_compute)
    steady_stall = np.maximum(0.0, tile_mem[:, :, None, None] - hidden)
    pipe_stall = sb_stall[:, :, None, None] + prologue[:, :, None, None] \
        + (n_tiles - 1.0)[:, :, None, None] * steady_stall
    dram_stall = np.where(db_mask[:, :, None, None], pipe_stall,
                          serial_stall[:, :, None, None])

    oact_words = math.prod(wl.oact_dims().values())
    oact_lines = max(1.0, oact_words / cfg.buffer.line_size)

    active = np.maximum(1.0, compute - load)
    line_reads = avg_lines * active                            # iActs
    line_reads = line_reads + active                           # StrB stream

    # ``reorder_overhead`` per mode: only the off-chip overlap term varies
    # across the lattice, everything else is the standalone-pass constant
    ro_cycles = np.zeros((nd, nt, nl, nm))
    ro_energy = np.zeros(nm)
    ro_dram = np.zeros(nm)
    ro_reads = np.zeros(nm)
    ro_writes = np.zeros(nm)
    for mi, mode in enumerate(modes):
        ro = reorder_overhead(wl, cfg, mode, 0.0)
        ro_energy[mi] = ro.energy_pj
        ro_dram[mi] = ro.dram_bytes
        ro_reads[mi] = ro.line_reads
        ro_writes[mi] = ro.line_writes
        if mode == "offchip":
            # ro.cycles at compute_cycles=0.0 IS the full round-trip latency;
            # expose only the part the lattice point's compute can't hide
            ro_cycles[:, :, :, mi] = np.maximum(
                0.0, ro.cycles - 0.9 * compute[:, :, :, mi])
        else:
            ro_cycles[:, :, :, mi] = ro.cycles

    line_reads = line_reads + ro_reads[None, None, None, :]
    line_writes = np.broadcast_to(
        (oact_lines + ro_writes)[None, None, None, :], (nd, nt, nl, nm))
    dram_bytes = np.broadcast_to(
        traffic_b[:, :, None, None] + ro_dram[None, None, None, :],
        (nd, nt, nl, nm))

    energy = (
        macs * (e.mac_pj + 2 * e.reg_access_pj)
        + line_reads * e.sram_line_read_pj
        + line_writes * e.sram_line_write_pj
        + dram_pj[:, :, None, None]
        + ro_energy[None, None, None, :]
    )
    cycles = compute + ro_cycles + dram_stall
    return LatticeMetrics(
        workload=wl, dataflows=dataflows, tilings=tilings, layouts=layouts,
        modes=modes, cycles=cycles, compute_cycles=compute,
        reorder_cycles=ro_cycles, slowdown=slowdown, utilization=util,
        energy_pj=energy, dram_bytes=dram_bytes, line_reads=line_reads,
        pj_per_mac=energy / max(macs, 1),
        dram_stall_cycles=dram_stall)


@dataclasses.dataclass(frozen=True)
class SearchResult:
    workload: ConvWorkload
    dataflow: Dataflow
    layout: Layout
    metrics: Metrics


def cosearch_layer(wl: ConvWorkload, cfg: EvalConfig,
                   layouts: Optional[Sequence[Layout]] = None,
                   dataflows: Optional[Iterable[Dataflow]] = None,
                   layout_fixed: Optional[Layout] = None,
                   objective: str = "edp",
                   tilings: Sequence[Tuple[Tuple[str, int], ...]]
                   = DEFAULT_TILINGS) -> SearchResult:
    """Exhaustive layout x pruned dataflow (x tiling) co-search for one layer
    (paper §VI-A2).

    One ``evaluate_lattice`` pass + an argmin; the flatten order (layouts
    outer, dataflows next, tilings innermost) preserves the scalar loop's
    first-wins tie-break.
    """
    layouts = [layout_fixed] if layout_fixed is not None else \
        list(layouts or conv_layout_space())
    pes = cfg.nest.aw * cfg.nest.ah
    dfs = list(dataflows) if dataflows is not None else \
        list(enumerate_dataflows(wl, pes))
    tilings = tuple(tilings)
    lat = evaluate_lattice(wl, dfs, layouts, (cfg.reorder,), cfg,
                           tilings=tilings)
    key = lat.key("edp" if objective == "edp" else "cycles")[:, :, :, 0]
    flat = int(np.argmin(np.moveaxis(key, 2, 0).reshape(-1)))
    li, rest = divmod(flat, len(dfs) * len(tilings))
    di, ti = divmod(rest, len(tilings))
    return SearchResult(wl, lat.point_dataflow(di, ti), layouts[li],
                        lat.metrics(di, ti, li, 0))


def network_eval(layers: Sequence[ConvWorkload], cfg: EvalConfig,
                 per_layer_layout: bool, **kw) -> List[SearchResult]:
    """Evaluate a whole network; with ``per_layer_layout=False`` a single layout
    (the best single choice across layers) is used everywhere — the fixed-layout
    baseline; with True, each layer co-switches (FEATHER)."""
    if per_layer_layout:
        return [cosearch_layer(l, cfg, **kw) for l in layers]
    layouts = list(kw.pop("layouts", conv_layout_space()))
    objective = kw.pop("objective", "edp")
    dataflows = kw.pop("dataflows", None)
    if kw:
        raise TypeError(f"unexpected network_eval options {sorted(kw)}")
    # one lattice per layer over every layout, then a per-layout reduction
    pes = cfg.nest.aw * cfg.nest.ah
    per_layer: List[Tuple[List[Dataflow], LatticeMetrics]] = []
    for wl in layers:
        dfs = list(dataflows) if dataflows is not None else \
            list(enumerate_dataflows(wl, pes))
        per_layer.append((dfs, evaluate_lattice(wl, dfs, layouts,
                                                (cfg.reorder,), cfg)))
    best_total, best_results = None, None
    for li, lay in enumerate(layouts):
        res = []
        for wl, (dfs, lat) in zip(layers, per_layer):
            keys = lat.key("edp" if objective == "edp"
                           else "cycles")[:, 0, li, 0]
            di = int(np.argmin(keys))
            res.append(SearchResult(wl, dfs[di], lay,
                                    lat.metrics(di, 0, li, 0)))
        total = sum(r.metrics.edp for r in res)
        if best_total is None or total < best_total:
            best_total, best_results = total, res
    assert best_results is not None
    return best_results
