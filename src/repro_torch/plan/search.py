"""Network-level (dataflow, layout) co-search over layer-boundary layouts.

The per-layer ``cosearch_layer`` optimizes each layer in isolation and
ignores that layer L's output layout IS layer L+1's input layout.  Here the
whole network is planned as a shortest path: the DP state is the *boundary
layout* between consecutive layers, per-layer cost comes from
``core.layoutloop.evaluate``, and a boundary where the layout changes is
charged the reorder implementation that realizes the switch
(``none`` / ``offchip`` / RAR variants / ``rir``).  With RIR the switch rides
the producing layer's reduction (paper §II-E2) and costs only BIRRD hop
energy; without it the planner weighs a relayout pass against living with a
discordant (bank-conflicted) layout.

Exactness: on a pure chain, keeping the best path per boundary layout is the
exact Viterbi optimum (validated against brute-force enumeration in
``tests/test_plan.py``).  Residual/branch skip edges couple non-adjacent
boundaries, so the beam keeps several paths per state; the greedy path is
always injected as a candidate, so the planned schedule never loses to
per-layer-greedy under the same total-cost objective.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core.dataflow import (Dataflow, enumerate_dataflows,
                                 enumerate_tilings)
from repro_torch.core.layout import Layout, conv_layout_space
from repro_torch.core.layoutloop import (EvalConfig, LatticeMetrics, Metrics,
                                   evaluate, evaluate_lattice,
                                   exposed_stall_cycles, fusion_feasible,
                                   refused_metrics, reorder_overhead,
                                   tile_dram_terms)
from repro_torch.core.workloads import is_depthwise

from .graph import LayerGraph
from .plan import (RIR_BLOCK, ExecutionPlan, JoinSpec, PlanStep, config_key,
                   layout_block_perm)


@dataclasses.dataclass(frozen=True)
class PlannerOptions:
    """Knobs for the network planner.

    ``objective`` must be additive over layers for the DP to be exact:
    ``cycles`` | ``energy`` | ``edp_sum`` (sum of per-layer EDP).
    ``switch_modes`` are the reorder implementations the hardware offers for
    a layout-changing boundary; ``residual_mode`` relayouts a skip tensor
    whose producing boundary disagrees with its consuming boundary (RIR can
    only write ONE layout per tensor, so skips fall back to a copy pass).
    ``search_tiles`` adds the on-chip tile axis to every layer's lattice
    (``core.dataflow.enumerate_tilings``, at most ``max_tilings``
    capacity-feasible candidates over ``tile_dims``); the default tiling is
    always injected, so the tiled DP never loses to the untiled one.
    ``double_buffer`` additionally enumerates each layer's ping-pong
    tilings — half the buffer traded for overlap of tile refetch with
    compute — as extra lattice points; the single-buffered candidates stay
    in the space, so the double-buffered DP never loses to the
    single-buffered one either.
    ``per_tensor_buffers`` grows the tile axis with per-tensor allocation
    arms (``Dataflow.buffer_alloc``: each of weights/iActs/oActs single- or
    double-buffered independently) plus the fusion-headroom shapes; the
    uniform points stay in the space, so the per-tensor DP never loses to
    the uniform one.  ``fuse_layers`` makes fused layer pairs DP states:
    a path may declare the edge to the next layer *fused* — the boundary
    tensor never touches DRAM (``layoutloop.refused_metrics``) — when both
    sides pass ``layoutloop.fusion_feasible`` and the boundary's reorder is
    on-chip (RIR or identity); the unfused branch is always searched too,
    so the fused DP never loses to the unfused one.
    """

    objective: str = "cycles"
    switch_modes: Tuple[str, ...] = ("rir",)
    residual_mode: str = "offchip"
    beam_width: int = 64
    layouts: Optional[Tuple[Layout, ...]] = None
    dataflows: Optional[Tuple[Dataflow, ...]] = None   # None = enumerate/layer
    max_spatial_dims: int = 2
    # dims eligible for spatial unrolling; drop "M" to model accelerators whose
    # weight-port bandwidth can't feed pure output-channel parallelism (the
    # paper's D1/D2 mappings always co-parallelize an input dim)
    parallel_dims: Tuple[str, ...] = ("M", "C", "P", "Q")
    search_tiles: bool = True
    max_tilings: int = 8
    tile_dims: Tuple[str, ...] = ("M", "C", "P", "Q")
    double_buffer: bool = True
    per_tensor_buffers: bool = True
    fuse_layers: bool = True

    def key(self) -> str:
        return repr(self)


def _metric_key(m: Metrics, objective: str) -> float:
    if objective == "cycles":
        return m.cycles
    if objective == "energy":
        return m.energy_pj
    if objective == "edp_sum":
        return m.edp
    raise ValueError(f"objective {objective!r} is not additive")


def _overhead_key(cycles: float, energy: float, objective: str) -> float:
    if objective == "cycles":
        return cycles
    if objective == "energy":
        return energy
    return energy * cycles  # edp_sum: standalone pass EDP


@dataclasses.dataclass
class _StepChoice:
    """Best execution of one layer given (input layout, output layout).

    ``dataflow`` carries the chosen tiling on ``Dataflow.tiles``; ``tiles``
    repeats it explicitly so plan emission and tests never have to dig.
    """

    dataflow: Dataflow
    metrics: Metrics
    mode: str
    key: float
    tiles: Tuple[Tuple[str, int], ...] = ()
    fused_in: bool = False     # consumes the previous layer's oActs on chip
    fused_out: bool = False    # feeds the next layer without touching DRAM


@dataclasses.dataclass
class _Path:
    key: float
    cycles: float
    energy_pj: float
    transition_cycles: float
    boundaries: Tuple[str, ...]            # layout names, len = layer_idx + 1
    choices: Tuple[_StepChoice, ...]
    fuse_next: bool = False    # the last layer's output edge is fused: the
    # next layer MUST consume it on chip (fused_in), and the path cannot
    # terminate here


class NetworkPlanner:
    """Shared machinery for DP / greedy / brute-force planning.

    Each layer's full (dataflow x layout x mode) cost table is built by one
    ``evaluate_lattice`` pass on first touch (``precompute_tables`` forces
    all of them), so ``layer_cost`` / ``step_choice`` are argmin lookups
    instead of scalar ``evaluate`` sweeps.  Pass ``use_lattice=False`` to
    force the original scalar path — the oracle the table-driven planner is
    asserted byte-identical against.
    """

    def __init__(self, graph: LayerGraph, cfg: EvalConfig,
                 opts: PlannerOptions = PlannerOptions(),
                 use_lattice: bool = True):
        self.graph = graph
        self.cfg = cfg
        self.opts = opts
        self.layouts: Tuple[Layout, ...] = tuple(
            opts.layouts if opts.layouts is not None else conv_layout_space())
        self._by_name: Dict[str, Layout] = {l.name(): l for l in self.layouts}
        pes = cfg.nest.aw * cfg.nest.ah
        if opts.dataflows is not None:
            self._dfs = {i: tuple(opts.dataflows)
                         for i in range(len(graph))}
        else:
            self._dfs = {i: tuple(enumerate_dataflows(
                wl, pes, max_dims=opts.max_spatial_dims,
                parallel_dims=opts.parallel_dims))
                for i, wl in enumerate(graph.layers)}
        # the tile axis: shared across a layer's dataflows (one dense 4-D
        # lattice per layer); entry 0 is always the default whole-tensor
        # tiling, so the untiled plan is a sub-space of the tiled search
        cap_bytes = cfg.buffer.num_lines * cfg.buffer.line_size \
            * cfg.dtype_bytes
        if opts.search_tiles:
            self._tilings = {i: tuple(enumerate_tilings(
                wl, None, cap_bytes, cfg.dtype_bytes,
                tile_dims=opts.tile_dims, max_tilings=opts.max_tilings,
                ping_pong=opts.double_buffer,
                per_tensor=opts.per_tensor_buffers))
                for i, wl in enumerate(graph.layers)}
        else:
            self._tilings = {i: ((),) for i in range(len(graph))}
        self._layer_memo: Dict[Tuple[int, str, str, bool, bool],
                               Optional[Tuple[float, Dataflow, Metrics]]] = {}
        self._skip_memo: Dict[int, Tuple[float, float]] = {}
        # every mode any boundary can engage (step_choice prepends "none")
        self._modes: Tuple[str, ...] = ("none",) + tuple(
            m for m in opts.switch_modes if m != "none")
        self._mode_idx = {m: k for k, m in enumerate(self._modes)}
        self._layout_idx = {l.name(): j for j, l in enumerate(self.layouts)}
        self._use_lattice = use_lattice
        self._tables: Dict[int, LatticeMetrics] = {}
        self._keys: Dict[int, "np.ndarray"] = {}
        # fused-variant key tables per (layer, fused_in, fused_out); the
        # set of layers that may fuse their output edge into the next layer
        self._variant_memo: Dict[Tuple[int, bool, bool], "np.ndarray"] = {}
        self._no_fuse_out = frozenset(graph.buffer_sources()) \
            | {len(graph) - 1}
        if obs.enabled():
            # candidate-count gauges: how big the search space this planner
            # instance sweeps actually is (guarded — the sums are real work)
            n_pts = sum(len(self._dfs[i]) * len(self._tilings[i])
                        for i in range(len(graph)))
            obs.set_gauge("planner.layers", len(graph))
            obs.set_gauge("planner.dataflow_candidates",
                          sum(len(v) for v in self._dfs.values()))
            obs.set_gauge("planner.tiling_candidates",
                          sum(len(v) for v in self._tilings.values()))
            obs.set_gauge("planner.lattice_points",
                          n_pts * len(self.layouts) * len(self._modes))

    def _table(self, i: int) -> LatticeMetrics:
        """Layer ``i``'s cost table, built on first touch (one lattice pass).

        Lazy so table-free consumers — ``fixed`` with a layout outside the
        search space hits only the scalar fallback — pay nothing.
        """
        tab = self._tables.get(i)
        if tab is None:
            with obs.span("planner.lattice") as sp:
                sp.set("layer", i).set("workload", self.graph.layers[i].name)
                tab = evaluate_lattice(self.graph.layers[i], self._dfs[i],
                                       self.layouts, self._modes, self.cfg,
                                       tilings=self._tilings[i])
            obs.inc_counter("planner.lattice_builds")
            self._tables[i] = tab
            self._keys[i] = tab.key(self.opts.objective)
        return tab

    def precompute_tables(self) -> None:
        """Force every layer's cost table (e.g. before timing a search)."""
        if self._use_lattice:
            for i in range(len(self.graph)):
                self._table(i)

    def _variant_keys(self, i: int, fused_in: bool, fused_out: bool
                      ) -> "np.ndarray":
        """Layer ``i``'s objective-key table with the fused boundary's DRAM
        terms elided — the lattice-path twin of ``refused_metrics``.

        Rebuilds only the (dataflow, tile)-indexed stall/energy deltas; the
        conflict/nest arrays are shared with the base table.  Points that
        fail ``fusion_feasible`` (and every off-chip-reorder column when the
        output edge is fused) are +inf, mirroring the scalar path's skips.
        """
        memo = self._variant_memo.get((i, fused_in, fused_out))
        if memo is not None:
            return memo
        tab = self._table(i)
        wl = self.graph.layers[i]
        e = self.cfg.energy
        nd, nt, nl, nm = tab.shape
        serial = np.zeros((nd, nt))
        tile_mem = np.zeros((nd, nt))
        tile_base = np.zeros((nd, nt))
        prologue = np.zeros((nd, nt))
        sb_stall = np.zeros((nd, nt))
        n_tiles = np.ones((nd, nt))
        db_mask = np.zeros((nd, nt), bool)
        dram_pj0 = np.zeros((nd, nt))
        dram_pj1 = np.zeros((nd, nt))
        feasible = np.zeros((nd, nt), bool)
        for di in range(nd):
            for ti in range(nt):
                df_t = tab.point_dataflow(di, ti)
                if not fusion_feasible(wl, df_t, self.cfg,
                                       fused_in=fused_in,
                                       fused_out=fused_out):
                    continue
                feasible[di, ti] = True
                t0 = tile_dram_terms(wl, df_t, self.cfg)
                t1 = tile_dram_terms(wl, df_t, self.cfg,
                                     fused_in=fused_in, fused_out=fused_out)
                serial[di, ti] = t1.serial_stall_cycles
                tile_mem[di, ti] = t1.tile_mem_cycles
                tile_base[di, ti] = t1.tile_base_cycles
                prologue[di, ti] = t1.prologue_cycles
                sb_stall[di, ti] = t1.sb_stall_cycles
                n_tiles[di, ti] = t1.n_tiles
                db_mask[di, ti] = t1.double_buffer
                dram_pj0[di, ti] = e.dram_bytes_pj(t0.traffic_bytes)
                dram_pj1[di, ti] = e.dram_bytes_pj(t1.traffic_bytes)
        # ``exposed_stall_cycles`` in array form against the base compute
        # table — op order mirrors the scalar helper exactly so the chosen
        # point's ``refused_metrics`` reproduce these keys bit-for-bit
        compute = tab.compute_cycles
        per_tile = compute / n_tiles[:, :, None, None]
        hidden = np.maximum(tile_base[:, :, None, None], per_tile)
        steady = np.maximum(0.0, tile_mem[:, :, None, None] - hidden)
        pipe = sb_stall[:, :, None, None] + prologue[:, :, None, None] \
            + (n_tiles - 1.0)[:, :, None, None] * steady
        stall = np.where(db_mask[:, :, None, None], pipe,
                         serial[:, :, None, None])
        cycles = compute + tab.reorder_cycles + stall
        energy = tab.energy_pj - dram_pj0[:, :, None, None] \
            + dram_pj1[:, :, None, None]
        if self.opts.objective == "cycles":
            keys = cycles.copy()
        elif self.opts.objective == "energy":
            keys = energy.copy()
        else:
            keys = energy * cycles
        keys[~feasible] = np.inf
        if fused_out and "offchip" in self._mode_idx:
            keys[:, :, :, self._mode_idx["offchip"]] = np.inf
        self._variant_memo[(i, fused_in, fused_out)] = keys
        return keys

    # ---------------------------------------------------------------- layer cost
    def layer_cost(self, i: int, layout: Layout, mode: str,
                   fused_in: bool = False, fused_out: bool = False
                   ) -> Optional[Tuple[float, Dataflow, Metrics]]:
        """Min-cost (dataflow, tiling) for layer i reading ``layout``,
        reorder ``mode`` — the returned dataflow carries the tiling.

        With a fused boundary (``fused_in`` / ``fused_out``) the cost is the
        fused variant (``refused_metrics``); returns ``None`` when no
        candidate passes the fusion-feasibility check (or the mode is
        off-chip with a fused output, which cannot relayout on chip)."""
        fused = fused_in or fused_out
        if fused_out and mode == "offchip":
            return None
        memo_key = (i, layout.name(), mode, fused_in, fused_out)
        if memo_key in self._layer_memo:
            return self._layer_memo[memo_key]
        j = self._layout_idx.get(layout.name())
        mi = self._mode_idx.get(mode)
        nt = len(self._tilings[i])
        best: Optional[Tuple[float, Dataflow, Metrics]]
        if self._use_lattice and j is not None and mi is not None:
            tab = self._table(i)
            if fused:
                keys = self._variant_keys(i, fused_in, fused_out)[:, :, j, mi]
            else:
                keys = self._keys[i][:, :, j, mi]
            # C-order first-min == the scalar loop's (df outer, tile inner)
            # first-wins tie-break
            di, ti = divmod(int(np.argmin(keys)), nt)
            if not np.isfinite(keys[di, ti]):
                best = None
            else:
                df_t = tab.point_dataflow(di, ti)
                m = tab.metrics(di, ti, j, mi)
                if fused:
                    m = refused_metrics(self.graph.layers[i], df_t, self.cfg,
                                        m, fused_in=fused_in,
                                        fused_out=fused_out)
                best = (float(keys[di, ti]), df_t, m)
        else:
            # scalar fallback: lattice disabled, or a layout outside the
            # search space (``fixed`` with an external baseline layout)
            wl = self.graph.layers[i]
            best = None
            for df in self._dfs[i]:
                for tiling in self._tilings[i]:
                    df_t = df.with_tiles(tiling) if tiling else df
                    if fused and not fusion_feasible(
                            wl, df_t, self.cfg, fused_in=fused_in,
                            fused_out=fused_out):
                        continue
                    m = evaluate(wl, df_t, layout, self.cfg, reorder=mode)
                    if fused:
                        m = refused_metrics(wl, df_t, self.cfg, m,
                                            fused_in=fused_in,
                                            fused_out=fused_out)
                    k = _metric_key(m, self.opts.objective)
                    if best is None or k < best[0]:
                        best = (k, df_t, m)
            assert best is not None or fused, \
                f"no dataflow candidates for layer {i}"
        self._layer_memo[memo_key] = best
        return best

    def step_choice(self, i: int, l_in: Layout, l_out: Layout,
                    fused_in: bool = False, fused_out: bool = False
                    ) -> Optional[_StepChoice]:
        """Best (dataflow, reorder mode) for layer i given both boundaries.

        Identity boundaries may still engage the reorder unit (its read-side
        conflict relief can beat the hop energy); changing boundaries must.
        A fused output boundary can only switch layout on chip, so the
        off-chip mode is excluded there; returns ``None`` when no feasible
        fused execution exists.
        """
        same = l_in.name() == l_out.name()
        modes = (("none",) + self.opts.switch_modes) if same \
            else self.opts.switch_modes
        best: Optional[_StepChoice] = None
        for mode in modes:
            res = self.layer_cost(i, l_in, mode, fused_in=fused_in,
                                  fused_out=fused_out)
            if res is None:
                continue
            k, df, m = res
            if best is None or k < best.key:
                best = _StepChoice(dataflow=df, metrics=m, mode=mode, key=k,
                                   tiles=df.tiles, fused_in=fused_in,
                                   fused_out=fused_out)
        assert best is not None or fused_in or fused_out
        return best

    def skip_penalty(self, src: int) -> Tuple[float, float]:
        """(cycles, energy) to relayout layer ``src``'s skip tensor."""
        hit = self._skip_memo.get(src)
        if hit is None:
            ro = reorder_overhead(self.graph.layers[src], self.cfg,
                                  self.opts.residual_mode, 0.0)
            hit = (ro.cycles, ro.energy_pj)
            self._skip_memo[src] = hit
        return hit

    def skip_shapes_agree(self, src: int, dst: int) -> bool:
        """True when the skip tensor can join ``dst``'s output tile-for-tile.

        Mirrors the executor's fusion condition: a residual add only fuses
        into the consumer's epilogue when the two tensors share (N, P, Q, M);
        otherwise the boundary adapter must run a standalone pass regardless
        of layout agreement, and the planner must charge for it.
        """
        a, b = self.graph.layers[src], self.graph.layers[dst]
        return (a.N, a.P, a.Q, a.M) == (b.N, b.P, b.Q, b.M)

    # ------------------------------------------------------------ path scoring
    def extend(self, path: _Path, layer: int, l_out: Layout,
               fuse_out: bool = False) -> Optional[_Path]:
        """Append layer ``layer`` with output boundary ``l_out``.

        ``fuse_out`` declares the edge to the NEXT layer fused; the path's
        ``fuse_next`` flag forces this layer to consume the previous
        boundary on chip.  Returns ``None`` when no feasible fused
        execution of the layer exists."""
        l_in = self._by_name[path.boundaries[-1]]
        c = self.step_choice(layer, l_in, l_out,
                             fused_in=path.fuse_next, fused_out=fuse_out)
        if c is None:
            return None
        key = path.key + c.key
        cycles = path.cycles + c.metrics.cycles
        energy = path.energy_pj + c.metrics.energy_pj
        trans = path.transition_cycles + c.metrics.reorder_cycles
        for src in self.graph.skips_into(layer):
            # boundary index src+1 carries layers[src]'s output; the skip
            # tensor joins (residual add) at this layer's OUTPUT boundary —
            # the add fuses into the producing epilogue for free only when
            # layouts AND shapes agree; otherwise the tensor pays a
            # relayout/adapter pass (the executor's exact fusion condition)
            if path.boundaries[src + 1] != l_out.name() \
                    or not self.skip_shapes_agree(src, layer):
                pc, pe = self.skip_penalty(src)
                key += _overhead_key(pc, pe, self.opts.objective)
                cycles += pc
                energy += pe
                trans += pc
        return _Path(key=key, cycles=cycles, energy_pj=energy,
                     transition_cycles=trans,
                     boundaries=path.boundaries + (l_out.name(),),
                     choices=path.choices + (c,), fuse_next=fuse_out)

    def score_boundaries(self, boundaries: Sequence[str]) -> _Path:
        """Score a full boundary-layout assignment (len = n_layers + 1),
        unfused — the greedy/fixed/brute-force baselines."""
        assert len(boundaries) == len(self.graph) + 1
        path = _Path(0.0, 0.0, 0.0, 0.0, (boundaries[0],), ())
        for i, b in enumerate(boundaries[1:]):
            nxt = self.extend(path, i, self._by_name[b])
            assert nxt is not None   # unfused extension always exists
            path = nxt
        return path

    def _fuse_options(self, layer: int) -> Tuple[bool, ...]:
        """Whether layer ``layer``'s output edge may be declared fused: never
        for the last layer (its output leaves the chip) or a skip-edge
        source (the tensor is re-consumed later and must be materialized)."""
        if self.opts.fuse_layers and layer not in self._no_fuse_out:
            return (False, True)
        return (False,)

    # ----------------------------------------------------------------- planners
    def plan(self) -> ExecutionPlan:
        """Beam/Viterbi DP over boundary layouts (greedy path injected).

        With tracing on, the three phases land as nested spans —
        ``planner.lattice_build`` (every layer's cost table, forced up
        front), ``planner.dp_extend`` (the beam sweep) and
        ``planner.argmin`` (final selection + greedy injection) — under one
        ``planner.plan`` root carrying the graph provenance.
        """
        with obs.span("planner.plan") as root:
            root.set("graph", self.graph.name) \
                .set("objective", self.opts.objective)
            with obs.span("planner.lattice_build"):
                self.precompute_tables()
            with obs.span("planner.dp_extend"):
                beams: List[_Path] = [
                    _Path(0.0, 0.0, 0.0, 0.0, (l.name(),), ())
                    for l in self.layouts]
                for i in range(len(self.graph)):
                    grown = [g for p in beams for l_out in self.layouts
                             for fo in self._fuse_options(i)
                             if (g := self.extend(p, i, l_out, fo))
                             is not None]
                    grown.sort(key=lambda p: p.key)
                    kept: List[_Path] = []
                    seen_last: Dict[Tuple[str, bool], int] = {}
                    # keep the best few per terminal state, best-first
                    # overall; a fused-pending path is a distinct DP state
                    # (its next layer is constrained), so it gets its own
                    # per-state quota instead of competing with unfused ones
                    per_state = max(1,
                                    self.opts.beam_width // len(self.layouts))
                    for p in grown:
                        last = (p.boundaries[-1], p.fuse_next)
                        if seen_last.get(last, 0) >= per_state:
                            continue
                        seen_last[last] = seen_last.get(last, 0) + 1
                        kept.append(p)
                        if len(kept) >= self.opts.beam_width:
                            break
                    if all(p.fuse_next for p in kept):
                        # a fused-pending path may have no feasible next
                        # layer; never let the beam strand itself
                        kept.append(min((p for p in grown if not p.fuse_next),
                                        key=lambda p: p.key))
                    beams = kept
            with obs.span("planner.argmin"):
                best = min(beams, key=lambda p: p.key)
                greedy = self._greedy_path()
                if greedy.key < best.key:
                    best = greedy
            plan = self._to_plan(best, "network-dp")
            if obs.enabled():   # plan_id hashes; don't compute it when off
                root.set("graph_hash", plan.graph_hash) \
                    .set("plan_id", plan.plan_id) \
                    .set("total_cycles", plan.total_cycles)
        return plan

    def _greedy_boundaries(self) -> List[str]:
        """Each layer picks its locally-best input layout, boundary costs be
        damned — the baseline FEATHER's per-layer co-switching implies."""
        picks: List[str] = []
        for i in range(len(self.graph)):
            best_k, best_l = None, None
            for lay in self.layouts:
                for mode in ("none",) + self.opts.switch_modes:
                    k, _, _ = self.layer_cost(i, lay, mode)
                    if best_k is None or k < best_k:
                        best_k, best_l = k, lay.name()
            picks.append(best_l)
        return picks + [picks[-1]]   # keep the last boundary where it landed

    def _greedy_path(self) -> _Path:
        return self.score_boundaries(self._greedy_boundaries())

    def greedy(self) -> ExecutionPlan:
        return self._to_plan(self._greedy_path(), "greedy")

    def brute_force(self) -> ExecutionPlan:
        """Exhaustive enumeration of boundary assignments (tests/small nets)."""
        names = [l.name() for l in self.layouts]
        best: Optional[_Path] = None
        for combo in itertools.product(names, repeat=len(self.graph) + 1):
            p = self.score_boundaries(combo)
            if best is None or p.key < best.key:
                best = p
        assert best is not None
        return self._to_plan(best, "brute-force")

    def fixed(self, layout: Layout) -> ExecutionPlan:
        """No switching: one layout at every boundary (the baseline layout
        need not be part of the search space)."""
        self._by_name.setdefault(layout.name(), layout)
        names = [layout.name()] * (len(self.graph) + 1)
        return self._to_plan(self.score_boundaries(names), "fixed")

    # ------------------------------------------------------------- plan emission
    def _to_plan(self, path: _Path, planner: str) -> ExecutionPlan:
        steps = []
        for i, (wl, choice) in enumerate(zip(self.graph.layers, path.choices)):
            l_in, l_out = path.boundaries[i], path.boundaries[i + 1]
            # every layer lowers to the RIR matmul: GEMM-able layers feed it
            # directly, convolutions through the layout-aware im2col gather
            # (depthwise via the block-diagonal dense form) — no layer falls
            # back to the reference matmul path anymore
            if is_depthwise(wl):
                lowering = "depthwise"
            elif wl.R == 1 and wl.S == 1 and wl.stride == 1:
                lowering = "gemm"
            else:
                lowering = "im2col"
            n_blocks = wl.M // RIR_BLOCK if wl.M % RIR_BLOCK == 0 else 0
            perm = layout_block_perm(l_out, n_blocks) if n_blocks >= 1 else None
            joins = tuple(
                JoinSpec(src=src, src_layout=path.boundaries[src + 1],
                         relayout=("none"
                                   if path.boundaries[src + 1] == l_out
                                   and self.skip_shapes_agree(src, i)
                                   else self.opts.residual_mode))
                for src in self.graph.skips_into(i))
            steps.append(PlanStep(
                layer=wl.name, workload=wl, dataflow=choice.dataflow,
                in_layout=l_in, out_layout=l_out, reorder=choice.mode,
                kernel="rir_matmul", epilogue_perm=perm, lowering=lowering,
                joins=joins, cycles=choice.metrics.cycles,
                energy_pj=choice.metrics.energy_pj, tiles=choice.tiles,
                double_buffer=choice.dataflow.double_buffer,
                buffer_alloc=choice.dataflow.buffer_alloc,
                fused_with=(i + 1) if choice.fused_out else None,
                dram_stall_cycles=choice.metrics.dram_stall_cycles))
        return ExecutionPlan(
            graph_name=self.graph.name, graph_hash=self.graph.graph_hash(),
            config_key=config_key(self.cfg, self.opts.key()),
            objective=self.opts.objective, planner=planner,
            steps=tuple(steps), total_cycles=path.cycles,
            total_energy_pj=path.energy_pj,
            transition_cycles=path.transition_cycles)


# ------------------------------------------------------------- module-level API
def plan_network(graph: LayerGraph, cfg: EvalConfig,
                 opts: PlannerOptions = PlannerOptions()) -> ExecutionPlan:
    return NetworkPlanner(graph, cfg, opts).plan()


def greedy_plan(graph: LayerGraph, cfg: EvalConfig,
                opts: PlannerOptions = PlannerOptions()) -> ExecutionPlan:
    return NetworkPlanner(graph, cfg, opts).greedy()


def brute_force_plan(graph: LayerGraph, cfg: EvalConfig,
                     opts: PlannerOptions = PlannerOptions()) -> ExecutionPlan:
    return NetworkPlanner(graph, cfg, opts).brute_force()


def fixed_plan(graph: LayerGraph, cfg: EvalConfig, layout: Layout,
               opts: PlannerOptions = PlannerOptions()) -> ExecutionPlan:
    return NetworkPlanner(graph, cfg, opts).fixed(layout)
