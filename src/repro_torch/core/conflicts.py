"""Bank-conflict assessment: the concordance test (paper §II-C, §V-B).

A (dataflow, layout) pair is *concordant* when every per-cycle spatial access
footprint touches at most ``ports`` lines per bank; otherwise the pair is
*discordant* and each cycle is stretched by ``max(N_L / N_P, 1)``.

Two entry points share the same math:

* ``assess_iact_conflicts``      — one (dataflow, layout, relief) point; the
  scalar oracle the batched path is verified against.
* ``assess_iact_conflicts_grid`` — one dataflow against MANY layouts x relief
  modes at once.  The iAct coordinate grid is computed once per (wl, df) and
  the per-sample ``np.unique`` of the scalar path is replaced by one sort +
  bincount over stacked ``(sample, wire)`` arrays, which is what makes
  lattice-wide sweeps (``layoutloop.evaluate_lattice``) cheap.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .dataflow import ConvWorkload, Dataflow
from .layout import Buffer, Layout


@dataclasses.dataclass(frozen=True)
class ConflictReport:
    slowdown: float            # average per-cycle stretch, >= 1.0
    worst_slowdown: float
    avg_lines_per_cycle: float # distinct buffer lines touched per cycle
    concordant: bool

    def practical_utilization(self, theoretical: float) -> float:
        return theoretical / self.slowdown


def _spatial_offsets(wl: ConvWorkload, df: Dataflow
                     ) -> Tuple[Dict[str, np.ndarray], int]:
    """Per-dim spatial offset arrays (repeated spatial entries on the same dim
    accumulate, as in ``Dataflow.spatial_footprint``) + footprint size."""
    dims = wl.dims()
    axes = [d for d, _ in df.spatial]
    ranges = [np.arange(min(f, dims[d])) for d, f in df.spatial]
    if ranges:
        grids = np.meshgrid(*ranges, indexing="ij")
        offs: Dict[str, np.ndarray] = {}
        for d, g in zip(axes, grids):
            offs[d] = offs.get(d, 0) + g.reshape(-1)
    else:
        offs = {}
    footprint = next(iter(offs.values())).size if offs else 1
    return offs, footprint


def _transposed(layout: Layout) -> Layout:
    """Transposed orientation: lines<->offsets swap; a footprint confined to
    few offsets reads few "columns" instead."""
    return Layout(inter=tuple(d for d, _ in layout.intra) or layout.inter,
                  intra=tuple((d, 1) for d in layout.inter))


def assess_iact_conflicts(wl: ConvWorkload, df: Dataflow, layout: Layout,
                          buffer: Buffer, max_samples: int = 16,
                          reorder: str = "none") -> ConflictReport:
    """Average the paper's per-bank slowdown over sampled cycles.

    ``reorder`` models the *read-side* relief each on-chip reorder pattern
    provides (paper Fig. 5):
      - "none"          : raw conflicts
      - "line_rotation" : one conflicting line per bank may be served from a
                          neighbour bank's spare port (Medusa) -> N_L - 1
      - "transpose"     : column access of a bank is as cheap as row access;
                          conflicts count against the transposed layout too and
                          the better orientation wins (MTIA / TPUv4)
      - "row_reorder"   : data may be permuted within a line; does not reduce
                          the number of lines accessed (TPUv4) -> no relief
      - "arbitrary"     : full relayout available (FEATHER w/ RIR): concordant
                          by construction -> slowdown 1
    """
    if reorder == "arbitrary":
        return ConflictReport(1.0, 1.0, 1.0, True)

    iact_dims = wl.iact_dims()
    offs, footprint = _spatial_offsets(wl, df)

    def loop_val(base: Dict[str, int], d: str):
        return base.get(d, 0) + offs.get(d, 0)

    def sample_lines(lay: Layout, base: Dict[str, int]) -> np.ndarray:
        coords = {
            "N": np.broadcast_to(np.asarray(loop_val(base, "N")), (footprint,)),
            "C": np.broadcast_to(np.asarray(loop_val(base, "C")), (footprint,)),
            "H": np.broadcast_to(np.asarray(
                loop_val(base, "P") * wl.stride + loop_val(base, "R")),
                (footprint,)),
            "W": np.broadcast_to(np.asarray(
                loop_val(base, "Q") * wl.stride + loop_val(base, "S")),
                (footprint,)),
        }
        return np.unique(lay.lines_array(coords, iact_dims))

    def bank_slowdown(lines: np.ndarray, relief: str) -> float:
        banks = lines // buffer.conflict_depth
        counts = np.unique(banks, return_counts=True)[1]
        if relief == "line_rotation":
            counts = np.maximum(1, counts - 1)
        if counts.size == 0:
            return 1.0
        return max(float(counts.max()) / buffer.ports, 1.0)

    t_layout = _transposed(layout) if reorder == "transpose" else None

    slowdowns, line_counts = [], []
    for base in df.sample_table(wl, max_samples):
        lines = sample_lines(layout, base)
        sd = bank_slowdown(lines, reorder)
        if t_layout is not None:
            sd = min(sd, bank_slowdown(sample_lines(t_layout, base), "none"))
        slowdowns.append(sd)
        line_counts.append(lines.size)
    avg_sd = sum(slowdowns) / len(slowdowns) if slowdowns else 1.0
    worst = max(slowdowns, default=1.0)
    avg_lines = sum(line_counts) / len(line_counts) if line_counts else 0.0
    return ConflictReport(avg_sd, worst, avg_lines, worst <= 1.0)


# ------------------------------------------------------------- batched variant
def iact_coord_grid(wl: ConvWorkload, df: Dataflow, max_samples: int = 16
                    ) -> Dict[str, np.ndarray]:
    """(samples, wires) iAct coordinate arrays for one ``(wl, df)``.

    Layout- and relief-independent: every candidate in a lattice sweep shares
    this grid, so the temporal samples and the spatial footprint are derived
    exactly once per dataflow.
    """
    offs, footprint = _spatial_offsets(wl, df)
    bases = df.sample_table(wl, max_samples)
    n = len(bases)

    def lv(d: str) -> np.ndarray:   # (S, 1) base + (1, F) offset, broadcast
        base = np.asarray([b.get(d, 0) for b in bases], np.int64)[:, None]
        return base + np.asarray(offs.get(d, 0), np.int64).reshape(1, -1)

    return {
        "N": np.broadcast_to(lv("N"), (n, footprint)),
        "C": np.broadcast_to(lv("C"), (n, footprint)),
        "H": np.broadcast_to(lv("P") * wl.stride + lv("R"), (n, footprint)),
        "W": np.broadcast_to(lv("Q") * wl.stride + lv("S"), (n, footprint)),
    }


def _per_sample_bank_stats(lines: np.ndarray, buffer: Buffer
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-sample (distinct-line count, slowdown, line-rotation slowdown).

    Replaces the scalar path's per-sample ``np.unique`` with one sort along
    the wire axis: a line's first occurrence marks a distinct line, a bank's
    first occurrence opens a dense per-sample bank rank, and a single
    ``bincount`` over ``sample * F + rank`` yields every bank's distinct-line
    count at once.
    """
    sl = np.sort(lines, axis=1)
    n, f = sl.shape
    new_line = np.ones((n, f), bool)
    new_bank = np.ones((n, f), bool)
    if f > 1:
        new_line[:, 1:] = sl[:, 1:] != sl[:, :-1]
        banks = sl // buffer.conflict_depth
        new_bank[:, 1:] = banks[:, 1:] != banks[:, :-1]
    distinct = new_line.sum(axis=1)
    rank = np.cumsum(new_bank, axis=1) - 1          # dense bank rank per row
    flat = (np.arange(n)[:, None] * f + rank)[new_line]
    counts = np.bincount(flat, minlength=n * f).reshape(n, f)
    sd = np.maximum(counts.max(axis=1) / buffer.ports, 1.0)
    rot = np.where(counts > 0, np.maximum(1, counts - 1), 0)
    sd_rot = np.maximum(rot.max(axis=1) / buffer.ports, 1.0)
    return distinct, sd, sd_rot


def assess_iact_conflicts_grid(wl: ConvWorkload, df: Dataflow,
                               layouts: Sequence[Layout], buffer: Buffer,
                               reliefs: Sequence[str], max_samples: int = 16
                               ) -> Dict[str, List[ConflictReport]]:
    """Concordance test for one dataflow against ``layouts`` x ``reliefs``.

    Returns ``{relief: [report per layout]}`` with every report numerically
    identical to the scalar ``assess_iact_conflicts`` call it replaces (the
    per-sample slowdowns are reduced with the same Python-float summation).
    """
    reliefs = tuple(reliefs)
    out: Dict[str, List[ConflictReport]] = {r: [] for r in reliefs}
    lines_needed = any(r != "arbitrary" for r in reliefs)
    if lines_needed:
        coords = iact_coord_grid(wl, df, max_samples)
        iact_dims = wl.iact_dims()
    for lay in layouts:
        stats = None
        for r in reliefs:
            if r == "arbitrary":
                out[r].append(ConflictReport(1.0, 1.0, 1.0, True))
                continue
            if stats is None:
                stats = _per_sample_bank_stats(
                    lay.lines_array(coords, iact_dims), buffer)
            distinct, sd_none, sd_rot = stats
            if r == "none" or r == "row_reorder":
                sd = sd_none
            elif r == "line_rotation":
                sd = sd_rot
            elif r == "transpose":
                _, sd_t, _ = _per_sample_bank_stats(
                    _transposed(lay).lines_array(coords, iact_dims), buffer)
                sd = np.minimum(sd_none, sd_t)
            else:
                raise ValueError(f"unknown reorder relief {r!r}")
            sds = sd.tolist()                     # Python floats: the scalar
            cnts = distinct.tolist()              # path's summation order
            worst = max(sds)
            out[r].append(ConflictReport(
                sum(sds) / len(sds), worst,
                sum(cnts) / len(cnts), worst <= 1.0))
    return out


def assess_iact_conflicts_lattice(wl: ConvWorkload,
                                  dataflows: Sequence[Dataflow],
                                  tilings: Sequence[Tuple[Tuple[str, int],
                                                          ...]],
                                  layouts: Sequence[Layout], buffer: Buffer,
                                  reliefs: Sequence[str],
                                  max_samples: int = 16
                                  ) -> Dict[str, Tuple[np.ndarray,
                                                       np.ndarray]]:
    """Concordance statistics over a (dataflow x tiling x layout) lattice.

    Returns ``{relief: (slowdown, avg_lines)}`` with both arrays indexed
    ``[dataflow, tiling, layout]``.  Each (dataflow, tiling) column is one
    ``assess_iact_conflicts_grid`` pass over a *tiled* dataflow — the tiling
    confines the temporal sample bases (``Dataflow.temporal_samples``), so
    its conflict profile genuinely differs from the untiled one — and every
    cell is numerically identical to the scalar ``assess_iact_conflicts``
    call on ``df.with_tiles(tiling)``.

    Ping-pong tilings (the ``PING_PONG``-tagged twins ``enumerate_tilings``
    emits) change the capacity/overlap model but not the access pattern, so
    a tagged and an untagged tiling with the same extents share one grid
    pass — the double-buffer axis costs the conflict sweep nothing.
    """
    reliefs = tuple(reliefs)
    nd, nt, nl = len(dataflows), len(tilings), len(layouts)
    out = {r: (np.ones((nd, nt, nl)), np.zeros((nd, nt, nl)))
           for r in reliefs}
    grids: Dict[Dataflow, Dict[str, List[ConflictReport]]] = {}
    for di, df in enumerate(dataflows):
        for ti, tiling in enumerate(tilings):
            df_t = df.with_tiles(tiling) if tiling else df
            df_key = dataclasses.replace(df_t, double_buffer=False)
            grid = grids.get(df_key)
            if grid is None:
                grid = assess_iact_conflicts_grid(wl, df_key, layouts,
                                                  buffer, reliefs,
                                                  max_samples)
                grids[df_key] = grid
            for r in reliefs:
                sd, al = out[r]
                for li, rep in enumerate(grid[r]):
                    sd[di, ti, li] = rep.slowdown
                    al[di, ti, li] = rep.avg_lines_per_cycle
    return out


def concordant(wl: ConvWorkload, df: Dataflow, layout: Layout,
               buffer: Buffer) -> bool:
    return assess_iact_conflicts(wl, df, layout, buffer).concordant
