"""Dataflow descriptors: Tiling / Ordering / Parallelism / Shape (paper §II-A, Fig. 1).

A dataflow is a transformed loop nest over the 7 convolution dims
``N, M, C, P, Q, R, S`` (iActs are indexed by ``H = P*stride + R``,
``W = Q*stride + S``) or the 3 GEMM dims ``M, N, K``.

* ``spatial``  — (dim, factor) pairs unrolled over the PE array       (P, S of TOPS)
* ``order``    — temporal loop order, outermost first                 (O)
* ``tiles``    — per-dim on-chip tile sizes                           (T)
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import math
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

CONV_DIMS = ("N", "M", "C", "P", "Q", "R", "S")
GEMM_DIMS = ("M", "N", "K")

# Pseudo-dim tag a tiling tuple may carry to mark a ping-pong (double-
# buffered) tiling: ``Dataflow.with_tiles`` strips it into the
# ``double_buffer`` field, so ``Dataflow.tiles`` itself only ever holds real
# workload dims.  Lattice tile axes (``enumerate_tilings`` output) use the
# tagged tuples directly — a tagged and an untagged tiling with the same
# extents are distinct search points with different cost/capacity models.
PING_PONG = "2B"

# The three on-chip tensors a buffer allocation names, canonical order.
# A *per-tensor* allocation double-buffers a proper subset of them: each
# tensor in the subset gets a ping-pong pair (2x its tile footprint), the
# rest stay single-buffered at 1x.  The uniform PING_PONG tag is the
# all-three point and keeps its PR 5 capacity/2 semantics bit-for-bit.
BUFFER_TENSORS = ("iact", "w", "oact")


def ping_pong_tag(tensor: str) -> str:
    """Pseudo-dim tag marking ``tensor`` as individually double-buffered."""
    assert tensor in BUFFER_TENSORS, tensor
    return f"{PING_PONG}:{tensor}"


def _is_ping_pong_tag(dim: str) -> bool:
    return dim == PING_PONG or dim.startswith(PING_PONG + ":")


@dataclasses.dataclass(frozen=True)
class ConvWorkload:
    """One convolution layer (paper Fig. 1 terminology)."""

    N: int = 1
    M: int = 1
    C: int = 1
    P: int = 1
    Q: int = 1
    R: int = 1
    S: int = 1
    stride: int = 1
    name: str = "conv"

    @property
    def H(self) -> int:
        return (self.P - 1) * self.stride + self.R

    @property
    def W(self) -> int:
        return (self.Q - 1) * self.stride + self.S

    def dims(self) -> Dict[str, int]:
        return {d: getattr(self, d) for d in CONV_DIMS}

    def macs(self) -> int:
        return self.N * self.M * self.C * self.P * self.Q * self.R * self.S

    def iact_dims(self) -> Dict[str, int]:
        return {"N": self.N, "C": self.C, "H": self.H, "W": self.W}

    def weight_dims(self) -> Dict[str, int]:
        return {"M": self.M, "C": self.C, "R": self.R, "S": self.S}

    def oact_dims(self) -> Dict[str, int]:
        return {"N": self.N, "M": self.M, "P": self.P, "Q": self.Q}

    def iact_coord(self, loop: Mapping[str, int]) -> Dict[str, int]:
        return {
            "N": loop.get("N", 0),
            "C": loop.get("C", 0),
            "H": loop.get("P", 0) * self.stride + loop.get("R", 0),
            "W": loop.get("Q", 0) * self.stride + loop.get("S", 0),
        }

    def oact_coord(self, loop: Mapping[str, int]) -> Dict[str, int]:
        return {"N": loop.get("N", 0), "M": loop.get("M", 0),
                "P": loop.get("P", 0), "Q": loop.get("Q", 0)}

    @staticmethod
    def from_gemm(M: int, N: int, K: int, name: str = "gemm") -> "ConvWorkload":
        """GEMM == 1x1 conv: out[M, N] = sum_K  W[M, K] @ in[K, N]."""
        return ConvWorkload(N=1, M=M, C=K, P=N, Q=1, R=1, S=1, name=name)


@dataclasses.dataclass(frozen=True)
class Dataflow:
    """A TOPS point: spatial unrolling + temporal order (+ optional tiling)."""

    spatial: Tuple[Tuple[str, int], ...]          # (dim, factor), product <= #PE
    order: Tuple[str, ...] = CONV_DIMS            # temporal order, outer->inner
    tiles: Tuple[Tuple[str, int], ...] = ()       # on-chip tile sizes (T)
    name: str = ""
    double_buffer: bool = False   # ping-pong tile buffers: refetch overlaps
    # compute (half the buffer holds the live tile, half the next fetch)
    buffer_alloc: Tuple[str, ...] = ()   # per-tensor allocation: the proper
    # subset of BUFFER_TENSORS that is individually double-buffered; () with
    # double_buffer=False is fully single-buffered, double_buffer=True is the
    # uniform all-three ping-pong (buffer_alloc stays empty there)

    def spatial_product(self) -> int:
        return math.prod(f for _, f in self.spatial) if self.spatial else 1

    def spatial_factors(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for d, f in self.spatial:
            out[d] = out.get(d, 1) * f
        return out

    def label(self) -> str:
        if self.name:
            return self.name
        lbl = "|".join(f"{d}{f}" for d, f in self.spatial)
        if self.tiles:
            lbl += "@" + "".join(f"{d}{t}" for d, t in self.tiles)
        if self.double_buffer:
            lbl += f"@{PING_PONG}"
        elif self.buffer_alloc:
            lbl += f"@{PING_PONG}:" + "+".join(self.buffer_alloc)
        return lbl

    def db_tensors(self) -> frozenset:
        """The set of tensors whose tiles are ping-pong (double) buffered."""
        if self.double_buffer:
            return frozenset(BUFFER_TENSORS)
        return frozenset(self.buffer_alloc)

    def with_tiles(self, tiles: Sequence[Tuple[str, int]]) -> "Dataflow":
        """The same TOPS point with on-chip tile sizes ``tiles`` (a searched
        coordinate: distinct tilings are distinct lattice points).

        A ``(PING_PONG, 1)`` entry in ``tiles`` marks the uniform ping-pong
        variant of the tiling; per-tensor ``(ping_pong_tag(t), 1)`` entries
        mark tensor ``t`` as individually double-buffered.  All tags are
        stripped into ``double_buffer`` / ``buffer_alloc`` so the stored
        ``tiles`` only ever name real workload dims.  Tagging all three
        tensors normalizes to the uniform ping-pong point.
        """
        tiles = tuple(tiles)
        tags = {d for d, _ in tiles if _is_ping_pong_tag(d)}
        alloc = tuple(t for t in BUFFER_TENSORS if ping_pong_tag(t) in tags)
        db = PING_PONG in tags or len(alloc) == len(BUFFER_TENSORS)
        return dataclasses.replace(
            self,
            tiles=tuple((d, f) for d, f in tiles if not _is_ping_pong_tag(d)),
            double_buffer=db, buffer_alloc=() if db else alloc)

    # --------------------------------------------------------------- analysis
    def theoretical_utilization(self, wl: ConvWorkload, num_pes: int) -> float:
        """Mapping efficiency over the array: divisibility loss x occupancy."""
        util = min(1.0, self.spatial_product() / num_pes) if num_pes else 1.0
        dims = wl.dims()
        for d, f in self.spatial_factors().items():
            size = dims[d]
            used = min(size, f)
            eff = size / (math.ceil(size / used) * used)
            util *= eff * used / f if f > used else eff
        return util

    def spatial_footprint(self, wl: ConvWorkload,
                          base: Mapping[str, int] | None = None
                          ) -> Iterator[Dict[str, int]]:
        """All loop points touched in one cycle (the spatial unroll), offset
        from temporal position ``base``."""
        base = dict(base or {})
        dims = wl.dims()
        axes, ranges = [], []
        for d, f in self.spatial:
            axes.append(d)
            ranges.append(range(min(f, dims[d])))
        for combo in itertools.product(*ranges):
            pt = dict(base)
            for d, v in zip(axes, combo):
                pt[d] = pt.get(d, 0) + v
            yield pt

    def sample_table(self, wl: ConvWorkload, max_samples: int = 16
                     ) -> Tuple[Dict[str, int], ...]:
        """Materialized ``temporal_samples``, memoized per ``(wl, df)``.

        The sample bases depend only on the workload and the dataflow — NOT
        on the layout or reorder mode — so every (layout, mode) candidate in
        a lattice sweep shares one table.  Callers must not mutate the dicts.
        """
        return _sample_table(self, wl, max_samples)

    def temporal_samples(self, wl: ConvWorkload, max_samples: int = 16
                         ) -> Iterator[Dict[str, int]]:
        """Sample temporal base points (tile origins) for conflict averaging.

        With ``tiles`` set, the temporal sweep is confined to one on-chip
        tile: bases wrap at the (clamped) tile extent instead of the full
        dim, so a tiling that keeps the footprint inside few lines shows up
        as fewer conflicts.  The default (empty) tiling reproduces the
        untiled sweep exactly.
        """
        ext = tile_extents(wl, self)
        sf = self.spatial_factors()
        # iterate innermost temporal dims first for representative samples
        inner = [d for d in reversed(self.order) if ext[d] > sf.get(d, 1)]
        count = 0
        steps = [0] * len(inner)
        while count < max_samples:
            base = {}
            for d, s in zip(inner, steps):
                base[d] = (s * sf.get(d, 1)) % max(1, ext[d])
            yield base
            count += 1
            # odometer increment over inner dims
            for i in range(len(inner)):
                steps[i] += 1
                limit = max(1, math.ceil(ext[inner[i]] / sf.get(inner[i], 1)))
                if steps[i] < limit:
                    break
                steps[i] = 0
            else:
                break
            if not inner:
                break


@functools.lru_cache(maxsize=4096)
def _sample_table(df: "Dataflow", wl: ConvWorkload, max_samples: int
                  ) -> Tuple[Dict[str, int], ...]:
    return tuple(df.temporal_samples(wl, max_samples))


# ------------------------------------------------------------------- tilings
def tile_extents(wl: ConvWorkload, df: Dataflow) -> Dict[str, int]:
    """Effective per-dim on-chip tile sizes for ``(wl, df)``.

    A declared tile is clamped into ``[spatial factor, dim]``: the spatial
    unrolling must fit inside one tile, and a tile never exceeds the dim.
    Dims without a declared tile (and the default empty tiling) keep the
    whole extent on chip — the pre-tiling status quo.
    """
    dims = wl.dims()
    sf = df.spatial_factors()
    declared = dict(df.tiles)
    out: Dict[str, int] = {}
    for d, size in dims.items():
        want = declared.get(d, size)
        out[d] = max(min(size, want), min(size, sf.get(d, 1)))
    return out


def tile_footprint_split(wl: ConvWorkload,
                         extents: Mapping[str, int]) -> Dict[str, int]:
    """Per-tensor on-chip words one tile occupies, keyed by BUFFER_TENSORS."""
    t = extents
    h = (t["P"] - 1) * wl.stride + t["R"]
    w = (t["Q"] - 1) * wl.stride + t["S"]
    return {"iact": t["N"] * t["C"] * h * w,
            "w": t["M"] * t["C"] * t["R"] * t["S"],
            "oact": t["N"] * t["M"] * t["P"] * t["Q"]}


def tile_working_set(wl: ConvWorkload, extents: Mapping[str, int]) -> int:
    """On-chip words one tile of each tensor occupies simultaneously."""
    fp = tile_footprint_split(wl, extents)
    return fp["iact"] + fp["w"] + fp["oact"]


def alloc_working_set(wl: ConvWorkload, extents: Mapping[str, int],
                      db_tensors: frozenset) -> int:
    """Buffer words a per-tensor allocation claims: double-buffered tensors
    hold a ping-pong pair (2x their tile), the rest a single tile."""
    fp = tile_footprint_split(wl, extents)
    return sum(fp[t] * (2 if t in db_tensors else 1) for t in BUFFER_TENSORS)


def tile_traffic_split(wl: ConvWorkload,
                       extents: Mapping[str, int]) -> Dict[str, int]:
    """Per-tensor off-chip words moved for the whole layer under a tiling,
    keyed by BUFFER_TENSORS (see ``tile_traffic_words`` for the model)."""
    dims = wl.dims()
    n = {d: math.ceil(dims[d] / extents[d]) for d in dims}
    iact_words = math.prod(wl.iact_dims().values())
    w_words = math.prod(wl.weight_dims().values())
    oact_words = math.prod(wl.oact_dims().values())
    m_iact = n["M"]                                  # iActs reread per M tile
    m_w = n["N"] * n["P"] * n["Q"]                   # weights per output tile
    m_oact = n["C"] * n["R"] * n["S"]                # partial-sum round trips
    return {"iact": iact_words * m_iact,
            "w": w_words * m_w,
            "oact": oact_words * (2 * m_oact - 1)}


def tensor_words_split(wl: ConvWorkload) -> Dict[str, int]:
    """Whole-tensor words per tensor — the one-pass DRAM stream baseline."""
    return {"iact": math.prod(wl.iact_dims().values()),
            "w": math.prod(wl.weight_dims().values()),
            "oact": math.prod(wl.oact_dims().values())}


def tile_traffic_words(wl: ConvWorkload, extents: Mapping[str, int]) -> float:
    """Off-chip words moved for the whole layer under a tiling.

    Classic tiled-nest reuse accounting (MAESTRO-style): a tensor is
    re-fetched once per outer-tile iteration over every dim it does NOT
    depend on, and partial oAct sums round-trip once per revisit of the
    reduction dims.  The whole-tensor default tiling has every multiplier at
    1 and reduces to one pass over each tensor — today's untiled traffic.
    """
    tr = tile_traffic_split(wl, extents)
    return tr["iact"] + tr["w"] + tr["oact"]


def enumerate_tilings(wl: ConvWorkload, df: Optional[Dataflow],
                      buffer_bytes: int, dtype_bytes: int = 1,
                      tile_dims: Sequence[str] = ("M", "C", "P", "Q"),
                      max_tilings: int = 8, ping_pong: bool = True,
                      per_tensor: bool = False
                      ) -> Iterator[Tuple[Tuple[str, int], ...]]:
    """Pruned on-chip tile-size candidates for one layer.

    Yields the default (whole-tensor) tiling FIRST — searched spaces built
    from this generator therefore always contain the status quo point, so a
    tiled co-search is never worse than the untiled one by construction —
    followed by the *maximal* capacity-feasible power-of-two tilings: a
    tiling is kept only if no other feasible candidate dominates it
    (component-wise ≥ tile sizes ⇒ component-wise ≥ reuse), capped at
    ``max_tilings`` preferring the largest working sets (closest to filling
    the buffer, i.e. most reuse per byte).

    With ``ping_pong`` (the default), a second arm of candidates trades half
    the buffer for ping-pong space: the maximal tilings feasible in
    ``buffer_bytes / 2`` are emitted tagged ``(PING_PONG, 1)`` — the cost
    model (``layoutloop.tile_dram_terms``) charges them half the resident
    capacity but overlaps their refetch traffic with compute.  Each arm is
    capped at ``max_tilings`` independently.

    With ``per_tensor`` additionally set, six more arms cover the proper
    subsets of ``BUFFER_TENSORS``: tilings maximal under the *allocation-
    weighted* working set (double-buffered tensors count twice, the rest
    once) are emitted tagged ``(ping_pong_tag(t), 1)`` per tensor in the
    subset.  Each per-tensor arm is capped at ``max(1, max_tilings // 4)``
    so the lattice grows by a bounded factor.  *Fusion headroom* arms
    follow: tilings maximal in HALF the buffer that keep the reduction
    dims (C; producer side) or M (consumer side) untiled — the single-pass
    shapes whose fused-boundary claim (``layoutloop.fusion_feasible``)
    fits half the buffer, which the capacity-maximal arms above almost
    never do.  Each comes in a plain single-buffered variant and one with
    the two non-fused tensors ping-pong'd so their refetch stays
    pipelined across a fused edge.

    ``df`` (optional) lower-bounds each dim's tile at its spatial unroll
    factor; pass ``None`` for a tile axis shared across many dataflows —
    the cost model clamps per dataflow via ``tile_extents`` anyway.
    """
    yield ()   # the default tiling: everything on chip (status quo)
    dims = wl.dims()
    sf = df.spatial_factors() if df is not None else {}
    cap_words = max(1, buffer_bytes // max(1, dtype_bytes))
    cands: List[List[int]] = []
    tile_dims = tuple(tile_dims)
    for d in tile_dims:
        size = dims[d]
        lo = min(size, max(1, sf.get(d, 1)))
        vals = {size}
        v = 1
        while v < size:
            if v >= lo:
                vals.add(v)
            v *= 2
        cands.append(sorted(vals))
    def ws(combo: Tuple[int, ...],
           db: frozenset = frozenset()) -> int:
        ext = dict(dims)
        ext.update(zip(tile_dims, combo))
        if db:
            return alloc_working_set(wl, ext, db)
        return tile_working_set(wl, ext)

    def maximal_tilings(cap: int, db: frozenset = frozenset(),
                        cands: List[List[int]] = cands,
                        ) -> List[Tuple[Tuple[str, int], ...]]:
        # keep only maximal (Pareto) tilings: larger tiles always mean
        # ≥ reuse, so anything dominated by another feasible tiling is dead
        # weight.  Working set is monotone in every tile size, so a feasible
        # combo is dominated iff bumping some single dim to its next
        # candidate stays feasible — an O(dims) test instead of an
        # O(candidates^2) sweep.
        nxt = [{v: c[i + 1] for i, v in enumerate(c[:-1])} for c in cands]
        maximal: List[Tuple[int, ...]] = []
        for combo in itertools.product(*cands):
            if ws(combo, db) > cap:
                continue
            bumped = (combo[:i] + (nxt[i][v],) + combo[i + 1:]
                      for i, v in enumerate(combo) if v in nxt[i])
            if all(ws(b, db) > cap for b in bumped):
                maximal.append(combo)
        maximal.sort(key=lambda c: (-ws(c, db), c))
        return [tuple((d, v) for d, v in zip(tile_dims, combo)
                      if v < dims[d])
                for combo in maximal[:max_tilings]]

    emitted = {()}
    for tiling in maximal_tilings(cap_words):
        if tiling not in emitted:
            emitted.add(tiling)
            yield tiling
    if not ping_pong:
        return
    for tiling in maximal_tilings(max(1, cap_words // 2)):
        tagged = tiling + ((PING_PONG, 1),)
        if tagged not in emitted:
            emitted.add(tagged)
            yield tagged
    if not per_tensor:
        return
    per_arm = max(1, max_tilings // 4)
    subsets = [("iact",), ("w",), ("oact",),
               ("iact", "w"), ("iact", "oact"), ("w", "oact")]
    for subset in subsets:
        tags = tuple((ping_pong_tag(t), 1) for t in subset)
        for tiling in maximal_tilings(cap_words, frozenset(subset))[:per_arm]:
            tagged = tiling + tags
            if tagged not in emitted:
                emitted.add(tagged)
                yield tagged
    half_cap = max(1, cap_words // 2)
    # fuse-out / fuse-in single-pass headroom: C untiled (producer side,
    # oAct streams out once) or M untiled (consumer side, iAct read once).
    # ``live`` is the tensor pair still hitting DRAM across a fused edge;
    # double-buffering exactly those keeps their refetch pipelined, and the
    # alloc-weighted working set (fused tensor x1, live x2) under half the
    # buffer is precisely the single-pass fused claim
    # (``layoutloop.fusion_feasible``).  Plain single-buffered variants are
    # emitted too — cheaper shapes when the refetch is small anyway.
    for fixed, live in (("C", ("iact", "w")), ("M", ("w", "oact"))):
        if fixed not in tile_dims:
            continue
        cands_f = [([dims[d]] if d == fixed else c)
                   for d, c in zip(tile_dims, cands)]
        for tiling in maximal_tilings(half_cap, cands=cands_f)[:per_arm]:
            if tiling not in emitted:
                emitted.add(tiling)
                yield tiling
        tags = tuple((ping_pong_tag(t), 1) for t in live)
        for tiling in maximal_tilings(half_cap, frozenset(live),
                                      cands=cands_f)[:per_arm]:
            tagged = tiling + tags
            if tagged not in emitted:
                emitted.add(tagged)
                yield tagged


def enumerate_dataflows(wl: ConvWorkload, num_pes: int,
                        max_dims: int = 2,
                        parallel_dims: Sequence[str] = ("M", "C", "P", "Q"),
                        ) -> Iterator[Dataflow]:
    """Generate candidate spatial unrollings for a PE array (pruned TOPS space).

    Factors are powers of two up to the array size; at most ``max_dims`` dims
    are parallelized, mirroring practical accelerator mappings.  Factor-1
    dims are dropped before deduplication so spatially equivalent unrollings
    (e.g. ``M8|C1`` vs ``M8``) are yielded exactly once, in canonical
    (factor-1-free) form.
    """
    pows = [2 ** i for i in range(int(math.log2(num_pes)) + 1)]
    seen = set()
    for k in range(1, max_dims + 1):
        for dims in itertools.combinations(parallel_dims, k):
            for factors in itertools.product(pows, repeat=k):
                if math.prod(factors) != num_pes:
                    continue
                spatial = tuple((d, f) for d, f in zip(dims, factors) if f > 1)
                key = tuple(sorted(spatial))
                if key in seen:
                    continue
                seen.add(key)
                yield Dataflow(spatial=spatial)
