"""BIRRD — Butterfly Interconnect for Reduction and Reordering in Dataflows.

Faithful functional model of the paper's §III-B:

* topology:  2*log2(AW) stages of AW/2 two-input "Egg" switches, wired by the
  bit-reversal connectivity of Alg. 1 (AW=4 is the 3-stage special case);
* Egg configs: PASS, SWAP, ADD_LEFT, ADD_RIGHT (Fig. 8);
* routing: destination-tag backtracking search with constraint propagation, and
  the paper's brute-force fallback (§III-B3);
* simulation: numeric value propagation used to validate routed configurations
  against the RIR semantic spec (``core.rir``).

The production TPU datapath does NOT push words through this switch model —
``kernels/rir_matmul.py`` / ``kernels/birrd_reduce.py`` implement the same
*function* (grouped reduction + arbitrary output reorder in the producer's
epilogue) with MXU/VPU-native operations.  This module is the validator and
the source of the paper's own area/latency claims.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

PASS, SWAP, ADD_LEFT, ADD_RIGHT = 0, 1, 2, 3
CONFIG_NAMES = {PASS: "=", SWAP: "x", ADD_LEFT: "+<", ADD_RIGHT: ">+"}


class _Unroutable(Exception):
    """Raised when a routing strategy fails on a sub-problem."""


class _Budget(Exception):
    """Raised when the path-DFS exceeds its node budget."""


def reverse_bits(data: int, bit_range: int) -> int:
    """Alg. 1 helper: reverse the low ``bit_range`` bits of ``data``."""
    mask = (1 << bit_range) - 1
    rev = 0
    for i in range(bit_range):
        if data & (1 << i):
            rev |= 1 << (bit_range - 1 - i)
    return (data & ~mask) | rev


@dataclasses.dataclass(frozen=True)
class BirrdTopology:
    """Inter-stage wiring of an AW-input BIRRD."""

    aw: int

    def __post_init__(self):
        if self.aw < 2 or self.aw & (self.aw - 1):
            raise ValueError("AW must be a power of two >= 2")

    @property
    def log_aw(self) -> int:
        return int(math.log2(self.aw))

    @property
    def num_stages(self) -> int:
        # 4-input BIRRD merges the two middle stages (paper footnote 1).
        if self.aw == 4:
            return 3
        return 2 * self.log_aw

    @property
    def switches_per_stage(self) -> int:
        return self.aw // 2

    def connection(self, stage: int, port: int) -> int:
        """Input port of ``stage + 1`` fed by output ``port`` of ``stage``.

        Alg. 1: output[i][j] -> input[i+1][reverse_bits(j, bit_range)] with
        bit_range = min(log2(AW), 2 + i, 2*log2(AW) - i).
        """
        n = self.log_aw
        if self.aw == 4:
            # 3-stage special case: two butterflies sharing the middle stage.
            bit_range = 2 if stage < self.num_stages - 1 else 1
        else:
            bit_range = min(n, 2 + stage, 2 * n - stage)
        return reverse_bits(port, max(1, bit_range))

    def permutation(self, stage: int) -> List[int]:
        return [self.connection(stage, j) for j in range(self.aw)]


class Birrd:
    """Configurable BIRRD instance: simulate + route."""

    def __init__(self, aw: int):
        self.topo = BirrdTopology(aw)
        self.aw = aw
        # perms[i][j]: wire j after stage i lands on input perms[i][j] of stage i+1
        # (the final stage's "connection" maps to output-buffer ports).
        self.perms = [self.topo.permutation(i) for i in range(self.topo.num_stages)]

    # ------------------------------------------------------------- simulation
    def simulate(self, inputs: Sequence[float] | np.ndarray,
                 configs: Sequence[Sequence[int]]) -> np.ndarray:
        """Push numeric values through the switches (vectorized over trailing dims)."""
        vals = np.asarray(inputs, dtype=np.float64).copy()
        if vals.shape[0] != self.aw:
            raise ValueError(f"expected {self.aw} inputs")
        for stage in range(self.topo.num_stages):
            nxt = vals.copy()
            for sw in range(self.topo.switches_per_stage):
                l, r = 2 * sw, 2 * sw + 1
                cfg = configs[stage][sw]
                if cfg == PASS:
                    nxt[l], nxt[r] = vals[l], vals[r]
                elif cfg == SWAP:
                    nxt[l], nxt[r] = vals[r], vals[l]
                elif cfg == ADD_LEFT:   # left out = l + r, right out keeps right
                    nxt[l], nxt[r] = vals[l] + vals[r], vals[r]
                elif cfg == ADD_RIGHT:  # right out = l + r, left out keeps left
                    nxt[l], nxt[r] = vals[l], vals[l] + vals[r]
                else:
                    raise ValueError(f"bad config {cfg}")
            # inter-stage wiring
            wired = np.empty_like(nxt)
            for j in range(self.aw):
                wired[self.perms[stage][j]] = nxt[j]
            vals = wired
        return vals

    # ---------------------------------------------------------------- routing
    #
    # All inter-stage wirings are bit-permutations, so in "virtual
    # coordinates" (relabeling positions by the inverse cumulative wiring)
    # BIRRD is a pure dimension-exchange cascade: stage s XORs a free bit into
    # virtual dimension dim_seq[s].  Every dimension occurs exactly twice
    # (first pass free, second pass forced by the destination), so a wire's
    # entire path is determined by one intermediate label m (log2(AW) bits).
    #
    # route() =  (a) closed-form label candidates (covers the structured
    # relayouts dataflow switching produces, at any width), then (b) complete
    # path-DFS with randomized restarts (exact for the paper-scale networks:
    # AW=8 is exhaustively rearrangeable, AW=16 routes >99% of uniform-random
    # permutations within budget), then (c) for reductions, a destination-tag
    # stage-DFS — mirroring the paper's own ALM-heuristic + brute-force
    # fallback strategy (§III-B3).

    def _virtual_structure(self):
        if hasattr(self, "_vs"):
            return self._vs
        k = self.topo.log_aw
        gammas, gam, dims = [], list(range(k)), []
        for s in range(self.topo.num_stages):
            gammas.append(gam[:])
            dims.append(gam.index(0))
            pm = [self.perms[s][1 << j].bit_length() - 1 for j in range(k)]
            gam = [pm[g] for g in gam]
        gammas.append(gam[:])
        first, last = {}, {}
        for i, d in enumerate(dims):
            first.setdefault(d, i)
            last[d] = i
        self._vs = (dims, gammas, first, last)
        return self._vs

    def _phys_of_virtual(self, v: int, gam: List[int]) -> int:
        x = 0
        for j, g in enumerate(gam):
            if v >> j & 1:
                x |= 1 << g
        return x

    def _virtual_of_out(self, t: int) -> int:
        _, gammas, _, _ = self._virtual_structure()
        gam = gammas[self.topo.num_stages]
        v = 0
        for j, g in enumerate(gam):
            if t >> g & 1:
                v |= 1 << j
        return v

    def route(self, group_ids: Sequence[int], out_ports: Sequence[int],
              node_budget: int = 200_000, restarts: int = 12
              ) -> Optional[List[List[int]]]:
        """Find switch configs realising RIR semantics.

        ``group_ids[i]``  — reduction group of input wire i (or -1 for bubble)
        ``out_ports[g]``  — output port where group g's full sum must land

        Returns configs[stage][switch] or None if every strategy exhausts its
        budget (the paper reports no unroutable multicast case; property tests
        exercise this claim at the paper's network sizes).
        """
        group_ids, out_ports = list(group_ids), list(out_ports)
        sizes: Dict[int, int] = {}
        for g in group_ids:
            if g >= 0:
                sizes[g] = sizes.get(g, 0) + 1
        if sizes and max(sizes.values()) == 1:
            cfg = self._route_permutation(group_ids, out_ports,
                                          node_budget, restarts)
            if cfg is not None:
                return cfg
        # grouped reductions: the stage-DFS prunes hard once merges begin, so
        # a couple of deep searches beat many shallow restarts.
        rng = np.random.default_rng(0xFEA7)
        for attempt in range(3):
            router = _Router(self, group_ids, out_ports,
                             max(node_budget, 3_000_000),
                             rng=None if attempt == 0 else rng)
            cfg = router.solve()
            if cfg is not None:
                return cfg
        return None

    def _route_permutation(self, group_ids: Sequence[int],
                           out_ports: Sequence[int], node_budget: int,
                           restarts: int) -> Optional[List[List[int]]]:
        n = self.aw
        target = [-1] * n
        for i, g in enumerate(group_ids):
            if g >= 0:
                target[i] = out_ports[g]
        free = sorted(set(range(n)) - {t for t in target if t >= 0})
        it = iter(free)
        target = [t if t >= 0 else next(it) for t in target]
        vt = [self._virtual_of_out(t) for t in target]
        labels = self._closed_form_labels(vt)
        if labels is None:
            labels = self._label_dfs(vt, node_budget, restarts)
        if labels is None:
            return None
        return self._configs_from_labels(vt, labels)

    def _boundary_masks(self):
        """Per-boundary bit source masks: (from_w, from_m, from_t)."""
        dims, _, first, last = self._virtual_structure()
        k = self.topo.log_aw
        S = self.topo.num_stages
        masks = []
        for s in range(S):
            wm = mm = tm = 0
            for d in range(k):
                if s < first[d]:
                    wm |= 1 << d
                elif s < last[d]:
                    mm |= 1 << d
                else:
                    tm |= 1 << d
            masks.append((wm, mm, tm))
        return masks

    def _labels_feasible(self, vt: List[int], m: List[int]) -> bool:
        """All stage boundaries must be collision-free (injective positions)."""
        n = self.aw
        for wm, mm, tm in self._boundary_masks():
            seen = set()
            for w in range(n):
                pos = (w & wm) | (m[w] & mm) | (vt[w] & tm)
                if pos in seen:
                    return False
                seen.add(pos)
        return True

    def _closed_form_labels(self, vt: List[int]) -> Optional[List[int]]:
        """Label candidates that solve structured (bit-linear) relayouts
        without search: destination-routing, source-holding, and xor mixes."""
        n = self.aw
        k = self.topo.log_aw

        def rot(x: int, r: int) -> int:
            return ((x << r) | (x >> (k - r))) & (n - 1)

        cands = [
            list(vt),                          # destination-tag both passes
            list(range(n)),                    # hold source bits
            [w ^ vt[w] for w in range(n)],     # xor mix
            [vt[w] ^ (n - 1) for w in range(n)],
        ]
        for r in range(1, k):                  # bit-rotations of source/dest
            cands.append([rot(w, r) for w in range(n)])
            cands.append([rot(vt[w], r) for w in range(n)])
        for m in cands:
            if self._labels_feasible(vt, m):
                return m
        return None

    def _label_dfs(self, vt: List[int], node_budget: int,
                   restarts: int) -> Optional[List[int]]:
        """Complete path-DFS over intermediate labels with restarts."""
        import sys
        dims, _, first, last = self._virtual_structure()
        S = self.topo.num_stages
        n = self.aw
        if n > 16:
            # uniform-random wide permutations are out of the search budget;
            # production relayouts are structured and hit the closed forms.
            node_budget = min(node_budget, 50_000)
            restarts = min(restarts, 4)
        sys.setrecursionlimit(max(sys.getrecursionlimit(), n * (S + 2) * 3))
        for attempt in range(restarts):
            rng = np.random.default_rng(attempt * 7919 + 13)
            order = list(range(n))
            if attempt > 0:
                rng.shuffle(order)
            occ: List[Dict[int, int]] = [dict() for _ in range(S)]
            vpath: Dict[int, List[int]] = {}
            nodes = [0]

            def place(w: int, s: int, v: int, acc: List[int], idx: int) -> bool:
                nodes[0] += 1
                if nodes[0] > node_budget:
                    raise _Budget
                if s == S:
                    if v != vt[w]:
                        return False
                    vpath[w] = acc[:]
                    if dfs(idx + 1):
                        return True
                    del vpath[w]
                    return False
                d = dims[s]
                if last[d] == s:
                    choices = [(vt[w] >> d & 1) ^ (v >> d & 1)]
                else:
                    choices = [0, 1] if attempt == 0 or rng.random() < 0.5 \
                        else [1, 0]
                for c in choices:
                    v2 = v ^ (c << d)
                    if v2 not in occ[s]:
                        occ[s][v2] = w
                        acc.append(v2)
                        if place(w, s + 1, v2, acc, idx):
                            return True
                        acc.pop()
                        del occ[s][v2]
                return False

            def dfs(idx: int) -> bool:
                if idx == n:
                    return True
                w = order[idx]
                return place(w, 0, w, [], idx)

            try:
                if dfs(0):
                    # recover labels from the paths (bits at first-pass end)
                    labels = []
                    for w in range(n):
                        mid = vpath[w][max(first.values())]
                        labels.append(mid)
                    return labels
            except _Budget:
                continue
        return None

    def _configs_from_labels(self, vt: List[int], m: List[int]
                             ) -> Optional[List[List[int]]]:
        """Derive switch configs from intermediate labels, verifying
        collision-freedom along the way."""
        dims, gammas, first, last = self._virtual_structure()
        S = self.topo.num_stages
        n = self.aw
        masks = self._boundary_masks()
        configs = [[PASS] * (n // 2) for _ in range(S)]
        v_prev = list(range(n))
        for s in range(S):
            wm, mm, tm = masks[s]
            seen = {}
            for w in range(n):
                v_after = (w & wm) | (m[w] & mm) | (vt[w] & tm)
                if v_after in seen:
                    return None
                seen[v_after] = w
                flip = (v_prev[w] ^ v_after) >> dims[s] & 1
                if (v_prev[w] ^ v_after) & ~(1 << dims[s]):
                    return None  # illegal multi-bit move
                x = self._phys_of_virtual(v_prev[w], gammas[s])
                if flip:
                    configs[s][x >> 1] = SWAP
                v_prev[w] = v_after
            # consistency: both wires of a switch must agree (implied by
            # injectivity, but verify defensively)
        for w in range(n):
            if v_prev[w] != vt[w]:
                return None
        return configs

    def check(self, group_ids: Sequence[int], out_ports: Sequence[int],
              configs: Sequence[Sequence[int]]) -> bool:
        """Validate configs against the RIR spec with random values."""
        rng = np.random.default_rng(0)
        vals = rng.integers(1, 100, size=self.aw).astype(np.float64)
        for i, g in enumerate(group_ids):
            if g < 0:
                vals[i] = 0.0
        out = self.simulate(vals, configs)
        ngroups = max(group_ids) + 1 if group_ids else 0
        ok = True
        for g in range(ngroups):
            want = sum(vals[i] for i, gi in enumerate(group_ids) if gi == g)
            ok &= bool(abs(out[out_ports[g]] - want) < 1e-9)
        return ok


_JUNK = "JUNK"  # leftover copy produced by an ADD's secondary output


class _Router:
    """Backtracking destination-tag router with reachability pruning.

    Wire state: ``None`` (bubble), ``_JUNK`` (a stale partial-sum copy that may
    land anywhere EXCEPT a claimed output port) or a frozenset of input indices
    whose running sum rides the wire.  Each group's live partials must all
    merge (via ADD) before reaching the group's designated output port; an
    ADD's secondary output becomes junk (its value was folded into the sum).
    """

    def __init__(self, net: Birrd, group_ids: List[int], out_ports: List[int],
                 node_budget: int, rng=None):
        self.net = net
        self.aw = net.aw
        self.group_ids = group_ids
        self.out_ports = out_ports
        self.budget = node_budget
        self.rng = rng
        self.ngroups = max(group_ids) + 1 if group_ids else 0
        if len(set(out_ports)) != len(out_ports):
            raise ValueError("output ports must be distinct")
        self.full: List[frozenset] = [
            frozenset(i for i, g in enumerate(group_ids) if g == g_id)
            for g_id in range(self.ngroups)
        ]
        self.claimed = set(out_ports)
        self.unclaimed = set(range(self.aw)) - self.claimed
        # reach[stage][port] = set of final output ports reachable
        self.reach = self._reachability()

    def _reachability(self) -> List[List[set]]:
        S = self.net.topo.num_stages
        reach: List[List[set]] = [[set() for _ in range(self.aw)]
                                  for _ in range(S + 1)]
        for p in range(self.aw):
            reach[S][p] = {p}
        for stage in range(S - 1, -1, -1):
            perm = self.net.perms[stage]
            for sw in range(self.aw // 2):
                l, r = 2 * sw, 2 * sw + 1
                down = reach[stage + 1][perm[l]] | reach[stage + 1][perm[r]]
                reach[stage][l] = down
                reach[stage][r] = down
        return reach

    def solve(self) -> Optional[List[List[int]]]:
        init = [frozenset([i]) if self.group_ids[i] >= 0 else None
                for i in range(self.aw)]
        self.nodes = 0
        configs: List[List[int]] = []
        if self._dfs(0, init, configs):
            return configs
        return None

    def _wire_group(self, s) -> int:
        if s is None or s is _JUNK:
            return -1
        return self.group_ids[next(iter(s))]

    def _prune(self, stage: int, wires) -> bool:
        groups_seen: Dict[int, List[int]] = {}
        for w, s in enumerate(wires):
            if s is None:
                continue
            if s is _JUNK:
                # junk must still be able to avoid every claimed port
                if not (self.reach[stage][w] & self.unclaimed):
                    return False
                continue
            groups_seen.setdefault(self._wire_group(s), []).append(w)
        for g, ws in groups_seen.items():
            target = self.out_ports[g]
            members = frozenset().union(*(wires[w] for w in ws))
            if members != self.full[g]:
                return False
            # every live partial must be able to reach the target (it has to
            # merge into the final sum somewhere on a target-reaching path)
            for w in ws:
                if target not in self.reach[stage][w]:
                    return False
        return True

    def _dfs(self, stage: int, wires, configs: List[List[int]]) -> bool:
        S = self.net.topo.num_stages
        if stage == S:
            for g in range(self.ngroups):
                if wires[self.out_ports[g]] != self.full[g]:
                    return False
            for p in self.claimed:
                if wires[p] is _JUNK:
                    return False
            return True
        if not self._prune(stage, wires):
            return False
        return self._dfs_switch(stage, 0, wires, list(wires), [], configs)

    def _dfs_switch(self, stage: int, sw: int, wires, staged,
                    cfg_row: List[int], configs: List[List[int]]) -> bool:
        self.nodes += 1
        if self.nodes > self.budget:
            return False
        nsw = self.aw // 2
        if sw == nsw:
            perm = self.net.perms[stage]
            wired = [None] * self.aw
            for j in range(self.aw):
                wired[perm[j]] = staged[j]
            configs.append(cfg_row)
            if self._dfs(stage + 1, wired, configs):
                return True
            configs.pop()
            return False
        l, r = 2 * sw, 2 * sw + 1
        sl, sr = wires[l], wires[r]
        gl, gr = self._wire_group(sl), self._wire_group(sr)
        options: List[Tuple[int, object, object]] = []
        if gl >= 0 and gl == gr:
            merged = sl | sr
            options.append((ADD_LEFT, merged, _JUNK))
            options.append((ADD_RIGHT, _JUNK, merged))
        if sl is sr is None:
            options.append((PASS, sl, sr))   # both bubbles: one config suffices
        else:
            options.append((PASS, sl, sr))
            options.append((SWAP, sr, sl))
        if self.rng is not None:
            self.rng.shuffle(options)
        for cfg, ol, orr in options:
            staged[l], staged[r] = ol, orr
            cfg_row.append(cfg)
            if self._dfs_switch(stage, sw + 1, wires, staged, cfg_row, configs):
                return True
            cfg_row.pop()
        staged[l], staged[r] = sl, sr
        return False


# ------------------------------------------------------------------ cost model
@dataclasses.dataclass(frozen=True)
class NetworkCost:
    """Structural cost of a reduction network (paper Fig. 14a)."""

    switches: int
    adders: int
    stages: int
    area_um2: float
    power_mw: float


# Post-layout anchors from the paper (TSMC 28nm, int32 adders): a 16-input
# BIRRD occupies ~4% of the 475897 um^2 16x16 FEATHER die.
_EGG_AREA_UM2 = 4.0 / 100 * 475897.19 / (16 // 2 * 8)   # per Egg (16-in, 8 stages)
_EGG_POWER_MW = 0.04 * 323.48 / (16 // 2 * 8)


def birrd_cost(aw: int) -> NetworkCost:
    t = BirrdTopology(aw)
    n_sw = t.switches_per_stage * t.num_stages
    return NetworkCost(switches=n_sw, adders=n_sw, stages=t.num_stages,
                       area_um2=n_sw * _EGG_AREA_UM2,
                       power_mw=n_sw * _EGG_POWER_MW)


def fan_cost(n_inputs: int) -> NetworkCost:
    """SIGMA's FAN: log2(N)-1 stages, ~N-1 adders, spread across the PE array.

    One instance is needed per 1D PE array of AW*AH inputs (vs. BIRRD's single
    AW-input instance), which is where FEATHER's 94% NoC saving comes from.
    """
    stages = max(1, int(math.log2(n_inputs)) - 1)
    adders = n_inputs - 1
    # paper: AW-input BIRRD is ~1.43x FAN area at equal inputs
    area = birrd_cost_area_like(n_inputs) / 1.43
    return NetworkCost(switches=adders, adders=adders, stages=stages,
                       area_um2=area, power_mw=area * _EGG_POWER_MW / _EGG_AREA_UM2)


def art_cost(n_inputs: int) -> NetworkCost:
    """MAERI's ART (augmented reduction tree)."""
    stages = max(1, int(math.log2(n_inputs)) - 1)
    adders = n_inputs - 1
    area = birrd_cost_area_like(n_inputs) / 2.21
    return NetworkCost(switches=adders, adders=adders, stages=stages,
                       area_um2=area, power_mw=area * _EGG_POWER_MW / _EGG_AREA_UM2)


def birrd_cost_area_like(aw: int) -> float:
    t = BirrdTopology(aw)
    return t.switches_per_stage * t.num_stages * _EGG_AREA_UM2
