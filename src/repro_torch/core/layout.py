"""Data-layout algebra for logical 2D on-chip buffers (paper §II-B, Fig. 3, Tab. II).

A *layout* maps a tensor coordinate to a ``(line, offset)`` address in a logical
2D buffer of ``num_lines x line_size``.  The notation follows the paper:

    "CHW_W4H2C2"  ==  Layout(inter=("C","H","W"), intra=(("W",4),("H",2),("C",2)))

* ``intra`` — ordered (dim, size) pairs flattened into a single line; the FIRST
  entry varies fastest within the line ("W4H2C2" packs 4 consecutive W, then 2 H,
  then 2 C into a 16-wide line).
* ``inter`` — dimension order ACROSS lines; the FIRST entry varies fastest from
  one line to the next ("CHW" steps C tiles first, then H tiles, then W tiles).

Physically the buffer stacks SRAM banks vertically; ``conflict_depth`` lines live
in each bank and each bank has ``ports`` concurrent read/write ports (paper §V-A).
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, Iterable, Mapping, Sequence, Tuple

import numpy as np

Coord = Mapping[str, int]


@dataclasses.dataclass(frozen=True)
class Layout:
    """A data layout: inter-line dim order + intra-line (dim, size) packing."""

    inter: Tuple[str, ...]
    intra: Tuple[Tuple[str, int], ...]

    # ------------------------------------------------------------------ basics
    @property
    def line_size(self) -> int:
        return math.prod(s for _, s in self.intra) if self.intra else 1

    @property
    def intra_sizes(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for d, s in self.intra:
            out[d] = out.get(d, 1) * s
        return out

    def name(self) -> str:
        return "".join(self.inter) + "_" + "".join(f"{d}{s}" for d, s in self.intra)

    @staticmethod
    def parse(spec: str) -> "Layout":
        """Parse paper notation, e.g. ``CHW_W4H2C2`` or ``MK_K32``."""
        inter_s, _, intra_s = spec.partition("_")
        inter = tuple(inter_s)
        intra = tuple((m.group(1), int(m.group(2)))
                      for m in re.finditer(r"([A-Za-z])(\d+)", intra_s))
        return Layout(inter=inter, intra=intra)

    # --------------------------------------------------------------- addressing
    def num_lines(self, dims: Mapping[str, int]) -> int:
        intra = self.intra_sizes
        n = 1
        for d in self.inter:
            n *= max(1, math.ceil(dims[d] / intra.get(d, 1)))
        return n

    def address(self, coord: Coord, dims: Mapping[str, int]) -> Tuple[int, int]:
        """Return (line, offset) of ``coord`` in a tensor with extents ``dims``."""
        # intra-line offset: first intra entry is innermost
        off, mul = 0, 1
        rem: Dict[str, int] = dict(coord)
        for d, s in self.intra:
            off += (rem[d] % s) * mul
            rem[d] = rem[d] // s
            mul *= s
        # inter-line index: first inter entry is innermost (fastest varying)
        intra = self.intra_sizes
        line, lmul = 0, 1
        for d in self.inter:
            extent = max(1, math.ceil(dims[d] / intra.get(d, 1)))
            line += (rem.get(d, 0) % extent) * lmul
            lmul *= extent
        return line, off

    def lines_for(self, coords: Iterable[Coord], dims: Mapping[str, int]) -> set:
        return {self.address(c, dims)[0] for c in coords}

    def lines_array(self, coords: Mapping[str, "np.ndarray"],
                    dims: Mapping[str, int]) -> "np.ndarray":
        """Vectorized line index of coordinate arrays (same math as
        ``address``; the conflict assessor's hot path)."""
        shape = next(iter(coords.values())).shape
        rem = {d: np.asarray(v, np.int64) for d, v in coords.items()}
        for d, s in self.intra:
            rem[d] = rem[d] // s
        intra = self.intra_sizes
        line = np.zeros(shape, np.int64)
        lmul = 1
        for d in self.inter:
            extent = max(1, math.ceil(dims[d] / intra.get(d, 1)))
            line = line + (rem.get(d, 0) % extent) * lmul
            lmul *= extent
        return line


@dataclasses.dataclass(frozen=True)
class Buffer:
    """Physical organization of a logical 2D buffer (paper §V-A).

    ``conflict_depth`` lines share one bank; each bank has ``ports`` ports.
    """

    num_lines: int
    line_size: int
    conflict_depth: int = 8
    ports: int = 2  # TSMC 28nm SRAM: at most two ports (paper Tab. II)

    def bank_of(self, line: int) -> int:
        return line // self.conflict_depth

    @property
    def num_banks(self) -> int:
        return max(1, math.ceil(self.num_lines / self.conflict_depth))

    def access_slowdown(self, lines: Sequence[int]) -> float:
        """Paper §V-B: max(N_L / N_P, 1) per bank, worst bank dominates a cycle."""
        per_bank: Dict[int, int] = {}
        for ln in set(lines):
            b = self.bank_of(ln)
            per_bank[b] = per_bank.get(b, 0) + 1
        if not per_bank:
            return 1.0
        return max(max(n / self.ports, 1.0) for n in per_bank.values())


# Layout spaces used in the paper's evaluation (§VI-A footnote 4).
CONV_LAYOUTS = (
    "HWC_C32", "HWC_W32", "HWC_H32",
    "HWC_C4W8", "HWC_C4H8", "HWC_W4H8", "HWC_C4W4H2",
)
GEMM_LAYOUTS = ("MK_K32", "MK_M32", "MK_M4K8")


def conv_layout_space() -> Tuple[Layout, ...]:
    return tuple(Layout.parse(s) for s in CONV_LAYOUTS)


def gemm_layout_space() -> Tuple[Layout, ...]:
    return tuple(Layout.parse(s) for s in GEMM_LAYOUTS)
