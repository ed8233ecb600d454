"""H100 roofline terms: the counterpart of ``repro.core.tpu_cost``.

The same three terms (compute, memory, collectives), each the per-device
count over the card's rate, and the bound the larger of them, with NVIDIA
H100 SXM5 80GB constants in place of TPU v5e's.  Every rate below is a
data-sheet figure, not a measurement.  The compute term splits by the
unit that runs the work: bf16 products on the tensor cores, f32 work on
the CUDA cores (the port keeps PyTorch's TF32 off, so an f32 product runs
there), and the fp32 products of ``rir_matmul``'s 3xTF32 design on the
tensor cores, three TF32 products each, so at a third of their TF32 rate.
The collective term splits by mesh axis, because an axis whose groups
cross nodes rides a different link: an HGX/DGX H100 node holds
``NODE_CARDS`` = 8 cards joined by NVLink, and nodes talk through their
NICs.  ``axis_bytes_per_s`` gives each axis its link from the mesh's
shape: on the row-major rank order, a group of the axis that stays inside
one node gets NVLink, and one that spans nodes the NIC, since its slowest
hop sets a ring's pace.  On the production 16x16 mesh both axes span
nodes (``model``'s 16 consecutive ranks cover two, ``data``'s stride of
16 crosses one at every hop).

``repro``'s ``collective_bytes_from_hlo`` has no counterpart: the port has
no HLO, and ``repro_torch.core.trace_cost`` counts a step's collectives as
``distributed.collectives`` issues them.  ``Work`` is one call's count,
which each kernel module states beside its kernel (``work``) and
``bound_ms`` turns into the least time the card could take.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, NamedTuple, Optional

# NVIDIA H100 SXM5 80GB data sheet (spec-sheet figures, not measurements)
BF16_PEAK_FLOPS = 989e12       # dense bf16 on the tensor cores
FP32_PEAK_FLOPS = 67e12        # fp32 on the CUDA cores
TF32_PEAK_FLOPS = 495e12       # dense tf32 on the tensor cores
HBM_BYTES_PER_S = 3.35e12      # HBM3
NVLINK_BYTES_PER_S = 450e9     # NVLink 4: 900 GB/s a card, 450 each way
NIC_BYTES_PER_S = 50e9         # one 400 Gb/s NIC a card
NODE_CARDS = 8                 # cards an HGX/DGX H100 node joins by NVLink
#: the peak of each compute unit a count names
PEAK_FLOPS = {"bf16": BF16_PEAK_FLOPS, "fp32": FP32_PEAK_FLOPS,
              "tf32x3": TF32_PEAK_FLOPS / 3}


class Work(NamedTuple):
    """One call's operations and bytes, and the unit that runs them
    (``"bf16"``: the tensor cores, ``"fp32"``: the CUDA cores,
    ``"tf32x3"``: an fp32 product as three TF32 ones on the tensor
    cores)."""
    flops: float
    bytes: float
    unit: str = "fp32"


def bound_ms(work: Work) -> Dict[str, float]:
    """The least time the card could take for ``work``: its bytes over
    the HBM rate or its operations over its unit's peak, whichever is
    larger (``bound_ms``, ``bound_by``, and both terms)."""
    byte_ms = work.bytes / HBM_BYTES_PER_S * 1e3
    op_ms = work.flops / PEAK_FLOPS[work.unit] * 1e3
    return {"bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            "byte_ms": byte_ms, "op_ms": op_ms}


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: Mapping[str, float]          # by unit
    bytes: float
    collective_bytes: Mapping[str, float]   # by mesh axis
    collective_s_by_axis: Mapping[str, float]
    chips: int

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def roofline_fraction(self) -> float:
        """bound / sum of the terms: 1.0 means the other two are free."""
        total = self.compute_s + self.memory_s + self.collective_s
        return self.bound_s / total if total else 0.0

    def to_dict(self) -> Dict:
        return {"compute_s": self.compute_s, "memory_s": self.memory_s,
                "collective_s": self.collective_s,
                "collective_s_by_axis": dict(self.collective_s_by_axis),
                "bound_s": self.bound_s, "dominant": self.dominant,
                "roofline_fraction": self.roofline_fraction(),
                "rates": "NVIDIA H100 SXM5 80GB data sheet, not measured"}


def axis_bytes_per_s(mesh_shape: Mapping[str, int]) -> Dict[str, float]:
    """The link rate of each axis of a mesh of ``mesh_shape`` (axis name
    -> size, in the mesh's order; ranks numbered row-major): NVLink where
    every group of the axis lies inside one node of ``NODE_CARDS`` ranks,
    else the NIC."""
    names, sizes = list(mesh_shape), list(mesh_shape.values())
    world = math.prod(sizes)
    out = {}
    for i, name in enumerate(names):
        stride = math.prod(sizes[i + 1:])
        inside = True
        for base in range(world):
            if (base // stride) % sizes[i]:
                continue                     # not the group's first rank
            last = base + (sizes[i] - 1) * stride
            inside = inside and base // NODE_CARDS == last // NODE_CARDS
        out[name] = NVLINK_BYTES_PER_S if inside else NIC_BYTES_PER_S
    return out


def terms_from_counts(flops: Mapping[str, float], nbytes: float,
                      collective_bytes: Mapping[str, float],
                      chips: int,
                      mesh_shape: Optional[Mapping[str, int]] = None
                      ) -> RooflineTerms:
    """The three terms in seconds from PER-DEVICE counts: ``flops`` by unit
    (``{"bf16": ..., "fp32": ...}``), ``nbytes`` of HBM traffic, and the
    collective bytes by mesh axis, each over its link on a mesh of
    ``mesh_shape`` (``axis_bytes_per_s``; an axis's collectives serialise
    on its link, the axes' times add).  ``mesh_shape`` may be left out
    where there are no collective bytes."""
    rates = axis_bytes_per_s(mesh_shape or {})
    by_axis = {ax: b / rates[ax] for ax, b in collective_bytes.items()}
    return RooflineTerms(
        compute_s=sum(f / PEAK_FLOPS[u] for u, f in flops.items()),
        memory_s=nbytes / HBM_BYTES_PER_S,
        collective_s=sum(by_axis.values()),
        flops=dict(flops), bytes=nbytes,
        collective_bytes=dict(collective_bytes),
        collective_s_by_axis=by_axis, chips=chips)


def model_flops(n_params_active: float, tokens: float,
                train: bool = True) -> float:
    """MODEL_FLOPS = 6 * N * D (dense) or 6 * N_active * D (MoE) for a
    train step; 2 * N_active * D for a forward pass alone (prefill,
    decode)."""
    return (6.0 if train else 2.0) * n_params_active * tokens


__all__ = ["BF16_PEAK_FLOPS", "FP32_PEAK_FLOPS", "TF32_PEAK_FLOPS",
           "HBM_BYTES_PER_S",
           "NIC_BYTES_PER_S", "NODE_CARDS", "NVLINK_BYTES_PER_S",
           "PEAK_FLOPS", "RooflineTerms", "Work", "axis_bytes_per_s",
           "bound_ms", "model_flops", "terms_from_counts"]
