"""RIR — Reorder-In-Reduction semantic specification (paper §II-E2, §IV).

The PyTorch port of ``repro.core.rir``.  The function BIRRD computes each
cycle: AW partial sums arrive from one NEST row; arbitrary contiguous-or-not
*reduction groups* are summed and each group's result lands on an
*arbitrary output port* (= StaB bank), so the oAct tensor materializes
directly in the next layer's concordant layout.

This module is the oracle the BIRRD kernel and the BIRRD switch model are
both validated against.  ``jax.ops.segment_sum`` with a bubble overflow slot
becomes ``index_add_`` into ``ngroups + 1`` rows (the last dropped), and
``.at[].set`` an index assignment into a zeros tensor.
"""
from __future__ import annotations

from typing import Sequence

import torch


def rir_reduce_reorder(values: torch.Tensor, group_ids: torch.Tensor,
                       out_ports: torch.Tensor, num_outputs: int
                       ) -> torch.Tensor:
    """sum values per group, scatter each group's sum to its output port.

    values:     (n, ...)  — one row of NEST partial sums (leading axis = wires)
    group_ids:  (n,) int — reduction group per wire, -1 = bubble
    out_ports:  (g,) int — target port per group (distinct)
    returns     (num_outputs, ...) with zeros on unclaimed ports
    """
    ngroups = out_ports.shape[0]
    gid = group_ids.to(device=values.device, dtype=torch.long)
    gid = torch.where(gid < 0, torch.full_like(gid, ngroups), gid)
    sums = values.new_zeros((ngroups + 1,) + tuple(values.shape[1:]))
    sums.index_add_(0, gid, values)
    out = values.new_zeros((num_outputs,) + tuple(values.shape[1:]))
    out[out_ports.to(device=values.device, dtype=torch.long)] = sums[:ngroups]
    return out


def rir_layout_write(oacts: torch.Tensor, perm: torch.Tensor
                     ) -> torch.Tensor:
    """Pure reorder (no reduction): BIRRD as a permutation network (Fig. 10-B).

    perm[i] = output port receiving input wire i.
    """
    out = torch.zeros_like(oacts)
    out[perm.to(device=oacts.device, dtype=torch.long)] = oacts
    return out


def make_group_ids(group_sizes: Sequence[int], n: int) -> torch.Tensor:
    """Contiguous reduction groups: sizes -> per-wire group ids (-1 padding)."""
    ids = []
    for g, s in enumerate(group_sizes):
        ids.extend([g] * s)
    ids.extend([-1] * (n - len(ids)))
    if len(ids) != n:
        raise ValueError("group sizes exceed wire count")
    return torch.tensor(ids, dtype=torch.int32)
