"""Expert-parallel MoE: explicit all-to-all token routing.

The port of ``repro.distributed.moe_ep``, with ``torch.distributed``
collectives in place of ``shard_map``:

* tokens arrive sequence-sharded over the *model* axis (the coswitch
  layout): each rank holds ``(B_loc, T/m, D)``;
* each rank routes its local tokens and builds a local ``(E, C, D)``
  dispatch, with the capacity ``C`` of its own ``N = B_loc T_loc`` tokens
  (so EP drops tokens differently from the one-device ``moe_apply``, as
  in ``repro``), and ``all_to_all_single``s it over the model group, so
  each rank receives the tokens of ITS ``E/m`` experts from every peer;
* the expert weights are E-sharded over the model axis and FSDP-sharded
  over the data axes, all-gathered over the data axes inside the block;
* the results go home with the reverse ``all_to_all_single`` and are
  combined by the top-k gates: FEATHER's RIR at mesh scale, a reduction
  whose results land at each token's home position.

The router, the norm and the shared expert see this rank's tokens only,
so their gradients are summed over the model group (``collectives.copy``).

Where EP does not apply (``ep_applicable``: a decode step, or T not
divisible by the model axis) ``moe_apply_tp`` runs the block on the
replicated stream: each rank's ``E/m`` experts on their rows of the
one-device dispatch, the partial combines all-reduced over the model
group.  No expert weight crosses the model group in either path.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.blocks import (moe_capacity, moe_combine,
                                       moe_dispatch, moe_experts, moe_route,
                                       moe_shared)
from repro_torch.models.common import apply_norm

from . import collectives as col
from .collectives import data_group
from .sharding import axis_sizes, data_size


def capacity(cfg: ArchConfig, n_tokens: int) -> int:
    """Rows an expert takes from one shard's ``n_tokens`` tokens:
    ``repro``'s EP rule (at least 8, where ``moe_capacity`` caps at N)."""
    C = int(math.ceil(n_tokens * cfg.top_k / cfg.n_experts
                      * cfg.capacity_factor / 8.0)) * 8
    return min(C, max(8, n_tokens))


def moe_apply_ep(cfg: ArchConfig, p, x: torch.Tensor, mesh,
                 return_slot: bool = False):
    """x: this rank's (B_loc, T_loc, D) tokens -> their (B_loc, T_loc, D)
    residual delta (and, with ``return_slot``, each (token, k)'s slot in
    this rank's dispatch, ``E C`` where it was dropped).  ``p`` holds the
    local shards: experts ``(E/m, D, F/d)`` and ``(E/m, F/d, D)``, the
    shared expert ``(D, F/d)``/``(F/d, D)``, the router and norm whole."""
    norm = {k: col.copy(v, mesh.get_group("model"))
            for k, v in p["norm"].named_parameters()}
    return _ep_normed(cfg, p, apply_norm(cfg.norm, x, norm), mesh,
                      return_slot)


def _ep_normed(cfg: ArchConfig, p, h: torch.Tensor, mesh,
               return_slot: bool = False):
    """``moe_apply_ep`` after the block's norm: ``h`` this rank's normed
    (B_loc, T_loc, D) tokens."""
    E, K = cfg.n_experts, cfg.top_k
    mg, dg = mesh.get_group("model"), data_group(mesh)
    m = axis_sizes(mesh)["model"]
    E_loc = E // m
    B_loc, T_loc, D = h.shape
    N = B_loc * T_loc
    flat = h.reshape(N, D)
    logits = flat.float() @ col.copy(p["router"], mg)
    top, idx = torch.topk(logits, K, dim=-1)
    gates = torch.softmax(top, dim=-1)

    C = capacity(cfg, N)
    slot, disp = moe_dispatch(flat, idx, E, C)

    # to the experts' owners: block j of E goes to rank j; each rank ends
    # with (E_loc, m C, D), its experts' rows from every peer in rank order
    recv = col.all_to_all_single(disp, mg)
    recv = recv.reshape(m, E_loc, C, D).transpose(0, 1).reshape(
        E_loc, m * C, D)

    # FSDP: the data shards of this rank's experts, gathered
    def whole(w, dim):
        return col.all_gather(w, dim, dg, contiguous=False)

    wg = whole(p["wg"], 2) if cfg.act == "swiglu" else None
    out_e = moe_experts(cfg, recv, whole(p["wu"], 2), wg, whole(p["wd"], 1))

    # home again (the reverse exchange): the RIR combine
    out_e = out_e.reshape(E_loc, m, C, D).transpose(0, 1).contiguous()
    back = col.all_to_all_single(out_e, mg).reshape(E * C, D)
    combined = moe_combine(back, slot, gates, flat)
    if cfg.shared_expert:
        combined = combined + _shared(
            cfg, p["shared"], flat,
            lambda t, dim: col.copy(whole(t, dim), mg))
    out = combined.reshape(B_loc, T_loc, D)
    return (out, slot) if return_slot else out


def _shared(cfg: ArchConfig, sp, flat: torch.Tensor, whole) -> torch.Tensor:
    """The shared expert on ``flat``, each weight through ``whole(w,
    dim)``, which gathers it over the axes that split it."""
    def w(k):
        return whole(sp[k], 0 if k == "wd" else 1)

    return moe_shared(cfg, flat, w("wu"),
                      w("wg") if cfg.act == "swiglu" else None, w("wd"))


def ep_applicable(cfg: ArchConfig, mesh, shape: Sequence[int]) -> bool:
    """``repro``'s test, on the global ``(B, T, D)`` shape of the block's
    input: the experts, T, the batch and ``d_ff`` divide their axes."""
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return False
    m = axis_sizes(mesh)["model"]
    if cfg.n_experts % m or shape[1] % m:
        return False
    dsize = data_size(mesh)
    if shape[0] % dsize:
        return False
    return cfg.d_ff % dsize == 0


def moe_apply_ep_stream(cfg: ArchConfig, p, x: torch.Tensor, mesh, tp
                        ) -> torch.Tensor:
    """The EP block on the residual stream in ``tp``'s layout: the
    sequence-sharded stream is this rank's tokens already; the replicated
    one is normed whole on every rank (the norm weights' gradient then
    whole on each, from the gathered gradient of the normed tokens), each
    rank takes its T block of the normed tokens and the results are
    gathered back.  Norming before the split keeps the stream's gradient
    terms (the residual's and the norm's) summed in the order one device
    sums them: a split between them made one rank's step differ from one
    device's in the last bits."""
    if tp.seq:
        return moe_apply_ep(cfg, p, x, mesh)
    h = apply_norm(cfg.norm, x, p["norm"])
    y = _ep_normed(cfg, p, col.split(h, 1, tp.group), mesh)
    return col.all_gather(y, 1, tp.group, replicated=True)


def moe_apply_tp(cfg: ArchConfig, p, x: torch.Tensor, mesh) -> torch.Tensor:
    """The block where EP does not apply (a decode step, T not divisible by
    the model axis): ``x`` (B_loc, T, D), the same on every rank of the
    model group.  Every rank routes all of its tokens, with
    ``moe_apply``'s capacity of its ``N = B_loc T``, and runs its ``E/m``
    experts on their rows of the dispatch; the partial combines are summed
    over the model group, so no expert weight crosses it (the partition
    GSPMD gives an E-sharded ``moe_apply``).  The router, the norm and the
    shared expert run whole on every rank; the gates and the dispatched
    tokens feed this rank's experts only, so their gradients are summed
    over the group (``collectives.copy``).  Experts and the shared expert
    split over the data axes are gathered over them.  Where E does not
    split over the group every rank runs every expert and nothing is
    summed.  Both follow the placement (``_guard`` keeps an axis where it
    divides the dimension), so a group of one still calls every
    collective."""
    mg, dg = mesh.get_group("model"), data_group(mesh)
    E, F = cfg.n_experts, cfg.d_ff
    B, T, D = x.shape
    m = axis_sizes(mesh)["model"]
    split = E % m == 0
    E_loc = E // m if split else E
    lo = mesh.get_local_rank("model") * E_loc if split else 0
    by_data = F % data_size(mesh) == 0

    def part(t):
        return col.copy(t, mg) if split else t

    def whole(w, dim):
        return col.all_gather(w, dim, dg, contiguous=False) if by_data else w

    flat, _, (top, idx) = moe_route(cfg, p, x)
    gates = torch.softmax(top, dim=-1)
    C = moe_capacity(cfg, B * T)
    slot, disp = moe_dispatch(part(flat), idx, E, C)
    wg = whole(p["wg"], 2) if cfg.act == "swiglu" else None
    mine = moe_experts(cfg, disp[lo:lo + E_loc], whole(p["wu"], 2), wg,
                       whole(p["wd"], 1))
    out_e = torch.cat([mine.new_zeros((lo * C, D)),
                       mine.reshape(E_loc * C, D),
                       mine.new_zeros(((E - lo - E_loc) * C, D))])
    combined = moe_combine(out_e, slot, part(gates), flat)
    if split:
        combined = col.all_reduce(combined, mg)
    if cfg.shared_expert:
        combined = combined + _shared(cfg, p["shared"], flat, whole)
    return combined.reshape(B, T, D)
