"""SSM mixers: Mamba2 (SSD) and RWKV6 (Finch), train and decode paths.

The port of ``repro.models.ssm``: the same parameter specs (Mamba2's
``A_log``, ``D_skip`` and ``dt_bias`` and RWKV6's ``w0`` and ``u`` in f32,
the rest in the model dtype), the same projections, the chunked train path
through ``ops.linear_scan`` (the CUDA kernel on the card) and the exact
one-step recurrence for decode.  Both mixers reduce to the gated linear
attention recurrence of the scan.  Mamba2 shares its ``B``/``C`` and decay
across the heads; the JAX code broadcasts them to the scan's per-head
operands, and so does the port, made contiguous, since the kernel takes
contiguous operands (the log decay stays f32, as the kernel asks).

Under a mesh RWKV6 is tensor-parallel over heads (a ``TensorParallel``
context, ``tp``): ``wr``/``wk``/``wv``/``wg`` column-parallel, ``w0``,
``u`` and the decode state ``(B, H/m, dk, dv)`` local, the scan on the
local heads; the decay LoRA's ``w1`` column-parallel over its rank-64
hidden and ``w2`` row-parallel, reduce-scattered onto the local heads'
channels; ``ln_x``, an rmsnorm over the whole ``di``, sums its squares
over the group; ``wo`` row-parallel.  Mamba2 runs on one device only.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops

from .blocks import dtype_of
from .common import (NO_TP, SpecTree, TensorParallel, apply_norm, dense,
                     norm_spec)

_LORA_RANK = 64


def _dims(cfg: ArchConfig) -> Tuple[int, int, int, int]:
    di = cfg.d_inner or 2 * cfg.d_model
    state = cfg.ssm_state or 64
    heads = cfg.ssm_heads or max(1, di // 64)
    headdim = di // heads
    return di, state, heads, headdim


# ---------------------------------------------------------------------- mamba2
def mamba2_specs(cfg: ArchConfig) -> SpecTree:
    D = cfg.d_model
    di, state, heads, _ = _dims(cfg)
    dt = dtype_of(cfg)
    f32 = torch.float32
    conv_ch = di + 2 * state
    return {
        "norm": norm_spec(cfg.norm, D, dt),
        "in_proj": ((D, 2 * di + 2 * state + heads), dt),
        "conv_w": ((cfg.conv_width, conv_ch), dt),
        "conv_b": ((conv_ch,), dt),
        "A_log": ((heads,), f32),
        "D_skip": ((heads,), f32),
        "dt_bias": ((heads,), f32),
        "out_norm": norm_spec("rmsnorm", di, dt),
        "out_proj": ((di, D), dt),
    }


def _mamba2_project(cfg: ArchConfig, p, x: torch.Tensor):
    di, state, heads, _ = _dims(cfg)
    h = apply_norm(cfg.norm, x, p["norm"])
    zxbcdt = dense(h, p["in_proj"])
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * state]
    dt_raw = zxbcdt[..., -heads:]
    return z, xbc, dt_raw


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv over time.  xbc: (B, T, C); w: (W, C).  The
    taps are summed in the JAX code's order, in xbc's type."""
    W, T = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    out = torch.zeros_like(xbc)
    for i in range(W):
        out = out + pad[:, i:i + T, :] * w[i]
    return F.silu(out + b)


def mamba2_train(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    """x: (B, T, D) -> (B, T, D) residual delta, the chunked SSD scan
    through ``ops.linear_scan``."""
    B, T, D = x.shape
    di, state, heads, headdim = _dims(cfg)
    z, xbc, dt_raw = _mamba2_project(cfg, p, x)
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xs = xbc[..., :di].reshape(B, T, heads, headdim)
    Bmat = xbc[..., di:di + state]                      # (B, T, state)
    Cmat = xbc[..., di + state:]                        # (B, T, state)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])      # (B, T, heads)
    A = -torch.exp(p["A_log"])                          # (heads,) negative
    dt_h = dt.transpose(1, 2)[..., None]                # (B, heads, T, 1)
    shape = (B, heads, T, state)
    log_decay = (dt_h * A[None, :, None, None]).expand(shape).contiguous()
    q = Cmat[:, None].expand(shape).to(x.dtype).contiguous()
    k = (Bmat[:, None].expand(shape) * dt_h.to(x.dtype)).contiguous()
    v = xs.transpose(1, 2).contiguous()                 # (B, heads, T, hd)
    y = ops.linear_scan(q, k, v, log_decay)
    y = y + v * p["D_skip"][None, :, None, None].to(x.dtype)
    y = y.transpose(1, 2).reshape(B, T, di)
    y = apply_norm("rmsnorm", y * F.silu(z), p["out_norm"])
    return dense(y, p["out_proj"])


def mamba2_cache_specs(cfg: ArchConfig, batch: int) -> SpecTree:
    di, state, heads, headdim = _dims(cfg)
    return {"conv": ((batch, cfg.conv_width - 1, di + 2 * state),
                     dtype_of(cfg)),
            "ssm": ((batch, heads, state, headdim), torch.float32)}


def mamba2_decode(cfg: ArchConfig, p, x: torch.Tensor, cache: Dict
                  ) -> Tuple[torch.Tensor, Dict]:
    """One step.  x: (B, D); cache: {conv (B, W-1, C) in the model dtype,
    ssm (B, H, state, hd) f32}.  Returns (residual delta (B, D), new
    cache), as the JAX version does; the model writes the new cache into
    its own in place."""
    B, D = x.shape
    di, state, heads, headdim = _dims(cfg)
    z, xbc, dt_raw = _mamba2_project(cfg, p, x[:, None, :])
    z, xbc, dt_raw = z[:, 0], xbc[:, 0], dt_raw[:, 0]
    window = torch.cat([cache["conv"], xbc[:, None, :]], dim=1)
    conv = F.silu(torch.einsum("bwc,wc->bc", window, p["conv_w"])
                  + p["conv_b"])
    xs = conv[..., :di].reshape(B, heads, headdim)
    Bv = conv[..., di:di + state]
    Cv = conv[..., di + state:]
    dtv = F.softplus(dt_raw.float() + p["dt_bias"])    # (B, heads)
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dtv * A)
    h = cache["ssm"] * decay[..., None, None]
    h = h + (Bv[:, None, :, None] * dtv[..., None, None]
             * xs[:, :, None, :].float())
    y = torch.einsum("bhsd,bs->bhd", h, Cv.float())
    y = y.to(x.dtype) + xs * p["D_skip"][None, :, None].to(x.dtype)
    y = y.reshape(B, di)
    y = apply_norm("rmsnorm", y * F.silu(z), p["out_norm"])
    return dense(y, p["out_proj"]), {"conv": window[:, 1:], "ssm": h}


# ----------------------------------------------------------------------- rwkv6
def rwkv6_specs(cfg: ArchConfig) -> SpecTree:
    D = cfg.d_model
    di, _, heads, headdim = _dims(cfg)
    dt = dtype_of(cfg)
    f32 = torch.float32
    return {
        "norm": norm_spec(cfg.norm, D, dt),
        "mu": ((5, D), dt),                   # r,k,v,w,g token-shift
        "wr": ((D, di), dt),
        "wk": ((D, di), dt),
        "wv": ((D, di), dt),
        "wg": ((D, di), dt),
        "w0": ((di,), f32),
        "w1": ((D, _LORA_RANK), dt),
        "w2": ((_LORA_RANK, di), dt),
        "u": ((di,), f32),                    # current-token bonus
        "ln_x": norm_spec("rmsnorm", di, dt),  # rmsnorm over all of di
        "wo": ((di, D), dt),
    }


def _rwkv6_project(cfg: ArchConfig, p, x: torch.Tensor,
                   x_prev: torch.Tensor, tp: TensorParallel = NO_TP):
    """Token-shift mix then project.  x, x_prev: (B, T, D); r, k, v, logw
    and g of this rank's channels.  ``repro``'s rules split ``mu`` over
    the model axis along D (its ``u$`` rule matches), so it is gathered
    whole for the mix."""
    mu = p["mu"]
    if "mu" in tp.split:
        from repro_torch.distributed import collectives as col
        mu = col.all_gather(mu, 1, tp.group)
    else:
        mu = tp.local(mu)
    mixed = [x + (x_prev - x) * mu[i] for i in range(5)]
    r = dense(mixed[0], p["wr"])
    k = dense(mixed[1], p["wk"])
    v = dense(mixed[2], p["wv"])
    lora = dense(torch.tanh(dense(mixed[3], p["w1"])), p["w2"])
    if tp.on:
        from repro_torch.distributed import collectives as col
        lora = col.reduce_scatter(lora, -1, tp.group)
    logw = -torch.exp(p["w0"] + lora.float())
    g = F.silu(dense(mixed[4], p["wg"]))
    return r, k, v, logw, g


def _ln_x(cfg: ArchConfig, p, y: torch.Tensor, tp: TensorParallel
          ) -> torch.Tensor:
    """The rmsnorm over all of ``di`` on this rank's channels of it: the
    mean square summed over the group."""
    if not tp.on:
        return apply_norm("rmsnorm", y, p["ln_x"])
    from repro_torch.distributed import collectives as col
    di = _dims(cfg)[0]
    n = y.shape[-1]
    y32 = y.float()
    part = torch.mean(y32 * y32, dim=-1, keepdim=True) * (n / di)
    var = col.copy(col.all_reduce(part, tp.group), tp.group)
    w = tp.local(p["ln_x"]["w"]).narrow(0, tp.rank * n, n)
    return (y32 * torch.rsqrt(var + 1e-5)).to(y.dtype) * w


def _shift(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` one step later along ``dim`` (a zero first, the last dropped)."""
    return torch.cat([torch.zeros_like(t.narrow(dim, 0, 1)),
                      t.narrow(dim, 0, t.shape[dim] - 1)], dim=dim)


def _local_heads(cfg: ArchConfig, tp: TensorParallel) -> Tuple[int, int]:
    """(heads, channels) this rank computes."""
    _, _, heads, headdim = _dims(cfg)
    if tp.on:
        heads //= tp.size
    return heads, heads * headdim


def rwkv6_train(cfg: ArchConfig, p, x: torch.Tensor,
                tp: TensorParallel = NO_TP) -> torch.Tensor:
    """x: (B, T, D) -> (B, T, D) residual delta (in the stream's layout
    under a mesh), the scan through ``ops.linear_scan`` on this rank's
    heads."""
    _, _, _, headdim = _dims(cfg)
    heads, di = _local_heads(cfg, tp)
    h = tp.enter(tp.norm(cfg.norm, x, p["norm"]))
    B, T, D = h.shape
    r, k, v, logw, g = _rwkv6_project(cfg, p, h, _shift(h, 1), tp)

    def split(t):
        return t.reshape(B, T, heads, headdim).transpose(1, 2)

    rh, kh, vh, wh = split(r), split(k), split(v), split(logw)
    # exclusive-decay trick: shift (k, v, w) one step so the scan yields
    # y_t = r_t . h_{t-1}; the current-token bonus u is added directly.
    ksh = _shift(kh, 2).to(x.dtype).contiguous()
    vsh = _shift(vh, 2).contiguous()
    wsh = _shift(wh, 2).contiguous()
    y = ops.linear_scan(rh.contiguous(), ksh, vsh, wsh)
    u = p["u"].reshape(heads, headdim)
    bonus = torch.sum(rh * u[None, :, None, :].to(x.dtype) * kh, dim=-1,
                      keepdim=True) * vh
    y = (y + bonus).transpose(1, 2).reshape(B, T, di)
    y = _ln_x(cfg, p, y, tp) * g
    return tp.exit(dense(y, p["wo"]))


def rwkv6_cache_specs(cfg: ArchConfig, batch: int) -> SpecTree:
    _, _, heads, headdim = _dims(cfg)
    return {"x_prev": ((batch, cfg.d_model), dtype_of(cfg)),
            "state": ((batch, heads, headdim, headdim), torch.float32)}


def rwkv6_decode(cfg: ArchConfig, p, x: torch.Tensor, cache: Dict,
                 tp: TensorParallel = NO_TP) -> Tuple[torch.Tensor, Dict]:
    """One step.  x: (B, D); cache: {x_prev (B, D), state (B, H, hd, hd)}.
    Returns (residual delta (B, D), new cache), as the JAX version does.
    Under a mesh the cache holds this rank's (B, D/m) of ``x_prev`` and
    (B, H/m, hd, hd) of the state, as ``cache_shardings`` places them."""
    B, D = x.shape
    _, _, _, headdim = _dims(cfg)
    heads, di = _local_heads(cfg, tp)
    h = tp.enter(apply_norm(cfg.norm, x, p["norm"]))
    prev = cache["x_prev"]
    if tp.on:
        from repro_torch.distributed import collectives as col
        prev = col.all_gather(prev, 1, tp.group, replicated=True)
    r, k, v, logw, g = _rwkv6_project(cfg, p, h[:, None], prev[:, None], tp)
    r, k, v, logw, g = r[:, 0], k[:, 0], v[:, 0], logw[:, 0], g[:, 0]

    def split(t):
        return t.reshape(B, heads, headdim)

    rh, kh, vh = split(r), split(k), split(v)
    wh = torch.exp(split(logw))
    u = p["u"].reshape(1, heads, headdim)
    kv = kh[..., :, None].float() * vh[..., None, :].float()
    wkv = cache["state"] + u[..., :, None] * kv
    y = torch.einsum("bhk,bhkd->bhd", rh.float(), wkv)
    new_state = cache["state"] * wh[..., :, None] + kv
    y = y.to(x.dtype).reshape(B, di)
    y = _ln_x(cfg, p, y, tp) * g
    new_prev = h
    if tp.on:
        from repro_torch.distributed import collectives as col
        new_prev = col.split(h, 1, tp.group)
    return tp.exit(dense(y, p["wo"])), {"x_prev": new_prev,
                                        "state": new_state}
