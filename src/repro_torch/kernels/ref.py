"""Plain PyTorch versions of the kernels (the ``ref.py`` contract).

Each function is the semantic ground truth its kernel is held against: the
CPU tests compare them with the JAX package's oracles, and ``chip_smoke.py``
compares the CUDA kernel with them on the card.  Layouts at the public
functions are the JAX package's: NHWC activations, ``(R, S, C, M)`` conv
weights, ``(R, S, M)`` depthwise weights, ``(B, S, Hkv, D)`` KV caches,
``(B, H, T, d)`` scan operands.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.birrd import (ADD_LEFT, ADD_RIGHT, PASS, SWAP,
                                    BirrdTopology)
from repro_torch.core.rir import rir_reduce_reorder


# ----------------------------------------------------------------- rir_matmul
def rir_matmul(a: torch.Tensor, b: torch.Tensor,
               out_block_perm: Sequence[int], block_n: int,
               residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GEMM whose output N-blocks are written in permuted order (RIR epilogue).

    out[:, perm[j]*bn : (perm[j]+1)*bn] = (a @ b)[:, j*bn : (j+1)*bn]

    ``residual`` (if given) is already stored in the *output* block order and
    is added after the store — the fused skip-connection add of the plan
    executor.
    """
    y = torch.matmul(a.float(), b.float()).to(a.dtype)
    n_blocks = y.shape[1] // block_n
    out = torch.zeros_like(y)
    for j in range(n_blocks):
        pj = int(out_block_perm[j])
        out[:, pj * block_n:(pj + 1) * block_n] = \
            y[:, j * block_n:(j + 1) * block_n]
    if residual is not None:
        out = out + residual.to(out.dtype)
    return out


# ----------------------------------------------------------- conv2d (+depthwise)
def _taps(x: torch.Tensor, r: int, s: int, P: int, Q: int,
          stride: int) -> torch.Tensor:
    return x[:, r:r + (P - 1) * stride + 1:stride,
             s:s + (Q - 1) * stride + 1:stride, :]


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Valid (no-padding) NHWC convolution.

    x: (N, H, W, C); w: (R, S, C, M).  Returns (N, P, Q, M) with
    P = (H - R)//stride + 1, Q = (W - S)//stride + 1 — the ``ConvWorkload``
    convention, where the workload's H/W already include any SAME padding.
    """
    N, H, W, C = x.shape
    R, S, _, M = w.shape
    P = (H - R) // stride + 1
    Q = (W - S) // stride + 1
    y = torch.zeros((N, P, Q, M), dtype=torch.float32, device=x.device)
    for r in range(R):
        for s in range(S):
            tap = _taps(x, r, s, P, Q, stride)
            y = y + torch.einsum("npqc,cm->npqm", tap.float(), w[r, s].float())
    return y.to(x.dtype)


def depthwise_conv2d(x: torch.Tensor, w: torch.Tensor,
                     stride: int = 1) -> torch.Tensor:
    """Valid NHWC depthwise convolution.

    x: (N, H, W, M); w: (R, S, M) — one RxS filter per channel.
    """
    N, H, W, M = x.shape
    R, S, _ = w.shape
    P = (H - R) // stride + 1
    Q = (W - S) // stride + 1
    y = torch.zeros((N, P, Q, M), dtype=torch.float32, device=x.device)
    for r in range(R):
        for s in range(S):
            tap = _taps(x, r, s, P, Q, stride)
            y = y + tap.float() * w[r, s].float()
    return y.to(x.dtype)


# --------------------------------------------------------------- birrd_reduce
def birrd_reduce(x: torch.Tensor, group_ids: torch.Tensor,
                 out_ports: torch.Tensor, num_outputs: int) -> torch.Tensor:
    """Grouped reduction + scatter: the RIR semantic spec over rows of x."""
    return rir_reduce_reorder(x, group_ids, out_ports, num_outputs)


def birrd_apply(x: torch.Tensor, stage_mats: torch.Tensor,
                port_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x`` (aw, d) through stacked stage matrices (S, aw, aw): ``vals =
    M_s @ vals`` in f32 stage after stage, then one cast to x's dtype (the
    arithmetic of the Pallas ``birrd_apply_p`` and of the dense CUDA
    kernel); rows where ``port_mask`` (aw,) bool is False are 0."""
    vals = x.float()
    for m in stage_mats:
        vals = torch.matmul(m.float(), vals)
    y = vals.to(x.dtype)
    if port_mask is None:
        return y
    return torch.where(port_mask[:, None], y, torch.zeros_like(y))


def birrd_switch(x: torch.Tensor, configs: Sequence[Sequence[int]],
                 port_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x`` (aw, d) through the BIRRD switches as ``Birrd.simulate`` walks
    them, in f32: each stage's Egg configs (one a switch: PASS, SWAP,
    ADD_LEFT, ADD_RIGHT), then the Alg. 1 wiring to the next stage; one
    cast to x's dtype at the end (the arithmetic of the switch kernel).
    Rows where ``port_mask`` (aw,) bool is False are 0."""
    aw = x.shape[0]
    topo = BirrdTopology(aw)
    if len(configs) != topo.num_stages:
        raise ValueError(f"aw={aw} has {topo.num_stages} stages, got "
                         f"{len(configs)}")
    vals = list(x.float().unbind(0))
    for stage, row in enumerate(configs):
        nxt = [None] * aw
        for sw, cfg in enumerate(row):
            left, right = vals[2 * sw], vals[2 * sw + 1]
            cfg = int(cfg)
            if cfg == PASS:
                out = (left, right)
            elif cfg == SWAP:
                out = (right, left)
            elif cfg == ADD_LEFT:
                out = (left + right, right)
            elif cfg == ADD_RIGHT:
                out = (left, left + right)
            else:
                raise ValueError(f"bad config {cfg}")
            nxt[topo.connection(stage, 2 * sw)] = out[0]
            nxt[topo.connection(stage, 2 * sw + 1)] = out[1]
        vals = nxt
    y = torch.stack(vals).to(x.dtype)
    if port_mask is None:
        return y
    return torch.where(port_mask[:, None], y, torch.zeros_like(y))


# ----------------------------------------------------------------- gqa_decode
def gqa_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               lengths: Optional[torch.Tensor] = None,
               scale: Optional[float] = None) -> torch.Tensor:
    """Single-token GQA decode attention.

    q: (B, Hq, D); k/v: (B, S, Hkv, D); lengths: (B,) valid KV length.
    Hq = G * Hkv.  Returns (B, Hq, D).  Masks with -inf, so a row of
    length 0 gives NaN.
    """
    B, Hq, D = q.shape
    _, S, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    qg = q.reshape(B, Hkv, G, D)
    scores = torch.einsum("bhgd,bshd->bhgs", qg.float(), k.float()) * scale
    if lengths is not None:
        pos = torch.arange(S, device=q.device)
        mask = pos[None, None, None, :] < lengths[:, None, None, None]
        scores = scores.masked_fill(~mask, float("-inf"))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", w, v.float())
    return out.reshape(B, Hq, D).to(q.dtype)


def gqa_decode_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       lengths: torch.Tensor,
                       scale: Optional[float] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``gqa_decode`` with each row's softmax statistics: ``(out (B, Hq, D)
    in q's dtype, m (B, Hq) f32, l (B, Hq) f32)``, ``m`` the row's largest
    scaled score over its first ``lengths[b]`` positions and ``l = sum
    exp(s - m)`` over them.  A row of length <= 0 is ``(0, -inf, 0)``, no
    NaN: the merge of a sequence split weighs it 0."""
    B, Hq, D = q.shape
    _, S, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    qg = q.reshape(B, Hkv, G, D)
    scores = torch.einsum("bhgd,bshd->bhgs", qg.float(), k.float()) * scale
    pos = torch.arange(S, device=q.device)
    mask = pos[None, None, None, :] < lengths[:, None, None, None]
    scores = scores.masked_fill(~mask, float("-inf"))
    m = scores.amax(dim=-1)
    p = torch.exp(scores - torch.where(torch.isfinite(m), m, 0.0)[..., None])
    l = p.sum(dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v.float()) \
        / torch.where(l > 0, l, 1.0)[..., None]
    return (out.reshape(B, Hq, D).to(q.dtype), m.reshape(B, Hq),
            l.reshape(B, Hq))


# ---------------------------------------------------------------- linear_scan
#: steps a chunk and rows a sub-chunk, shared with the CUDA kernel
#: (``kChunk`` / ``kSub`` in ``csrc/linear_scan.cu``)
CHUNK = 64
SUB = 16


def _intra_chunk_scores(qq: torch.Tensor, kk: torch.Tensor,
                        cum: torch.Tensor) -> torch.Tensor:
    """Exact, overflow-free masked intra-chunk attention scores.

    qq, kk, cum: (..., L, dk), any leading dims (the port runs every chunk
    of every (b, h) at once).  Returns (..., L, L):

        S[t, s] = sum_d q[t,d] k[s,d] exp(cum[t,d] - cum[s,d]) for s <= t,
        else 0.

    Stability: for each row sub-chunk j, factor through the base b_j =
    decay-prefix at the sub-chunk start, which lies BETWEEN s and t, so both
    exponents (cum_t - b_j) and (b_j - cum_s) are <= 0 — no clamping needed.
    The diagonal sub-blocks use the direct (sub, sub, dk) form (also <= 0).
    """
    L = qq.shape[-2]
    sub = min(SUB, L)
    while L % sub:
        sub -= 1
    t_idx = torch.arange(L, device=qq.device)
    tri = torch.tril(torch.ones(sub, sub, dtype=torch.bool,
                                device=qq.device))
    rows = []
    for lo in range(0, L, sub):
        b = cum[..., lo:lo + 1, :]                          # (..., 1, dk)
        cd = cum[..., lo:lo + sub, :]
        q_j = qq[..., lo:lo + sub, :] * torch.exp(cd - b)
        # columns strictly before this sub-chunk
        k_pre = kk * torch.exp(torch.clamp(b - cum, max=0.0))
        pre = q_j @ k_pre.transpose(-1, -2)                 # (..., sub, L)
        pre = torch.where(t_idx < lo, pre, 0.0)
        # exact diagonal block
        diff = cd[..., :, None, :] - cd[..., None, :, :]    # (.., sub, sub, dk)
        blk = torch.sum(qq[..., lo:lo + sub, None, :]
                        * kk[..., None, lo:lo + sub, :]
                        * torch.exp(torch.clamp(diff, max=0.0)), dim=-1)
        blk = torch.where(tri, blk, 0.0)
        rows.append(pre + F.pad(blk, (lo, L - lo - sub)))
    return torch.cat(rows, dim=-2)                          # (..., L, L)


def linear_scan_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        log_decay: torch.Tensor) -> torch.Tensor:
    """Plain chunked GLA scan: the kernel's algorithm (three GEMMs a chunk,
    an f32 (dk, dv) state carried across chunks), in v's dtype.

    The intra-chunk scores and the decay factors of every chunk are computed
    at once; only the carried state walks the chunks in order.  The chunk
    (``CHUNK`` steps) shrinks until it divides T, as in the JAX version.
    Differentiable: it is what ``ops.linear_scan``'s backward runs autograd
    through.
    """
    B, H, T, dk = q.shape
    dv = v.shape[-1]
    chunk = min(CHUNK, T)
    while T % chunk:
        chunk -= 1
    n = T // chunk
    qc = q.float().reshape(B, H, n, chunk, dk)
    kc = k.float().reshape(B, H, n, chunk, dk)
    vc = v.float().reshape(B, H, n, chunk, dv)
    cum = torch.cumsum(log_decay.float().reshape(B, H, n, chunk, dk), dim=-2)
    tot = cum[..., -1:, :]                                  # (B, H, n, 1, dk)
    q_in = qc * torch.exp(cum)                              # <= 0 exponents
    k_in = kc * torch.exp(tot - cum)                        # <= 0
    ys = _intra_chunk_scores(qc, kc, cum) @ vc              # (B, H, n, L, dv)
    h = q.new_zeros((B, H, dk, dv), dtype=torch.float32)
    out = []
    for c in range(n):
        out.append(ys[:, :, c] + q_in[:, :, c] @ h)
        h = tot[:, :, c].transpose(-1, -2).exp() * h \
            + k_in[:, :, c].transpose(-1, -2) @ vc[:, :, c]
    return torch.stack(out, dim=2).reshape(B, H, T, dv).to(v.dtype)


def linear_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_decay: torch.Tensor) -> torch.Tensor:
    """Gated linear attention / SSM scan (rwkv6 and mamba2 core), one step
    at a time: the exact recurrence, the ground truth of both the chunked
    version and the kernel.

    Over t, with state h: (dk, dv) per (b, h):
        h_t = exp(log_decay_t)[:, None] * h_{t-1} + k_t^T v_t
        y_t = q_t @ h_t

    q/k: (B, H, T, dk); v: (B, H, T, dv); log_decay: (B, H, T, dk) (<= 0).
    Returns (B, H, T, dv) in v's dtype, computed in f32.
    """
    B, H, T, dk = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    w = torch.exp(log_decay.float())
    h = q.new_zeros((B, H, dk, v.shape[-1]), dtype=torch.float32)
    out = []
    for t in range(T):
        h = h * w[:, :, t, :, None] + kf[:, :, t, :, None] * vf[:, :, t, None]
        out.append((qf[:, :, t, None, :] @ h)[:, :, 0])
    return torch.stack(out, dim=2).to(v.dtype)
