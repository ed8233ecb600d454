"""The plain reference: a configuration's network in plain PyTorch.

It reads the layers and residual edges from the configuration file and works
the network out again from the weights and inputs it is handed, in canonical
NHWC order: no plan, no layouts, no block permutations, no kernel of the
port.  It imports nothing of the program.

* Between consecutive layers whose shapes differ, the adapter: a larger
  spatial axis is subsampled by its integer ratio and cropped, a smaller one
  zero-padded symmetrically (the lower side gets the floor of half), and
  channels are truncated or zero-padded at the end.
* A convolution is valid (a layer's H and W include its padding): the sum
  over its R*S taps of a (rows, C) x (C, M) product, each a plain matmul.
  A depthwise layer (C 1, M above 1, a window above 1x1) multiplies each
  tap by its channel's filter.
* A residual edge (src, dst) adds src's output, through the same adapter,
  to dst's output.

fp32 with TF32 off.  ``tf32=True`` computes the products in TF32, the
precision just below the configuration's: the control that the check has
to fail.  On the card that is the tensor cores' TF32; on the CPU, which has
none, each product's operands are rounded to TF32's 10-bit mantissa first.
"""
from __future__ import annotations

import contextlib
from typing import List, Sequence

import torch
import torch.nn.functional as F

from .count import in_extent, is_depthwise


def adapt(a: torch.Tensor, H: int, W: int, C: int) -> torch.Tensor:
    """``a`` (N, h, w, c) brought to (N, H, W, C)."""
    _, h, w, c = a.shape
    if h > H:
        a = a[:, ::h // H][:, :H]
    elif h < H:
        lo = (H - h) // 2
        a = F.pad(a, (0, 0, 0, 0, lo, H - h - lo))
    if w > W:
        a = a[:, :, ::w // W][:, :, :W]
    elif w < W:
        lo = (W - w) // 2
        a = F.pad(a, (0, 0, lo, W - w - lo))
    if c > C:
        a = a[..., :C]
    elif c < C:
        a = F.pad(a, (0, C - c))
    return a


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits), to nearest, ties to even."""
    b = x.contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    b = (b + 0xFFF + lsb) & ~0x1FFF
    return b.view(torch.float32)


@contextlib.contextmanager
def precision(tf32: bool):
    """cuBLAS and cuDNN in TF32 or not, restored after."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def _taps(x: torch.Tensor, r: int, s: int, P: int, Q: int, stride: int):
    return x[:, r:r + (P - 1) * stride + 1:stride,
             s:s + (Q - 1) * stride + 1:stride, :]


def layer(x: torch.Tensor, L: dict, w: torch.Tensor,
          emulate_tf32: bool) -> torch.Tensor:
    """One valid convolution of ``x`` (N, H, W, C) with ``w``
    ((R, S, C, M), or (R, S, M) depthwise)."""
    N = x.shape[0]
    P, Q, M, st = L["P"], L["Q"], L["M"], L["stride"]
    if emulate_tf32:
        x, w = round_tf32(x), round_tf32(w)
    y = torch.zeros((N, P, Q, M), dtype=torch.float32, device=x.device)
    for r in range(L["R"]):
        for s in range(L["S"]):
            t = _taps(x, r, s, P, Q, st)
            if is_depthwise(L):
                y += t * w[r, s]
            else:
                y += (t.reshape(-1, t.shape[-1]) @ w[r, s]).reshape(y.shape)
    return y


def forward(config: dict, weights: Sequence[torch.Tensor], x: torch.Tensor,
            tf32: bool = False) -> torch.Tensor:
    """The network's output (N, P, Q, M) for inputs ``x`` (N, H, W, C).

    ``weights[i]`` is layer i's as the configuration declares it:
    (R, S, C, M), or (R, S, M) for a depthwise layer.  Only the channels a
    layer receives are contracted: the adapter drops the rest.
    """
    layers = config["layers"]
    emulate = tf32 and x.device.type == "cpu"
    outs: List[torch.Tensor] = []
    cur = x.float()
    with precision(tf32), torch.no_grad():
        for i, L in enumerate(layers):
            dw = is_depthwise(L)
            c_in = L["M"] if dw else L["C"]
            a = adapt(cur, in_extent(L, "P"), in_extent(L, "Q"), c_in)
            y = layer(a, L, weights[i].float(), emulate)
            for s, d in config["skip_edges"]:
                if d == i:
                    y = y + adapt(outs[s], L["P"], L["Q"], L["M"])
            outs.append(y)
            cur = y
    return outs[-1]
