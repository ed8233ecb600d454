"""Paper evaluation workloads: ResNet-50 / MobileNet-V3 / BERT layer shapes.

A representative subset of layers (the paper evaluates per-layer and reports
geomeans); shapes are the standard published layer dims.

Besides the layer lists, this module owns the *execution-side* view of a
``ConvWorkload``: which layers are depthwise (the Mob-V3 dw layers are
modeled as ``C == 1`` with ``M`` = channels), what shape their weight tensor
takes, and a seeded initializer so the plan executor and its reference
oracle agree on concrete weights for a whole graph.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .dataflow import ConvWorkload


def is_depthwise(wl: ConvWorkload) -> bool:
    """Mob-V3 style depthwise layer: per-channel RxS filters, no C reduction.

    The analytical model stores these as ``C == 1`` with ``M`` = channel
    count; a 1x1 layer with C == 1 is a degenerate dense conv, not depthwise.
    """
    return wl.C == 1 and wl.M > 1 and (wl.R > 1 or wl.S > 1)


def input_channels(wl: ConvWorkload) -> int:
    """Channels the layer actually reads (M for depthwise, C otherwise)."""
    return wl.M if is_depthwise(wl) else wl.C


def weight_shape(wl: ConvWorkload) -> Tuple[int, ...]:
    """Natural weight tensor shape: (R, S, M) depthwise, else (R, S, C, M)."""
    if is_depthwise(wl):
        return (wl.R, wl.S, wl.M)
    return (wl.R, wl.S, wl.C, wl.M)


def init_graph_weights(layers: List[ConvWorkload] | Tuple[ConvWorkload, ...],
                       seed: int = 0) -> List[np.ndarray]:
    """Seeded fp32 weights for every layer (1/sqrt(fan-in) scaled normals).

    Shared by the plan executor tests, the example, and the executed
    benchmark so all paths run the *same* concrete network.
    """
    rng = np.random.default_rng(seed)
    out: List[np.ndarray] = []
    for wl in layers:
        shape = weight_shape(wl)
        fan_in = wl.R * wl.S * (1 if is_depthwise(wl) else wl.C)
        out.append((rng.normal(size=shape) / np.sqrt(fan_in))
                   .astype(np.float32))
    return out


def resnet50_layers() -> List[ConvWorkload]:
    L = ConvWorkload
    return [
        L(N=1, M=64, C=3, P=112, Q=112, R=7, S=7, stride=2, name="res50-conv1"),
        L(N=1, M=64, C=64, P=56, Q=56, R=1, S=1, name="res50-l2-1x1"),
        L(N=1, M=64, C=64, P=56, Q=56, R=3, S=3, name="res50-l2-3x3"),
        L(N=1, M=256, C=64, P=56, Q=56, R=1, S=1, name="res50-l2-expand"),
        L(N=1, M=128, C=256, P=28, Q=28, R=1, S=1, name="res50-l3-reduce"),
        L(N=1, M=128, C=128, P=28, Q=28, R=3, S=3, name="res50-l3-3x3"),
        L(N=1, M=512, C=256, P=28, Q=28, R=1, S=1, name="res50-l3-expand"),
        L(N=1, M=256, C=512, P=14, Q=14, R=1, S=1, name="res50-l4-reduce"),
        L(N=1, M=256, C=256, P=14, Q=14, R=3, S=3, name="res50-l47-3x3"),
        L(N=1, M=1024, C=512, P=14, Q=14, R=1, S=1, name="res50-l4-expand"),
        L(N=1, M=512, C=2048, P=7, Q=7, R=1, S=1, name="res50-l5-reduce"),
        L(N=1, M=512, C=512, P=7, Q=7, R=3, S=3, name="res50-l5-3x3"),
    ]


def mobilenet_v3_layers() -> List[ConvWorkload]:
    """Mob-V3 mixes pointwise (1x1) and depthwise convs (C==1 per group ->
    modeled as C=1 with M=channels)."""
    L = ConvWorkload
    return [
        L(N=1, M=16, C=3, P=112, Q=112, R=3, S=3, stride=2, name="mbv3-conv1"),
        L(N=1, M=16, C=1, P=112, Q=112, R=3, S=3, name="mbv3-dw1"),
        L(N=1, M=64, C=16, P=56, Q=56, R=1, S=1, name="mbv3-pw1"),
        L(N=1, M=64, C=1, P=56, Q=56, R=3, S=3, stride=2, name="mbv3-dw2"),
        L(N=1, M=24, C=64, P=28, Q=28, R=1, S=1, name="mbv3-pw2"),
        L(N=1, M=72, C=24, P=28, Q=28, R=1, S=1, name="mbv3-pw3"),
        L(N=1, M=72, C=1, P=28, Q=28, R=5, S=5, stride=2, name="mbv3-dw3"),
        L(N=1, M=40, C=72, P=14, Q=14, R=1, S=1, name="mbv3-pw4"),
        L(N=1, M=120, C=40, P=14, Q=14, R=1, S=1, name="mbv3-pw5"),
        L(N=1, M=120, C=1, P=14, Q=14, R=5, S=5, name="mbv3-dw4"),
        L(N=1, M=960, C=160, P=7, Q=7, R=1, S=1, name="mbv3-pw-head"),
    ]


def bert_layers(seq: int = 512, d: int = 768, heads: int = 12,
                layers_sampled: int = 4) -> List[ConvWorkload]:
    """BERT-base GEMMs as 1x1 convs: QKV, attn-out, FFN up/down."""
    out: List[ConvWorkload] = []
    for i in range(layers_sampled):
        out += [
            ConvWorkload.from_gemm(M=3 * d, N=seq, K=d, name=f"bert{i}-qkv"),
            ConvWorkload.from_gemm(M=d, N=seq, K=d, name=f"bert{i}-attnout"),
            ConvWorkload.from_gemm(M=4 * d, N=seq, K=d, name=f"bert{i}-ffn-up"),
            ConvWorkload.from_gemm(M=d, N=seq, K=4 * d, name=f"bert{i}-ffn-dn"),
        ]
    return out


WORKLOADS = {
    "resnet50": resnet50_layers,
    "mobilenet_v3": mobilenet_v3_layers,
    "bert": bert_layers,
}
