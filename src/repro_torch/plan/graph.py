"""Layer-graph IR for network-level dataflow/layout planning.

A ``LayerGraph`` is the planner's view of a network: an ordered chain of
compute layers (``ConvWorkload``s) plus *skip edges* for residual/branch
connections.  The chain edge (i, i+1) carries layer i's oAct tensor to layer
i+1; a skip edge (j, k) says layer j's output is ALSO consumed at layer k
(a residual add), so the tensor at boundary j must be readable in layer k's
input layout too — if the two boundaries disagree, the planner charges a
relayout for the skip tensor.

Adapters build graphs from the paper's evaluation workloads
(``core.workloads``: ResNet-50 / MobileNet-V3 / BERT) and from the LM
architecture configs (``repro.configs``), whose transformer stacks become
per-layer GEMM chains with residual edges around attention and MLP.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import List, Sequence, Tuple

from repro_torch.core.dataflow import ConvWorkload
from repro_torch.core.workloads import (bert_layers, input_channels,
                                  mobilenet_v3_layers, resnet50_layers)


@dataclasses.dataclass(frozen=True)
class LayerGraph:
    """Planner IR: layers in execution order + skip (residual/branch) edges.

    ``skip_edges`` are (src, dst) pairs, src < dst: the tensor at boundary
    ``src`` (output of ``layers[src]``) is re-consumed at layer ``dst``.
    """

    name: str
    layers: Tuple[ConvWorkload, ...]
    skip_edges: Tuple[Tuple[int, int], ...] = ()

    def __post_init__(self):
        n = len(self.layers)
        for s, d in self.skip_edges:
            if not (0 <= s < d < n):
                raise ValueError(f"bad skip edge ({s}, {d}) in {n}-layer graph")

    def __len__(self) -> int:
        return len(self.layers)

    def skips_into(self, dst: int) -> List[int]:
        """Sources of skip edges landing at layer ``dst``."""
        return [s for s, d in self.skip_edges if d == dst]

    def buffer_sources(self) -> List[int]:
        """Layers whose output the executor must buffer (skip-edge sources),
        in execution order — everything else is dead after its consumer."""
        return sorted({s for s, _ in self.skip_edges})

    def input_shape(self) -> Tuple[int, int, int, int]:
        """Canonical NHWC input tensor shape the first layer reads."""
        wl = self.layers[0]
        return (wl.N, wl.H, wl.W, input_channels(wl))

    def graph_hash(self) -> str:
        """Stable content hash — the plan-cache key component."""
        h = hashlib.sha256()
        h.update(self.name.encode())
        for wl in self.layers:
            h.update(repr((wl.name, wl.N, wl.M, wl.C, wl.P, wl.Q, wl.R, wl.S,
                           wl.stride)).encode())
        h.update(repr(tuple(sorted(self.skip_edges))).encode())
        return h.hexdigest()

    def with_batch(self, batch: int) -> "LayerGraph":
        """The same network at batch extent ``batch`` (every layer's N).

        Serving plans the graph at the engine's maximum batch size so the
        plan tile's batch extent bounds dynamic batch assembly; the batch is
        part of the workload dims, so the rebatched graph hashes (and is
        planned and cached) separately from the original.
        """
        if batch < 1:
            raise ValueError(f"batch {batch} < 1")
        if all(wl.N == batch for wl in self.layers):
            return self
        return dataclasses.replace(
            self, layers=tuple(dataclasses.replace(wl, N=batch)
                               for wl in self.layers))


def from_layers(layers: Sequence[ConvWorkload], name: str = "chain",
                skip_edges: Sequence[Tuple[int, int]] = ()) -> LayerGraph:
    """Wrap a plain layer list (e.g. ``core.workloads``) as a linear chain."""
    return LayerGraph(name=name, layers=tuple(layers),
                      skip_edges=tuple(skip_edges))


def resnet50_graph() -> LayerGraph:
    """The ResNet-50 evaluation subset with bottleneck residual edges.

    The sampled layers are one bottleneck per stage; the residual shortcut
    skips the (reduce, 3x3, expand) triple, i.e. the block input (output of
    the previous expand) is re-consumed at the add after the expand.
    """
    layers = resnet50_layers()
    # indices: 0 conv1 | 1-3 l2 (1x1, 3x3, expand) | 4-6 l3 | 7-9 l4 | 10-11 l5
    skips = ((0, 3), (3, 6), (6, 9))
    return LayerGraph(name="resnet50", layers=tuple(layers), skip_edges=skips)


def mobilenet_v3_graph() -> LayerGraph:
    """MobileNet-V3 subset: inverted residuals connect pointwise boundaries."""
    layers = mobilenet_v3_layers()
    # pw2 (idx 4) -> pw3 output (idx 5): the stride-1 inverted-residual add
    skips = ((4, 5),)
    return LayerGraph(name="mobilenet_v3", layers=tuple(layers),
                      skip_edges=skips)


def bert_graph(seq: int = 512, d: int = 768, heads: int = 12,
               layers_sampled: int = 4) -> LayerGraph:
    """BERT GEMM chain with residual edges around attention and FFN.

    Per encoder layer: [qkv, attn-out, ffn-up, ffn-dn]; the residual stream
    skips (qkv, attn-out) and (ffn-up, ffn-dn).
    """
    layers = bert_layers(seq=seq, d=d, heads=heads,
                         layers_sampled=layers_sampled)
    skips: List[Tuple[int, int]] = []
    for i in range(layers_sampled):
        base = 4 * i
        if base > 0:
            skips.append((base - 1, base + 1))      # stream into attn-out add
        skips.append((base + 1, base + 3))          # attn-out into ffn-dn add
    return LayerGraph(name=f"bert-s{seq}", layers=tuple(layers),
                      skip_edges=tuple(skips))


def from_arch_config(cfg, seq: int = 512,
                     layers_sampled: int | None = None) -> LayerGraph:
    """Build a GEMM layer graph from a ``repro.configs`` ArchConfig.

    Each transformer block contributes its projection GEMMs (qkv, attn-out,
    gate/up, down) at batch=`seq` tokens; the residual stream adds skip edges
    around the attention and MLP groups.  MoE blocks plan the expert GEMM at
    per-expert token share; SSM blocks contribute their in/out projections.
    """
    D = cfg.d_model
    n = layers_sampled if layers_sampled is not None else min(cfg.n_layers, 2)
    G = ConvWorkload.from_gemm
    layers: List[ConvWorkload] = []
    skips: List[Tuple[int, int]] = []
    for i in range(n):
        base = len(layers)
        if cfg.family == "ssm":
            di = cfg.d_inner or 2 * D
            layers += [
                G(M=5 * di, N=seq, K=D, name=f"{cfg.name}-L{i}-ssm-in"),
                G(M=D, N=seq, K=di, name=f"{cfg.name}-L{i}-ssm-out"),
            ]
            if base > 0:
                skips.append((base - 1, base + 1))
            continue
        dh, H, Hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        F = cfg.d_ff
        up_mult = 2 if cfg.act == "swiglu" else 1
        if cfg.family == "moe" and cfg.top_k:
            # active-expert GEMMs at the per-expert token share
            toks = max(1, seq * cfg.top_k // max(cfg.n_experts, 1))
        else:
            toks = seq
        layers += [
            G(M=(H + 2 * Hkv) * dh, N=seq, K=D, name=f"{cfg.name}-L{i}-qkv"),
            G(M=D, N=seq, K=H * dh, name=f"{cfg.name}-L{i}-attnout"),
            G(M=up_mult * F, N=toks, K=D, name=f"{cfg.name}-L{i}-ffn-up"),
            G(M=D, N=toks, K=F, name=f"{cfg.name}-L{i}-ffn-dn"),
        ]
        if base > 0:
            skips.append((base - 1, base + 1))      # residual into attn-out
        skips.append((base + 1, base + 3))          # residual into ffn-down
    return LayerGraph(name=f"{cfg.name}-s{seq}", layers=tuple(layers),
                      skip_edges=tuple(skips))
