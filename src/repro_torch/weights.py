"""Carry the JAX package's parameters into the port's tensors.

Conv networks (``to_torch_weights``): the input is what
``init_graph_weights`` returns (per-layer numpy arrays, identical in both
packages for one seed), ``np.asarray`` of a jax array, or anything
``torch.as_tensor`` takes; each weight is checked against
``weight_shape(wl)`` (a 1x1 layer may come squeezed as ``(C, M)``) and each
bias against ``(M,)``.

LMs (``to_torch_lm_params``): the input is the JAX parameter pytree as
numpy (``jax.tree.map(np.asarray, model.init(key))``), with its stacked
leading layer axis; each leaf is checked against the port's
``param_specs``.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.dataflow import ConvWorkload
from repro_torch.core.workloads import weight_shape
from repro_torch.device import resolve_device
from repro_torch.models.lm import param_specs


def to_torch_weights(weights: Sequence, biases: Optional[Sequence] = None, *,
                     layers: Sequence[ConvWorkload],
                     device: str | torch.device = "cuda"
                     ) -> Tuple[List[torch.Tensor],
                                Optional[List[Optional[torch.Tensor]]]]:
    """``(weights, biases)`` as float32 tensors on ``device``, shape-checked
    against ``layers``; ``biases`` stays None when not given."""
    dev = resolve_device(device)
    if len(weights) != len(layers):
        raise ValueError(f"{len(weights)} weights for {len(layers)} layers")
    if biases is not None and len(biases) != len(layers):
        raise ValueError(f"{len(biases)} biases for {len(layers)} layers")
    ws = []
    for wl, w in zip(layers, weights):
        shape = weight_shape(wl)
        got = tuple(np.shape(w))
        if got != shape and not (wl.R == wl.S == 1 and got == shape[-2:]):
            raise ValueError(f"layer {wl.name}: weight shape {got} != "
                             f"{shape}")
        ws.append(torch.as_tensor(np.asarray(w, np.float32)).to(dev))
    if biases is None:
        return ws, None
    bs: List[Optional[torch.Tensor]] = []
    for wl, b in zip(layers, biases):
        if b is None:
            bs.append(None)
            continue
        if tuple(np.shape(b)) != (wl.M,):
            raise ValueError(f"layer {wl.name}: bias shape "
                             f"{tuple(np.shape(b))} != ({wl.M},)")
        bs.append(torch.as_tensor(np.asarray(b, np.float32)).to(dev))
    return ws, bs


def _leaves(tree: Mapping, prefix: str = "") -> Iterator[Tuple[str, object]]:
    for name, val in tree.items():
        if isinstance(val, Mapping):
            yield from _leaves(val, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", val


def to_torch_lm_params(params: Mapping, cfg: ArchConfig,
                       device: str | torch.device = "cuda"
                       ) -> Dict[str, torch.Tensor]:
    """The JAX LM parameter tree as the port's named tensors on ``device``.

    ``params`` is nested like ``repro.models.LMModel.param_specs()``
    (``embed``, ``final_norm``, ``layers`` with a leading layer axis on
    every leaf, ``lm_head`` when the head is untied; a hybrid's ``shared``
    block, which has no layer axis, is carried as it is), its leaves numpy
    arrays (bf16 ones included).  The result has one entry per layer
    (``layers.<i>.mixer.wq``, ...), in ``cfg``'s dtype, and goes to
    ``LMModel.load_params`` or ``ServeEngine(weights=...)``.  A missing or
    unexpected leaf, or a shape that is not the port's, raises
    ``ValueError``.
    """
    dev = resolve_device(device)
    specs = param_specs(cfg)
    L = cfg.n_layers
    flat: Dict[str, np.ndarray] = {}
    for path, leaf in _leaves(params):
        a = np.asarray(leaf)
        if not path.startswith("layers."):
            flat[path] = a
            continue
        if a.shape[:1] != (L,):
            raise ValueError(f"{path}: shape {a.shape} has no leading layer "
                             f"axis of {L}")
        for i in range(L):
            flat[f"layers.{i}.{path[len('layers.'):]}"] = a[i]
    if set(flat) != set(specs):
        missing = sorted(set(specs) - set(flat))[:5]
        extra = sorted(set(flat) - set(specs))[:5]
        raise ValueError(f"{cfg.name}: parameter tree differs from the "
                         f"port's: missing {missing}, unexpected {extra}")
    out = {}
    for name, (shape, dtype) in specs.items():
        a = flat[name]
        if a.shape != shape:
            raise ValueError(f"{name}: shape {a.shape} != {shape}")
        # via an f32 copy: exact for f32 and bf16 leaves (numpy has no bf16)
        out[name] = torch.from_numpy(np.array(a, np.float32)).to(dev, dtype)
    return out
