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

from typing import (Any, Dict, Iterator, List, Mapping, NamedTuple,
                    Optional, Sequence, Tuple)

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.dataflow import ConvWorkload
from repro_torch.core.workloads import weight_shape
from repro_torch.device import resolve_device
from repro_torch.models.lm import param_specs
from repro_torch.optim.adamw import AdamWState


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


def _to_tensor(a, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    """A numpy leaf as a ``dtype`` tensor on ``dev``: bf16 patterns (``V2``)
    bit for bit, any other leaf via an f32 copy (exact for f32 and bf16;
    numpy has no bf16 of its own)."""
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        t = torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, np.float32))
    return t.to(dev, dtype)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor on the host as numpy; a bf16 one as its patterns (``V2``)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view("V2")
    return t.cpu().numpy()


def _unstack(params: Mapping, cfg: ArchConfig, dev: torch.device,
             dtype: Optional[torch.dtype]) -> Dict[str, torch.Tensor]:
    """``repro``'s stacked tree as the port's named tensors, each in
    ``dtype`` (None: the spec's)."""
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
    for name, (shape, spec_dtype) in specs.items():
        a = flat[name]
        if a.shape != shape:
            raise ValueError(f"{name}: shape {a.shape} != {shape}")
        out[name] = _to_tensor(a, dtype or spec_dtype, dev)
    return out


def _put(tree: Dict, path: str, value) -> None:
    """Set ``tree[a][b][c] = value`` for the dotted ``path`` ``a.b.c``."""
    *parents, leaf = path.split(".")
    for part in parents:
        tree = tree.setdefault(part, {})
    tree[leaf] = value


def _stacked_names(specs: Mapping
                   ) -> Iterator[Tuple[str, str, Optional[str]]]:
    """(``repro`` leaf path, the port's name of it or of its layer 0, the
    per-layer suffix or None) for every leaf of the stacked tree, in
    ``specs``' order."""
    prefix = "layers.0."
    for name in specs:
        if name.startswith(prefix):
            rest = name[len(prefix):]
            yield f"layers.{rest}", name, rest
        elif not name.startswith("layers."):
            yield name, name, None


def _stack(named: Mapping[str, torch.Tensor], cfg: ArchConfig) -> Dict:
    """The port's named tensors as ``repro``'s nested tree of numpy arrays,
    per-layer leaves stacked on a leading layer axis."""
    specs = param_specs(cfg)
    if set(named) != set(specs):
        missing = sorted(set(specs) - set(named))[:5]
        extra = sorted(set(named) - set(specs))[:5]
        raise ValueError(f"{cfg.name}: parameter names differ from the "
                         f"port's: missing {missing}, unexpected {extra}")
    tree: Dict = {}
    for path, name, rest in _stacked_names(specs):
        _put(tree, path, _to_numpy(named[name]) if rest is None else
             np.stack([_to_numpy(named[f"layers.{i}.{rest}"])
                       for i in range(cfg.n_layers)]))
    return tree


def to_torch_lm_params(params: Mapping, cfg: ArchConfig,
                       device: str | torch.device = "cuda"
                       ) -> Dict[str, torch.Tensor]:
    """The JAX LM parameter tree as the port's named tensors on ``device``.

    ``params`` is nested like ``repro.models.LMModel.param_specs()``
    (``embed``, ``final_norm``, ``layers`` with a leading layer axis on
    every leaf, ``lm_head`` when the head is untied; a hybrid's ``shared``
    block, which has no layer axis, is carried as it is), its leaves numpy
    arrays (bf16 ones included, as ``ml_dtypes`` arrays or as ``V2``
    patterns).  The result has one entry per layer
    (``layers.<i>.mixer.wq``, ...), in ``cfg``'s dtype, and goes to
    ``LMModel.load_params`` or ``ServeEngine(weights=...)``.  A missing or
    unexpected leaf, or a shape that is not the port's, raises
    ``ValueError``.
    """
    return _unstack(params, cfg, resolve_device(device), None)


def to_repro_lm_params(named: Mapping[str, torch.Tensor], cfg: ArchConfig
                       ) -> Dict:
    """The exact inverse of ``to_torch_lm_params``: the port's named
    tensors (``LMModel.params()``) as ``repro``'s nested tree of numpy
    arrays, per-layer leaves stacked on a leading layer axis, each in its
    own dtype (bf16 as ``V2`` patterns)."""
    return _stack(named, cfg)


class ReproAdamWState(NamedTuple):
    """``repro``'s optimizer state as numpy: the step a 0-d int32 array,
    ``mu``, ``nu`` and ``master`` f32 trees shaped like its params.  The
    fields are ``repro.optim.adamw.AdamWState``'s, in its order, which is
    the order ``repro_torch.checkpoint`` flattens and names them in."""
    step: np.ndarray
    mu: Dict[str, Any]
    nu: Dict[str, Any]
    master: Dict[str, Any]


def to_repro_adamw_state(state: AdamWState, cfg: ArchConfig
                         ) -> ReproAdamWState:
    """The port's ``AdamWState`` in ``repro``'s layout, its trees stacked
    as ``to_repro_lm_params`` stacks the params."""
    return ReproAdamWState(step=np.asarray(state.step, np.int32),
                           mu=_stack(state.mu, cfg),
                           nu=_stack(state.nu, cfg),
                           master=_stack(state.master, cfg))


def to_torch_adamw_state(tree, cfg: ArchConfig,
                         device: str | torch.device = "cuda") -> AdamWState:
    """The inverse of ``to_repro_adamw_state``: ``tree`` (that layout, or
    ``repro``'s own ``AdamWState`` as numpy) as the port's state, its f32
    tensors named per layer on ``device``."""
    dev = resolve_device(device)
    return AdamWState(
        step=int(np.asarray(tree.step)),
        mu=_unstack(tree.mu, cfg, dev, torch.float32),
        nu=_unstack(tree.nu, cfg, dev, torch.float32),
        master=_unstack(tree.master, cfg, dev, torch.float32))


def repro_lm_template(cfg: ArchConfig, dtype: Optional[torch.dtype] = None
                      ) -> Dict:
    """``to_repro_lm_params``'s layout as uninitialised numpy arrays of its
    shapes, in ``dtype`` (None: each parameter's own), a restore template
    that holds no data."""
    specs = param_specs(cfg)
    tree: Dict = {}
    for path, name, rest in _stacked_names(specs):
        shape, spec_dtype = specs[name]
        if rest is not None:
            shape = (cfg.n_layers,) + tuple(shape)
        dt = dtype or spec_dtype
        np_dtype = np.dtype("V2") if dt == torch.bfloat16 else \
            torch.empty((), dtype=dt).numpy().dtype
        _put(tree, path, np.empty(shape, np_dtype))
    return tree


def repro_adamw_template(cfg: ArchConfig) -> ReproAdamWState:
    """``to_repro_adamw_state``'s layout as uninitialised numpy arrays."""
    return ReproAdamWState(step=np.zeros((), np.int32),
                           mu=repro_lm_template(cfg, torch.float32),
                           nu=repro_lm_template(cfg, torch.float32),
                           master=repro_lm_template(cfg, torch.float32))
