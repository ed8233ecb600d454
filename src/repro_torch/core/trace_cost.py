"""Per-device cost of one step, counted as eager PyTorch runs it.

The counterpart of ``repro.core.hlo_cost``.  Where ``repro`` walks the
compiled HLO of a step, the port counts the step while it runs: ``Counter``
is a ``TorchDispatchMode`` that sees every operator the step issues after
autograd (the forward, the remat recompute and the backward) and keeps
per-device totals of

* **operations**, by the unit that runs them: matmul, bmm, addmm,
  convolution and SDPA as ``torch.utils.flop_counter`` reckons them (2 a
  multiply-add), on the tensor cores for a 2-byte type (``"bf16"``) and on
  the CUDA cores otherwise (``"fp32"``: the port keeps TF32 off); plus each
  kernel operator's own count (``kernels.ops.WORK``, the kernel modules'
  ``work``) on the unit its kernel runs it on, recorded under the kernel's
  name.  A kernel operator is one op here: its plain version's inner ops
  are not seen.
* **bytes**: the operands plus the results of every ``aten`` operator.
  Eager PyTorch runs unfused, so this is its real HBM traffic; it is the
  opposite of ``hlo_cost``'s fusion rule, which counts a fusion's result
  only.  A view (a result on an operand's storage) moves nothing; an
  in-place op counts its operands; an allocation (``empty``) counts
  nothing; an indexing op counts the rows it touches (its result or its
  values twice, and its indices), not the whole tensor it indexes.  A
  kernel counts by its own formula.
* **collective bytes**, by kind and by mesh dimension: the result bytes of
  every call of ``repro_torch.distributed.collectives`` (its ``BYTES``),
  as ``hlo_cost`` counts a collective's result.
* **peak live bytes**: the storages born under the counter and not yet
  freed, at their peak: the counterpart of XLA's
  ``memory_analysis().temp_size_in_bytes``.  The step's arguments are not
  in it.

It counts every layer and every microbatch as eager execution runs them,
so ``repro``'s loop-once numbers (``xla_loop_once``) have no counterpart
and no trip count is parsed.  Every count comes from shapes and types
alone, so a step counts the same, bit for bit, on real CUDA tensors and on
fake ones (``FakeTensorMode``) of the same shapes.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

#: allocations: their results are written by the op that fills them
_ALLOC = {"empty", "empty_strided", "new_empty", "new_empty_strided",
          "empty_like"}
#: reads a subset of its first operand's rows: result x 2 + indices
_GATHER = {"index", "index_select", "gather", "embedding", "take"}
#: writes a subset of its first operand's rows: values x 2 + indices
_SCATTER = {"index_put", "index_put_", "_index_put_impl_", "scatter",
            "scatter_", "scatter_add", "scatter_add_", "index_add",
            "index_add_", "index_copy", "index_copy_", "scatter_reduce",
            "scatter_reduce_", "embedding_dense_backward",
            "index_select_backward"}


def _flop_registry():
    from torch.utils.flop_counter import flop_registry
    return flop_registry


def unit_of(dtype: torch.dtype) -> str:
    """The compute unit an operator on ``dtype`` runs on."""
    return "bf16" if dtype in (torch.bfloat16, torch.float16) else "fp32"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


@dataclasses.dataclass
class Counts:
    """What one ``Counter`` saw."""
    flops: Dict[str, float] = dataclasses.field(default_factory=dict)
    bytes: float = 0.0
    collective_kinds: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    kernels: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    peak_live_bytes: int = 0
    ops: int = 0

    @property
    def total_flops(self) -> float:
        return sum(self.flops.values())

    @property
    def collective_bytes(self) -> float:
        return sum(b for kind in self.collective_kinds.values()
                   for b in kind.values())

    def collective_by_axis(self) -> Dict[str, float]:
        """The collective bytes by the mesh axis whose link they ride: the
        flattened ``pod+data`` group crosses the pod axis's slower link;
        a group of no mesh (``group``) counts as ``data``."""
        out: Dict[str, float] = {}
        for kind in self.collective_kinds.values():
            for dim, b in kind.items():
                axis = "data" if dim == "group" else dim.split("+")[0]
                out[axis] = out.get(axis, 0.0) + b
        return out

    def to_dict(self) -> Dict:
        return {"flops": dict(self.flops), "total_flops": self.total_flops,
                "bytes": self.bytes,
                "collective_bytes": self.collective_bytes,
                "collective_kinds": {k: dict(v) for k, v in
                                     self.collective_kinds.items()},
                "kernels": {k: dict(v) for k, v in self.kernels.items()},
                "peak_live_bytes": self.peak_live_bytes, "ops": self.ops}


class Counter(TorchDispatchMode):
    """``with Counter() as c: step(...)``, then ``c.counts``."""

    def __init__(self):
        super().__init__()
        self.counts = Counts()
        self._live = 0
        self._born: set = set()
        self._depth = 0        # the mode re-enters itself to decompose

    def __enter__(self):
        from repro_torch.distributed import collectives as col
        if self._depth == 0:
            self._coll0 = dict(col.BYTES)
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.distributed import collectives as col
        out = super().__exit__(*exc)
        self._depth -= 1
        if self._depth:
            return out
        kinds: Dict[str, Dict[str, float]] = {}
        for (kind, dim), b in col.BYTES.items():
            d = b - self._coll0.get((kind, dim), 0.0)
            if d:
                kinds.setdefault(kind, {})[dim] = d
        self.counts.collective_kinds = kinds
        return out

    # -------------------------------------------------------- bookkeeping
    def _add_flops(self, unit: str, n: float) -> None:
        self.counts.flops[unit] = self.counts.flops.get(unit, 0.0) + n

    def _free(self, key: int, n: int) -> None:
        self._live -= n
        self._born.discard(key)

    def _track(self, outs: List[torch.Tensor], inputs: set) -> None:
        for t in outs:
            key = _storage_key(t)
            if key in inputs or key in self._born:
                continue
            st = t.untyped_storage()
            n = st.nbytes()
            self._born.add(key)
            self._live += n
            weakref.finalize(st, self._free, key, n)
        self.counts.peak_live_bytes = max(self.counts.peak_live_bytes,
                                          self._live)

    # ------------------------------------------------------------ the mode
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ns, _, name = func.name().partition("::")
        if ns == "aten" and func._overloadpacket not in _flop_registry():
            # a composite op (``matmul`` under ``inference_mode``, where
            # no autograd key decomposes it first) is counted as the ops
            # it runs, as it is with autograd on
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if ns == "prim":            # metadata queries (a fake tensor's device)
            return out
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        in_keys = {_storage_key(t) for t in ins}
        self.counts.ops += 1
        if ns == "repro_torch":
            self._kernel(func.name(), args, kwargs)
        elif ns == "aten":
            self._aten(func, name, ins, outs, in_keys, out, args, kwargs)
        self._track(outs, in_keys)
        return out

    def _kernel(self, op: str, args, kwargs) -> None:
        from repro_torch.kernels.ops import WORK
        kernel, work_of = WORK[op]
        w = work_of(*args, **kwargs)
        self._add_flops(w.unit, w.flops)
        self.counts.bytes += w.bytes
        rec = self.counts.kernels.setdefault(
            kernel, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        rec["calls"] += 1
        rec["flops"] += w.flops
        rec["bytes"] += w.bytes

    def _aten(self, func, name, ins, outs, in_keys, out, args,
              kwargs) -> None:
        packet = func._overloadpacket
        if packet in _flop_registry() and ins:
            n = _flop_registry()[packet](*args, **kwargs, out_val=out)
            if n:
                self._add_flops(unit_of(ins[0].dtype), float(n))
        if name in _ALLOC:
            return
        if name in _GATHER:
            idx = sum(_nbytes(t) for t in ins[1:])
            self.counts.bytes += 2 * sum(_nbytes(t) for t in outs) + idx
            return
        if name in _SCATTER:
            # (self, ..., values/src last among the tensors)
            idx = sum(_nbytes(t) for t in ins[1:-1])
            self.counts.bytes += 2 * _nbytes(ins[-1]) + idx
            return
        fresh = [t for t in outs if _storage_key(t) not in in_keys]
        writes = any(r.alias_info is not None and r.alias_info.is_write
                     for r in func._schema.returns)
        if outs and not fresh and not writes:
            return                           # a view: nothing moves
        self.counts.bytes += sum(_nbytes(t) for t in ins) \
            + sum(_nbytes(t) for t in fresh)


__all__ = ["Counter", "Counts", "unit_of"]
