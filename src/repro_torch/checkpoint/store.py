"""Checkpointing with async writes and atomic-commit resume.

The port of ``repro.checkpoint.store``, on the same files.  Layout (one
directory per step)::

    <dir>/step_000100/
        manifest.json        # leaf names, shapes, dtypes, logical shardings
        arrays/<leaf>.npy    # host copy of every leaf
        digests.json         # sha256 of every npy + the manifest (integrity)
        COMMIT               # written last: presence marks a valid checkpoint

A checkpoint written by either package restores in the other: leaves are
flattened in ``jax.tree_util``'s order (dict keys sorted, list and tuple
items by index, a NamedTuple's or a dataclass's fields in order; ``None``
holds no leaf) and named as ``repro`` names them (path parts joined with
``__``), so the same tree gives byte-identical ``manifest.json``,
``digests.json`` and ``.npy`` files.  Leaves may be ``torch.Tensor``s on
any device, numpy arrays or numpy scalars.  numpy has no bfloat16: a bf16
tensor is written as its 2-byte patterns in a ``'<V2'`` ``.npy`` with
``"dtype": "bfloat16"`` in the manifest, the bytes ``repro`` writes for a
bf16 leaf, and read back through ``int16``, never through f32, so the
round trip is bit-exact.  A numpy leaf of dtype ``V2`` is taken as bf16
patterns too (``weights.to_repro_lm_params`` returns bf16 leaves so).
Restore gives each leaf the template leaf's type, device and dtype.

Fault-tolerance contract (``repro``'s):
* writes go to ``step_X.tmp`` then atomically rename — a crash mid-write
  (the ``ckpt.write`` fault site fires between the two) never corrupts the
  latest valid checkpoint;
* every array file and the manifest get a sha256 digest in ``digests.json``,
  written *before* COMMIT; restore verifies bytes against digests and raises
  ``OSError`` on mismatch (bit-rot / truncation reads as an I/O fault, so
  the retry/fallback machinery handles it like one).  Checkpoints written
  before the sidecar existed restore without verification;
* the manifest's ``sharding`` is ``""`` for every leaf of a one-device
  save; a save from a mesh passes ``shardings=``, a tree like ``tree`` of
  ``repro``'s ``PartitionSpec`` strings (``stepfn.checkpoint_shardings``),
  whose leaves are whole (gathered by the caller, written by rank 0 only),
  so the files equal a one-device save's but for those strings.  A
  restore returns whole leaves, whatever mesh wrote them: the caller
  places them on its own mesh (the trainer through
  ``stepfn.local_named``, which splits the packed ``wkv`` by KV head), so
  a checkpoint reshards on restore;
* ``CheckpointManager`` keeps the last ``keep`` checkpoints and an async
  writer thread so the train loop never blocks on IO.  The writer retries
  transient faults (``retry_call``, site ``ckpt.write``) and on persistent
  failure *drops the save* (counter ``ckpt.write_failed``) rather than
  killing the thread — the previous checkpoint stays good.  ``wait``
  returns once no save is queued or being written.  ``restore_latest``
  walks committed steps newest-to-oldest, falling back past
  corrupt/unreadable checkpoints (``ckpt.restore_fallback``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import pathlib
import re
import shutil
import threading
from typing import Any, Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.runtime import faults
from repro_torch.runtime.retry import IO_POLICY, RetryPolicy, retry_call

log = obs.get_logger("ckpt")

Pytree = Any
BF16 = "bfloat16"


# ---------------------------------------------------------------- the tree
def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """(name, child) pairs of a container in ``jax.tree_util``'s order, or
    None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name))
                for f in dataclasses.fields(node)]
    return None


def _flatten(tree: Pytree, path: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[str, Any]]:
    """(leaf name, leaf) in ``jax.tree_util.tree_flatten_with_path`` order,
    named as ``repro.checkpoint.store._leaf_name`` names them."""
    if tree is None:
        return
    kids = _children(tree)
    if kids is None:
        yield "__".join(path) or "leaf", tree
        return
    for name, child in kids:
        yield from _flatten(child, path + (name,))


def _rebuild(template: Pytree, leaves: Iterator) -> Pytree:
    """``template``'s structure with its leaves taken from ``leaves``."""
    if template is None:
        return None
    kids = _children(template)
    if kids is None:
        return next(leaves)
    new = {name: _rebuild(child, leaves) for name, child in kids}
    if isinstance(template, dict):
        return {k: new[str(k)] for k in sorted(template)}
    if _is_namedtuple(template):
        return type(template)(*(new[f] for f in template._fields))
    if isinstance(template, (list, tuple)):
        return type(template)(new[str(i)] for i in range(len(template)))
    return dataclasses.replace(template, **new)


# ---------------------------------------------------------------- the files
def _is_bf16(dtype: np.dtype) -> bool:
    """bf16 as an ``ml_dtypes`` numpy dtype or as its 2-byte patterns
    (numpy ``V2``)."""
    return str(dtype) == BF16 or (dtype.kind == "V" and dtype.itemsize == 2)


def _host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as the numpy array its ``.npy`` holds, and its manifest
    dtype; a bf16 leaf as its ``int16`` bit patterns."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy(), BF16
        arr = t.cpu().numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    if _is_bf16(arr.dtype):
        return arr.view(np.int16), BF16
    return arr, str(arr.dtype)


def _npy_bytes(arr: np.ndarray, dtype: str) -> bytes:
    """The ``.npy`` file for one leaf: ``np.save``'s bytes, and for bf16
    the ``'<V2'`` header that ``np.save`` writes for an ``ml_dtypes`` bf16
    array, over the raw 2-byte patterns."""
    buf = io.BytesIO()
    if dtype != BF16:
        np.save(buf, arr)
        return buf.getvalue()
    arr = np.ascontiguousarray(arr, dtype="<i2")
    np.lib.format.write_array_header_1_0(
        buf, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
    buf.write(arr.tobytes())
    return buf.getvalue()


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def save_pytree(tree: Pytree, directory: str | pathlib.Path,
                shardings: Optional[Pytree] = None) -> None:
    """Write ``tree``; ``shardings``: the manifest's sharding string of
    each leaf, a tree of ``tree``'s structure (None: ``""``)."""
    d = pathlib.Path(directory)
    specs = iter(leaf for _, leaf in _flatten(shardings)) \
        if shardings is not None else None
    tmp = d.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    (tmp / "arrays").mkdir(parents=True)
    manifest = {"leaves": []}
    digests = {}
    for name, leaf in _flatten(tree):
        arr, dtype = _host(leaf)
        fname = f"{name}.npy"
        raw = _npy_bytes(arr, dtype)
        (tmp / "arrays" / fname).write_bytes(raw)
        digests[f"arrays/{fname}"] = _sha256(raw)
        manifest["leaves"].append(
            {"name": name, "shape": list(arr.shape), "dtype": dtype,
             "sharding": next(specs) if specs is not None else ""})
    manifest_bytes = json.dumps(manifest).encode()
    (tmp / "manifest.json").write_bytes(manifest_bytes)
    digests["manifest.json"] = _sha256(manifest_bytes)
    (tmp / "digests.json").write_text(json.dumps(digests))
    (tmp / "COMMIT").write_text("ok")
    # the kill-between-write-and-rename point: everything (COMMIT included)
    # is in the temp dir; a fault here leaves the previous checkpoint intact
    faults.site(faults.CKPT_WRITE)
    if d.exists():
        shutil.rmtree(d)
    os.replace(tmp, d)


def _as_template(arr: np.ndarray, bf16: bool, leaf):
    """The file's array as ``leaf``'s type, device and dtype; bf16 moves
    as bit patterns into a bf16 target and is widened exactly otherwise."""
    want_shape = tuple(np.shape(leaf))
    if tuple(arr.shape) != want_shape:
        raise ValueError(f"checkpoint leaf shape {tuple(arr.shape)} != "
                         f"template shape {want_shape}")
    if bf16:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = None
    if isinstance(leaf, torch.Tensor):
        if t is None:
            t = torch.from_numpy(np.array(arr))
        return t.to(device=leaf.device, dtype=leaf.dtype)
    want = np.asarray(leaf).dtype
    if t is None:
        out = arr.astype(want)
    elif _is_bf16(want):
        out = arr.view(want)
    else:
        out = t.float().numpy().astype(want)
    return out[()] if isinstance(leaf, np.generic) else out


def restore_pytree(template: Pytree, directory: str | pathlib.Path
                   ) -> Pytree:
    """Restore into the structure of ``template``, each leaf as the template
    leaf's type, on its device, in its dtype.

    When a ``digests.json`` sidecar is present, the manifest's and every
    array file's bytes are verified against their recorded sha256; a
    mismatch raises ``OSError`` (integrity failure is an I/O fault to the
    recovery machinery)."""
    d = pathlib.Path(directory)
    faults.site(faults.CKPT_READ)
    if not (d / "COMMIT").exists():
        raise FileNotFoundError(f"no committed checkpoint at {d}")
    digests = {}
    dig_path = d / "digests.json"
    if dig_path.exists():
        digests = json.loads(dig_path.read_text())

    def read(rel: str) -> bytes:
        raw = (d / rel).read_bytes()
        want = digests.get(rel)
        if want is not None and _sha256(raw) != want:
            raise OSError(f"checkpoint integrity failure: {d / rel} does not "
                          f"match its recorded sha256")
        return raw

    dtypes = {leaf["name"]: leaf["dtype"] for leaf in
              json.loads(read("manifest.json"))["leaves"]}
    out = []
    for name, leaf in _flatten(template):
        arr = np.load(io.BytesIO(read(f"arrays/{name}.npy")))
        bf16 = dtypes.get(name) == BF16 or _is_bf16(arr.dtype)
        out.append(_as_template(arr, bf16, leaf))
    return _rebuild(template, iter(out))


def latest_step(root: str | pathlib.Path) -> Optional[int]:
    root = pathlib.Path(root)
    if not root.exists():
        return None
    best = None
    for p in root.iterdir():
        m = re.fullmatch(r"step_(\d+)", p.name)
        if m and (p / "COMMIT").exists():
            s = int(m.group(1))
            best = s if best is None else max(best, s)
    return best


def committed_steps(root: str | pathlib.Path) -> list[int]:
    """All committed step numbers under ``root``, ascending."""
    root = pathlib.Path(root)
    if not root.exists():
        return []
    out = []
    for p in root.iterdir():
        m = re.fullmatch(r"step_(\d+)", p.name)
        if m and (p / "COMMIT").exists():
            out.append(int(m.group(1)))
    return sorted(out)


def _snapshot(leaf):
    """A host copy the writer thread may read while training goes on: a
    tensor is copied to the CPU (the port updates parameters in place); a
    numpy leaf is taken as it is, as ``repro`` takes its host arrays."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.asarray(leaf)


class CheckpointManager:
    """Async checkpointing: save() enqueues, a writer thread persists."""

    def __init__(self, root: str | pathlib.Path, keep: int = 3, *,
                 io_policy: RetryPolicy = IO_POLICY,
                 sleep: Optional[Callable[[float], None]] = None):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._io_policy = io_policy
        self._sleep = sleep
        self._pending: Optional[Tuple[int, Pytree, Optional[Pytree]]] = None
        self._lock = threading.Lock()
        self._event = threading.Event()
        self._done = threading.Event()
        self._stop = False
        self._thread = threading.Thread(target=self._writer, daemon=True)
        self._thread.start()

    def _retry(self, fn, site: str):
        kw = {} if self._sleep is None else {"sleep": self._sleep}
        return retry_call(fn, site=site, policy=self._io_policy, **kw)

    def save(self, step: int, tree: Pytree,
             shardings: Optional[Pytree] = None) -> None:
        """Queue ``tree`` (``shardings``: as ``save_pytree`` takes it)."""
        leaves = [_snapshot(leaf) for _, leaf in _flatten(tree)]
        host_tree = _rebuild(tree, iter(leaves))
        with self._lock:          # cleared with the lock held, so the
            self._done.clear()    # writer cannot finish this item first
            self._pending = (step, host_tree, shardings)
        self._event.set()

    def _writer(self) -> None:
        while not self._stop:
            self._event.wait(timeout=0.2)
            with self._lock:
                item, self._pending = self._pending, None
                self._event.clear()
            if item is None:
                if self._stop:
                    return
                continue
            step, tree, specs = item
            try:
                self._retry(
                    lambda: save_pytree(tree, self.root / f"step_{step:08d}",
                                        specs),
                    site=faults.CKPT_WRITE)
                self._gc()
            except faults.STEP_FAULT_TYPES as e:
                # drop the save, keep the thread (and the previous good
                # checkpoint) alive — the next save() gets a fresh chance
                obs.inc_counter("ckpt.write_failed", type=type(e).__name__)
                log.warning("checkpoint write for step %d failed (%s: %s); "
                            "keeping previous checkpoint", step,
                            type(e).__name__, e)
            finally:
                # done only when no save is queued behind this one, so
                # wait() never returns between two saves
                with self._lock:
                    if self._pending is None:
                        self._done.set()

    def _gc(self) -> None:
        steps = sorted(int(re.fullmatch(r"step_(\d+)", p.name).group(1))
                       for p in self.root.iterdir()
                       if re.fullmatch(r"step_(\d+)", p.name)
                       and (p / "COMMIT").exists())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.root / f"step_{s:08d}", ignore_errors=True)

    def wait(self, timeout: float = 60.0) -> bool:
        """True once every save() so far is written (or dropped)."""
        return self._done.wait(timeout)

    def restore_latest(self, template: Pytree
                       ) -> Tuple[Optional[int], Optional[Pytree]]:
        """Restore the newest committed checkpoint, falling back past
        corrupt/unreadable ones to the next-oldest (``ckpt.restore_fallback``
        counts how often the newest was not the one restored)."""
        steps = committed_steps(self.root)
        for idx, step in enumerate(reversed(steps)):
            try:
                tree = self._retry(
                    lambda: restore_pytree(
                        template, self.root / f"step_{step:08d}"),
                    site=faults.CKPT_READ)
            except faults.STEP_FAULT_TYPES as e:
                obs.inc_counter("ckpt.restore_failed", type=type(e).__name__)
                log.warning("restore of step %d failed (%s: %s); trying "
                            "older checkpoint", step, type(e).__name__, e)
                continue
            if idx > 0:
                obs.inc_counter("ckpt.restore_fallback")
            return step, tree
        return None, None

    def close(self) -> None:
        self._stop = True
        self._event.set()
        self._thread.join(timeout=5)
