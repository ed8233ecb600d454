"""The port's checkpoint store against the JAX package's, and resume.

Each contract test of ``repro.checkpoint`` (``tests/test_substrates.py``,
``tests/test_faults.py``) runs here as two cases, one a package: round
trip, atomic commit, the async manager, digests, tamper, no sidecar, the
kill between write and rename, the fallback past a corrupt checkpoint and
the writer that survives a persistent fault.  Across the packages, the same
f32/int32 tree gives byte-identical files and each package restores the
other's; a bf16 leaf goes from ``repro`` into the port bit for bit (the
other way fails in ``repro`` as ``repro``'s own bf16 restore does); the
trainer's ``{"params", "opt"}`` tree crosses both ways through
``to_repro_lm_params`` / ``to_torch_lm_params``, whisper's and dbrx's too
(byte for byte); and the port's launcher resumes to the loss of a
straight run.
"""
import dataclasses
import json
import pathlib
import threading
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.checkpoint as jckpt
from repro import obs as jobs
from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.optim import adamw as jadamw
from repro.runtime import faults as jfaults
from repro.runtime.retry import RetryPolicy as JRetryPolicy
from repro.runtime.retry import retry_call as jretry_call
from repro_torch import obs
from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.runtime import faults
from repro_torch.runtime.retry import RetryPolicy, retry_call
from repro_torch.weights import (ReproAdamWState, repro_adamw_template,
                                 repro_lm_template,
                                 to_repro_adamw_state, to_repro_lm_params,
                                 to_torch_adamw_state, to_torch_lm_params)


def NOSLEEP(_s):
    return None


PACKAGES = {
    "repro": types.SimpleNamespace(
        store=jckpt, obs=jobs, faults=jfaults, retry_call=jretry_call,
        fast=JRetryPolicy(max_attempts=3, base_delay_s=0.0, jitter=0.0),
        array=jnp.asarray, value=np.asarray),
    "repro_torch": types.SimpleNamespace(
        store=ckpt, obs=obs, faults=faults, retry_call=retry_call,
        fast=RetryPolicy(max_attempts=3, base_delay_s=0.0, jitter=0.0),
        array=torch.from_numpy, value=lambda t: t.numpy()),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    """Each package's store, with its obs recording (counters are no-ops
    with tracing off) and its fault schedule disarmed afterwards."""
    p = PACKAGES[request.param]
    p.obs.reset()
    p.obs.enable()
    yield p
    p.faults.disarm()
    p.obs.reset()


def _tree(v=1.0):
    return {"w": np.arange(6, dtype=np.float32) * v, "b": np.float32(v)}


def _rng_tree(seed: int):
    """A nested f32/int32 tree with every container kind the trainer
    writes: nested dicts, a list, a tuple, an ``AdamWState`` (a NamedTuple
    in ``repro``, a dataclass in the port), a numpy scalar."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    w = f(3, 4)
    return {
        "params": {"b": f(4), "a": {"x": rng.integers(-9, 9, (2, 3))
                                    .astype(np.int32)}},
        "seq": [f(2), (f(1, 2), np.int32(7))],
        "opt": (np.zeros((), np.int32), {"w": w}, {"w": w * 2},
                {"w": w * 3}),
        "scale": np.float32(0.5),
    }


def _as_package(tree, name: str):
    """``_rng_tree``'s tree with the ``opt`` tuple as the package's
    ``AdamWState`` and its arrays as the package's leaves."""
    step, mu, nu, master = tree["opt"]
    if name == "repro":
        array, state = jnp.asarray, jadamw.AdamWState
    else:
        array, state = torch.from_numpy, adamw.AdamWState

    def conv(a):              # numpy scalars stay numpy in both packages
        return array(a) if isinstance(a, np.ndarray) and a.ndim else a

    out = jax.tree.map(conv, {k: v for k, v in tree.items() if k != "opt"})
    out["opt"] = state(step, jax.tree.map(conv, mu), jax.tree.map(conv, nu),
                       jax.tree.map(conv, master))
    return out


def _np_leaves(tree, name: str):
    """Every leaf of a package's tree as numpy, in jax's order."""
    if name == "repro":
        return [np.asarray(x) for x in jax.tree.leaves(tree)]
    return [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for _, x in ckpt.store._flatten(tree)]


# ---------------------------------------------------- contract, both packages
def test_checkpoint_roundtrip(pkg, tmp_path):
    tree = {"a": pkg.array(np.arange(6, dtype=np.float32).reshape(2, 3)),
            "b": {"c": pkg.array(np.asarray([1, 2, 3], np.int32))}}
    pkg.store.save_pytree(tree, tmp_path / "step_00000001")
    out = pkg.store.restore_pytree(tree, tmp_path / "step_00000001")
    np.testing.assert_array_equal(pkg.value(out["a"]), pkg.value(tree["a"]))
    np.testing.assert_array_equal(pkg.value(out["b"]["c"]),
                                  pkg.value(tree["b"]["c"]))
    assert pkg.value(out["b"]["c"]).dtype == np.int32


def test_checkpoint_atomic_commit(pkg, tmp_path):
    pkg.store.save_pytree({"a": pkg.array(np.zeros(4, np.float32))},
                          tmp_path / "step_00000005")
    bad = tmp_path / "step_00000009"     # a partial (uncommitted) later step
    (bad / "arrays").mkdir(parents=True)
    assert pkg.store.latest_step(tmp_path) == 5


def test_checkpoint_manager_async_resume(pkg, tmp_path):
    mgr = pkg.store.CheckpointManager(tmp_path, keep=2)
    w = np.asarray([1.0, 2.0], np.float32)
    tree = {"w": pkg.array(w), "step": pkg.array(np.asarray(0))}
    try:
        for s in (10, 20, 30):
            mgr.save(s, {"w": pkg.array(w * s),
                         "step": pkg.array(np.asarray(s))})
            assert mgr.wait(30)
        step, restored = mgr.restore_latest(tree)
    finally:
        mgr.close()
    assert step == 30
    np.testing.assert_allclose(pkg.value(restored["w"]), [30.0, 60.0])
    assert pkg.store.latest_step(tmp_path) == 30      # keep=2 collected
    assert not (tmp_path / "step_00000010").exists()


def test_checkpoint_digests_written_and_verified(pkg, tmp_path):
    d = tmp_path / "step_00000001"
    pkg.store.save_pytree(_tree(), d)
    digests = json.loads((d / "digests.json").read_text())
    assert "manifest.json" in digests and "arrays/w.npy" in digests
    got = pkg.store.restore_pytree(_tree(0.0), d)
    assert np.array_equal(np.asarray(got["w"]), _tree()["w"])


def test_checkpoint_tamper_raises_oserror(pkg, tmp_path):
    d = tmp_path / "step_00000001"
    pkg.store.save_pytree(_tree(), d)
    raw = bytearray((d / "arrays" / "w.npy").read_bytes())
    raw[-1] ^= 0xFF                      # flip one payload byte
    (d / "arrays" / "w.npy").write_bytes(raw)
    with pytest.raises(OSError, match="integrity"):
        pkg.store.restore_pytree(_tree(0.0), d)


def test_checkpoint_without_sidecar_still_restores(pkg, tmp_path):
    d = tmp_path / "step_00000001"
    pkg.store.save_pytree(_tree(), d)
    (d / "digests.json").unlink()        # pre-sidecar layout
    got = pkg.store.restore_pytree(_tree(0.0), d)
    assert np.array_equal(np.asarray(got["w"]), _tree()["w"])


def test_checkpoint_kill_between_write_and_rename(pkg, tmp_path):
    root = tmp_path / "ckpt"
    pkg.store.save_pytree(_tree(1.0), root / "step_00000001")
    sched = pkg.faults.FaultSchedule(seed=0, sites={
        "ckpt.write": pkg.faults.SiteSpec(count=99, exc="OSError")})
    with pkg.faults.injecting(sched):
        with pytest.raises(OSError):
            pkg.retry_call(lambda: pkg.store.save_pytree(
                _tree(2.0), root / "step_00000002"),
                site="ckpt.write", policy=pkg.fast, sleep=NOSLEEP)
    assert pkg.store.latest_step(root) == 1   # previous-good untouched
    got = pkg.store.restore_pytree(_tree(0.0), root / "step_00000001")
    assert np.asarray(got["b"]) == np.float32(1.0)
    # fault gone: the exact same save completes cleanly over its own debris
    pkg.store.save_pytree(_tree(2.0), root / "step_00000002")
    assert pkg.store.committed_steps(root) == [1, 2]


def test_restore_latest_falls_back_past_corrupt(pkg, tmp_path):
    root = tmp_path / "ckpt"
    mgr = pkg.store.CheckpointManager(root, keep=3, sleep=NOSLEEP)
    try:
        mgr.save(1, _tree(1.0))
        assert mgr.wait(30)
        mgr.save(2, _tree(2.0))
        assert mgr.wait(30)
        raw = bytearray((root / "step_00000002" / "arrays" / "w.npy")
                        .read_bytes())
        raw[-1] ^= 0xFF                  # corrupt the newest's payload
        (root / "step_00000002" / "arrays" / "w.npy").write_bytes(raw)
        step, tree = mgr.restore_latest(_tree(0.0))
    finally:
        mgr.close()
    assert step == 1
    assert np.asarray(tree["b"]) == np.float32(1.0)
    assert pkg.obs.counter_value("ckpt.restore_fallback") == 1
    assert pkg.obs.counter_value("ckpt.restore_failed", type="OSError") > 0


def test_manager_writer_survives_persistent_write_fault(pkg, tmp_path):
    root = tmp_path / "ckpt"
    mgr = pkg.store.CheckpointManager(root, sleep=NOSLEEP)
    try:
        mgr.save(1, _tree(1.0))
        assert mgr.wait(30)
        sched = pkg.faults.FaultSchedule(seed=0, sites={
            "ckpt.write": pkg.faults.SiteSpec(count=99, exc="OSError")})
        with pkg.faults.injecting(sched):
            mgr.save(2, _tree(2.0))
            assert mgr.wait(30)          # writer dropped the save, thread OK
        assert pkg.store.latest_step(root) == 1
        assert pkg.obs.counter_value("ckpt.write_failed",
                                     type="OSError") == 1
        mgr.save(3, _tree(3.0))          # thread still alive and writing
        assert mgr.wait(30)
        assert pkg.store.latest_step(root) == 3
    finally:
        mgr.close()


# ------------------------------------------------------------- the port only
def test_bf16_round_trip_is_bit_exact(tmp_path):
    """Every bf16 pattern class (normals, subnormals, +-0, +-inf, NaN
    payloads) comes back bit for bit, as a tensor and as ``V2`` numpy, and
    into an f32 template as the exact widening."""
    bits = np.concatenate([
        np.random.default_rng(0).integers(-2 ** 15, 2 ** 15, 4096),
        [0, -2 ** 15, 0x7F80, -0x0080, 0x7FC1, 0x0001, -0x7FFF, 0x7F7F]]
    ).astype(np.int16)
    t = torch.from_numpy(bits.copy()).view(torch.bfloat16).reshape(8, -1)
    ckpt.save_pytree({"t": t, "v": bits.view("V2")}, tmp_path / "s")
    man = json.loads((tmp_path / "s" / "manifest.json").read_text())
    assert [leaf["dtype"] for leaf in man["leaves"]] == ["bfloat16"] * 2
    got = ckpt.restore_pytree(
        {"t": torch.zeros(t.shape, dtype=torch.bfloat16),
         "v": np.zeros(bits.shape, "V2")}, tmp_path / "s")
    assert got["t"].dtype == torch.bfloat16
    assert torch.equal(got["t"].view(torch.int16), t.view(torch.int16))
    assert got["v"].dtype == np.dtype("V2")
    assert np.array_equal(got["v"].view(np.int16), bits)
    wide = ckpt.restore_pytree({"t": torch.zeros(t.shape),
                                "v": np.zeros(bits.shape, np.float32)},
                               tmp_path / "s")
    want = t.float()
    assert torch.equal(wide["t"].isnan(), want.isnan())
    finite = ~want.isnan()
    assert torch.equal(wide["t"][finite], want[finite])
    assert np.array_equal(wide["v"], want.flatten().numpy(), equal_nan=True)


def test_restore_follows_the_template_type_and_dtype(tmp_path):
    ckpt.save_pytree({"a": torch.arange(4, dtype=torch.float32),
                      "s": np.float32(3.0)}, tmp_path / "s")
    got = ckpt.restore_pytree({"a": np.zeros(4, np.float64),
                               "s": torch.zeros((), dtype=torch.float16)},
                              tmp_path / "s")
    assert got["a"].dtype == np.float64 and list(got["a"]) == [0, 1, 2, 3]
    assert got["s"].dtype == torch.float16 and float(got["s"]) == 3.0
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_pytree({"a": np.zeros(5, np.float32),
                             "s": np.float32(0)}, tmp_path / "s")


def test_manager_wait_covers_a_save_queued_behind_another(tmp_path):
    mgr = ckpt.CheckpointManager(tmp_path, keep=5)
    try:
        for s in range(1, 6):
            mgr.save(s, {"w": torch.full((1000,), float(s))})
        assert mgr.wait(30)
        assert ckpt.latest_step(tmp_path) == 5
    finally:
        mgr.close()


def test_manager_wait_sees_a_save_the_writer_finished_first(tmp_path):
    """The writer may take and write a save before ``save()`` returns (its
    caller's thread is descheduled): ``wait()`` must still report it done.
    Here ``save()``'s clear of the done flag waits up to 1 s for the
    writer to finish first."""
    mgr = ckpt.CheckpointManager(tmp_path)
    written = threading.Event()

    class LateClear(threading.Event):
        def set(self):
            super().set()
            written.set()

        def clear(self):
            written.wait(1.0)
            super().clear()

    mgr._done = LateClear()
    try:
        mgr.save(1, _tree())
        assert mgr.wait(5)
        assert ckpt.committed_steps(tmp_path) == [1]
    finally:
        mgr.close()


def test_manager_snapshots_tensors_it_is_given(tmp_path):
    """The port's parameters change in place: save() copies a tensor
    before it returns, so the checkpoint holds the value at save()."""
    w = torch.ones(8)
    mgr = ckpt.CheckpointManager(tmp_path)
    try:
        mgr.save(1, {"w": w})
        w.mul_(5)
        assert mgr.wait(30)
    finally:
        mgr.close()
    got = ckpt.restore_pytree({"w": torch.zeros(8)}, tmp_path / "step_00000001")
    assert torch.equal(got["w"], torch.ones(8))


# ------------------------------------------------------------ across packages
def _files(d: pathlib.Path):
    return {p.relative_to(d).as_posix(): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


def test_the_same_tree_gives_byte_identical_files(tmp_path):
    tree = _rng_tree(0)
    jckpt.save_pytree(_as_package(tree, "repro"), tmp_path / "j")
    ckpt.save_pytree(_as_package(tree, "repro_torch"), tmp_path / "t")
    jf, tf = _files(tmp_path / "j"), _files(tmp_path / "t")
    assert sorted(jf) == sorted(tf)
    assert "arrays/opt__step.npy" in jf and "arrays/seq__1__1.npy" in jf
    for name in jf:
        assert jf[name] == tf[name], name


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_each_package_restores_the_others_tree(tmp_path, writer):
    tree = _rng_tree(1)
    store = {"repro": jckpt, "repro_torch": ckpt}
    reader = "repro" if writer == "repro_torch" else "repro_torch"
    store[writer].save_pytree(_as_package(tree, writer), tmp_path / "s")
    zeros = jax.tree.map(np.zeros_like, _rng_tree(1))
    zeros["scale"] = np.float32(0)
    got = store[reader].restore_pytree(_as_package(zeros, reader),
                                       tmp_path / "s")
    want = _np_leaves(_as_package(tree, reader), reader)
    back = _np_leaves(got, reader)
    assert len(back) == len(want) == 10
    for a, b in zip(back, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_bf16_goes_from_repro_into_the_port_bit_for_bit(tmp_path):
    x = np.random.default_rng(2).standard_normal((5, 7)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    jckpt.save_pytree({"x": xb, "y": jnp.asarray(x)}, tmp_path / "j")
    got = ckpt.restore_pytree({"x": torch.zeros(5, 7, dtype=torch.bfloat16),
                               "y": torch.zeros(5, 7)}, tmp_path / "j")
    assert torch.equal(got["x"].view(torch.int16),
                       torch.from_numpy(np.array(xb).view(np.int16)))
    assert torch.equal(got["y"], torch.from_numpy(x))
    # the port writes the same bytes back
    ckpt.save_pytree(got, tmp_path / "t")
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    # the other way fails inside repro as its own bf16 restore does
    # (repro/checkpoint/store.py casts '<V2' to bfloat16): ROADMAP Queue 3
    for d in ("j", "t"):
        with pytest.raises(ValueError, match="cast"):
            jckpt.restore_pytree({"x": xb, "y": jnp.asarray(x)},
                                 tmp_path / d)


# ------------------------------------------------------ the trainer's tree
ARCH = "rwkv6_1p6b"


@pytest.fixture(scope="module")
def trainer_trees():
    """rwkv6 SMOKE (f32): the JAX params after one AdamW update, and the
    port's model after one train step (so mu, nu and the step are not at
    their init)."""
    jcfg = jget_config(ARCH, smoke=True)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jopt = jadamw.adamw_init(jparams)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), jparams)
    jparams, jopt = jadamw.adamw_update(grads, jopt, jparams, 1e-3)
    cfg = get_config(ARCH, smoke=True)
    model = build_model(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    opt = adamw.adamw_init(model.params())
    from repro_torch.distributed import make_train_step
    step = make_train_step(model, lr=1e-3)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 33))
    opt, _ = step(opt, {"tokens": toks})
    return {"jcfg": jcfg, "jparams": jparams, "jopt": jopt, "cfg": cfg,
            "model": model, "opt": opt}


def _assert_named_equal(got, want):
    assert set(got) == set(want)
    for n in want:
        assert got[n].dtype == want[n].dtype, n
        assert torch.equal(got[n], want[n]), n


def test_repro_trainer_checkpoint_restores_into_the_port(tmp_path,
                                                         trainer_trees):
    t = trainer_trees
    jckpt.save_pytree({"params": t["jparams"], "opt": t["jopt"]},
                      tmp_path / "s")
    cfg = t["cfg"]
    got = ckpt.restore_pytree({"params": repro_lm_template(cfg),
                               "opt": repro_adamw_template(cfg)},
                              tmp_path / "s")
    host = jax.tree.map(np.asarray, t["jparams"])
    _assert_named_equal(to_torch_lm_params(got["params"], cfg, "cpu"),
                        to_torch_lm_params(host, cfg, "cpu"))
    state = to_torch_adamw_state(got["opt"], cfg, "cpu")
    jstate = to_torch_adamw_state(jax.tree.map(np.asarray, t["jopt"]), cfg,
                                  "cpu")
    assert state.step == jstate.step == 1
    for field in ("mu", "nu", "master"):
        _assert_named_equal(getattr(state, field), getattr(jstate, field))


def test_port_trainer_checkpoint_restores_in_repro(tmp_path, trainer_trees):
    t = trainer_trees
    cfg, model, opt = t["cfg"], t["model"], t["opt"]
    tree = {"params": to_repro_lm_params(model.params(), cfg),
            "opt": to_repro_adamw_state(opt, cfg)}
    ckpt.save_pytree(tree, tmp_path / "s")
    got = jckpt.restore_pytree({"params": t["jparams"], "opt": t["jopt"]},
                               tmp_path / "s")
    jflat = jax.tree_util.tree_flatten_with_path(got)[0]
    want = dict(ckpt.store._flatten(tree))
    assert len(jflat) == len(want)
    for path, leaf in jflat:
        name = jckpt.store._leaf_name(path)
        assert np.array_equal(np.asarray(leaf), want[name]), name
    assert int(got["opt"].step) == opt.step == 1


def test_the_converter_is_its_own_inverse(trainer_trees):
    t = trainer_trees
    cfg, jcfg = t["cfg"], t["jcfg"]
    named = t["model"].params()
    _assert_named_equal(to_torch_lm_params(to_repro_lm_params(named, cfg),
                                           cfg, "cpu"), named)
    host = jax.tree.map(np.asarray, t["jparams"])
    back = to_repro_lm_params(to_torch_lm_params(host, cfg, "cpu"), cfg)
    assert jax.tree.structure(back) == jax.tree.structure(host)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(host)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # bf16: the patterns cross, no f32 detour
    bcfg = dataclasses.replace(cfg, dtype="bfloat16")
    bmodel = build_model(bcfg, device="cpu").init(
        torch.Generator().manual_seed(3))
    stacked = to_repro_lm_params(bmodel.params(), bcfg)
    assert stacked["embed"].dtype == np.dtype("V2")
    back = to_torch_lm_params(stacked, bcfg, "cpu")
    for n, p in bmodel.params().items():
        assert torch.equal(back[n].view(torch.int16), p.view(torch.int16)), n
    state = to_torch_adamw_state(to_repro_adamw_state(t["opt"], cfg), cfg,
                                 "cpu")
    assert state.step == t["opt"].step
    for field in ("mu", "nu", "master"):
        _assert_named_equal(getattr(state, field), getattr(t["opt"], field))
    assert jcfg.n_layers == cfg.n_layers


def test_templates_match_the_converted_layout(trainer_trees):
    cfg = trainer_trees["cfg"]
    shapes = lambda tr: jax.tree.map(lambda a: (a.shape, a.dtype), tr)  # noqa
    assert shapes(repro_lm_template(cfg)) == shapes(
        to_repro_lm_params(trainer_trees["model"].params(), cfg))
    opt_t = repro_adamw_template(cfg)
    opt_c = to_repro_adamw_state(trainer_trees["opt"], cfg)
    assert shapes(opt_t.master) == shapes(opt_c.master)
    assert opt_t.step.shape == () and opt_t.step.dtype == np.int32


def test_repro_optimizer_layout_has_repro_field_order(trainer_trees):
    """The checkpoint names the optimizer's leaves by field, in field order:
    the port's copy of ``repro``'s layout must keep ``repro``'s fields."""
    assert ReproAdamWState._fields == jadamw.AdamWState._fields
    state = to_repro_adamw_state(trainer_trees["opt"], trainer_trees["cfg"])
    names = [n for n, _ in ckpt.store._flatten({"opt": state})]
    jnames = [jckpt.store._leaf_name(p) for p, _ in
              jax.tree_util.tree_flatten_with_path(
                  {"opt": jadamw.AdamWState(*state)})[0]]
    assert names == jnames and names[0] == "opt__step"


# ------------------------------------------- the new families' trees
NEW_FAMILIES = ["whisper_small", "dbrx_132b"]


@pytest.fixture(scope="module", params=NEW_FAMILIES)
def family_trees(request):
    """whisper (two layer stacks of their own depths) and dbrx (the MoE
    experts' (E, ...) leaves) at SMOKE: ``repro``'s params and fresh
    optimizer state, and the same carried into the port's model and its
    fresh state."""
    arch = request.param
    jmodel = jbuild_model(jget_config(arch, smoke=True))
    jparams = jmodel.init(jax.random.PRNGKey(5))
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg, device="cpu").load_params(
        to_torch_lm_params(jax.tree.map(np.asarray, jparams), cfg, "cpu"))
    return {"cfg": cfg, "jtree": {"params": jparams,
                                  "opt": jadamw.adamw_init(jparams)},
            "tree": {"params": to_repro_lm_params(model.params(), cfg),
                     "opt": to_repro_adamw_state(
                         adamw.adamw_init(model.params()), cfg)},
            "model": model}


def test_new_families_checkpoint_is_repros_file_byte_for_byte(
        tmp_path, family_trees):
    t = family_trees
    jckpt.save_pytree(t["jtree"], tmp_path / "j")
    ckpt.save_pytree(t["tree"], tmp_path / "t")
    jf, tf = _files(tmp_path / "j"), _files(tmp_path / "t")
    assert sorted(jf) == sorted(tf)
    stacked = ("arrays/params__dec_layers__cross__wkv.npy"
               if t["cfg"].family == "encdec" else
               "arrays/params__layers__ffn__wu.npy")
    assert stacked in jf
    for name in jf:
        assert jf[name] == tf[name], name


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_new_families_restore_into_the_other_package(tmp_path, family_trees,
                                                     writer):
    t = family_trees
    cfg = t["cfg"]
    if writer == "repro":
        jckpt.save_pytree(t["jtree"], tmp_path / "s")
        got = ckpt.restore_pytree({"params": repro_lm_template(cfg),
                                   "opt": repro_adamw_template(cfg)},
                                  tmp_path / "s")
        _assert_named_equal(to_torch_lm_params(got["params"], cfg, "cpu"),
                            t["model"].params())
        state = to_torch_adamw_state(got["opt"], cfg, "cpu")
        assert state.step == 0
        _assert_named_equal(state.master, {n: p.float() for n, p in
                                           t["model"].params().items()})
    else:
        ckpt.save_pytree(t["tree"], tmp_path / "s")
        got = jckpt.restore_pytree(t["jtree"], tmp_path / "s")
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(t["jtree"])):
            assert a.dtype == b.dtype and np.array_equal(np.asarray(a),
                                                         np.asarray(b))


def test_new_families_templates_keep_each_leafs_dtype(family_trees):
    """The restore template of a bf16 model: every leaf bf16 (``V2``) but
    the MoE router, which is f32 in any model; the layer stacks each at
    their own depth."""
    cfg = dataclasses.replace(family_trees["cfg"], dtype="bfloat16")
    tmpl = repro_lm_template(cfg)
    if cfg.family == "moe":
        assert tmpl["layers"]["ffn"]["router"].dtype == np.float32
        assert tmpl["layers"]["ffn"]["wu"].shape == (
            cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff)
        assert tmpl["layers"]["ffn"]["wu"].dtype == np.dtype("V2")
    else:
        assert tmpl["enc_layers"]["attn"]["wq"].shape[0] == cfg.enc_layers
        assert tmpl["dec_layers"]["cross"]["wq"].shape[0] == cfg.n_layers
        assert tmpl["enc_pos"].dtype == np.dtype("V2")
    shapes = lambda tr: jax.tree.map(lambda a: a.shape, tr)  # noqa: E731
    assert shapes(tmpl) == shapes(family_trees["tree"]["params"])


# ------------------------------------------------------------ the launcher
def _final_loss(text: str) -> float:
    lines = [line for line in text.splitlines() if "loss=" in line]
    return float(lines[-1].split("loss=")[1].split()[0])


def test_launcher_resumes_to_the_straight_runs_loss(tmp_path, capsys):
    """As ``tests/test_system.py``'s resume test: 10 steps straight against
    5 + 5 through ``--ckpt-dir``, the final loss within rel 1e-4."""
    base = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
            "--seq", "32", "--log-every", "1"]

    def run(steps, ckpt_dir):
        launch_train.main(base + ["--steps", str(steps), "--ckpt-dir",
                                  str(ckpt_dir), "--ckpt-every", "5"])
        return capsys.readouterr().out

    log_full = run(10, tmp_path / "a")
    run(5, tmp_path / "b")
    log_resumed = run(10, tmp_path / "b")
    assert "resumed from step 5" in log_resumed
    assert "resumed" not in log_full
    assert _final_loss(log_full) == pytest.approx(_final_loss(log_resumed),
                                                  rel=1e-4)
    assert ckpt.committed_steps(tmp_path / "b") == [5, 10]
    man = json.loads((tmp_path / "b" / "step_00000010" / "manifest.json")
                     .read_text())
    assert man["leaves"][0] == {"name": "opt__step", "shape": [],
                                "dtype": "int32", "sharding": ""}
