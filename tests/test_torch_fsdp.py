"""FSDP and ZeRO-1 executed on the CPU, against the whole-over-data step
and ``repro``'s.

One ``gloo`` world of 4 ranks (``torch_dist_worker``, one process a rank)
runs SMOKE llama3.2-3b, dbrx-132b and rwkv6-1.6b in f32 on a (2, 2) and a
(4, 1) mesh: two steps with FSDP forced on every leaf (``_wants_fsdp``
forced, ``FSDP_MIN_ELEMENTS`` lowered to 0) and ZeRO-1, and two steps of
the step that keeps every parameter and its state whole over the data
axes.  ``repro``'s side runs in a subprocess on 8 forced host devices (as
``tests/test_distributed.py`` runs it): its sharded train step on the same
meshes, the same numpy weights and tokens.  Held at 1e-5: losses (rtol),
the gradients the step hands its optimiser (gathered whole, within 1e-5 of
each leaf's max |g|), the clip's global norm (rtol) and the parameters
after each step (within 1e-5 of each leaf's max |p| where the first
gradient is at least 1e-7: Adam's first step is ``g / (|g| + eps)``).
Each rank holds the bytes its placement tables say, and a checkpoint saved
from the FSDP mesh is the one-device save's files byte for byte.
"""
import json
import math
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_distributed as td  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.lm import param_specs  # noqa: E402

ARCHS = {"llama": "llama3p2_3b", "dbrx": "dbrx_132b", "rwkv": "rwkv6_1p6b"}
MESHES = {"2x2": (2, 2), "4x1": (4, 1)}
STEPS = 2

REPRO = r'''
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_config
from repro.distributed.sharding import _path_str
from repro.distributed.stepfn import make_train_step
from repro.models import build_model
from repro.optim import adamw_init

out, tokens = sys.argv[1], np.load(sys.argv[2])
scale = {"llama3p2_3b": 1.0, "rwkv6_1p6b": 10.0, "dbrx_132b": 1.0}
devs = np.array(jax.devices())
arrays = {}


def keep(prefix, tree):
    for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        arrays[f"{prefix}|{_path_str(p)}"] = np.asarray(leaf)


batch = {"tokens": jnp.asarray(tokens, jnp.int32)}
for arch, s in scale.items():
    for d, m in ((2, 2), (4, 1)):
        model = build_model(get_config(arch, smoke=True))
        params = jax.tree.map(lambda a: np.asarray(a) * np.float32(s),
                              model.init(jax.random.PRNGKey(0)))
        mesh = Mesh(devs[:d * m].reshape(d, m), ("data", "model"))
        step = jax.jit(make_train_step(model, mesh))
        key = f"{arch}/{d}x{m}"
        with mesh:
            keep(f"grad/{key}", jax.jit(jax.grad(model.loss))(params, batch))
            opt = adamw_init(params)
            for i in range(2):
                params, opt, met = step(params, opt, batch)
                arrays[f"loss/{key}/{i}"] = np.asarray(met["loss"])
                keep(f"params/{key}/{i}", params)
np.savez(out, **arrays)
'''


def _expected_held(arch, shape, fsdp):
    """The bytes each rank of a (data, model) = ``shape`` mesh holds by
    the placement tables (with ``fsdp``, FSDP on every leaf):
    parameters by ``param_shardings`` (a leaf FSDP would split on the
    layer axis stays whole over the data axes), f32 moments and master
    (12 bytes an element) by ``opt_shardings``, split on the layer axis:
    the owner's layers whole, nothing for the others."""
    d, m = shape
    sizes = {"data": d, "model": m}
    cfg = get_config(arch, smoke=True)
    specs = param_specs(cfg)
    old = sharding.FSDP_MIN_ELEMENTS
    sharding.FSDP_MIN_ELEMENTS = 0
    try:
        p_sh = sharding.param_shardings(sizes, specs, fsdp=fsdp)
        base = sharding.param_shardings(sizes, specs)
        z1 = sharding.opt_shardings(sizes, p_sh, specs)
    finally:
        sharding.FSDP_MIN_ELEMENTS = old
    depth = sharding._depths(specs)

    def local(shape_, spec):
        n = 1
        for dim, ax in zip(shape_, spec):
            axes = () if ax is None else (ax if isinstance(ax, tuple)
                                          else (ax,))
            n *= dim // math.prod(sizes[a] for a in axes)
        return n

    out = []
    for rank in range(d * m):
        drank = rank // m
        held = {"params": {}, "state": {}}
        for name, (shp, dt) in specs.items():
            ps = base[name] if isinstance(p_sh[name], sharding.LayerSharded) \
                else p_sh[name]
            item = torch.empty((), dtype=dt).element_size()
            held["params"][name] = local(shp, ps) * item
            zs = z1[name]
            if isinstance(zs, sharding.LayerSharded):
                stack, i = name.split(".")[:2]
                if int(i) // (depth[stack] // d) != drank:
                    continue
                zs = tuple(zs[1:])
            held["state"][name] = local(shp, zs) * 12
        out.append(held)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp")
    params = {a: td._jax_params(a) for a in ARCHS.values()}
    np.save(tmp / "tokens.npy", td.TOKENS)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count"
               "=8", PYTHONPATH=str(td.ROOT / "src"), JAX_PLATFORMS="cpu")
    repro = subprocess.Popen(
        [sys.executable, "-c", REPRO, str(tmp / "repro.npz"),
         str(tmp / "tokens.npy")], env=env, cwd=str(td.ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    toks = torch.from_numpy(td.TOKENS)
    tasks = [("ckpt", "fsdp_save", 2,
              {"arch": "llama3p2_3b", "params": params["llama3p2_3b"],
               "directory": str(tmp / "ckpt_fsdp")})]
    for short, arch in ARCHS.items():
        for mname, (d, m) in MESHES.items():
            for kind, kw in (("fsdp", {"fsdp": True}), ("zero1", {}),
                             ("whole", {"whole": True})):
                tasks.append((f"{short}/{mname}/{kind}", "fsdp_train", m,
                              {"arch": arch, "params": params[arch],
                               "tokens": toks, "steps": STEPS, **kw}))
            for kind, fsdp in (("fsdp", True), ("zero1", False)):
                tasks.append((f"{short}/{mname}/held/{kind}", "held", m,
                              {"arch": arch, "fsdp": fsdp}))
    procs, out = td._world(tmp, "w4", 4, tasks)
    ends = td._finish(procs)
    rso, rse = repro.communicate(timeout=900)
    assert repro.returncode == 0, rse[-3000:]
    for rank, (code, so, se) in enumerate(ends):
        err = out if rank == 0 else out.with_name(f"{out.name}.rank{rank}")
        if code and err.exists():
            with open(err, "rb") as f:
                se += pickle.load(f).get("error", "")
        assert code == 0, (rank, se[-3000:])
    with open(out, "rb") as f:
        got = pickle.load(f)
    return {"tmp": tmp, "params": params, "port": got,
            "repro": dict(np.load(tmp / "repro.npz"))}


CASES = [(s, m, k) for s in ARCHS for m in MESHES
         for k in ("fsdp", "zero1")]
IDS = [f"{s}-{m}-{k}" for s, m, k in CASES]


def _repro_named(runs, key, arch):
    return td._repro_params(runs, key, td._f32(arch))


@pytest.mark.parametrize("short,mesh,kind", CASES, ids=IDS)
def test_sharded_step_matches_whole_step(runs, short, mesh, kind):
    """With FSDP forced on every leaf (and ZeRO-1 where FSDP leaves the
    state whole), or with ZeRO-1 alone (a SMOKE config's own placement):
    losses, gradients, clip norm and parameters after each of two steps
    equal the step that keeps everything whole over the data axes; the
    placement did split the parameters (FSDP) or the state (ZeRO-1)."""
    got = runs["port"][f"{short}/{mesh}/{kind}"]
    want = runs["port"][f"{short}/{mesh}/whole"]
    if kind == "fsdp":
        assert got["held"]["fsdp"] > 0
    else:
        assert got["held"]["fsdp"] == 0 and got["held"]["zero1"] > 0
    assert want["held"]["fsdp"] == want["held"]["zero1"] == 0
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    td._close_grads(got["grads"], want["grads"])
    np.testing.assert_allclose(got["gnorm"], want["gnorm"], rtol=1e-5)
    td._close_params(got["first"], want["first"], want["grads"])
    td._close_params(got["params"], want["params"], want["grads"])


@pytest.mark.parametrize("short,mesh,kind", CASES, ids=IDS)
def test_sharded_step_matches_repro(runs, short, mesh, kind):
    """The same against ``repro``'s sharded step on the same mesh (8
    forced host devices): both steps' losses, the first step's
    gradients and the parameters after each step."""
    arch = ARCHS[short]
    got = runs["port"][f"{short}/{mesh}/{kind}"]
    key = f"{arch}/{mesh}"
    losses = [float(runs["repro"][f"loss/{key}/{i}"]) for i in range(STEPS)]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    grads = _repro_named(runs, f"grad/{key}", arch)
    td._close_grads(got["grads"], grads)
    td._close_params(got["first"], _repro_named(runs, f"params/{key}/0",
                                                arch), grads)
    td._close_params(got["params"], _repro_named(runs, f"params/{key}/1",
                                                 arch), grads)


@pytest.mark.parametrize("short,mesh,kind", CASES, ids=IDS)
def test_each_rank_holds_its_placement(runs, short, mesh, kind):
    """Every rank's parameter and state bytes, leaf by leaf, are what the
    FSDP (forced on every leaf) and ZeRO-1 tables give that rank."""
    got = runs["port"][f"{short}/{mesh}/held/{kind}"]
    assert got == _expected_held(ARCHS[short], MESHES[mesh],
                                 fsdp=kind == "fsdp")


def test_fsdp_checkpoint_bytes(runs):
    """A trainer checkpoint saved from the (2, 2) mesh with FSDP on every
    leaf and ZeRO-1 state writes the one-device save's files byte for
    byte (the manifest's strings aside), and the trainer's resume puts
    every block back."""
    tmp = runs["tmp"]
    got = runs["port"]["ckpt"]
    assert got["restored_blocks_equal"] and got["step"] == 3
    model = td._one_device("llama3p2_3b", runs["params"]["llama3p2_3b"])
    from repro_torch.checkpoint.store import save_pytree
    import torch_dist_worker as worker
    save_pytree(launch_train._ckpt_tree(model, worker.train_state(model),
                                        model.cfg), tmp / "ckpt_one")
    a, b = tmp / "ckpt_fsdp" / "step_00000003", tmp / "ckpt_one"
    files = sorted(p.relative_to(b) for p in b.rglob("*.npy"))
    assert files == sorted(p.relative_to(a) for p in a.rglob("*.npy"))
    for rel in files:
        assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel
    ma = json.loads((a / "manifest.json").read_text())
    assert any("data" in leaf["sharding"] for leaf in ma["leaves"])
