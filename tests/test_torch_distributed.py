"""The port's distribution layer on the CPU against ``repro``'s.

Placements: for every config of the zoo, at SMOKE and full shapes, on a
(data 2, model 4) mesh, every leaf's placement and the FSDP, ZeRO-1 and
cache tables equal ``repro``'s with the layer axis dropped, and
``spec_str`` equals the string ``repro`` shows.  ``repro``'s side runs once
per module in a subprocess with 8 forced host devices (as
``tests/test_distributed.py`` runs it), which also computes its sharded
train steps, its expert-parallel loss and its sharded serve steps.

Multi-rank runs: ``gloo`` worlds of 2 and 4 ranks (``torch_dist_worker``,
one process a rank, joined through a ``FileStore`` under the test's tmp
dir), all in f32, from the same numpy weights and tokens as ``repro``'s
(``to_torch_lm_params``).  Held against the port's one-device results and
``repro``'s: losses at rtol 1e-5; the gradients the step hands its
optimiser within 1e-5 of each leaf's max |g|, and the clip's global norm
at rtol 1e-5; updated parameters within 1e-5 of each leaf's max |p|,
except where the one-device gradient is below 1e-7 (ten times Adam's
eps: the first Adam step is ``g / (|g| + eps)``, whose value there is
decided by summation order); serving logits within 1e-5 of the max
|logit|, greedy tokens identical; the port's expert-parallel loss within
``repro``'s own 2e-3 of its local dispatch, and the MoE block without
expert parallelism (odd T) at the one-device tolerances.  The launcher runs
under ``torch.distributed.run`` with 2 ranks.  The three worlds, the
launcher runs and ``repro``'s subprocess start together.

Attention whose heads do not divide the model axis: SMOKE llama (2 KV
heads) at (1, 4) trains with its queries split by sequence and serves
from a cache split by sequence (the ranks merge ``gqa_decode_partial``'s
outputs by log-sum-exp); whisper SMOKE (4 heads) trains and serves at
(1, 2) and (1, 4) on its heads, and a variant (``worker.VARIANT``: 6 heads
of 16 dims, 30 frames) at (1, 4) through the split paths, its encoder's 30
frames through attention whole on every rank and its cross cache whole on
every rank, as whisper-small's on 16.
"""
import dataclasses
import json
import os
import pathlib
import pickle
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist_worker as worker

import jax

from repro.configs import ARCH_IDS
from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro_torch import api
from repro_torch.checkpoint.store import save_pytree
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import (LayerSharded,
                                              batch_sharding,
                                              cache_shardings,
                                              hidden_sharding,
                                              opt_shardings,
                                              param_shardings, plans_for,
                                              repro_path, spec_str)
from repro_torch.distributed.stepfn import checkpoint_shardings
from repro_torch.launch import train as launch_train
from repro_torch.models.lm import param_specs

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOKENS = np.random.default_rng(1).integers(0, 512, size=(4, 33))
SERVE_TOKENS = np.random.default_rng(3).integers(0, 512, size=(4, 8))
SERVE_SEQ, SERVE_STEPS = 32, 3
#: x the 0.02 init: rwkv6's scan lies below its ``ln_x`` epsilon at 0.02
SCALE = {"llama3p2_3b": 1.0, "rwkv6_1p6b": 10.0, "dbrx_132b": 1.0,
         "whisper_small": 5.0}
#: short name -> (arch, variant): the runs' models (``variant``: the
#: config of ``worker.VARIANT``)
MODELS = {"llama": ("llama3p2_3b", False), "rwkv": ("rwkv6_1p6b", False),
          "dbrx": ("dbrx_132b", False), "whisper": ("whisper_small", False),
          "whisper6": ("whisper_small", True)}
#: whisper SMOKE's vocabulary, its stub frames (B, enc_frames, d_model)
WH_VOCAB = 256
FRAMES = np.random.default_rng(5).normal(size=(4, 32, 64)).astype(np.float32)
MESH_24 = {"data": 2, "model": 4}
#: odd sequence lengths, which no model axis above 1 divides: the MoE
#: block without expert parallelism (``moe_ep.moe_apply_tp``)
MOE_TP_T, MOE_TP_T_SERVE = 31, 7
LAUNCH = ["--arch", "llama3p2_3b", "--smoke", "--device", "cpu",
          "--batch", "4", "--seq", "32", "--log-every", "1"]

REPRO = r'''
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import ARCH_IDS, get_config
from repro.models import build_model
from repro.distributed.sharding import (batch_sharding, cache_shardings,
                                        opt_shardings, param_shardings,
                                        plans_for, _path_str)
from repro.distributed.stepfn import (jit_prefill, jit_serve_step,
                                      make_train_step)
from repro.optim import adamw_init

out, tokens, serve_tokens = sys.argv[1], np.load(sys.argv[2]), \
    np.load(sys.argv[3])
SCALE = json.loads(sys.argv[4])
frames = np.load(sys.argv[5])
devs = np.array(jax.devices())


def mesh(d, m):
    return Mesh(devs[:d * m].reshape(d, m), ("data", "model"))


def ent(a):
    if isinstance(a, tuple):
        return a[0] if len(a) == 1 else list(a)
    return a


def table(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: hasattr(x, "spec"))[0]
    return {_path_str(p): [[ent(a) for a in sh.spec], str(sh.spec)]
            for p, sh in leaves}


res = {}
m24 = mesh(2, 4)
for arch in ARCH_IDS:
    for smoke in (True, False):
        model = build_model(get_config(arch, smoke=smoke))
        specs = model.param_specs()
        p = param_shardings(m24, specs)
        pf = param_shardings(m24, specs, fsdp=True)
        res[f"{arch}/{smoke}"] = {
            "param": table(p), "fsdp": table(pf),
            "zero1": table(opt_shardings(m24, p, specs)),
            "zero1_fsdp": table(opt_shardings(m24, pf, specs)),
            "cache": table(cache_shardings(m24, model.cache_specs(8, 64)))}
        res[f"{arch}/{smoke}"]["plans"] = {
            mode: {k: str(v.hidden) for k, v in
                   plans_for(get_config(arch, smoke=smoke), m24,
                             mode).items()}
            for mode in ("coswitch", "fixed")}
res["batch"] = str(batch_sharding(m24).spec)
arrays = {}


def params_of(arch, variant=False):
    cfg = get_config(arch, smoke=True)
    if variant:
        cfg = dataclasses.replace(cfg, **%(variant)r)
    model = build_model(cfg)
    return model, jax.tree.map(
        lambda a: np.asarray(a) * np.float32(SCALE[arch]),
        model.init(jax.random.PRNGKey(0)))


def keep(prefix, tree):
    for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        arrays[f"{prefix}|{_path_str(p)}"] = np.asarray(leaf)


batch = {"tokens": jnp.asarray(tokens, jnp.int32)}


def wbatch(model):
    return {"tokens": jnp.asarray(tokens %% %(vocab)d, jnp.int32),
            "frames": jnp.asarray(frames[:, :model.cfg.enc_frames])}


for short, arch, variant, runs in (
        ("llama", "llama3p2_3b", False,
         [(1, 2, "coswitch"), (1, 2, "fixed"), (2, 2, "coswitch"),
          (2, 2, "fixed"), (1, 4, "coswitch"), (1, 4, "fixed")]),
        ("rwkv", "rwkv6_1p6b", False,
         [(1, 2, "coswitch"), (1, 2, "fixed")]),
        ("whisper", "whisper_small", False,
         [(1, 2, "coswitch"), (1, 4, "coswitch")]),
        ("whisper6", "whisper_small", True,
         [(1, 4, "coswitch"), (1, 4, "fixed")])):
    model, params = params_of(arch, variant)
    data = wbatch(model) if arch == "whisper_small" else batch
    for d, m, mode in runs:
        mesh_ = mesh(d, m)
        step = jax.jit(make_train_step(model, mesh_, layout_mode=mode))
        with mesh_:
            p2, _, met = step(params, adamw_init(params), data)
        key = f"train/{short}/{d}x{m}/{mode}"
        arrays[f"{key}|loss"] = np.asarray(met["loss"])
        keep(key, p2)
    keep(f"grad/{short}", jax.jit(jax.grad(model.loss))(params, data))

model, params = params_of("dbrx_132b")
model.mesh = mesh(1, 4)
with model.mesh:
    arrays["ep|loss"] = np.asarray(jax.jit(model.loss)(params, batch))

B, T = serve_tokens.shape
for short, arch, variant, meshes in (
        ("llama", "llama3p2_3b", False, ((1, 2), (2, 2), (1, 4))),
        ("whisper", "whisper_small", False, ((1, 2), (1, 4))),
        ("whisper6", "whisper_small", True, ((1, 4),))):
    model, params = params_of(arch, variant)
    wh = arch == "whisper_small"
    toks = jnp.asarray(serve_tokens %% (%(vocab)d if wh else 1 << 30),
                       jnp.int32)
    for d, m in meshes:
        mesh_ = mesh(d, m)
        with mesh_:
            pre = jit_prefill(model, mesh_, B, T, %(seq)d, frames=wh)
            cache, logits = pre(params, toks, wbatch(model)["frames"]) \
                if wh else pre(params, toks)
            step = jit_serve_step(model, mesh_, B, %(seq)d)
            outs = [np.asarray(logits)]
            for _ in range(%(steps)d):
                tok = jnp.argmax(logits, -1).astype(jnp.int32)
                cache, logits = step(params, cache, tok)
                outs.append(np.asarray(logits))
        arrays[f"serve/{short}/{d}x{m}|logits"] = np.stack(outs)
np.savez(out + ".npz", **arrays)
with open(out + ".json", "w") as f:
    json.dump(res, f)
''' % {"seq": SERVE_SEQ, "steps": SERVE_STEPS, "vocab": WH_VOCAB,
       "variant": worker.VARIANT}


# ------------------------------------------------------------- helpers
def _nest(flat):
    """``{"a/b": x}`` as ``{"a": {"b": x}}``."""
    out = {}
    for path, leaf in flat.items():
        node = out
        *parents, last = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = leaf
    return out


def _arch_variant(name):
    """(arch, variant) of a run's short name, or of an arch's own name."""
    return MODELS.get(name, (name, False))


def _jax_params(short):
    """``repro``'s SMOKE init (key 0) of a run's model (or an arch) at
    ``SCALE``, as numpy."""
    arch, variant = _arch_variant(short)
    cfg = jget_config(arch, smoke=True)
    if variant:
        cfg = dataclasses.replace(cfg, **worker.VARIANT)
    return jax.tree.map(lambda a: np.asarray(a) * np.float32(SCALE[arch]),
                        jbuild_model(cfg).init(jax.random.PRNGKey(0)))


def _f32(short):
    return worker.smoke_f32(*_arch_variant(short))


def _one_device(short, params):
    cfg = _f32(short)
    return api.build_model(cfg, device="cpu").load_params(
        api.to_torch_lm_params(params, cfg, "cpu"))


def _data(short, tokens=TOKENS):
    """A run's tokens (within whisper's vocabulary) and its frames."""
    cfg = _f32(short)
    if cfg.family != "encdec":
        return {"tokens": torch.from_numpy(tokens)}
    return {"tokens": torch.from_numpy(tokens % WH_VOCAB),
            "frames": torch.from_numpy(FRAMES[:, :cfg.enc_frames].copy())}


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    env.pop("XLA_FLAGS", None)
    return env


def _world(tmp, name, world, tasks):
    """Start one process per rank; returns (processes, result path)."""
    tmp.mkdir(parents=True, exist_ok=True)
    with open(tmp / f"{name}.tasks", "wb") as f:
        pickle.dump(tasks, f)
    out = tmp / f"{name}.out"
    code = textwrap.dedent(f"""
        import pickle, sys
        import torch_dist_worker as w
        with open({str(tmp / f'{name}.tasks')!r}, "rb") as f:
            tasks = pickle.load(f)
        w.run(int(sys.argv[1]), {world}, {str(tmp / f'{name}.store')!r},
              tasks, {str(out)!r})
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)],
                              env=_env(), cwd=str(ROOT),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    return procs, out


def _finish(procs, timeout=600):
    outs = []
    for p in procs:
        so, se = p.communicate(timeout=timeout)
        outs.append((p.returncode, so, se))
    return outs


def _torchrun(extra, tmp):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
           *LAUNCH, "--model-axis", "2", *extra]
    return subprocess.Popen(cmd, env=_env(), cwd=str(tmp),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _losses(text):
    return {int(m.group(1)): m.group(2) for m in re.finditer(
        r"step=(\d+) loss=([0-9.]+)", text)}


# ------------------------------------------------------------ the runs
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    params = {a: _jax_params(a) for a in MODELS}
    np.save(tmp / "tokens.npy", TOKENS)
    np.save(tmp / "serve.npy", SERVE_TOKENS)
    np.save(tmp / "frames.npy", FRAMES)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count"
               "=8", PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    repro = subprocess.Popen(
        [sys.executable, "-c", REPRO, str(tmp / "repro"),
         str(tmp / "tokens.npy"), str(tmp / "serve.npy"), json.dumps(SCALE),
         str(tmp / "frames.npy")],
        env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)

    toks = torch.from_numpy(TOKENS)
    llama, rwkv, dbrx = params["llama"], params["rwkv"], params["dbrx"]

    def run(short, kind, **kw):
        arch, variant = MODELS[short]
        data = _data(short, kw.pop("tokens", TOKENS))
        if kind == "serve":
            data["max_seq"], data["steps"] = SERVE_SEQ, SERVE_STEPS
        return {"arch": arch, "variant": variant, "params": params[short],
                **data, **kw}

    w2 = [("ckpt", "save", 2, {"arch": "llama3p2_3b", "params": llama,
                               "directory": str(tmp / "ckpt_mesh")}),
          ("dbrx/1x2/train", "train", 2,
           {"arch": "dbrx_132b", "params": dbrx,
            "tokens": toks[:, :MOE_TP_T + 1], "mode": "coswitch"}),
          ("dbrx/1x2/serve", "serve", 2,
           {"arch": "dbrx_132b", "params": dbrx,
            "tokens": torch.from_numpy(SERVE_TOKENS[:, :MOE_TP_T_SERVE]),
            "max_seq": SERVE_SEQ, "steps": SERVE_STEPS}),
          ("meshes", "meshes", 2, {}),
          ("ep_slots", "ep_slots", 1, {"arch": "dbrx_132b",
                                       "params": dbrx}),
          ("zamba2", "refuse", 2, {"arch": "zamba2_2p7b"}),
          ("whisper/1x2/coswitch", "train", 2,
           run("whisper", "train", mode="coswitch")),
          ("llama/1x2/serve", "serve", 2,
           run("llama", "serve", tokens=SERVE_TOKENS)),
          ("whisper/1x2/serve", "serve", 2,
           run("whisper", "serve", tokens=SERVE_TOKENS))]
    for mode in ("coswitch", "fixed"):
        w2 += [(f"llama/1x2/{mode}", "train", 2,
                {"arch": "llama3p2_3b", "params": llama, "tokens": toks,
                 "mode": mode}),
               (f"rwkv/1x2/{mode}", "train", 2,
                {"arch": "rwkv6_1p6b", "params": rwkv, "tokens": toks,
                 "mode": mode}),
               (f"rwkv/zero/{mode}", "loss", 2,
                {"arch": "rwkv6_1p6b", "params": rwkv, "tokens": toks,
                 "mode": mode, "zero_scan": True})]
    w4 = [("ep", "loss", 4, {"arch": "dbrx_132b",
                             "params": dbrx, "tokens": toks,
                             "mode": "coswitch"}),
          ("whisper/1x4/coswitch", "train", 4,
           run("whisper", "train", mode="coswitch"))]
    for ma, shape in ((2, "2x2"), (4, "1x4")):
        for mode in ("coswitch", "fixed"):
            w4.append((f"llama/{shape}/{mode}", "train", ma,
                       {"arch": "llama3p2_3b", "params": llama,
                        "tokens": toks, "mode": mode}))
        w4.append((f"llama/{shape}/serve", "serve", ma,
                   run("llama", "serve", tokens=SERVE_TOKENS)))
    for short in ("whisper", "whisper6"):
        w4.append((f"{short}/1x4/serve", "serve", 4,
                   run(short, "serve", tokens=SERVE_TOKENS)))
    for mode in ("coswitch", "fixed"):
        w4.append((f"whisper6/1x4/{mode}", "train", 4,
                   run("whisper6", "train", mode=mode)))
    p2, out2 = _world(tmp, "w2", 2, w2)
    p4, out4 = _world(tmp, "w4", 4, w4)
    runs_dir = tmp / "launch"
    runs_dir.mkdir()
    full = _torchrun(["--steps", "4"], runs_dir)
    half = _torchrun(["--steps", "2", "--ckpt-dir", "ck"], runs_dir)

    one = {short: _one_device(short, params[short]) for short in MODELS}
    ends = {"w2": _finish(p2), "w4": _finish(p4)}
    half_out = half.communicate(timeout=600)
    resumed = _torchrun(["--steps", "4", "--ckpt-dir", "ck"], runs_dir)
    full_out = full.communicate(timeout=600)
    launched = {"full": (full.returncode, *full_out),
                "half": (half.returncode, *half_out)}
    resumed_out = resumed.communicate(timeout=600)
    launched["resumed"] = (resumed.returncode, *resumed_out)
    rso, rse = repro.communicate(timeout=900)
    assert repro.returncode == 0, rse[-3000:]
    for name, out in (("w2", out2), ("w4", out4)):
        for rank, (code, so, se) in enumerate(ends[name]):
            err = out if rank == 0 else out.with_name(f"{out.name}.rank{rank}")
            if code and err.exists():
                with open(err, "rb") as f:
                    se += pickle.load(f).get("error", "")
            assert code == 0, (name, rank, se[-3000:])
    with open(out2, "rb") as f:
        r2 = pickle.load(f)
    with open(out4, "rb") as f:
        r4 = pickle.load(f)
    with open(tmp / "repro.json") as f:
        specs = json.load(f)
    ref = dict(np.load(tmp / "repro.npz"))
    return {"tmp": tmp, "params": params, "one": one, "port": {**r2, **r4},
            "repro_specs": specs, "repro": ref, "launched": launched}


# ------------------------------------------------------------ placements
def _port_tables(arch, smoke):
    specs = param_specs(get_config(arch, smoke=smoke))
    p = param_shardings(MESH_24, specs)
    pf = param_shardings(MESH_24, specs, fsdp=True)
    return specs, {"param": p, "fsdp": pf,
                   "zero1": opt_shardings(MESH_24, p, specs),
                   "zero1_fsdp": opt_shardings(MESH_24, pf, specs)}


def _cache_specs(arch, smoke):
    """The port's cache specs (they depend on the config alone), without
    building a model's weights."""
    from repro_torch.models import encdec, hybrid, lm
    cfg = get_config(arch, smoke=smoke)
    cls = {"hybrid": hybrid.HybridModel,
           "encdec": encdec.EncDecModel}.get(cfg.family, lm.LMModel)
    shell = cls.__new__(cls)
    object.__setattr__(shell, "cfg", cfg)
    return shell.cache_specs(8, 64)


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_placements_match_repro(runs, arch, smoke):
    got = runs["repro_specs"][f"{arch}/{smoke}"]
    cfg = get_config(arch, smoke=smoke)
    for mode, plans in got["plans"].items():
        port = plans_for(cfg, MESH_24, mode)
        assert {k: "PartitionSpec" + repr(v.hidden) for k, v in
                port.items()} == plans
    specs, tables = _port_tables(arch, smoke)
    for table, port in tables.items():
        want = got[table]
        seen = set()
        for name, spec in port.items():
            path, stacked = repro_path(name)
            rspec, rstr = want[path]
            rspec = tuple(tuple(a) if isinstance(a, list) else a
                          for a in rspec)
            rspec = rspec + (None,) * (len(specs[name][0]) + stacked
                                       - len(rspec))
            if stacked and not isinstance(spec, LayerSharded):
                spec = (None,) + spec
                stacked = False
            assert tuple(spec) == rspec, (table, name, spec, rspec)
            assert spec_str(name, port[name]) == rstr, (table, name)
            seen.add(path)
        assert seen == set(want), (table, sorted(set(want) - seen))
    port_cache = cache_shardings(MESH_24, _cache_specs(arch, smoke))
    flat = {}

    def walk(tree, prefix):
        for n, s in tree.items():
            if isinstance(s, dict):
                walk(s, f"{prefix}{n}/")
            else:
                flat[f"{prefix}{n}"] = s
    walk(port_cache, "")
    want = {k: tuple(tuple(a) if isinstance(a, list) else a for a in v[0])
            for k, v in got["cache"].items()}
    assert set(flat) == set(want)
    for k, spec in flat.items():
        assert spec == want[k] + (None,) * (len(spec) - len(want[k])), k


# ------------------------------------------------------------ train steps
def _one_step(short, params, tokens=TOKENS):
    """The one-device step: its loss, its gradients as the optimiser gets
    them, their global norm and the updated parameters."""
    model = _one_device(short, params)
    step = api.make_train_step(model)
    opt = api.adamw_init(model.params())
    with worker.clip_seen() as clip:
        opt, met = step(opt, _data(short, tokens))
    grads, gnorm = clip.seen[0]
    return {"loss": float(met["loss"]), "gnorm": gnorm,
            "grads": {n: g.numpy() for n, g in grads.items()},
            "params": {n: p.detach().numpy() for n, p in
                       model.params().items()}}


@pytest.fixture(scope="module")
def one_steps(runs):
    out = {s: _one_step(s, runs["params"][s])
           for s in ("llama", "rwkv", "whisper", "whisper6")}
    out["dbrx"] = _one_step("dbrx", runs["params"]["dbrx"],
                            TOKENS[:, :MOE_TP_T + 1])
    return out


def _close_params(got, want, grads):
    for name, w in want.items():
        g = got[name]
        keep = np.abs(grads[name]) >= 1e-7
        tol = 1e-5 * max(np.abs(w).max(), 1e-30)
        assert np.all(np.abs(g - w)[keep] <= tol), \
            (name, np.abs(g - w)[keep].max() / tol)


def _close_grads(got, want):
    """Every leaf within 1e-5 of its own max |g|: the magnitudes, which
    the first Adam step cannot see (it is about ``lr sign(g)``)."""
    assert set(got) == set(want)
    for name, w in want.items():
        tol = 1e-5 * max(np.abs(w).max(), 1e-30)
        err = np.abs(got[name] - w).max()
        assert err <= tol, (name, err / tol)


def _repro_params(runs, key, cfg):
    flat = {k.split("|", 1)[1]: v for k, v in runs["repro"].items()
            if k.startswith(key + "|") and not k.endswith("|loss")}
    return {n: t.numpy() for n, t in api.to_torch_lm_params(
        _nest(flat), cfg, "cpu").items()}


TRAIN = [("llama3p2_3b", "llama", shape, mode)
         for shape in ("1x2", "2x2", "1x4")
         for mode in ("coswitch", "fixed")] + \
        [("rwkv6_1p6b", "rwkv", "1x2", mode)
         for mode in ("coswitch", "fixed")] + \
        [("whisper_small", "whisper", shape, "coswitch")
         for shape in ("1x2", "1x4")] + \
        [("whisper_small", "whisper6", "1x4", mode)
         for mode in ("coswitch", "fixed")]


@pytest.mark.parametrize("arch,short,shape,mode", TRAIN,
                         ids=[f"{s}-{sh}-{m}" for _, s, sh, m in TRAIN])
def test_train_step_matches_one_device(runs, one_steps, arch, short, shape,
                                       mode):
    one = one_steps[short]
    got = runs["port"][f"{short}/{shape}/{mode}"]
    np.testing.assert_allclose(got["losses"][0], one["loss"], rtol=1e-5)
    _close_params(got["params"], one["params"], one["grads"])


@pytest.mark.parametrize("arch,short,shape,mode", TRAIN,
                         ids=[f"{s}-{sh}-{m}" for _, s, sh, m in TRAIN])
def test_train_step_gradients_match(runs, one_steps, arch, short, shape,
                                    mode):
    """The gradients the mesh step hands its optimiser, gathered whole,
    against the one-device step's and ``repro``'s (one device: GSPMD keeps
    the semantics), and the clip's global norm, which the sharded
    ``reduce`` sums over the ranks, against the one-device norm."""
    one = one_steps[short]
    got = runs["port"][f"{short}/{shape}/{mode}"]
    _close_grads(got["grads"], one["grads"])
    _close_grads(got["grads"], _repro_params(runs, f"grad/{short}",
                                             _f32(short)))
    np.testing.assert_allclose(got["gnorm"], one["gnorm"], rtol=1e-5)


@pytest.mark.parametrize("arch,short,shape,mode", TRAIN,
                         ids=[f"{s}-{sh}-{m}" for _, s, sh, m in TRAIN])
def test_train_step_matches_repro_mesh(runs, one_steps, arch, short, shape,
                                       mode):
    key = f"train/{short}/{shape}/{mode}"
    got = runs["port"][f"{short}/{shape}/{mode}"]
    np.testing.assert_allclose(got["losses"][0],
                               float(runs["repro"][f"{key}|loss"]),
                               rtol=1e-5)
    _close_params(got["params"], _repro_params(runs, key, _f32(short)),
                  one_steps[short]["grads"])


def test_layout_modes_call_their_collectives(runs):
    """coswitch reduce-scatters into the sequence-sharded stream over the
    model group; fixed all-reduces and never reduce-scatters the stream
    over it.  Where llama's 2 KV heads divide the model axis (1x2, 2x2)
    fixed has no reduce-scatter over the model group at all (the step's
    ZeRO-1 reduce-scatters of the gradients run over the data group); at
    1x4 its attention splits the sequence, and the gradients of what it
    gathered (the weights, K/V) reduce-scatter back over the model group
    in both modes, fewer bytes than coswitch, which also reduce-scatters
    the stream.  Every mesh run called collectives."""
    port = runs["port"]
    for shape in ("1x2", "2x2", "1x4"):
        cos, fix = (port[f"llama/{shape}/{m}"]["calls"]
                    for m in ("coswitch", "fixed"))
        rs_cos = cos["by_dim"].get("reduce_scatter/model", 0)
        rs_fix = fix["by_dim"].get("reduce_scatter/model", 0)
        assert rs_cos > 0
        assert cos["all_gather"] > 0
        if shape == "1x4":
            assert 0 < rs_fix < rs_cos
        else:
            assert rs_fix == 0
        assert fix["all_reduce"] > 0
        assert set(fix["by_dim"]) <= {f"{k}/{d}" for k in col_kinds()
                                      for d in ("model", "data")}


def col_kinds():
    from repro_torch.distributed import collectives as col
    return tuple(col.CALLS)


def test_rwkv6_tests_see_the_scan(runs):
    """Zeroing the scan on the mesh moves the loss: the checks above see
    the ``linear_scan`` path."""
    base = runs["one"]["rwkv"]
    with torch.no_grad():
        want = float(base.loss({"tokens": torch.from_numpy(TOKENS)}))
    for mode in ("coswitch", "fixed"):
        zero = runs["port"][f"rwkv/zero/{mode}"]["loss"]
        assert abs(zero - want) > 1e-3 * abs(want), (zero, want)


# ----------------------------------------------------------------- MoE EP
def test_moe_ep_matches_repro_and_local(runs):
    got = runs["port"]["ep"]
    assert got["calls"]["all_to_all_single"] > 0
    np.testing.assert_allclose(got["loss"], float(runs["repro"]["ep|loss"]),
                               rtol=1e-5)
    with torch.no_grad():
        local = float(runs["one"]["dbrx"].loss(
            {"tokens": torch.from_numpy(TOKENS)}))
    assert abs(got["loss"] - local) < 2e-3


def test_moe_without_ep_matches_one_device(runs, one_steps):
    """Where EP does not apply (T odd on a model axis of 2) each rank runs
    its experts on the replicated stream: the train step's loss, its
    gradients, the clip's norm and the updated parameters equal the
    one-device step's (the capacity is the same), with no all-to-all."""
    one = one_steps["dbrx"]
    got = runs["port"]["dbrx/1x2/train"]
    np.testing.assert_allclose(got["losses"][0], one["loss"], rtol=1e-5)
    _close_grads(got["grads"], one["grads"])
    np.testing.assert_allclose(got["gnorm"], one["gnorm"], rtol=1e-5)
    _close_params(got["params"], one["params"], one["grads"])
    assert got["calls"]["all_to_all_single"] == 0
    assert got["calls"]["all_reduce"] > 0


def test_moe_ep_reports_moe_apply_slots_at_model_axis_one(runs):
    """On a model axis of 1 (data 2) the EP block's own slots equal
    ``moe_apply``'s dispatch, drops included (some tokens are dropped),
    and the outputs agree to f32 rounding."""
    got = runs["port"]["ep_slots"]
    assert got["C"] == got["C_ep"] and got["same_slots"]
    assert got["dropped"] > 0
    assert got["max_abs_err"] <= 1e-6 * got["ref_max_abs"]


# ------------------------------------------------------------------ serve
def _one_device_serve(model, tokens, frames=None):
    with torch.no_grad():
        if frames is None:
            cache, logits = model.prefill(torch.from_numpy(tokens), SERVE_SEQ)
        else:
            cache, logits = model.prefill(torch.from_numpy(tokens), SERVE_SEQ,
                                          frames=frames)
        outs = [logits]
        for _ in range(SERVE_STEPS):
            cache, logits = model.decode_step(cache, outs[-1].argmax(-1))
            outs.append(logits)
    return torch.stack(outs).numpy()


def test_moe_serve_without_ep_matches_one_device(runs):
    """dbrx's prefill (an odd prompt) and decode steps on a model axis of
    2, each MoE block through ``moe_apply_tp``: logits within 1e-5 of the
    max |logit| of one device's, greedy tokens identical."""
    want = _one_device_serve(runs["one"]["dbrx"],
                             SERVE_TOKENS[:, :MOE_TP_T_SERVE])
    got = runs["port"]["dbrx/1x2/serve"]
    assert np.abs(got["logits"] - want).max() <= 1e-5 * np.abs(want).max()
    assert np.array_equal(got["logits"].argmax(-1), want.argmax(-1))
    assert got["calls"]["all_to_all_single"] == 0


SERVE = [("llama", "1x2"), ("llama", "2x2"), ("llama", "1x4"),
         ("whisper", "1x2"), ("whisper", "1x4"), ("whisper6", "1x4")]
#: where the KV heads do not divide the model axis, a decode step's
#: self-attention over the cache split by sequence runs the partial kernel
#: (the variant's cross cache, 30 frames on 4 ranks, stays whole)
SPLIT_S = {("llama", "1x4"): 1, ("whisper6", "1x4"): 1}


@pytest.mark.parametrize("short,shape", SERVE,
                         ids=[f"{s}-{sh}" for s, sh in SERVE])
def test_serve_and_prefill_steps_match(runs, short, shape):
    """``prefill_step`` then greedy ``serve_step``s on the mesh against
    the one-device model's and ``repro``'s sharded steps: logits within
    1e-5 of the max |logit|, greedy tokens identical.  Where the KV heads
    do not divide the model axis a decode step's self-attention runs
    ``gqa_decode_partial`` on the rank's sequence block of its cache (the
    variant's cross-attention, over a cache kept whole, ``gqa_decode``);
    elsewhere every attention runs ``gqa_decode``."""
    data = _data(short, SERVE_TOKENS)
    want = _one_device_serve(runs["one"][short], data["tokens"].numpy(),
                             data.get("frames"))
    got = runs["port"][f"{short}/{shape}/serve"]
    scale = np.abs(want).max()
    assert np.abs(got["logits"] - want).max() <= 1e-5 * scale
    assert np.array_equal(got["logits"].argmax(-1), want.argmax(-1))
    theirs = runs["repro"][f"serve/{short}/{shape}|logits"]
    assert np.abs(got["logits"] - theirs).max() <= \
        1e-5 * np.abs(theirs).max()
    calls = got["calls"]
    assert calls["all_reduce"] > 0 and calls["all_gather"] > 0
    cfg = _f32(short)
    n = cfg.n_layers * SERVE_STEPS * (2 if cfg.family == "encdec" else 1)
    split = SPLIT_S.get((short, shape), 0) * cfg.n_layers * SERVE_STEPS
    assert got["kernel_calls"] == {"gqa_decode": n - split,
                                   "gqa_decode_partial": split}


# ------------------------------------------------------- launcher, ckpt
def test_launcher_two_ranks_match_one(runs):
    code, so, se = runs["launched"]["full"]
    assert code == 0, se[-3000:]
    got = _losses(se + so)
    args = launch_train.parse_args(LAUNCH + ["--steps", "4"])
    want = {s: f"{v:.4f}" for s, v in launch_train.train(args)["losses"]
            .items()}
    assert got == want


def test_launcher_resume_under_mesh(runs):
    full = _losses("".join(runs["launched"]["full"][1:]))
    for name in ("half", "resumed"):
        assert runs["launched"][name][0] == 0, runs["launched"][name][2]
    resumed = "".join(runs["launched"]["resumed"][1:])
    assert "resumed from step 2" in resumed
    got = _losses(resumed)
    assert set(got) == {2, 3}
    assert got == {s: full[s] for s in (2, 3)}


def test_mesh_checkpoint_bytes(runs):
    """A 2-rank trainer checkpoint (params and optimiser state) writes the
    one-device save's bytes, but for the manifest's sharding strings,
    which are ``repro``'s; the trainer's resume puts every block back on
    the mesh, the packed ``wkv`` in its KV-head order included."""
    tmp = runs["tmp"]
    got = runs["port"]["ckpt"]
    assert got["restored_blocks_equal"] and got["kv_checked"] == 2
    assert got["checked"] == 4 * len(param_specs(_f32("llama")))
    assert got["step"] == got["opt_step"] == 3
    model = runs["one"]["llama"]
    save_pytree(launch_train._ckpt_tree(model, worker.train_state(model),
                                        model.cfg),
                tmp / "ckpt_one")
    a, b = tmp / "ckpt_mesh" / "step_00000003", tmp / "ckpt_one"
    files = sorted(p.relative_to(b) for p in b.rglob("*.npy"))
    assert files == sorted(p.relative_to(a) for p in a.rglob("*.npy"))
    for rel in files:
        assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel
    ma = json.loads((a / "manifest.json").read_text())
    mb = json.loads((b / "manifest.json").read_text())
    specs = runs["repro_specs"]["llama3p2_3b/True"]
    for la, lb in zip(ma["leaves"], mb["leaves"]):
        assert lb["sharding"] == ""
        assert {**la, "sharding": ""} == lb
        tree, rest = la["name"].split("__", 1)
        if rest == "step":
            assert la["sharding"] == "PartitionSpec()"
            continue
        table = "param"
        if tree == "opt":
            table, rest = "zero1", rest.split("__", 1)[1]
        assert la["sharding"] == specs[table][rest.replace("__", "/")][1]
    da = json.loads((a / "digests.json").read_text())
    db = json.loads((b / "digests.json").read_text())
    assert {k: v for k, v in da.items() if k != "manifest.json"} == \
        {k: v for k, v in db.items() if k != "manifest.json"}


def test_checkpoint_shardings_strings(runs):
    """The trainer's manifest strings: ``shardings_for_train``'s
    placements as ``repro`` shows them (no FSDP at SMOKE size)."""
    specs = runs["repro_specs"]["llama3p2_3b/True"]

    class Shell:
        cfg = get_config("llama3p2_3b", smoke=True)
    tree = checkpoint_shardings(Shell, {"data": 2, "model": 4})
    for name, s in tree["params"]["layers"]["mixer"].items():
        if isinstance(s, dict):
            name, s = f"{name}/w", s["w"]
        assert s == specs["param"][f"layers/mixer/{name}"][1]
    assert tree["opt"].step == "PartitionSpec()"
    assert tree["opt"].mu["embed"] == specs["zero1"]["embed"][1]


def test_layer_boundary_layouts(runs):
    """``hidden_sharding``: sequence-sharded in coswitch where T divides
    the model axis, else (and always in fixed) batch-sharded; the batch
    layout is ``repro``'s."""
    assert "PartitionSpec" + repr(batch_sharding(MESH_24)) == \
        runs["repro_specs"]["batch"]
    cos, fix = (hidden_sharding(MESH_24, m) for m in ("coswitch", "fixed"))
    assert cos(32) == ("data", "model", None)
    assert cos(33) == fix(32) == fix(33) == ("data", None, None)
    with pytest.raises(ValueError):
        hidden_sharding(MESH_24, "diagonal")


def test_mesh_builders(runs):
    """``make_local_mesh`` over a world of 2: (2, 1) and (1, 2), and it
    refuses a model axis that does not divide the world;
    ``make_production_mesh`` refuses a world that is not 16 x 16."""
    got = runs["port"]["meshes"]
    assert got["shapes"] == [[2, 1], [1, 2]]
    assert got["names"] == ["data", "model"]
    assert "does not divide" in got["local_3"]
    assert "needs 256 ranks" in got["production"]


# --------------------------------------------------------------- refusals
@pytest.mark.parametrize("arch", ["zamba2"])
def test_model_axis_refusals(runs, arch):
    got = runs["port"][arch]
    assert got["raised"] == "NotImplementedError"
    assert "item 10b (b)" in got["message"]
