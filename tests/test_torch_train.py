"""The port's training half on the CPU against the JAX package's.

Loss and every gradient of the SMOKE rwkv6 (the ``linear_scan`` path, its
parameters at 10x the init scale so that the scan shapes the loss) and
minicpm_2b (the config ``repro``'s system tests train) against
``jax.value_and_grad(model.loss)`` on the same parameters and tokens: the
loss at rtol 1e-5, each gradient within 1e-4 of its own max |g| (f32 on
both sides, sums in other orders).  AdamW is held to ``repro``'s update on
identical inputs at 1e-6 (the first Adam step is about sign(g), so only
identical gradients compare), the schedules and the data stream exactly or
to f32 rounding, and a 3-step ``make_train_step`` trajectory against
``repro``'s on a 1-device mesh at rtol 1e-3.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from numpy.testing import assert_allclose

from repro.configs import get_config as jget_config
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLMStream as JSyntheticLMStream
from repro.distributed.stepfn import make_train_step as jmake_train_step
from repro.launch.mesh import make_local_mesh
from repro.models import build_model as jbuild_model
from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro_torch import api
from repro_torch.configs import get_config
from repro_torch.launch import train as launch_train
from repro_torch.optim import adamw, schedule
from repro_torch.weights import to_torch_lm_params

ARCHS = ["rwkv6_1p6b", "minicpm_2b"]
#: x the 0.02 init for the loss/gradient parity: rwkv6's scan output lies
#: below its ``ln_x`` epsilon at 0.02 and would leave the loss untouched
SCALE = {"rwkv6_1p6b": 10.0, "minicpm_2b": 1.0}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_model(arch, params):
    cfg = get_config(arch, smoke=True)
    return cfg, api.build_model(cfg, device="cpu").load_params(
        to_torch_lm_params(params, cfg, "cpu"))


# ------------------------------------------------------------ loss and grads
@pytest.fixture(scope="module", params=ARCHS)
def grads_pair(request):
    arch = request.param
    jm = jbuild_model(jget_config(arch, smoke=True))
    params = jax.tree.map(lambda a: np.asarray(a) * np.float32(SCALE[arch]),
                          jm.init(jax.random.PRNGKey(7)))
    toks = np.random.default_rng(8).integers(
        0, jm.cfg.vocab, size=(2, 129)).astype(np.int32)
    loss, grads = jax.value_and_grad(jm.loss)(params,
                                              {"tokens": jnp.asarray(toks)})
    cfg, model = _port_model(arch, params)
    return {"cfg": cfg, "model": model, "toks": toks,
            "j_loss": float(loss),
            "j_grads": to_torch_lm_params(jax.tree.map(np.asarray, grads),
                                          cfg, "cpu")}


def test_loss_and_grads_match_jax(grads_pair):
    m = grads_pair["model"]
    m.requires_grad_(True)
    params = m.params()
    loss = m.loss({"tokens": torch.from_numpy(grads_pair["toks"])})
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert_allclose(float(loss.detach()), grads_pair["j_loss"], rtol=1e-5)
    grads = torch.autograd.grad(loss, list(params.values()))
    assert len(grads) == len(grads_pair["j_grads"])
    for (name, _), g in zip(params.items(), grads):
        want = grads_pair["j_grads"][name].numpy()
        assert_allclose(g.numpy(), want, rtol=0,
                        atol=1e-4 * np.abs(want).max(), err_msg=name)


def test_loss_without_remat_and_without_grad_is_the_same(grads_pair):
    """``remat`` and the per-chunk checkpoints of the loss change no number;
    under ``no_grad`` neither is taken."""
    m, toks = grads_pair["model"], torch.from_numpy(grads_pair["toks"])
    with torch.no_grad():
        plain = m.loss({"tokens": toks})
        hid = m.hidden_states(toks[:, :-1], remat=False)
    m.requires_grad_(True)
    assert torch.equal(m.loss({"tokens": toks}).detach(), plain)
    assert torch.equal(hid, m.hidden_states(toks[:, :-1]).detach())


def test_chunked_ce_loss_matches_full_softmax():
    """Chunks of 512 positions, summed in order, against one softmax over
    the whole (B, T, V) logits; and a T the chunk does not tile raises."""
    from repro_torch.models.lm import chunked_ce_loss
    cfg = get_config("minicpm_2b", smoke=True)
    m = api.build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    hidden = torch.randn(2, 1024, cfg.d_model, generator=gen)
    tgt = torch.randint(0, cfg.vocab, (2, 1024), generator=gen)
    full = torch.nn.functional.cross_entropy(
        m.logits(hidden).reshape(-1, cfg.vocab), tgt.reshape(-1))
    got = chunked_ce_loss(m, hidden, tgt)
    torch.testing.assert_close(got, full, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="multiple"):
        chunked_ce_loss(m, hidden[:, :600], tgt[:, :600])


def test_serving_builds_no_autograd_graph_and_training_does():
    cfg = get_config("rwkv6_1p6b", smoke=True)
    m = api.build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    assert not any(p.requires_grad for p in m.params().values())
    toks = torch.zeros(1, 9, dtype=torch.long)
    assert not m.loss({"tokens": toks}).requires_grad
    api.make_train_step(m)
    assert all(p.requires_grad for p in m.params().values())
    assert m.loss({"tokens": toks}).requires_grad


# --------------------------------------------------------------------- AdamW
def _opt_inputs(seed, grad_scale):
    rng = np.random.default_rng(seed)
    shapes = {"a": (16, 8), "b": (5,), "c": (3, 4, 2)}
    params = {n: (rng.normal(size=s) * 0.02).astype(np.float32)
              for n, s in shapes.items()}
    grads = [{n: (rng.normal(size=s) * grad_scale).astype(np.float32)
              for n, s in shapes.items()} for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("grad_scale", [1e-3, 1.0])   # unclipped, clipped
def test_adamw_update_matches_jax(grad_scale):
    """Three updates on identical numpy grads, params and state: moments,
    master and params at 1e-6, the step counted as in JAX."""
    params, grads = _opt_inputs(0, grad_scale)
    jp = {n: jnp.asarray(p) for n, p in params.items()}
    jst = jadamw.adamw_init(jp)
    tp = {n: torch.from_numpy(p.copy()) for n, p in params.items()}
    tst = adamw.adamw_init(tp)
    for i, g in enumerate(grads):
        lr = 3e-3 * (i + 1)
        jp, jst = jadamw.adamw_update({n: jnp.asarray(x) for n, x in
                                       g.items()}, jst, jp, lr)
        tp, tst = adamw.adamw_update({n: torch.from_numpy(x) for n, x in
                                      g.items()}, tst, tp, lr)
        assert tst.step == int(jst.step) == i + 1
        for n in params:
            for got, want in ((tst.mu[n], jst.mu[n]), (tst.nu[n], jst.nu[n]),
                              (tst.master[n], jst.master[n]),
                              (tp[n], jp[n])):
                assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                atol=1e-6, err_msg=f"step {i} {n}")


def test_adamw_bf16_params_and_master_never_aliases():
    params, grads = _opt_inputs(1, 1e-2)
    tp = {n: torch.from_numpy(p).to(torch.bfloat16) for n, p in
          params.items()}
    f32 = torch.from_numpy(params["a"].copy())
    st = adamw.adamw_init({"a": f32})
    assert st.master["a"].data_ptr() != f32.data_ptr()
    f32.add_(1.0)
    assert not torch.equal(st.master["a"], f32)
    jp = {n: jnp.asarray(p, jnp.bfloat16) for n, p in params.items()}
    jst = jadamw.adamw_init(jp)
    tst = adamw.adamw_init(tp)
    g = {n: x.astype(np.float32) for n, x in grads[0].items()}
    tp, tst = adamw.adamw_update({n: torch.from_numpy(x).to(torch.bfloat16)
                                  for n, x in g.items()}, tst, tp, 1e-2)
    jp, jst = jadamw.adamw_update({n: jnp.asarray(x, jnp.bfloat16)
                                   for n, x in g.items()}, jst, jp, 1e-2)
    for n in params:
        assert tp[n].dtype == torch.bfloat16
        assert_allclose(tst.master[n].numpy(), np.asarray(jst.master[n]),
                        rtol=1e-6, atol=1e-6)
        assert_allclose(tp[n].float().numpy(),
                        np.asarray(jp[n], np.float32), rtol=1e-2, atol=1e-6)


def test_clip_by_global_norm_matches_jax():
    _, grads = _opt_inputs(2, 1.0)
    g = grads[0]
    tc, tn = adamw.clip_by_global_norm(
        {n: torch.from_numpy(x) for n, x in g.items()}, 1.0)
    jc, jn = jadamw.clip_by_global_norm({n: jnp.asarray(x) for n, x in
                                         g.items()}, 1.0)
    assert_allclose(float(tn), float(jn), rtol=1e-6)
    for n in g:
        assert_allclose(tc[n].numpy(), np.asarray(jc[n]), rtol=1e-6,
                        atol=1e-8)


# ----------------------------------------------------------------- schedules
def test_schedules_match_jax():
    kw = dict(peak_lr=3e-3, warmup=5, stable=10, decay=7)
    for s in range(0, 30):
        assert_allclose(schedule.wsd_schedule(s, **kw),
                        float(jschedule.wsd_schedule(s, **kw)), rtol=1e-6)
        assert_allclose(
            schedule.cosine_schedule(s, peak_lr=1e-3, warmup=4, total=25),
            float(jschedule.cosine_schedule(s, peak_lr=1e-3, warmup=4,
                                            total=25)), rtol=1e-6)
    assert schedule.wsd_schedule(0, **kw) == 0.0
    assert isinstance(schedule.wsd_schedule(3, **kw), float)


# ----------------------------------------------------------------------- data
@pytest.mark.parametrize("kw", [
    dict(vocab=512, global_batch=8, seq_len=64),
    dict(vocab=65536, global_batch=4, seq_len=33, seed=5, shard=1,
         num_shards=2, frames_dim=8, frames_len=3),
])
def test_synthetic_stream_is_byte_identical_to_jax(kw):
    mine = api.SyntheticLMStream(api.DataConfig(**kw))
    theirs = JSyntheticLMStream(JDataConfig(**kw))
    for step in (0, 1, 17):
        a, b = mine.batch_at(step), theirs.batch_at(step)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            assert a[k].tobytes() == b[k].tobytes()


# ---------------------------------------------------------------- train step
@pytest.mark.parametrize("arch,accum,sched", [
    ("rwkv6_1p6b", 1, True), ("minicpm_2b", 2, False)])
def test_train_trajectory_matches_jax(arch, accum, sched):
    """Three steps of ``make_train_step`` (WSD schedule, or a constant lr
    with 2 accumulated microbatches) against ``repro``'s on a 1-device
    mesh, from the same parameters and batches: losses at rtol 1e-3."""
    jm = jbuild_model(jget_config(arch, smoke=True))
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    cfg, model = _port_model(arch, params)

    def wsd(s):
        return schedule.wsd_schedule(s, peak_lr=1e-2, warmup=1, stable=1,
                                     decay=1)

    def jwsd(s):
        return jschedule.wsd_schedule(s, peak_lr=1e-2, warmup=1, stable=1,
                                      decay=1)

    stream = api.SyntheticLMStream(api.DataConfig(vocab=cfg.vocab,
                                                  global_batch=4, seq_len=32))
    step = api.make_train_step(model, accum=accum, lr=1e-2,
                               schedule=wsd if sched else None)
    opt = api.adamw_init(model.params())
    mesh = make_local_mesh()
    jstep = jax.jit(jmake_train_step(jm, mesh, accum=accum, lr=1e-2,
                                     schedule=jwsd if sched else None))
    jp = jax.tree.map(jnp.asarray, params)
    jopt = jadamw.adamw_init(jp)
    losses, jlosses, lrs, jlrs = [], [], [], []
    with mesh:
        for s in range(3):
            batch = stream.batch_at(s)
            opt, m = step(opt, batch)
            jp, jopt, jm_ = jstep(jp, jopt, {"tokens": jnp.asarray(
                batch["tokens"])})
            losses.append(float(m["loss"]))
            jlosses.append(float(jm_["loss"]))
            lrs.append(m["lr"])
            jlrs.append(float(jm_["lr"]))
    assert opt.step == 3 and np.isfinite(losses).all()
    assert_allclose(losses, jlosses, rtol=1e-3)
    assert_allclose(lrs, jlrs, rtol=1e-6)
    assert losses[-1] != losses[0]                  # the params moved


def test_launcher_trains_on_the_cpu():
    """``python -m repro_torch.launch.train --arch rwkv6_1p6b --smoke
    --device cpu --steps 3``: exit 0, finite losses on the log lines."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "rwkv6_1p6b", "--smoke", "--device", "cpu", "--steps", "3",
         "--batch", "2", "--seq", "64", "--log-every", "1"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    losses = [float(line.split("loss=")[1].split()[0])
              for line in out.stdout.splitlines() if "loss=" in line]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert "done" in out.stdout


def test_launcher_refuses_what_is_not_ported(monkeypatch):
    base = ["--arch", "rwkv6_1p6b", "--smoke", "--device", "cpu",
            "--steps", "1"]
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        launch_train.main(base + ["--model-axis", "2"])
    with pytest.raises(SystemExit):
        launch_train.main(base + ["--layout-mode", "coswitch"])
    assert launch_train.parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--arch", "rwkv6_1p6b", "--smoke", "--steps", "1"])
