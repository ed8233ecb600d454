"""The port's network executor on the CPU against the JAX package's.

One plan (made by the port's planner and handed to the JAX package through
its JSON), one set of numpy weights and inputs from a seed: the port's
``execute_network(device="cpu")`` must match ``repro``'s
``execute_network(use_pallas=False)`` and ``repro``'s reference, at the JAX
executor tests' tolerance (rtol 1e-4, atol 1e-3: fp32 GEMMs summed in other
orders).  The JAX side runs under ``jax.jit``: the same ops as one XLA
program, compiled once instead of dispatched one by one.  GEMM chains
(``execute_plan``/``execute_plan_reference``) are held to ``repro``'s the
same way.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.plan as jplan
from repro.core.dataflow import ConvWorkload as JConv
from repro_torch.core.dataflow import ConvWorkload
from repro_torch.core.layout import Layout
from repro_torch.core.layoutloop import EvalConfig
from repro_torch.core.workloads import init_graph_weights
from repro_torch.plan import executor as executor_mod
from repro_torch.plan import (NetworkPlanner, PlanError,
                              PlannerOptions, adapt_activation,
                              execute_network, execute_network_reference,
                              execute_plan, execute_plan_reference,
                              fold_batchnorm, from_layers, layout_block_perm,
                              mobilenet_v3_graph, prepare_network,
                              prepare_plan, resnet50_graph)
from repro_torch.weights import to_torch_weights

LAYOUTS = ("HWC_C32", "HWC_H32", "HWC_C4W8")
TOL = dict(rtol=1e-4, atol=1e-3)


def make_plan(graph, layouts=LAYOUTS, modes=("rir",)):
    opts = PlannerOptions(switch_modes=modes,
                          layouts=tuple(Layout.parse(s) for s in layouts),
                          parallel_dims=("C", "P", "Q"))
    return NetworkPlanner(graph, EvalConfig(), opts).plan()


def jax_twin(graph, plan):
    """The same graph and plan as the JAX package's objects."""
    layers = [JConv(**{f.name: getattr(wl, f.name)
                       for f in dataclasses.fields(wl)})
              for wl in graph.layers]
    jg = jplan.LayerGraph(name=graph.name, layers=tuple(layers),
                          skip_edges=graph.skip_edges)
    return jg, jplan.ExecutionPlan.from_json(plan.to_json())


def run_three(graph, plan, *, ws=None, seed=0, relu=False, biases=None):
    """(port, repro XLA path, repro reference) outputs as numpy."""
    if ws is None:
        ws = init_graph_weights(list(graph.layers), seed=seed)
    x = np.random.default_rng(seed + 1).normal(
        size=graph.input_shape()).astype(np.float32)
    jg, jp = jax_twin(graph, plan)
    assert jg.graph_hash() == graph.graph_hash()
    t_act = torch.relu if relu else None
    j_act = (lambda t: jnp.maximum(t, 0)) if relu else None
    jb = None if biases is None else [jnp.asarray(b) for b in biases]
    y = execute_network(plan, graph, x, ws, activation=t_act, biases=biases,
                        device="cpu")
    assert y.device.type == "cpu" and y.dtype == torch.float32
    y_jax = jax.jit(lambda a: jplan.execute_network(
        jp, jg, a, ws, activation=j_act, use_pallas=False,
        biases=jb))(jnp.asarray(x))
    y_ref = jax.jit(lambda a: jplan.execute_network_reference(
        jg, a, ws, activation=j_act, biases=jb))(jnp.asarray(x))
    return y.numpy(), np.asarray(y_jax), np.asarray(y_ref)


@pytest.mark.parametrize("M,C,R,S,stride,P,Q", [
    (64, 16, 3, 3, 1, 14, 14),     # plain 3x3
    (96, 32, 3, 3, 2, 8, 8),       # strided
    (128, 64, 5, 5, 1, 7, 7),      # 5x5, M = one kernel block
    (256, 128, 1, 1, 1, 16, 16),   # GEMM-able 1x1, permutable M
    (40, 24, 3, 1, 1, 10, 12),     # asymmetric taps, ragged channels
    (384, 256, 3, 3, 2, 7, 7),     # strided with permutable in/out blocks
])
def test_single_conv_matches_jax(M, C, R, S, stride, P, Q):
    wl = ConvWorkload(M=M, C=C, P=P, Q=Q, R=R, S=S, stride=stride,
                      name="conv")
    graph = from_layers([wl], "one")
    y, y_jax, y_ref = run_three(graph, make_plan(graph))
    np.testing.assert_allclose(y, y_jax, **TOL)
    np.testing.assert_allclose(y, y_ref, **TOL)
    # the port's own reference is the same oracle
    ws = init_graph_weights([wl], seed=0)
    x = np.random.default_rng(1).normal(
        size=graph.input_shape()).astype(np.float32)
    np.testing.assert_allclose(
        execute_network_reference(graph, x, ws, device="cpu").numpy(),
        y_ref, rtol=1e-5, atol=1e-5)


def test_depthwise_matches_jax():
    wl = ConvWorkload(M=72, C=1, P=14, Q=14, R=5, S=5, stride=2, name="dw")
    graph = from_layers([wl], "dw1")
    plan = make_plan(graph)
    assert plan.steps[0].lowering == "depthwise"
    y, y_jax, y_ref = run_three(graph, plan)
    np.testing.assert_allclose(y, y_jax, **TOL)
    np.testing.assert_allclose(y, y_ref, **TOL)


def _bn_biases(graph, ws, seed):
    """BatchNorm statistics from a seed, folded by both packages."""
    rng = np.random.default_rng(seed)
    folded, biases = [], []
    for wl, w in zip(graph.layers, ws):
        g, b, m = (rng.normal(size=wl.M).astype(np.float32)
                   for _ in range(3))
        v = rng.uniform(0.5, 2.0, size=wl.M).astype(np.float32)
        fw, fb = fold_batchnorm(w, g, b, m, v)
        jw, jb = jplan.fold_batchnorm(w, g, b, m, v)
        np.testing.assert_allclose(fw.numpy(), np.asarray(jw), rtol=1e-6)
        np.testing.assert_allclose(fb.numpy(), np.asarray(jb), rtol=1e-6,
                                   atol=1e-6)
        folded.append(np.array(jw))
        biases.append(fb.numpy())
    return folded, biases


@pytest.mark.parametrize("name", ["resnet50", "mobv3"])
def test_full_network_with_relu_and_batchnorm_matches_jax(name):
    graph = resnet50_graph() if name == "resnet50" else mobilenet_v3_graph()
    plan = make_plan(graph, layouts=("HWC_C32", "HWC_H32"))
    assert all(s.kernel == "rir_matmul" for s in plan.steps)
    ws = init_graph_weights(list(graph.layers), seed=0)
    folded, biases = _bn_biases(graph, ws, seed=11)
    y, y_jax, y_ref = run_three(graph, plan, ws=folded, relu=True,
                                biases=biases)
    assert y.shape == tuple(graph.layers[-1].dims()[k] for k in "NPQM")
    np.testing.assert_allclose(y, y_jax, **TOL)
    np.testing.assert_allclose(y, y_ref, **TOL)


def residual_gemm_graph():
    """GEMM trunk whose skip endpoints share shape (512 features)."""
    return from_layers([
        ConvWorkload.from_gemm(M=512, N=128, K=256, name="in"),
        ConvWorkload.from_gemm(M=512, N=128, K=512, name="mid"),
        ConvWorkload.from_gemm(M=512, N=128, K=512, name="out"),
    ], "res-mlp", skip_edges=((0, 2),))


def _force_boundaries(plan, names):
    """Rewrite a plan's boundary layouts (and derived perms/joins)."""
    steps = []
    for i, s in enumerate(plan.steps):
        n_blocks = s.workload.M // 128 if s.workload.M % 128 == 0 else 0
        joins = tuple(dataclasses.replace(
            j, src_layout=names[j.src + 1],
            relayout="none" if names[j.src + 1] == names[i + 1] else "offchip")
            for j in s.joins)
        steps.append(dataclasses.replace(
            s, in_layout=names[i], out_layout=names[i + 1],
            epilogue_perm=(layout_block_perm(names[i + 1], n_blocks)
                           if n_blocks >= 1 else None),
            joins=joins))
    return dataclasses.replace(plan, steps=tuple(steps))


@pytest.fixture(scope="module")
def res_plan():
    return make_plan(residual_gemm_graph())


@pytest.mark.parametrize("names,fused", [
    (["HWC_C32", "HWC_C32", "HWC_C32", "HWC_C32"], True),
    (["HWC_C32", "HWC_H32", "HWC_C32", "HWC_C4W8"], False),
])
def test_residual_join_fused_and_relayout(res_plan, names, fused):
    graph = residual_gemm_graph()
    plan = _force_boundaries(res_plan, names)
    ws = init_graph_weights(list(graph.layers), seed=5)
    prepared = prepare_network(plan, graph, ws, device="cpu")
    assert prepared.steps[2].joins[0].fused is fused
    y, y_jax, y_ref = run_three(graph, plan, seed=5, relu=True)
    np.testing.assert_allclose(y, y_jax, **TOL)
    np.testing.assert_allclose(y, y_ref, **TOL)


@pytest.mark.parametrize("width,padded", [(64, 64), (40, 64), (96, 128)])
def test_single_block_steps_pad_to_the_tile(width, padded):
    """A one-block output has nothing to permute: its weight is padded only
    to the kernel's 64-wide tile and launched as one block that wide, fused
    residual included, with the same result as the JAX package's."""
    graph = from_layers([
        ConvWorkload.from_gemm(M=width, N=96, K=48, name="in"),
        ConvWorkload.from_gemm(M=width, N=96, K=width, name="mid"),
        ConvWorkload.from_gemm(M=width, N=96, K=width, name="out"),
    ], "narrow", skip_edges=((0, 2),))
    plan = make_plan(graph)
    ws = init_graph_weights(list(graph.layers), seed=6)
    prepared = prepare_network(plan, graph, ws, device="cpu")
    assert [(st.w_eff.shape[1], st.block_n) for st in prepared.steps] == \
        [(padded, padded)] * 3
    assert prepared.steps[2].joins[0].fused
    y, y_jax, y_ref = run_three(graph, plan, seed=6, relu=True)
    np.testing.assert_allclose(y, y_jax, **TOL)
    np.testing.assert_allclose(y, y_ref, **TOL)


def test_adapt_activation_matches_jax():
    x = np.arange(2 * 8 * 8 * 4, dtype=np.float32).reshape(2, 8, 8, 4)
    for H, W, C in [(4, 4, 4), (10, 8, 6), (8, 8, 3), (11, 3, 5)]:
        mine = adapt_activation(torch.from_numpy(x), H, W, C)
        theirs = jplan.adapt_activation(jnp.asarray(x), H, W, C)
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))


def test_prepared_reuse_staleness_and_device(res_plan):
    graph, plan = residual_gemm_graph(), res_plan
    ws = init_graph_weights(list(graph.layers), seed=9)
    prepared = prepare_network(plan, graph, ws, device="cpu")
    x = np.random.default_rng(10).normal(
        size=graph.input_shape()).astype(np.float32)
    y_prep = execute_network(plan, graph, x, ws, prepared=prepared,
                             device="cpu")
    assert torch.equal(y_prep, execute_network(plan, graph, x, ws,
                                               device="cpu"))
    with pytest.raises(PlanError, match="different"):
        execute_network(plan, graph, x, [w + 1.0 for w in ws],
                        prepared=prepared, device="cpu")
    with pytest.raises(PlanError):
        prepare_network(plan, resnet50_graph(), ws, device="cpu")


def test_cuda_default_raises_without_cuda(res_plan, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    graph, plan = residual_gemm_graph(), res_plan
    ws = init_graph_weights(list(graph.layers), seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        prepare_network(plan, graph, ws)
    with pytest.raises(RuntimeError, match="CUDA"):
        execute_network_reference(graph, np.zeros(graph.input_shape()), ws)
    with pytest.raises(RuntimeError, match="CUDA"):
        to_torch_weights(ws, layers=graph.layers)


def test_to_torch_weights_checks_shapes():
    graph = mobilenet_v3_graph()
    ws = init_graph_weights(list(graph.layers), seed=2)
    bs = [np.full(wl.M, 0.5, np.float32) for wl in graph.layers]
    tw, tb = to_torch_weights(ws, bs, layers=graph.layers, device="cpu")
    for w, t in zip(ws, tw):
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), w)
    assert [tuple(b.shape) for b in tb] == [(wl.M,) for wl in graph.layers]
    assert to_torch_weights(ws, layers=graph.layers, device="cpu")[1] is None
    with pytest.raises(ValueError, match="weight shape"):
        to_torch_weights([w.T for w in ws], layers=graph.layers, device="cpu")
    with pytest.raises(ValueError, match="bias shape"):
        to_torch_weights(ws, [b[:3] for b in bs], layers=graph.layers,
                         device="cpu")
    # the converted tensors drive the executor like the numpy originals
    head = from_layers(graph.layers[:3], "mbv3-head")
    plan = make_plan(head, layouts=("HWC_C32",))
    x = np.random.default_rng(3).normal(
        size=head.input_shape()).astype(np.float32)
    np.testing.assert_array_equal(
        execute_network(plan, head, x, tw[:3], device="cpu").numpy(),
        execute_network(plan, head, x, ws[:3], device="cpu").numpy())


def test_traced_execution_spans_and_identical_outputs(res_plan):
    """Tracing records one ``exec.step`` per step (group) with the plan's
    modeled numbers and its host enqueue time, and never changes the
    values."""
    from repro_torch import obs
    graph = residual_gemm_graph()
    ws = init_graph_weights(list(graph.layers), seed=4)
    x = np.random.default_rng(4).normal(
        size=graph.input_shape()).astype(np.float32)
    prepared = prepare_network(res_plan, graph, ws, device="cpu")
    obs.reset()
    obs.enable()
    try:
        y_on, secs = obs.measure(prepared, x)
        steps = [e for e in obs.events()
                 if e.get("ev") == "span" and e["name"] == "exec.step"]
        nets = [e for e in obs.events()
                if e.get("ev") == "span" and e["name"] == "exec.network"]
    finally:
        obs.reset()
    assert secs > 0 and len(nets) == 1
    assert len(steps) == sum(s.fused_with is None for s in res_plan.steps)
    assert all(e["attrs"]["plan_id"] == res_plan.plan_id for e in steps)
    assert all(e["attrs"]["host_us"] == e["dur"] > 0 for e in steps)
    assert torch.equal(y_on, prepared(x))


# ------------------------------------------------------------- GEMM chains
def mlp3_graph():
    """``examples/layout_coswitch.py``'s part 3 chain."""
    return from_layers([
        ConvWorkload.from_gemm(M=384, N=128, K=256, name="fc1"),
        ConvWorkload.from_gemm(M=512, N=128, K=384, name="fc2"),
        ConvWorkload.from_gemm(M=256, N=128, K=512, name="fc3"),
    ], "mlp3")


@pytest.fixture(scope="module")
def mlp3_plan():
    return make_plan(mlp3_graph())


def _chain_inputs(dims, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(128, dims[0])).astype(np.float32)
    ws = [(rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32)
          for a, b in zip(dims[:-1], dims[1:])]
    return x, ws


def _chain_three(plan, x, ws, relu):
    """(port, repro XLA path, repro reference, port reference) as numpy."""
    t_act = torch.relu if relu else None
    j_act = (lambda t: jnp.maximum(t, 0)) if relu else None
    jp = jplan.ExecutionPlan.from_json(plan.to_json())
    jws = [jnp.asarray(w) for w in ws]
    y = execute_plan(plan, x, ws, activation=t_act, device="cpu")
    assert y.device.type == "cpu" and y.dtype == torch.float32
    y_jax = jplan.execute_plan(jp, jnp.asarray(x), jws, activation=j_act,
                               use_pallas=False)
    y_ref = jplan.execute_plan_reference(jp, jnp.asarray(x), jws,
                                         activation=j_act)
    mine_ref = execute_plan_reference(plan, x, ws, activation=t_act,
                                      device="cpu")
    return y.numpy(), np.asarray(y_jax), np.asarray(y_ref), mine_ref.numpy()


@pytest.mark.parametrize("names", [
    None,                                            # as planned
    ["HWC_C32", "HWC_H32", "HWC_C4W8", "HWC_H32"],   # every boundary permuted
])
@pytest.mark.parametrize("relu", [False, True])
def test_execute_plan_matches_jax(mlp3_plan, names, relu):
    plan = mlp3_plan if names is None else _force_boundaries(mlp3_plan,
                                                             names)
    x, ws = _chain_inputs([256, 384, 512, 256], seed=1)
    y, y_jax, y_ref, mine_ref = _chain_three(plan, x, ws, relu)
    assert y.shape == (128, 256)
    for want in (y_jax, y_ref, mine_ref):
        np.testing.assert_allclose(y, want, **TOL)
    if names is not None:
        perms = prepare_plan(plan, 256, ws, device="cpu").perms
        assert any(p != tuple(range(len(p))) for p in perms)


def test_execute_plan_one_block_chain_matches_jax(monkeypatch):
    """Boundaries of one block: a 128-wide output runs the kernel with no
    perm; a 96-wide one (not whole blocks) runs it too, padded to the
    kernel's 128-wide tile multiple and cut back, where the JAX executor
    leaves it to ``jnp.dot``.  Every step is one ``ops.rir_matmul`` call."""
    graph = from_layers([
        ConvWorkload.from_gemm(M=128, N=128, K=64, name="a"),
        ConvWorkload.from_gemm(M=96, N=128, K=128, name="b"),
    ], "narrow-chain")
    plan = make_plan(graph)
    x, ws = _chain_inputs([64, 128, 96], seed=2)
    prepared = prepare_plan(plan, 64, ws, device="cpu")
    assert prepared.perms == [(0,), (0,), (0,)]
    assert prepared.block_n == [128, 128]
    assert [tuple(w.shape) for w in prepared.w_eff] == [(64, 128), (128, 128)]
    calls = []
    real = executor_mod.ops.rir_matmul
    monkeypatch.setattr(executor_mod.ops, "rir_matmul",
                        lambda *a, **k: calls.append(k["block_n"])
                        or real(*a, **k))
    y, y_jax, y_ref, mine_ref = _chain_three(plan, x, ws, relu=True)
    assert calls == [128, 128]
    assert y.shape == (128, 96)
    for want in (y_jax, y_ref, mine_ref):
        np.testing.assert_allclose(y, want, **TOL)


def test_execute_plan_rejects_a_step_kernel_it_does_not_run(mlp3_plan):
    """``kernel='ref'`` is a value the plan format admits (the JAX executor
    runs such a step as a plain product); the port runs every step through
    ``rir_matmul``, so a plan asking for anything else raises."""
    x, ws = _chain_inputs([256, 384, 512, 256], seed=3)
    steps = list(mlp3_plan.steps)
    steps[1] = dataclasses.replace(steps[1], kernel="ref")
    plan = dataclasses.replace(mlp3_plan, steps=tuple(steps))
    plan = type(plan).from_json(plan.to_json())
    assert plan.steps[1].kernel == "ref"
    with pytest.raises(PlanError, match="'ref'"):
        execute_plan(plan, x, ws, device="cpu")
    with pytest.raises(PlanError, match="'ref'"):
        prepare_plan(plan, 256, ws, device="cpu")


def test_execute_plan_prepared_reuse_and_staleness(mlp3_plan, monkeypatch):
    """A prepared chain reused gives the same output; one built from other
    weights, another plan, another width or device raises ``PlanError``;
    the device defaults to cuda and raises without it."""
    x, ws = _chain_inputs([256, 384, 512, 256], seed=3)
    prepared = prepare_plan(mlp3_plan, 256, ws, device="cpu")
    first = execute_plan(mlp3_plan, x, ws, prepared=prepared, device="cpu")
    assert torch.equal(first, execute_plan(mlp3_plan, x, ws, device="cpu"))
    other = [w.copy() for w in ws]
    with pytest.raises(PlanError, match="different"):
        execute_plan(mlp3_plan, x, other, prepared=prepared, device="cpu")
    forced = _force_boundaries(mlp3_plan, ["HWC_H32"] * 4)
    with pytest.raises(PlanError, match="different"):
        execute_plan(forced, x, ws, prepared=prepared, device="cpu")
    with pytest.raises(PlanError, match="weight 1"):
        prepare_plan(mlp3_plan, 256, [ws[0], ws[2], ws[1]], device="cpu")
    with pytest.raises(PlanError, match="2 weights"):
        prepare_plan(mlp3_plan, 256, ws[:2], device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        execute_plan(mlp3_plan, x, ws, prepared=prepared)
    with pytest.raises(RuntimeError, match="CUDA"):
        execute_plan_reference(mlp3_plan, x, ws)


def test_coswitch_parts_run_on_the_cpu(capsys):
    """``python -m repro_torch.launch.coswitch``'s kernel and chain parts
    (2 and 3) on the CPU: every oracle check holds and prints True."""
    from repro_torch.launch import coswitch
    dev = torch.device("cpu")
    p2 = coswitch.part2_rir_kernels(dev)
    p3 = coswitch.part3_plan_execution(dev)
    assert p2["rir_matmul_layout"] and p2["birrd_matches_oracle"]
    assert p2["birrd_max_abs_err"] <= 1e-5
    assert p3["steps"] == 3 and p3["chain_matches"]
    out = capsys.readouterr().out
    assert "False" not in out and out.count(": True") == 3


def test_coswitch_runs_on_the_card_by_default(monkeypatch):
    from repro_torch.launch import coswitch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        coswitch.run()
    with pytest.raises(RuntimeError, match="CUDA"):
        coswitch.main([])
