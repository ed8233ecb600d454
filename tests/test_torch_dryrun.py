"""The port's dry-run, its step counter and the kernels' work on the CPU.

* Each kernel's ``work`` equals the hand formula at the shapes of
  ``PERF.md``'s bound column, and the bounds come out as recorded there:
  0.198 ms for ResNet-50 b8's 12 ``rir_matmul`` steps, 0.0097 ms for
  ``gqa_decode`` at llama3.2-3b's decode shape, 0.0967 ms for
  ``linear_scan`` at the rwkv6 training shape, 0.0153 ms for
  ``birrd_apply`` at full size.
* ``trace_cost.Counter`` counts a hand-sized step as the formulas say, and
  a SMOKE decode step and train step alike on real and on fake tensors.
* Per-device argument bytes of the dry-run on a fake world of 8 equal
  ``repro``'s ``memory_analysis().argument_size_in_bytes`` of its compiled
  step on 8 host devices: SMOKE llama, dbrx (train) and phi3 (decode) on
  (2, 4), SMOKE rwkv6 and zamba2 (train) on (4, 2) (their 2 heads do not
  split over a model axis of 4, which the port refuses for both mixers;
  zamba2's mamba2 leaves placed in ``ssm_order``, its conv leaves' ZeRO-1
  state on ``repro``'s layer axis).
* The matmul FLOPs of SMOKE llama's train and decode steps on one device
  are within 10% of ``repro.core.hlo_cost.analyze_hlo``'s.
* The CLI writes a cell's record (llama3.2-3b ``decode_32k``, whose cache
  is split by sequence: under 100 MB of collectives a device a step, on
  the last model rank; zamba2-2.7b ``decode_32k``, its mamba2 mixers on 5
  of the 80 SSM heads a rank, one ``gqa_decode`` a shared-block
  invocation).
* ``gpu_cost`` prices an axis whose groups span nodes of 8 cards at the
  NIC's rate and one whose groups stay inside a node at NVLink's.
* ``launch.roofline`` reads the fake world's records into rows.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.core import gpu_cost  # noqa: E402
from repro_torch.core.trace_cost import Counter, Counts  # noqa: E402
from repro_torch.kernels import birrd_reduce as bk  # noqa: E402
from repro_torch.kernels import gqa_decode as gk  # noqa: E402
from repro_torch.kernels import linear_scan as lk  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rir_matmul as rk  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
HBM, FP32 = 3.35e12, 67e12


def _ms(flops, nbytes, peak):
    return max(flops / peak, nbytes / HBM) * 1e3


# ------------------------------------------------------- kernels' work
def test_rir_matmul_work_resnet50_b8():
    """The 12 ResNet-50 batch-8 plan steps (the serve engine's planner
    options): ``2 M K N`` at the fp32 rate against A, B, the residual, the
    output and the perm in bytes; 0.198 ms in all."""
    from repro_torch.serve.engine import _planner_options
    graph = api.resnet50_graph().with_batch(8)
    opts = _planner_options(api.ServeConfig(graph="resnet50", max_batch=8,
                                            device="cpu"))
    plan = api.resolve_plan(graph, api.EvalConfig(), opts=opts).plan
    prepared = api.prepare_network(plan, graph, api.init_graph_weights(
        list(graph.layers), seed=0), device="cpu")
    total = 0.0
    for st in prepared.steps:
        M, K, N = st.rows_out, st.k_width, st.wl.M
        fused = any(j.fused for j in st.joins)
        n_perm = st.w_eff.shape[1] // st.block_n
        w = rk.work(M, K, N, 4, fused, n_perm)
        assert w == gpu_cost.Work(
            2.0 * M * K * N,
            4.0 * (M * K + K * N + M * N + (M * N if fused else 0)
                   + n_perm), "fp32")
        total += _ms(w.flops, w.bytes, FP32)
    assert len(prepared.steps) == 12
    assert f"{total:.3g}" == "0.198"


def test_gqa_decode_work_llama_decode_shape():
    lens = torch.randint(960, 1024, (8,), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(6))
    rows = int(lens.sum())
    w = gk.work(8, 24, 8, 128, rows, 2)
    assert w == gpu_cost.Work(4.0 * rows * 24 * 128,
                              2.0 * (2 * rows * 8 * 128 + 2 * 8 * 24 * 128)
                              + 4 * 8, "bf16")
    assert f"{gpu_cost.bound_ms(w)['bound_ms']:.2g}" == "0.0097"


def test_linear_scan_work_rwkv6_train_shape():
    B, H, T, dk, dv = 8, 32, 1024, 64, 64
    w = lk.work(B, H, T, dk, dv, 2, 4)
    L = 64
    ops_ = T // L * 2 * (2 * L * dk * dv + L * (L + 1) // 2 * (dk + dv))
    assert w == gpu_cost.Work(float(B * H * ops_),
                              float(B * H * T * (2 * (dk + dv) * 2 + dk * 4)),
                              "fp32")
    assert f"{gpu_cost.bound_ms(w)['bound_ms']:.3g}" == "0.0967"
    assert gpu_cost.bound_ms(w)["bound_by"] == "operations"


def test_birrd_work_full_size():
    aw, d = 16, 8 * 56 * 56 * 256 // 16
    gids, ports = tuple(i // 4 for i in range(aw)), (0, 4, 8, 12)
    mats = bk._routed_stage_mats(aw, gids, ports, torch.device("cpu"))
    adds = int((mats != 0).sum(dim=-1).gt(1).sum())
    w = bk.work(aw, d, 4, bk.program_adds(
        aw, bk._routed_configs(aw, gids, ports)))
    assert w == gpu_cost.Work(float(adds * d), 2.0 * aw * d * 4, "fp32")
    assert f"{gpu_cost.bound_ms(w)['bound_ms']:.3g}" == "0.0153"


# ------------------------------------------------------------- counter
def test_counter_counts_by_the_formulas():
    """Matmuls at their unit's rate, elementwise bytes as operands plus
    result, a view as nothing, a kernel as its ``work``."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(16, 32, generator=g)
    b = torch.randn(32, 48, generator=g)
    q = torch.randn(2, 4, 16, generator=g).bfloat16()
    kv = torch.randn(2, 8, 2, 16, generator=g).bfloat16()
    lens = torch.tensor([5, 8], dtype=torch.int32)
    sq = torch.randn(1, 2, 64, 16, generator=g)
    w = -torch.rand(1, 2, 64, 16, generator=g)
    with Counter() as c:
        y = a @ b                                   # 2 M K N, fp32
        z = (y.bfloat16() @ b.t().bfloat16())       # bf16 product
        y2 = y + 1.0                                # elementwise
        y.view(48, 16)                              # a view
        ops.gqa_decode(q, kv, kv, lens)
        ops.linear_scan(sq, sq, sq, w)
    n = c.counts
    assert n.flops["fp32"] == 2.0 * 16 * 32 * 48 + lk.work(
        1, 2, 64, 16, 16, 4).flops
    assert n.flops["bf16"] == 2.0 * 16 * 48 * 32 + gk.work(
        2, 4, 2, 16, 16, 2).flops
    assert n.kernels["gqa_decode"] == {
        "calls": 1, "flops": gk.work(2, 4, 2, 16, 16, 2).flops,
        "bytes": gk.work(2, 4, 2, 16, 16, 2).bytes}
    assert n.kernels["linear_scan"]["calls"] == 1
    mm = 4 * (16 * 32 + 32 * 48 + 16 * 48)
    cast = 4 * 16 * 48 + 2 * 16 * 48 + 4 * 32 * 48 + 2 * 32 * 48
    bmm = 2 * (16 * 48 + 48 * 32 + 16 * 32)
    add = 2 * 4 * 16 * 48
    kernels = gk.work(2, 4, 2, 16, 16, 2).bytes + lk.work(
        1, 2, 64, 16, 16, 4).bytes
    assert n.bytes == mm + cast + bmm + add + kernels
    del z, y2


def _decode_step(fake: bool):
    cfg = api.get_config("llama3p2_3b", smoke=True)
    model = api.build_model(cfg, device="cpu")
    if not fake:
        model.init(torch.Generator().manual_seed(0))
    cache = model.init_cache(2, 32)
    cache["length"].fill_(5)
    with torch.no_grad(), Counter() as c:
        model.decode_step(cache, torch.zeros(2, dtype=torch.int32))
    return c.counts.to_dict()


def _train_step(fake: bool):
    cfg = api.get_config("rwkv6_1p6b", smoke=True)
    model = api.build_model(cfg, device="cpu")
    if not fake:
        model.init(torch.Generator().manual_seed(0))
    step = api.make_train_step(model)
    opt = api.adamw_init(model.params())
    tokens = torch.zeros((2, 65), dtype=torch.int32)
    with Counter() as c:
        step(opt, {"tokens": tokens})
    return c.counts.to_dict()


@pytest.mark.parametrize("step", [_decode_step, _train_step],
                         ids=["llama-decode", "rwkv6-train"])
def test_counter_equal_on_real_and_fake_tensors(step):
    real = step(False)
    with FakeTensorMode():
        fake = step(True)
    assert real["total_flops"] > 0 and real["bytes"] > 0
    assert real == fake


# ---------------------------------------------------- dry-run vs repro
REPRO_ARGS = r'''
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import get_config
from repro.distributed.stepfn import jit_serve_step, jit_train_step
from repro.models import build_model
from repro.optim.adamw import AdamWState

devs = np.array(jax.devices())
B, T, S = 8, 32, 64
out = {}
for arch, kind, shape in json.loads(sys.argv[1]):
    mesh = Mesh(devs[:8].reshape(*shape), ("data", "model"))
    model = build_model(get_config(arch, smoke=True))
    ps = model.param_specs()
    with mesh:
        if kind == "train":
            f32 = lambda s: jax.ShapeDtypeStruct(s.shape, "float32")
            opt = AdamWState(step=jax.ShapeDtypeStruct((), "int32"),
                             mu=jax.tree.map(f32, ps),
                             nu=jax.tree.map(f32, ps),
                             master=jax.tree.map(f32, ps))
            batch = {"tokens": jax.ShapeDtypeStruct((B, T + 1), jnp.int32)}
            c = jit_train_step(model, mesh, batch, accum=1).lower(
                ps, opt, batch).compile()
        else:
            c = jit_serve_step(model, mesh, B, S).lower(
                ps, model.cache_specs(B, S),
                jax.ShapeDtypeStruct((B,), jnp.int32)).compile()
    out[arch] = c.memory_analysis().argument_size_in_bytes
print(json.dumps(out))
'''

PORT_ARGS = r'''
import json, sys
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import dryrun
arch, kind, d, m = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
cell = ShapeCell("t", 32, 8, "train") if kind == "train" else \
    ShapeCell("d", 64, 8, "decode")
r = dryrun.run_cell(arch, cell.name, accum=1, smoke=True, mesh=(d, m),
                    cell=cell)
print(json.dumps(r))
'''

ARG_CASES = [("llama3p2_3b", "train", (2, 4)), ("dbrx_132b", "train", (2, 4)),
             ("phi3_mini_3p8b", "decode", (2, 4)),
             ("rwkv6_1p6b", "train", (4, 2)),
             ("zamba2_2p7b", "train", (4, 2))]


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT / "src"), **extra)
    return env


@pytest.fixture(scope="module")
def argument_bytes():
    repro = subprocess.Popen(
        [sys.executable, "-c", REPRO_ARGS, json.dumps(ARG_CASES)],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=8",
                 JAX_PLATFORMS="cpu"), cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    port = {arch: subprocess.Popen(
        [sys.executable, "-W", "ignore", "-c", PORT_ARGS, arch, kind,
         str(shape[0]), str(shape[1])], env=_env(), cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for arch, kind, shape in ARG_CASES}
    out = {"port": {}}
    for arch, p in port.items():
        so, se = p.communicate(timeout=600)
        assert p.returncode == 0, se[-3000:]
        out["port"][arch] = json.loads(so)
    so, se = repro.communicate(timeout=600)
    assert repro.returncode == 0, se[-3000:]
    out["repro"] = json.loads(so.strip().splitlines()[-1])
    return out


@pytest.mark.parametrize("arch,kind,shape", ARG_CASES,
                         ids=[f"{a}-{k}" for a, k, _ in ARG_CASES])
def test_dryrun_argument_bytes_equal_repro(argument_bytes, arch, kind,
                                           shape):
    got = argument_bytes["port"][arch]
    assert got["mesh"] == f"{shape[0]}x{shape[1]}"
    assert got["per_device"]["argument_bytes"] == \
        argument_bytes["repro"][arch]
    # the step's collectives are counted, by mesh dimension
    dims = {d for kind in got["collective_kinds"].values() for d in kind}
    assert got["collective_bytes_per_device"] > 0
    assert dims <= {"data", "model"} and "model" in dims


def _repro_flops(kind):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.configs import get_config
    from repro.core.hlo_cost import analyze_hlo
    from repro.distributed.stepfn import jit_serve_step, jit_train_step
    from repro.models import build_model
    from repro.optim.adamw import AdamWState
    model = build_model(get_config("llama3p2_3b", smoke=True))
    ps = model.param_specs()
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    with mesh:
        if kind == "train":
            def f32(s):
                return jax.ShapeDtypeStruct(s.shape, "float32")
            opt = AdamWState(step=jax.ShapeDtypeStruct((), "int32"),
                             mu=jax.tree.map(f32, ps),
                             nu=jax.tree.map(f32, ps),
                             master=jax.tree.map(f32, ps))
            batch = {"tokens": jax.ShapeDtypeStruct((8, 33), jnp.int32)}
            c = jit_train_step(model, mesh, batch, accum=1).lower(
                ps, opt, batch).compile()
        else:
            c = jit_serve_step(model, mesh, 8, 64).lower(
                ps, model.cache_specs(8, 64),
                jax.ShapeDtypeStruct((8,), jnp.int32)).compile()
    return analyze_hlo(c.as_text()).flops


def _port_flops(kind):
    cfg = api.get_config("llama3p2_3b", smoke=True)
    with FakeTensorMode():
        model = api.build_model(cfg, device="cpu")
        if kind == "train":
            step = api.make_train_step(model)
            opt = api.adamw_init(model.params())
            with Counter() as c:
                step(opt, {"tokens": torch.zeros((8, 33),
                                                 dtype=torch.int32)})
        else:
            cache = model.init_cache(8, 64)
            with torch.no_grad(), Counter() as c:
                model.decode_step(cache, torch.zeros(8, dtype=torch.int32))
    return c.counts.total_flops


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_dryrun_flops_near_repro_hlo(kind):
    """Matmul FLOPs of SMOKE llama's step on one device, the port's
    counter against ``analyze_hlo`` of ``repro``'s compiled step (both
    count the remat recompute): within 10%."""
    ratio = _port_flops(kind) / _repro_flops(kind)
    assert 0.9 <= ratio <= 1.1, ratio


# ------------------------------------------------------------------ CLI
def test_dryrun_cli(tmp_path):
    """A cell that traces writes its record.  llama3.2-3b's 8 KV heads do
    not divide 16: its ``decode_32k`` cell traces the cache split by
    sequence on the last model rank, one ``gqa_decode_partial`` a layer,
    under 100 MB of collectives a device a step.  zamba2-2.7b's
    ``decode_32k`` runs its 54 mamba2 mixers tensor-parallel over the 16
    model ranks and its shared block 9 times: 9 ``gqa_decode`` calls a
    step, and the mixers' B/C gathers over the model axis."""
    out = tmp_path / "phi3.json"
    ok = subprocess.run(
        [sys.executable, "-W", "ignore", "-m", "repro_torch.launch.dryrun",
         "--arch", "phi3_mini_3p8b", "--shape", "decode_32k", "--out",
         str(out)], env=_env(), cwd=str(tmp_path), capture_output=True,
        text=True, timeout=600)
    assert ok.returncode == 0, ok.stderr[-3000:]
    rec = json.loads(out.read_text())
    assert rec["mesh"] == "16x16" and rec["chips"] == 256
    assert rec["kernels"]["gqa_decode"]["calls"] == 32
    assert rec["roofline"]["dominant"] == "memory"
    assert rec["n_params"] == rec["n_params_active"] > 3e9
    out = tmp_path / "llama.json"
    split = subprocess.run(
        [sys.executable, "-W", "ignore", "-m", "repro_torch.launch.dryrun",
         "--arch", "llama3p2_3b", "--shape", "decode_32k", "--out",
         str(out)], env=_env(), cwd=str(tmp_path), capture_output=True,
        text=True, timeout=600)
    assert split.returncode == 0, split.stderr[-3000:]
    rec = json.loads(out.read_text())
    assert rec["rank"]["model"] == 15 and rec["rank"]["global"] == 15
    assert rec["kernels"] == {"gqa_decode_partial": {
        "calls": 28, **{k: rec["kernels"]["gqa_decode_partial"][k]
                        for k in ("flops", "bytes")}}}
    assert 0 < rec["collective_bytes_per_device"] < 100e6
    out = tmp_path / "zamba2.json"
    hybrid = subprocess.run(
        [sys.executable, "-W", "ignore", "-m", "repro_torch.launch.dryrun",
         "--arch", "zamba2_2p7b", "--shape", "decode_32k", "--out",
         str(out)], env=_env(), cwd=str(tmp_path), capture_output=True,
        text=True, timeout=600)
    assert hybrid.returncode == 0, hybrid.stderr[-3000:]
    rec = json.loads(out.read_text())
    assert rec["mesh"] == "16x16" and rec["chips"] == 256
    assert set(rec["kernels"]) == {"gqa_decode"}
    assert rec["kernels"]["gqa_decode"]["calls"] == 9
    assert rec["collective_kinds"]["all_gather"]["model"] > 0


LINKS = [({"data": 16, "model": 16}, {"data": "nic", "model": "nic"}),
         ({"pod": 2, "data": 16, "model": 16},
          {"pod": "nic", "data": "nic", "model": "nic"}),
         ({"data": 32, "model": 8}, {"data": "nic", "model": "nvlink"}),
         ({"data": 2, "model": 4}, {"data": "nvlink", "model": "nvlink"})]


@pytest.mark.parametrize("shape,want", LINKS,
                         ids=["x".join(map(str, s.values())) for s, _ in
                              LINKS])
def test_link_rates_by_node(shape, want):
    """An axis whose groups (row-major ranks) stay inside one node of 8
    cards rides NVLink; one whose groups span nodes the NIC: on 16x16 the
    model axis's 16 consecutive ranks cover two nodes, the data axis's
    stride of 16 crosses one at every hop; on 32x8 the model group is one
    node; on 2x4 the whole mesh is.  The collective term divides each
    axis's bytes by its rate."""
    rate = {"nic": gpu_cost.NIC_BYTES_PER_S,
            "nvlink": gpu_cost.NVLINK_BYTES_PER_S}
    got = gpu_cost.axis_bytes_per_s(shape)
    assert got == {a: rate[w] for a, w in want.items()}
    terms = gpu_cost.terms_from_counts({}, 0.0, {a: 1e9 for a in shape},
                                       256, shape)
    assert terms.collective_s == pytest.approx(
        sum(1e9 / rate[w] for w in want.values()))


def test_roofline_reads_dryrun_records(argument_bytes, tmp_path):
    """``launch.roofline`` on the records the fake world of 8 wrote: a row
    a cell with the re-priced terms (as ``gpu_cost`` prices the counts),
    the model-FLOP ratio (``gpu_cost.model_flops`` of the cell over the
    mesh, over the counted FLOPs), fp32 against bf16 and peak live bytes
    against 80 GB; the CLI prints them as a table."""
    from repro_torch.launch import roofline
    recs = argument_bytes["port"]
    for arch, rec in recs.items():
        (tmp_path / f"{arch}.json").write_text(json.dumps(rec))
    rows = {r["arch"]: r for r in roofline.rows(tmp_path)}
    assert set(rows) == set(recs)
    for arch, rec in recs.items():
        r = rows[arch]
        shape = roofline._mesh_shape(rec["mesh"])
        assert r["rank"] == shape["model"] - 1
        terms = gpu_cost.terms_from_counts(
            rec["flops_by_unit"], rec["bytes_per_device"],
            Counts(collective_kinds=rec["collective_kinds"])
            .collective_by_axis(), rec["chips"], shape)
        assert r["bound_s"] == terms.bound_s
        assert r["dominant"] == terms.dominant
        cell = rec["cell"]
        tokens = cell["global_batch"] * (
            1 if cell["kind"] == "decode" else cell["seq_len"])
        mf = (6 if cell["kind"] == "train" else 2) \
            * rec["n_params_active"] * tokens / rec["chips"]
        assert r["model_flops"] == pytest.approx(mf)
        assert r["model_flops_ratio"] == pytest.approx(
            mf / rec["flops_per_device"])
        assert r["fp32_flops"] + r["bf16_flops"] == pytest.approx(
            rec["flops_per_device"])
        assert r["peak_share_of_hbm"] == pytest.approx(
            rec["per_device"]["peak_live_bytes"] / 80e9)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.roofline", "--dir",
         str(tmp_path)], env=_env(), capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert len(out.stdout.strip().splitlines()) == 2 + len(recs)


def test_model_params_count_matches_repro():
    """``_tree_params`` on the port's names equals ``repro``'s, dense and
    MoE, total and active."""
    from repro.configs import get_config as jget
    from repro.launch.dryrun import _tree_params as jtree
    from repro.models import build_model as jbuild
    from repro_torch.launch.dryrun import _tree_params
    for arch in ("llama3p2_3b", "dbrx_132b", "llama4_scout_17b"):
        cfg = api.get_config(arch)
        with FakeTensorMode():
            model = api.build_model(cfg, device="cpu")
        jm = jbuild(jget(arch))
        for active in (False, True):
            assert _tree_params(model, active) == jtree(jm, active)
