"""The port's CUDA kernels on the card (marked ``cuda``; skip without one).

Run on a machine with an NVIDIA card and ``nvcc``:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same device:
``rir_matmul`` at 2e-4 for f32 (fp32 sums in another order), its 3xTF32
design too, and 2e-2 for bf16, ``gqa_decode`` at the JAX sweep's 5e-4 /
3e-2 (softmax sums in another order, merged across splits),
``linear_scan`` at 1e-4 / 2e-2 against the plain chunked version (the same
algorithm, sums in another order) and at the JAX sweep's 3e-3 against the
stepwise recurrence, ``birrd_apply``'s switch kernel bit for bit against
the plain switch walk and stage loop on routed programs (every stage an
exact copy or one f32 sum of two values), its dense kernel at 1e-5 on
dense stage matrices.  Served outputs, batched against the same requests
one at a time, agree bit for bit, and so do ``rir_matmul``'s rows alone
and in a batch at split-K shapes and on the 3xTF32 design, whose error
against a float64 product is held to at most twice the SIMT design's and
its lean toward zero to 4e-7.  The MoE block and whisper's decode (both
through ``gqa_decode`` on the card) are held against the CPU in f32.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import gqa_decode as gk
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rir_matmul as rk

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    """Decided per test, never at import (xdist workers must agree)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("m,k,n,bn", [(128, 128, 256, 128),
                                      (256, 384, 512, 128),
                                      (256, 256, 1024, 256),
                                      (100, 147, 256, 128)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("with_res", [False, True])
def test_kernel_matches_plain_on_card(cuda, m, k, n, bn, dtype, tol,
                                      with_res):
    gen = torch.Generator().manual_seed(m + k + n)
    a = torch.randn(m, k, generator=gen).to(cuda, dtype)
    b = torch.randn(k, n, generator=gen).to(cuda, dtype)
    r = torch.randn(m, n, generator=gen).to(cuda, dtype) if with_res \
        else None
    perm = torch.randperm(n // bn, generator=gen).tolist()
    before = rk.launch_count()
    y = ops.rir_matmul(a, b, perm, residual=r, block_n=bn)
    torch.cuda.synchronize()
    assert rk.launch_count() == before + 1
    want = ref.rir_matmul(a, b, perm, bn, residual=r)
    torch.testing.assert_close(y.float(), want.float(), rtol=tol, atol=tol)


def test_kernel_rows_do_not_depend_on_batch(cuda):
    """A row's output is bit-identical whatever other rows share the call."""
    gen = torch.Generator().manual_seed(5)
    a = torch.randn(300, 1152, generator=gen).to(cuda)
    b = torch.randn(1152, 256, generator=gen).to(cuda)
    full = ops.rir_matmul(a, b, (1, 0))
    head = ops.rir_matmul(a[:7].contiguous(), b, (1, 0))
    assert torch.equal(full[:7], head)


@pytest.mark.parametrize("m,k,n,bn", [
    (1000, 147, 64, 64),       # conv1's K: A's rows unaligned (4-byte)
    (1000, 64, 64, 64),        # K = 64: four slices, one split
    (392, 4608, 512, 128),     # step 11: 8 K-splits
    (1568, 2304, 256, 128),    # step 8
    (300, 2304, 256, 64),      # 128-wide tiles over 64-wide blocks
    (392, 120, 960, 960),      # MobileNet-V3's head: N 960, 64-wide tiles
    (77, 1000, 128, 128),      # ragged M and K, K % 16 != 0, 2 splits
])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 2e-2)])
def test_kernel_matches_plain_at_path_shapes_on_card(cuda, m, k, n, bn,
                                                     dtype, tol):
    """The shapes the network path gives the kernel, each cut as
    ``launch_plan`` says, with a residual, against the plain version."""
    gen = torch.Generator().manual_seed(m + k)
    a = torch.randn(m, k, generator=gen).to(cuda, dtype)
    b = torch.randn(k, n, generator=gen).to(cuda, dtype)
    r = torch.randn(m, n, generator=gen).to(cuda, dtype)
    perm = torch.randperm(n // bn, generator=gen).tolist()
    y = ops.rir_matmul(a, b, perm, residual=r, block_n=bn)
    want = ref.rir_matmul(a, b, perm, bn, residual=r)
    torch.testing.assert_close(y.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("tile_n", [64, 128])
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_every_cut_matches_plain_on_card(cuda, tile_n, splits):
    """Every tile width and split count the kernel takes (a cut forced past
    ``launch_plan``), with A's rows unaligned (K = 637: 4-byte copies) and
    aligned: within 2e-4 of the plain version."""
    gen = torch.Generator().manual_seed(tile_n + splits)
    for k in (640, 637):
        a = torch.randn(200, k, generator=gen).to(cuda)
        b = torch.randn(k, 256, generator=gen).to(cuda)
        perm = ops.device_perm((1, 0), cuda)
        cut = rk.LaunchPlan(tile_n, splits, rk._k_bounds(k, splits))
        y = rk._launch(a, b, perm, None, 128, cut)
        want = ref.rir_matmul(a, b, (1, 0), 128)
        torch.testing.assert_close(y, want, rtol=2e-4, atol=2e-4)


def test_split_k_rows_do_not_depend_on_batch(cuda):
    """At step 11's shape (K 4608: 8 K-splits, summed in split order) a
    row's output is bit-identical whatever other rows share the call."""
    gen = torch.Generator().manual_seed(6)
    a = torch.randn(392, 4608, generator=gen).to(cuda)
    b = torch.randn(4608, 512, generator=gen).to(cuda)
    r = torch.randn(392, 512, generator=gen).to(cuda)
    assert rk.launch_plan(392, 4608, 512, 128).splits == 8
    full = ops.rir_matmul(a, b, (3, 1, 0, 2), residual=r)
    for lo, hi in ((0, 7), (1, 8), (130, 390)):
        head = ops.rir_matmul(a[lo:hi].contiguous(), b, (3, 1, 0, 2),
                              residual=r[lo:hi].contiguous())
        assert torch.equal(full[lo:hi], head)


def test_unaligned_a_runs_on_card(cuda):
    """A contiguous view of A that does not start on a 16-byte boundary
    runs (its rows go in by 4-byte copies) and matches."""
    gen = torch.Generator().manual_seed(8)
    base = torch.randn(101 * 64 + 1, generator=gen).to(cuda)
    a = base[1:].view(101, 64)
    assert a.data_ptr() % 16
    b = torch.randn(64, 128, generator=gen).to(cuda)
    torch.testing.assert_close(ops.rir_matmul(a, b, None),
                               ref.rir_matmul(a, b, (0,), 128),
                               rtol=2e-4, atol=2e-4)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    a = torch.zeros(8, 16, device=cuda)
    with pytest.raises(ValueError, match="multiple"):
        ops.rir_matmul(a, torch.zeros(16, 96, device=cuda), None, block_n=96)
    with pytest.raises(TypeError):
        ops.rir_matmul(a.half(), torch.zeros(16, 128, device=cuda).half())
    with pytest.raises(ValueError, match="contiguous"):
        ops.rir_matmul(torch.zeros(16, 8, device=cuda).t(),
                       torch.zeros(16, 128, device=cuda))
    # a perm tensor whose values nobody checked would store out of bounds
    bad = torch.tensor([0, 5], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="device_perm"):
        ops.rir_matmul(a, torch.zeros(16, 256, device=cuda), bad)
    # b and the residual are read 16 bytes at a time
    b = torch.zeros(16 * 128 + 1, device=cuda)[1:].view(16, 128)
    with pytest.raises(ValueError, match="16-byte"):
        ops.rir_matmul(a, b)
    r = torch.zeros(8 * 128 + 1, device=cuda)[1:].view(8, 128)
    with pytest.raises(ValueError, match="16-byte"):
        ops.rir_matmul(a, torch.zeros(16, 128, device=cuda), residual=r)
    # a cut the kernel does not take is refused by the launcher
    perm = ops.device_perm((0,), cuda)
    for cut in (rk.LaunchPlan(128, 3, (0, 16, 32, 48)),
                rk.LaunchPlan(96, 1, (0, 16)),
                rk.LaunchPlan(64, 8, rk._k_bounds(16, 8))):
        with pytest.raises(RuntimeError, match="launch failed"):
            rk._launch(a, torch.zeros(16, 128, device=cuda), perm, None, 128,
                       cut)


# BERT-Large's four encoder GEMMs (K, N): QKV, attn-out, FFN up, FFN down
BERT_KN = [(1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024)]


@pytest.mark.parametrize("k,n", BERT_KN)
@pytest.mark.parametrize("m", [768, 77, 1000])
def test_tf32x3_matches_plain_on_card(cuda, m, k, n):
    """BERT-Large's four GEMMs run on the 3xTF32 design, two sequences'
    rows and ragged M alike, with a residual and a perm: within 2e-4 of
    the plain version, one launch of that design a call."""
    gen = torch.Generator().manual_seed(m + k + n)
    a = torch.randn(m, k, generator=gen).to(cuda)
    b = torch.randn(k, n, generator=gen).to(cuda) / k ** 0.5
    r = torch.randn(m, n, generator=gen).to(cuda)
    perm = torch.randperm(n // 128, generator=gen).tolist()
    assert rk.launch_plan(m, k, n, 128).design == rk.TF32X3
    before = rk.launch_count(rk.TF32X3), rk.launch_count(rk.SIMT)
    y = ops.rir_matmul(a, b, perm, residual=r)
    torch.cuda.synchronize()
    assert (rk.launch_count(rk.TF32X3), rk.launch_count(rk.SIMT)) == \
        (before[0] + 1, before[1])
    want = ref.rir_matmul(a, b, perm, 128, residual=r)
    torch.testing.assert_close(y, want, rtol=2e-4, atol=2e-4)


def test_tf32x3_rows_do_not_depend_on_batch(cuda):
    """At FFN-down's shape (K 4096, N 1024) on the 3xTF32 design a row's
    output is bit-identical whatever other rows share the call."""
    gen = torch.Generator().manual_seed(9)
    a = torch.randn(600, 4096, generator=gen).to(cuda)
    b = torch.randn(4096, 1024, generator=gen).to(cuda)
    r = torch.randn(600, 1024, generator=gen).to(cuda)
    perm = (5, 2, 7, 0, 1, 6, 3, 4)
    assert rk.launch_plan(600, 4096, 1024, 128).design == rk.TF32X3
    full = ops.rir_matmul(a, b, perm, residual=r)
    for lo, hi in ((0, 7), (1, 8), (130, 390), (599, 600)):
        head = ops.rir_matmul(a[lo:hi].contiguous(), b, perm,
                              residual=r[lo:hi].contiguous())
        assert torch.equal(full[lo:hi], head)


@pytest.mark.parametrize("k", [1024, 4096])
def test_tf32x3_error_is_the_fp32_kernels(cuda, k):
    """Against a float64 product, the 3xTF32 design's max |err| / max
    |ref| is at most twice the SIMT design's (fp32 FMAs) on the same
    inputs, and a single-pass TF32 product (``torch.matmul`` with TF32
    on) reads at least 10x above that limit."""
    gen = torch.Generator().manual_seed(k)
    a = torch.randn(512, k, generator=gen).to(cuda)
    b = torch.randn(k, 1024, generator=gen).to(cuda)
    want = a.double() @ b.double()
    scale = want.abs().max()
    perm = ops.device_perm(range(8), cuda)
    simt = rk.launch_plan(512, k, 1024, 128, torch.bfloat16)
    assert simt.design == rk.SIMT
    err = {}
    for name, cut in (("tf32x3", rk.launch_plan(512, k, 1024, 128)),
                      ("simt", simt)):
        y = rk._launch(a, b, perm, None, 128, cut)
        err[name] = ((y.double() - want).abs().max() / scale).item()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        y = torch.matmul(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    err["tf32"] = ((y.double() - want).abs().max() / scale).item()
    assert err["tf32x3"] <= 2 * err["simt"], err
    assert err["tf32"] >= 10 * 2 * err["simt"], err


def test_tf32x3_lean_toward_zero_is_the_tensor_cores(cuda):
    """The 3xTF32 design's outputs lean toward zero: the least-squares fit
    got = (1 + scale) ref against a float64 product reads a scale of at
    most 4e-7 in size (-1.84e-7 measured at BERT-Large's four shapes),
    where the split alone, its three products exact in float64, reads
    under 1e-9: the lean is the tensor cores' truncated sums, not the
    split.  A chain of GEMMs adds it up (PERF.md)."""
    gen = torch.Generator().manual_seed(12)
    a = torch.randn(1024, 1024, generator=gen).to(cuda)
    b = (torch.randn(1024, 1024, generator=gen) / 32).to(cuda)
    want = a.double() @ b.double()

    def scale(y):
        d = y.double() - want
        return ((d * want).sum() / (want * want).sum()).item()

    assert rk.launch_plan(1024, 1024, 1024, 128).design == rk.TF32X3
    ah, al = (t.double() for t in rk.split_tf32(a))
    bh, bl = (t.double() for t in rk.split_tf32(b))
    assert abs(scale(al @ bh + ah @ bl + ah @ bh)) < 1e-9
    assert abs(scale(ops.rir_matmul(a, b))) <= 4e-7


def test_tf32x3_refuses_what_it_does_not_take(cuda):
    """The 3xTF32 design takes fp32 with K % 4 == 0 and N a multiple of
    128: forced past ``launch_plan`` onto anything else it raises, and an
    A that is not 16-byte aligned is copied first and runs."""
    perm = ops.device_perm((0,), cuda)
    for k, n, bn in ((1022, 128, 128), (1024, 64, 64), (1024, 192, 64)):
        a = torch.zeros(8, k, device=cuda)
        b = torch.zeros(k, n, device=cuda)
        p = ops.device_perm(range(n // bn), cuda)
        with pytest.raises(RuntimeError, match="launch failed"):
            rk._launch(a, b, p, None, bn,
                       rk.LaunchPlan(128, 1, (0, k), rk.TF32X3))
    with pytest.raises(TypeError, match="float32"):
        rk._launch(torch.zeros(8, 64, device=cuda, dtype=torch.bfloat16),
                   torch.zeros(64, 128, device=cuda, dtype=torch.bfloat16),
                   perm, None, 128, rk.LaunchPlan(128, 1, (0, 64), rk.TF32X3))
    gen = torch.Generator().manual_seed(4)
    base = torch.randn(101 * 1024 + 1, generator=gen).to(cuda)
    a = base[1:].view(101, 1024)
    b = torch.randn(1024, 1024, generator=gen).to(cuda)
    assert a.data_ptr() % 16 and rk.takes_tf32x3(1024, 1024)
    torch.testing.assert_close(ops.rir_matmul(a, b, None, block_n=1024),
                               ref.rir_matmul(a, b, (0,), 1024),
                               rtol=2e-4, atol=2e-4)


def test_prepared_planes_stand_for_the_weight_on_card(cuda):
    """``prepare_weight`` splits a weight whose GEMMs take 3xTF32 into the
    planes ``weight_planes`` gives; a launch handed planes reads them in
    the weight's place, with the weight or without it, bit for bit the
    launch that splits the weight itself; the SIMT design will not launch
    from planes alone, and a weight that stays on SIMT gets none."""
    gen = torch.Generator().manual_seed(10)
    a = torch.randn(200, 1024, generator=gen).to(cuda)
    b = torch.randn(1024, 1024, generator=gen).to(cuda)
    planes = rk.prepare_weight(b)
    assert torch.equal(planes, rk.weight_planes(b))
    y = ops.rir_matmul(a, b)
    assert torch.equal(ops.rir_matmul(a, None, planes=planes), y)
    assert torch.equal(ops.rir_matmul(a, b, planes=planes), y)
    # the planes, not b, are what the launch reads (2b's are exactly 2x)
    assert torch.equal(ops.rir_matmul(a, b, planes=rk.weight_planes(2 * b)),
                       2 * y)
    with pytest.raises(ValueError, match="planes"):
        ops.rir_matmul(a, b, planes=planes[:1024])
    small = rk.weight_planes(torch.randn(512, 1024, device=cuda))
    with pytest.raises(ValueError, match="SIMT"):
        ops.rir_matmul(torch.randn(8, 512, device=cuda), None, planes=small)
    assert rk.prepare_weight(torch.zeros(1024, 256, device=cuda)) is None
    assert rk.prepare_weight(
        torch.zeros(1024, 1024, device=cuda, dtype=torch.bfloat16)) is None


def test_prepared_plan_holds_planes_not_the_weight_on_card(cuda):
    """A GEMM chain whose last two steps take 3xTF32 (512 -> 1024 -> 2048
    -> 1024) keeps those steps' planes and not their fp32 weights on the
    card, launches each step on its design, and matches the chain on the
    CPU."""
    from repro_torch.core.dataflow import ConvWorkload
    from repro_torch.core.layoutloop import EvalConfig
    from repro_torch.plan import (NetworkPlanner, execute_plan, from_layers,
                                  prepare_plan)
    widths = (512, 1024, 2048, 1024)
    graph = from_layers([
        ConvWorkload.from_gemm(M=m, N=128, K=k, name=f"l{i}")
        for i, (k, m) in enumerate(zip(widths[:-1], widths[1:]))], "chain")
    plan = NetworkPlanner(graph, EvalConfig()).plan()
    rng = np.random.default_rng(1)
    x = rng.normal(size=(128, widths[0])).astype(np.float32)
    ws = [(rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32)
          for a, b in zip(widths[:-1], widths[1:])]
    prepared = prepare_plan(plan, widths[0], ws, device=cuda)
    assert [p is None for p in prepared.planes] == [True, False, False]
    assert [w is None for w in prepared.w_eff] == [False, True, True]
    before = {d: rk.launch_count(d) for d in rk.DESIGNS}
    y = execute_plan(plan, x, ws, activation=torch.relu, prepared=prepared,
                     device=cuda)
    torch.cuda.synchronize()
    assert {d: rk.launch_count(d) - before[d] for d in rk.DESIGNS} == \
        {rk.SIMT: 1, rk.TF32X3: 2}
    want = execute_plan(plan, x, ws, activation=torch.relu, device="cpu")
    torch.testing.assert_close(y.cpu(), want, rtol=2e-4, atol=2e-4)


def test_served_batches_equal_sequential_on_card(cuda):
    from repro_torch import api
    cfg = dict(graph="tiny", max_batch=4, device="cuda")
    samples = [np.random.default_rng(i).standard_normal((8, 8, 16))
               .astype(np.float32) for i in range(6)]
    cache = api.PlanCache()
    with api.ServeEngine(api.ServeConfig(workers=2, **cfg),
                         cache=cache) as eng:
        got = eng.serve(samples)
    with api.ServeEngine(api.ServeConfig(assemble_max=1, **cfg),
                         cache=cache) as seq:
        want = seq.serve(samples)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


class _SyncCount:
    def __init__(self):
        self.n = 0

    def __call__(self, *a, **k):
        self.n += 1


def test_traced_forward_makes_no_sync_on_card(cuda, monkeypatch):
    """Tracing a ``PreparedNetwork`` forward adds no device sync: each
    ``exec.step``'s ``dur`` is the device time between the two timing
    events recorded around it, and the output is bit-identical."""
    from repro_torch import api, obs
    from repro_torch.serve import build_graph
    graph = build_graph("tiny").with_batch(4)
    plan = api.plan_network(graph, api.EvalConfig(), opts=api.PlannerOptions(
        switch_modes=("rir",), layouts=(api.Layout.parse("HWC_C32"),),
        parallel_dims=("C", "P", "Q")))
    ws = api.init_graph_weights(list(graph.layers), seed=0)
    prepared = api.prepare_network(plan, graph, ws, device=cuda)
    x = torch.randn(graph.input_shape(),
                    generator=torch.Generator().manual_seed(5)).to(cuda)
    y_off = prepared(x).clone()
    torch.cuda.synchronize()
    made, real_event = [], torch.cuda.Event

    def Event(*a, **k):
        made.append(real_event(*a, **k))
        return made[-1]

    syncs = _SyncCount()
    obs.reset()
    obs.enable()
    try:
        monkeypatch.setattr(torch.cuda, "Event", Event)
        monkeypatch.setattr(torch.cuda, "synchronize", syncs)
        y_on = prepared(x)
        assert syncs.n == 0
        monkeypatch.undo()
        steps = [e for e in obs.events()
                 if e.get("ev") == "span" and e["name"] == "exec.step"]
    finally:
        obs.reset()
    groups = sum(s.fused_with is None for s in plan.steps)
    assert len(steps) == groups and len(made) == 2 * groups
    for e, (a, b) in zip(steps, zip(made[::2], made[1::2])):
        assert e["dur"] == a.elapsed_time(b) * 1e3 > 0
        assert e["attrs"]["host_us"] > 0
    assert torch.equal(y_on, y_off)


@pytest.mark.parametrize("traced", [False, True])
def test_served_batches_call_no_device_sync_on_card(cuda, monkeypatch,
                                                    traced):
    """A served batch, network or LM, traced or not, calls no
    ``torch.cuda.synchronize``: its only sync is its copy back."""
    from repro_torch import api, obs
    net = api.ServeConfig(graph="tiny", max_batch=4, workers=2,
                          device="cuda")
    lm = api.ServeConfig(arch="llama3p2_3b", smoke=True, device="cuda",
                         max_batch=2, prompt_len=8, gen=4, workers=1)
    samples = [np.random.default_rng(i).standard_normal((8, 8, 16))
               .astype(np.float32) for i in range(6)]
    prompts = [np.arange(8) % 7, np.arange(8) % 5]
    syncs = _SyncCount()
    obs.reset()
    with api.ServeEngine(net) as a, api.ServeEngine(lm) as b:
        a.serve(samples[:4])
        b.serve(prompts)                 # warm: builds and first launches
        if traced:
            obs.enable()
        monkeypatch.setattr(torch.cuda, "synchronize", syncs)
        a.serve(samples)
        b.serve(prompts)
        monkeypatch.undo()
    try:
        assert syncs.n == 0
        if traced:
            steps = [e for e in obs.events() if e.get("ev") == "span"
                     and e["name"] == "exec.step"]
            assert steps and all(e["dur"] > 0 for e in steps)
            assert obs.hist_samples("serve.prefill_ms")[0] > 0
            assert obs.hist_samples("serve.decode_ms_per_token")[0] > 0
        else:
            assert obs.events() == []
    finally:
        obs.reset()


# ------------------------------------------------------------------ gqa_decode
def _gqa_inputs(b, hq, hkv, d, s, dtype, device, seed):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(b, hq, d, generator=gen).to(device, dtype)
    k = torch.randn(b, s, hkv, d, generator=gen).to(device, dtype)
    v = torch.randn(b, s, hkv, d, generator=gen).to(device, dtype)
    lens = torch.randint(s // 2, s + 1, (b,), generator=gen,
                         dtype=torch.int32).to(device)
    return q, k, v, lens


@pytest.mark.parametrize("widths", [(256, 384, 512, 256), (64, 128, 96)])
def test_execute_plan_launches_every_step_on_card(cuda, widths):
    """A GEMM chain on the card: one ``rir_matmul`` launch a step, a
    boundary of whole blocks and a ragged one-block output (96 wide)
    alike, against the same chain on the CPU."""
    from repro_torch.core.dataflow import ConvWorkload
    from repro_torch.core.layoutloop import EvalConfig
    from repro_torch.plan import NetworkPlanner, execute_plan, from_layers
    graph = from_layers([
        ConvWorkload.from_gemm(M=m, N=128, K=k, name=f"l{i}")
        for i, (k, m) in enumerate(zip(widths[:-1], widths[1:]))], "chain")
    plan = NetworkPlanner(graph, EvalConfig()).plan()
    rng = np.random.default_rng(len(widths))
    x = rng.normal(size=(128, widths[0])).astype(np.float32)
    ws = [(rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32)
          for a, b in zip(widths[:-1], widths[1:])]
    before = rk.launch_count()
    y = execute_plan(plan, x, ws, activation=torch.relu, device=cuda)
    torch.cuda.synchronize()
    assert rk.launch_count() == before + len(ws)
    want = execute_plan(plan, x, ws, activation=torch.relu, device="cpu")
    assert y.shape == (128, widths[-1])
    torch.testing.assert_close(y.cpu(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("b,hq,hkv,d,s", [
    (2, 8, 2, 64, 512), (1, 4, 4, 128, 1024), (3, 8, 1, 64, 2048),  # JAX's
    (8, 24, 8, 128, 1024),          # llama3.2-3b at max_seq 1024
    (2, 8, 2, 128, 1000),           # ragged S
    (2, 4, 2, 16, 100), (1, 16, 2, 256, 300),   # smallest and largest D
    (8, 48, 8, 128, 144),           # dbrx-132b decode: G 6
    (8, 40, 8, 128, 144),           # llama4-scout decode: G 5
    (8, 12, 12, 64, 96),            # whisper-small self-attention: G 1, D 64
    (8, 12, 12, 64, 1500),          # whisper cross-attention: S 1500
])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-4),
                                       (torch.bfloat16, 3e-2)])
def test_gqa_decode_matches_plain_on_card(cuda, b, hq, hkv, d, s, dtype,
                                          tol):
    q, k, v, lens = _gqa_inputs(b, hq, hkv, d, s, dtype, cuda, b + s + d)
    before = gk.launch_count()
    y = ops.gqa_decode(q, k, v, lens)
    torch.cuda.synchronize()
    assert gk.launch_count() == before + 1
    assert y.dtype == dtype and y.shape == q.shape
    torch.testing.assert_close(y.float(), ref.gqa_decode(q, k, v, lens)
                               .float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("hq,hkv,d", [(48, 8, 128), (40, 8, 128),
                                      (12, 12, 64)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-4),
                                       (torch.bfloat16, 3e-2)])
def test_gqa_decode_new_shapes_full_length_on_card(cuda, hq, hkv, d, dtype,
                                                   tol):
    """G 6, G 5 and D 64 / G 1 at S 1500 (whisper's encoder frames, not a
    multiple of the split) with every row at full length, as the
    cross-attention decodes, against the plain version."""
    S = 1500
    q, k, v, _ = _gqa_inputs(8, hq, hkv, d, S, dtype, cuda, hq + d)
    lens = torch.full((8,), S, dtype=torch.int32, device=cuda)
    y = ops.gqa_decode(q, k, v, lens)
    torch.testing.assert_close(y.float(), ref.gqa_decode(q, k, v, lens)
                               .float(), rtol=tol, atol=tol)


def test_gqa_decode_lengths_on_card(cuda):
    """Length 1, lengths on and either side of a split boundary, the whole
    cache; what lies past a row's length (NaN here) never reaches it; and a
    row's output does not depend on the rows decoded beside it."""
    S = 4 * gk.SPLIT + 40
    q, k, v, _ = _gqa_inputs(7, 6, 2, 128, S, torch.float32, cuda, 9)
    lens = torch.tensor([1, gk.SPLIT - 1, gk.SPLIT, gk.SPLIT + 1,
                         2 * gk.SPLIT, S - 1, S], dtype=torch.int32,
                        device=cuda)
    want = ref.gqa_decode(q, k, v, lens)
    for i, n in enumerate(lens.tolist()):
        k[i, n:] = float("nan")
        v[i, n:] = float("nan")
    y = ops.gqa_decode(q, k, v, lens)
    torch.testing.assert_close(y, want, rtol=5e-4, atol=5e-4)
    for i in (0, 2, 6):
        one = ops.gqa_decode(q[i:i + 1].contiguous(),
                             k[i:i + 1].contiguous(),
                             v[i:i + 1].contiguous(), lens[i:i + 1])
        assert torch.equal(one[0], y[i])


def _device_kernels(prof):
    """``[(name, events)]`` of every device event a profile kept."""
    from torch.autograd import DeviceType
    return [(e.key, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]


def test_gqa_decode_one_kernel_and_no_scratch_allocation_on_card(cuda):
    """At the llama3.2-3b decode shape a call is one device kernel (no
    merge kernel, no memset) and, once the stream has its workspace, the
    output is the call's only allocation."""
    from torch.profiler import ProfilerActivity, profile
    q, k, v, lens = _gqa_inputs(8, 24, 8, 128, 1024, torch.bfloat16, cuda, 3)
    want = ops.gqa_decode(q, k, v, lens)     # the stream's workspace
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    outs = [ops.gqa_decode(q, k, v, lens) for _ in range(5)]
    assert torch.cuda.memory_stats()["allocation.all.allocated"] \
        == before + len(outs)
    # the profiler may drop some events of a short loop, never add any
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            ops.gqa_decode(q, k, v, lens)
        torch.cuda.synchronize()
    kernels = _device_kernels(prof)
    assert kernels and all(gk.KERNEL in name for name, _ in kernels)
    assert 1 <= sum(n for _, n in kernels) <= 10
    for y in outs:
        assert torch.equal(y, want)


def test_gqa_decode_streams_keep_their_own_workspace_on_card(cuda):
    """Calls queued on two streams at once, several splits a row, never
    share counters or partials: every result equals the one-stream
    result."""
    q, k, v, lens = _gqa_inputs(4, 8, 2, 64, 1500, torch.float32, cuda, 4)
    want = ops.gqa_decode(q, k, v, lens)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    got = []
    for i in range(20):
        with torch.cuda.stream(streams[i % 2]):
            got.append(ops.gqa_decode(q, k, v, lens))
    torch.cuda.synchronize()
    for y in got:
        assert torch.equal(y, want)
    ws = [gk._workspaces[(q.device.index, s.cuda_stream)] for s in streams]
    assert ws[0][0].data_ptr() != ws[1][0].data_ptr()
    assert ws[0][1].data_ptr() != ws[1][1].data_ptr()


@pytest.mark.parametrize("hq,hkv,d,s", [(24, 8, 128, 1024),
                                         (48, 8, 128, 144),
                                         (12, 12, 64, 1500)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-4),
                                       (torch.bfloat16, 3e-2)])
def test_gqa_decode_partial_matches_plain_on_card(cuda, hq, hkv, d, s, dtype,
                                                  tol):
    """The partial variant's (out, m, l) against ``ref.gqa_decode_partial``
    at llama's, dbrx's and whisper's cross shapes, rows of length 0 (``(0,
    -inf, 0)``), 1, one split, several splits and the whole cache among
    them; the plain ``gqa_decode`` launch gives the same output."""
    gen = torch.Generator().manual_seed(hq + s)
    q = torch.randn(8, hq, d, generator=gen).to(cuda, dtype)
    k = torch.randn(8, s, hkv, d, generator=gen).to(cuda, dtype)
    v = torch.randn(8, s, hkv, d, generator=gen).to(cuda, dtype)
    lens = torch.tensor([0, 1, 100, 256, 257, s // 2, s - 1, s],
                        dtype=torch.int32, device=cuda).clamp(max=s)
    before = gk.partial_launch_count()
    out, m, l = ops.gqa_decode_partial(q, k, v, lens)
    torch.cuda.synchronize()
    assert gk.partial_launch_count() == before + 1
    want = ref.gqa_decode_partial(q, k, v, lens)
    assert torch.equal(out[0].float(), torch.zeros_like(out[0].float()))
    assert torch.all(m[0] == float("-inf")) and torch.all(l[0] == 0)
    torch.testing.assert_close(out.float(), want[0].float(), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(m[1:], want[1][1:], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l[1:], want[2][1:], rtol=1e-4, atol=1e-5)
    assert torch.equal(ops.gqa_decode(q, k, v, lens), out)


def test_gqa_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q, k, v, lens = _gqa_inputs(2, 4, 2, 64, 256, torch.float32, cuda, 1)
    with pytest.raises(ValueError, match="head dim"):
        ops.gqa_decode(q[..., :40].contiguous(), k[..., :40].contiguous(),
                       v[..., :40].contiguous(), lens)
    with pytest.raises(ValueError, match="multiple"):
        ops.gqa_decode(q[:, :3].contiguous(), k, v, lens)
    with pytest.raises(TypeError):
        ops.gqa_decode(q.half(), k.half(), v.half(), lens)
    with pytest.raises(ValueError, match="contiguous"):
        ops.gqa_decode(q, k.transpose(1, 2).contiguous().transpose(1, 2),
                       v, lens)
    with pytest.raises(ValueError, match="operands on"):
        ops.gqa_decode(q, k, v, lens.cpu())
    with pytest.raises(ValueError, match="int32"):
        gk.gqa_decode_cuda(q, k, v, lens.long())


def test_lm_decode_on_card_matches_cpu(cuda):
    """The dense LM on the card (f32, TF32 off) against the same weights on
    the CPU: prefill, then decode steps that launch ``gqa_decode`` once a
    layer (rtol/atol 2e-4, the JAX prefill-vs-decode bound)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("llama3p2_3b", smoke=True)
    cpu = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    dev = build_model(cfg, device=cuda).load_params(cpu.params())
    toks = torch.randint(0, cfg.vocab, (2, 12),
                         generator=torch.Generator().manual_seed(1))
    c_cpu, l_cpu = cpu.prefill(toks[:, :8], 32)
    c_dev, l_dev = dev.prefill(toks[:, :8].to(cuda), 32)
    torch.testing.assert_close(l_dev.cpu(), l_cpu, rtol=2e-4, atol=2e-4)
    before = gk.launch_count()
    for t in range(8, 12):
        c_cpu, l_cpu = cpu.decode_step(c_cpu, toks[:, t])
        c_dev, l_dev = dev.decode_step(c_dev, toks[:, t].to(cuda))
        torch.testing.assert_close(l_dev.cpu(), l_cpu, rtol=2e-4, atol=2e-4)
    assert gk.launch_count() == before + 4 * cfg.n_layers


@pytest.mark.parametrize("arch", ["dbrx_132b", "llama4_scout_17b"])
def test_moe_block_on_card_matches_cpu(cuda, arch):
    """The MoE block (f32, TF32 off) on the card against the same weights
    on the CPU at a capacity that drops tokens: the same routing wherever
    the k-th and (k+1)-th router logits are more than 1e-5 apart, and the
    rows routed alike within 1e-4."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import blocks, build_model
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              capacity_factor=0.5)
    cpu = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(2), scale=0.2)
    dev = build_model(cfg, device=cuda).load_params(cpu.params())
    x = torch.randn(4, 64, cfg.d_model,
                    generator=torch.Generator().manual_seed(3))
    p_cpu, p_dev = cpu.layers[0]["ffn"], dev.layers[0]["ffn"]
    y_cpu = blocks.moe_apply(cfg, p_cpu, x)
    y_dev = blocks.moe_apply(cfg, p_dev, x.to(cuda)).cpu()
    _, logits, (_, idx) = blocks.moe_route(cfg, p_cpu, x)
    _, _, (_, idx_dev) = blocks.moe_route(cfg, p_dev, x.to(cuda))
    top = torch.topk(logits, min(cfg.top_k + 1, cfg.n_experts), dim=-1)
    clear = (top.values[:, cfg.top_k - 1] - top.values[:, -1]) > 1e-5
    assert torch.equal(idx[clear], idx_dev.cpu()[clear])
    same = (idx == idx_dev.cpu()).all(dim=-1).reshape(4, 64)
    assert same.float().mean() > 0.95
    # a row routed alike can still differ where another row's flip moved
    # its place in an expert's queue; compare rows of batches with none
    whole = same.all(dim=-1)
    torch.testing.assert_close(y_dev[whole], y_cpu[whole], rtol=1e-4,
                               atol=1e-4)


def test_whisper_decode_on_card_matches_cpu(cuda):
    """whisper SMOKE (f32, TF32 off) on the card against the CPU: prefill
    over zero stub frames, then decode steps that launch ``gqa_decode``
    twice a layer (self and cross), rtol/atol 2e-4."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("whisper_small", smoke=True)
    cpu = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0), scale=0.1)
    dev = build_model(cfg, device=cuda).load_params(cpu.params())
    toks = torch.randint(0, cfg.vocab, (2, 12),
                         generator=torch.Generator().manual_seed(1))
    c_cpu, l_cpu = cpu.prefill(toks[:, :8], 16)
    c_dev, l_dev = dev.prefill(toks[:, :8].to(cuda), 16)
    torch.testing.assert_close(l_dev.cpu(), l_cpu, rtol=2e-4, atol=2e-4)
    before = gk.launch_count()
    for t in range(8, 12):
        c_cpu, l_cpu = cpu.decode_step(c_cpu, toks[:, t])
        c_dev, l_dev = dev.decode_step(c_dev, toks[:, t].to(cuda))
        torch.testing.assert_close(l_dev.cpu(), l_cpu, rtol=2e-4, atol=2e-4)
    assert gk.launch_count() == before + 4 * 2 * cfg.n_layers


# ----------------------------------------------------------------- linear_scan
def _scan_inputs(b, h, t, dk, dv, dtype, device, seed, decay=None):
    """q, k, v ~ N(0, 1) in ``dtype``; log decay -|N(0, 1)| * 0.2 in f32
    (the JAX sweep's), or the constant ``decay``."""
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(b, h, t, dk, generator=gen).to(device, dtype)
    k = torch.randn(b, h, t, dk, generator=gen).to(device, dtype)
    v = torch.randn(b, h, t, dv, generator=gen).to(device, dtype)
    w = -(torch.randn(b, h, t, dk, generator=gen).abs() * 0.2) \
        if decay is None else torch.full((b, h, t, dk), float(decay))
    return q, k, v, w.to(device)


@pytest.mark.parametrize("b,h,t,dk,dv", [
    (2, 3, 128, 32, 64), (1, 2, 256, 64, 64), (2, 1, 192, 16, 16),  # JAX's
    (2, 4, 128, 64, 16), (1, 2, 64, 16, 32),        # dk != dv
    (8, 32, 1024, 64, 64),                          # rwkv6-1.6b training
])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_linear_scan_matches_plain_on_card(cuda, b, h, t, dk, dv, dtype,
                                           tol):
    from repro_torch.kernels import linear_scan as lk
    q, k, v, w = _scan_inputs(b, h, t, dk, dv, dtype, cuda, b + t + dk)
    before = lk.launch_count()
    y = ops.linear_scan(q, k, v, w)
    torch.cuda.synchronize()
    assert lk.launch_count() == before + 1
    assert y.dtype == dtype and y.shape == v.shape
    want = ref.linear_scan_chunked(q, k, v, w)
    torch.testing.assert_close(y.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("t", [1, 5, 63, 65, 100, 200])
def test_linear_scan_ragged_t_on_card(cuda, t):
    """Any T runs the kernel (the last chunk masked): held against the
    stepwise recurrence at the JAX sweep's 3e-3."""
    q, k, v, w = _scan_inputs(2, 2, t, 32, 32, torch.float32, cuda, t)
    y = ops.linear_scan(q, k, v, w)
    torch.testing.assert_close(y, ref.linear_scan(q, k, v, w), rtol=3e-3,
                               atol=3e-3)


def test_linear_scan_decay_underflow_on_card(cuda):
    """A log decay of -60 kills all history (e^cum underflows to 0 inside a
    chunk): y_t = (q_t . k_t) v_t, with no NaN."""
    q, k, v, w = _scan_inputs(1, 2, 128, 16, 16, torch.float32, cuda, 3,
                              decay=-60.0)
    y = ops.linear_scan(q, k, v, w)
    expect = torch.einsum("bhtd,bhtd->bht", q, k)[..., None] * v
    assert torch.isfinite(y).all()
    torch.testing.assert_close(y, expect, rtol=1e-4, atol=1e-4)


def test_linear_scan_grad_on_card(cuda):
    """The Function's gradient (kernel forward, plain chunked backward)
    against autograd straight through the plain chunked version."""
    ins = _scan_inputs(2, 2, 128, 32, 64, torch.float32, cuda, 11)
    g = torch.randn(2, 2, 128, 64, generator=torch.Generator()
                    .manual_seed(12)).to(cuda)
    a = [x.clone().requires_grad_(True) for x in ins]
    b = [x.clone().requires_grad_(True) for x in ins]
    ga = torch.autograd.grad(ops.linear_scan(*a), a, g)
    gb = torch.autograd.grad(ref.linear_scan_chunked(*b), b, g)
    for x, y in zip(ga, gb):
        assert torch.isfinite(x).all()
        torch.testing.assert_close(x, y, rtol=0,
                                   atol=1e-4 * float(y.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_linear_scan_head_alone_equals_batched_on_card(cuda, dtype):
    """One CTA a (b, h): a head's output, scanned alone, is bit for bit the
    same head's output in a batch, and a call is one device kernel."""
    from repro_torch.kernels import linear_scan as lk
    from torch.profiler import ProfilerActivity, profile
    q, k, v, w = _scan_inputs(3, 4, 200, 64, 64, dtype, cuda, 13)
    y = ops.linear_scan(q, k, v, w)
    for b, h in ((0, 0), (1, 2), (2, 3)):
        one = ops.linear_scan(*(x[b:b + 1, h:h + 1].contiguous()
                                for x in (q, k, v, w)))
        assert torch.equal(one[0, 0], y[b, h])
    # the profiler may drop some events of a short loop, never add any
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            ops.linear_scan(q, k, v, w)
        torch.cuda.synchronize()
    kernels = _device_kernels(prof)
    assert kernels and all(lk.KERNEL in name for name, _ in kernels)
    assert 1 <= sum(n for _, n in kernels) <= 10


def test_linear_scan_rejects_what_the_kernel_does_not_take(cuda):
    q, k, v, w = _scan_inputs(1, 2, 64, 32, 32, torch.float32, cuda, 1)
    with pytest.raises(ValueError, match="head dims"):
        ops.linear_scan(q[..., :24].contiguous(), k[..., :24].contiguous(),
                        v, w[..., :24].contiguous())
    with pytest.raises(TypeError):
        ops.linear_scan(q.bfloat16(), k, v, w)
    with pytest.raises(TypeError, match="log_decay"):
        ops.linear_scan(q, k, v, w.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        ops.linear_scan(q.transpose(2, 3).contiguous().transpose(2, 3), k,
                        v, w)
    with pytest.raises(ValueError, match="operands on"):
        ops.linear_scan(q, k, v.cpu(), w)
    with pytest.raises(ValueError, match="shapes"):
        ops.linear_scan(q, k[:, :1].contiguous(), v, w)
    shifted = torch.empty(q.numel() + 1, device=cuda)[1:].view(q.shape)
    with pytest.raises(ValueError, match="aligned"):
        ops.linear_scan(shifted, k, v, w)


def test_rwkv6_loss_and_grads_on_card_match_cpu(cuda):
    """SMOKE rwkv6 (2 layers, f32, TF32 off, parameters at 0.2 so that the
    scan shapes the loss): the loss and every gradient on the card
    (``linear_scan`` forward kernel) against the CPU, within 2e-4 relative
    (of max |g| for each gradient)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import linear_scan as lk
    from repro_torch.models import build_model
    cfg = get_config("rwkv6_1p6b", smoke=True)
    cpu = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0), scale=0.2)
    dev = build_model(cfg, device=cuda).load_params(cpu.params())
    toks = torch.randint(0, cfg.vocab, (2, 129),
                         generator=torch.Generator().manual_seed(1))
    out = {}
    for name, m, t in (("cpu", cpu, toks), ("cuda", dev, toks.to(cuda))):
        m.requires_grad_(True)
        params = list(m.params().values())
        before = lk.launch_count()
        loss = m.loss({"tokens": t})
        grads = torch.autograd.grad(loss, params)
        out[name] = (loss, grads, lk.launch_count() - before)
    assert out["cpu"][2] == 0
    assert out["cuda"][2] == 2 * cfg.n_layers    # forward + remat recompute
    torch.testing.assert_close(out["cuda"][0].cpu(), out["cpu"][0],
                               rtol=2e-4, atol=0)
    for gd, gc in zip(out["cuda"][1], out["cpu"][1]):
        torch.testing.assert_close(gd.cpu(), gc, rtol=0,
                                   atol=2e-4 * float(gc.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_update_is_the_expression_bit_for_bit_on_card(cuda, dtype):
    """AdamW's in-place update on the card rounds as ``repro``'s
    expression does (a CUDA division by a host scalar multiplies by its
    reciprocal, in both forms): three steps' moments, master and
    parameters equal the expression's bit for bit."""
    from repro_torch.optim import adamw
    gen = torch.Generator().manual_seed(5)
    shapes = {"a": (257, 33), "b": (1000,)}
    tp = {n: (torch.randn(s, generator=gen) * 0.02).to(cuda, dtype)
          for n, s in shapes.items()}
    st = adamw.adamw_init(tp)
    mu = {n: torch.zeros_like(t) for n, t in st.mu.items()}
    nu = {n: torch.zeros_like(t) for n, t in st.nu.items()}
    w = {n: t.clone() for n, t in st.master.items()}
    b1, b2, eps, wd = 0.9, 0.95, 1e-8, 0.1
    for i in range(3):
        lr = 3e-3 * (i + 1)
        g = {n: torch.randn(s, generator=gen).to(cuda, dtype)
             for n, s in shapes.items()}
        clipped, _ = adamw.clip_by_global_norm(g, 1.0)
        tp, st = adamw.adamw_update(g, st, tp, lr)
        b1c = float(1 - np.float32(b1) ** np.float32(i + 1))
        b2c = float(1 - np.float32(b2) ** np.float32(i + 1))
        for n, c in clipped.items():
            mu[n] = b1 * mu[n] + (1 - b1) * c
            nu[n] = b2 * nu[n] + (1 - b2) * c * c
            upd = (mu[n] / b1c) / (torch.sqrt(nu[n] / b2c) + eps) + wd * w[n]
            w[n] = w[n] - lr * upd
            for got, want in ((st.mu[n], mu[n]), (st.nu[n], nu[n]),
                              (st.master[n], w[n]), (tp[n], w[n].to(dtype))):
                assert torch.equal(got, want), (i, n)


# ---------------------------------------------------------------- birrd_apply
def _routed(aw, gids, ports, device):
    from repro_torch.kernels.birrd_reduce import _routed_stage_mats
    return _routed_stage_mats(aw, tuple(gids), tuple(ports),
                              torch.device(device))


BIRRD_PATTERNS = [
    (8, [i // 2 for i in range(8)], [0, 2, 4, 6]),
    (16, [i // 2 for i in range(16)], [2 * g for g in range(8)]),
    (16, [i // 4 for i in range(16)], [0, 4, 8, 12]),
    (4, [0, 0, 0, 0], [3]),
    (2, [0, 1], [1, 0]),
    (32, list(range(32)), [((i << 2) | (i >> 3)) & 31 for i in range(32)]),
    (64, list(range(64)), [((i << 3) | (i >> 3)) & 63 for i in range(64)]),
]


@pytest.mark.parametrize("aw,gids,ports", BIRRD_PATTERNS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [256, 77])
def test_birrd_reduce_matches_plain_bitwise_on_card(cuda, aw, gids, ports,
                                                    dtype, d):
    """Routed programs: the switch kernel (one launch, the port mask in its
    store) equals the plain stage loop and the plain switch walk bit for
    bit, any d, f32 and bf16."""
    from repro_torch.kernels import birrd_reduce as bk
    x = torch.randn(aw, d, generator=torch.Generator().manual_seed(aw + d)
                    ).to(cuda, dtype)
    before = bk.switch_launch_count()
    y = ops.birrd_reduce(x, gids, ports)
    torch.cuda.synchronize()
    assert bk.switch_launch_count() == before + 1
    assert y.dtype == dtype and y.shape == (aw, d)
    mats = _routed(aw, gids, ports, cuda)
    mask = torch.zeros(aw, dtype=torch.bool, device=cuda)
    mask[list(ports)] = True
    want = ref.birrd_apply(x, mats, mask)
    assert torch.equal(y, want)
    cfg = bk._routed_configs(aw, tuple(gids), tuple(ports))
    assert torch.equal(y, ref.birrd_switch(x, cfg, mask))
    oracle = ref.birrd_reduce(x.float(), torch.tensor(gids),
                              torch.tensor(ports), aw)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(y.float(), oracle, rtol=tol, atol=tol)


@pytest.mark.parametrize("aw", [4, 8, 16, 32, 64])
def test_birrd_apply_dense_stage_matrices_on_card(cuda, aw):
    """Random dense stage matrices: the kernel's in-order fmaf sums against
    the plain version's products (TF32 off) at 1e-5 of the output scale."""
    gen = torch.Generator().manual_seed(aw)
    S = 2 * aw.bit_length() - 2 if aw != 4 else 3
    mats = (torch.randn(S, aw, aw, generator=gen) / aw ** 0.5).to(cuda)
    x = torch.randn(aw, 1000, generator=gen).to(cuda)
    y = ops.birrd_apply_p(x, mats)
    want = ref.birrd_apply(x, mats)
    torch.testing.assert_close(y, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("aw,gids,ports", BIRRD_PATTERNS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [4096, 1001, 3])
def test_birrd_switch_kernel_matches_plain_bitwise_on_card(cuda, aw, gids,
                                                           ports, dtype, d):
    """``ops.birrd_apply`` on a routed config program runs the switch
    kernel, unmasked: bit for bit ``ref.birrd_switch``, at a d its vector
    loads tile, a ragged one and one below a thread's columns."""
    from repro_torch.kernels import birrd_reduce as bk
    cfg = bk._routed_configs(aw, tuple(gids), tuple(ports))
    x = torch.randn(aw, d, generator=torch.Generator().manual_seed(d + aw)
                    ).to(cuda, dtype)
    before = (bk.launch_count(), bk.switch_launch_count())
    y = ops.birrd_apply(x, cfg)
    torch.cuda.synchronize()
    assert (bk.launch_count(), bk.switch_launch_count()) == \
        (before[0], before[1] + 1)
    assert torch.equal(y, ref.birrd_switch(x, cfg))
    assert torch.equal(y, ref.birrd_apply(x, _routed(aw, gids, ports, cuda)))


def test_birrd_switch_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels import birrd_reduce as bk
    x = torch.zeros(8, 128, device=cuda)
    codes = torch.zeros(6, 4, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="aw=12"):
        bk.birrd_switch_cuda(torch.zeros(12, 128, device=cuda),
                             torch.zeros(6, 6, dtype=torch.uint8,
                                         device=cuda))
    with pytest.raises(ValueError, match="shapes"):
        bk.birrd_switch_cuda(x, codes[:, :3])
    with pytest.raises(ValueError, match="stages"):
        bk.birrd_switch_cuda(x, codes[:5])
    with pytest.raises(TypeError, match="uint8"):
        bk.birrd_switch_cuda(x, codes.int())
    with pytest.raises(TypeError):
        bk.birrd_switch_cuda(x.half(), codes)
    with pytest.raises(ValueError, match="operands on"):
        bk.birrd_switch_cuda(x, codes.cpu())
    with pytest.raises(ValueError, match="port_mask"):
        bk.birrd_switch_cuda(x, codes, port_mask=torch.ones(8, device=cuda))


def test_birrd_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels import birrd_reduce as bk
    x = torch.zeros(8, 128, device=cuda)
    mats = torch.zeros(6, 8, 8, device=cuda)
    with pytest.raises(ValueError, match="aw=12"):
        bk.birrd_apply_cuda(torch.zeros(12, 128, device=cuda),
                            torch.zeros(6, 12, 12, device=cuda))
    with pytest.raises(ValueError, match="shapes"):
        bk.birrd_apply_cuda(x, mats[:, :4])
    with pytest.raises(TypeError):
        bk.birrd_apply_cuda(x.half(), mats)
    with pytest.raises(TypeError, match="stage_mats"):
        bk.birrd_apply_cuda(x, mats.double())
    with pytest.raises(ValueError, match="contiguous"):
        bk.birrd_apply_cuda(torch.zeros(128, 8, device=cuda).t(), mats)
    with pytest.raises(ValueError, match="operands on"):
        bk.birrd_apply_cuda(x, mats.cpu())
    with pytest.raises(ValueError, match="port_mask"):
        bk.birrd_apply_cuda(x, mats, port_mask=torch.ones(8, device=cuda))


def test_zamba2_decode_on_card_matches_cpu(cuda):
    """SMOKE zamba2 (f32, TF32 off, parameters at 0.2 so that the scan
    shapes the logits): ``hidden_states`` on the card (``linear_scan`` once
    a layer) and a scan-in through ``decode_step`` (``gqa_decode`` once a
    shared-block invocation) against the CPU, rtol/atol 2e-4."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import linear_scan as lk
    from repro_torch.models import build_model
    cfg = get_config("zamba2_2p7b", smoke=True)
    cpu = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0), scale=0.2)
    dev = build_model(cfg, device=cuda).load_params(cpu.params())
    toks = torch.randint(0, cfg.vocab, (2, 70),
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        before = lk.launch_count()
        full = dev.logits(dev.hidden_states(toks.to(cuda)))
        assert lk.launch_count() == before + cfg.n_layers
        torch.testing.assert_close(full.cpu(), cpu.logits(
            cpu.hidden_states(toks)), rtol=2e-4, atol=2e-4)
        c_cpu, c_dev = cpu.init_cache(2, 70), dev.init_cache(2, 70)
        before = gk.launch_count()
        for t in range(70):
            c_cpu, l_cpu = cpu.decode_step(c_cpu, toks[:, t])
            c_dev, l_dev = dev.decode_step(c_dev, toks[:, t].to(cuda))
            torch.testing.assert_close(l_dev.cpu(), l_cpu, rtol=2e-4,
                                       atol=2e-4)
        assert gk.launch_count() == before + 70 * dev.n_invocations
