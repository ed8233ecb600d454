"""The port's kernel layer on the CPU against the JAX package's.

``repro_torch.kernels.ops.rir_matmul``, ``ops.gqa_decode``,
``ops.linear_scan`` and the BIRRD ops on CPU tensors run their plain
PyTorch versions; each is held against the JAX Pallas kernel (interpret
mode on the CPU) and the JAX ``ref`` oracle over the ``test_kernels.py``
sweep, and the port's
conv/depthwise versions against the JAX ones.  The same inputs, made with
numpy from a seed, go to both.  Tolerances are the JAX sweeps': 2e-4
(``rir_matmul``) and 5e-4 (``gqa_decode``) for f32, sums in another order;
2e-2 and 3e-2 for bf16 (8-bit mantissa, rounded at other places by the two
frameworks).  ``linear_scan``: 1e-4 in f32 against the Pallas kernel (the
same chunked algorithm), the JAX sweep's 3e-3 against the stepwise oracle,
2e-2 for bf16 q/k/v; its gradient (recomputed through the chunked version
on both sides) within 1e-4 of max |g|.  BIRRD: bit for bit against the
Pallas ``birrd_apply_p`` on routed programs (each stage an exact copy or
one f32 sum of two values), whether the program runs as switches
(``ref.birrd_switch``) or as stage matrices; 1e-5 on dense stage matrices
and against the RIR oracle (it sums a group in another order).
``rir_matmul.launch_plan``, the kernel's cut of a GEMM, is pinned: its
K-splits and their K ranges never depend on M.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
from numpy.testing import assert_allclose

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import gqa_decode as gk
from repro_torch.kernels import rir_matmul as rk

TORCH_DT = {"f32": torch.float32, "bf16": torch.bfloat16}
JAX_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TOL = {"f32": 2e-4, "bf16": 2e-2}


def _np(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _both(x, dt):
    """The same numpy array as a torch and a jax array of dtype ``dt``."""
    return torch.from_numpy(x).to(TORCH_DT[dt]), jnp.asarray(x, JAX_DT[dt])


def _f32(y):
    if torch.is_tensor(y):
        return y.float().numpy()
    return np.asarray(y, np.float32)


@pytest.mark.parametrize("m,k,n,bm,bn,bk", [
    (128, 128, 256, 128, 128, 128),
    (256, 384, 512, 128, 128, 128),
    (256, 256, 1024, 128, 256, 64),
])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("with_res", [False, True])
def test_rir_matmul_sweep_matches_jax(m, k, n, bm, bn, bk, dt, with_res):
    rng = np.random.default_rng(m + k + n)
    a_t, a_j = _both(_np(rng, (m, k)), dt)
    b_t, b_j = _both(_np(rng, (k, n)), dt)
    r_t, r_j = _both(_np(rng, (m, n)), dt) if with_res else (None, None)
    perm = tuple(int(x) for x in rng.permutation(n // bn))
    y = ops.rir_matmul(a_t, b_t, perm, residual=r_t, block_n=bn)
    assert y.dtype == TORCH_DT[dt] and y.shape == (m, n)
    y_kernel = jops.rir_matmul(a_j, b_j, perm, residual=r_j, block_m=bm,
                               block_n=bn, block_k=bk)
    y_ref = jref.rir_matmul(a_j, b_j, perm, bn, residual=r_j)
    tol = TOL[dt]
    assert_allclose(_f32(y), _f32(y_kernel), rtol=tol, atol=tol)
    assert_allclose(_f32(y), _f32(y_ref), rtol=tol, atol=tol)


def test_rir_matmul_identity_and_tensor_perm():
    rng = np.random.default_rng(3)
    a, b = _np(rng, (128, 128)), _np(rng, (128, 256))
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    y = ops.rir_matmul(at, bt, None)
    assert_allclose(y.numpy(), np.asarray(jops.rir_matmul(
        jnp.asarray(a), jnp.asarray(b), None)), rtol=2e-4, atol=2e-4)
    # a perm given as an int32 tensor (the executor's form) == as a tuple
    perm = (1, 0)
    y_t = ops.rir_matmul(at, bt, ops.device_perm(perm, "cpu"))
    assert torch.equal(y_t, ops.rir_matmul(at, bt, perm))
    assert torch.equal(y_t[:, :128], y[:, 128:])


def test_rir_matmul_ragged_m_and_k():
    """No padding needed: M and K need not tile (the kernel masks them)."""
    rng = np.random.default_rng(4)
    a, b = _np(rng, (100, 147)), _np(rng, (147, 256))
    y = ops.rir_matmul(torch.from_numpy(a), torch.from_numpy(b), (1, 0))
    want = np.asarray(jref.rir_matmul(jnp.asarray(a), jnp.asarray(b),
                                      (1, 0), 128))
    assert_allclose(y.numpy(), want, rtol=2e-4, atol=2e-4)


def test_rir_matmul_rejects_bad_perm_and_width():
    a, b = torch.zeros(8, 16), torch.zeros(16, 256)
    with pytest.raises(ValueError, match="permutation"):
        ops.rir_matmul(a, b, (0, 0))
    with pytest.raises(ValueError, match="multiple"):
        ops.rir_matmul(a, torch.zeros(16, 200), None)


def test_only_checked_perms_reach_the_kernel():
    """The kernel stores at ``perm[j] * block_n``: it takes only tensors
    ``device_perm`` made (values checked), unwritten since."""
    checked = ops.device_perm((1, 0), "cpu")
    assert rk._is_checked_perm(checked)
    assert ops.device_perm([1, 0], "cpu") is checked
    assert not rk._is_checked_perm(torch.tensor([1, 0], dtype=torch.int32))
    fresh = rk.register_perm(torch.tensor([0, 1], dtype=torch.int32))
    assert rk._is_checked_perm(fresh)
    fresh[0] = 7
    assert not rk._is_checked_perm(fresh)
    with pytest.raises(ValueError, match="permutation"):
        ops.device_perm((0, 2), "cpu")


def test_cuda_wrapper_checks_before_any_build():
    """The CUDA wrapper refuses a CPU tensor up front; importing the module
    and failing a check never compiles anything."""
    a, b = torch.zeros(8, 16), torch.zeros(16, 128)
    perm = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        rk.rir_matmul_cuda(a, b, perm)
    assert rk._lib is None
    assert rk.library_path().parent == rk.BUILD_DIR


@pytest.mark.parametrize("R,S,stride,H,W", [(3, 3, 1, 9, 9), (5, 5, 2, 15, 13),
                                            (1, 1, 1, 6, 6), (7, 7, 2, 20, 20)])
def test_conv_refs_match_jax(R, S, stride, H, W):
    rng = np.random.default_rng(R * 10 + stride)
    x = _np(rng, (2, H, W, 8))
    w = _np(rng, (R, S, 8, 12))
    dw = _np(rng, (R, S, 8))
    y = ref.conv2d(torch.from_numpy(x), torch.from_numpy(w), stride)
    assert_allclose(y.numpy(), np.asarray(jref.conv2d(
        jnp.asarray(x), jnp.asarray(w), stride)), rtol=1e-5, atol=1e-5)
    yd = ref.depthwise_conv2d(torch.from_numpy(x), torch.from_numpy(dw),
                              stride)
    assert_allclose(yd.numpy(), np.asarray(jref.depthwise_conv2d(
        jnp.asarray(x), jnp.asarray(dw), stride)), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ gqa_decode
@pytest.mark.parametrize("b,hq,hkv,d,s", [
    (2, 8, 2, 64, 512), (1, 4, 4, 128, 1024), (3, 8, 1, 64, 2048),
])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_gqa_decode_sweep_matches_jax(b, hq, hkv, d, s, dt):
    rng = np.random.default_rng(b * hq + s)
    q_t, q_j = _both(_np(rng, (b, hq, d)), dt)
    k_t, k_j = _both(_np(rng, (b, s, hkv, d)), dt)
    v_t, v_j = _both(_np(rng, (b, s, hkv, d)), dt)
    lens = rng.integers(s // 2, s + 1, size=b).astype(np.int32)
    y = ops.gqa_decode(q_t, k_t, v_t, torch.from_numpy(lens))
    assert y.dtype == TORCH_DT[dt] and y.shape == (b, hq, d)
    tol = 3e-2 if dt == "bf16" else 5e-4
    y_kernel = jops.gqa_decode(q_j, k_j, v_j, jnp.asarray(lens))
    y_ref = jref.gqa_decode(q_j, k_j, v_j, jnp.asarray(lens))
    assert_allclose(_f32(y), _f32(y_kernel), rtol=tol, atol=tol)
    assert_allclose(_f32(y), _f32(y_ref), rtol=tol, atol=tol)


def test_gqa_decode_ignores_kv_past_length():
    rng = np.random.default_rng(7)
    q = torch.from_numpy(_np(rng, (2, 6, 32)))
    k = torch.from_numpy(_np(rng, (2, 300, 3, 32)))
    v = torch.from_numpy(_np(rng, (2, 300, 3, 32)))
    lens = torch.tensor([1, 129], dtype=torch.int32)
    y = ops.gqa_decode(q, k, v, lens)
    k2, v2 = k.clone(), v.clone()
    k2[0, 1:], v2[0, 1:] = 1e4, -1e4
    k2[1, 129:], v2[1, 129:] = 1e4, -1e4
    assert torch.equal(ops.gqa_decode(q, k2, v2, lens), y)
    # length 1 attends to position 0 alone: the output is v[0] exactly
    assert torch.allclose(y[0], v[0, 0].repeat_interleave(2, dim=0))


def test_gqa_decode_cuda_wrapper_checks_before_any_build():
    q, k = torch.zeros(1, 4, 64), torch.zeros(1, 16, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        gk.gqa_decode_cuda(q, k, k, torch.ones(1, dtype=torch.int32))
    assert gk._lib is None
    assert gk.library_path().parent == build.BUILD_DIR
    assert gk.library_path().name.startswith("libgqa_decode-")
    assert rk.library_path().name.startswith("librir_matmul-")


def test_gqa_decode_constants_mirror_the_source():
    """The wrapper sizes the kernel's workspace and split count from
    WARP_ROWS/WARP_TILES/SLOTS/MAX_WARPS/MAX_GROUP/ROW_PAD; they must be the
    source's kWarpRows/kWarpTiles/kSlots/kMaxWarps/kMaxGroup/kRowPad
    (``load`` also checks the split and shared-memory rules against the
    built library's)."""
    src = gk.SOURCE.read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert (int(consts["kWarpRows"]), int(consts["kWarpTiles"]),
            int(consts["kSlots"]), int(consts["kMaxWarps"]),
            int(consts["kMaxGroup"]), int(consts["kRowPad"])) == (
        gk.WARP_ROWS, gk.WARP_TILES, gk.SLOTS, gk.MAX_WARPS, gk.MAX_GROUP,
        gk.ROW_PAD)
    assert (int(consts["kMinD"]), int(consts["kMaxD"])) == (gk.D_MIN,
                                                            gk.D_MAX)
    assert f"__global__ void __launch_bounds__(kMaxWarps * 32)\n{gk.KERNEL}(" \
        in src
    # 256-position splits (two 32-row tiles for each of four warps, a ring
    # of three slots a warp) wherever four warps' rings fit: every bf16 D,
    # f32 up to D = 128; 128 beyond
    assert gk.SPLIT == 256
    assert [gk.split_len(D, 2) for D in (16, 80, 128, 256)] == [256] * 4
    assert [gk.split_len(D, 4) for D in (64, 128, 144, 256)] == \
        [256, 256, 128, 128]
    assert gk.n_splits(1024, 128, 2) == 4 and gk.n_splits(1000, 128, 2) == 4
    assert gk.n_splits(80, 80, 2) == 1 and gk.n_splits(1000, 256, 4) == 8
    assert [gk.group_width(G) for G in (1, 2, 3, 4, 5, 8, 12)] == \
        [1, 2, 4, 4, 8, 8, 8]
    # two CTAs share an SM at the llama3.2-3b decode shape (G 3, D 128,
    # bf16; 1 KB reserved a CTA of the SM's 228 KB), so its 256 CTAs are
    # one wave on 132 SMs; every shape fits a block
    assert 2 * (gk.smem_bytes(3, 128, 2) + 1024) <= 233472
    assert max(gk.smem_bytes(G, D, it) for G in (1, 8, 64)
               for D in range(16, 257, 16) for it in (2, 4)) <= gk.MAX_SMEM


def test_gqa_decode_workspace_sizes():
    """A counter for every (b, h, group), and (m, l) and the acc of every
    (b, h, split, query head)."""
    B, Hq, Hkv, S, D = 8, 24, 8, 1024, 128       # llama3.2-3b decode
    assert gk.workspace_sizes(B, Hq, Hkv, S, D, 2) == (
        B * Hkv, 2 * B * Hkv * 4 * 3, B * Hkv * 4 * 3 * D)
    assert gk.workspace_sizes(1, 12, 1, 80, 80, 2) == (2, 2 * 12, 12 * 80)


def test_gqa_decode_workspace_is_kept_per_stream():
    """One (counters, partials) pair per (device, stream): reused while
    large enough, each replaced when too short (the counters by zeros),
    never shared by two streams."""
    import types
    dev = torch.device("cpu")
    s1, s2 = (types.SimpleNamespace(cuda_stream=n) for n in (101, 102))
    saved = dict(gk._workspaces)
    try:
        cnt, part = gk._workspace(dev, s1, 8, 64)
        assert cnt.dtype == torch.int32 and cnt.numel() == 8
        assert not cnt.any() and part.numel() == 64
        assert gk._workspace(dev, s1, 4, 32) == (cnt, part)
        other = gk._workspace(dev, s2, 4, 32)
        assert other[0] is not cnt and other[1] is not part
        cnt2, part2 = gk._workspace(dev, s1, 8, 128)
        assert cnt2 is cnt and part2 is not part and part2.numel() == 128
        cnt3, part3 = gk._workspace(dev, s1, 16, 16)
        assert part3 is part2 and cnt3.numel() == 16 and not cnt3.any()
    finally:
        gk._workspaces.clear()
        gk._workspaces.update(saved)


# ----------------------------------------------------------------- linear_scan
def _scan_np(rng, b, h, t, dk, dv, decay_scale=0.2):
    """q, k, v ~ N(0, 1) and log decay -|N(0, 1)| * scale: the JAX sweep's
    inputs."""
    q, k = _np(rng, (b, h, t, dk)), _np(rng, (b, h, t, dk))
    v = _np(rng, (b, h, t, dv))
    w = -np.abs(_np(rng, (b, h, t, dk))) * np.float32(decay_scale)
    return q, k, v, w


SCAN_SHAPES = [(2, 3, 128, 32, 64), (1, 2, 256, 64, 64), (2, 1, 192, 16, 16)]


@pytest.mark.parametrize("b,h,t,dk,dv", SCAN_SHAPES)
def test_linear_scan_matches_jax_kernel_and_ref(b, h, t, dk, dv):
    """f32: the JAX Pallas kernel (interpret mode) at 1e-4, the same
    chunked algorithm; the JAX stepwise oracle at the JAX sweep's 3e-3."""
    arrs = _scan_np(np.random.default_rng(t + dk), b, h, t, dk, dv)
    y = ops.linear_scan(*map(torch.from_numpy, arrs))
    assert y.dtype == torch.float32 and y.shape == (b, h, t, dv)
    jarrs = [jnp.asarray(a) for a in arrs]
    assert_allclose(y.numpy(), np.asarray(jops.linear_scan(*jarrs)),
                    rtol=1e-4, atol=1e-4)
    assert_allclose(y.numpy(), np.asarray(jref.linear_scan(*jarrs)),
                    rtol=3e-3, atol=3e-3)


@pytest.mark.parametrize("b,h,t,dk,dv", SCAN_SHAPES)
def test_linear_scan_bf16_matches_jax(b, h, t, dk, dv):
    """bf16 q/k/v (f32 log decay): both packages compute in f32 and round
    the output to bf16; 2e-2."""
    q, k, v, w = _scan_np(np.random.default_rng(t), b, h, t, dk, dv)
    (qt, qj), (kt, kj), (vt, vj) = _both(q, "bf16"), _both(k, "bf16"), \
        _both(v, "bf16")
    y = ops.linear_scan(qt, kt, vt, torch.from_numpy(w))
    assert y.dtype == torch.bfloat16
    want = jops.linear_scan(qj, kj, vj, jnp.asarray(w))
    assert_allclose(_f32(y), _f32(want), rtol=2e-2, atol=2e-2)


def test_linear_scan_decay_underflow_matches_jax():
    """-60 log decay kills all history (the JAX decay-semantics case):
    y_t = (q_t . k_t) v_t, no NaN, against the Pallas kernel at 1e-4."""
    rng = np.random.default_rng(9)
    q, k, v = _np(rng, (1, 1, 16, 8)), _np(rng, (1, 1, 16, 8)), \
        _np(rng, (1, 1, 16, 8))
    w = np.full((1, 1, 16, 8), -60.0, np.float32)
    y = ops.linear_scan(*map(torch.from_numpy, (q, k, v, w))).numpy()
    expect = np.einsum("bhtd,bhtd->bht", q, k)[..., None] * v
    assert np.isfinite(y).all()
    assert_allclose(y, expect, rtol=1e-4, atol=1e-4)
    assert_allclose(y, np.asarray(jops.linear_scan(
        *map(jnp.asarray, (q, k, v, w)))), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("t", [100, 200, 37])
def test_linear_scan_ragged_t_matches_stepwise(t):
    """A T that 64 does not divide: the plain chunked version shrinks its
    chunk (the kernel masks its last chunk instead), both against the
    port's stepwise recurrence at 3e-3."""
    arrs = _scan_np(np.random.default_rng(t), 2, 2, t, 32, 16)
    ts = list(map(torch.from_numpy, arrs))
    y = ops.linear_scan(*ts)
    assert_allclose(y.numpy(), ref.linear_scan(*ts).numpy(), rtol=3e-3,
                    atol=3e-3)


def test_linear_scan_stepwise_ref_matches_jax():
    arrs = _scan_np(np.random.default_rng(5), 2, 2, 48, 16, 24)
    y = ref.linear_scan(*map(torch.from_numpy, arrs))
    assert_allclose(y.numpy(), np.asarray(jref.linear_scan(
        *map(jnp.asarray, arrs))), rtol=1e-5, atol=1e-5)


def test_linear_scan_grad_matches_jax():
    """``torch.autograd.grad`` through the port's ``ops.linear_scan``
    against ``jax.grad`` through ``repro``'s (its ``custom_vjp``: both
    recompute through the chunked version); 1e-4 x max |g| per operand."""
    import jax
    arrs = _scan_np(np.random.default_rng(13), 1, 2, 128, 16, 32)
    g = _np(np.random.default_rng(14), (1, 2, 128, 32))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    got = torch.autograd.grad(ops.linear_scan(*ts), ts, torch.from_numpy(g))

    def f(*xs):
        return jnp.sum(jops.linear_scan(*xs) * jnp.asarray(g))

    want = jax.grad(f, argnums=(0, 1, 2, 3))(*map(jnp.asarray, arrs))
    for name, a, b in zip("qkvw", got, want):
        b = np.asarray(b)
        assert np.isfinite(a.numpy()).all(), name
        assert_allclose(a.numpy(), b, rtol=0,
                        atol=1e-4 * np.abs(b).max(), err_msg=name)


def test_linear_scan_cuda_wrapper_checks_before_any_build():
    from repro_torch.kernels import linear_scan as lk
    q = torch.zeros(1, 2, 64, 32)
    with pytest.raises(ValueError, match="CUDA"):
        lk.linear_scan_cuda(q, q, q, q)
    assert lk._lib is None
    assert lk.library_path().parent == build.BUILD_DIR
    assert lk.library_path().name.startswith("liblinear_scan-")


def test_linear_scan_constants_mirror_the_source():
    from repro_torch.kernels import linear_scan as lk
    src = lk.SOURCE.read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert (int(consts["kChunk"]), int(consts["kSub"])) == (lk.CHUNK, lk.SUB)
    assert f"__launch_bounds__(kThreads, kMinBlocks)\n{lk.KERNEL}(" in src
    for d in lk.HEAD_DIMS:
        assert f"case {d}: return launch_dims" in src
        assert f"case {d}: return launch_dv" in src
    # one launch a call of 256 threads, two CTAs an SM; S between the 4
    # blocks of 16 rows by 6 pairs of 16 tiles of 4 x 4, inside them by 4
    # blocks of 10 tiles, 4 lanes a tile
    assert [int(consts[n]) for n in ("kThreads", "kMinBlocks", "kPreThreads",
                                     "kDiagThreads")] == [256, 2, 96, 160]


# ---------------------------------------------------------------- birrd_reduce
BIRRD_SWEEP = [(8, 128), (16, 256), (16, 512)]


def _jax_birrd_apply_p(x, mats):
    """The Pallas kernel in interpret mode."""
    from repro.kernels.birrd_reduce import birrd_apply_p
    return birrd_apply_p(x, jnp.asarray(mats), interpret=True)


@pytest.mark.parametrize("aw,d", BIRRD_SWEEP)
def test_birrd_reduce_matches_jax_kernel_bitwise(aw, d):
    """``tests/test_kernels.py``'s sweep (aw/2 groups of 2 to the even
    ports): the port's ``birrd_reduce`` equals the Pallas kernel bit for
    bit (a routed program sums at most two values a stage, exactly as
    either side does), and the RIR oracle of both packages at 1e-5."""
    x = _np(np.random.default_rng(aw + d), (aw, d))
    gids = [i // 2 for i in range(aw)]
    ports = [2 * g for g in range(aw // 2)]
    y = ops.birrd_reduce(torch.from_numpy(x), gids, ports)
    assert y.dtype == torch.float32 and y.shape == (aw, d)
    assert np.array_equal(y.numpy(), np.asarray(
        jops.birrd_reduce(jnp.asarray(x), gids, ports)))
    want = jref.birrd_reduce(jnp.asarray(x), jnp.asarray(gids, jnp.int32),
                             jnp.asarray(ports, jnp.int32), aw)
    assert_allclose(y.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    mine = ref.birrd_reduce(torch.from_numpy(x), torch.tensor(gids),
                            torch.tensor(ports), aw)
    assert_allclose(y.numpy(), mine.numpy(), rtol=1e-5, atol=1e-5)


def test_birrd_pure_reorder_matches_jax_bitwise():
    rng = np.random.default_rng(21)
    x = _np(rng, (8, 128))
    perm = [int(p) for p in rng.permutation(8)]
    y = ops.birrd_reduce(torch.from_numpy(x), list(range(8)), perm)
    assert np.array_equal(y.numpy(), np.asarray(
        jops.birrd_reduce(jnp.asarray(x), list(range(8)), perm)))
    moved = np.zeros_like(x)
    moved[perm] = x                     # a reorder moves values exactly
    assert np.array_equal(y.numpy(), moved)


@pytest.mark.parametrize("aw,gids,ports", [
    (4, [0, 0, 0, 0], [2]),
    (16, [0] * 4 + [1] * 4 + [2] * 4 + [3] * 4, [0, 4, 8, 12]),
    (16, [0, 0, 0, 1, 1, 2, 2, 2] + [3] * 4 + [-1] * 4, [1, 5, 9, 13]),
    (32, list(range(32)), [((i << 2) | (i >> 3)) & 31 for i in range(32)]),
])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_birrd_apply_p_routed_programs_match_jax_bitwise(aw, gids, ports,
                                                         dt):
    """Routed stage matrices through ``ops.birrd_apply_p`` (unmasked)
    against the Pallas ``birrd_apply_p`` in interpret mode: equal bit for
    bit in f32 and in bf16 (f32 stages, one rounding on the way out)."""
    from repro_torch.kernels.birrd_reduce import _routed_stage_mats
    mats = _routed_stage_mats(aw, tuple(gids), tuple(ports),
                              torch.device("cpu"))
    xt, xj = _both(_np(np.random.default_rng(aw), (aw, 256)), dt)
    y = ops.birrd_apply_p(xt, mats)
    assert y.dtype == TORCH_DT[dt] and y.shape == (aw, 256)
    assert np.array_equal(_f32(y), _f32(_jax_birrd_apply_p(xj,
                                                           mats.numpy())))


@pytest.mark.parametrize("aw,S", [(4, 3), (8, 6), (16, 8)])
def test_birrd_apply_p_dense_stage_matrices_match_jax(aw, S):
    """Random dense stage matrices (no longer exact sums): the JAX sweep's
    1e-5, relative to the output's scale."""
    rng = np.random.default_rng(aw * S)
    mats = (_np(rng, (S, aw, aw)) / np.float32(np.sqrt(aw)))
    x = _np(rng, (aw, 384))
    y = ops.birrd_apply_p(torch.from_numpy(x), torch.from_numpy(mats))
    want = np.asarray(_jax_birrd_apply_p(jnp.asarray(x), mats))
    assert_allclose(y.numpy(), want, rtol=1e-5,
                    atol=1e-5 * np.abs(want).max())


def test_birrd_apply_configs_match_jax():
    """``ops.birrd_apply`` compiles a config program (memoized, numpy) and
    runs it: the same as the JAX ``birrd_apply``."""
    from repro.kernels.birrd_reduce import birrd_apply as jbirrd_apply
    from repro_torch.kernels.birrd_reduce import _birrd
    cfg = _birrd(8).route([0, 0, 1, 1, 2, 2, 3, 3], [6, 0, 2, 4])
    x = _np(np.random.default_rng(22), (8, 128))
    y = ops.birrd_apply(torch.from_numpy(x), cfg)
    assert np.array_equal(y.numpy(), np.asarray(
        jbirrd_apply(jnp.asarray(x), cfg, interpret=True)))


def test_birrd_reduce_memoizes_routing_and_lowering():
    """Repeat calls with the same (aw, group_ids, out_ports) on one device
    hit the routing/encoding/upload cache instead of re-searching the
    switch network; the port's counterpart of the JAX test."""
    from repro_torch.kernels.birrd_reduce import _routed_program
    gids, ports = [i // 2 for i in range(8)], [2 * g for g in range(4)]
    rng = np.random.default_rng(23)
    y0 = ops.birrd_reduce(torch.from_numpy(_np(rng, (8, 128))), gids, ports)
    before = _routed_program.cache_info()
    x = _np(rng, (8, 128))
    y1 = ops.birrd_reduce(torch.from_numpy(x), gids, ports)
    after = _routed_program.cache_info()
    assert after.hits == before.hits + 1
    assert after.misses == before.misses
    want = jref.birrd_reduce(jnp.asarray(x), jnp.asarray(gids, jnp.int32),
                             jnp.asarray(ports, jnp.int32), 8)
    assert_allclose(y1.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    del y0


def test_birrd_reduce_ragged_d_and_bad_pattern():
    """Any d (the JAX wrapper asserts d % 128 == 0; the kernel masks its
    ragged edge) against the oracle; a pattern the router refuses (two
    groups on one port) raises before anything runs."""
    x = _np(np.random.default_rng(24), (16, 77))
    gids = [i // 4 for i in range(16)]
    y = ops.birrd_reduce(torch.from_numpy(x), gids, [0, 4, 8, 12])
    want = ref.birrd_reduce(torch.from_numpy(x), torch.tensor(gids),
                            torch.tensor([0, 4, 8, 12]), 16)
    assert_allclose(y.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="distinct"):
        ops.birrd_reduce(torch.from_numpy(x[:4]), [0, 1, 0, 1], [0, 0])


def test_birrd_cuda_wrapper_checks_before_any_build():
    from repro_torch.kernels import birrd_reduce as bk
    x, mats = torch.zeros(8, 128), torch.zeros(6, 8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        bk.birrd_apply_cuda(x, mats)
    assert bk._lib is None
    assert bk.library_path().parent == build.BUILD_DIR
    assert bk.library_path().name.startswith("libbirrd_apply-")


def test_birrd_widths_mirror_the_source():
    """Both kernels are instantiated for every width the wrapper takes, and
    the switch kernel numbers the Egg configs as the switch model does."""
    from repro_torch.core import birrd
    from repro_torch.kernels import birrd_reduce as bk
    src = bk.SOURCE.read_text()
    for aw in bk.WIDTHS:
        assert f"case {aw}: return launch_aw<T, {aw}>" in src
        assert f"case {aw}: return launch_switch_aw<T, {aw}>" in src
    assert src.count("return launch_aw<") == len(bk.WIDTHS)
    assert src.count("return launch_switch_aw<") == len(bk.WIDTHS)
    assert (f"kSwap = {birrd.SWAP}, kAddLeft = {birrd.ADD_LEFT}, "
            f"kAddRight = {birrd.ADD_RIGHT}") in src
    assert birrd.PASS == 0         # a code the kernel does not name passes
    for kernel in (bk.SWITCH_KERNEL, bk.DENSE_KERNEL):
        assert f"__global__ void __launch_bounds__(kThreads)\n{kernel}(" \
            in src


# routed programs at every width: a swap, a full reduction (aw 4's three
# stages), pairs to scattered ports, the demo's groups of 4, and structured
# relayouts routed in closed form
BIRRD_ROUTED = [
    (2, [0, 1], [1, 0]),
    (4, [0, 0, 0, 0], [3]),
    (8, [0, 0, 1, 1, 2, 2, 3, 3], [6, 0, 2, 4]),
    (16, [i // 4 for i in range(16)], [0, 4, 8, 12]),
    (32, list(range(32)), [((i << 2) | (i >> 3)) & 31 for i in range(32)]),
    (64, list(range(64)), [((i << 3) | (i >> 3)) & 63 for i in range(64)]),
]


@pytest.mark.parametrize("aw,gids,ports", BIRRD_ROUTED)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True])
def test_birrd_switch_matches_stage_matrices_and_jax_bitwise(aw, gids, ports,
                                                             dt, masked):
    """``ref.birrd_switch`` (the switch kernel's plain version) walks a
    routed program's switches and wiring: bit for bit the plain stage loop
    on its compiled matrices and the Pallas ``birrd_apply_p`` in interpret
    mode, in f32 and bf16, with and without the port mask."""
    from repro_torch.kernels.birrd_reduce import (_out_port_mask,
                                                  _routed_configs,
                                                  compile_switch_program)
    cfg = _routed_configs(aw, tuple(gids), tuple(ports))
    mats = compile_switch_program(aw, cfg)
    xt, xj = _both(_np(np.random.default_rng(aw + 5), (aw, 128)), dt)
    mask = _out_port_mask(aw, tuple(ports), torch.device("cpu")) \
        if masked else None
    y = ref.birrd_switch(xt, cfg, mask)
    assert y.dtype == TORCH_DT[dt] and y.shape == (aw, 128)
    assert torch.equal(y, ref.birrd_apply(xt, torch.from_numpy(mats), mask))
    want = _f32(_jax_birrd_apply_p(xj, mats))
    if masked:
        want = np.where(mask.numpy()[:, None], want, 0.0)
    assert np.array_equal(_f32(y), want)


def test_birrd_program_codes_round_trip():
    """A program's codes (one byte a switch, stage-major) decode back to its
    configs; a program of the wrong shape or with a bad config is refused
    before anything is uploaded."""
    from repro_torch.kernels import birrd_reduce as bk
    for aw, gids, ports in BIRRD_ROUTED:
        cfg = bk._routed_configs(aw, tuple(gids), tuple(ports))
        codes = bk.encode_program(aw, cfg)
        assert codes.dtype == np.uint8
        assert codes.shape == (len(bk._birrd(aw).perms), aw // 2)
        assert bk.decode_program(codes) == [list(row) for row in cfg]
        _, dev = bk._routed_program(aw, tuple(gids), tuple(ports),
                                    torch.device("cpu"))
        assert np.array_equal(dev.numpy(), codes)
    with pytest.raises(ValueError, match="stages"):
        bk.encode_program(8, [[0] * 4] * 5)
    with pytest.raises(ValueError, match="bad config"):
        bk.encode_program(4, [[0, 4], [0, 0], [0, 0]])


# the twelve ResNet-50 batch-8 plan steps (M, K, N, block_n) as the executor
# launches them, and the JAX kernel sweep's shapes
RESNET_STEPS = [
    (100352, 147, 64, 64), (25088, 64, 64, 64), (25088, 576, 64, 64),
    (25088, 64, 256, 128), (6272, 256, 128, 128), (6272, 1152, 128, 128),
    (6272, 128, 512, 128), (1568, 512, 256, 128), (1568, 2304, 256, 128),
    (1568, 256, 1024, 128), (392, 1024, 512, 128), (392, 4608, 512, 128)]
JAX_SWEEP = [(128, 128, 256, 128), (256, 384, 512, 128),
             (256, 256, 1024, 256)]


@pytest.mark.parametrize("m,k,n,bn", RESNET_STEPS + JAX_SWEEP)
def test_rir_launch_plan_does_not_depend_on_m(m, k, n, bn):
    """The kernel's cut of a GEMM: the same tile, K-splits and K ranges
    for every M, so a row's sums are taken in the same order whatever rows
    share its launch; the K ranges tile [0, K) in whole slices, none
    empty, at most 8 splits (a portable cluster), a power of two."""
    plan = rk.launch_plan(m, k, n, bn)
    for rows in (1, 7, 49, 127, 128, 129, 392, m // 3 + 1, m, 2 * m):
        assert rk.launch_plan(rows, k, n, bn) == plan
    assert n % plan.tile_n == 0 and plan.tile_n in (64, 128)
    assert plan.splits in (1, 2, 4, 8) and plan.splits <= rk.MAX_SPLITS
    b = plan.k_bounds
    assert len(b) == plan.splits + 1 and b[0] == 0 and b[-1] == k
    assert all(lo < hi for lo, hi in zip(b, b[1:]))
    assert all(x % rk.TILE_K == 0 for x in b[:-1])
    if plan.splits > 1:
        assert min(hi - lo for lo, hi in zip(b, b[1:])) \
            >= rk.SPLIT_MIN_SLICES * rk.TILE_K - rk.TILE_K
    assert plan.kernels == (rk.KERNELS if plan.splits > 1
                            else rk.KERNELS[:1])


def test_rir_launch_plan_mirrors_the_source():
    """The wrapper's cut uses the kernel's tile constants, and the kernel
    computes a split's K range as ``_k_bounds`` does."""
    src = rk.SOURCE.read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kTileM"]) == rk.TILE_M
    assert int(consts["kTileK"]) == rk.TILE_K
    assert int(consts["kMaxSplits"]) == rk.MAX_SPLITS
    assert "const int per = (k_tiles + splits - 1) / splits;" in src
    assert "const int kt0 = blockIdx.z * per;" in src
    assert "__launch_bounds__(2 * TN, 128 / TN)  // kThreads<TN>\n" \
        f"{rk.KERNELS[0]}(" in src
    assert "constexpr int kThreads = kTileM * TN / 64;" in src
    assert f"__launch_bounds__(kReduceThreads)\n{rk.KERNELS[1]}(" in src
    # the kernel's split j walks slices [j * per, min((j + 1) * per, all))
    for k in (147, 576, 1152, 4608, 1000):
        for splits in (1, 2, 4, 8):
            slices = -(-k // 16)
            per = -(-slices // splits)
            if (splits - 1) * per >= slices:
                continue
            want = tuple(min(j * per * 16, k) for j in range(splits)) + (k,)
            assert rk._k_bounds(k, splits) == want
