"""The port's kernel layer on the CPU against the JAX package's.

``repro_torch.kernels.ops.rir_matmul`` on CPU tensors runs its plain PyTorch
version; it is held against the JAX Pallas kernel (interpret mode on the
CPU) and the JAX ``ref`` oracle over the ``test_kernels.py`` sweep, and the
port's conv/depthwise versions against the JAX ones.  The same inputs, made
with numpy from a seed, go to both.  Tolerances are the JAX sweep's: 2e-4
for f32 (fp32 sums in another order) and 2e-2 for bf16 (8-bit mantissa,
rounded at other places by the two frameworks).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
from numpy.testing import assert_allclose

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
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
