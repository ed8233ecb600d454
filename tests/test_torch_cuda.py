"""The port's CUDA kernel on the card (marked ``cuda``; skips without one).

Run on a machine with an NVIDIA card and ``nvcc``:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The kernel is held against its plain PyTorch version on the same device
(2e-4 for f32: fp32 sums in another order; 2e-2 for bf16), and the
executor's batched output against the same requests run one at a time,
bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
