"""The trace reduction on a hand-made chrome trace."""
import json

import pytest

from bench import trace


def ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


def test_reduction(tmp_path):
    evs = [
        ev("user_annotation", trace.RANGE, 100.0, 100.0, tid=9),
        # host: worker tid 2 assembles, then launches
        ev("cpu_op", "aten::zeros", 105.0, 30.0, tid=2),
        ev("cuda_runtime", "cudaMemcpyAsync", 136.0, 2.0, tid=2,
           correlation=1),
        ev("cuda_runtime", "cudaLaunchKernel", 139.0, 1.0, tid=2,
           correlation=2),
        ev("cuda_runtime", "cudaLaunchKernel", 141.0, 1.0, tid=2,
           correlation=3),
        # device: a copy straddling the range's start, two overlapping
        # kernels, one kernel after the range
        ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 90.0, 50.0,
           tid=7, correlation=1, bytes=4 << 20),
        ev("kernel", "void rir_matmul_kernel<float, 64, 0>", 150.0, 20.0,
           tid=7, correlation=2),
        ev("kernel", "vectorized_gather_kernel", 160.0, 20.0, tid=7,
           correlation=3),
        ev("kernel", "late", 250.0, 5.0, tid=7, correlation=4),
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": evs}))
    t = trace.read_chrome_trace(p)
    assert t.window_s == pytest.approx(100e-6)
    assert len(t.events) == 3
    # union: [100, 140] + [150, 180] = 70 us, not the 80 us of the sum
    assert t.busy_s() == pytest.approx(70e-6)
    assert t.class_s("copy_h2d") == pytest.approx(40e-6)
    assert t.class_s("gemm") == pytest.approx(20e-6)
    assert t.class_s("index") == pytest.approx(20e-6)
    assert t.kernel_s() == pytest.approx(40e-6)
    gaps = dict((k, v) for k, v in t.top_gaps())
    # [140, 150]: the thread that launched the next kernel had finished its
    # launches; [180, 200]: nothing follows in the range
    assert gaps["after_cudaLaunchKernel"] == pytest.approx(10e-6)
    assert gaps["end_of_window"] == pytest.approx(20e-6)
    assert t.top_ops()[0][0] == "Memcpy HtoD (Pageable -> Device)"


def test_no_range_is_an_error(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": [ev("kernel", "k", 0, 1)]}))
    with pytest.raises(RuntimeError):
        trace.read_chrome_trace(p)
