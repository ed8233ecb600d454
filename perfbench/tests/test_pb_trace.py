"""The trace reduction on a hand-made chrome trace."""
import json

import numpy as np
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


def test_device_ranges(tmp_path):
    """The program's ranges on the device, clipped to the window: the
    device time of the events inside them, a nested or repeated range
    counted once; an event lying partly outside the window is not whole."""
    evs = [
        ev("user_annotation", trace.RANGE, 100.0, 100.0, tid=9),
        ev("kernel", "linear_scan_kernel", 90.0, 20.0, tid=7),
        ev("kernel", "linear_scan_kernel", 120.0, 10.0, tid=7),
        ev("kernel", "elementwise", 135.0, 10.0, tid=7),
        ev("kernel", "mm", 160.0, 30.0, tid=7),
        ev("gpu_user_annotation", "linear_scan.backward", 118.0, 30.0,
           tid=7),
        ev("gpu_user_annotation", "linear_scan.backward", 119.0, 5.0, tid=7),
        ev("gpu_user_annotation", "adamw.update", 170.0, 50.0, tid=7),
        ev("gpu_user_annotation", trace.RANGE, 90.0, 100.0, tid=7),
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": evs}))
    t = trace.read_chrome_trace(p)
    assert sorted(n for n, _, _ in t.ranges) == [
        "adamw.update", "linear_scan.backward", "linear_scan.backward"]
    # [118, 148]: the scan kernel 10 us and the elementwise one 10 us
    assert t.range_s("linear_scan.backward") == pytest.approx(20e-6)
    # [170, 200] (clipped): the last 20 us of mm
    assert t.range_s("adamw.update") == pytest.approx(20e-6)
    assert t.range_s("absent") == 0.0
    scans = [e for e in t.events if e.cls == "scan"]
    assert [e.whole for e in scans] == [False, True]


def recorded(device_ranges: bool):
    """A trace laid out as a served run records it (launches on two worker
    threads, copies, the GEMM kernel, gathers, gaps), from a fixed seed;
    with ``device_ranges`` also device-side copies of the program's
    ranges."""
    rng = np.random.default_rng(2800000405)
    evs = [ev("user_annotation", trace.RANGE, 1000.0, 50000.0, tid=9)]
    t, corr = 900.0, 0
    kinds = [("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy"),
             ("void rir_matmul_kernel_tf32x3<CUtensorMap_st>", "kernel"),
             ("void at::native::vectorized_gather_kernel<4>", "kernel"),
             ("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy"),
             ("void at::native::elementwise_kernel<128, 2>", "kernel")]
    while t < 51500.0:
        tid = 2 + int(rng.integers(0, 2))
        name, cat = kinds[int(rng.integers(0, len(kinds)))]
        host = t - float(rng.uniform(5, 60))
        evs.append(ev("cpu_op", "aten::mm", host - 4, 3.5, tid=tid))
        evs.append(ev("cuda_runtime", "cudaLaunchKernel", host, 2.0, tid=tid,
                      correlation=corr))
        dur = float(rng.uniform(3, 400))
        evs.append(ev(cat, name, t, dur, tid=7, correlation=corr))
        if device_ranges and corr % 7 == 0:
            evs.append(ev("gpu_user_annotation", "serve.batch", t - 1,
                          dur + 2, tid=7))
        corr += 1
        t += dur + float(rng.exponential(20.0))
    return evs


#: what every reader of bert_large.offline read from ``recorded``, with
#: 12.648 requests in the window, before the reduction kept device-side
#: ranges
BEFORE = {
    "copy.h2d_ms_per_request.offline": 0.831740260451988,
    "copy.d2h_ms_per_request.offline": 0.859867585800503,
    "exec.index_ms_per_request.offline": 0.7722505688182603,
    "rir_matmul_roofline": 81.10123572602785,
    "kernels.roofline_pct": 24.82039740938721,
    "mfu_pct": 11.852235569412656,
    "device.idle_pct.offline": 9.45709034467923,
}


@pytest.mark.parametrize("device_ranges", [False, True])
def test_served_readers_read_as_before(tmp_path, device_ranges):
    from bench import spec
    from bench.context import Context
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": recorded(device_ranges)}))
    t = trace.read_chrome_trace(p)
    t.requests = 12.648
    ctx = Context(cell=spec.find_cell("bert_large.offline"), trace=t,
                  batch=64)
    assert ctx.per_layer() == {k: {"value": v, "unit": u} for (k, v), u in
                               zip(BEFORE.items(), ("ms", "ms", "ms", "%",
                                                    "%", "%", "%"))}
    assert t.busy_s() == 0.04527145482766038
