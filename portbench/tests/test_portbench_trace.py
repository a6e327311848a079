"""Reading profiler traces: the device's busy time is the union of its
intervals, and work is tied to the span it was launched from."""
import json
from types import SimpleNamespace

from portbench.tests import threads  # noqa: F401
from portbench import yardstick
from portbench.harness import SPAN_UPDATE, metric_reader
from portbench.trace import WINDOW, Trace, device_busy_s


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _write(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_device_busy_is_the_union_of_device_intervals(tmp_path):
    # 0-100 and 50-150 overlap, 200-250 apart; host events do not count
    path = _write(tmp_path, [
        _x("kernel", "a", 0, 100), _x("kernel", "b", 50, 100),
        _x("gpu_memcpy", "c", 200, 50), _x("cpu_op", "d", 0, 1000),
        {"ph": "i", "cat": "kernel", "name": "e", "ts": 400}])
    assert abs(device_busy_s(path) - 200e-6) < 1e-12


def test_trace_window_spans_kernels_and_breakdown(tmp_path):
    path = _write(tmp_path, [
        _x("user_annotation", WINDOW, 100, 1000),
        _x("user_annotation", "portbench/update", 200, 100),
        _x("cuda_runtime", "cudaLaunchKernel", 250, 5, corr=1),
        _x("cuda_runtime", "cudaLaunchKernel", 600, 5, corr=2),
        _x("kernel", "fused_adamw_kernel", 300, 200, corr=1),
        _x("kernel", "gemm", 650, 100, corr=2),
        _x("kernel", "gemm", 0, 50, corr=3)])        # before the window
    tr = Trace.load(path)
    assert abs(tr.window_s - 1000e-6) < 1e-12
    t, n = tr.kernels("gemm")
    assert n == 1 and abs(t - 100e-6) < 1e-12
    assert abs(tr.span_device_s("portbench/update") - 200e-6) < 1e-12
    assert tr.span_count("portbench/update") == 1
    b = tr.breakdown()
    assert b["device_ops"][0][0] == "fused_adamw_kernel"
    # idle: 100-300, 500-650 and 750-1100 of the window
    assert abs(sum(v for _, v in b["idle_gaps"]) - 700e-6) < 1e-12


def test_window_work_is_chosen_by_its_launch(tmp_path):
    # the device's stamps put the last kernel past the window's end and
    # one launched before the window inside it: the launches decide
    path = _write(tmp_path, [
        _x("user_annotation", WINDOW, 100, 1000),
        _x("cuda_runtime", "cudaLaunchKernel", 50, 5, corr=1),
        _x("cuda_runtime", "cudaLaunchKernel", 1000, 5, corr=2),
        _x("kernel", "fused_adamw_kernel", 120, 30, corr=1),
        _x("kernel", "fused_adamw_kernel", 1080, 40, corr=2),
        _x("kernel", "fused_adamw_kernel", 500, 10, corr=9)])  # no launch
    tr = Trace.load(path)
    t, n = tr.kernels("fused_adamw_kernel")
    assert n == 2 and abs(t - 50e-6) < 1e-12
    b = tr.breakdown()
    assert b["device_ops"] == [["fused_adamw_kernel", t]]


def test_adamw_roofline_leaves_out_a_step_that_lost_a_launch(tmp_path):
    # two leaves a step; the second step's trace lost one launch
    ev = [_x("user_annotation", WINDOW, 0, 10000),
          _x("user_annotation", SPAN_UPDATE, 1000, 500),
          _x("user_annotation", SPAN_UPDATE, 6000, 500)]
    for corr, (launch, dur) in enumerate(
            [(1100, 40), (1200, 60), (6100, 30)], start=1):
        ev += [_x("cuda_runtime", "cudaLaunchKernel", launch, 5, corr=corr),
               _x("kernel", "fused_adamw_kernel<float, float>", launch + 10,
                  dur, corr=corr)]
    tr = Trace.load(_write(tmp_path, ev))
    got = tr.kernels_by_span("fused_adamw", SPAN_UPDATE)
    assert [n for _, n in got] == [2, 1]
    assert all(abs(t - want) < 1e-12
               for (t, _), want in zip(got, (100e-6, 30e-6)))
    leaves = [(1000, "float32"), (3000, "bfloat16")]
    ctx = SimpleNamespace(trace=tr, leaves=leaves)
    least = sum(yardstick.least_time(0, yardstick.adamw_bytes(n, d, d),
                                     yardstick.PEAK_BF16_FLOPS)
                for n, d in leaves)
    got = metric_reader("adamw_roofline")(ctx)
    assert abs(got - 100.0 * least / 100e-6) < 1e-9 * got
    # no whole step: nothing to read
    ctx.leaves = leaves * 2
    assert metric_reader("adamw_roofline")(ctx) is None
