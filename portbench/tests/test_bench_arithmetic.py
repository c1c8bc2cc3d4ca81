"""The window's arithmetic and the trace's reduction, on made-up
readings."""

import numpy as np
import pytest

from portbench.core import trace, window
from portbench.core.window import Answer, Call, Window


def _answer(k, rows):
    return Answer(None, {}, np.array(rows), tuple(range(k)))


def _window(walls, ks, rows, seconds):
    calls = [Call(0.0, w, _answer(k, r)) for w, k, r in zip(walls, ks, rows)]
    return Window(calls, seconds)


def test_run_window_closes_after_the_call_under_way():
    now = [0.0]

    def clock():
        return now[0]

    def call(idx):
        now[0] += 0.3
        return _answer(len(idx), [10] * len(idx))

    w = window.run_window(call, lambda j: (j,), 1.0, clock=clock)
    # calls start at 0, 0.3, 0.6, 0.9: the fourth ends at 1.2
    assert len(w.calls) == 4
    assert w.seconds == pytest.approx(1.2)
    assert [c.start for c in w.calls] == pytest.approx([0, 0.3, 0.6, 0.9])


def test_solve_and_iteration_rates_take_the_whole_window():
    w = _window([0.5, 1.5], [1, 3], [[100], [10, 20, 30]], 2.5)
    assert window.solve_seconds(w) == pytest.approx(2.5 / 4)
    assert window.iteration_ms(w) == pytest.approx(2500.0 / 160)


def test_call_p90_is_over_every_call():
    walls = [float(v) for v in range(1, 21)]  # 20 calls
    w = _window(walls, [1] * 20, [[1]] * 20, 210.0)
    # nearest rank: the 18th of 20 sorted walls
    assert window.call_p90_seconds(w) == 18.0
    assert window.percentile([3.0], 90) == 3.0
    assert window.percentile([5.0, 1.0], 50) == 1.0


def test_trace_busy_is_the_union_over_the_span():
    kernels = [("k", 10.0, 30.0), ("k", 20.0, 40.0), ("m", 60.0, 100.0)]
    host = [("cudaLaunchKernel", 0.0, 4.0), ("cudaStreamSynchronize", 40.0,
                                              58.0)]
    t = trace.summarize(kernels, host)
    assert t.window_s == pytest.approx(100e-6)  # first record to last op
    assert t.busy_s == pytest.approx(70e-6)     # 10-40 and 60-100
    assert t.device_ops[0] == ["k", pytest.approx(40e-6)]
    gaps = dict(t.idle_gaps)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(20e-6)
    assert "cudaLaunchKernel" not in gaps       # over by the gap's middle
    assert gaps[trace.HOST_ONLY] == pytest.approx(10e-6)  # 0-10
    assert sum(gaps.values()) == pytest.approx(30e-6)
    assert trace.device_seconds(t, "k") == (pytest.approx(40e-6), 2)


def test_trace_gap_takes_the_runtime_call_at_its_middle():
    kernels = [("k", 0.0, 10.0), ("k", 50.0, 60.0)]
    host = [("cudaMemcpyAsync", 12.0, 40.0), ("cudaGraphLaunch", 45.0, 49.0)]
    t = trace.summarize(kernels, host)
    assert dict(t.idle_gaps) == {"cudaMemcpyAsync": pytest.approx(40e-6)}


def test_trace_window_leaves_out_the_profilers_own_gaps():
    kernels = [("k", 0.0, 10.0), ("k", 30.0, 40.0)]
    host = [("Buffer Flush", 12.0, 28.0)]
    t = trace.summarize(kernels, host)
    assert t.window_s == pytest.approx(20e-6)
    assert t.busy_s == pytest.approx(20e-6)
    assert dict(t.idle_gaps)["Buffer Flush"] == pytest.approx(20e-6)


def test_trace_ignores_the_profilers_step_records():
    kernels = [("k", 10.0, 20.0)]
    host = [("ProfilerStep#7", 0.0, 30.0), ("cudaGraphLaunch", 8.0, 9.0)]
    t = trace.summarize(kernels, host)
    assert t.window_s == pytest.approx(12e-6)   # from the launch at 8
    assert t.busy_s == pytest.approx(10e-6)
    assert dict(t.idle_gaps) == {"cudaGraphLaunch": pytest.approx(2e-6)}


def test_trace_without_device_operations_is_refused():
    with pytest.raises(ValueError):
        trace.summarize([], [("cudaLaunchKernel", 0.0, 1.0)])
