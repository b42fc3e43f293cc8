"""The harness's metric arithmetic: percentiles and per-picture readings
on known samples, the launch bound, and the reduction of a trace."""
import numpy as np
import pytest

from conftest import ROOT

from avcbench import work
from avcbench.peaks import PEAKS
from avcbench.run import Run, read_metric
from avcbench.timing import percentile
from avcbench.trace import (REQUEST, STAGE, WINDOW_END, WINDOW_START,
                            TraceSummary, summarize)

H100 = PEAKS["NVIDIA H100 80GB HBM3"]


def test_peaks():
    assert H100["int32_ops_per_s"] == pytest.approx(16.727e12, rel=1e-4)
    assert H100["hbm_bytes_per_s"] == 3.35e12


def test_launch_bound_takes_the_larger():
    assert work.launch_bound_s(3.35e12, 0, H100) == 1.0
    ops = H100["int32_ops_per_s"]
    assert work.launch_bound_s(3.35e9, ops, H100) == 1.0


def test_percentile_known_samples():
    v = list(range(1, 11))
    assert percentile(v, 90) == pytest.approx(9.1)
    assert percentile(v, 50) == 5.5
    assert percentile([3.0], 90) == 3.0
    assert percentile(v, 90) == pytest.approx(float(np.percentile(v, 90)))


def run_of(**kw):
    r = Run()
    for k, v in kw.items():
        setattr(r, k, v)
    return r


def test_per_frame_readers():
    r = run_of(frames=40, window_s=2.0, cpu_s=1.2, latencies_s=[0.1] * 9
               + [0.3], stage_s={"parse": 0.08, "entropy": 0.4},
               untimed_s=0.04, mem_peak_bytes=3 * 2 ** 20, setup_s=7.5,
               pool_mib={"cuda:0": 12.0})
    got = {m: read_metric(ROOT, m, r) for m in (
        "frames_per_s", "host_cpu_ms_per_frame", "clip_latency_p90_ms",
        "parse_ms_per_frame", "entropy_ms_per_frame", "motion_ms_per_frame",
        "untimed_ms_per_frame", "device_mem_peak_mib", "setup_s",
        "graph_pool_mib", "device_idle_pct", "b2_roofline")}
    assert got["frames_per_s"] == 20.0
    assert got["host_cpu_ms_per_frame"] == pytest.approx(30.0)
    assert got["clip_latency_p90_ms"] == pytest.approx(120.0)
    assert got["parse_ms_per_frame"] == pytest.approx(2.0)
    assert got["entropy_ms_per_frame"] == pytest.approx(10.0)
    assert got["untimed_ms_per_frame"] == pytest.approx(1.0)
    assert got["device_mem_peak_mib"] == 3.0 and got["setup_s"] == 7.5
    assert got["graph_pool_mib"] == 12.0
    for absent in ("motion_ms_per_frame", "device_idle_pct",
                   "b2_roofline"):
        assert got[absent] is None


def test_roofline_reader():
    k = "(anonymous namespace)::intra_rows_kernel(unsigned char const*)"
    t = TraceSummary(10.0, 1.0, {k: 0.002, "intra_rows_kernel_b(int)": 1.0},
                     {k: 2, "intra_rows_kernel_b(int)": 5})
    r = run_of(trace=t, peak=H100,
               launches={"b2": [(3.35e12 * 0.5e-3, 0)] * 2})
    assert read_metric(ROOT, "b2_roofline", r) == pytest.approx(50.0)
    r.launches = {"b2": [(1.0, 1)] * 3}       # launches differ: nothing
    assert read_metric(ROOT, "b2_roofline", r) is None
    r.peak = None
    assert read_metric(ROOT, "b2_roofline", r) is None


def test_trace_summary_busy_and_idle_by_stage():
    ms = 1_000_000
    ev = [(WINDOW_START, False, 0, 0), (WINDOW_END, False, 100 * ms,
                                        100 * ms),
          (WINDOW_END, False, 90 * ms, 90 * ms),
          (REQUEST, False, 0, 95 * ms),
          (STAGE + "entropy", False, 0, 40 * ms),
          (STAGE + "dispatch", False, 40 * ms, 50 * ms),
          ("k1(int)", True, 45 * ms, 55 * ms),
          ("k2(int)", True, 50 * ms, 60 * ms),
          ("k1(int)", True, 98 * ms, 105 * ms), ("early", True, -5 * ms, -1)]
    s = summarize(ev)
    assert s.window_s == pytest.approx(0.1)
    assert s.busy_s == pytest.approx(0.017)
    assert s.op_s == pytest.approx({"k1(int)": 0.012, "k2(int)": 0.010})
    assert s.launches == {"k1(int)": 2, "k2(int)": 1}
    assert s.idle_s == pytest.approx({"entropy": 0.040, "dispatch": 0.005,
                                      "untimed": 0.035,
                                      "between requests": 0.003})
    assert sum(s.idle_s.values()) + s.busy_s == pytest.approx(s.window_s)
    assert s.kernel("k1") == (pytest.approx(0.012), 2)
    b = s.breakdown()
    assert b["device_ops"][0] == ["k1(int)", pytest.approx(0.012)]
    assert b["idle_gaps"][0] == ["entropy", pytest.approx(0.040)]


def test_trace_needs_its_window():
    with pytest.raises(ValueError):
        summarize([("k", True, 0, 5)])
