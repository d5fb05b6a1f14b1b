"""The readers of the program's spans on fixed spans and device intervals:
each metric's hand-computed value, an idle gap split between two leaf spans,
a job's own time and no span, and no value where there is nothing to read."""

import sys

import pytest

from artes_tpu_torch import spans
from portbench import program_spans, run, spanlook
from portbench.trace import DeviceTrace

# (name, start, end, parent index or None, attrs) in ns; two jobs in a window
# of 100 us
JOB1, JOB2 = 0, 12
SPANS = [
    ("job", 0, 49_000, None, {}),                                   # 0
    ("tables", 1_000, 11_000, 0, {}),                               # 1
    ("tables.geometry", 1_000, 4_000, 1, {}),
    ("tables.depth", 4_000, 9_000, 1, {}),
    ("tables.cells", 9_000, 11_000, 1, {}),
    ("chunk", 11_000, 45_000, 0, {"n": 8}),                         # 5
    ("launch", 11_000, 20_000, 5, {"source": "pool_radial", "device_ms": 0.022,
                                   "refill_passes": 10, "refill_lanes": 40,
                                   "round_passes": 30, "round_lanes": 600}),
    ("wait", 15_000, 19_000, 6, {}),
    ("wait", 20_000, 40_000, 5, {}),
    ("accumulate", 40_000, 45_000, 5, {}),
    ("finish", 45_000, 48_000, 0, {}),                              # 10
    ("unused", 0, 0, None, {}),
    ("job", 50_000, 100_000, None, {}),                             # 12
    ("tables", 50_000, 56_000, 12, {}),
    ("tables.cells", 50_000, 56_000, 13, {}),
    ("chunk", 56_000, 90_000, 12, {"n": 8}),                        # 15
    ("launch", 56_000, 60_000, 15, {"source": "pool_radial", "device_ms": 0.023,
                                    "refill_passes": 5, "refill_lanes": 20,
                                    "round_passes": 10, "round_lanes": 300}),
    ("wait", 60_000, 85_000, 15, {}),
    ("accumulate", 85_000, 90_000, 15, {}),
    ("finish", 90_000, 99_000, 12, {}),
]
# an upload, the first kernel, a copy back, the second kernel
INTERVALS = [(10_000, 11_000, "Memcpy HtoD"), (16_000, 38_000, "void pool_radial_kernel<false>"),
             (40_500, 41_000, "Memcpy DtoH"), (61_000, 84_000, "void pool_radial_kernel<false>")]
WINDOW_S = 1e-4


def _spans():
    out = []
    for i, (name, start, end, parent, attrs) in enumerate(SPANS):
        if name == "unused":
            out.append(None)
            continue
        s = spans.Span(name, dict(attrs))
        s.start, s.end = start, end
        s.parent = out[parent].id if parent is not None else 0
        s.job = out[parent].job if parent is not None else i + 1
        out.append(s)
    return [s for s in out if s is not None]


@pytest.fixture
def traced(monkeypatch):
    """A traced run whose program recorded :data:`SPANS`."""
    monkeypatch.setattr(spans, "_spans", _spans())
    trace = DeviceTrace()
    trace.intervals = list(INTERVALS)
    cell = run.Cell.load("rayleigh_spectrum")
    return run.Run(cell=cell, jobs=[{}, {}], setup_s=1.0, window_s=WINDOW_S, trace=trace)


def test_host_metrics_by_hand(traced):
    # tables 10 and 6 us; launch 9 - 4 us of wait, and 4 us; accumulate and
    # finish 5 + 3 and 5 + 9 us
    assert run.read_metric("tables_ms_per_job", traced) == pytest.approx(0.008)
    assert run.read_metric("wrapper_ms_per_job", traced) == pytest.approx(0.0045)
    assert run.read_metric("accumulate_ms_per_job", traced) == pytest.approx(0.011)
    assert run.read_metric("tables_ms_per_job.short", traced) == pytest.approx(0.008)


def test_idle_unexplained_by_hand(traced):
    # busy 46.5 us of 100; idle in no leaf: 1 before the tables, 1 while the
    # launch waits before its kernel, 2 while the runner waits after it, 2
    # between the jobs (1 of job 1's own time, 1 in no span), 1, 1 and 1
    # around the second kernel and at the end
    assert run.read_metric("device_idle_pct", traced) == pytest.approx(53.5)
    assert run.read_metric("idle_unexplained_pct", traced) == pytest.approx(9.0)
    assert run.read_metric("idle_unexplained_pct.short", traced) == pytest.approx(9.0)


def test_lane_metrics_by_hand(traced):
    assert run.read_metric("pool_radial_lane_pct", traced) == pytest.approx(
        100 * 960 / (32 * 55))
    assert program_spans.lane_parts(traced, "pool_radial") == {
        "refill": pytest.approx(12.5), "round": pytest.approx(100 * 900 / (32 * 40)),
        "both": pytest.approx(100 * 960 / (32 * 55))}
    assert run.read_metric("pool_grid3d_lane_pct", traced) is None


def test_gap_split_and_alignment(traced):
    recorded = spans.recorded()
    busy = program_spans.merged((s, e) for s, e, _ in INTERVALS)
    total, gaps = spanlook.idle_split(recorded, busy, 0, 100_000)
    # the longest gap, 41-61 us: the first job's sums and end, its own time,
    # no span, the second job's tables and launch, and its runner's wait
    assert gaps[0] == [0.02, {"accumulate": 0.004, "finish": 0.003, "job": 0.001,
                              "none": 0.001, "tables.cells": 0.006, "launch": 0.004,
                              "wait": 0.001}]
    assert sum(total.values()) == pytest.approx(0.0535)
    assert total["launch.wait"] == pytest.approx(0.001)
    got = spanlook.alignment(recorded, INTERVALS, 0)
    assert got["kernels"] == got["launches"] == 2 and got["aligned_pct"] == 100.0
    assert got["device_ms_ratio"] == [pytest.approx(1.0)] * 3
    # a kernel that ends after its chunk's wait is not aligned
    late = [INTERVALS[0], (16_000, 41_000, "void pool_radial_kernel<false>")] + INTERVALS[2:]
    assert spanlook.alignment(recorded, late, 0)["aligned_pct"] == 50.0


def test_lost_kernel_record(traced):
    # the trace lost the second kernel's record: its time would read as idle
    traced.trace.intervals = INTERVALS[:3]
    assert run.read_metric("idle_unexplained_pct", traced) is None
    assert run.read_metric("wrapper_ms_per_job", traced) == pytest.approx(0.0045)


def test_nothing_to_read(traced, monkeypatch):
    traced.trace = None
    assert run.read_metric("tables_ms_per_job", traced) is None
    traced.trace = DeviceTrace()
    monkeypatch.setattr(spans, "_dropped", 1)
    assert run.read_metric("idle_unexplained_pct", traced) is None
    monkeypatch.setattr(spans, "_dropped", 0)
    monkeypatch.setattr(spans, "_spans", [])
    assert run.read_metric("wrapper_ms_per_job", traced) is None
    # a checkout whose program has no recorder
    monkeypatch.setitem(sys.modules, "artes_tpu_torch.spans", None)
    assert run.read_metric("pool_radial_lane_pct", traced) is None
