"""The span recorder (``artes_tpu_torch.spans``) and the spans of the host
path, on the CPU.

* Off, ``span()`` and ``job()`` return one shared object and nothing is kept.
* Nesting gives parents; every span of a job carries its job id; self time
  is the duration less the children's.
* A profiler session active at a job's start records that job and none
  before it; the spans are stamped on the profiler's clock.
* The buffer's limit drops and counts; late reads run when the spans are
  read, not inside a job.
* The plain path's ``run_wavelength`` records ``job > tables (> tables.*),
  prepare, chunk (> wait, accumulate)`` and ``finish``; ``--spans``
  adds the self-time line to the CLI's report.

No test here reads a time as a measurement: the clock is replaced where a
duration is checked.
"""

import itertools

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from artes_tpu_torch import cells, cli, presets, runner, spans
from artes_tpu_torch.config import ArtesConfig, detector_setup
from torch_threads import one_thread  # noqa: F401


@pytest.fixture
def ticks(monkeypatch):
    """The recorder's clock as a counter: each read is 10 ns after the last."""
    counter = itertools.count(0, 10)
    monkeypatch.setattr(spans, "_now", lambda: next(counter))


@pytest.fixture(autouse=True)
def empty():
    spans.take()
    yield
    spans.take()


def test_off_returns_one_shared_object_and_keeps_nothing():
    assert spans.span("tables") is spans.OFF
    assert spans.span("chunk", n=3) is spans.OFF
    assert spans.job(wl=0) is spans.OFF
    with spans.job(wl=0) as j:
        with spans.span("tables") as s:
            s.set(rows=4)
        assert s is j is spans.OFF and not j
    assert spans.recorded() == [] and spans.dropped() == 0


def test_nesting_gives_parents_and_one_job_id(ticks):
    with spans.recording() as rec:
        with spans.job(wl=1) as j:
            with spans.span("tables") as t:
                with spans.span("tables.depth"):
                    pass
            with spans.span("chunk", n=5) as c:
                c.set(extra=2)
        with spans.job(wl=2) as k:
            with spans.span("tables") as t2:
                pass
        with spans.span("outside") as o:
            pass
    names = [s.name for s in rec.spans]
    assert names == ["job", "tables", "tables.depth", "chunk", "job", "tables", "outside"]
    by = {s.id: s for s in rec.spans}
    assert t.parent == j.id and c.parent == j.id and j.parent == 0
    assert by[rec.spans[2].parent] is t
    assert {s.job for s in rec.spans[:4]} == {j.job} and j.job > 0
    assert t2.job == k.job != j.job and o.job == 0 and o.parent == 0
    assert c.attrs == {"n": 5, "extra": 2} and j.attrs == {"wl": 1}
    # the outermost recording hands its spans over and empties the buffer
    assert spans.recorded() == []


def test_self_time_is_duration_less_children(ticks):
    with spans.recording() as rec:
        with spans.job() as j:           # start 0
            with spans.span("a"):        # 10 .. 40
                with spans.span("b"):    # 20 .. 30
                    pass
            with spans.span("a"):        # 50 .. 60
                pass
    kids = spans.children(rec.spans)
    assert j.ns == 70
    assert spans.self_ns(j, kids) == 70 - 30 - 10
    assert spans.self_times(rec.spans) == {"job": (pytest.approx(3e-8), 1),
                                           "a": (pytest.approx(3e-8), 2),
                                           "b": (pytest.approx(1e-8), 1)}
    line = spans.self_time_line(rec.spans)
    assert line.startswith("spans (self time, count): ")
    assert "a 0.000000 s x2" in line and "b 0.000000 s x1" in line


def test_recordings_nest():
    with spans.recording() as outer:
        with spans.span("one"):
            pass
        with spans.recording() as inner:
            with spans.span("two"):
                pass
        assert [s.name for s in inner.spans] == ["two"]
        assert [s.name for s in spans.recorded()] == ["one", "two"]
    assert [s.name for s in outer.spans] == ["one", "two"]
    assert spans.recorded() == []


def test_profiler_session_records_the_jobs_inside_it():
    with spans.job(wl=0):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.job(wl=1) as j:
            with spans.span("tables") as s:
                with record_function("inside"):
                    torch.ones(64).sum()
        assert spans.span("between") is spans.OFF      # no job open
    with spans.job(wl=2):
        pass
    kept = spans.take()
    assert [(s.name, s.attrs.get("wl")) for s in kept] == [("job", 1), ("tables", None)]
    assert spans.recorded() == []
    # the profiler's event of the same host work lies inside the span: both
    # on the wall clock in ns (a slack of 1 ms for the profiler's own clock)
    ev = next(e for e in prof.profiler.kineto_results.events() if e.name() == "inside")
    assert s.start - 1_000_000 <= ev.start_ns()
    assert ev.start_ns() + ev.duration_ns() <= s.end + 1_000_000
    assert j.start <= s.start <= s.end <= j.end


def test_full_buffer_drops_and_counts(monkeypatch):
    monkeypatch.setattr(spans, "LIMIT", 3)
    with spans.recording() as rec:
        for _ in range(5):
            with spans.span("x"):
                pass
        assert spans.dropped() == 2
        assert spans.span("y") is spans.OFF
    assert len(rec.spans) == 3 and rec.dropped == 3
    assert spans.dropped() == 0 and spans.recorded() == []


def test_late_reads_run_when_the_spans_are_read():
    """The reads run when the spans are read (``recorded``, the recording's
    end): never inside a job."""
    got = []
    with spans.recording() as rec:
        with spans.job():
            with spans.span("launch") as s:
                spans.later(lambda: s.set(device_ms=1.5))
                spans.later(lambda: got.append(1))
            with spans.span("accumulate"):
                pass
        assert "device_ms" not in s.attrs and got == []       # nothing read in the job
        assert [x.name for x in spans.recorded()] == ["job", "launch", "accumulate"]
        assert s.attrs == {"device_ms": 1.5} and got == [1]
        spans.later(lambda: got.append(2))
    assert got == [1, 2]                   # the recording's end runs them too
    assert [x.name for x in rec.spans] == ["job", "launch", "accumulate"]


def _layer():
    atm = presets.rayleigh_single_layer(tau=5.0)
    cfg = ArtesConfig()
    cfg.mode = "spectrum"
    return atm, cfg, detector_setup(cfg, float(atm.rfront[-1]))


def test_plain_run_wavelength_records_its_tree():
    atm, cfg, det = _layer()
    runner.run_wavelength(atm, cfg, det, 0, 64, device="cpu", dtype=torch.float64)
    assert spans.recorded() == []                       # off outside a recording
    with spans.recording() as rec:
        res = runner.run_wavelength(atm, cfg, det, 0, 300, seed=4, batch_size=128,
                                    device="cpu", dtype=torch.float64)
    assert res.detector[..., 0, 2].sum() > 0
    by = {s.id: s for s in rec.spans}

    def path(s):
        return path(by[s.parent]) + [s.name] if s.parent else [s.name]

    assert [" > ".join(path(s)) for s in rec.spans] == [
        "job", "job > tables", "job > tables > tables.geometry", "job > tables > tables.depth",
        "job > tables > tables.cells", "job > tables > tables.jumps", "job > prepare",
        "job > chunk", "job > chunk > wait", "job > chunk > accumulate", "job > finish"]
    job = rec.spans[0]
    assert job.attrs == {"wl": 0, "packages": 300, "view_deg": 90.0, "crescent": False,
                         "path": "plain", "launches": 0}
    assert rec.spans[7].attrs == {"n": 300, "id_hi": 0, "id_lo": 0}
    assert {s.job for s in rec.spans} == {job.job}
    assert all(job.start <= s.start <= s.end <= job.end for s in rec.spans)


def test_cli_spans_line(tmp_path):
    cells.write_input(tmp_path)
    assert cli.main(["demo", "512", "-o", "r", "--f64", "--device", "cpu", "--spans",
                     "--root", str(tmp_path), "-k", "general:log=on"]) == 0
    lines = (tmp_path / "output" / "r" / "output.log").read_text().splitlines()
    line = next(x for x in lines if x.startswith("spans (self time, count): "))
    counts = {part.split()[0]: part.split()[-1] for part in line.split(": ", 1)[1].split(", ")}
    assert counts["job"] == counts["tables"] == counts["chunk"] == counts["finish"] == "x1"
    assert spans.recorded() == []
