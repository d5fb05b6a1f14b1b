"""The benchmark's phase-curve cell, ``hg_deck_phase_curve``: BASELINE #2's
cloud deck as ``portbench/configs/hg_cloud_deck.json`` against the port's
preset, its cloud file against its generator, its 73 views against
``runner.run_phase_curve``'s, the frozen reference against the port's plain
version at three of them, the job span's view and the drain reader.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_hg_phase_cell.py -q
"""

import json

import numpy as np
import pytest
import torch

from artes_tpu_torch import presets, runner, spans
from artes_tpu_torch.atmosphere import Atmosphere
from artes_tpu_torch.config import ArtesConfig, detector_setup
from portbench import check, hg_table, inputs, run
from torch_threads import one_thread  # noqa: F401

CELL = "hg_deck_phase_curve"


@pytest.fixture(scope="module")
def cell():
    return run.Cell.load(CELL)


def _port(cell):
    atm = Atmosphere(**inputs.atmosphere_arrays(cell.config))
    return atm, inputs.run_config(ArtesConfig, cell.config, cell.traffic)


def test_configuration_is_baseline2_deck(cell):
    """The configuration's arrays are ``presets.hg_cloud_deck(tau=6.0, g=0.6,
    p_linear=0.4)``'s: the matrix bit for bit, the opacities but for the
    rounding of the two routes (the density aside: the tables read none)."""
    got = inputs.atmosphere_arrays(cell.config)
    want = presets.hg_cloud_deck(tau=6.0, g=0.6, p_linear=0.4)
    for key in ("rfront", "thetafront", "phifront", "wavelengths", "temperature"):
        np.testing.assert_array_equal(got[key], getattr(want, key), err_msg=key)
    np.testing.assert_array_equal(got["scatter"], want.scatter)
    for key in ("k_sca", "k_abs"):
        np.testing.assert_allclose(got[key], getattr(want, key), rtol=1e-12, atol=0,
                                   err_msg=key)
    assert got["k_abs"].min() > 0 and cell.config["reduced"] == []


def test_cloud_file_is_its_generator():
    with open(hg_table.PATH) as fh:
        assert json.load(fh) == hg_table.table()


def test_views_are_run_phase_curve(cell, monkeypatch):
    """Each of the cycle's 73 jobs has the angle, detector phi and crescent
    that ``runner.run_phase_curve`` gives that angle."""
    atm, cfg = _port(cell)
    calls = []

    def record(atm_, cfg_, det, wl, n, seed=0, crescent=False, **kw):
        calls.append((wl, det, crescent))

    monkeypatch.setattr(runner, "run_wavelength", record)
    rows = runner.run_phase_curve(atm, cfg, 8)
    views = cell.views()
    assert len(views) == len(rows) == len(calls) == 73
    assert sum(c for _, _, c in calls) == 5
    for (wl, phase), (ang, _, _), (wl_, det_, cres_) in zip(views, rows, calls):
        det, crescent = inputs.detector_of(detector_setup, cfg, float(atm.rfront[-1]), phase)
        assert (wl, phase) == (wl_, ang)
        assert (det, crescent) == (det_, cres_)


# (phase angle, photons): at 177.5 degrees (the crescent) 3 photons in 100
# book a peel
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("phase,photons", [(1.0e-5, 192), (97.5, 192), (177.5, 1024)])
def test_reference_equals_port_plain(cell, phase, photons, dtype):
    """On the same photons at a view of the cycle, the frozen reference's
    energy-scaled detector is the port's plain ``run_wavelength``'s on the
    CPU: counts bit-equal, sums equal but for the order of their float64
    additions."""
    atm, cfg = _port(cell)
    det, crescent = inputs.detector_of(detector_setup, cfg, float(atm.rfront[-1]), phase)
    seed = 2718281828
    port = runner.run_wavelength(atm, cfg, det, 0, photons, seed=seed, dtype=dtype,
                                 device="cpu", crescent=crescent)
    ref, counts = check.reference_detector(cell.config, cell.traffic, 0, photons, seed, "cpu",
                                           dtype=dtype, phase_deg=phase)
    assert port.detector[..., 2].sum() > 0
    assert counts == {k: getattr(port, k) for k in check.ABANDONED}
    np.testing.assert_array_equal(port.detector[..., 2], ref[..., 2])
    np.testing.assert_allclose(port.detector[..., :2], ref[..., :2], rtol=1e-12, atol=0)
    assert check.photometry_gap(port.detector, port.photometry) == 0.0


def test_job_span_carries_its_view(cell):
    """A recorded job says which view it is; the plain path launches no pool
    kernel, so no ``launch`` span carries a drain."""
    atm, cfg = _port(cell)
    with spans.recording() as rec:
        for phase in (97.5, 177.5):
            det, crescent = inputs.detector_of(detector_setup, cfg, float(atm.rfront[-1]),
                                               phase)
            runner.run_wavelength(atm, cfg, det, 0, 16, device="cpu", crescent=crescent)
    jobs = [s.attrs for s in rec.spans if s.name == "job"]
    assert [(j["view_deg"], j["crescent"], j["path"]) for j in jobs] == [
        (pytest.approx(97.5), False, "plain"), (pytest.approx(177.5), True, "plain")]
    assert not any("drain_ms" in s.attrs for s in rec.spans if s.name == "launch")


def _launch(job, source, **attrs):
    s = spans.Span("launch", dict(source=source, **attrs), job)
    s.start, s.end = 0, 1
    return s


@pytest.mark.parametrize("launches,want", [
    ([("pool_radial", {"device_ms": 50.0, "drain_ms": 2.0}),
      ("pool_radial", {"device_ms": 30.0, "drain_ms": 2.0}),
      ("pool_grid3d", {"device_ms": 99.0})], 5.0),
    ([("pool_radial", {"device_ms": 50.0, "drain_ms": 2.0}),
      ("pool_radial", {"device_ms": 30.0})], None),
    ([("pool_grid3d", {"device_ms": 99.0})], None),
], ids=["two_radial_launches", "a_launch_without_drain", "no_radial_launch"])
def test_drain_reader(cell, monkeypatch, launches, want):
    """``pool_radial_drain_pct``: 100 x the window's radial drains over their
    device time; nothing where a radial launch lacks its drain (a program
    without the stamps) or there is none."""
    job = spans.Span("job", {}, 1)
    job.start, job.end = 0, 2
    monkeypatch.setattr(spans, "_spans", [job] + [_launch(1, src, **a) for src, a in launches])
    monkeypatch.setattr(spans, "_dropped", 0)
    traced = run.Run(cell=cell, jobs=[{}], setup_s=1.0, window_s=1.0, trace=object())
    got = run.read_metric("pool_radial_drain_pct", traced)
    assert got == (None if want is None else pytest.approx(want))
