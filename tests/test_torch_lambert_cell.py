"""The benchmark's Lambert-surface cell, ``lambert_surface_spectrum``: the
Rayleigh layer over a white Lambert surface as
``portbench/configs/lambert_layer.json`` against the port's preset, the
marching kernel it takes, the frozen reference's march and Lambert branches
against the port's plain version, the output check on a sound run and its
faults, and the two readers of ``pool_march``'s counters.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_lambert_cell.py -q
"""

import numpy as np
import pytest
import torch

from artes_tpu_torch import presets, runner, spans
from artes_tpu_torch.atmosphere import Atmosphere
from artes_tpu_torch.config import ArtesConfig, detector_setup
from artes_tpu_torch.transport import pool_cuda
from artes_tpu_torch.transport.tables import build_tables
from portbench import check, control, costmodel, inputs, program_spans, run
from portbench.reference import config as rcfg
from portbench.reference.kernel import walk_mode
from portbench.trace import DeviceTrace
from torch_threads import one_thread  # noqa: F401

CELL = "lambert_surface_spectrum"
WAVELENGTHS = (0.5, 0.55, 0.6, 0.65, 0.7, 0.75)
SEED = 2718281828


@pytest.fixture(scope="module")
def cell():
    return run.Cell.load(CELL)


def _port(cell):
    atm = Atmosphere(**inputs.atmosphere_arrays(cell.config))
    cfg = inputs.run_config(ArtesConfig, cell.config, cell.traffic)
    det, _ = inputs.detector_of(detector_setup, cfg, float(atm.rfront[-1]), None)
    return atm, cfg, det


def test_configuration_is_the_lambert_layer(cell):
    """The configuration's arrays are ``presets.rayleigh_single_layer(tau=0.5,
    nr=2)``'s at the six wavelengths; both sides' run configurations put a
    white Lambert surface under it; nothing is cut."""
    got = inputs.atmosphere_arrays(cell.config)
    want = presets.rayleigh_single_layer(tau=0.5, nr=2, wavelengths=WAVELENGTHS)
    for key in ("rfront", "thetafront", "phifront", "wavelengths", "temperature", "scatter",
                "k_abs"):
        np.testing.assert_array_equal(got[key], getattr(want, key), err_msg=key)
    np.testing.assert_allclose(got["k_sca"], want.k_sca, rtol=1e-12, atol=0)
    for make in (ArtesConfig, rcfg.ArtesConfig):
        cfg = inputs.run_config(make, cell.config, cell.traffic)
        assert cfg.surface_albedo == 1.0 and cfg.mode == "spectrum"
    assert cell.config["reduced"] == [] and cell.traffic["photons_per_job"] == 1 << 26
    assert [wl for wl, _ in cell.views()] == list(range(6))


@pytest.mark.parametrize("wl", range(6))
def test_every_job_takes_pool_march(cell, wl):
    """Each job's float32 tables take the marching walk: on a card
    ``run_wavelength`` launches ``pool_march``'s stellar spectrum, and the
    reference marches too."""
    atm, cfg, det = _port(cell)
    prep = build_tables(atm, cfg, det, wl, dtype=torch.float32, device="cpu")
    static = runner._kernel_static(cfg, det, atm, False)
    assert pool_cuda.supports(prep.tables, static)
    assert pool_cuda.kernel_of(prep.tables, static) == ("pool_march", "march_stellar")
    _, _, _, ref, ref_static, _ = check.reference_setup(cell.config, cell.traffic, wl, "cpu")
    assert walk_mode(ref.tables, ref_static) == "march"


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("wl", [0, 5])
def test_reference_equals_port_plain(cell, wl, dtype):
    """On the same photons the frozen reference's march, Lambert reflection
    and surface peel give the port's plain ``run_wavelength`` detector on the
    CPU: counts bit-equal, sums equal but for the order of their float64
    additions, the abandoned photons alike, the photometry the reference's
    arithmetic."""
    atm, cfg, det = _port(cell)
    photons = 384
    port = runner.run_wavelength(atm, cfg, det, wl, photons, seed=SEED, dtype=dtype,
                                 device="cpu")
    ref, counts = check.reference_detector(cell.config, cell.traffic, wl, photons, SEED, "cpu",
                                           dtype=dtype)
    assert port.detector[..., 2].sum() > photons
    assert counts == {k: getattr(port, k) for k in check.ABANDONED}
    np.testing.assert_array_equal(port.detector[..., 2], ref[..., 2])
    np.testing.assert_allclose(port.detector[..., :2], ref[..., :2], rtol=1e-12, atol=0)
    assert check.photometry_gap(port.detector, port.photometry) == 0.0


def _checked(cell, fault):
    with control.planted(fault, cell, "cpu"):
        res = run.run_cell(cell, SEED, 0.0, False, device="cpu", photons=8192, jobs_only=1,
                           log=lambda m: None)
    return res["correct"], {k: v["value"] for k, v in res["checks"].items()}


def test_sound_run_is_exact(cell):
    """Where the check replays every photon of the job, the sound program
    and the reference follow the same photons: no gap at all."""
    correct, numbers = _checked(cell, "none")
    assert correct and numbers == {"tally_z": 0.0, "peels_gap": 0.0, "photometry_gap": 0.0}


@pytest.mark.parametrize("fault", ["control", "unchanged", "half", "altered"])
def test_faults_are_refused(cell, fault):
    """The control (the reference in bfloat16) and the program's faults
    are refused on 8192 photons, every one replayed."""
    correct, numbers = _checked(cell, fault)
    assert not correct, numbers


@pytest.mark.parametrize("fault", ["capped", "draws"])
def test_faults_not_refused(cell, fault):
    """Two faults this cell does not refuse. ``capped`` (the scattering cap
    cut from 256 to 16): at tau <= 0.5 over a white surface few photons
    reach 16 scattering orders, so the photons it abandons lie within the
    counts' Poisson error. ``draws`` (only the reference's uniform draws
    rounded to bfloat16): a photon's draws move by a bfloat16 rounding, so
    few of 8192 photons take another path and every flux moves by less than
    its Monte Carlo error."""
    correct, numbers = _checked(cell, fault)
    assert correct and numbers["tally_z"] > 0.0, numbers


# a traced window of two jobs, by hand: each job's launch spans (pool_march's
# counts), the trace's pool_march kernels (1 ms each), and the job's Q-row count
JOBS = [(0, 1 << 20, 2_000_000, [5_000_000]), (1, 1 << 20, 1_500_000, [3_000_000, 1_000_000])]
LANES = [dict(refill_passes=100, refill_lanes=1600, round_passes=300, round_lanes=8000),
         dict(refill_passes=50, refill_lanes=400, round_passes=150, round_lanes=4000),
         dict(refill_passes=10, refill_lanes=80, round_passes=40, round_lanes=1000)]


def _traced(cell, monkeypatch, face_of=lambda k, n: n):
    recorded, jobs, k = [], [], 0
    for i, (wl, packages, rounds, faces) in enumerate(JOBS):
        job = spans.Span("job", {"wl": wl, "packages": packages}, 10 + i)
        job.start, job.end = 1000 * i, 1000 * i + 900
        recorded.append(job)
        for n in faces:
            attrs = dict(source="pool_march", **LANES[k])
            if face_of(k, n) is not None:
                attrs["cell_face"] = face_of(k, n)
            launch = spans.Span("launch", attrs, job.job)
            launch.start, launch.end, launch.parent = job.start + 1, job.end - 1, job.id
            recorded.append(launch)
            k += 1
        det = np.zeros((1, 1, 4, 3))
        det[..., 1, 2] = rounds
        jobs.append({"wl": wl, "packages": packages, "detector": det})
    monkeypatch.setattr(spans, "_spans", recorded)
    monkeypatch.setattr(spans, "_dropped", 0)
    trace = DeviceTrace()
    trace.intervals = [(1_000_000 * k, 1_000_000 * k + 1_000_000,
                        "void (anonymous namespace)::pool_march_kernel<false, false, false>()")
                       for k in range(3)]
    return run.Run(cell=cell, jobs=jobs, setup_s=1.0, window_s=1.0, trace=trace)


def test_pool_march_readers_by_hand(cell, monkeypatch):
    """``pool_march_roofline``: each job's float32 operations (40 an emitted
    photon, 787 a round, 48 a ``cell_face`` pass on a radial grid: two roots
    and the selection) over 67 TFLOP/s against its bytes over 3.35 TB/s,
    summed, over the trace's 3 ms of ``pool_march`` kernels.
    ``pool_march_lane_pct``: the lanes over 32 a pass, both branches."""
    traced = _traced(cell, monkeypatch)
    want = 0.0
    for wl, packages, rounds, faces in JOBS:
        ops = 40 * packages + 787 * rounds + 48 * sum(faces)
        n_bytes = costmodel.launch_shape(cell.config, cell.traffic, wl)["tables_nbytes"] + 160
        want += max(ops / 67e12, n_bytes / 3.35e12)
    assert run.read_metric("pool_march_roofline", traced) == pytest.approx(100 * want / 3e-3)
    lanes = sum(a["refill_lanes"] + a["round_lanes"] for a in LANES)
    passes = sum(a["refill_passes"] + a["round_passes"] for a in LANES)
    assert run.read_metric("pool_march_lane_pct", traced) == pytest.approx(
        100 * lanes / (32 * passes))
    assert program_spans.lane_parts(traced, "pool_march")["refill"] == pytest.approx(
        100 * 2080 / (32 * 160))
    assert run.read_metric("pool_grid3d_lane_pct", traced) is None


def test_pool_march_roofline_needs_every_count(cell, monkeypatch):
    """A launch without ``cell_face`` (a program that does not report it), a
    trace without the kernel, or a window whose jobs the spans do not match
    gives no roofline."""
    traced = _traced(cell, monkeypatch, face_of=lambda k, n: None if k == 2 else n)
    assert run.read_metric("pool_march_roofline", traced) is None
    traced = _traced(cell, monkeypatch)
    traced.jobs = traced.jobs[:1]
    assert run.read_metric("pool_march_roofline", traced) is None
    traced = _traced(cell, monkeypatch)
    traced.trace.intervals = [(0, 1000, "void pool_radial_kernel<false>")]
    assert run.read_metric("pool_march_roofline", traced) is None
    traced.trace = None
    assert run.read_metric("pool_march_lane_pct", traced) is None
