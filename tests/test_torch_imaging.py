"""Multi-pixel imaging, crescent sampling, the off-axis star and the phase
curve of the port against the JAX package.

* float64: the plain version against JAX ``run_stream`` on a 5x5 image of
  the flagship, the crescent with an off-axis star
  (tests/test_pallas_stream.py:433-446) and a 5x5 thermal image; counts
  equal per pixel and count column, moments at rtol 1e-10
  (``test_torch_pool.assert_matches_jax``). A per-pixel comparison sees a
  transposed or shifted image, which sums over the pixels cannot.
* float32: per-pixel statistical check on the 5x5 image.
* Image = spectrum: the image summed over its pixels is the single-pixel
  spectrum tally of the same photons.
* The thin Rayleigh shell's single-scattering phase curve holds.
* The CLI's ``stokes.fits``, ``error.fits``, ``photometry.dat``
  (imaging_mono), summed ``stokes.fits`` (imaging_broad) and all 73 rows of
  ``phase.dat`` equal the ``artes_tpu`` CLI's at float64.
"""

import os

import numpy as np
import pytest
import torch
from test_torch_pool import SEED, assert_matches_jax, setup
from torch_threads import one_thread  # noqa: F401

from artes_tpu import cli as jax_cli
from artes_tpu import presets
from artes_tpu.config import ArtesConfig, detector_setup
from artes_tpu.io.fitsio import read_fits
from artes_tpu.transport import kernel as JK
from artes_tpu_torch import cells, cli, runner
from artes_tpu_torch.transport import kernel as TK


def test_image_matches_jax_f64():
    jt, static, tt, st = setup("flagship", "float64", mode="imaging_mono", npix=5)
    got = assert_matches_jax(jt, static, tt, st, 1024)
    det = got["detector"].numpy()
    lit = det[:, 0, 2] > 0
    # the half-lit disk at 90 deg phase: some pixels dark, the image not
    # symmetric under a transpose
    assert 0 < lit.sum() < 25
    img = det[:, 0, 0].reshape(5, 5)
    assert not np.allclose(img, img.T)


def test_crescent_offaxis_matches_jax_f64():
    jt, static, tt, st = setup(presets.rayleigh_single_layer(tau=1.0, nr=2), "float64",
                               crescent=True, stellar_direction=True, theta_star=1.2,
                               phi_star=0.4)
    assert static.crescent and static.stellar_direction
    assert_matches_jax(jt, static, tt, st, 2048)


def test_thermal_image_matches_jax_f64():
    jt, static, tt, st = setup(cells.thermal_scattering_shell(), "float64",
                               photon_source="planet", mode="imaging_mono", npix=5)
    # 512 photons: none bisects the azimuth in jitted XLA (the replay is
    # exercised by the spectrum of this shell in test_torch_thermal.py)
    got = assert_matches_jax(jt, static, tt, st, 512)
    det = got["detector"].numpy()
    assert (det[:, 0, 2] >= det[:, 1, 2]).all() and det[:, 0, 2].sum() > det[:, 1, 2].sum()


# about 3x the gaps measured on the CPU at 2^14 photons, seed 7, on the 5x5
# flagship image: sum_p |dN_p| / N 9.0e-5, sum_p |dI_p| / I 1.7e-4
F32_PIXEL_LIMITS = {"N": 3e-4, "I": 5e-4}


def test_image_f32_per_pixel():
    jt, static, tt, st = setup("flagship", "float32", mode="imaging_mono", npix=5)
    n = 1 << 14
    r = np.asarray(JK.run_stream(jt, static, n, SEED, 4096)["detector"], np.float64)
    g = TK.run_stream(tt, st, n, SEED, n)["detector"].numpy()
    gaps = {"N": np.abs(g[:, 0, 2] - r[:, 0, 2]).sum() / r[:, 0, 2].sum(),
            "I": np.abs(g[:, 0, 0] - r[:, 0, 0]).sum() / r[:, 0, 0].sum()}
    assert all(gaps[k] <= F32_PIXEL_LIMITS[k] for k in gaps), gaps
    assert np.isfinite(g).all()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_image_sums_to_spectrum(dtype):
    """Every peel lands inside the image square (x_max = 1.3 outer radii),
    so the 25x25 image summed over its pixels holds the spectrum's counts
    exactly and its sums up to the order of addition."""
    n = 4096
    image = TK.run_stream(*cells.imaging_tables(25, "cpu", dtype), n, SEED, n)["detector"]
    spec = TK.run_stream(*cells.spectrum_tables(cells.flagship(), "cpu", dtype), n, SEED,
                         n)["detector"]
    total = image.sum(0, keepdim=True)
    assert torch.equal(total[..., 2], spec[..., 2])
    torch.testing.assert_close(total[..., :2], spec[..., :2], rtol=1e-9, atol=0.0)


@pytest.mark.parametrize("phase_deg", [1.0e-5, 60.0, 90.0, 160.0])
def test_thin_shell_phase_oracle(phase_deg):
    """Single Rayleigh scattering in a thin shell at phase angle alpha:
    I / (norm pi) = (4/3) k P11(180 - alpha) within 5%, and -Q/I its degree
    of polarization within 0.05 (the detector's Q sign makes -Q/I > 0)."""
    atm = cells.thin_rayleigh_shell()
    cfg = ArtesConfig()
    cfg.mode = "phase"
    det = detector_setup(cfg, float(atm.rfront[-1]), det_phi=np.radians(phase_deg))
    res = runner.run_wavelength(atm, cfg, det, 0, 1 << 15, seed=3, device="cpu")
    p = res.photometry
    intensity, pol = cells.thin_shell_phase_oracle(atm, phase_deg)
    assert p[0] / (cells.stellar_norm(cfg, atm) * np.pi) == pytest.approx(intensity, rel=0.05)
    assert -p[2] / p[0] == pytest.approx(pol, abs=0.05)


def _fits(path):
    return read_fits(path)[0][1]


def _assert_close_to_noise(got, ref, atol):
    """Equal at rtol 1e-10 where the values mean something; ``atol`` covers
    values that are rounding noise (Rayleigh's V, about 1e-26 of I; the
    spread m2 - m1^2 of a pixel whose few peels are nearly equal), which
    depend on the order of addition, and the two packages add in different
    orders."""
    np.testing.assert_array_less(np.abs(got - ref), 1e-10 * np.abs(ref) + atol + 1e-300)


def _run_both(root, name, n, *args):
    common = [name, str(n), "--f64", "--root", str(root), *args]
    assert jax_cli.main([*common, "-o", "ref"]) == 0
    assert cli.main([*common, "-o", "got", "--device", "cpu"]) == 0
    ref, got = root / "output" / "ref" / "output", root / "output" / "got" / "output"
    assert sorted(os.listdir(got)) == sorted(os.listdir(ref))
    return got, ref


def test_cli_imaging_mono_matches_jax_f64(tmp_path):
    cells.write_input(tmp_path)
    got, ref = _run_both(tmp_path, "demo", 2048, "-k", "detector:type=imaging_mono")
    g, r = _fits(got / "stokes.fits"), _fits(ref / "stokes.fits")
    assert g.shape == r.shape == (4, 25, 25)
    np.testing.assert_allclose(g, r, rtol=1e-10, atol=0.0)
    g, r = _fits(got / "error.fits"), _fits(ref / "error.fits")
    assert g.shape == r.shape == (5, 25, 25)
    # per plane: the noise floor of an error is sqrt(eps) ~ 1e-8 of the
    # plane's largest error, so 1e-10 of it cannot be met; 1e-4 of it is
    # still far below what a moved or missing peel changes
    _assert_close_to_noise(g, r, 1e-4 * np.abs(r).max(axis=(1, 2), keepdims=True))
    assert (_fits(got / "stokes.fits")[0] > 0).sum() > 10
    np.testing.assert_allclose(np.loadtxt(got / "photometry.dat", ndmin=2),
                               np.loadtxt(ref / "photometry.dat", ndmin=2), rtol=1e-10, atol=0.0)
    assert (got / "normalization.dat").read_text() == (ref / "normalization.dat").read_text()


def test_cli_imaging_broad_matches_jax_f64(tmp_path):
    cells.write_input(tmp_path, "two", [0.6, 0.8], "50, 100",
                      "opacity01: 1, 2e-3, 0, 2, 0, ntheta, 0, nphi")
    got, ref = _run_both(tmp_path, "two", 1024, "-k", "detector:type=imaging_broad")
    np.testing.assert_allclose(_fits(got / "stokes.fits"), _fits(ref / "stokes.fits"),
                               rtol=1e-10, atol=0.0)


def test_cli_phase_curve_matches_jax_f64(tmp_path):
    """Seeds 203 .. 275 (one a phase angle): no photon among the first 64
    of these bisects the azimuth in jitted XLA (seed 34, for one, has one:
    see test_torch_pool.py), so every row compares at rtol 1e-10."""
    cells.write_input(tmp_path)
    got, ref = _run_both(tmp_path, "demo", 64, "--seed", "203", "-k", "detector:type=phase")
    g, r = np.loadtxt(got / "phase.dat", ndmin=2), np.loadtxt(ref / "phase.dat", ndmin=2)
    assert g.shape == r.shape == (len(runner.PHASE_ANGLES_DEG), 9)
    # Stokes columns to 1e-10 of the row's I; the error columns, whose
    # noise floor is about 1e-8 of the row's values (as in error.fits), to
    # 1e-4 of it
    scale = np.where(np.arange(9) % 2 == 0, 1e-4, 1e-10)
    _assert_close_to_noise(g, r, scale * np.abs(r[:, 1:2]))
    assert g[0, 0] == 0.0 and g[-1, 0] == 180.0 and (g[:60, 1] > 0).all()
