"""Thermal emission in the plain PyTorch pool kernel against the JAX package.

* float64: the plain version against JAX ``run_stream`` on the bench's
  absorbing thermal shell (isotropic and Gordon-biased emission, births and
  birth peels only) and on the half-scattering thermal shell of
  tests/test_pallas_stream.py:163-191, whose photons scatter and leave
  (``flux_exit`` > 0). Counts equal per pixel and count column, moments and
  both fluxes at rtol 1e-10 (``test_torch_pool.assert_matches_jax``, with
  its eager replay of at most two photons).
* float32: different compilers, so the check is statistical.
* The transparent-shell oracle L / (4 pi d^2) holds.
* The CLI's thermal outputs (``luminosity.dat``, ``cell_luminosity.fits``)
  equal the ``artes_tpu`` CLI's at float64.
"""

import os

import numpy as np
import pytest
from test_torch_pool import SEED, assert_matches_jax, setup
from torch_threads import one_thread  # noqa: F401

from artes_tpu import cli as jax_cli
from artes_tpu.config import ArtesConfig, detector_setup
from artes_tpu.io.fitsio import read_fits
from artes_tpu.transport import kernel as JK
from artes_tpu_torch import cells, cli, runner
from artes_tpu_torch.transport import kernel as TK


@pytest.mark.parametrize("emission", ["isotropic", "biased"])
def test_thermal_births_match_jax_f64(emission):
    jt, static, tt, st = setup(cells.thermal_bench(), "float64", photon_source="planet",
                               photon_emission=emission)
    got = assert_matches_jax(jt, static, tt, st, 4096)
    det = got["detector"].numpy()
    # a pure absorber: every count is a birth peel, booked on Stokes I only
    assert det[0, 0, 2] > 0 and (det[0, 1:, 2] == 0).all() and (det[0, 1:, :2] == 0).all()
    assert float(got["flux_emitted"]) > 0.0 and float(got["flux_exit"]) == 0.0


def test_scattering_thermal_shell_matches_jax_f64():
    """Births, scatter peels and exits: the count of the Stokes-I row holds
    the birth peels on top of the Q, U, V rows' scatter peels."""
    jt, static, tt, st = setup(cells.thermal_scattering_shell(), "float64",
                               photon_source="planet")
    # 1024 photons: two of them bisect the azimuth in jitted XLA (ids 738, 872)
    got = assert_matches_jax(jt, static, tt, st, 1024)
    det = got["detector"].numpy()
    assert det[0, 0, 2] > det[0, 1, 2] > 0 and det[0, 1, 2] == det[0, 3, 2]
    assert float(got["flux_exit"]) > 0.0


# about 3x the gaps measured on the CPU at 2^14 photons, seed 7, scattering
# thermal shell: I rel 7.2e-8, flux_emitted rel 1.1e-7, flux_exit rel
# 3.2e-5; counts equal in every row (limit: two flipped peels in ~2e4)
F32_LIMITS = {"count": 1e-4, "I": 2.2e-7, "flux_emitted": 3.3e-7, "flux_exit": 1e-4}


def test_thermal_f32_statistical():
    jt, static, tt, st = setup(cells.thermal_scattering_shell(), "float32",
                               photon_source="planet")
    n = 1 << 14
    ref = JK.run_stream(jt, static, n, SEED, 4096)
    got = TK.run_stream(tt, st, n, SEED, n)
    r, g = np.asarray(ref["detector"], np.float64), got["detector"].numpy()
    gaps = {"count": np.abs(g[0, :, 2] - r[0, :, 2]).max() / r[0, 0, 2],
            "I": abs(g[0, 0, 0] - r[0, 0, 0]) / r[0, 0, 0]}
    for key in ("flux_emitted", "flux_exit"):
        gaps[key] = abs(float(got[key]) - float(ref[key])) / float(ref[key])
    assert all(gaps[k] <= F32_LIMITS[k] for k in F32_LIMITS), gaps
    assert np.isfinite(g).all()


def test_transparent_shell_oracle():
    """L / (4 pi d^2) of a transparent 900 K shell (test_transport.py:82-105)
    through the port's runner, float32 plain version."""
    atm = cells.transparent_thermal_shell()
    cfg = ArtesConfig()
    cfg.mode = "spectrum"
    cfg.photon_source = "planet"
    det = detector_setup(cfg, float(atm.rfront[-1]))
    res = runner.run_wavelength(atm, cfg, det, 0, 1 << 15, seed=5, device="cpu")
    assert res.photometry[0] == pytest.approx(cells.thermal_shell_oracle(atm, cfg), rel=0.02)
    # every photon is forced to interact in the shell, where it is absorbed
    assert res.flux_emitted > 0.0 and res.flux_exit == 0.0


def _fits(path):
    return read_fits(path)[0][1]


@pytest.mark.parametrize("mode", ["spectrum", "imaging_mono"])
def test_cli_thermal_outputs_match_jax_f64(tmp_path, mode):
    cells.write_artifact_input(tmp_path, "therm", cells.thermal_scattering_shell(),
                               ["photon:source=planet"])
    common = ["therm", "1024", "--f64", "--root", str(tmp_path), "-k", f"detector:type={mode}"]
    assert jax_cli.main([*common, "-o", "ref"]) == 0
    assert cli.main([*common, "-o", "got", "--device", "cpu"]) == 0
    ref, got = tmp_path / "output" / "ref" / "output", tmp_path / "output" / "got" / "output"
    assert sorted(os.listdir(got)) == sorted(os.listdir(ref))
    lum_g, lum_r = (np.loadtxt(d / "luminosity.dat", ndmin=2) for d in (got, ref))
    np.testing.assert_allclose(lum_g, lum_r, rtol=1e-10, atol=0.0)
    # emitted > emergent > 0: the shell absorbs part of what it emits
    assert lum_g[0, 1] > lum_g[0, 2] > 0.0
    if mode == "imaging_mono":
        np.testing.assert_array_equal(_fits(got / "cell_luminosity.fits"),
                                      _fits(ref / "cell_luminosity.fits"))
        assert (_fits(got / "cell_luminosity.fits") > 0).all()
