"""The plain PyTorch version on 3-D grids against the JAX package.

Both packages get identical tables (``convert.tables_from_jax``) and the same
(seed, photon id) streams, at float64 on the CPU:

* the 2 x 3 x 4 patchy grid as a spectrum, the phi-zone grid as a 5 x 5
  image, a self-luminous patchy grid and a two-species 3-D grid: counts
  bit-equal, moments and fluxes at rtol 1e-10, ``n_error``, ``error_codes``
  and the capped count equal (with the allowance of test_torch_pool.py for
  photons where jitted XLA bisects the azimuth Newton step);
* error records: the JAX pool keeps at most one record a pool round, which
  ones depends on its lane order; the port keeps the first and last K events
  in photon-id order. Every record JAX kept must be among the port's events,
  field for field, with K large enough to keep them all. Errors are forced
  with the crossing cap of tests/test_forensics.py:85 (error 032) and with
  its unphysical scattering matrix (error 050, ``debug_stokes``);
* ``photon_scattering`` off;
* the CLI at ``--f64`` on a 3-D input: ``spectrum.dat``, ``stokes.fits`` and
  ``error.log`` equal to the ``artes_tpu`` CLI's (every record line JAX wrote
  is among the port's).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artes_tpu import cli as jax_cli
from artes_tpu import presets
from artes_tpu import runner as jax_runner
from artes_tpu.io.fitsio import read_fits
from artes_tpu.transport import kernel as JK
from artes_tpu_torch import cells, cli, runner
from artes_tpu_torch.transport import convert
from artes_tpu_torch.transport import kernel as TK
from test_torch_pool import _close, _diverging, _tallies, setup
from torch_threads import one_thread  # noqa: F401

SEED = 9
JAX_WIDTH = 256


def two_species_3d():
    """Rayleigh above forward-scattering haze (the two species of
    tests/test_pallas_stream.py:326-349) on a grid with an equatorial face."""
    from artes_tpu.opacity import henyey_greenstein

    atm = presets.rayleigh_single_layer(tau=2.0, nr=4, theta_deg=(0.0, 90.0, 180.0),
                                        phi_deg=(0.0, 180.0))
    hg = henyey_greenstein.generate([0.7], absorption=0.05, scattering=1.0, g1=0.6,
                                    p_linear=0.3)
    atm.scatter[:2] = hg.scatter.transpose(2, 0, 1)[None, 0]
    atm.k_abs[:2] = 0.05 * atm.k_sca[:2]
    atm.k_sca[:, 0, 1] *= 3.0
    atm.refresh_derived()
    return atm


CASES = {
    "patchy spectrum": (lambda: presets.patchy_3d(0.5, 6.0), {}),
    "phi-zone image": (lambda: presets.patchy_3d(0.5, 6.0, theta_deg=(0.0, 90.0, 180.0),
                                                 phi_deg=(0.0, 120.0, 240.0)),
                       dict(mode="imaging_mono", npix=5)),
    "thermal": (cells.grid3d_thermal_atm, dict(photon_source="planet")),
    "two species": (two_species_3d, {}),
}


def records_of(out):
    """The JAX pool's records in its own order, and the port's."""
    if isinstance(out["error_records"], torch.Tensor):
        return out["error_records"].numpy()
    return np.asarray(JK.order_error_records(out["error_records"], out["n_error_records"]))


def assert_records_found(ref, got):
    """Every record the JAX pool kept is one of the port's events."""
    mine = {int(r[1]): r for r in records_of(got)}
    kept = records_of(ref)
    assert len(kept) > 0
    for row in kept:
        assert int(row[1]) in mine, f"photon {int(row[1])} has no record in the port"
        np.testing.assert_array_equal(mine[int(row[1])][[0, 1, 8, 9, 10, 11, 12, 14, 15]],
                                      row[[0, 1, 8, 9, 10, 11, 12, 14, 15]])
        np.testing.assert_allclose(mine[int(row[1])], row, rtol=1e-10, atol=1e-300)


def assert_matches_jax_3d(jt, static, tt, st, n, seed=SEED):
    """test_torch_pool.assert_matches_jax with the error tallies compared
    instead of being zero."""
    ref = JK.run_stream(jt, static, n, seed, JAX_WIDTH)
    got = TK.run_stream(tt, st, n, seed, n, err_k=n)
    assert got["n_emitted"] == int(ref["n_emitted"]) == n

    def jax_run(lo, k):
        return _tallies(JK.run_stream(jt, static, k, seed, JAX_WIDTH, 0, lo))

    def port_run(lo, k):
        return _tallies(TK.run_stream(tt, st, k, seed, k, 0, lo))

    bad = _diverging(jax_run, port_run, 0, n)
    assert len(bad) <= 2, f"{len(bad)} photons disagree with the jitted JAX kernel: {bad}"
    ref_t, got_t = _tallies(ref), _tallies(got)
    for pid in bad:
        ref_t = tuple(r - x for r, x in zip(ref_t, jax_run(pid, 1)))
        got_t = tuple(g - x for g, x in zip(got_t, port_run(pid, 1)))
    assert _close(got_t, ref_t)
    if not bad:
        assert int(got["n_error"]) == int(ref["n_error"])
        np.testing.assert_array_equal(got["error_codes"].numpy(), np.asarray(ref["error_codes"]))
        assert int(got["n_alive_at_cap"]) == int(ref["n_alive_at_cap"])
        assert int(got["n_stokes_anomaly"]) == int(ref["n_stokes_anomaly"])
    return ref, got


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_3d_matches_jax_f64(case):
    make, keys = CASES[case]
    jt, static, tt, st = setup(make(), "float64", **keys)
    assert tt.jump is not None
    ref, got = assert_matches_jax_3d(jt, static, tt, st, 256)
    assert got["detector"].shape == (static.nx * static.ny, 4, 3)
    assert float(got["detector"][..., 2].sum()) > 200


def degenerate(overrides, atm=None):
    """The 8 x 2 x 1 grid of tests/test_forensics.py:85 with ``overrides`` of
    its static parameters."""
    atm = atm or presets.rayleigh_single_layer(tau=6.0, nr=8, theta_deg=(0.0, 90.0, 180.0))
    jt, static, tt, st = setup(atm, "float64")
    static = dataclasses.replace(static, **overrides)
    return jt, static, tt, convert.static_from_jax(static)


def test_error_032_records_found_in_port():
    jt, static, tt, st = degenerate(dict(max_crossings=2))
    ref, got = assert_matches_jax_3d(jt, static, tt, st, 300, seed=5)
    assert int(got["n_error"]) > TK.ERR_RECORD_K and int(got["error_codes"][1]) > 0
    assert got["n_error_records"] == int(got["n_error"]) == len(got["error_records"])
    assert_records_found(ref, got)
    # the default K keeps the first and the last K events in photon-id order
    few = TK.run_stream(tt, st, 300, 5, 128)
    pids = got["error_records"][:, 1]
    assert torch.equal(pids, torch.sort(pids).values)
    k = TK.ERR_RECORD_K
    assert torch.equal(few["error_records"], torch.cat([got["error_records"][:k],
                                                        got["error_records"][-k:]]))
    assert few["n_error_records"] == got["n_error_records"]


@pytest.mark.parametrize("theta_deg", [(0.0, 180.0), (0.0, 90.0, 180.0), "over a surface"])
def test_stokes_anomaly_matches_jax(theta_deg):
    """Error 050 on a radial grid, on a 3-D grid and on a radial grid over a
    surface of albedo 0.5 (the marching walks): an unphysical matrix (m21 = 3
    P11) drives Q above I (tests/test_forensics.py:44)."""
    surface = theta_deg == "over a surface"
    atm = presets.rayleigh_single_layer(tau=3.0, theta_deg=(0.0, 180.0) if surface else theta_deg)
    atm.scatter[..., 4] = 3.0 * atm.scatter[..., 0]
    if surface:
        jt, static, tt, st = setup(atm, "float64", surface_albedo=0.5)
        static = dataclasses.replace(static, debug_stokes=True)
        st = convert.static_from_jax(static)
        assert TK.walk_mode(tt, st) == "march"
    else:
        jt, static, tt, st = degenerate(dict(debug_stokes=True), atm)
    ref, got = assert_matches_jax_3d(jt, static, tt, st, 200, seed=3)
    assert int(got["n_stokes_anomaly"]) > 0
    assert int(got["n_error"]) >= int(got["n_stokes_anomaly"])
    rows = got["error_records"].numpy()
    assert ((rows[:, 0] == 50.0) & (rows[:, 15] == 4.0)).sum() == int(got["n_stokes_anomaly"])
    assert_records_found(ref, got)
    quiet = TK.run_stream(tt, dataclasses.replace(st, debug_stokes=False), 200, 3, 200)
    assert int(quiet["n_stokes_anomaly"]) == int(quiet["n_error"]) == 0


def test_scattering_off_matches_jax():
    jt, static, tt, st = degenerate(dict(photon_scattering=False),
                                    presets.patchy_3d(0.5, 6.0))
    ref, got = assert_matches_jax_3d(jt, static, tt, st, 128)
    assert float(got["detector"][..., 2].sum()) == 0.0      # no scattering, no peel


def test_cli_3d_matches_jax_cli_f64(tmp_path, monkeypatch):
    """Spectrum and image of a 3-D input through both CLIs; the crossing cap
    is lowered in both so that photons are abandoned and error.log is
    written."""
    root = str(tmp_path)
    cells.write_artifact_input(root, "patchy", presets.patchy_3d(0.5, 6.0, nr=4))
    for mod in (jax_runner, runner):
        orig = mod._kernel_static
        monkeypatch.setattr(mod, "_kernel_static", lambda *a, _orig=orig: dataclasses.replace(
            _orig(*a), max_crossings=3))
    image = ["-k", "detector:type=imaging_mono", "-k", "detector:pixel=5"]
    for run, extra in (("spec", []), ("image", image)):
        assert jax_cli.main(["patchy", "96", "-o", run + "_ref", "--f64", "--root", root,
                             *extra]) == 0
        assert cli.main(["patchy", "96", "-o", run, "--f64", "--device", "cpu", "--root", root,
                         *extra]) == 0
        ref, got = (tmp_path / "output" / (run + tag) for tag in ("_ref", ""))
        assert sorted(os.listdir(got / "output")) == sorted(os.listdir(ref / "output"))
        ref_log = (ref / "error.log").read_text().splitlines()
        got_log = (got / "error.log").read_text().splitlines()
        tallies = [line for line in ref_log if " x" in line and "photon" not in line]
        assert tallies and tallies == [line for line in got_log if "photon" not in line]
        records = [line for line in ref_log if "photon" in line]
        assert records and set(records) <= set(got_log)
    spec = [np.loadtxt(tmp_path / "output" / r / "output" / "spectrum.dat", ndmin=2)
            for r in ("spec_ref", "spec")]
    np.testing.assert_allclose(spec[1], spec[0], rtol=1e-10, atol=0.0)
    img = [read_fits(tmp_path / "output" / r / "output" / "stokes.fits")[0][1]
           for r in ("image_ref", "image")]
    assert img[1].shape == (4, 5, 5) and np.abs(img[0]).max() > 0
    np.testing.assert_allclose(img[1], img[0], rtol=1e-10, atol=1e-300)
