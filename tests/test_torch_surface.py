"""Lambert surfaces in the plain PyTorch version against the JAX package.

A surface takes every grid off its fast walks: peels, the prewalk and the
transport march all step through ``geometry.cell_face``, and the surface
event and its peel are branches of that march. At float64 on the CPU, with
identical tables (``convert.tables_from_jax``) and (seed, photon id) streams:

* the marching tau walk against ``kernel._peel_walk`` and
  ``_first_tau_walk`` of the JAX package on a radial and a 3-D grid, optical
  depths at rtol 1e-11 and the outcome flags equal;
* ``run_stream`` on a radial grid at two albedos, as a 5 x 5 image, with a
  thermal source, and on a 3-D grid: counts bit-equal, moments and fluxes at
  rtol 1e-10, error tallies equal;
* peel and prewalk failures, forced with a low crossing cap: a failed
  prewalk abandons the photon under code 031 (record site 2), a failed
  scatter peel is tallied under the peel code and recorded as code 50 at
  site 3; every record the JAX pool kept is among the port's;
* the Lambert sphere: a transparent shell over a white surface at full
  phase has the geometric albedo 2/3 (tests/test_transport.py:141-159).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artes_tpu import presets
from artes_tpu.transport import kernel as JK
from artes_tpu_torch import cells, runner
from artes_tpu_torch.config import ArtesConfig, detector_setup
from artes_tpu_torch.transport import convert
from artes_tpu_torch.transport import kernel as TK
from test_geometry import locate
from test_torch_grid3d import assert_matches_jax_3d, records_of
from test_torch_pool import setup
from torch_threads import one_thread  # noqa: F401


# a walk sums up to a dozen cell_face distances, each equal at 1e-12; on shells
# 1e-3 of the radius thick a near-tangent root differs by 2.4e-12 (measured)
WALK_RTOL = 1e-11


def interior(atm, n, seed):
    """Points inside the shells of ``atm`` (off the radial faces), unit
    directions and the cells of the points."""
    rs = np.random.default_rng(seed)
    rf = atm.rfront / atm.rfront[-1]
    r = rf[0] + rs.uniform(0.01, 0.99, n) * (1.0 - rf[0])
    ct = rs.uniform(-0.999, 0.999, n)
    st = np.sqrt(1.0 - ct * ct)
    ph = rs.uniform(0.0, 2.0 * np.pi, n)
    pos = np.stack([r * st * np.cos(ph), r * st * np.sin(ph), r * ct], axis=-1)
    dirn = rs.normal(size=(n, 3))
    dirn /= np.linalg.norm(dirn, axis=-1, keepdims=True)
    return pos, dirn, locate(atm, pos)


WALK_GRIDS = {"radial": lambda: presets.rayleigh_single_layer(tau=2.0, nr=4),
              "patchy": lambda: presets.patchy_3d(0.5, 6.0)}


@pytest.mark.parametrize("grid", sorted(WALK_GRIDS))
def test_marching_tau_walk_matches_jax(grid):
    atm = WALK_GRIDS[grid]()
    jt, static, tt, st = setup(atm, "float64", surface_albedo=0.5)
    assert static.has_surface and TK.walk_mode(tt, st) == "march"
    pos, dirn, cell = interior(atm, 300, 4)
    face = np.zeros((len(pos), 2), np.int64)
    active = np.ones(len(pos), bool)
    active[::7] = False                 # inactive photons walk nowhere
    jargs = (jnp.asarray(cell, jnp.int32), jnp.asarray(face, jnp.int32), jnp.asarray(active))
    targs = (torch.as_tensor(cell), torch.as_tensor(face), torch.as_tensor(active))

    tau, exited, err = JK._peel_walk(jt, static, jnp.asarray(pos), *jargs)
    got = TK._tau_walk_march(tt, st, torch.as_tensor(pos), tt.det_dir, *targs)
    np.testing.assert_allclose(got["tau"].numpy(), np.asarray(tau), rtol=WALK_RTOL, atol=0.0)
    np.testing.assert_array_equal(got["exited"].numpy(), np.asarray(exited))
    np.testing.assert_array_equal(got["error"].numpy(), np.asarray(err))
    assert not got["capped"].any() and got["exited"].any() and got["surface"].any()
    assert not (got["tau"][~torch.as_tensor(active)] != 0).any()

    tau, surface, err = JK._first_tau_walk(jt, static, jnp.asarray(pos), jnp.asarray(dirn), *jargs)
    got = TK._tau_walk_march(tt, st, torch.as_tensor(pos), torch.as_tensor(dirn), *targs)
    np.testing.assert_allclose(got["tau"].numpy(), np.asarray(tau), rtol=WALK_RTOL, atol=0.0)
    np.testing.assert_array_equal(got["surface"].numpy(), np.asarray(surface))
    np.testing.assert_array_equal(got["error"].numpy(), np.asarray(err))

    # a cap of two passes stops the long walks short: flagged, not an exit
    short = TK._tau_walk_march(tt, dataclasses.replace(st, max_crossings=2),
                               torch.as_tensor(pos), torch.as_tensor(dirn), *targs)
    assert short["capped"].any() and not (short["capped"] & short["exited"]).any()


CASES = {
    "albedo 1.0 tau 0.3": (lambda: presets.rayleigh_single_layer(tau=0.3, nr=2),
                           dict(surface_albedo=1.0)),
    "albedo 0.5 tau 1.0": (lambda: presets.rayleigh_single_layer(tau=1.0, nr=2),
                           dict(surface_albedo=0.5)),
    "image 5x5 albedo 0.8": (lambda: presets.rayleigh_single_layer(tau=0.5, nr=2),
                             dict(surface_albedo=0.8, mode="imaging_mono", npix=5)),
    "thermal albedo 0.7": (cells.thermal_surface_shell,
                           dict(photon_source="planet", surface_albedo=0.7)),
    "patchy 3-D albedo 0.5": (lambda: presets.patchy_3d(0.5, 6.0), dict(surface_albedo=0.5)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_surface_matches_jax_f64(case):
    make, keys = CASES[case]
    jt, static, tt, st = setup(make(), "float64", **keys)
    assert TK.walk_mode(tt, st) == "march"
    ref, got = assert_matches_jax_3d(jt, static, tt, st, 256)
    det = got["detector"]
    assert det.shape == (static.nx * static.ny, 4, 3)
    # surface peels count in the Stokes-I row only
    assert float(det[:, 0, 2].sum()) > float(det[:, 1, 2].sum()) > 0
    assert got["flow_global"] is None and got["flow_theta"] is None


def events_found(ref, got):
    """Every record the JAX pool kept is one of the port's events, matched
    by photon, site and scattering count; returns the JAX records."""
    mine = {(int(r[1]), int(r[15]), int(r[14])): r for r in records_of(got)}
    kept = records_of(ref)
    for row in kept:
        key = (int(row[1]), int(row[15]), int(row[14]))
        assert key in mine, f"event {key} has no record in the port"
        np.testing.assert_array_equal(mine[key][[0, 8, 9, 10, 11, 12]],
                                      row[[0, 8, 9, 10, 11, 12]])
        np.testing.assert_allclose(mine[key], row, rtol=1e-10, atol=1e-300)
    return kept


FAILING = {
    # thick shells: many stellar photons graze past the floor, eight passes deep
    "star": lambda: presets.rayleigh_single_layer(tau=1.0, nr=4, shell_km=20000.0,
                                                  theta_deg=(0.0, 90.0, 180.0),
                                                  phi_deg=(0.0, 180.0)),
    "planet": cells.grid3d_thermal_atm,
}


@pytest.mark.parametrize("source", sorted(FAILING))
def test_walk_failures_match_jax(source):
    """A crossing cap of 5 over a surface fails marches (032), prewalks (031,
    site 2) and peels (peel code; code 50 at site 3; a thermal birth peel
    abandons its photon and leaves no record)."""
    jt, static, tt, st = setup(FAILING[source](), "float64", surface_albedo=0.5,
                               photon_source=source)
    static = dataclasses.replace(static, max_crossings=5)
    st = convert.static_from_jax(static)
    ref, got = assert_matches_jax_3d(jt, static, tt, st, 300, seed=5)
    codes = got["error_codes"].numpy()
    np.testing.assert_array_equal(codes, np.asarray(ref["error_codes"]))
    assert int(got["n_error"]) == int(ref["n_error"]) > 0
    assert codes[1] > 0 and codes[3] > 0
    rows = got["error_records"].numpy()
    assert got["n_error_records"] == len(rows)
    sites = {int(s): int((rows[:, 15] == s).sum()) for s in (0, 1, 2, 3)}
    for col, code in ((0, 31.0), (1, 32.0), (2, 34.0)):          # prewalks count under 031
        assert int((rows[:, 0] == code).sum()) == codes[col]
    assert ((rows[:, 15] == 2) <= (rows[:, 0] == 31.0)).all()
    assert ((rows[:, 15] == 3) == (rows[:, 0] == 50.0)).all()
    assert sites[3] <= codes[3]
    assert sites[2] > 0 and sites[3] > 0
    if source == "star":
        # abandoned photons: every march and prewalk failure has its record
        assert int(got["n_error"]) == sites[0] + sites[1] + sites[2]
    else:
        # birth-peel failures abandon photons without a record
        assert int(got["n_error"]) > sites[0] + sites[1] + sites[2]
    kept = events_found(ref, got)
    assert len(kept) > 0


def test_lambert_sphere_albedo():
    atm = cells.lambert_sphere()
    cfg = ArtesConfig()
    cfg.mode = "spectrum"
    cfg.surface_albedo = 1.0
    cfg.det_phi = 1.0e-3                # the observer at the star: phase 0
    det = detector_setup(cfg, float(atm.rfront[-1]))
    n = 40000
    res = runner.run_wavelength(atm, cfg, det, 0, n, seed=11, batch_size=n,
                                dtype=torch.float64, device="cpu")
    assert res.n_error == 0 and not res.error_codes.any()
    assert res.photometry[0] / cells.stellar_norm(cfg, atm) == pytest.approx(2.0 / 3.0, rel=0.03)
    assert abs(res.photometry[2] / res.photometry[0]) < 0.01     # a Lambert surface depolarises
    assert res.flow_global is None and res.flow_theta is None
