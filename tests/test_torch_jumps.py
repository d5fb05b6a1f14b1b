"""The jump walk of the port against the JAX package's, at float64.

The same numpy-seeded rays go through ``artes_tpu.transport.jumps`` (with
the environment ``kernel._jump_env`` builds over the JAX tables) and
``artes_tpu_torch.transport.jumps`` (with the difference tables built once
by ``jump_tables`` over the carried-over tables): optical depths at rtol
1e-12, surface flags equal. The grid is that of tests/test_jumps.py:98 (6 x
4 x 4 patchy zones on a graded profile, round and oblate), with the photon
floor at the bottom and raised; the port's walk is also held against that
file's brute-force integral.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artes_tpu import presets
from artes_tpu.config import ArtesConfig, detector_setup
from artes_tpu.transport import jumps as JJ
from artes_tpu.transport import kernel as JK
from artes_tpu.transport.tables import build_tables
from artes_tpu_torch.transport import convert
from artes_tpu_torch.transport import geometry as TG
from artes_tpu_torch.transport import jumps as TJ
from test_jumps import _brute, _env_from_tables
from torch_threads import one_thread  # noqa: F401

RTOL = 1e-12


def graded_patchy(oblateness, cell_depth=None):
    """JAX tables of the 6 x 4 x 4 grid and the port's twins."""
    th = tuple(np.linspace(0.0, 180.0, 5))
    ph = tuple(np.linspace(0.0, 360.0, 5)[:-1])
    atm = presets.patchy_3d(tau_clear=0.5, tau_cloud=4.0, nr=6, theta_deg=th, phi_deg=ph)
    prof = np.exp(np.linspace(1.0, -1.0, 6))[:, None, None, None]
    atm.k_sca = atm.k_sca * prof
    atm.k_abs = atm.k_abs * prof
    atm.refresh_derived()
    cfg = ArtesConfig()
    cfg.mode = "spectrum"
    cfg.oblateness = oblateness
    det = detector_setup(cfg, float(atm.rfront[-1]))
    jt = build_tables(atm, cfg, det, 0, dtype=jnp.float64).tables
    if cell_depth is not None:
        jt.cell_depth = jnp.asarray(cell_depth, jnp.int32)
    return jt, convert.tables_from_jax(jt)


def rays(tt, n, seed):
    """Points between the floor and the top with random directions, and the
    cells the port locates them in."""
    g = tt.grid
    rs = np.random.default_rng(seed)
    r_floor = float(g.rfront[int(tt.cell_depth)])
    r = r_floor + (1.0 - r_floor) * rs.uniform(0.02, 0.98, n)
    u = rs.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pos = r[:, None] * u / np.array([g.ob_ax, g.ob_by, g.ob_cz])
    d = rs.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cr = torch.clamp(torch.searchsorted(g.rfront, torch.as_tensor(r), right=True) - 1, 0, g.nr - 1)
    cell = TG.locate_cell(g, torch.as_tensor(pos), cr).numpy()
    return pos, d, cell


def walk_both(jt, tt, pos, d, cell):
    ref = JJ.tau_walk_jumps(JK._jump_env(jt), *[jnp.asarray(pos[:, i]) for i in range(3)],
                            *[jnp.asarray(d[:, i]) for i in range(3)],
                            *[jnp.asarray(cell[:, i], jnp.int32) for i in range(3)])
    got = TJ.tau_walk_jumps(tt.grid, tt.jump, tt.grid.rfront[tt.cell_depth],
                            *torch.as_tensor(pos).unbind(-1), *torch.as_tensor(d).unbind(-1),
                            *torch.as_tensor(cell).unbind(-1))
    assert sorted(got) == sorted(ref)
    for key in ("exited", "surface", "err"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]), err_msg=key)
    np.testing.assert_allclose(got["tau"].numpy(), np.asarray(ref["tau"]), rtol=RTOL, atol=0.0)
    return got


@pytest.mark.parametrize("cell_depth", [None, 2])
@pytest.mark.parametrize("oblateness", [0.0, 0.15])
def test_jump_walk_matches_jax(oblateness, cell_depth):
    jt, tt = graded_patchy(oblateness, cell_depth)
    pos, d, cell = rays(tt, 300, 7)
    got = walk_both(jt, tt, pos, d, cell)
    assert got["surface"].any() and got["exited"].any() and not got["err"].any()
    assert (got["tau"] > 0).all()


def test_jump_walk_special_rays_match_jax():
    """Rays in the equatorial plane, along the axis, in a phi half-plane and
    straight up: the linear and degenerate branches of the roots."""
    jt, tt = graded_patchy(0.0)
    g = tt.grid
    r = 0.5 * (float(g.rfront[2]) + float(g.rfront[3]))
    pos = np.array([[r, 0.0, 0.0], [0.0, 0.0, r], [r * 0.6, 0.0, r * 0.8], [r * 0.6, r * 0.8, 0.0],
                    [r * 0.6, r * 0.8, 0.0]])
    d = np.array([[0.0, 1.0, 0.0], [0.0, 0.0, -1.0], [0.6, 0.0, 0.8], [0.0, 0.0, 1.0],
                  [-0.8, 0.6, 0.0]])
    cell = TG.locate_cell(g, torch.as_tensor(pos), torch.full((5,), 2)).numpy()
    walk_both(jt, tt, pos, d, cell)


@pytest.mark.parametrize("oblateness", [0.0, 0.15])
def test_jump_walk_matches_brute_force(oblateness):
    """The port's walk against the dense midpoint integral of
    tests/test_jumps.py (its discretisation error is about 1e-4)."""
    jt, tt = graded_patchy(oblateness)
    env, k3, cd = _env_from_tables(jt)
    pos, d, cell = rays(tt, 12, 3)
    got = TJ.tau_walk_jumps(tt.grid, tt.jump, tt.grid.rfront[tt.cell_depth],
                            *torch.as_tensor(pos).unbind(-1), *torch.as_tensor(d).unbind(-1),
                            *torch.as_tensor(cell).unbind(-1))
    for i in range(len(pos)):
        tau, surface = _brute(env, k3, cd, pos[i], d[i])
        assert bool(got["surface"][i]) == surface
        assert abs(float(got["tau"][i]) - tau) <= 2.0e-3 * max(tau, 1e-12)


def test_jump_tables_match_jax_env():
    """``jump_tables`` holds the rows that ``kernel._jump_env`` gathers."""
    jt, tt = graded_patchy(0.0)
    env, j = JK._jump_env(jt), tt.jump
    g = tt.grid
    ncol = {"dr": g.ntheta * g.nphi, "dtt": g.nr * g.nphi, "dpp": g.nr * g.ntheta}
    for name, first, rows in (("dr", 1, j.dr), ("dtt", 1, j.dtt), ("dpp", 0, j.dpp)):
        idx = jnp.arange(ncol[name], dtype=jnp.int32)
        for i, row in enumerate(rows):
            np.testing.assert_array_equal(row.numpy(), np.asarray(getattr(env, name)(first + i, idx)),
                                          err_msg=f"{name}[{i}]")
    np.testing.assert_array_equal(j.kbar.numpy(), np.asarray(jnp.stack(env.kbar)))
    np.testing.assert_array_equal(j.dk.numpy(),
                                  np.asarray(env.dk0(jnp.arange(j.dk.shape[0], dtype=jnp.int32))))
    r2 = np.linspace(0.9, 1.01, 50) ** 2
    np.testing.assert_array_equal(
        torch.searchsorted(j.rf2, torch.as_tensor(r2), right=True).numpy(),
        np.asarray(env.locate_m(jnp.asarray(r2))[0]))
    assert TJ.jump_tables_of(convert.tables_from_jax(build_radial()).grid, None) is None


def build_radial():
    atm = presets.rayleigh_single_layer(tau=1.0, nr=3)
    cfg = ArtesConfig()
    cfg.mode = "spectrum"
    det = detector_setup(cfg, float(atm.rfront[-1]))
    return build_tables(atm, cfg, det, 0, dtype=jnp.float64).tables


def test_stable_roots_and_sel_cone_match_jax():
    rs = np.random.default_rng(1)
    a, b, c = (rs.normal(size=400) for _ in range(3))
    a[:40] = 0.0                    # linear
    a[40:60] = 1e-40                # below lin_eps
    b[20:50] = 0.0
    c[60:80] = 0.0
    ref = JJ._stable_roots(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c))
    got = TJ._stable_roots(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(c))
    for x, y in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=RTOL, atol=0.0)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    cone = rs.uniform(size=400) < 0.5
    for first in (True, False):
        ref = JJ._sel_cone(jnp.asarray(cone), jnp.asarray(a), jnp.asarray(b), first)
        got = TJ._sel_cone(torch.as_tensor(cone), torch.as_tensor(a), torch.as_tensor(b), first)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
