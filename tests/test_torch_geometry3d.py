"""The 3-D geometry of the port against the JAX package's, at float64.

The same numpy-seeded rays and cells go through
``artes_tpu.transport.geometry`` and ``artes_tpu_torch.transport.geometry``:
``cell_face`` (one step, and whole marches fed with each package's own
outputs), ``heal_cell`` and ``locate_cell``. Floats agree at rtol 1e-12,
integer and boolean outputs exactly. The cases mirror tests/test_geometry.py:
random interior rays, the phi wrap-around, the equatorial plane, the
same-face re-crossing and oblate grids.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artes_tpu.transport import geometry as JG
from artes_tpu_torch.transport import geometry as TG
from test_geometry import GRIDS, FakeAtm, locate, sample_interior
from torch_threads import one_thread  # noqa: F401

RTOL = 1e-12
INT_KEYS = ("next_face", "cell_out", "grid_exit", "error", "err_nocand", "err_degen")


def both_grids(atm, oblateness=0.0):
    return (JG.make_grid_geometry(atm, oblateness)[0], TG.make_grid_geometry(atm, oblateness)[0])


def both_cell_face(jg, tg, pos, dirn, cell, face, cell_depth=0):
    """``cell_face`` of both packages on the same numpy inputs; asserts that
    they agree and returns the port's outputs as numpy."""
    ref = JG.cell_face(jg, jnp.asarray(pos), jnp.asarray(dirn), jnp.asarray(cell, jnp.int32),
                       jnp.asarray(face, jnp.int32), cell_depth)
    got = TG.cell_face(tg, torch.as_tensor(pos), torch.as_tensor(dirn), torch.as_tensor(cell),
                       torch.as_tensor(face), torch.tensor(cell_depth))
    assert sorted(got) == sorted(ref)
    for key in INT_KEYS:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]), err_msg=key)
    np.testing.assert_allclose(got["distance"].numpy(), np.asarray(ref["distance"]),
                               rtol=RTOL, atol=0.0)
    return {k: v.numpy() for k, v in got.items()}


def interior(atm, n, seed, a=1.0):
    pos, dirn = sample_interior(atm, n, np.random.default_rng(seed), a=a)
    cell = locate(atm, pos, a=a)
    ok = (cell[:, 0] >= 0) & (cell[:, 0] < atm.nr)
    return pos[ok], dirn[ok], cell[ok]


@pytest.mark.parametrize("oblateness", [0.0, 0.3])
@pytest.mark.parametrize("atm_idx", range(len(GRIDS)))
def test_cell_face_matches_jax(atm_idx, oblateness):
    atm = GRIDS[atm_idx]
    jg, tg = both_grids(atm, oblateness)
    pos, dirn, cell = interior(atm, 400, 42 + atm_idx, a=1.0 - oblateness)
    out = both_cell_face(jg, tg, pos, dirn, cell, np.zeros((len(pos), 2), np.int64))
    assert not out["error"].any() and (out["distance"] > 0).all()
    # the second step starts on a face: the skip rules and the looser
    # same-face threshold come into play
    pos2 = pos + out["distance"][:, None] * dirn
    inside = ~out["grid_exit"] & (out["cell_out"][:, 0] >= 0)     # not out, not on the floor
    both_cell_face(jg, tg, pos2[inside], dirn[inside], out["cell_out"][inside],
                   out["next_face"][inside])


@pytest.mark.parametrize("cell_depth", [0, 1])
def test_marches_match_jax(cell_depth):
    """Whole marches on the 3 x 4 x 4 grid: both packages step from the same
    state until every ray has left the grid, hit the floor or failed."""
    atm = GRIDS[1]
    jg, tg = both_grids(atm)
    pos, dirn, cell = interior(atm, 300, 5)
    keep = cell[:, 0] >= cell_depth
    pos, dirn, cell = pos[keep], dirn[keep], cell[keep]
    face = np.zeros((len(pos), 2), np.int64)
    steps = 0
    while len(pos):
        out = both_cell_face(jg, tg, pos, dirn, cell, face, cell_depth)
        nf = out["next_face"]
        go = ~(out["grid_exit"] | out["error"] | ((nf[:, 0] == 1) & (nf[:, 1] == cell_depth)))
        pos = (pos + out["distance"][:, None] * dirn)[go]
        dirn, cell, face = dirn[go], out["cell_out"][go], nf[go]
        steps += 1
        assert steps < 64
    assert steps >= 3


def test_no_candidate_and_rescues_match_jax():
    """Rays at the boundaries: past the outer face moving outward (no face
    ahead: rescued as a grid exit), just under the floor face moving inward,
    and a photon on the floor face that grazes back onto it."""
    atm = GRIDS[1]
    jg, tg = both_grids(atm)
    rf = atm.rfront / atm.rfront[-1]
    u = np.array([0.5, 0.4, 0.7]) / np.linalg.norm([0.5, 0.4, 0.7])
    _, ct, cp = locate(atm, u[None] * 0.999)[0]
    pos = np.stack([u * (1.0 + 1e-13), u * rf[1] * (1.0 - 1e-13)])
    dirn = np.stack([u, -u])
    cell = np.array([[2, ct, cp], [1, ct, cp]])
    out = both_cell_face(jg, tg, pos, dirn, cell, np.zeros((2, 2), int), cell_depth=1)
    assert out["grid_exit"].tolist() == [True, False] and not out["error"].any()
    assert out["next_face"][0].tolist() == [1, 3] and out["distance"][0] == 0.0
    # a photon on the floor face that grazes back onto it
    t = np.cross(u, [0.0, 0.0, 1.0])
    d = (-1e-9 * u + t) / np.linalg.norm(-1e-9 * u + t)
    both_cell_face(jg, tg, (u * rf[1])[None], d[None], np.array([[1, ct, cp]]),
                   np.array([[1, 1]]), 1)


def test_named_cases_match_jax():
    """The hand-built cases of tests/test_geometry.py."""
    atm = GRIDS[1]
    jg, tg = both_grids(atm)
    r_mid = 0.5 * (atm.rfront[0] + atm.rfront[1]) / atm.rfront[-1]
    z0 = 1e-4
    out = both_cell_face(jg, tg, np.array([[np.sqrt(r_mid ** 2 - z0 ** 2), 0.0, z0]]),
                         np.array([[0.0, 0.0, -1.0]]), np.array([[0, 1, 0]]), np.zeros((1, 2), int))
    assert out["next_face"][0].tolist() == [2, 2] and out["cell_out"][0].tolist() == [0, 2, 0]
    assert out["distance"][0] == pytest.approx(z0, rel=1e-10)      # the equatorial plane

    atm = GRIDS[0]
    jg, tg = both_grids(atm)
    rf = atm.rfront / atm.rfront[-1]
    b = 0.5 * (rf[0] + rf[1])
    out = both_cell_face(jg, tg, np.array([[np.sqrt(rf[1] ** 2 - b ** 2), b, 0.0]]),
                         np.array([[-1.0, 0.0, 0.0]]), np.array([[0, 0, 0]]), np.array([[1, 1]]))
    assert out["next_face"][0].tolist() == [1, 1]                  # same-face re-crossing
    assert out["distance"][0] == pytest.approx(2.0 * np.sqrt(rf[1] ** 2 - b ** 2), rel=1e-9)

    jg, tg = both_grids(atm, 0.3)
    out = both_cell_face(jg, tg, np.array([[(1 - 1e-12) / 0.7, 0.0, 0.0]]),
                         np.array([[-1.0, 0.0, 0.0]]), np.array([[atm.nr - 1, 0, 0]]),
                         np.array([[1, atm.nr]]))
    assert out["distance"][0] == pytest.approx((1.0 - rf[1]) / 0.7, rel=1e-9)     # oblate

    atm = FakeAtm([1.0e7, 7.5e7], [0, 180], [0, 120, 240])
    jg, tg = both_grids(atm)
    ang = np.deg2rad(330.0)
    out = both_cell_face(jg, tg, np.array([[0.5 * np.cos(ang), 0.5 * np.sin(ang), 0.0]]),
                         np.array([[-np.sin(ang), np.cos(ang), 0.0]]), np.array([[0, 0, 2]]),
                         np.zeros((1, 2), int))
    assert out["next_face"][0].tolist() == [3, 0] and out["cell_out"][0].tolist() == [0, 0, 0]


@pytest.mark.parametrize("oblateness", [0.0, 0.2])
@pytest.mark.parametrize("atm_idx", range(len(GRIDS)))
def test_locate_and_heal_match_jax(atm_idx, oblateness):
    atm = GRIDS[atm_idx]
    jg, tg = both_grids(atm, oblateness)
    a = 1.0 - oblateness
    pos, _, cell = interior(atm, 256, 3 + atm_idx, a=a)
    # points on the axis, on the equatorial plane and on the phi = 0 plane
    rf0 = atm.rfront[0] / atm.rfront[-1]
    special = np.array([[0.0, 0.0, 0.99], [0.0, 0.0, -0.99], [0.99 / a, 0.0, 0.0],
                        [0.0, 0.99 / a, 0.0], [-(rf0 + 1e-3) / a, 0.0, 0.0]])
    pos = np.concatenate([pos, special])
    cell = np.concatenate([cell, locate(atm, special, a=a)])
    ref = JG.locate_cell(jg, jnp.asarray(pos), jnp.asarray(cell[:, 0], jnp.int32))
    got = TG.locate_cell(tg, torch.as_tensor(pos), torch.as_tensor(cell[:, 0]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy()[:-len(special)], cell[:-len(special)])

    # tracked cells that disagree with the position in every way
    rs = np.random.default_rng(9)
    wrong = np.stack([rs.integers(0, max(n, 1), len(pos))
                      for n in (atm.nr, atm.ntheta, atm.nphi)], -1)
    active = rs.uniform(size=len(pos)) < 0.8
    ref = JG.heal_cell(jg, jnp.asarray(pos), jnp.asarray(wrong, jnp.int32), jnp.asarray(active))
    got = TG.heal_cell(tg, torch.as_tensor(pos), torch.as_tensor(wrong), torch.as_tensor(active))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    healed = (got.numpy() != wrong).any(axis=1)
    assert not healed[~active].any()
    if atm.nr > 1:
        assert healed.any()
