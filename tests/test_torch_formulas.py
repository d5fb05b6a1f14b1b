"""Formula functions of the port against their JAX counterparts in float64.

The same random inputs, made with numpy, go through both packages: the
closed-form radial walks (rays that hit and miss the floor, grazing chords,
nr in {1, 5}, oblate and spherical), every Stokes/Mueller function, and the
scattering samplers. Floats agree at rtol 1e-12 / atol 1e-14; integer and
boolean outputs are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artes_tpu import presets
from artes_tpu.atmosphere import SINBETA
from artes_tpu.transport import mueller as JM
from artes_tpu.transport import radial as JRAD
from artes_tpu.transport import sampling as JS
from artes_tpu_torch.transport import mueller as TM
from artes_tpu_torch.transport import radial as TRAD
from artes_tpu_torch.transport import sampling as TS
from torch_threads import one_thread  # noqa: F401

RTOL, ATOL = 1e-12, 1e-14


def close(ref, got):
    np.testing.assert_allclose(got.numpy() if isinstance(got, torch.Tensor) else got,
                               np.asarray(ref), rtol=RTOL, atol=ATOL)


def equal(ref, got):
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def T(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def J(a):
    return jnp.asarray(np.asarray(a, np.float64))


def unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _rays(nr, ob, rs, n=600):
    """Positions between the floor and the top, random directions plus
    tangent rays (chords grazing their own radius) and rays aimed at the
    floor's limb; positions are mapped onto the oblate grid."""
    rf = np.linspace(0.97, 1.0, nr + 1)
    r = rs.uniform(rf[0], 1.0, n)
    pos = unit(rs.normal(size=(n, 3))) * r[:, None]
    d = unit(rs.normal(size=(n, 3)))
    k = n // 3
    # tangent: direction perpendicular to the position vector
    d[:k] = unit(np.cross(pos[:k], rs.normal(size=(k, 3))))
    # aimed at the floor sphere's limb (perigee ~ floor radius)
    limb = unit(np.cross(pos[k:2 * k], rs.normal(size=(k, 3))))
    rad = unit(pos[k:2 * k])
    d[k:2 * k] = unit(limb * np.sqrt(1 - (rf[0] / r[k:2 * k]) ** 2)[:, None]
                      - rad * (rf[0] / r[k:2 * k])[:, None])
    return rf, pos / np.array([1.0 - ob, 1.0 - ob, 1.0]), d


@pytest.mark.parametrize("nr,ob", [(1, 0.0), (5, 0.0), (5, 0.08)])
def test_radial_walks(nr, ob):
    rs = np.random.default_rng(nr + int(ob * 100))
    rf, pos, d = _rays(nr, ob, rs)
    kx = rs.uniform(50.0, 3000.0, nr)
    kx[nr // 2] = 0.0 if nr > 1 else kx[0]        # a clear shell: k_safe path
    a2 = b2 = (1.0 - ob) ** 2
    c2 = 1.0
    floor = rf[1] if nr > 1 else rf[0]
    peps = 1e-15 / 7.1e7
    pj = [J(pos[:, i]) for i in range(3)] + [J(d[:, i]) for i in range(3)]
    pt = [T(pos[:, i]) for i in range(3)] + [T(d[:, i]) for i in range(3)]
    rfj = [np.float64(v) for v in rf]
    kxj = [np.float64(v) for v in kx]

    ej, hj, sj, ssj = JRAD.ray_chords(a2, b2, c2, rfj, floor, peps, *pj)
    et, ht, st, sst = TRAD.ray_chords(a2, b2, c2, T(rf), T(floor), peps, *pt)
    close(np.stack(ej, -1), et)
    close(np.stack(hj, -1), ht)
    equal(sj, st)
    close(ssj, sst)
    assert st.any() and not st.all()             # both floor hits and misses

    wj = JRAD.tau_walk(a2, b2, c2, rfj, kxj, floor, peps, *pj)
    wt = TRAD.tau_walk(a2, b2, c2, T(rf), T(kx), T(floor), peps, *pt)
    close(wj["tau"], wt["tau"])
    for key in ("exited", "surface", "err"):
        equal(wj[key], wt[key])

    tau = rs.exponential(2.0, pos.shape[0])
    active = rs.uniform(size=pos.shape[0]) < 0.9
    mj = JRAD.march(a2, b2, c2, rfj, kxj, floor, peps, *pj, J(tau),
                    jnp.asarray(active), jnp.int32)
    mt = TRAD.march(a2, b2, c2, T(rf), T(kx), T(floor), peps, *pt, T(tau),
                    torch.as_tensor(active))
    for key in ("s_stop", "tau_surf"):
        close(mj[key], mt[key])
    for key in ("cr", "inter", "exited", "surface"):
        equal(mj[key], mt[key])
    assert mt["inter"].any() and mt["exited"].any() and mt["surface"].any()


def _stokes(rs, n):
    st = np.stack([rs.uniform(0.5, 2.0, n), rs.uniform(-0.4, 0.4, n),
                   rs.uniform(-0.4, 0.4, n), rs.uniform(-0.1, 0.1, n)], -1)
    st[: n // 8, 1:] = 0.0                                  # unpolarized
    return st


def test_mueller_functions():
    rs = np.random.default_rng(3)
    n = 500
    st = _stokes(rs, n)
    c2p = rs.uniform(-1, 1, n)
    s2p = np.sqrt(1 - c2p ** 2) * rs.choice([-1, 1], n)
    close(JM.mueller_rotate_cs(J(st), J(c2p), J(s2p)),
          TM.mueller_rotate_cs(T(st), T(c2p), T(s2p)))
    psi = rs.uniform(0, np.pi, n)
    close(JM.mueller_rotate(J(st), J(psi)), TM.mueller_rotate(T(st), T(psi)))
    mat = rs.normal(size=(n, 4, 4))
    close(JM.apply_scatter(J(mat), J(st)), TM.apply_scatter(T(mat), T(st)))

    d = unit(rs.normal(size=(n, 3)))
    d[:4] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, -1, 0]]   # poles: degenerate basis
    alpha = rs.uniform(-0.999, 0.999, n)
    beta = rs.uniform(1e-6, 2 * np.pi, n)
    dn_j = JM.direction_cosine(J(alpha), J(beta), J(d))
    dn_t = TM.direction_cosine(T(alpha), T(beta), T(d))
    close(dn_j, dn_t)
    for peeling in (False, True):
        close(JM.polarization_rotation(J(alpha), J(beta), J(st), J(mat), J(d), dn_j, peeling),
              TM.polarization_rotation(T(alpha), T(beta), T(st), T(mat), T(d), dn_t, peeling))
    trig = (np.cos(2 * beta), np.sin(2 * beta))
    sign = np.where(beta < np.pi, 1.0, -1.0)
    close(JM.polarization_rotation(J(alpha), None, J(st), J(mat), J(d), dn_j, True,
                                   beta_trig=(J(trig[0]), J(trig[1])), beta_sign=J(sign)),
          TM.polarization_rotation(T(alpha), None, T(st), T(mat), T(d), dn_t, True,
                                   beta_trig=(T(trig[0]), T(trig[1])), beta_sign=T(sign)))
    for axis in range(3):
        close(JM.rotation_matrix(axis, J(beta)), TM.rotation_matrix(axis, T(beta)))


@pytest.fixture(scope="module")
def cloud_tables():
    """Per-cell matrices that differ between cells: an HG cloud deck over
    Rayleigh gas (5 radial cells)."""
    atm = presets.hg_cloud_deck(tau=3.0, g=0.7, nr=5)
    ray = presets.rayleigh_single_layer(tau=1.0, nr=5, wavelengths=(0.8,))
    scat = atm.scatter[:, 0, 0, 0].copy()
    scat[::2] = ray.scatter[::2, 0, 0, 0]
    pint = np.einsum("cae,a->ce", scat[..., :4], SINBETA * np.pi / 180.0)
    return scat.reshape(-1, 16), JS.build_alpha_prefix(scat), pint


def test_alpha_prefix_and_sincos(cloud_tables):
    rows, prefix, _ = cloud_tables
    np.testing.assert_array_equal(TS.build_alpha_prefix(rows.reshape(5, 180, 16)), prefix)
    rs = np.random.default_rng(4)
    delta = rs.uniform(0, np.pi / 16, 300)
    k = rs.integers(0, 16, 300)
    sj = JS.sincos_2beta(J(delta), J(JS.BETA_EDGE_SIN2[k]), J(JS.BETA_EDGE_COS2[k]))
    stt = TS.sincos_2beta(T(delta), T(TS.BETA_EDGE_SIN2[k]), T(TS.BETA_EDGE_COS2[k]))
    close(sj[0], stt[0])
    close(sj[1], stt[1])


def test_samplers_and_matrix(cloud_tables):
    rows, prefix, pint = cloud_tables
    rs = np.random.default_rng(6)
    n = 800
    st = _stokes(rs, n)
    cell = rs.integers(0, 5, n)
    u = rs.uniform(1e-9, 1 - 1e-9, (4, n))
    bj = JS.sample_beta(J(pint[cell]), J(st), J(u[0]), J(u[1]))
    bt = TS.sample_beta(T(pint[cell]), T(st), T(u[0]), T(u[1]))
    for r, g in zip(bj, bt):
        close(r, g)
    aj = JS.sample_alpha_fused(J(prefix), jnp.asarray(cell, jnp.int32), J(st), bj[1:], J(u[2]))
    at = TS.sample_alpha_fused(T(prefix), torch.as_tensor(cell), T(st), bt[1:], T(u[2]))
    for r, g in zip(aj, at):
        close(r, g)
    equal(np.floor(np.asarray(aj[1])), torch.floor(at[1]))   # the sampled bin
    close(JS.matrix_at_angle_deg(J(rows), jnp.asarray(cell, jnp.int32), aj[1]),
          TS.matrix_at_angle_deg(T(rows), torch.as_tensor(cell), at[1]))
    ang = rs.uniform(0, np.pi, n)
    ang[:3] = [0.0, np.pi, 0.25 * np.pi / 180]                # clamped ends
    close(JS.matrix_at_angle(J(rows), jnp.asarray(cell, jnp.int32), J(ang)),
          TS.matrix_at_angle(T(rows), torch.as_tensor(cell), T(ang)))
