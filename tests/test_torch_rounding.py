"""The plain version's float32 geometry rounds as compiled code does.

XLA (and nvcc, for the CUDA kernels) contracts the reference's float32
geometry into chains of fused multiply-adds; the plain PyTorch version,
which runs one operation at a time, emulates those chains
(``geometry.fmadd``). On a few thousand numpy-seeded states on and near the
radial, theta and phi faces of the nr=39 graded grid and of the 39 x 8 x 8
deck (``cells.hydrostatic39``, ``cells.grid3d_2496``), each of these chains
equals bit for bit the reference's own expression compiled by ``jax.jit`` on
the CPU:

* the sphere quadratic's constant term ``qc``
  (``artes_tpu/transport/geometry.py:194``), its ``qa`` and ``qb`` (:192-193)
  and the discriminant (:165);
* the cone quadratic (:210-212) and the nappe test's ``z + s nz`` (:216);
* the phi half-plane distance (:232-236, a division of two chains);
* the jump walk's ray quadratic, ``Cq - r^2`` and its discriminant
  (``artes_tpu/transport/jumps.py:145-147``, ``radial.py:88-89``);
* ``x^2 + y^2 + z^2`` of ``heal_cell`` and ``locate_cell`` (:434, :454) and
  the emission's ``1 - disk1^2 - disk2^2`` (``artes_tpu/transport/kernel.py:448``).

Two chains follow nvcc, not XLA: the walks' position update ``p + s d``
(``artes_tpu/transport/kernel.py:316``) and the march's interaction test
``tau_run + dist k`` (:737; its running sum stays op by op). The kernels
write both fused, component by component. For these two the test compiles
an isolated expression, each component of the update on its own axis and
``s + a b`` alone, not the reference's fragment in its context: XLA's
vectorised loop over the reference's (B, 3) update leaves one column op by
op on the CPU, and in the march ``tau_cell`` also feeds the running sum. So
these two cases show that the port's chains are the fused ones nvcc
writes, not that XLA rounds the reference so.

Float64 rounds op by op, as before: the same functions at float64 equal the
reference run op by op (``jax.disable_jit``), bit for bit, and the whole
``cell_face`` at float64 gives what it gave before, bit for bit (a hash of
its outputs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artes_tpu.transport import geometry as JG
from artes_tpu_torch import cells
from artes_tpu_torch.transport import geometry as TG
from artes_tpu_torch.transport import jumps as TJ
from artes_tpu_torch.transport import kernel as TK
from torch_threads import one_thread  # noqa: F401

N = 4096
GRIDS = {"hydrostatic39": cells.hydrostatic39, "grid3d_2496": cells.grid3d_2496}


def near_faces(atm, n, seed, dtype):
    """``(pos, dirn, r_face, tan_t, sin_p, cos_p, s)`` of ``n`` states on or
    within a few float32 ulps of a face of ``atm`` (lengths scaled by the
    outer radius): a point on a random radial face, nudged, with a random
    direction; the radius, cone tangent and phi face of a random face of
    the grid; a random path length."""
    rng = np.random.default_rng(seed)
    rf = np.asarray(atm.rfront, np.float64) / float(atm.rfront[-1])
    r_face = rf[rng.integers(0, len(rf), n)]
    r = r_face * (1.0 + rng.integers(-4, 5, n) * 6e-8)
    mu = rng.uniform(-1.0, 1.0, n)
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    st = np.sqrt(1.0 - mu * mu)
    pos = np.stack([r * st * np.cos(phi), r * st * np.sin(phi), r * mu], axis=-1)
    dirn = rng.normal(size=(n, 3))
    dirn /= np.linalg.norm(dirn, axis=-1, keepdims=True)
    theta = np.deg2rad(np.asarray(atm.thetafront, np.float64))
    tan_t = np.tan(theta[rng.integers(0, len(theta), n)])
    tan_t = np.where(np.abs(tan_t) > 1e6, 1.0, tan_t)
    phis = np.deg2rad(np.asarray(atm.phifront, np.float64)) if atm.nphi > 1 else \
        np.zeros(1)
    face = phis[rng.integers(0, len(phis), n)]
    s = rng.uniform(0.0, 2e-3, n)
    return tuple(np.asarray(v, dtype) for v in (pos, dirn, r_face, tan_t, np.sin(face),
                                                np.cos(face), s))


def grids(atm, dtype):
    jg = JG.make_grid_geometry(atm, 0.0, dtype=jnp.float32 if dtype == np.float32
                               else jnp.float64)[0]
    tg = TG.make_grid_geometry(atm, 0.0, dtype=torch.float32 if dtype == np.float32
                               else torch.float64)[0]
    return jg, tg


# the reference's expressions, as written in artes_tpu/transport/geometry.py
# (:192-194, :165, :210-212, :216, :232-236), jumps.py (:145-147), radial.py
# (:88-89) and kernel.py (:316, :448, :737)
def ref_sphere(g, pos, dirn, r_face):
    a, b, c = g.ob_ax, g.ob_by, g.ob_cz
    x, y, z = pos[..., 0], pos[..., 1], pos[..., 2]
    nx, ny, nz = dirn[..., 0], dirn[..., 1], dirn[..., 2]
    qa = a * a * nx * nx + b * b * ny * ny + c * c * nz * nz
    qb = 2.0 * (a * a * x * nx + b * b * y * ny + c * c * z * nz)
    qc = a * a * x * x + b * b * y * y + c * c * z * z - r_face * r_face
    return qa, qb, qc


def ref_cone(g, pos, dirn, tan_t):
    a, b, c = g.ob_ax, g.ob_by, g.ob_cz
    x, y, z = pos[..., 0], pos[..., 1], pos[..., 2]
    nx, ny, nz = dirn[..., 0], dirn[..., 1], dirn[..., 2]
    t2 = tan_t * tan_t
    qa = a * a * nx * nx + b * b * ny * ny - c * c * nz * nz * t2
    qb = 2.0 * (a * a * x * nx + b * b * y * ny - c * c * z * nz * t2)
    qc = a * a * x * x + b * b * y * y - c * c * z * z * t2
    return qa, qb, qc


def ref_radial(g, pos, dirn):
    a2, b2, c2 = g.ob_ax * g.ob_ax, g.ob_by * g.ob_by, g.ob_cz * g.ob_cz
    px, py, pz = pos[..., 0], pos[..., 1], pos[..., 2]
    dx, dy, dz = dirn[..., 0], dirn[..., 1], dirn[..., 2]
    A = a2 * dx * dx + b2 * dy * dy + c2 * dz * dz
    Bq = a2 * px * dx + b2 * py * dy + c2 * pz * dz
    Cq = a2 * px * px + b2 * py * py + c2 * pz * pz
    return A, Bq, Cq


def ref_chord(A, Bq, Cq, r_face):
    Cj = Cq - r_face * r_face
    disc = Bq * Bq - A * Cj
    return Cj, disc


def flat(x):
    """``x`` as one axis: the position update is compared component by
    component, the chain nvcc writes for each (XLA's vectorised loop over a
    (B, 3) array leaves one column op by op on the CPU)."""
    return x.reshape(-1)


# name: (the reference's computation on the JAX grid, the port's on its grid),
# each of (pos, dirn, r_face, tan_t, sin_p, cos_p, s) and returning a tuple
CHAINS = {
    "sphere qa, qb, qc": (
        lambda g, p, d, r, t, sp, cp, s: ref_sphere(g, p, d, r),
        lambda g, p, d, r, t, sp, cp, s: TG.sphere_quadratic(g, p, d, r)),
    "discriminant": (
        lambda g, p, d, r, t, sp, cp, s: (p[..., 1] * p[..., 1] - 4.0 * p[..., 0] * p[..., 2],),
        lambda g, p, d, r, t, sp, cp, s: (TG.discriminant(p[..., 0], p[..., 1], p[..., 2]),)),
    "cone qa, qb, qc": (
        lambda g, p, d, r, t, sp, cp, s: ref_cone(g, p, d, t),
        lambda g, p, d, r, t, sp, cp, s: TG.cone_quadratic(g, p, d, t * t)),
    "nappe z": (
        lambda g, p, d, r, t, sp, cp, s: (p[..., 2] + s * d[..., 2],),
        lambda g, p, d, r, t, sp, cp, s: (TG.fmadd(s, d[..., 2], p[..., 2]),)),
    "phi half-plane": (
        lambda g, p, d, r, t, sp, cp, s: (JG._phi_plane_distance(g, p, d, sp, cp, 0.0),),
        lambda g, p, d, r, t, sp, cp, s: (TG._phi_plane_distance(g, p, d, sp, cp, 0.0),)),
    "jump walk quadratic": (
        lambda g, p, d, r, t, sp, cp, s: ref_radial(g, p, d),
        lambda g, p, d, r, t, sp, cp, s: TJ.quad_terms(
            g.ob_ax * g.ob_ax, g.ob_by * g.ob_by, g.ob_cz * g.ob_cz, *p.unbind(-1),
            *d.unbind(-1))),
    "jump walk Cj, disc": (
        lambda g, p, d, r, t, sp, cp, s: ref_chord(p[..., 0], p[..., 1], p[..., 2], r),
        lambda g, p, d, r, t, sp, cp, s: TJ.chord_disc(p[..., 0], p[..., 1], p[..., 2], r)),
    "norm2": (
        lambda g, p, d, r, t, sp, cp, s: (p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1]
                                          + p[..., 2] * p[..., 2],),
        lambda g, p, d, r, t, sp, cp, s: (TG.norm2(*p.unbind(-1)),)),
    "emission depth": (
        lambda g, p, d, r, t, sp, cp, s: (1.0 - d[..., 0] * d[..., 0] - d[..., 1] * d[..., 1],),
        lambda g, p, d, r, t, sp, cp, s: (TK.disk_depth2(d[..., 0], d[..., 1]),)),
    "march interaction": (
        lambda g, p, d, r, t, sp, cp, s: (s + d[..., 0] * d[..., 1],),
        lambda g, p, d, r, t, sp, cp, s: (TG.fmadd(d[..., 0], d[..., 1], s),)),
    "position update": (
        lambda g, p, d, r, t, sp, cp, s: (flat(p) + flat(s[..., None] + 0.0 * d) * flat(d),),
        lambda g, p, d, r, t, sp, cp, s: (TG.fmadd(s[:, None], d, p).reshape(-1),)),
}


def both(name, grid_name, dtype, seed, compiled):
    """The reference's and the port's results of chain ``name`` on the same
    states, as numpy: the reference compiled by ``jax.jit`` or op by op."""
    atm = GRIDS[grid_name]()
    jg, tg = grids(atm, dtype)
    args = near_faces(atm, N, seed, dtype)
    ref_fn, port_fn = CHAINS[name]
    fn = lambda *a: ref_fn(jg, *a)
    if compiled:
        ref = jax.jit(fn)(*(jnp.asarray(a) for a in args))
    else:
        with jax.disable_jit():
            ref = fn(*(jnp.asarray(a) for a in args))
    got = port_fn(tg, *(torch.from_numpy(a) for a in args))
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


@pytest.mark.parametrize("grid_name", sorted(GRIDS))
@pytest.mark.parametrize("name", sorted(CHAINS))
def test_float32_chain_equals_xla_compiled(name, grid_name):
    ref, got = both(name, grid_name, np.float32, 11, compiled=True)
    for r, g in zip(ref, got):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_float64_chain_rounds_op_by_op(name):
    ref, got = both(name, "grid3d_2496", np.float64, 12, compiled=False)
    for r, g in zip(ref, got):
        assert g.dtype == np.float64
        np.testing.assert_array_equal(g, r)


def test_float32_chains_differ_from_op_by_op():
    """The states are ones where the rounding matters: op by op, the
    reference's ``qc`` differs from the compiled one on many of them."""
    compiled, _ = both("sphere qa, qb, qc", "grid3d_2496", np.float32, 11, compiled=True)
    eager, _ = both("sphere qa, qb, qc", "grid3d_2496", np.float32, 11, compiled=False)
    assert (compiled[2] != eager[2]).mean() > 0.05


# sha256 of the float64 cell_face outputs of cell_face_hash, as the plain
# version computed them before it rounded float32 in chains
CELL_FACE_F64_SHA256 = "f416a5be8cc924bfc0f0fdd864c8a136a5d891ed1367d9e38847d8c7676dfe95"


def cell_face_hash():
    """sha256 of ``cell_face``'s distances, next faces, next cells and
    errors at float64, three passes from the states of both grids."""
    import hashlib
    h = hashlib.sha256()
    for name in sorted(GRIDS):
        atm = GRIDS[name]()
        tg = TG.make_grid_geometry(atm, 0.0, dtype=torch.float64)[0]
        pos, dirn = near_faces(atm, N, 13, np.float64)[:2]
        r = np.linalg.norm(pos, axis=-1)
        ir = np.clip(np.searchsorted(np.asarray(tg.rfront), r) - 1, 0, atm.nr - 1)
        cell = TG.locate_cell(tg, torch.from_numpy(pos), torch.from_numpy(ir))
        face = torch.zeros((N, 2), dtype=torch.int64)
        for _ in range(3):
            out = TG.cell_face(tg, torch.from_numpy(pos), torch.from_numpy(dirn), cell, face,
                               torch.tensor(0))
            for key in ("distance", "next_face", "cell_out", "error"):
                h.update(out[key].numpy().tobytes())
            pos = pos + out["distance"].numpy()[:, None] * dirn
            cell, face = out["cell_out"].clamp(0, None), out["next_face"]
            cell[:, 0] = cell[:, 0].clamp(0, atm.nr - 1)
    return h.hexdigest()


def test_float64_cell_face_unchanged():
    """The whole float64 ``cell_face`` is bit for bit what it was before
    float32 took the fused chains, over three passes from the states of both
    grids: its outputs hash as they did."""
    assert cell_face_hash() == CELL_FACE_F64_SHA256
