# Frozen copy of artes_tpu_torch/transport/geometry.py at commit bba47c3; only its imports
# are renamed. The benchmark's reference: it imports nothing of artes_tpu_torch.
"""Grid geometry tables, the cell lookups and the 3-D traversal step.

Counterpart of ``artes_tpu.transport.geometry``: :class:`GridGeometry`
holds the grid tables as tensors on one device, in lengths scaled by the
outer radius. The epsilon tiers follow the ``dtype`` argument alone (float64
runs take the reference's scaled thresholds, float32 runs the floors matched
to f32 resolution).

:func:`cell_face` is one traversal step of a photon batch through the
(r, theta, phi) cells (ARTES.f90:2800-3470): radial faces are concentric
(oblate-scaled) ellipsoids, theta faces cones with wrong-nappe rejection
(the theta = 90 deg face degenerates to the z = 0 plane), phi faces planes
through the z-axis; the candidate selection keeps the reference's two-tier
epsilon fallback and its looser same-face threshold. Faces are encoded as
``(axis, index)`` with axis 0 = none, 1 = radial, 2 = theta, 3 = phi.
"""

from __future__ import annotations

import dataclasses

import math

import numpy as np
import torch

BIG = 1.0e30


@dataclasses.dataclass
class GridGeometry:
    """Grid tables on one device (lengths scaled by the outer radius)."""

    rfront: torch.Tensor          # (nr+1,)
    theta_tan: torch.Tensor       # (ntheta+1,)
    theta_cos: torch.Tensor       # (ntheta+1,)
    thetaplane_cone: torch.Tensor  # (ntheta+1,) bool: cone, else z=0 plane
    theta_above: torch.Tensor     # (ntheta+1,) bool: theta < pi/2
    phi_sin: torch.Tensor         # (nphi,)
    phi_cos: torch.Tensor         # (nphi,)
    r_pair: torch.Tensor          # (nr, 2): rfront[i], rfront[i+1]
    theta_combo: torch.Tensor     # (ntheta, 6)
    phi_combo: torch.Tensor       # (nphi, 4)
    nr: int
    ntheta: int
    nphi: int
    ob_ax: float                  # 1/oblate_x etc. (ARTES.f90:2838-2840)
    ob_by: float
    ob_cz: float
    pos_eps: float                # root validity threshold
    same_eps: float               # same-face root threshold
    sel1: float                   # primary selection tier
    sel2: float                   # fallback selection tier
    boundary_tol: float           # no-candidate boundary-rescue tolerance


def make_grid_geometry(atm, oblateness=0.0, dtype=torch.float64,
                       device="cpu") -> tuple[GridGeometry, float]:
    """Grid tables from a host :class:`~artes_tpu.atmosphere.Atmosphere`.

    Returns ``(grid, r_scale)`` with ``r_scale`` the outer radius in metres.
    """
    r_scale = float(atm.rfront[-1])
    f64 = dtype == torch.float64
    theta = np.asarray(atm.thetafront)
    rf = np.asarray(atm.rfront) / r_scale
    cone = (atm.thetaplane == 1).astype(float)
    above = (theta < np.pi / 2.0).astype(float)
    theta_combo = np.stack([
        atm.theta_tan[:-1], cone[:-1], above[:-1],
        atm.theta_tan[1:], cone[1:], above[1:],
    ], axis=1)
    nxt = (np.arange(atm.nphi) + 1) % atm.nphi
    phi_combo = np.stack([atm.phi_sin, atm.phi_cos,
                          atm.phi_sin[nxt], atm.phi_cos[nxt]], axis=1)

    def t(x):
        return torch.as_tensor(np.array(x, np.float64, order="C"), dtype=dtype, device=device)

    def b(x):
        return torch.as_tensor(np.asarray(x, bool), device=device)

    grid = GridGeometry(
        rfront=t(rf),
        theta_tan=t(atm.theta_tan),
        theta_cos=t(atm.theta_cos),
        thetaplane_cone=b(atm.thetaplane == 1),
        theta_above=b(theta < np.pi / 2.0),
        phi_sin=t(atm.phi_sin),
        phi_cos=t(atm.phi_cos),
        r_pair=t(np.stack([rf[:-1], rf[1:]], axis=1)),
        theta_combo=t(theta_combo),
        phi_combo=t(phi_combo),
        nr=atm.nr, ntheta=atm.ntheta, nphi=atm.nphi,
        # a = 1/oblate_x with oblate_x = 1/(1-oblateness) (ARTES.f90:469-471)
        ob_ax=1.0 - oblateness,
        ob_by=1.0 - oblateness,
        ob_cz=1.0,
        # the reference's absolute thresholds [m], scaled; float32 floors
        # them at values matched to ~1e-7 relative precision
        pos_eps=(1.0e-15 / r_scale) if f64 else 1.0e-12,
        same_eps=(1.0e-3 / r_scale) if f64 else max(1.0e-3 / r_scale, 3.0e-6),
        sel1=(1.0e-9 / r_scale) if f64 else max(1.0e-9 / r_scale, 1.0e-6),
        sel2=(1.0e-12 / r_scale) if f64 else max(1.0e-12 / r_scale, 1.0e-7),
        boundary_tol=1.0e-12 if f64 else 4.0e-7,
    )
    return grid, r_scale


def fmadd(a, b, c):
    """``a * b + c``. In float32 rounded once, as a fused multiply-add: XLA
    and nvcc contract the reference's float32 geometry into such chains, and
    their rounding decides which walks graze a face (PERF.md). The product
    is exact in float64 and the sum is rounded to float64, then to float32;
    the two roundings differ from one only where the float64 sum falls on a
    float32 tie. In float64 op by op, as before."""
    if a.dtype != torch.float32:
        return a * b + c
    return (a.double() * b.double() + c.double()).float()


def norm2(x, y, z):
    """``x^2 + y^2 + z^2`` as the chain ``fma(z, z, fma(x, x, y y))``."""
    return fmadd(z, z, fmadd(x, x, y * y))


def _form(g: GridGeometry, u, v):
    """``a^2 u_x v_x + b^2 u_y v_y + c^2 u_z v_z`` as the chain
    ``fma(c^2 u_z, v_z, fma(a^2 u_x, v_x, b^2 u_y v_y))``."""
    a, b, c = g.ob_ax, g.ob_by, g.ob_cz
    ux, uy, uz = u.unbind(-1)
    vx, vy, vz = v.unbind(-1)
    return fmadd(c * c * uz, vz, fmadd(a * a * ux, vx, b * b * uy * vy))


def sphere_qc(g: GridGeometry, pos, r_face):
    """Constant term of the sphere quadratic, ``a^2 x^2 + b^2 y^2 + c^2 z^2 -
    r^2``: ``fma(-r, r, fma(c^2 z, z, fma(a^2 x, x, b^2 y y)))`` in float32."""
    return fmadd(-r_face, r_face, _form(g, pos, pos))


def discriminant(qa, qb, qc):
    """``qb^2 - 4 qa qc``: ``fma(qb, qb, -(4 qa qc))`` in float32."""
    return fmadd(qb, qb, -(4.0 * qa * qc))


def _quadratic(qa, qb, qc):
    """Numerically stable quadratic roots, q-form (ARTES.f90:4154-4173).
    Returns ``(s1, s2)``; absent roots are 0 (the reference's sentinel)."""
    disc = discriminant(qa, qb, qc)
    ok = disc >= 0.0
    sqrt_disc = torch.sqrt(torch.where(ok, disc, 0.0))
    q = -0.5 * (qb + torch.sign(qb) * sqrt_disc)
    q = torch.where(qb == 0.0, -0.5 * sqrt_disc, q)     # sign(0) = 0 guard
    s1 = torch.where(ok & (qa.abs() > 1.0e-100), q / torch.where(qa == 0, 1.0, qa), 0.0)
    s2 = torch.where(ok & (q.abs() > 1.0e-100), qc / torch.where(q == 0, 1.0, q), 0.0)
    return s1, s2


def _pick_root(s1, s2, eps):
    """The smallest root above ``eps`` (ARTES.f90:2897-2907), else 0."""
    v1 = (s1 > eps) & (s1 < BIG)
    v2 = (s2 > eps) & (s2 < BIG)
    return torch.where(v1 & v2, torch.minimum(s1, s2),
                       torch.where(v1, s1, torch.where(v2, s2, 0.0)))


def sphere_quadratic(g: GridGeometry, pos, dirn, r_face):
    """``(qa, qb, qc)`` of the (oblate) sphere of scaled radius ``r_face``
    along the ray, each a chain of fused multiply-adds in float32."""
    return _form(g, dirn, dirn), 2.0 * _form(g, pos, dirn), sphere_qc(g, pos, r_face)


def _sphere_distance(g: GridGeometry, pos, dirn, r_face, eps):
    """Distance to the (oblate) sphere of scaled radius ``r_face``."""
    return _pick_root(*_quadratic(*sphere_quadratic(g, pos, dirn, r_face)), eps)


def cone_quadratic(g: GridGeometry, pos, dirn, t2):
    """``(qa, qb, qc)`` of the cone ``a^2 x^2 + b^2 y^2 = c^2 z^2 t2`` along
    the ray, each a chain of fused multiply-adds in float32."""
    a, b, c = g.ob_ax, g.ob_by, g.ob_cz
    x, y, z = pos.unbind(-1)
    nx, ny, nz = dirn.unbind(-1)
    qa = fmadd(-(c * c * nz * nz), t2, fmadd(a * a * nx, nx, b * b * ny * ny))
    qb = 2.0 * fmadd(-(c * c * z * nz), t2, fmadd(a * a * x, nx, b * b * y * ny))
    qc = fmadd(-(c * c * z * z), t2, fmadd(a * a * x, x, b * b * y * y))
    return qa, qb, qc


def _cone_distance(g: GridGeometry, pos, dirn, tan_t, above, eps):
    """Distance to a theta cone with wrong-nappe rejection, and to the
    z = 0 plane: ``(d_cone, s_plane)``. ``tan_t`` and ``above`` (theta_f <
    pi/2) are the per-photon face properties."""
    z, nz = pos[..., 2], dirn[..., 2]
    s1, s2 = _quadratic(*cone_quadratic(g, pos, dirn, tan_t * tan_t))

    def nappe_ok(s):
        z_test = fmadd(s, nz, z)
        # roots on the wrong nappe are rejected (ARTES.f90:3038-3051)
        wrong = ((z_test > 0.0) & ~above) | ((z_test < 0.0) & above)
        return torch.where((s > g.pos_eps) & wrong, 0.0, s)

    d_cone = _pick_root(nappe_ok(s1), nappe_ok(s2), eps)
    s_plane = -z / torch.where(nz == 0.0, 1.0, nz)
    return d_cone, s_plane


def _phi_plane_distance(g: GridGeometry, pos, dirn, sin_p, cos_p, eps):
    """Distance to a phi half-plane (ARTES.f90:3300-3318)."""
    a, b = g.ob_ax, g.ob_by
    x, y = pos[..., 0], pos[..., 1]
    nx, ny = dirn[..., 0], dirn[..., 1]
    denom = fmadd(b * ny, cos_p, -(a * nx * sin_p))
    s = fmadd(a * x, sin_p, -(b * y * cos_p)) / torch.where(denom == 0.0, 1.0, denom)
    valid = (denom.abs() > 0.0) & (s > eps) & (s < BIG)
    return torch.where(valid, s, 0.0)


def cell_face(g: GridGeometry, pos, dirn, cell, cur_face, cell_depth):
    """One traversal step for a batch of photons.

    ``pos``, ``dirn``: (B, 3); ``cell``: (B, 3) integer (ir, itheta, iphi);
    ``cur_face``: (B, 2) integer (axis, index); ``cell_depth``: the photon
    floor radial face. Returns ``next_face`` (B, 2), ``distance``,
    ``cell_out`` (B, 3), ``grid_exit``, ``error``, ``err_nocand`` (error
    031: no candidate face) and ``err_degen`` (error 034: degenerate
    surface bounce)."""
    cr, ct, cp = cell.unbind(-1)
    axis, fidx = cur_face.unbind(-1)
    cur_r, cur_t, cur_p = axis == 1, axis == 2, axis == 3
    pos_eps, same_eps = g.pos_eps, g.same_eps
    zero = torch.zeros_like(pos[..., 0])

    def eps_of(same):
        return torch.where(same, torch.full_like(zero, same_eps), torch.full_like(zero, pos_eps))

    # ---- radial candidates: the inner sphere is skipped when the photon
    # just crossed it moving outward (ARTES.f90:2909-2931); the outer one
    # is the "same face" with the looser threshold after an inward crossing
    # (:2933-2954) ----
    rp = g.r_pair[cr]
    r_in_active = ~(cur_r & (cr == fidx))
    d_r_in = torch.where(r_in_active, _sphere_distance(g, pos, dirn, rp[..., 0], pos_eps), 0.0)
    r_same = cur_r & (cr == fidx - 1)
    d_r_out = _sphere_distance(g, pos, dirn, rp[..., 1], eps_of(r_same))

    # ---- theta candidates (none on a grid with one polar cell) ----
    if g.ntheta > 1:
        tc = g.theta_combo[ct]
        tan_in, cone_in, above_in = tc[..., 0], tc[..., 1] > 0.5, tc[..., 2] > 0.5
        tan_out, cone_out, above_out = tc[..., 3], tc[..., 4] > 0.5, tc[..., 5] > 0.5
        nz = dirn[..., 2]
        t_in_same = cur_t & (ct == fidx) & ~above_in
        t_in_active = (ct > 0) & (~cur_t | (cur_t & (ct == fidx - 1)) | t_in_same)
        d_cone_in, s_plane_in = _cone_distance(g, pos, dirn, tan_in, above_in,
                                               eps_of(t_in_same))
        # the plane as inner face is crossed moving up (ARTES.f90:3068)
        d_plane_in = torch.where((s_plane_in > 0.0) & (nz > pos_eps), s_plane_in, 0.0)
        d_t_in = torch.where(t_in_active, torch.where(cone_in, d_cone_in, d_plane_in), 0.0)

        t_out_same = cur_t & (ct == fidx - 1) & above_out
        t_out_active = (ct + 1 < g.ntheta) & (~cur_t | (cur_t & (ct == fidx)) | t_out_same)
        d_cone_out, s_plane_out = _cone_distance(g, pos, dirn, tan_out, above_out,
                                                 eps_of(t_out_same))
        d_plane_out = torch.where((s_plane_out > 0.0) & (nz < -pos_eps), s_plane_out, 0.0)
        d_t_out = torch.where(t_out_active, torch.where(cone_out, d_cone_out, d_plane_out), 0.0)
    else:
        d_t_in = d_t_out = zero

    # ---- phi candidates ----
    if g.nphi > 1:
        pc = g.phi_combo[cp]
        p_outer_idx = torch.where(cp + 1 == g.nphi, 0, cp + 1)
        p_inward = cur_p & ((cp == fidx - 1) | ((cp == g.nphi - 1) & (fidx == 0)))
        p_outward = cur_p & (cp == fidx) & ~p_inward
        d_p_in = torch.where(~cur_p | p_inward,
                             _phi_plane_distance(g, pos, dirn, pc[..., 0], pc[..., 1], pos_eps),
                             0.0)
        d_p_out = torch.where(~cur_p | p_outward,
                              _phi_plane_distance(g, pos, dirn, pc[..., 2], pc[..., 3], pos_eps),
                              0.0)
    else:
        p_outer_idx = torch.zeros_like(cp)
        d_p_in = d_p_out = zero

    # ---- selection: two-tier epsilon (ARTES.f90:3356-3418); candidates in
    # the reference's scan order: r, theta, phi inward, then outward ----
    dists = torch.stack([d_r_in, d_t_in, d_p_in, d_r_out, d_t_out, d_p_out], dim=-1)
    axes = torch.tensor([1, 2, 3, 1, 2, 3], dtype=cr.dtype, device=cr.device)
    faces = torch.stack([cr, ct, cp, cr + 1, ct + 1, p_outer_idx], dim=-1)

    def select(tier_eps):
        dist, best = torch.where(dists > tier_eps, dists, BIG).min(dim=-1)
        return best, dist

    best1, dist1 = select(g.sel1)
    best2, dist2 = select(g.sel2)
    use_fallback = dist1 >= BIG
    best = torch.where(use_fallback, best2, best1)
    distance = torch.where(use_fallback, dist2, dist1)
    no_candidate = distance >= BIG
    distance = torch.where(no_candidate, 0.0, distance)

    # No-candidate rescue: float32 roundoff can land a photon on (or an
    # epsilon past) a radial boundary, where the sphere quadratic yields no
    # root although the photon is crossing. Resolved by position: on or
    # over the outer face moving outward is a grid exit, on or under the
    # photon floor moving inward a floor hit.
    rho2 = _form(g, pos, pos)
    rad_dot = _form(g, pos, dirn)
    tol = g.boundary_tol
    r_outer = g.rfront[g.nr]
    on_outer = no_candidate & (rho2 >= (r_outer * (1.0 - tol)) ** 2) & (rad_dot > 0.0)
    r_floor = g.rfront[cell_depth]
    on_floor = (no_candidate & ~on_outer & (rho2 <= (r_floor * (1.0 + tol)) ** 2)
                & (rad_dot < 0.0) & (cr == cell_depth))
    rescued = on_outer | on_floor
    error = no_candidate & ~rescued

    next_axis = axes[best]
    next_idx = faces.gather(-1, best.unsqueeze(-1))[..., 0]
    next_axis = torch.where(rescued, 1, next_axis)
    next_idx = torch.where(on_outer, g.nr, torch.where(on_floor, cell_depth, next_idx))

    # ---- next cell (ARTES.f90:2671-2798) ----
    outward = torch.where(rescued, on_outer, best >= 3)
    cr_out = torch.where(next_axis == 1, torch.where(outward, cr + 1, cr - 1), cr)
    ct_out = torch.where(next_axis == 2, torch.where(outward, ct + 1, ct - 1), ct)
    cp_next = torch.where(outward, cp + 1, cp - 1)
    cp_next = torch.where(cp_next < 0, g.nphi - 1, torch.where(cp_next >= g.nphi, 0, cp_next))
    cp_out = torch.where(next_axis == 3, cp_next, cp)

    grid_exit = (next_axis == 1) & (next_idx == g.nr)
    # degenerate surface bounce (error 034, ARTES.f90:3438-3468)
    err_degen = cur_r & (fidx == cell_depth) & (next_axis == 1) & (next_idx == cell_depth)
    return {
        "next_face": torch.stack([next_axis, next_idx], dim=-1),
        "distance": distance,
        "cell_out": torch.stack([cr_out, ct_out, cp_out], dim=-1),
        "grid_exit": grid_exit,
        "error": error | err_degen,
        "err_nocand": error,
        "err_degen": err_degen,
    }


def heal_cell(g: GridGeometry, pos, cell, active):
    """Re-locate active photons whose tracked radial cell disagrees with
    their radius by more than ``sel1`` (f32 tangent-root error; see
    ``artes_tpu.transport.geometry.heal_cell``): all three indices are
    re-derived from the position. Consistent photons, and so every float64
    run, keep their cell bit for bit. ``cell`` is (B, 3)."""
    x = pos[..., 0] * g.ob_ax
    y = pos[..., 1] * g.ob_by
    z = pos[..., 2] * g.ob_cz
    rho = torch.sqrt(norm2(x, y, z))
    cr = cell[..., 0]
    r_lo = g.rfront[torch.clamp(cr, 0, g.nr - 1)]
    r_hi = g.rfront[torch.clamp(cr + 1, 0, g.nr)]
    bad = active & ((rho < r_lo - g.sel1) | (rho > r_hi + g.sel1))
    r_idx = torch.clamp(torch.searchsorted(g.rfront, rho.contiguous(), right=True) - 1,
                        0, g.nr - 1)
    return torch.where(bad.unsqueeze(-1), locate_cell(g, pos, r_idx), cell)


def phi_fronts(g: GridGeometry):
    """Azimuth of every phi face in [0, 2 pi)."""
    phifront = torch.arctan2(g.phi_sin, g.phi_cos)
    return torch.where(phifront < 0.0, phifront + 2.0 * math.pi, phifront)


def locate_cell(g: GridGeometry, pos, radial_index):
    """(r, theta, phi) cell of a point with the radial index supplied by the
    caller (nr - 1 at stellar entry; ARTES.f90:2605-2669). The azimuth is
    binned with ``arctan2``, as the JAX package's XLA kernel does."""
    x = pos[..., 0] * g.ob_ax
    y = pos[..., 1] * g.ob_by
    z = pos[..., 2] * g.ob_cz
    zero = torch.zeros_like(radial_index)
    if g.ntheta > 1:
        r = torch.sqrt(norm2(x, y, z))
        theta = torch.arccos(torch.clamp(z / torch.clamp_min(r, 1e-300), -1.0, 1.0))
        cos_t = torch.cos(theta)
        # theta_cos decreases; cell j has cos in (cos[j+1], cos[j])
        ct = (cos_t.unsqueeze(-1) < g.theta_cos[1:-1]).sum(dim=-1)
    else:
        ct = zero
    if g.nphi > 1:
        phi = torch.arctan2(y, x)
        phi = torch.where(phi < 0.0, phi + 2.0 * math.pi, phi)
        cp = torch.clamp((phi.unsqueeze(-1) >= phi_fronts(g)[1:]).sum(dim=-1), 0, g.nphi - 1)
    else:
        cp = zero
    return torch.stack([radial_index, ct.to(radial_index.dtype), cp.to(radial_index.dtype)],
                       dim=-1)
