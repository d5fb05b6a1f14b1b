"""Order-free jump-sum tau walks for 3-D spherical grids.

Counterpart of ``artes_tpu.transport.jumps`` (see its docstring for the
derivation): along a fixed ray through a piecewise-constant opacity,

    tau(0, s_end) = k(0) * s_end + sum_i dk_i * max(0, s_end - t_i)

with t_i the ray's face-crossing parameters (radial spheres and theta cones:
quadratic roots; the theta = 90 deg plane and the phi half-planes: linear)
and dk_i the opacity jump across crossing i. The opacity splits as
``k[cell] = kbar[cr] + dk[cr, ct, cp]`` with ``kbar[m] = k[m, 0, 0]``: the
kbar part is the radial chords of ``radial.py`` (the inbound chords and the
outbound ones each summed from shell 0 up, then the two sums added: the
3-D kernel's order, not the closed form's path order), and only the dk
part pays per-crossing jumps, each read from a per-face difference table

    DR[j][a]    = dk[j, a] - dk[j-1, a]          (radial face j; a = ct*NP+cp)
    DTT[t][m,p] = dk[m, t, p] - dk[m, t-1, p]    (theta face t)
    DPP[p][m,t] = dk[m, t, p] - dk[m, t, p-1]    (phi face p, wrap-around)

The JAX package hands its walk per-kernel gather callbacks; here the tables
are plain tensors (:class:`JumpTables`, built once per wavelength by
:func:`jump_tables`), and the faces form a trailing tensor dimension: the
jumps are evaluated for all faces at once and added one at a time in the
reference's order (radial faces inward then outward, theta faces low root
then high root, phi faces) and in their dtype, ``radial.left_scan``, as the JAX
package's loop and the 3-D kernel add them, on every device.

Scope: 3-D grids (ntheta > 1 or nphi > 1) without a Lambert surface and
without flow diagnostics. The walk has no failure modes.
"""

from __future__ import annotations

import dataclasses

import torch

from artes_tpu_torch.transport import radial as RAD
from artes_tpu_torch.transport.geometry import fmadd

BIG = 1.0e30


@dataclasses.dataclass
class JumpTables:
    """Opacity split and per-face difference tables of one wavelength."""

    kbar: torch.Tensor    # (nr,) baseline opacity k[m, 0, 0]
    dk: torch.Tensor      # (nr*NT*NP,) k - kbar, flat over (r, theta, phi)
    dr: torch.Tensor      # (nr-1, NT*NP): row j-1 is radial face j
    dtt: torch.Tensor     # (NT-1, nr*NP): row t-1 is theta face t, index m*NP+cp
    dpp: torch.Tensor     # (NP, nr*NT): row p is phi face p, index m*NT+ct
    rf2: torch.Tensor     # (nr-1,) squared radii of the interior radial faces


def jump_tables(grid, opacity) -> JumpTables:
    """The jump tables of ``opacity`` (flat over cells), in its dtype and on
    its device (``artes_tpu.transport.kernel._jump_env``)."""
    nr, nt, np_ = grid.nr, grid.ntheta, grid.nphi
    k3 = opacity.reshape(nr, nt, np_)
    kbar = k3[:, 0, 0].contiguous()
    dk = k3 - kbar[:, None, None]
    rf = grid.rfront[1:nr]
    return JumpTables(
        kbar=kbar,
        dk=dk.reshape(-1).contiguous(),
        dr=(dk[1:] - dk[:-1]).reshape(nr - 1, nt * np_).contiguous(),
        dtt=(dk[:, 1:, :] - dk[:, :-1, :]).permute(1, 0, 2).reshape(nt - 1, nr * np_).contiguous(),
        dpp=(dk - torch.roll(dk, 1, dims=2)).permute(2, 0, 1).reshape(np_, nr * nt).contiguous(),
        rf2=(rf * rf).contiguous(),
    )


def jump_tables_of(grid, opacity) -> JumpTables | None:
    """:func:`jump_tables` on a 3-D grid, ``None`` on a radial one (which
    takes the closed form of ``radial.py``)."""
    if grid.ntheta == 1 and grid.nphi == 1:
        return None
    return jump_tables(grid, opacity)


def _stable_roots(A, Bh, C, lin_eps=1.0e-30):
    """Both roots of A s^2 + 2 Bh s + C = 0 (q-form; A may be ~0 or negative
    for cone quadratics). Returns ``(lo, hi, ok)``."""
    disc = Bh * Bh - A * C
    ok = disc > 0.0
    sgn = torch.where(Bh >= 0.0, 1.0, -1.0).to(A.dtype)
    q = -(Bh + sgn * torch.sqrt(torch.where(ok, disc, 0.0)))
    a_small = A.abs() < lin_eps
    r1 = torch.where(a_small, BIG, q / torch.where(a_small, 1.0, A))
    r2 = C / torch.where(q == 0.0, 1.0, q)
    # degenerate to linear: A ~ 0 -> the single root -C / (2 Bh)
    lin = -C / torch.where(Bh.abs() < lin_eps, 1.0, 2.0 * Bh)
    lin_ok = a_small & (Bh.abs() >= lin_eps)
    lo = torch.where(lin_ok, lin, torch.minimum(r1, r2))
    hi = torch.where(lin_ok, BIG, torch.maximum(r1, r2))
    return lo, hi, ok | lin_ok


def _sel_cone(is_cone, cone_val, plane_val, first):
    """The cone root or, in the first root slot only, the plane root: the
    second slot of a plane face is empty (a plane is crossed once)."""
    plane = plane_val if first else torch.full_like(cone_val, BIG)
    return torch.where(is_cone, cone_val, plane)


def quad_terms(a2, b2, c2, px, py, pz, dx, dy, dz):
    """``(A, Bq, Cq)`` of the ray's squared transformed radius ``A s^2 + 2 Bq
    s + Cq``, each in the chain XLA compiles in float32, ``fma(c2 z w, ..,
    fma(a2 x u, .., b2 y v))`` (``geometry.fmadd``), as the 3-D kernel's jump
    walk rounds them; the closed form's ``radial.ray_chords`` rounds op by
    op."""
    def form(ux, uy, uz, vx, vy, vz):
        return fmadd(c2 * uz, vz, fmadd(a2 * ux, vx, b2 * uy * vy))

    return (form(dx, dy, dz, dx, dy, dz), form(px, py, pz, dx, dy, dz),
            form(px, py, pz, px, py, pz))


def chord_disc(A, Bq, Cq, r_face):
    """``(Cj, disc)`` of a face sphere, ``Cq - r^2`` and ``Bq^2 - A Cj``, as
    ``fma(-r, r, Cq)`` and ``fma(Bq, Bq, -(A Cj))`` in float32."""
    Cj = fmadd(-r_face, r_face, Cq)
    return Cj, fmadd(Bq, Bq, -(A * Cj))


def tau_walk_jumps(grid, jt: JumpTables, rf_floor, px, py, pz, dx, dy, dz, cr0, ct0, cp0):
    """Optical depth from (p, d) to the grid boundary or the photon floor.

    ``cr0, ct0, cp0`` is the caller's current cell (it defines k(0); nothing
    is located). Returns ``dict(tau, exited, surface, err)``, the contract of
    the marching tau walk; ``err`` is always False.
    """
    nr, NT, NP = grid.nr, grid.ntheta, grid.nphi
    a2, b2, c2 = grid.ob_ax * grid.ob_ax, grid.ob_by * grid.ob_by, grid.ob_cz * grid.ob_cz

    # ray quadratic in transformed coordinates: r^2(t) = A t^2 + 2 B t + C
    A, Bq, Cq = quad_terms(a2, b2, c2, px, py, pz, dx, dy, dz)

    # radial chords (the closed form's, in the chains) and the kbar baseline:
    # shell m's inbound chord, cut at the floor, and its outbound chord where
    # the ray does not end on the floor, each kind summed over shells 0 ..
    # nr-1 in a sum of its own, as the 3-D kernel's one pass over the faces
    # adds them (the closed form's path order, tau_from_chords, adds inbound
    # shells nr-1 .. 0, then outbound)
    e, h, surface_hit, s_surf = RAD.chords(A, Bq, Cq, grid.rfront, rf_floor, grid.pos_eps,
                                           chord_disc)
    s_col = s_surf.unsqueeze(-1)
    inbound = jt.kbar * torch.clamp_min(
        torch.minimum(e[..., :nr], s_col) - torch.minimum(e[..., 1:], s_col), 0.0)
    outbound = torch.where(surface_hit.unsqueeze(-1), 0.0,
                           jt.kbar * torch.clamp_min(h[..., 1:] - h[..., :-1], 0.0))
    tau_bar = RAD.left_scan(inbound)[..., -1] + RAD.left_scan(outbound)[..., -1]
    s_end = torch.where(surface_hit, s_surf, h[..., nr])

    col = [v.unsqueeze(-1) for v in (px, py, pz, dx, dy, dz, A, Bq, Cq)]
    pxc, pyc, pzc, dxc, dyc, dzc, Ac, Bc, Cc = col
    sq_c = c2 ** 0.5

    # phi half-plane crossings (each crossed at most once): their own jumps,
    # and the phi wedge of every other crossing by counting
    lz_pos = (px * dy - py * dx) > 0.0      # phi increases along the ray
    if NP > 1:
        ax, by = a2 ** 0.5, b2 ** 0.5
        sin_p, cos_p = grid.phi_sin, grid.phi_cos
        denom = by * dyc * cos_p - ax * dxc * sin_p
        s = (ax * pxc * sin_p - by * pyc * cos_p) / torch.where(denom == 0.0, 1.0, denom)
        # the right half of the plane: (X cos + Y sin) > 0 at the crossing
        xs = ax * (pxc + s * dxc)
        ys = by * (pyc + s * dyc)
        valid = (denom.abs() > 0.0) & (s > 0.0) & ((xs * cos_p + ys * sin_p) > 0.0)
        s_phi = torch.where(valid, s, BIG)                 # (B, NP)

    def cp_at(t):
        """phi wedge at parameters ``t`` (B, F): the signed count of
        half-plane crossings at or below t, wrapped."""
        if NP == 1:
            return torch.zeros_like(t, dtype=cr0.dtype)
        cnt = (s_phi.unsqueeze(1) <= t.unsqueeze(-1)).sum(dim=-1)
        cp_eff = torch.where(lz_pos.unsqueeze(-1), cp0.unsqueeze(-1) + cnt,
                             cp0.unsqueeze(-1) - cnt)
        for _ in range(2):
            cp_eff = torch.where(cp_eff < 0, cp_eff + NP, cp_eff)
        for _ in range(2):
            cp_eff = torch.where(cp_eff >= NP, cp_eff - NP, cp_eff)
        return cp_eff

    def ct_at(cos_t):
        """theta band of cos(theta): the count of interior faces whose
        cosine lies above it (theta_cos decreases)."""
        if NT == 1:
            return torch.zeros_like(cos_t, dtype=cr0.dtype)
        return (cos_t.unsqueeze(-1) < grid.theta_cos[1:NT]).sum(dim=-1)

    def locate_m(r2):
        return torch.searchsorted(jt.rf2, r2.contiguous(), right=True)

    def term(delta, t_i):
        return (delta * torch.clamp_min(s_end.unsqueeze(-1) - t_i, 0.0)
                * (t_i > 0.0) * (t_i < BIG))

    # the caller's cell indexes k(0), like the marching walk's first cell
    terms = [(jt.dk[(cr0 * NT + ct0) * NP + cp0] * s_end).unsqueeze(-1)]

    # radial-face jumps: inbound at e[j] (shell j -> j-1), outbound at h[j];
    # an unreached face collapses e == h and its two jumps cancel exactly
    if nr > 1:
        t_i = torch.stack([e[..., 1:nr], h[..., 1:nr]], dim=-1).flatten(-2)
        face = torch.arange(nr - 1, device=px.device).repeat_interleave(2)
        sign = torch.tensor([-1.0, 1.0], dtype=px.dtype, device=px.device).repeat(nr - 1)
        inv_rf = (1.0 / grid.rfront[1:nr]).repeat_interleave(2)
        # cos(theta) at the crossing: transformed z over the exact radius
        ct_i = ct_at(sq_c * (pzc + t_i * dzc) * inv_rf)
        cp_i = cp_at(t_i)
        terms.append(term(sign * jt.dr[face, ct_i * NP + cp_i], t_i))

    # theta-face jumps
    if NT > 1:
        tan2 = (grid.theta_tan[1:NT] * grid.theta_tan[1:NT])
        is_cone, above = grid.thetaplane_cone[1:NT], grid.theta_above[1:NT]
        qa = a2 * dxc * dxc + b2 * dyc * dyc - c2 * dzc * dzc * tan2
        qb = a2 * pxc * dxc + b2 * pyc * dyc - c2 * pzc * dzc * tan2
        qc = a2 * pxc * pxc + b2 * pyc * pyc - c2 * pzc * pzc * tan2
        lo, hi, ok = _stable_roots(qa, qb, qc)
        s_plane = torch.where(dzc.abs() > 0.0, -pzc / torch.where(dzc == 0.0, 1.0, dzc), BIG)
        slots = []
        for root, first in ((lo, True), (hi, False)):
            z_r = pzc + root * dzc
            nappe_ok = torch.where(above, z_r > 0.0, z_r < 0.0)
            cone_t = torch.where(ok & nappe_ok, root, BIG)
            slots.append(_sel_cone(is_cone, cone_t, s_plane.expand_as(cone_t), first))
        t_i = torch.stack(slots, dim=-1).flatten(-2)       # face-major, lo then hi
        face = torch.arange(NT - 1, device=px.device).repeat_interleave(2)
        # crossing direction: the sign of d(cos theta)/ds at t_i
        r2_i = (Ac * t_i + 2.0 * Bc) * t_i + Cc
        u = sq_c * dzc * r2_i - sq_c * (pzc + t_i * dzc) * (Ac * t_i + Bc)
        sign = torch.where(u < 0.0, 1.0, -1.0).to(px.dtype)   # u < 0: band t-1 -> t
        m_i = locate_m(r2_i)
        cp_i = cp_at(t_i)
        terms.append(term(sign * jt.dtt[face, m_i * NP + cp_i], t_i))

    # phi-face jumps
    if NP > 1:
        sign_p = torch.where(lz_pos, 1.0, -1.0).to(px.dtype).unsqueeze(-1)
        t_i = s_phi
        r2_i = (Ac * t_i + 2.0 * Bc) * t_i + Cc
        m_i = locate_m(r2_i)
        ct_i = ct_at(sq_c * (pzc + t_i * dzc) / torch.sqrt(torch.clamp_min(r2_i, 1.0e-30)))
        face = torch.arange(NP, device=px.device)
        terms.append(term(sign_p * jt.dpp[face, m_i * NT + ct_i], t_i))

    dk_sum = RAD.left_scan(torch.cat(terms, dim=-1))[..., -1]
    tau = torch.clamp_min(tau_bar + dk_sum, 0.0)
    return dict(tau=tau, exited=~surface_hit, surface=surface_hit,
                err=torch.zeros_like(surface_hit))
