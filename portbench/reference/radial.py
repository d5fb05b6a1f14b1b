# Frozen copy of artes_tpu_torch/transport/radial.py at commit bba47c3; only its imports
# are renamed. The benchmark's reference: it imports nothing of artes_tpu_torch.
"""Closed-form radial transport: loop-free shell-chord marching.

Counterpart of ``artes_tpu.transport.radial`` (see its docstring for the
derivation). Along a ray through concentric (optionally oblate) shells the
squared radius is a quadratic in the path parameter, so every face is
crossed at the roots of one quadratic; the optical depth is a sum of
per-shell chord lengths and the march to a sampled optical depth is a
prefix-sum walk over at most 2 nr segments.

Here the face roots and the segments are computed for all faces at once (a
trailing face dimension), and the running optical depth adds the segments
one at a time in the reference's path order and in their dtype
(:func:`left_scan`), as the JAX package's loops and the kernels do, on every
device. The ``flow`` hook of :func:`march` books the flow diagnostics of
every segment a photon walks.
"""

from __future__ import annotations

import torch

BIG = 1.0e30


def left_scan(terms):
    """The running sums of ``terms`` over the last dimension, each added to
    the one before in their dtype, ``t0, t0 + t1, (t0 + t1) + t2, ...``, as
    the reference's loops add them. ``torch.cumsum`` is not that scan: on
    the CPU it carries float32 in float64 and rounds each prefix once, and
    on a CUDA device its parallel scan over the last dimension adds in
    another order."""
    acc = terms[..., 0]
    out = [acc]
    for k in range(1, terms.shape[-1]):
        acc = acc + terms[..., k]
        out.append(acc)
    return torch.stack(out, dim=-1)


def use_closed_form(grid, static) -> bool:
    """Closed-form path applies: radial-only grid, no surface."""
    return grid.ntheta == 1 and grid.nphi == 1 and not static.has_surface


def ray_chords(a2, b2, c2, rf, rf_floor, pos_eps, px, py, pz, dx, dy, dz):
    """Forward crossing parameters of every face sphere plus the floor.

    ``rf`` is the (nr+1,) face-radius tensor, ``rf_floor`` the photon-floor
    radius rfront[cell_depth]. Returns ``(e, h, surface_hit, s_surf)``:
    clamped inward/outward crossing parameters with a trailing face
    dimension of nr+1, whether the forward path enters the floor sphere,
    and where (BIG when it does not). The quadratic rounds op by op, as the
    closed-form kernel's limits were read; the jump walk rounds its own in
    XLA's chains (``jumps.quad_terms``) and passes it to :func:`chords`.
    """
    A = a2 * dx * dx + b2 * dy * dy + c2 * dz * dz
    Bq = a2 * px * dx + b2 * py * dy + c2 * pz * dz
    Cq = a2 * px * px + b2 * py * py + c2 * pz * pz
    return chords(A, Bq, Cq, rf, rf_floor, pos_eps, _chord_disc)


def _chord_disc(A, Bq, Cq, r_face):
    """``(Cj, disc)`` of a face sphere, ``Cq - r^2`` and ``Bq^2 - A Cj``."""
    Cj = Cq - r_face * r_face
    return Cj, Bq * Bq - A * Cj


def chords(A, Bq, Cq, rf, rf_floor, pos_eps, chord_disc):
    """:func:`ray_chords` of a ray whose squared transformed radius is ``A
    s^2 + 2 Bq s + Cq``; ``chord_disc(A, Bq, Cq, r_face)`` gives a face
    sphere's ``(Cq - r^2, Bq^2 - A (Cq - r^2))`` as the caller's walk rounds
    them."""
    inv_a = 1.0 / A
    mb = -Bq * inv_a                      # perigee parameter
    sgn_b = torch.where(Bq >= 0.0, torch.ones_like(Bq), -1.0)

    def roots(r_face, A, Bq, Cq, inv_a, mb, sgn_b):
        # stable q-form roots (radial.py:83-96)
        Cj, disc = chord_disc(A, Bq, Cq, r_face)
        ok = disc > 0.0
        q = -(Bq + sgn_b * torch.sqrt(torch.where(ok, disc, 0.0)))
        r1 = q * inv_a
        r2 = Cj / torch.where(q == 0.0, 1.0, q)
        lo = torch.where(ok, torch.minimum(r1, r2), mb)
        hi = torch.where(ok, torch.maximum(r1, r2), mb)
        return lo, hi, ok

    per_face = [v.unsqueeze(-1) for v in (A, Bq, Cq, inv_a, mb, sgn_b)]
    lo, hi, _ = roots(rf, *per_face)
    e = torch.clamp_min(lo, 0.0)
    h = torch.clamp_min(hi, 0.0)
    lo_f, _, ok_f = roots(rf_floor, A, Bq, Cq, inv_a, mb, sgn_b)
    # pos_eps keeps photons starting ON the floor and moving outward
    # (lo ~ -0) from re-triggering a zero-distance surface hit
    surface_hit = ok_f & (lo_f > pos_eps)
    s_surf = torch.where(surface_hit, lo_f, BIG)
    return e, h, surface_hit, s_surf


def _path_segments(e, h, surface_hit, s_surf, kx):
    """The 2 nr shell segments of a ray in path order: inbound shells
    nr-1 .. 0, then outbound shells 0 .. nr-1 (zero past the floor).
    Returns per-segment ``start``, ``contrib`` (opacity x length), the
    running optical depth ``cum`` (:func:`left_scan`), the shell index and
    the length ``seg``."""
    nr = kx.shape[0]
    inb = torch.arange(nr - 1, -1, -1, device=kx.device)
    s_col = s_surf.unsqueeze(-1)
    start_in = torch.minimum(e[..., inb + 1], s_col)
    seg_in = torch.clamp_min(torch.minimum(e[..., inb], s_col) - start_in, 0.0)
    seg_out = torch.clamp_min(h[..., 1:] - h[..., :-1], 0.0)
    contrib = torch.cat([kx[inb] * seg_in,
                         torch.where(surface_hit.unsqueeze(-1), 0.0, kx * seg_out)], dim=-1)
    start = torch.cat([start_in, h[..., :-1]], dim=-1)
    shell = torch.cat([inb, torch.arange(nr, device=kx.device)])
    return (start, contrib, left_scan(contrib), shell,
            torch.cat([seg_in, seg_out], dim=-1))


def tau_from_chords(e, h, surface_hit, s_surf, kx):
    """Optical depth over precomputed chords; ``kx`` is the (nr,) per-shell
    opacity tensor."""
    return _path_segments(e, h, surface_hit, s_surf, kx)[2][..., -1]


def tau_walk(a2, b2, c2, rf, kx, rf_floor, pos_eps, px, py, pz, dx, dy, dz):
    """Total optical depth to the grid boundary or floor along a ray
    (ARTES.f90:623-656, :4542-4569). Returns ``tau``, ``exited``,
    ``surface`` and ``err`` (always False: the closed form cannot fail)."""
    e, h, surface_hit, s_surf = ray_chords(a2, b2, c2, rf, rf_floor, pos_eps,
                                           px, py, pz, dx, dy, dz)
    tau = tau_from_chords(e, h, surface_hit, s_surf, kx)
    return dict(tau=tau, exited=~surface_hit, surface=surface_hit,
                err=torch.zeros_like(surface_hit))


def _book_flow(flow, energy, px, py, pz, dx, dy, dz, start, seg, shell, mask, hit, s_hit):
    """Add the flow diagnostics of every walked segment into ``flow``, the
    float64 tensors ``(nr, 3)``, ``(nr, 4)`` and ``(nr,)`` (the ``book`` hook
    of the JAX march, ARTES.f90:711-744): energy x distance projected on the
    local (r, theta, phi) unit vectors at the segment's end, the energy of
    every full crossing in column 0 (outward) or 1 (inward), and energy x
    distance itself, the unsigned total the projections are parts of. The
    projections are polynomials of the path parameter over 1/r and 1/rho,
    constant coefficients along the ray. ``mask`` marks the walked segments,
    ``hit`` the one that ends at the interaction point ``s_hit``."""
    flow_g, flow_t, flow_path = flow
    nr = flow_g.shape[0]

    def col(v):
        return v.unsqueeze(-1)

    pd = col(px * dx + py * dy + pz * dz)
    p2 = col(px * px + py * py + pz * pz)
    pdxy = col(px * dx + py * dy)
    pq2 = col(px * px + py * py)
    dq2 = col(dx * dx + dy * dy)
    lz = col(px * dy - py * dx)
    dist = torch.where(hit, col(s_hit) - start, seg)
    t = torch.where(hit, col(s_hit), start + seg)
    r2 = t * (t + 2.0 * pd) + p2
    rho2 = (dq2 * t + 2.0 * pdxy) * t + pq2
    inv_r = torch.rsqrt(torch.clamp_min(r2, 1e-30))
    inv_rho = torch.rsqrt(torch.clamp_min(rho2, 1e-30))
    w = col(energy) * dist * mask
    tnum = (col(pz) + t * col(dz)) * (pdxy + t * dq2) - rho2 * col(dz)
    proj = torch.stack([(pd + t) * inv_r * w, tnum * (inv_rho * inv_r) * w, lz * inv_rho * w],
                       dim=-1)
    flow_g.index_add_(0, shell, proj.to(torch.float64).sum(dim=0))
    flow_path.index_add_(0, shell, w.to(torch.float64).sum(dim=0))
    crossed = (col(energy) * (mask & ~hit)).to(torch.float64).sum(dim=0)
    flow_t[:, 1].index_add_(0, shell[:nr], crossed[:nr])      # inbound segments
    flow_t[:, 0].index_add_(0, shell[nr:], crossed[nr:])      # outbound segments


def march(a2, b2, c2, rf, kx, rf_floor, pos_eps, px, py, pz, dx, dy, dz,
          tau_budget, active, chords=None, energy=None, flow=None):
    """March to the sampled optical depth (ARTES.f90:687-778, loop-free).

    Returns ``s_stop`` (path length consumed), ``cr`` (radial cell of an
    interaction), ``inter``, ``exited``, ``surface`` (reached the floor with
    budget left: absorbed) and ``tau_surf``. ``chords`` may carry this
    ray's :func:`ray_chords` result when the caller already has it. With
    ``flow`` (see :func:`_book_flow`) and ``energy``, the photons' Stokes I,
    the march books its flow diagnostics.
    """
    if chords is None:
        chords = ray_chords(a2, b2, c2, rf, rf_floor, pos_eps,
                            px, py, pz, dx, dy, dz)
    e, h, surface_hit, s_surf = chords
    nr = kx.shape[0]
    start, contrib, cum, shell, seg = _path_segments(e, h, surface_hit, s_surf, kx)
    cum_before = torch.cat([torch.zeros_like(cum[..., :1]), cum[..., :-1]], dim=-1)
    # the interaction is the first segment (in path order) whose running
    # optical depth passes the budget; outbound segments only count when
    # the ray does not end on the floor
    outbound = torch.arange(2 * nr, device=kx.device) >= nr
    hit = ((cum > tau_budget.unsqueeze(-1)) & active.unsqueeze(-1)
           & ~(outbound & surface_hit.unsqueeze(-1)))
    inter = hit.any(dim=-1)
    first = torch.argmax(hit.to(torch.uint8), dim=-1, keepdim=True)
    k_hit = kx[shell][first[..., 0]]
    k_safe = torch.where(k_hit == 0.0, 1.0, k_hit)
    s_hit = (start.gather(-1, first)[..., 0]
             + (tau_budget - cum_before.gather(-1, first)[..., 0]) / k_safe)
    if flow is not None:
        seg_index = torch.arange(2 * nr, device=kx.device)
        walked = torch.where(inter.unsqueeze(-1), seg_index <= first, True)
        mask = (active.unsqueeze(-1) & walked & (seg > 0.0)
                & ~(outbound & surface_hit.unsqueeze(-1)))
        _book_flow(flow, energy, px, py, pz, dx, dy, dz, start, seg, shell, mask,
                   inter.unsqueeze(-1) & (seg_index == first), s_hit)
    tau_surf = cum[..., nr - 1]
    surface = active & surface_hit & ~inter
    s_stop = torch.where(inter, s_hit, torch.where(surface, s_surf, 0.0))
    cr_stop = torch.where(inter, shell[first[..., 0]], 0)
    exited = active & ~inter & ~surface
    return dict(s_stop=s_stop, cr=cr_stop, inter=inter,
                exited=exited, surface=surface, tau_surf=tau_surf)
