"""The photon-transport kernel in plain PyTorch (the pool kernel's twin).

Counterpart of ``artes_tpu.transport.kernel``: the per-photon physics of
``_stream_impl`` (ARTES.f90:518-1006) for the slice this package covers,
written as batched tensor code that runs on any device and in float32 or
float64. It is the plain version of the hand-written CUDA kernel
``csrc/pool_radial.cu`` (see ``pool_cuda``): the CPU tests hold it against
the JAX package, and the card's smoke run holds the kernel against it.

Photon streams are keyed by (seed, photon id, draw site), not by lane or
round, so no regeneration pool is needed: :func:`run_stream` takes the ids
in chunks of ``width``, emits a chunk, and runs lockstep rounds over the
photons still alive (compacted every round) until all are dead. Per photon
the events, draw sites and tallies are those of the JAX pool:

* stellar emission consumes sites 0 and 1, thermal emission sites 0-5;
* a thermal photon then peels its birth toward the observer (no draw);
* the next round fuses the forced-first-interaction prewalk with the first
  march and consumes one site;
* every later (LIVE) round draws five sites: roulette, two azimuth draws,
  the zenith draw and the optical depth.

Slice: radial grids, stellar (any beam direction, crescent sampling) or
thermal (isotropic or Gordon-biased) sources, any detector size, no surface,
no flow (:func:`check_slice` names the ROADMAP slice of everything else).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from artes_tpu_torch.transport import geometry as G
from artes_tpu_torch.transport import mueller as M
from artes_tpu_torch.transport import radial as RAD
from artes_tpu_torch.transport import rng as R
from artes_tpu_torch.transport import sampling as S

TWO_PI = 2.0 * math.pi
ERR_RECORD_W = 16   # columns of an error record (artes_tpu.transport.kernel)


@dataclasses.dataclass(frozen=True)
class KernelStatic:
    """Run-constant kernel parameters (fields of the JAX ``KernelStatic``)."""

    nx: int
    ny: int
    photon_source: int          # 1 = star, 2 = planet (ARTES.f90:20)
    photon_emission: int = 1    # 1 = isotropic, 2 = biased
    photon_scattering: bool = True
    stellar_direction: bool = False
    crescent: bool = False
    thermal_weight: bool = True
    max_scatter: int = 128
    max_crossings: int = 64
    track_flow: bool = False
    has_surface: bool = False
    det_f64: bool = False
    debug_stokes: bool = False


@dataclasses.dataclass
class TransportTables:
    """Per-wavelength tables, all on one device (the fields of the JAX
    ``TransportTables``)."""

    grid: G.GridGeometry
    opacity: torch.Tensor        # (ncell,) extinction per scaled length
    albedo: torch.Tensor         # (ncell,)
    scatter_rows: torch.Tensor   # (ncell*180, 16)
    alpha_prefix: torch.Tensor   # (ncell, 4, 181)
    p_int: torch.Tensor          # (ncell, 4)
    cell_depth: torch.Tensor     # int scalar: photon floor radial face
    emis_cum: torch.Tensor       # (ncell,) cumulative emissivity CDF (thermal)
    cell_weight: torch.Tensor    # (ncell,) thermal emission weights
    det_dir: torch.Tensor        # (3,) unit vector to the observer
    det_trig: torch.Tensor       # (4,) sin/cos det theta, sin/cos det phi
    x_max: torch.Tensor          # scalar, scaled image half-size
    y_max: torch.Tensor
    surface_albedo: torch.Tensor
    fstop: torch.Tensor
    photon_minimum: torch.Tensor
    photon_bias: torch.Tensor    # Gordon emission bias (thermal, biased)
    star_theta: torch.Tensor     # off-axis stellar beam angles [rad]
    star_phi: torch.Tensor


def check_slice(tables: TransportTables, static: KernelStatic) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP slice of a config
    this package does not cover yet (the same rule on every device)."""
    g = tables.grid
    later = [
        (g.ntheta != 1 or g.nphi != 1,
         "3-D grids: 3-D slice (ROADMAP queue 1 item 8)"),
        (static.has_surface or float(tables.surface_albedo) > 0.0,
         "Lambert surfaces: surface slice (ROADMAP queue 1 item 8)"),
        (static.track_flow,
         "flow diagnostics: flow slice (ROADMAP queue 1 item 8)"),
        (static.debug_stokes or not static.photon_scattering,
         "--debug-stokes and photon:scattering=off: 3-D slice with the "
         "error forensics (ROADMAP queue 1 item 8)"),
    ]
    for unsupported, what in later:
        if unsupported:
            raise NotImplementedError(f"not ported yet: {what}")


def flat_cell(grid: G.GridGeometry, cell):
    return (cell[..., 0] * grid.ntheta + cell[..., 1]) * grid.nphi + cell[..., 2]


def _image_coords(t: TransportTables, pos):
    """Image-plane coordinates of a peel origin (ARTES.f90:4575-4579)."""
    st, ct, sp, cp = t.det_trig.unbind(0)
    x, y, z = pos.unbind(-1)
    return y * cp - x * sp, z * st - y * ct * sp - x * ct * cp


def _pixel_index(t: TransportTables, static: KernelStatic, pos):
    """Pixel of a peel origin, -1 outside the image (applies for one pixel
    too: the single pixel is the square of half-size x_max)."""
    x_im, y_im = _image_coords(t, pos)
    ix = torch.floor(static.nx * (x_im + t.x_max) / (2.0 * t.x_max)).to(torch.int64)
    iy = torch.floor(static.ny * (y_im + t.y_max) / (2.0 * t.y_max)).to(torch.int64)
    oob = (ix < 0) | (ix >= static.nx) | (iy < 0) | (iy >= static.ny)
    return torch.where(oob, -1, ix * static.ny + iy)


def _rotation(axis: int, angle: float) -> np.ndarray:
    """3x3 axis rotation in float64 numpy (``mueller.rotation_matrix``)."""
    return M.rotation_matrix(axis, torch.tensor(angle, dtype=torch.float64)).numpy()


def emit_basis(t: TransportTables, static: KernelStatic):
    """Stellar-beam frame on the ellipsoid silhouette (float64 numpy):
    ``(u_hat, e1s, e2s, w_hat)``. The default beam runs along -x; with
    ``stellar_direction`` it is turned by ``rot_z(phi*) @ rot_y(-(pi/2 -
    theta*))`` (artes_tpu.transport.kernel._emit)."""
    grid = t.grid
    u_hat = np.array([-1.0, 0.0, 0.0])
    e1 = np.array([0.0, 1.0, 0.0])
    if static.stellar_direction:
        rot = (_rotation(2, float(t.star_phi))
               @ _rotation(1, -(math.pi / 2.0 - float(t.star_theta))))
        u_hat = rot @ u_hat
        e1 = rot @ e1
    s_diag = np.array([grid.ob_ax, grid.ob_by, grid.ob_cz])
    w = s_diag * u_hat
    w_hat = w / np.linalg.norm(w)
    e1s = s_diag * e1
    e1s = e1s - np.dot(e1s, w_hat) * w_hat
    e1s = e1s / np.linalg.norm(e1s)
    e2s = np.cross(e1s, w_hat)
    return u_hat, e1s, e2s, w_hat


def _emit(t: TransportTables, static: KernelStatic, k0, k1, dtype):
    """Stellar emission: a uniform parallel beam over the ellipsoid
    silhouette (ARTES.f90:1054-1077, re-derived as in the JAX package), on
    the crescent ring r > 0.9 when ``static.crescent`` (:1041-1049).
    Consumes draw sites 0 and 1; returns ``pos, dirn, cr, counter``."""
    grid = t.grid
    dev = t.opacity.device
    u1, u2 = R.uniform_n_kk(k0, k1, 0, 2, dtype)
    if static.crescent:
        u1 = 0.81 + 0.19 * u1
    r_disk = torch.sqrt(u1)
    phi_disk = TWO_PI * u2
    disk1 = r_disk * torch.sin(phi_disk)
    disk2 = r_disk * torch.cos(phi_disk)
    depth = torch.sqrt(torch.clamp_min(1.0 - disk1 * disk1 - disk2 * disk2, 0.0))
    u_hat, e1s, e2s, w_hat = (torch.as_tensor(v, dtype=dtype, device=dev)
                              for v in emit_basis(t, static))
    s_diag = torch.tensor([grid.ob_ax, grid.ob_by, grid.ob_cz], dtype=dtype, device=dev)
    q = disk1[:, None] * e1s + disk2[:, None] * e2s - depth[:, None] * w_hat
    pos = q / s_diag
    dirn = u_hat.expand_as(pos).clone()
    cr = G.locate_cell(grid, pos, torch.full_like(k1, grid.nr - 1))[..., 0]
    return pos, dirn, cr, 2


def _emit_thermal(t: TransportTables, static: KernelStatic, k0, k1, dtype):
    """Thermal emission (ARTES.f90:1124-1254): the cell from the cumulative
    emissivity CDF, a point inside it, an isotropic or Gordon-biased
    direction. Consumes draw sites 0-5; returns ``pos, dirn, cr, w0`` with
    ``w0`` the initial Stokes I, bias weight over cell weight."""
    grid = t.grid
    u_cell, u_r, u_t, u_p, u_a, u_b = R.uniform_n_kk(k0, k1, 0, 6, dtype)
    # birth points stay off the cell faces, as in the JAX package
    u_r = torch.clamp(u_r, 1.0e-4, 1.0 - 1.0e-4)
    u_t = torch.clamp(u_t, 1.0e-4, 1.0 - 1.0e-4)
    target = u_cell * t.emis_cum[-1]
    cr = torch.clamp(torch.searchsorted(t.emis_cum, target, side="left"),
                     0, t.emis_cum.shape[0] - 1)
    rf, tc = grid.rfront, grid.theta_cos
    r = rf[cr] + u_r * (rf[cr + 1] - rf[cr])
    cos_t = tc[0] + u_t * (tc[1] - tc[0])
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    phi = TWO_PI * u_p
    pos = torch.stack([r * sin_t * torch.cos(phi) / grid.ob_ax,
                       r * sin_t * torch.sin(phi) / grid.ob_by,
                       r * cos_t / grid.ob_cz], dim=-1)
    if static.photon_emission == 1:
        alpha = 2.0 * u_a - 1.0
        beta = TWO_PI * u_b
        s = torch.sqrt(torch.clamp_min(1.0 - alpha * alpha, 0.0))
        dirn = torch.stack([s * torch.cos(beta), s * torch.sin(beta), alpha], dim=-1)
        bias_w = torch.ones_like(u_a)
    else:
        # biased upward, Gordon 1987 (:1229-1254)
        bias = t.photon_bias
        y_bias = (1.0 + bias) * torch.tan(math.pi * u_a / 2.0) / torch.sqrt(1.0 - bias * bias)
        theta_s = torch.arccos(torch.clamp((1.0 - y_bias * y_bias) / (1.0 + y_bias * y_bias),
                                           -1.0, 1.0))
        beta = TWO_PI * u_b
        radial = pos * torch.tensor([grid.ob_ax * grid.ob_ax, grid.ob_by * grid.ob_by,
                                     grid.ob_cz * grid.ob_cz], dtype=dtype, device=pos.device)
        radial = radial / torch.sqrt((radial * radial).sum(-1, keepdim=True))
        dirn = M.direction_cosine(torch.cos(math.pi - theta_s), beta, radial)
        bias_w = (math.pi * torch.sin(theta_s) * (1.0 + bias * torch.cos(theta_s))) / \
            (2.0 * torch.sqrt(1.0 - bias * bias))
    return pos, dirn, cr, bias_w / t.cell_weight[cr]


def _peel_photon_prep(t: TransportTables, static: KernelStatic, pos, dirn, cr, stokes):
    """The tau-independent part of the per-scatter peel (ARTES.f90:4763-4948):
    matrix at the detector angle, azimuth bookkeeping, Stokes rotation with
    the detector Q sign flip, and the pixel. ``cr`` is the radial cell."""
    eps = 1.0e-10
    d = t.det_dir
    mu = dirn[..., 0] * d[0] + dirn[..., 1] * d[1] + dirn[..., 2] * d[2]
    mu = torch.clamp(mu, -1.0 + eps, 1.0 - eps)
    scatter = S.matrix_at_angle(t.scatter_rows, cr, torch.arccos(mu))
    dz = dirn[..., 2]
    denom = (torch.sqrt(torch.clamp_min(1.0 - mu * mu, 0.0))
             * torch.sqrt(torch.clamp_min(1.0 - dz * dz, 0.0)))
    num = (d[2] - dz * mu) / torch.where(denom == 0.0, 1.0, denom)
    cphi = torch.clamp(num, -1.0 + eps, 1.0 - eps)
    flip = (dirn[..., 1] * d[0] - dirn[..., 0] * d[1]) > 0.0
    sign = torch.where(flip, -torch.ones_like(mu), 1.0)
    c2b = 2.0 * cphi * cphi - 1.0
    s2b = 2.0 * cphi * torch.sqrt(torch.clamp_min(1.0 - cphi * cphi, 0.0)) * sign
    stokes_out = M.polarization_rotation(mu, None, stokes, scatter, dirn,
                                         d.expand_as(dirn), peeling=True,
                                         beta_trig=(c2b, s2b), beta_sign=sign)
    qflip = torch.tensor([1.0, -1.0, 1.0, 1.0], dtype=stokes.dtype, device=stokes.device)
    return stokes_out * qflip, _pixel_index(t, static, pos)


def _radial_lists(t: TransportTables):
    """Face radii, shell opacities and floor radius for the closed form."""
    g = t.grid
    return (g.ob_ax * g.ob_ax, g.ob_by * g.ob_by, g.ob_cz * g.ob_cz,
            g.rfront, t.opacity, g.rfront[t.cell_depth], g.pos_eps)


def _march_radial(t: TransportTables, pos, dirn, cr, tau, active, chords=None):
    """Closed-form march to the sampled optical depth; returns the new
    position and radial cell and the march outcome."""
    a2, b2, c2, rf, kx, rfl, peps = _radial_lists(t)
    mo = RAD.march(a2, b2, c2, rf, kx, rfl, peps, *pos.unbind(-1), *dirn.unbind(-1),
                   tau, active, chords=chords)
    moved = mo["inter"] | mo["surface"]
    pos = torch.where(moved[:, None], pos + mo["s_stop"][:, None] * dirn, pos)
    return pos, torch.where(mo["inter"], mo["cr"], cr), mo


def _book(det_sum, det_cnt, pix, val, ok, first_only=False):
    """Add accepted peels into the detector: ``val`` (B, 4) and its square
    into ``det_sum`` (npix, 4, 2) at ``pix``, one count into ``det_cnt``
    (npix, 2) whose column 0 counts the Stokes-I row and column 1 the Q, U,
    V rows. ``first_only`` books Stokes I and column 0 only (the thermal
    birth peel, ARTES.f90:4583-4585)."""
    ok = ok & (pix >= 0)
    pix, val = pix[ok], val[ok]
    moments = torch.stack([val, val * val], dim=-1).to(torch.float64)
    if first_only:
        det_sum[:, 0].index_add_(0, pix, moments[:, 0])
        det_cnt[:, 0].index_add_(0, pix, torch.ones_like(pix))
    else:
        det_sum.index_add_(0, pix, moments)
        det_cnt.index_add_(0, pix, torch.ones_like(pix).unsqueeze(-1).expand(-1, 2))


def detector_from_tallies(det_sum, det_cnt):
    """(npix, 4, 3) float64 detector [sum, sum of squares, count] from the
    (npix, 4, 2) moments and the (npix, 2) counts of :func:`_book`."""
    cnt = torch.cat([det_cnt[:, :1], det_cnt[:, 1:].expand(-1, 3)], dim=1)
    return torch.cat([det_sum, cnt.to(torch.float64).unsqueeze(-1)], dim=-1)


def run_stream(tables: TransportTables, static: KernelStatic, n_photons: int, seed: int,
               width: int, id_hi: int = 0, id_lo: int = 0):
    """Transport photons ``id_lo .. id_lo + n_photons - 1`` (high id word
    ``id_hi``) and return the JAX ``run_stream`` tallies.

    The detector is ``(nx*ny, 4, 3)`` float64 [sum, sum of squares, count];
    counts are summed as integers, and the Stokes-I row's count includes the
    thermal birth peels, which the Q, U and V rows' counts do not.
    ``flux_emitted`` (sum of the emitted Stokes I) and ``flux_exit`` (sum of
    the Stokes I leaving through the top) are float64 and zero for stellar
    sources. ``width`` is the number of photons emitted together.
    """
    check_slice(tables, static)
    t = tables
    dt = t.opacity.dtype
    dev = t.opacity.device
    thermal = static.photon_source == 2
    a2, b2, c2, rf, kx, rfl, peps = _radial_lists(t)
    k0 = R.key_hi(seed, id_hi)
    det_dir = t.det_dir
    npix = static.nx * static.ny
    det_sum = torch.zeros((npix, 4, 2), dtype=torch.float64, device=dev)
    det_cnt = torch.zeros((npix, 2), dtype=torch.int64, device=dev)
    n_cap = torch.zeros((), dtype=torch.int64, device=dev)
    flux_emitted = torch.zeros((), dtype=torch.float64, device=dev)
    flux_exit = torch.zeros((), dtype=torch.float64, device=dev)

    for start in range(0, int(n_photons), width):
        n = min(width, int(n_photons) - start)
        pid = id_lo + start + torch.arange(n, dtype=torch.int64, device=dev)
        stokes = torch.zeros((n, 4), dtype=dt, device=dev)
        if thermal:
            pos, dirn, cr, w0 = _emit_thermal(t, static, k0, pid, dt)
            ctr = 6
            flux_emitted += w0.to(torch.float64).sum()
            stokes[:, 0] = w0
            # birth peel e^-tau/(4 pi) on Stokes I (ARTES.f90:4519-4598)
            pw = RAD.tau_walk(a2, b2, c2, rf, kx, rfl, peps, *pos.unbind(-1),
                              det_dir[0], det_dir[1], det_dir[2])
            w_b = torch.exp(-torch.clamp_max(pw["tau"], 500.0)) / (4.0 * math.pi)
            _book(det_sum, det_cnt, _pixel_index(t, static, pos),
                  (w_b * stokes[:, 0])[:, None], pw["exited"] & (pw["tau"] < 50.0),
                  first_only=True)
        else:
            pos, dirn, cr, ctr = _emit(t, static, k0, pid, dt)
            stokes[:, 0] = 1.0

        # the prewalk along the photon's own direction, fused with the
        # forced first interaction (ARTES.f90:623-684) and its march
        chords = RAD.ray_chords(a2, b2, c2, rf, rfl, peps,
                                *pos.unbind(-1), *dirn.unbind(-1))
        tau_first = RAD.tau_from_chords(*chords, kx)
        pre_surface = chords[2]
        (u_tau,) = R.uniform_n_kk(k0, pid, ctr, 1, dt)
        thin = tau_first < 1.0e-6
        go = ~(thin & ~pre_surface)         # vacuum, no surface: dropped
        forced = go & ~thin & (tau_first < 50.0)
        one_m_exp = 1.0 - torch.exp(-tau_first)
        tau = torch.where(forced, -torch.log(1.0 - u_tau * one_m_exp),
                          -torch.log(1.0 - u_tau))
        stokes = torch.where(forced[:, None], stokes * one_m_exp[:, None], stokes)
        ctr = torch.full_like(pid, ctr + 1)
        pos, cr, mo = _march_radial(t, pos, dirn, cr, tau, go, chords)
        if thermal:
            flux_exit += stokes[mo["exited"], 0].to(torch.float64).sum()
        n_scat = torch.zeros_like(pid)

        keep = mo["inter"]
        while True:
            pid, ctr, pos, dirn, cr, stokes, n_scat = (
                v[keep] for v in (pid, ctr, pos, dirn, cr, stokes, n_scat))
            if pid.numel() == 0:
                break
            # LIVE round (ARTES.f90:786-951)
            cr = G.heal_cell(t.grid, pos, cr, torch.ones_like(pid, dtype=torch.bool))
            d0, d1, d2, d3, d4 = R.uniform_n_kk(k0, pid, ctr, 5, dt)
            killed = d0 < t.fstop
            alb = t.albedo[cr]
            gamma = torch.where((alb < 1.0) & (alb > 0.0), alb / (1.0 - t.fstop),
                                torch.ones_like(alb))
            stokes = stokes * gamma[:, None]
            surv = ~killed & ~(stokes[:, 0] <= t.photon_minimum)
            pid, ctr, pos, dirn, cr, stokes, n_scat, d1, d2, d3, d4 = (
                v[surv] for v in (pid, ctr, pos, dirn, cr, stokes, n_scat, d1, d2, d3, d4))

            peel_contrib, peel_pix = _peel_photon_prep(t, static, pos, dirn, cr, stokes)
            beta, c2b, s2b = S.sample_beta(t.p_int[cr], stokes, d1, d2)
            alpha, alpha_deg = S.sample_alpha_fused(t.alpha_prefix, cr, stokes,
                                                    (c2b, s2b), d3)
            dir_new = M.direction_cosine(alpha, beta, dirn)
            scat_m = S.matrix_at_angle_deg(t.scatter_rows, cr, alpha_deg)
            stokes = M.polarization_rotation(alpha, beta, stokes, scat_m, dirn, dir_new,
                                             peeling=False, beta_trig=(c2b, s2b))
            n_scat = n_scat + 1

            pw = RAD.tau_walk(a2, b2, c2, rf, kx, rfl, peps, *pos.unbind(-1),
                              det_dir[0], det_dir[1], det_dir[2])
            _book(det_sum, det_cnt, peel_pix,
                  peel_contrib * torch.exp(-torch.clamp_max(pw["tau"], 500.0))[:, None],
                  pw["exited"] & (pw["tau"] < 50.0))

            tau = -torch.log(1.0 - d4)
            ctr = ctr + 5
            pos, cr, mo = _march_radial(t, pos, dir_new, cr, tau,
                                        torch.ones_like(pid, dtype=torch.bool))
            if thermal:
                flux_exit += stokes[mo["exited"], 0].to(torch.float64).sum()
            dirn = dir_new
            capped = mo["inter"] & (n_scat >= static.max_scatter)
            n_cap += capped.sum()
            keep = mo["inter"] & ~capped

    zero = torch.zeros((), dtype=torch.int64, device=dev)
    return {
        "detector": detector_from_tallies(det_sum, det_cnt),
        "flux_emitted": flux_emitted,
        "flux_exit": flux_exit,
        "n_error": zero,            # the closed form has no failure modes
        "error_codes": torch.zeros(4, dtype=torch.int64, device=dev),
        "n_alive_at_cap": n_cap,
        "n_emitted": int(n_photons),
        "error_records": torch.zeros((0, ERR_RECORD_W), dtype=torch.float64),
        "n_error_records": 0,
    }
