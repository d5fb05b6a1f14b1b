# Frozen copy of artes_tpu_torch/transport/kernel.py at commit bba47c3; only its imports
# are renamed. The benchmark's reference: it imports nothing of artes_tpu_torch.
"""The photon-transport kernel in plain PyTorch (the pool kernel's twin).

Counterpart of ``artes_tpu.transport.kernel``: the per-photon physics of
``_stream_impl`` (ARTES.f90:518-1006) for the slice this package covers,
written as batched tensor code that runs on any device and in float32 or
float64. It is the plain version of the hand-written CUDA kernel
``csrc/pool_radial.cu`` (see ``pool_cuda``): the CPU tests hold it against
the JAX package, and the card's smoke run holds the kernel against it. On
3-D grids it is the plain version of ``csrc/pool_grid3d.cu``.

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
  the zenith draw and the optical depth;
* a march through ``geometry.cell_face`` advances the site counter by 3 for
  every pass of its loop: the sites of the in-march Lambert draws, reserved
  whether or not a surface consumes them.

Three kinds of walk, chosen by :func:`walk_mode` as the JAX package chooses:

* ``closed``: radial grids without a Lambert surface take the closed-form
  walks of ``radial.py``, which cannot fail; flow diagnostics ride the
  ``flow`` hook of ``radial.march``;
* ``jumps``: 3-D grids without a surface and without flow take the jump
  walks of ``jumps.py`` for peels, the prewalk and an exit precheck, and
  march ``cell_face`` cell by cell to the next interaction;
* ``march``: any grid with a Lambert surface, and 3-D grids with flow, march
  ``cell_face`` for everything: peels and the prewalk (:func:`_tau_walk_march`)
  and the transport march, with no exit precheck. The Lambert event, its
  surface peel and the flow booking are branches of that march
  (:func:`_march_cells`).

A march can fail (error 031: no candidate face, 032: still marching after
``max_crossings``, 034: degenerate floor bounce), and so can a marching peel
or prewalk. A failed transport march, a failed prewalk (tallied under 031)
and a failed thermal birth peel abandon the photon; a failed scatter peel
drops that peel's flux only. Failures are tallied per code and kept as
16-column records (:data:`ERR_RECORD_W`), apart from birth peels, which the
JAX package does not record either. Of all records of a run the first
:data:`ERR_RECORD_K` and the last :data:`ERR_RECORD_K` in photon-id order
are returned, a rule that does not depend on how photons are scheduled.

Covers radial and 3-D grids, stellar (any beam direction, crescent sampling)
or thermal (isotropic or Gordon-biased) sources, any detector size, Lambert
surfaces and the flow diagnostics ``flow_global`` and ``flow_theta``.

The batch transport of the JAX package (``start_batch``, ``run_batch``, its
XLA path over an explicit photon-id array) is :func:`start_batch`,
:func:`scatter_rounds` and :func:`run_batch`: the same emission phase
(:func:`_start`) and LIVE round (:func:`_live_round`) as :func:`run_stream`,
on the ids given, with a resumable per-photon state and a round cap for the
whole batch. The tallies of both sum in float64 (:class:`_Tally`).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from portbench.reference import geometry as G
from portbench.reference import jumps as J
from portbench.reference import mueller as M
from portbench.reference import radial as RAD
from portbench.reference import rng as R
from portbench.reference import sampling as S

TWO_PI = 2.0 * math.pi
# an error record: [code, photon id, pos x3, dir x3, cell x3, face x2,
# Stokes I, scatterings so far, site] (artes_tpu.transport.kernel); site 0 is
# the scatter march, 1 the first march (marching walks only), 2 the prewalk,
# 3 a scatter peel (code 50), 4 the Stokes anomaly of --debug-stokes
ERR_RECORD_W = 16
ERR_RECORD_K = 8    # records kept from each end of a run, in photon-id order


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
    jump: J.JumpTables | None = None   # opacity-jump tables (3-D grids that take jump walks)


def walk_mode(tables: TransportTables, static: KernelStatic) -> str:
    """``"closed"``, ``"jumps"`` or ``"march"``: the walks a configuration
    takes (``radial.use_closed_form`` and ``_use_jumps`` of the JAX
    package)."""
    if RAD.use_closed_form(tables.grid, static):
        return "closed"
    radial_grid = tables.grid.ntheta == 1 and tables.grid.nphi == 1
    if not radial_grid and not static.track_flow and not static.has_surface:
        return "jumps"
    return "march"


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


def disk_depth2(disk1, disk2):
    """``1 - disk1^2 - disk2^2``, the squared depth below the beam's disk, as
    the chain ``fma(-disk2, disk2, fma(-disk1, disk1, 1))`` in float32."""
    return G.fmadd(-disk2, disk2, G.fmadd(-disk1, disk1, torch.ones_like(disk1)))


def disk_position(disk1, disk2, depth, e1s, e2s, w_hat):
    """The entry point ``disk1 e1s + disk2 e2s - depth w_hat`` on the unit
    sphere, as the chain ``fma(-depth, w_hat, fma(disk1, e1s, disk2 e2s))``
    in float32."""
    return G.fmadd(-depth[:, None], w_hat, G.fmadd(disk1[:, None], e1s, disk2[:, None] * e2s))


def _emit(t: TransportTables, static: KernelStatic, k0, k1, dtype):
    """Stellar emission: a uniform parallel beam over the ellipsoid
    silhouette (ARTES.f90:1054-1077, re-derived as in the JAX package), on
    the crescent ring r > 0.9 when ``static.crescent`` (:1041-1049). The
    entry point of a jump or marching walk rounds in the chains XLA
    compiles, as their kernels do (``disk_depth2``, ``disk_position``;
    ``pool_geom3d.cuh::emit_stellar_fma``); the closed form's op by op, as
    its kernel's limits were read (``pool_common.cuh::emit_stellar``).
    Consumes draw sites 0 and 1; returns ``pos, dirn, cell, face`` with
    the entry cell located in the outermost shell and the outer face as the
    current face."""
    grid = t.grid
    dev = t.opacity.device
    u1, u2 = R.uniform_n_kk(k0, k1, 0, 2, dtype)
    if static.crescent:
        u1 = 0.81 + 0.19 * u1
    r_disk = torch.sqrt(u1)
    phi_disk = TWO_PI * u2
    disk1 = r_disk * torch.sin(phi_disk)
    disk2 = r_disk * torch.cos(phi_disk)
    u_hat, e1s, e2s, w_hat = (torch.as_tensor(v, dtype=dtype, device=dev)
                              for v in emit_basis(t, static))
    s_diag = torch.tensor([grid.ob_ax, grid.ob_by, grid.ob_cz], dtype=dtype, device=dev)
    if walk_mode(t, static) == "closed":
        # as the closed-form kernel's limits were read: op by op
        depth = torch.sqrt(torch.clamp_min(1.0 - disk1 * disk1 - disk2 * disk2, 0.0))
        q = disk1[:, None] * e1s + disk2[:, None] * e2s - depth[:, None] * w_hat
    else:
        depth = torch.sqrt(torch.clamp_min(disk_depth2(disk1, disk2), 0.0))
        q = disk_position(disk1, disk2, depth, e1s, e2s, w_hat)
    pos = q / s_diag
    dirn = u_hat.expand_as(pos).clone()
    cell = G.locate_cell(grid, pos, torch.full_like(k1, grid.nr - 1))
    face = torch.tensor([1, grid.nr], dtype=k1.dtype, device=dev).expand(k1.shape[0], 2)
    return pos, dirn, cell, face


def _emit_thermal(t: TransportTables, static: KernelStatic, k0, k1, dtype):
    """Thermal emission (ARTES.f90:1124-1254): the cell from the cumulative
    emissivity CDF, a point inside it, an isotropic or Gordon-biased
    direction. Consumes draw sites 0-5; returns ``pos, dirn, cell, w0``
    with ``w0`` the initial Stokes I, bias weight over cell weight."""
    grid = t.grid
    u_cell, u_r, u_t, u_p, u_a, u_b = R.uniform_n_kk(k0, k1, 0, 6, dtype)
    # birth points stay off the cell faces, as in the JAX package
    u_r = torch.clamp(u_r, 1.0e-4, 1.0 - 1.0e-4)
    u_t = torch.clamp(u_t, 1.0e-4, 1.0 - 1.0e-4)
    target = u_cell * t.emis_cum[-1]
    idx = torch.clamp(torch.searchsorted(t.emis_cum, target, side="left"),
                      0, t.emis_cum.shape[0] - 1)
    cr = idx // (grid.ntheta * grid.nphi)
    ct = (idx // grid.nphi) % grid.ntheta
    cp = idx % grid.nphi
    rf, tc = grid.rfront, grid.theta_cos
    r = rf[cr] + u_r * (rf[cr + 1] - rf[cr])
    cos_t = tc[ct] + u_t * (tc[ct + 1] - tc[ct])
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    if grid.nphi == 1:
        phi = TWO_PI * u_p
    else:
        phifront = G.phi_fronts(grid)
        phi_lo = phifront[cp]
        phi_hi = torch.where(cp == grid.nphi - 1, TWO_PI,
                             phifront[torch.clamp_max(cp + 1, grid.nphi - 1)])
        phi = phi_lo + u_p * (phi_hi - phi_lo)
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
    return pos, dirn, torch.stack([cr, ct, cp], dim=-1), bias_w / t.cell_weight[idx]


def _peel_photon_prep(t: TransportTables, static: KernelStatic, pos, dirn, cr, stokes):
    """The tau-independent part of the per-scatter peel (ARTES.f90:4763-4948):
    matrix at the detector angle, azimuth bookkeeping, Stokes rotation with
    the detector Q sign flip, and the pixel. ``cr`` is the flat cell index."""
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


def _tau_walk(t: TransportTables, pos, dirn, cell):
    """Optical depth from ``pos`` along ``dirn`` to the grid boundary or the
    photon floor: the closed form on a radial grid, the jump walk on a 3-D
    one. Returns ``(tau, surface, walk)``; ``walk`` lets :func:`_march`
    along the same ray reuse the work."""
    if t.jump is None:
        a2, b2, c2, rf, kx, rfl, peps = _radial_lists(t)
        chords = RAD.ray_chords(a2, b2, c2, rf, rfl, peps, *pos.unbind(-1), *dirn.unbind(-1))
        return RAD.tau_from_chords(*chords, kx), chords[2], chords
    w = J.tau_walk_jumps(t.grid, t.jump, t.grid.rfront[t.cell_depth],
                         *pos.unbind(-1), *dirn.unbind(-1), *cell.unbind(-1))
    return w["tau"], w["surface"], w


def _tau_walk_march(t: TransportTables, static: KernelStatic, pos, dirn, cell, face, active):
    """Optical depth of active photons from ``pos`` along ``dirn``, marched
    through ``geometry.cell_face`` from ``cell`` with ``face`` as the
    current face (the peel walk and prewalk of ARTES.f90:623-656,
    :4542-4569). A photon stops at the grid's outer face (``exited``), at
    the photon floor (``surface``) or on a ``cell_face`` error (``error``);
    ``capped`` marks those still marching after ``static.max_crossings``
    passes. Returns a dict of ``tau`` and the four masks."""
    g = t.grid
    n = pos.shape[0]
    dev = pos.device
    tau = torch.zeros(n, dtype=pos.dtype, device=dev)
    flags = {k: torch.zeros(n, dtype=torch.bool, device=dev)
             for k in ("exited", "surface", "error", "capped")}
    idx = active.nonzero()[:, 0]
    p, c, f = pos[idx], cell[idx], face[idx]
    d = dirn[idx] if dirn.dim() == 2 else dirn.expand_as(p)
    for _ in range(static.max_crossings):
        if idx.numel() == 0:
            break
        out = G.cell_face(g, p, d, c, f, t.cell_depth)
        tau[idx] += out["distance"] * t.opacity[flat_cell(g, c)]
        nf = out["next_face"]
        hit = (nf[:, 0] == 1) & (nf[:, 1] == t.cell_depth)
        flags["exited"][idx] = out["grid_exit"]
        flags["surface"][idx] = hit
        flags["error"][idx] = out["error"]
        still = ~(out["grid_exit"] | out["error"] | hit)
        idx = idx[still]
        p = G.fmadd(out["distance"][:, None], d, p)[still]
        d, c, f = d[still], out["cell_out"][still], nf[still]
    flags["capped"][idx] = True
    return {"tau": tau, **flags}


def _flow_book(flow, g: G.GridGeometry, pos, dirn, energy, step, cf, out, cell, crossing):
    """Flow diagnostics of one pass of the marching loop (ARTES.f90:711-744,
    :4992-5047) into ``flow``, the float64 triple ``(ncell, 3)``, ``(ncell,
    4)`` and ``(ncell,)``: energy x step projected on the local (r, theta,
    phi) unit vectors at the advanced position ``pos``, booked into the cell
    the step was made in (``cf``); for a full crossing of a radial or theta
    face, the energy in column 0 up / 1 down / 2 south / 3 north of that
    cell; and energy x step itself, the unsigned total the projections are
    parts of."""
    flow_g, flow_t, flow_path = flow
    x, y, z = pos.unbind(-1)
    r = torch.sqrt(x * x + y * y + z * z)
    theta = torch.arccos(torch.clamp(z / torch.clamp_min(r, 1e-300), -1.0, 1.0))
    phi = torch.arctan2(y, x)
    st, ct, sp, cp = torch.sin(theta), torch.cos(theta), torch.sin(phi), torch.cos(phi)
    dx, dy, dz = dirn.unbind(-1)
    proj = torch.stack([st * cp * dx + st * sp * dy + ct * dz,
                        ct * cp * dx + ct * sp * dy - st * dz,
                        -sp * dx + cp * dy], dim=-1) * (energy * step)[:, None]
    flow_g.index_add_(0, cf, proj.to(torch.float64))
    flow_path.index_add_(0, cf, (energy * step).to(torch.float64))
    axis = out["next_face"][:, 0]
    outward = torch.where(axis == 2, out["cell_out"][:, 1] > cell[:, 1],
                          out["cell_out"][:, 0] > cell[:, 0])
    column = torch.where(axis == 1, torch.where(outward, 0, 1), torch.where(outward, 2, 3))
    ok = crossing & ((axis == 1) | (axis == 2))
    flow_t.index_put_((cf[ok], column[ok]), energy[ok].to(torch.float64), accumulate=True)


def _surface_normal(g: G.GridGeometry, pos):
    """Unit normal of the ellipsoid through ``pos``: (x a^2, y b^2, z c^2)
    normalised."""
    scale = torch.tensor([g.ob_ax * g.ob_ax, g.ob_by * g.ob_by, g.ob_cz * g.ob_cz],
                         dtype=pos.dtype, device=pos.device)
    normal = pos * scale
    return normal / torch.clamp_min(torch.sqrt((normal * normal).sum(-1, keepdim=True)), 1e-300)


def _march_cells(t: TransportTables, static: KernelStatic, k0, pid, ctr, pos, dirn, cell, face,
                 stokes, tau, marching, book_first=None, flow=None):
    """March ``geometry.cell_face`` cell by cell until the running optical
    depth passes ``tau`` (ARTES.f90:687-778). Photons leave the loop at an
    interaction, at the grid's outer face, absorbed at the photon floor or
    with an error; what still marches after ``static.max_crossings`` passes
    is error 032.

    At a crossing onto the floor face the pass's own three draws (site
    ``ctr`` + 3 x passes made) decide the surface event (:755-774): the
    photon is absorbed when the first exceeds the surface albedo, else it is
    reflected unless ``cell_face`` erred: a Lambertian direction about the
    ellipsoid normal, Q = U = V = 0, the cell above the surface, and the
    same march goes on with the optical depth it has left. A reflection
    visible from the observer peels ``e^-tau cos / pi`` on Stokes I through
    ``book_first(pos, value, ok)`` (:4600-4708). With ``flow`` every pass
    books its flow diagnostics (:func:`_flow_book`).

    Returns a dict of the new ``pos``, ``dirn``, ``cell``, ``face`` and
    ``stokes``, the outcome masks ``inter``, ``exited``, ``e031``, ``e034``
    and ``e032``, and ``crossings``, the passes each photon made."""
    g = t.grid
    n = pos.shape[0]
    dev = pos.device
    pos, dirn, cell, face, stokes = (v.clone() for v in (pos, dirn, cell, face, stokes))
    flags = {k: torch.zeros(n, dtype=torch.bool, device=dev)
             for k in ("inter", "exited", "e031", "e034", "e032")}
    crossings = torch.zeros(n, dtype=torch.int64, device=dev)
    idx = marching.nonzero()[:, 0]
    tau_run = torch.zeros_like(tau[idx])
    for it in range(static.max_crossings):
        if idx.numel() == 0:
            break
        p, d, c, f, tb = pos[idx], dirn[idx], cell[idx], face[idx], tau[idx]
        out = G.cell_face(g, p, d, c, f, t.cell_depth)
        dist = out["distance"]
        cf = flat_cell(g, c)
        k = t.opacity[cf]
        tau_cell = dist * k
        interact = G.fmadd(dist, k, tau_run) > tb         # fused, as XLA compiles it
        s_int = (tb - tau_run) / torch.where(k == 0.0, 1.0, k)
        step = torch.where(interact, s_int, dist)
        p = G.fmadd(step[:, None], d, p)
        pos[idx] = p
        crossing = ~interact
        if flow is not None:
            _flow_book(flow, g, p, d, stokes[idx, 0], step, cf, out, c, crossing)
        nf = out["next_face"]
        floor_hit = crossing & (nf[:, 0] == 1) & (nf[:, 1] == t.cell_depth)
        absorbed = torch.zeros_like(floor_hit)
        cell_after = out["cell_out"]
        if bool(floor_hit.any()):
            u_s, u_l1, u_l2 = R.uniform_n_kk(k0, pid[idx], ctr[idx] + 3 * it, 3, p.dtype)
            absorbed = floor_hit & (u_s > t.surface_albedo)
            reflected = floor_hit & ~absorbed & ~out["error"]
            if bool(reflected.any()):
                rf = reflected.nonzero()[:, 0]
                p_r = p[rf]
                normal = _surface_normal(g, p_r)
                cos = (normal * t.det_dir).sum(-1)
                visible = cos > 0.0
                above = cell_after[rf] + torch.tensor([1, 0, 0], dtype=c.dtype, device=dev)
                walk = _tau_walk_march(t, static, p_r, t.det_dir, above, nf[rf], visible)
                weight = torch.exp(-torch.clamp_max(walk["tau"], 500.0)) * cos / math.pi
                ok = (visible & walk["exited"] & (walk["tau"] < 50.0) & ~walk["error"])
                book_first(p_r, weight * stokes[idx[rf], 0], ok)
                stokes[idx[rf], 1:] = 0.0
                dirn[idx[rf]] = M.direction_cosine(torch.sqrt(u_l1[rf]), TWO_PI * u_l2[rf],
                                                   normal)
                cell_after = cell_after.clone()
                cell_after[rf, 0] += 1
        cell[idx] = torch.where(crossing[:, None], cell_after, c)
        face[idx] = torch.where(crossing[:, None], nf, torch.zeros_like(f))
        flags["inter"][idx] = interact
        flags["exited"][idx] = crossing & out["grid_exit"] & ~floor_hit
        flags["e031"][idx] = out["err_nocand"]
        flags["e034"][idx] = out["err_degen"]
        crossings[idx] += 1
        still = crossing & ~out["grid_exit"] & ~absorbed & ~out["error"]
        idx = idx[still]
        tau_run = (tau_run + tau_cell)[still]
    flags["e032"][idx] = True
    return {"pos": pos, "dirn": dirn, "cell": cell, "face": face, "stokes": stokes,
            "crossings": crossings, **flags}


def _march(t: TransportTables, static: KernelStatic, k0, pid, ctr, pos, dirn, cell, face,
           stokes, tau, active, walk=None, book_first=None, flow=None):
    """Walk active photons to the sampled optical depth ``tau``. Returns a
    dict: the new ``pos``, ``dirn``, ``cell``, ``face`` and ``stokes``;
    ``inter`` (interaction), ``exited`` (left through the top), ``error``
    and the per-code masks ``e031``/``e032``/``e034``; ``sites``, the draw
    sites the march reserved.

    ``closed`` walks take the closed form (no errors, no sites; ``flow``
    rides its hook). ``jumps`` walks first check the sampled depth against
    the jump walk's exact total along the ray: a photon that cannot reach it
    exits, or is absorbed at the floor, without marching; the others march
    cell by cell. ``march`` walks march every photon to its end, through the
    surface event and the flow booking of :func:`_march_cells`. A cell-by-cell
    march reserves three draw sites per pass. ``walk`` is :func:`_tau_walk`'s
    third result for the same ray (``closed`` and ``jumps``)."""
    mode = walk_mode(t, static)
    false = torch.zeros_like(active)
    if mode == "closed":
        if walk is None:
            walk = _tau_walk(t, pos, dirn, cell)[2]
        a2, b2, c2, rf, kx, rfl, peps = _radial_lists(t)
        mo = RAD.march(a2, b2, c2, rf, kx, rfl, peps, *pos.unbind(-1), *dirn.unbind(-1),
                       tau, active, chords=walk, energy=stokes[:, 0], flow=flow)
        moved = mo["inter"] | mo["surface"]
        cell_new = torch.stack([mo["cr"], torch.zeros_like(mo["cr"]),
                                torch.zeros_like(mo["cr"])], dim=-1)
        return {"pos": torch.where(moved[:, None], pos + mo["s_stop"][:, None] * dirn, pos),
                "dirn": dirn, "stokes": stokes,
                "cell": torch.where(mo["inter"][:, None], cell_new, cell),
                "face": torch.where(mo["inter"][:, None], torch.zeros_like(face), face),
                "inter": mo["inter"], "exited": mo["exited"], "error": false,
                "e031": false, "e032": false, "e034": false,
                "sites": torch.zeros_like(cell[:, 0])}
    no_reach = false
    if mode == "jumps":
        if walk is None:
            walk = _tau_walk(t, pos, dirn, cell)[2]
        no_reach = active & (tau >= walk["tau"])
    mo = _march_cells(t, static, k0, pid, ctr, pos, dirn, cell, face, stokes, tau,
                      active & ~no_reach, book_first, flow)
    if mode == "jumps":
        mo["exited"] = mo["exited"] | (no_reach & walk["exited"])
    mo["error"] = mo["e031"] | mo["e034"] | mo["e032"]
    mo["sites"] = 3 * mo.pop("crossings")
    return mo


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


def _error_rows(code, pid, pos, dirn, cell, face, stokes_i, n_scat, site):
    """(n, ERR_RECORD_W) float64 error records from per-photon columns."""
    cols = [code, pid, *pos.unbind(-1), *dirn.unbind(-1), *cell.unbind(-1),
            *face.unbind(-1), stokes_i, n_scat,
            torch.full_like(pid, site)]
    return torch.stack([c.to(torch.float64) for c in cols], dim=-1).cpu()


def select_error_records(rows, k: int = ERR_RECORD_K):
    """The first ``k`` and the last ``k`` of the error records ``rows``, a
    list of (n_i, ERR_RECORD_W) tensors that follow each other in photon-id
    order; all of them when there are at most 2k."""
    rec = torch.cat([torch.zeros((0, ERR_RECORD_W), dtype=torch.float64), *rows])
    return rec if rec.shape[0] <= 2 * k else torch.cat([rec[:k], rec[-k:]])


STATE_KEYS = ("pid", "ctr", "pos", "dirn", "cell", "face", "stokes", "n_scat", "row")


def _take(s: dict, mask) -> dict:
    """The photons ``mask`` of a live set: a dict of per-photon tensors
    (:data:`STATE_KEYS`: low id word, draw-site counter, position,
    direction, cell, face, Stokes vector, scatterings so far, row in the
    batch)."""
    return {k: v[mask] for k, v in s.items()}


class _Tally:
    """The tallies of a run on the tables' device, all of them summed in
    float64 or int64 whatever the transport's dtype: detector moments
    ``(npix, 4, 2)`` and counts ``(npix, 2)`` (:func:`_book`), the fluxes,
    the flow sums, the error tallies, and the error records (float64 rows
    on the CPU, in the order they were made). ``out``, a result of
    :func:`start_batch` or :func:`scatter_rounds`, is the tallies to go on
    from."""

    def __init__(self, t: TransportTables, static: KernelStatic, out: dict | None = None):
        dev = t.opacity.device
        npix = static.nx * static.ny
        ncell = t.opacity.shape[0]
        self.t, self.static = t, static
        self.thermal = static.photon_source == 2
        i64 = dict(dtype=torch.int64, device=dev)
        f64 = dict(dtype=torch.float64, device=dev)
        self.flow = None
        if out is None:
            self.det_sum = torch.zeros((npix, 4, 2), **f64)
            self.det_cnt = torch.zeros((npix, 2), **i64)
            self.n_cap, self.n_anom, self.n_error = (torch.zeros((), **i64) for _ in range(3))
            self.error_codes = torch.zeros(4, **i64)
            self.flux_emitted, self.flux_exit = (torch.zeros((), **f64) for _ in range(2))
            if static.track_flow:
                self.flow = tuple(torch.zeros(shape, **f64)
                                  for shape in ((ncell, 3), (ncell, 4), (ncell,)))
            self.records, self.n_unkept = [], 0
            return
        det = out["detector"]
        self.det_sum = det[..., :2].clone()
        self.det_cnt = det[:, :2, 2].to(torch.int64)
        self.n_cap = torch.zeros((), **i64)
        self.n_anom, self.n_error, self.error_codes, self.flux_emitted, self.flux_exit = (
            out[k].clone() for k in ("n_stokes_anomaly", "n_error", "error_codes",
                                     "flux_emitted", "flux_exit"))
        if static.track_flow:
            self.flow = tuple(out[k].clone() for k in ("flow_global", "flow_theta", "flow_path"))
        self.records = [out["error_records"]]
        self.n_unkept = int(out["n_error_records"]) - out["error_records"].shape[0]

    def book_first(self, pos, value, ok):
        """A first-only peel (thermal birth, surface) of Stokes I ``value``."""
        _book(self.det_sum, self.det_cnt, _pixel_index(self.t, self.static, pos),
              value[:, None], ok, first_only=True)

    def march(self, mo, pid, n_scat, site):
        """Error tallies, error records and the exit flux of one march;
        returns which photons interacted without error."""
        err = mo["error"]
        if bool(err.any()):
            self.n_error += err.sum()
            self.error_codes[:3] += torch.stack([mo["e031"].sum(), mo["e032"].sum(),
                                                 mo["e034"].sum()])
            code = torch.where(mo["e031"], 31, torch.where(mo["e034"], 34, 32))[err]
            self.records.append(_error_rows(code, pid[err], mo["pos"][err], mo["dirn"][err],
                                            mo["cell"][err], mo["face"][err],
                                            mo["stokes"][err, 0], n_scat[err], site))
        if self.thermal:
            self.flux_exit += mo["stokes"][mo["exited"], 0].to(torch.float64).sum()
        return mo["inter"] & ~err

    def result(self, err_k: int = ERR_RECORD_K) -> dict:
        """The tallies as a ``run_stream`` result (without ``n_emitted``)."""
        rec = select_error_records(self.records, 1 << 62)
        rec = rec[torch.argsort(rec[:, 1], stable=True)]
        flow = self.flow
        return {
            "detector": detector_from_tallies(self.det_sum, self.det_cnt),
            "flux_emitted": self.flux_emitted,
            "flux_exit": self.flux_exit,
            "flow_global": flow[0] if flow else None,
            "flow_theta": flow[1] if flow else None,
            "flow_path": flow[2] if flow else None,
            "n_error": self.n_error,
            "error_codes": self.error_codes,
            "n_stokes_anomaly": self.n_anom,
            "n_alive_at_cap": self.n_cap,
            "error_records": select_error_records([rec], err_k),
            "n_error_records": self.n_unkept + rec.shape[0],
        }


def _edge_walk(t: TransportTables, static: KernelStatic, pos, dirn, cell, face):
    """``(tau, surface, exited, error, walk)`` of the configuration's walk
    from ``pos`` along ``dirn`` to the grid's edge; a marching walk still
    going at the cap has erred."""
    if walk_mode(t, static) == "march":
        w = _tau_walk_march(t, static, pos, dirn, cell, face,
                            torch.ones_like(cell[:, 0], dtype=torch.bool))
        return w["tau"], w["surface"], w["exited"], w["error"] | w["capped"], None
    tau, surface, walk = _tau_walk(t, pos, dirn.expand_as(pos), cell)
    return tau, surface, ~surface, torch.zeros_like(surface), walk


def _peel_weight(t: TransportTables, static: KernelStatic, pos, cell, face):
    """e^-tau toward the observer, whether the peel is booked, and whether
    its walk failed."""
    tau, _, exited, err, _ = _edge_walk(t, static, pos, t.det_dir, cell, face)
    return torch.exp(-torch.clamp_max(tau, 500.0)), exited & ~err & (tau < 50.0), err


def _start(t: TransportTables, static: KernelStatic, k0: int, pid, acc: _Tally):
    """Emission, the thermal birth peel, the prewalk along the photon's own
    direction and the forced first interaction with its march
    (ARTES.f90:596-778) of the photons whose low id words are ``pid``, into
    ``acc``. A failed birth peel or prewalk (tallied under 031) abandons the
    photon. Returns ``(s, keep)``: the live set of the photons that reached
    their first march and which of them interacted without error."""
    dt = t.opacity.dtype
    dev = t.opacity.device
    n = pid.shape[0]
    row = torch.arange(n, dtype=torch.int64, device=dev)
    stokes = torch.zeros((n, 4), dtype=dt, device=dev)
    if acc.thermal:
        pos, dirn, cell, w0 = _emit_thermal(t, static, k0, pid, dt)
        face = torch.zeros((n, 2), dtype=torch.int64, device=dev)
        ctr = torch.full_like(pid, 6)
        acc.flux_emitted += w0.to(torch.float64).sum()
        stokes[:, 0] = w0
        # birth peel e^-tau/(4 pi) on Stokes I (ARTES.f90:4519-4598); a
        # failed walk abandons the photon
        w_b, ok_b, err_b = _peel_weight(t, static, pos, cell, face)
        acc.book_first(pos, w_b / (4.0 * math.pi) * stokes[:, 0], ok_b)
        if bool(err_b.any()):
            acc.n_error += err_b.sum()
            acc.error_codes[3] += err_b.sum()
            pid, ctr, pos, dirn, cell, face, stokes, row = (
                v[~err_b] for v in (pid, ctr, pos, dirn, cell, face, stokes, row))
    else:
        pos, dirn, cell, face = _emit(t, static, k0, pid, dt)
        ctr = torch.full_like(pid, 2)
        stokes[:, 0] = 1.0

    # the prewalk along the photon's own direction, then the forced first
    # interaction (ARTES.f90:623-684) and its march; a failed prewalk
    # abandons the photon under code 031
    marching = walk_mode(t, static) == "march"
    n_scat = torch.zeros_like(pid)
    tau_first, pre_surface, _, pre_err, walk = _edge_walk(t, static, pos, dirn, cell, face)
    if bool(pre_err.any()):
        acc.n_error += pre_err.sum()
        acc.error_codes[0] += pre_err.sum()
        acc.records.append(_error_rows(torch.full_like(pid[pre_err], 31), pid[pre_err],
                                       pos[pre_err], dirn[pre_err], cell[pre_err],
                                       face[pre_err], stokes[pre_err, 0], n_scat[pre_err], 2))
        ok = ~pre_err
        pid, ctr, pos, dirn, cell, face, stokes, n_scat, row, tau_first, pre_surface = (
            v[ok] for v in (pid, ctr, pos, dirn, cell, face, stokes, n_scat, row, tau_first,
                            pre_surface))
    (u_tau,) = R.uniform_n_kk(k0, pid, ctr, 1, dt)
    ctr = ctr + 1
    thin = tau_first < 1.0e-6
    go = ~(thin & ~pre_surface)         # vacuum, no surface: dropped
    forced = go & ~thin & (tau_first < 50.0)
    one_m_exp = 1.0 - torch.exp(-tau_first)
    tau = torch.where(forced, -torch.log(1.0 - u_tau * one_m_exp),
                      -torch.log(1.0 - u_tau))
    stokes = torch.where(forced[:, None], stokes * one_m_exp[:, None], stokes)
    mo = _march(t, static, k0, pid, ctr, pos, dirn, cell, face, stokes, tau, go, walk,
                acc.book_first, acc.flow)
    keep = acc.march(mo, pid, n_scat, 1 if marching else 0)
    s = dict(pid=pid, ctr=ctr + mo["sites"], n_scat=n_scat, row=row,
             **{k: mo[k] for k in ("pos", "dirn", "cell", "face", "stokes")})
    return s, keep


def _live_round(t: TransportTables, static: KernelStatic, k0: int, s: dict, acc: _Tally):
    """One LIVE round (ARTES.f90:786-951) of the live set ``s`` into
    ``acc``: roulette, the peel, the scattering and the march to the next
    interaction. Returns ``(s, keep)``: the photons that survived the
    roulette (and, with ``static.debug_stokes``, the Stokes check) after
    their march, and which of them interacted without error."""
    dt = t.opacity.dtype
    pid, ctr, pos, dirn, cell, face, stokes, n_scat, row = (s[k] for k in STATE_KEYS)
    cell = G.heal_cell(t.grid, pos, cell, torch.ones_like(pid, dtype=torch.bool))
    cf = flat_cell(t.grid, cell)
    d0, d1, d2, d3, d4 = R.uniform_n_kk(k0, pid, ctr, 5, dt)
    killed = d0 < t.fstop
    alb = t.albedo[cf]
    gamma = torch.where((alb < 1.0) & (alb > 0.0), alb / (1.0 - t.fstop),
                        torch.ones_like(alb))
    stokes = stokes * gamma[:, None]
    surv = ~killed & ~(stokes[:, 0] <= t.photon_minimum)
    pid, ctr, pos, dirn, cell, face, cf, stokes, n_scat, row, d1, d2, d3, d4 = (
        v[surv] for v in (pid, ctr, pos, dirn, cell, face, cf, stokes, n_scat, row,
                          d1, d2, d3, d4))

    peel_contrib, peel_pix = _peel_photon_prep(t, static, pos, dirn, cf, stokes)
    beta, c2b, s2b = S.sample_beta(t.p_int[cf], stokes, d1, d2)
    alpha, alpha_deg = S.sample_alpha_fused(t.alpha_prefix, cf, stokes, (c2b, s2b), d3)
    dir_new = M.direction_cosine(alpha, beta, dirn)
    scat_m = S.matrix_at_angle_deg(t.scatter_rows, cf, alpha_deg)
    stokes = M.polarization_rotation(alpha, beta, stokes, scat_m, dirn, dir_new,
                                     peeling=False, beta_trig=(c2b, s2b))
    dirn = dir_new
    if static.debug_stokes:
        # error 050 (ARTES.f90:830-835): I^2 < Q^2 + U^2 + V^2 after the
        # Mueller update; the photon is abandoned before its peel and
        # march, and recorded with the round's input state
        anom = stokes[:, 0] ** 2 * (1.0 + 1.0e-6) < (stokes[:, 1:] ** 2).sum(dim=-1)
        if bool(anom.any()):
            acc.n_anom += anom.sum()
            acc.n_error += anom.sum()
            acc.records.append(_error_rows(
                torch.full_like(pid[anom], 50), pid[anom], pos[anom], dirn[anom],
                cell[anom], face[anom], stokes[anom, 0], n_scat[anom], 4))
            ok = ~anom
            pid, ctr, pos, dirn, cell, face, stokes, n_scat, row, d4, peel_contrib, peel_pix = (
                v[ok] for v in (pid, ctr, pos, dirn, cell, face, stokes, n_scat, row, d4,
                                peel_contrib, peel_pix))
    n_scat = n_scat + 1

    w_peel, ok_peel, err_peel = _peel_weight(t, static, pos, cell, face)
    _book(acc.det_sum, acc.det_cnt, peel_pix, peel_contrib * w_peel[:, None], ok_peel)

    tau = -torch.log(1.0 - d4)
    ctr = ctr + 5
    mo = _march(t, static, k0, pid, ctr, pos, dirn, cell, face, stokes, tau,
                torch.ones_like(pid, dtype=torch.bool), None, acc.book_first, acc.flow)
    keep = acc.march(mo, pid, n_scat, 0)
    # a failed scatter peel loses its flux only; it is recorded with the
    # walk's input position, cell and face (code 50, site 3) unless the
    # round's march failed too
    if bool(err_peel.any()):
        lost = err_peel & ~mo["error"]
        acc.error_codes[3] += err_peel.sum()
        acc.records.append(_error_rows(
            torch.full_like(pid[lost], 50), pid[lost], pos[lost], mo["dirn"][lost],
            cell[lost], face[lost], mo["stokes"][lost, 0], n_scat[lost], 3))
    s = dict(pid=pid, ctr=ctr + mo["sites"], n_scat=n_scat, row=row,
             **{k: mo[k] for k in ("pos", "dirn", "cell", "face", "stokes")})
    return s, keep


def run_stream(tables: TransportTables, static: KernelStatic, n_photons: int, seed: int,
               width: int, id_hi: int = 0, id_lo: int = 0, err_k: int = ERR_RECORD_K):
    """Transport photons ``id_lo .. id_lo + n_photons - 1`` (high id word
    ``id_hi``) and return the JAX ``run_stream`` tallies.

    The detector is ``(nx*ny, 4, 3)`` float64 [sum, sum of squares, count];
    counts are summed as integers, and the Stokes-I row's count includes the
    thermal birth peels and the surface peels, which the Q, U and V rows'
    counts do not. ``flux_emitted`` (sum of the emitted Stokes I) and
    ``flux_exit`` (sum of the Stokes I leaving through the top) are float64
    and zero for stellar sources. ``flow_global`` (ncell, 3) and
    ``flow_theta`` (ncell, 4) are the float64 flow diagnostics and
    ``flow_path`` (ncell,) the energy x distance booked per cell, which a
    comparison of two ``flow_global`` is scaled by; ``None`` without
    ``static.track_flow``. ``n_error`` counts abandoned photons,
    ``error_codes`` the events of codes [031, 032, 034, peel walk],
    ``n_stokes_anomaly`` those of code 050 (``static.debug_stokes``).
    ``error_records`` holds the first ``err_k`` and the last ``err_k`` error
    records in photon-id order (float64, on the CPU) and ``n_error_records``
    the number of events recorded. ``width`` is the number of photons
    emitted together.
    """
    t = tables
    dev = t.opacity.device
    k0 = R.key_hi(seed, id_hi)
    acc = _Tally(t, static)
    for start in range(0, int(n_photons), width):
        n = min(width, int(n_photons) - start)
        pid = id_lo + start + torch.arange(n, dtype=torch.int64, device=dev)
        s, keep = _start(t, static, k0, pid, acc)
        if not static.photon_scattering:
            keep = torch.zeros_like(keep)
        while True:
            s = _take(s, keep)
            if s["pid"].numel() == 0:
                break
            s, keep = _live_round(t, static, k0, s, acc)
            capped = keep & (s["n_scat"] >= static.max_scatter)
            acc.n_cap += capped.sum()
            keep = keep & ~capped
    return {**acc.result(err_k), "n_emitted": int(n_photons)}


# ---------------------------------------------------------------------------
# The batch transport: an explicit photon-id array and a resumable state
# ---------------------------------------------------------------------------

# the per-photon state of the batch transport (``state`` of start_batch),
# keyed as the JAX package's, and the live-set keys they come from
BATCH_STATE = {"pos": "pos", "dirn": "dirn", "cell": "cell", "face": "face",
               "stokes": "stokes", "counter": "ctr", "n_scat": "n_scat"}


def _batch_ids(photon_ids, device) -> torch.Tensor:
    """The low id words of ``photon_ids`` (any integer type: int64, int32,
    uint32; a tensor or an array) as int64 on ``device``."""
    ids = torch.as_tensor(photon_ids)
    if ids.dtype.is_floating_point or ids.dtype == torch.bool:
        raise TypeError(f"photon ids are integers, not {ids.dtype}")
    return ids.to(device=device, dtype=torch.int64) & R.MASK32


def start_batch(tables: TransportTables, static: KernelStatic, photon_ids, seed: int):
    """Emission, birth peel, prewalk, forced first interaction and first
    march of the photons ``photon_ids`` (``artes_tpu.transport.kernel.
    start_batch``), in plain PyTorch on the tables' device.

    Each photon is keyed by ``(seed, id & 0xFFFFFFFF)``, as the JAX
    package's ``rng.photon_keys(seed, ids)``, so its history is the one it
    gets in :func:`run_stream` with the same seed and low id word. Returns
    ``(state, out)``: ``state`` the resumable per-photon state, a dict of
    ``pos``, ``dirn``, ``cell``, ``face``, ``stokes``, ``alive`` (interacted
    without error), ``counter`` (the next draw site), ``photon_ids`` (the
    low id words, int64) and ``n_scat`` (scatterings so far, which error
    records carry), one row a photon in the order of ``photon_ids``; a
    photon abandoned before its first march keeps zeros. ``out`` the
    tallies so far, keyed as :func:`run_batch`'s. The detector, fluxes and
    flow are summed in float64 whatever the tables' dtype (JAX sums in the
    transport dtype unless ``det_f64``: the two agree at float64)."""
    t = tables
    dev = t.opacity.device
    pid = _batch_ids(photon_ids, dev)
    n = pid.shape[0]
    acc = _Tally(t, static)
    s, keep = _start(t, static, R.key_hi(seed), pid, acc)
    state = {"photon_ids": pid, "alive": torch.zeros(n, dtype=torch.bool, device=dev)}
    for key, k in BATCH_STATE.items():
        state[key] = torch.zeros((n, *s[k].shape[1:]), dtype=s[k].dtype, device=dev)
        state[key][s["row"]] = s[k]
    state["alive"][s["row"]] = keep
    out = acc.result()
    out["n_alive_at_cap"] = state["alive"].sum()
    return state, out


def scatter_rounds(tables: TransportTables, static: KernelStatic, state: dict, seed: int,
                   rounds: int, out: dict):
    """Up to ``rounds`` LIVE rounds of the photons alive in ``state``, the
    tallies going on from ``out`` (``artes_tpu.transport.kernel.
    _scatter_rounds_impl``; resumable: two calls of k and m rounds equal one
    of k + m, bit for bit on the CPU). Without ``static.photon_scattering``
    no round runs. Returns ``(state, out)``: the new state, and the tallies
    summed from ``out`` on, ``n_alive_at_cap`` the photons still alive."""
    t = tables
    state = {k: v.clone() for k, v in state.items()}
    acc = _Tally(t, static, out)
    alive = state["alive"]
    rows = alive.nonzero()[:, 0]
    s = {k: state[key][rows] for key, k in BATCH_STATE.items()}
    s.update(pid=state["photon_ids"][rows], row=rows)
    k0 = R.key_hi(seed)
    for _ in range(rounds if static.photon_scattering else 0):
        if s["pid"].numel() == 0:
            break
        alive[s["row"]] = False
        s, keep = _live_round(t, static, k0, s, acc)
        for key, k in BATCH_STATE.items():
            state[key][s["row"]] = s[k]
        alive[s["row"]] = keep
        s = _take(s, keep)
    res = acc.result()
    res["n_alive_at_cap"] = alive.sum()
    return state, res


def run_batch(tables: TransportTables, static: KernelStatic, photon_ids, seed: int) -> dict:
    """Transport the photons ``photon_ids`` (``artes_tpu.transport.kernel.
    run_batch``): :func:`start_batch`, then :func:`scatter_rounds` for
    ``static.max_scatter`` rounds over the whole batch, in plain PyTorch on
    the tables' device (a CUDA device or the CPU; float32 or float64).

    Returns the JAX keys, ``detector`` (nx*ny, 4, 3) float64 [sum, sum of
    squares, count], ``flow_global``, ``flow_theta`` (``None`` without
    ``static.track_flow``), ``flux_emitted``, ``flux_exit``, ``n_error``,
    ``error_codes`` and ``n_alive_at_cap`` (the photons still alive after
    the last round; without scattering, the photons whose first march
    interacted, as in JAX), and those of :func:`run_stream`:
    ``n_stokes_anomaly``, ``error_records``, ``n_error_records``,
    ``flow_path`` and ``n_emitted``. Every photon has the history it has
    in :func:`run_stream`: the same photons give the same tallies."""
    state, out = start_batch(tables, static, photon_ids, seed)
    _, out = scatter_rounds(tables, static, state, seed, static.max_scatter, out)
    out["n_emitted"] = int(state["photon_ids"].shape[0])
    return out
