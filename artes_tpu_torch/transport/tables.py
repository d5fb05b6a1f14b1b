"""Host-side per-wavelength table preparation for the transport kernel.

Counterpart of ``artes_tpu.transport.tables`` (``grid_initialize`` mode 2,
ARTES.f90:2325-2505): the photon floor ``cell_depth`` and the flattened cell
tables, built in numpy float64 and placed on one device in one dtype. All
lengths are scaled by the outer radius. Thermal sources add the cell
luminosities, emission weights and the cumulative emissivity CDF
(ARTES.f90:2395-2453).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from artes_tpu_torch import spans
from artes_tpu_torch.constants import PI, planck_lambda
from artes_tpu_torch.transport import jumps as J
from artes_tpu_torch.transport import sampling as S
from artes_tpu_torch.transport.geometry import make_grid_geometry
from artes_tpu_torch.transport.kernel import TransportTables


def compute_cell_depth(atm, wl_index: int, photon_source: int, ring: bool = False) -> int:
    """Radial photon floor (ARTES.f90:2329-2393): the deepest radial index
    each (theta, phi) column reaches before its tau from the top passes 30
    (stellar) or its absorption tau passes 5 (thermal); the minimum over
    columns."""
    if photon_source == 1:
        k = atm.k_ext[:, :, :, wl_index]
        limit = 30.0
        grid_out = 0
    else:
        k = atm.k_abs[:, :, :, wl_index]
        limit = 5.0
        grid_out = 2 if ring else 0
    nr = atm.nr
    dr = np.diff(atm.rfront)
    cell_max = nr
    for j in range(atm.ntheta):
        for p in range(atm.nphi):
            tau = 0.0
            depth = nr - 1
            for i in range(grid_out, nr):
                idx = nr - i - 1
                tau += k[idx, j, p] * dr[idx]
                depth = idx
                if tau > limit:
                    break
            cell_max = min(cell_max, depth)
    return int(cell_max)


def thermal_emission_tables(atm, wl_index: int, cell_depth: int, thermal_weight: bool,
                            oblateness: float = 0.0):
    """Cell luminosity, emission weights and cumulative emissivity CDF
    (ARTES.f90:2395-2453), float64 and flattened over cells in (r, theta,
    phi) order: ``(luminosity, weight, cum)``; ``cum[-1]`` is the total
    weighted emissivity [W m-1]."""
    nr = atm.nr
    wavelength = atm.wavelengths[wl_index]
    volume = atm.cell_volume(1.0 / (1.0 - oblateness), 1.0 / (1.0 - oblateness), 1.0)
    k_abs = atm.k_abs[:, :, :, wl_index]
    temp = atm.temperature
    planck = np.where(temp > 0.0, planck_lambda(np.maximum(temp, 1.0), wavelength), 0.0)
    emitting = (temp > 0.0) & (k_abs > 0.0)
    emitting[:cell_depth] = False
    lum = np.where(emitting, 4.0 * PI * volume * k_abs * planck, 0.0)  # [W m-1]
    weight_norm = float((volume * k_abs * planck * ((temp > 0.0) &
                         (np.arange(nr)[:, None, None] >= cell_depth))).sum())
    if thermal_weight:
        with np.errstate(divide="ignore", invalid="ignore"):
            weight = np.where(emitting,
                              weight_norm / np.maximum(volume * k_abs * planck, 1e-300), 1.0)
    else:
        weight = np.ones_like(lum)
    # the CDF is summed in float64 and cast once, so its float32 lower-bound
    # search sees the JAX package's values
    cum = np.cumsum(np.where(emitting, lum * weight, 0.0).reshape(-1))
    return lum, weight.reshape(-1), cum


@dataclasses.dataclass
class PreparedWavelength:
    """Everything the runner needs for one wavelength."""

    tables: TransportTables
    r_scale: float
    cell_depth: int
    emissivity_total: float   # [W m-1] (0 for stellar runs)
    cell_luminosity: np.ndarray | None


def build_tables(atm, cfg, det, wl_index: int, dtype=torch.float64,
                 device="cpu") -> PreparedWavelength:
    """Tables for wavelength ``wl_index`` on ``device`` in ``dtype``.

    ``cfg`` is an :class:`~artes_tpu.config.ArtesConfig`, ``det`` a
    :class:`~artes_tpu.config.DetectorSetup`. Recorded as the span
    ``tables`` (``artes_tpu_torch.spans``) with the children
    ``tables.geometry`` (``make_grid_geometry``), ``tables.depth``
    (``compute_cell_depth``), ``tables.cells`` (the per-cell rows, the
    emission tables and their uploads) and, where the jump walks need them,
    ``tables.jumps`` (``jump_tables_of``).
    """
    with spans.span("tables"):
        source = 1 if cfg.photon_source == "star" else 2
        with spans.span("tables.geometry"):
            grid, r_scale = make_grid_geometry(atm, cfg.oblateness, dtype=dtype, device=device)
        with spans.span("tables.depth"):
            cell_depth = compute_cell_depth(atm, wl_index, source, cfg.ring)
        with spans.span("tables.cells"):
            tables, lum, emis_total = _cell_tables(atm, cfg, det, wl_index, source, grid,
                                                   r_scale, cell_depth, dtype, device)
        # the jump walks serve 3-D grids without a Lambert surface and without
        # flow diagnostics (kernel.walk_mode); every other walk reads no jump
        # table
        if not (cfg.surface_albedo > 0.0 or cfg.flow_global or cfg.flow_theta):
            with spans.span("tables.jumps"):
                tables.jump = J.jump_tables_of(grid, tables.opacity)
    return PreparedWavelength(tables=tables, r_scale=r_scale, cell_depth=cell_depth,
                              emissivity_total=emis_total, cell_luminosity=lum)


def _cell_tables(atm, cfg, det, wl_index, source, grid, r_scale, cell_depth, dtype, device):
    """The per-cell tables and the detector's and run's scalars on
    ``device``: ``(TransportTables without jump tables, cell luminosity or
    None, total emissivity)``."""
    ncell = atm.nr * atm.ntheta * atm.nphi
    k_ext = atm.k_ext[:, :, :, wl_index].reshape(-1) * r_scale
    albedo = atm.albedo[:, :, :, wl_index].reshape(-1)
    scatter = np.ascontiguousarray(atm.scatter[:, :, :, wl_index])
    st, ct = np.sin(det.det_theta), np.cos(det.det_theta)
    sp, cp = np.sin(det.det_phi), np.cos(det.det_phi)
    lum, emis_total = None, 0.0
    if source == 2:
        lum, weight, cum = thermal_emission_tables(atm, wl_index, cell_depth,
                                                   cfg.thermal_weight, cfg.oblateness)
        emis_total = float(cum[-1])
    else:
        weight, cum = np.ones(ncell), np.zeros(ncell)

    def t(x):
        return torch.as_tensor(np.array(x, np.float64, order="C"), dtype=dtype, device=device)

    tables = TransportTables(
        grid=grid,
        opacity=t(k_ext),
        albedo=t(albedo),
        scatter_rows=t(scatter.reshape(ncell * 180, 16)),
        alpha_prefix=t(S.build_alpha_prefix(scatter.reshape(ncell, 180, 16))),
        p_int=t(atm.p_int[:, :, :, wl_index].reshape(ncell, 4)),
        cell_depth=torch.tensor(cell_depth, dtype=torch.int64, device=device),
        emis_cum=t(cum),
        cell_weight=t(weight),
        det_dir=t(det.direction),
        det_trig=t([st, ct, sp, cp]),
        x_max=t(det.x_max / r_scale),
        y_max=t(det.y_max / r_scale),
        surface_albedo=t(cfg.surface_albedo),
        fstop=t(cfg.fstop),
        photon_minimum=t(cfg.photon_minimum),
        photon_bias=t(cfg.photon_bias),
        star_theta=t(cfg.theta_star),
        star_phi=t(cfg.phi_star),
    )
    return tables, lum, emis_total
