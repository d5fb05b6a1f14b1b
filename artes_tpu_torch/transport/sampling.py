"""Stokes-weighted scattering-angle sampling and matrix interpolation.

Counterpart of ``artes_tpu.transport.sampling``: the azimuth is the exact
inverse of the continuous Stokes-weighted CDF (bracket on 16 coarse edges,
then a guarded Newton polish), the scattering angle inverts the tabulated
180-bin CDF hierarchically (15 coarse blocks of 12 bins), and the matrix is
interpolated between half-degree-centred rows (ARTES.f90:1448-1661).

Per-cell rows are indexed directly (the JAX package's gather branch); its
one-hot contraction for small grids is a TPU layout choice.
"""

from __future__ import annotations

import math

import numpy as np
import torch

N_ANGLE = 180
N_COARSE = 15          # coarse blocks in the hierarchical alpha inversion
N_FINE = 12            # bins per coarse block
DEG = math.pi / 180.0

NEWTON_ITERS = 3
N_BETA_COARSE = 16
# continuous-CDF basis at the coarse azimuth edges j*pi/16:
# F(beta) = a*beta + b*sin(2 beta)/2 + c*(1 - cos(2 beta))/2
BETA_EDGES = np.linspace(0.0, np.pi, N_BETA_COARSE + 1)
BETA_BASIS = np.stack([BETA_EDGES,
                       0.5 * np.sin(2.0 * BETA_EDGES),
                       0.5 * (1.0 - np.cos(2.0 * BETA_EDGES))])  # (3, 17)
# sin/cos of 2*edge at the 16 bracket-lo edges, cast to the table dtype
BETA_EDGE_SIN2 = np.sin(2.0 * BETA_EDGES[:N_BETA_COARSE])
BETA_EDGE_COS2 = np.cos(2.0 * BETA_EDGES[:N_BETA_COARSE])


def sincos_2beta(delta, s2lo, c2lo):
    """sin/cos(2 beta) for beta = lo0 + delta, delta in [0, pi/16]: angle
    addition off the bracket's lower edge with small-angle polynomials
    (series error < 3e-7, below f32 resolution)."""
    x = 2.0 * delta
    x2 = x * x
    sx = x * (1.0 + x2 * (-1.0 / 6.0 + x2 * (1.0 / 120.0)))
    cx = 1.0 + x2 * (-0.5 + x2 * (1.0 / 24.0 - x2 * (1.0 / 720.0)))
    return s2lo * cx + c2lo * sx, c2lo * cx - s2lo * sx


def build_alpha_prefix(scatter_cell):
    """Per-cell prefix tables of the scattering-angle CDF (numpy).

    ``scatter_cell``: (..., 180, 16) matrices. Returns (..., 4, 181) prefix
    sums over bins of P1k(i) * sinbeta(i) * pi/180 (ARTES.f90:1610-1623).
    """
    from artes_tpu_torch.atmosphere import SINBETA

    w = SINBETA * DEG
    weighted = scatter_cell[..., :4] * w[..., :, None]
    prefix = np.cumsum(weighted, axis=-2)
    zeros = np.zeros_like(prefix[..., :1, :])
    return np.concatenate([zeros, prefix], axis=-2).swapaxes(-1, -2)


def _edge_count(cum, target, lo, hi):
    """Count of edges j in [lo, hi) with cum[..., j] < target (the
    reference's linear scan, ARTES.f90:1565-1587). Strict ``<``."""
    return torch.sum(cum[..., lo:hi] < target[..., None], dim=-1)


def _pick_edges(cum, k):
    """(cum[k-1], cum[k])."""
    lo = torch.gather(cum, -1, (k - 1)[..., None])[..., 0]
    hi = torch.gather(cum, -1, k[..., None])[..., 0]
    return lo, hi


def sample_beta(p_int, stokes, u1, u2):
    """Azimuthal scattering angle from the continuous Stokes-weighted CDF
    (ARTES.f90:1545-1593). ``p_int``: (B, 4) per-cell [P11..P14] integrals.
    Returns ``(beta, cos 2beta, sin 2beta)`` with beta in (0, 2 pi).

    float32 runs the Newton loop on the :func:`sincos_2beta` polynomial,
    float64 on exact sin/cos; the final trig is exact in both.
    """
    dt = stokes.dtype
    dev = stokes.device
    i, q, u, v = stokes.unbind(-1)
    p11, p12, p13, p14 = p_int.unbind(-1)
    a = p11 * i + p14 * v
    b = p12 * q + p13 * u
    c = p12 * u - p13 * q

    pi_ = torch.tensor(math.pi, dtype=dt, device=dev)
    a_safe = torch.where(a == 0.0, 1.0, a)
    target = u1 * a * pi_             # F(pi) = a*pi exactly
    basis = torch.as_tensor(BETA_BASIS, dtype=dt, device=dev)
    cum = a[..., None] * basis[0] + b[..., None] * basis[1] + c[..., None] * basis[2]
    k = _edge_count(cum, target, 1, N_BETA_COARSE)       # block in [0, 15]
    cum_lo, cum_hi = _pick_edges(cum, k + 1)
    width = pi_ / N_BETA_COARSE
    lo = k.to(dt) * width
    hi = lo + width
    lo0 = lo
    s2lo = torch.as_tensor(BETA_EDGE_SIN2, dtype=dt, device=dev)[k]
    c2lo = torch.as_tensor(BETA_EDGE_COS2, dtype=dt, device=dev)[k]
    dcum = cum_hi - cum_lo
    beta = lo + width * torch.where(dcum > 0.0,
                                    (target - cum_lo) / torch.where(dcum == 0.0, 1.0, dcum),
                                    0.5)
    gp_floor = 1e-12 * torch.abs(a_safe)
    use_poly = dt == torch.float32
    for _ in range(NEWTON_ITERS):
        if use_poly:
            s2b, c2b = sincos_2beta(beta - lo0, s2lo, c2lo)
        else:
            s2b = torch.sin(2.0 * beta)
            c2b = torch.cos(2.0 * beta)
        g = a * beta + 0.5 * b * s2b + 0.5 * c * (1.0 - c2b) - target
        gp = a + b * c2b + c * s2b
        lo = torch.where(g < 0.0, beta, lo)
        hi = torch.where(g < 0.0, hi, beta)
        beta_n = beta - g / torch.maximum(gp, gp_floor)
        # strict outside test: a converged step landing ON the edge is kept
        bad = (beta_n < lo) | (beta_n > hi) | ~torch.isfinite(beta_n)
        beta = torch.where(bad, 0.5 * (lo + hi), beta_n)
    c2b = torch.cos(2.0 * beta)
    s2b = torch.sin(2.0 * beta)
    # mirror to the other half-plane with probability 1/2 (:1589-1590)
    beta = torch.where(u2 > 0.5, beta + pi_, beta)
    two_pi = 2.0 * math.pi
    beta = torch.where(beta >= two_pi, two_pi - 1.0e-10, beta)
    beta = torch.where(beta <= 0.0, 1.0e-10, beta)
    return beta, c2b, s2b


def alpha_weights(stokes, c2b, s2b):
    """Coefficients of each matrix-row prefix in the conditional alpha CDF
    (ARTES.f90:1612-1617). Returns (B, 4)."""
    i, q, u, v = stokes.unbind(-1)
    return torch.stack([i, c2b * q + s2b * u, -s2b * q + c2b * u, v], dim=-1)


def _dot4(w, rows):
    """sum_k w[..., k] * rows[..., k, j] in k order."""
    return (w[..., 0:1] * rows[..., 0, :] + w[..., 1:2] * rows[..., 1, :]
            + w[..., 2:3] * rows[..., 2, :] + w[..., 3:4] * rows[..., 3, :])


def sample_alpha_fused(alpha_prefix_all, cell_flat, stokes, beta_trig, u3):
    """Scattering-angle cosine from the conditional tabulated CDF
    (ARTES.f90:1597-1659), inverted over 15 coarse x 12 fine bins.
    ``alpha_prefix_all``: (ncell, 4, 181). Returns ``(alpha, alpha_deg)``.
    """
    c2b, s2b = beta_trig
    dt = stokes.dtype
    w = alpha_weights(stokes, c2b, s2b)
    rows = alpha_prefix_all[cell_flat]                     # (B, 4, 181)
    cum_c = _dot4(w, rows[..., ::N_FINE])                  # (B, 16)
    target = u3 * cum_c[..., -1]
    k1 = _edge_count(cum_c, target, 1, N_COARSE)           # block in [0, 14]
    idx = (k1 * N_FINE)[..., None, None] + torch.arange(N_FINE + 1, device=k1.device)
    fine = torch.gather(rows, -1, idx.expand(-1, 4, -1))   # (B, 4, 13)
    cum_f = _dot4(w, fine)
    k2 = 1 + _edge_count(cum_f, target, 1, N_FINE)         # fine edge in [1, 12]
    cum_lo, cum_hi = _pick_edges(cum_f, k2)
    dcum = cum_hi - cum_lo
    frac = (target - cum_lo) / torch.where(dcum == 0.0, 1.0, dcum)
    frac = torch.where(dcum == 0.0, 0.5, frac)
    alpha_deg = (k1 * N_FINE + k2 - 1).to(dt) + frac
    eps = 1.0e-10
    alpha = torch.clamp(torch.cos(alpha_deg * DEG), -1.0 + eps, 1.0 - eps)
    return alpha, alpha_deg


def matrix_at_angle_deg(scatter_rows, cell_flat, angle_deg):
    """16-element matrix at a scattering angle in degrees: linear between
    rows centred at (i - 0.5) degrees, clamped at the ends
    (ARTES.f90:1506-1509). ``scatter_rows``: (ncell * 180, 16)."""
    t = angle_deg - 0.5
    r0 = torch.clamp(torch.floor(t).to(torch.int64), 0, N_ANGLE - 2)
    frac = torch.clamp(t - r0.to(angle_deg.dtype), 0.0, 1.0)
    base = cell_flat * N_ANGLE
    row0 = scatter_rows[base + r0]
    row1 = scatter_rows[base + r0 + 1]
    m = row0 + (row1 - row0) * frac[..., None]
    return m.reshape(m.shape[:-1] + (4, 4))


def matrix_at_angle(scatter_rows, cell_flat, acos_alpha):
    """:func:`matrix_at_angle_deg` for an angle in radians."""
    return matrix_at_angle_deg(scatter_rows, cell_flat, acos_alpha / DEG)


def alpha_tables(alpha_prefix_all):
    """Hierarchical views of the ``(ncell, 4, 181)`` zenith prefix table
    (``artes_tpu.transport.sampling.alpha_tables``): ``(coarse, fine)``,
    coarse ``(ncell, 4, 16)`` the prefix at every ``N_FINE``-th edge, fine
    ``(ncell, 15, 4, 13)`` the ``N_FINE + 1`` edges of each of the
    ``N_COARSE`` blocks (a block's last edge is the next one's first).
    :func:`sample_alpha_fused` reads the same edges from the rows
    directly."""
    nc = alpha_prefix_all.shape[0]
    coarse = alpha_prefix_all[:, :, ::N_FINE]
    body = alpha_prefix_all[:, :, :N_ANGLE].reshape(nc, 4, N_COARSE, N_FINE)
    last = alpha_prefix_all[:, :, N_FINE::N_FINE].reshape(nc, 4, N_COARSE, 1)
    return coarse, torch.cat([body, last], dim=-1).transpose(1, 2)
