# Frozen copy of artes_tpu_torch/transport/mueller.py at commit bba47c3; only its imports
# are renamed. The benchmark's reference: it imports nothing of artes_tpu_torch.
"""Stokes-vector algebra: rotations, scattering application, new directions.

Counterpart of ``artes_tpu.transport.mueller`` (meridian-plane bookkeeping
of ARTES.f90:1663-2052 as branch-free batched math, with both
renormalisations kept). Stokes vectors are ``(..., 4)`` tensors, directions
``(..., 3)``.
"""

from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi


def mueller_rotate_cs(stokes, c2p, s2p):
    """Rotate (Q, U) by (cos 2psi, sin 2psi) and renormalise so the
    polarized intensity is unchanged (ARTES.f90:1762-1781, :1942-1953)."""
    i, q, u, v = stokes.unbind(-1)
    q_new = c2p * q + s2p * u
    u_new = -s2p * q + c2p * u
    p_in = torch.sqrt(q * q + u * u + v * v)
    p_out = torch.sqrt(q_new * q_new + u_new * u_new + v * v)
    norm = torch.where(p_out > 0.0, p_in / torch.where(p_out == 0.0, 1.0, p_out), 1.0)
    return torch.stack([i, q_new * norm, u_new * norm, v * norm], dim=-1)


def mueller_rotate(stokes, psi):
    """:func:`mueller_rotate_cs` for an angle psi."""
    return mueller_rotate_cs(stokes, torch.cos(2.0 * psi), torch.sin(2.0 * psi))


def apply_scatter(scatter, stokes):
    """(..., 4, 4) @ (..., 4), summed in column order."""
    return (scatter[..., 0] * stokes[..., 0:1] + scatter[..., 1] * stokes[..., 1:2]
            + scatter[..., 2] * stokes[..., 2:3] + scatter[..., 3] * stokes[..., 3:4])


def _cos_to_double_angle(cpsi, sign_sin):
    """(cos 2psi, sin 2psi) from cos(psi) and the sign of sin(psi)."""
    c2 = 2.0 * cpsi * cpsi - 1.0
    s2 = 2.0 * cpsi * torch.sqrt(torch.clamp_min(1.0 - cpsi * cpsi, 0.0)) * sign_sin
    return c2, s2


def polarization_rotation(alpha, beta, stokes, scatter, dirn, dirn_new,
                          peeling: bool, beta_trig=None, beta_sign=None):
    """Meridian -> scattering plane -> meridian Stokes update.

    ``alpha`` is the cosine of the scattering angle, ``beta`` the azimuth in
    [0, 2 pi) (unused when ``beta_trig`` = (cos 2beta, sin 2beta) and
    ``beta_sign`` are given), ``scatter`` the (..., 4, 4) matrix at the
    scattering angle. Assumes |alpha| < 1.
    """
    dz = dirn[..., 2]
    dzn = dirn_new[..., 2]
    salpha = torch.sqrt(torch.clamp_min(1.0 - alpha * alpha, 0.0))
    szn = torch.sqrt(torch.clamp_min(1.0 - dzn * dzn, 0.0))
    denom = salpha * szn
    cbeta2 = torch.clamp((dz - dzn * alpha) / torch.where(denom == 0.0, 1.0, denom),
                         -1.0, 1.0)
    cbeta2 = torch.where(denom == 0.0, 1.0, cbeta2)

    if beta_trig is None:
        c2b, s2b = torch.cos(2.0 * beta), torch.sin(2.0 * beta)
    else:
        c2b, s2b = beta_trig
    stokes_rot = mueller_rotate_cs(stokes, c2b, s2b)
    stokes_sc = apply_scatter(scatter, stokes_rot)
    if not peeling:
        # conserve Stokes I across the scattering event (:1799-1814)
        i_sc = stokes_sc[..., 0]
        norm = torch.where(i_sc > 0.0,
                           stokes_rot[..., 0] / torch.where(i_sc == 0.0, 1.0, i_sc), 0.0)
        stokes_sc = stokes_sc * norm[..., None]
    if beta_sign is None:
        beta_sign = torch.where(beta < math.pi, 1.0, -1.0).to(stokes.dtype)
    c2p2, s2p2 = _cos_to_double_angle(cbeta2, beta_sign)
    return mueller_rotate_cs(stokes_sc, c2p2, s2p2)


def direction_cosine(alpha, beta, dirn):
    """New propagation direction from (alpha, beta) in the meridian-frame
    basis (ARTES.f90:1962-2052), renormalised to unit length."""
    dx, dy, dz = dirn.unbind(-1)
    sto = torch.sqrt(torch.clamp_min(1.0 - dz * dz, 0.0))
    degen = sto < 1.0e-12
    inv = 1.0 / torch.where(degen, 1.0, sto)
    e1x = torch.where(degen, 1.0, -dz * dx * inv)
    e1y = torch.where(degen, 0.0, -dz * dy * inv)
    e1z = torch.where(degen, 0.0, sto)
    e2x = torch.where(degen, 0.0, -dy * inv)
    e2y = torch.where(degen, -dz, dx * inv)
    e2z = torch.zeros_like(dz)

    salpha = torch.sqrt(torch.clamp_min(1.0 - alpha * alpha, 0.0))
    cb = torch.cos(beta)
    sb = torch.sin(beta)
    nx = alpha * dx + salpha * (cb * e1x + sb * e2x)
    ny = alpha * dy + salpha * (cb * e1y + sb * e2y)
    nz = alpha * dz + salpha * (cb * e1z + sb * e2z)
    inv_norm = 1.0 / torch.sqrt(nx * nx + ny * ny + nz * nz)
    return torch.stack([nx * inv_norm, ny * inv_norm, nz * inv_norm], dim=-1)


def rotation_matrix(axis: int, angle):
    """3x3 axis rotation (ARTES.f90:1270-1326); axis in {0: x, 1: y, 2: z}."""
    c = torch.cos(angle)
    s = torch.sin(angle)
    zero = torch.zeros_like(c)
    one = torch.ones_like(c)
    if axis == 0:
        rows = [[one, zero, zero], [zero, c, -s], [zero, s, c]]
    elif axis == 1:
        rows = [[c, zero, s], [zero, one, zero], [-s, zero, c]]
    else:
        rows = [[c, -s, zero], [s, c, zero], [zero, zero, one]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)
