"""Rayleigh scattering opacity generator (python/opacityRayleigh.py).

Cross-section from the H2 refractive index with a depolarization factor
(opacityRayleigh.py:54-66); the analytic 16-element Rayleigh matrix
(opacityRayleigh.py:92-109) is bin-averaged over 1-degree bins and
normalised to the analytic integral of P11.
"""

from __future__ import annotations

import numpy as np

from artes_tpu_torch.constants import AVOGADRO, LOSCHMIDT, PI
from artes_tpu_torch.opacity.base import OpacityTable, bin_average_matrix


def h2_refractive_index(wavelength_um):
    a = 13.58e-5
    b = 7.52e-3
    return 1.0 + a + a * b / (wavelength_um * wavelength_um)


def rayleigh_cross_section(wavelength_um, depolarization=0.0):
    """Rayleigh cross section [cm2] per molecule (opacityRayleigh.py:58-64)."""
    ri = h2_refractive_index(wavelength_um)
    rindex = (ri * ri - 1.0) ** 2 / (ri * ri + 2.0) ** 2
    dep = (6.0 + 3.0 * depolarization) / (6.0 - 7.0 * depolarization)
    return 24.0 * PI**3 * rindex * dep / ((wavelength_um * 1.0e-4) ** 4 * LOSCHMIDT**2)


def rayleigh_matrix16(cos_alpha, depolarization=0.0):
    """Unnormalised 16-element Rayleigh matrix (opacityRayleigh.py:92-109)."""
    m = np.zeros(16)
    delta = (1.0 - depolarization) / (1.0 + depolarization / 2.0)
    delta_p = (1.0 - 2.0 * depolarization) / (1.0 - depolarization)
    m[0] = cos_alpha * cos_alpha + 1.0
    m[1] = cos_alpha * cos_alpha - 1.0
    m[4] = m[1]
    m[5] = m[0]
    m[10] = 2.0 * cos_alpha
    m[15] = delta_p * m[10]
    m = delta * m
    m[0] += 1.0 - delta
    return m


def rayleigh_p11_norm(depolarization=0.0, n=200001):
    """2*pi*int_0^pi P11(theta) sin(theta) dtheta via dense Simpson."""
    theta = np.linspace(0.0, PI, n)
    delta = (1.0 - depolarization) / (1.0 + depolarization / 2.0)
    c = np.cos(theta)
    p11 = (c * c + 1.0) * delta + (1.0 - delta)
    y = p11 * np.sin(theta)
    h = theta[1] - theta[0]
    integral = h / 3.0 * (y[0] + y[-1] + 4.0 * y[1:-1:2].sum() + 2.0 * y[2:-2:2].sum())
    return 2.0 * PI * integral


def generate(wavelengths_um, mmw_scat=2.02, depolarization=0.0,
             single_scattering_albedo=1.0) -> OpacityTable:
    wl = np.asarray(wavelengths_um, dtype=float)
    gas_mass = mmw_scat / AVOGADRO  # molecule mass [g]
    kappa_sca = rayleigh_cross_section(wl, depolarization) / gas_mass  # [cm2 g-1]
    kappa_ext = kappa_sca / single_scattering_albedo
    kappa_abs = kappa_ext - kappa_sca

    norm = rayleigh_p11_norm(depolarization)
    scatter = bin_average_matrix(
        lambda c: rayleigh_matrix16(c, depolarization), wl, norm_per_wl=np.full(len(wl), norm)
    )
    return OpacityTable(wl, kappa_ext, kappa_abs, kappa_sca, scatter)
