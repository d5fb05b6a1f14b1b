# Frozen copy of artes_tpu_torch/opacity/rayleigh.py and of
# artes_tpu_torch/opacity/base.py::bin_average_matrix at commit bba47c3.
"""The Rayleigh opacity table (python/opacityRayleigh.py): the H2 cross
section with a depolarization factor and the bin-averaged 16-element matrix,
normalised to the analytic integral of P11."""

from __future__ import annotations

import numpy as np

from portbench.reference.constants import AVOGADRO, LOSCHMIDT, PI

N_ANGLE = 180


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


def bin_average_matrix(matrix_of_cos, wavelengths, norm_per_wl=None) -> np.ndarray:
    """Average an analytic matrix function over 1-degree bins.

    ``matrix_of_cos(cos_alpha) -> (16,)``. The reference averages the two bin
    edges (opacityRayleigh.py:113-122).
    """
    nl = len(wavelengths)
    out = np.zeros((N_ANGLE, 16, nl))
    edges = np.cos(np.arange(N_ANGLE + 1) * PI / 180.0)
    lo = np.stack([matrix_of_cos(c) for c in edges[:-1]])   # (180, 16)
    hi = np.stack([matrix_of_cos(c) for c in edges[1:]])
    avg = 0.5 * (lo + hi)
    for i in range(nl):
        out[:, :, i] = avg
    if norm_per_wl is not None:
        out /= np.asarray(norm_per_wl)[None, None, :]
    return out


def generate(wavelengths_um, mmw_scat=2.02, depolarization=0.0):
    """``(scattering [cm2 g-1] (nl,), scatter (180, 16, nl))`` of a pure
    scatterer (single-scattering albedo 1: no absorption)."""
    wl = np.asarray(wavelengths_um, dtype=float)
    gas_mass = mmw_scat / AVOGADRO  # molecule mass [g]
    kappa_sca = rayleigh_cross_section(wl, depolarization) / gas_mass  # [cm2 g-1]
    norm = rayleigh_p11_norm(depolarization)
    scatter = bin_average_matrix(
        lambda c: rayleigh_matrix16(c, depolarization), wl, norm_per_wl=np.full(len(wl), norm)
    )
    return kappa_sca, scatter
