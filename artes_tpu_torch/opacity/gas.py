"""Combined Rayleigh-scattering + molecular-absorption gas opacity
(python/opacityGas.py).

Absorption coefficients come from a two-column table (wavelength [micron],
cross-section [cm2/molecule]); the scattering side is H2 Rayleigh
(opacityGas.py:80-98). Note the reference's gas variant computes the Rayleigh
cross-section through the Lorentz-Lorenz-free form
(8 pi^3/3)((n^2-1)/N)^2 dep / lambda^4 (opacityGas.py:88-93), which differs
slightly from opacityRayleigh.py's (n^2-1)^2/(n^2+2)^2 form; both are kept.
"""

from __future__ import annotations

import numpy as np

from artes_tpu_torch.constants import AVOGADRO, LOSCHMIDT, PI
from artes_tpu_torch.opacity.base import OpacityTable, bin_average_matrix
from artes_tpu_torch.opacity.rayleigh import (h2_refractive_index, rayleigh_matrix16,
                                              rayleigh_p11_norm)


def rayleigh_cross_section_gas(wavelength_um, depolarization=0.0):
    """Rayleigh cross-section [cm2], opacityGas.py:88-93 variant."""
    ri = h2_refractive_index(wavelength_um)
    dep = (6.0 + 3.0 * depolarization) / (6.0 - 7.0 * depolarization)
    rindex = ((ri * ri - 1.0) / LOSCHMIDT) ** 2
    return (8.0 * PI**3 / 3.0) * rindex * dep / (wavelength_um * 1.0e-4) ** 4


def load_absorption_table(path):
    """Two-column file: wavelength [micron], absorption [cm2/molecule]."""
    data = np.loadtxt(path)
    return data[:, 0], data[:, 1]


def select_wavelengths(w, a, wl_min, wl_max, step=None):
    """Pick samples from the absorption table over [wl_min, wl_max].

    With ``step`` set this mirrors the manual-wavelength decimation loop
    (opacityGas.py:65-78); otherwise all in-range samples are used
    (opacityGas.py:54-63).
    """
    wl_out, ab_out = [], []
    if step is None:
        for wi, ai in zip(w, a):
            if wi >= wl_min:
                wl_out.append(wi)
                ab_out.append(ai)
            if wi > wl_max:
                break
    else:
        target = wl_min
        for wi, ai in zip(w, a):
            if target <= wi < target + step:
                wl_out.append(wi)
                ab_out.append(ai)
                target += step
            if wi > wl_max:
                break
    return np.asarray(wl_out), np.asarray(ab_out)


def generate(absorption_table_path, wl_min, wl_max, step=None,
             vmr=1.8e-3, mmw_abs=16.04, mmw_scat=2.02,
             depolarization=0.02) -> OpacityTable:
    w, a = load_absorption_table(absorption_table_path)
    a = a / (mmw_abs / AVOGADRO)  # [cm2/molecule] -> [cm2 g-1]
    wl, absorption = select_wavelengths(w, a, wl_min, wl_max, step)

    gas_mass_scat = mmw_scat / AVOGADRO
    kappa_sca = rayleigh_cross_section_gas(wl, depolarization) / gas_mass_scat
    kappa_abs = absorption * vmr
    kappa_ext = kappa_sca + kappa_abs

    norm = rayleigh_p11_norm(depolarization)
    scatter = bin_average_matrix(
        lambda c: rayleigh_matrix16(c, depolarization), wl,
        norm_per_wl=np.full(len(wl), norm),
    )
    return OpacityTable(wl, kappa_ext, kappa_abs, kappa_sca, scatter)
