"""Programmatic demo atmospheres (no file I/O) for benchmarks and harnesses.

These mirror the BASELINE.json configs: the Rayleigh 1-layer reflected-light
case (config #1), a Henyey-Greenstein cloud deck (config #2) and a thermal
self-luminous shell (config #3).
"""

from __future__ import annotations

import numpy as np

from artes_tpu_torch.atmosphere import Atmosphere
from artes_tpu_torch.constants import PI, R_JUP
from artes_tpu_torch.opacity import henyey_greenstein, isotropic, rayleigh


def _from_table(tab, rfront, theta_deg, phi_deg, density_si, temperature=0.0):
    nr = len(rfront) - 1
    theta = np.asarray(theta_deg, dtype=float)
    ntheta = len(theta) - 1
    phi = np.asarray(phi_deg, dtype=float)
    nphi = max(len(phi), 1)
    if len(phi) == 0:
        phi = np.array([0.0])
    nl = len(tab.wavelength)
    k_sca = np.zeros((nr, ntheta, nphi, nl))
    k_abs = np.zeros((nr, ntheta, nphi, nl))
    scatter = np.zeros((nr, ntheta, nphi, nl, 180, 16))
    k_sca[:] = density_si * tab.scattering / 10.0
    k_abs[:] = density_si * tab.absorption / 10.0
    scatter[:] = tab.scatter.transpose(2, 0, 1)[None, None, None]
    return Atmosphere(
        rfront=np.asarray(rfront, dtype=float),
        thetafront=theta * PI / 180.0,
        phifront=phi * PI / 180.0,
        wavelengths=np.asarray(tab.wavelength) * 1e-6,
        density=np.full((nr, ntheta, nphi), density_si),
        temperature=np.full((nr, ntheta, nphi), float(temperature)),
        k_sca=k_sca,
        k_abs=k_abs,
        scatter=scatter,
    )


def rayleigh_single_layer(tau=5.0, nr=1, shell_km=100.0, wavelengths=(0.7,),
                          theta_deg=(0.0, 180.0), phi_deg=()):
    """BASELINE config #1: homogeneous Rayleigh layer with radial tau."""
    tab = rayleigh.generate(list(wavelengths))
    rfront = R_JUP + np.linspace(0.0, shell_km * 1e3, nr + 1)
    k_target = tau / (shell_km * 1e3)                 # [m-1]
    density_si = k_target / (tab.scattering[0] / 10.0)  # [kg m-3]
    return _from_table(tab, rfront, theta_deg, phi_deg, density_si)


def hg_cloud_deck(tau=10.0, g=0.8, p_linear=0.5, shell_km=200.0, nr=4,
                  wavelengths=(0.8,), ssa=0.95):
    """BASELINE config #2: polarized Henyey-Greenstein cloud deck."""
    scattering = 1.0
    absorption = scattering * (1.0 - ssa) / ssa
    tab = henyey_greenstein.generate(list(wavelengths), absorption=absorption,
                                     scattering=scattering, g1=g, p_linear=p_linear)
    rfront = R_JUP + np.linspace(0.0, shell_km * 1e3, nr + 1)
    k_target = tau / (shell_km * 1e3)
    density_si = k_target / (tab.extinction[0] / 10.0)
    return _from_table(tab, rfront, (0.0, 180.0), (), density_si)


def thermal_shell(tau_abs=0.5, temperature=900.0, shell_km=500.0, nr=4,
                  wavelengths=(10.0,)):
    """Self-luminous isothermal shell (thermal-emission smoke config)."""
    tab = isotropic.generate(list(wavelengths), absorption=1.0, scattering=0.0)
    rfront = R_JUP + np.linspace(0.0, shell_km * 1e3, nr + 1)
    k_target = tau_abs / (shell_km * 1e3)
    density_si = k_target / (tab.absorption[0] / 10.0)
    return _from_table(tab, rfront, (0.0, 180.0), (), density_si,
                       temperature=temperature)


def patchy_3d(tau_clear=0.5, tau_cloud=8.0, nr=2,
              theta_deg=(0.0, 60.0, 120.0, 180.0),
              phi_deg=(0.0, 90.0, 180.0, 270.0), wavelengths=(0.7,)):
    """BASELINE config #4 shape: 3-D patchy zones (alternating opacity)."""
    atm = rayleigh_single_layer(tau=tau_clear, nr=nr, theta_deg=theta_deg,
                                phi_deg=phi_deg, wavelengths=wavelengths)
    scale = tau_cloud / tau_clear
    for it in range(atm.ntheta):
        for ip in range(atm.nphi):
            if (it + ip) % 2 == 0:
                atm.k_sca[:, it, ip] *= scale
    return Atmosphere(
        rfront=atm.rfront, thetafront=atm.thetafront, phifront=atm.phifront,
        wavelengths=atm.wavelengths, density=atm.density,
        temperature=atm.temperature, k_sca=atm.k_sca, k_abs=atm.k_abs,
        scatter=atm.scatter,
    )
