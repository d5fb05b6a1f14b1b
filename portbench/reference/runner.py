# Frozen copy of stellar_area_factor, package_energy, _kernel_static and
# photometry_from_detector from artes_tpu_torch/runner.py at commit bba47c3.
"""The reference's package energy, kernel constants and photometry
(ARTES.f90:959-1004, 2509-2539)."""

from __future__ import annotations

import numpy as np

from portbench.reference.config import ArtesConfig, DetectorSetup
from portbench.reference.constants import PI, planck_lambda
from portbench.reference.kernel import KernelStatic

def stellar_area_factor(cfg: ArtesConfig) -> float:
    """Beam cross-section of the oblate silhouette over the polar disk
    (pi Rp^2 |S u| / (abc) with S = diag(1-ob, 1-ob, 1)); 1.0 when not
    oblate."""
    a = b = 1.0 - cfg.oblateness
    c = 1.0
    if cfg.stellar_direction:
        st, ct = np.sin(cfg.theta_star), np.cos(cfg.theta_star)
        sp, cp = np.sin(cfg.phi_star), np.cos(cfg.phi_star)
        u = (-st * cp, -st * sp, -ct)
    else:
        u = (-1.0, 0.0, 0.0)
    return float(np.sqrt((a * u[0]) ** 2 + (b * u[1]) ** 2 + (c * u[2]) ** 2)
                 / (a * b * c))


def package_energy(cfg: ArtesConfig, atm, wl_index: int, packages: int,
                   emissivity_total: float, crescent: bool = False) -> float:
    """Photon package energy [W m-2 m-1 at the observer] (ARTES.f90:2509-2539)."""
    if cfg.photon_source == "star":
        flux = PI * planck_lambda(cfg.t_star, atm.wavelengths[wl_index])
        r_p = atm.rfront[-1]
        e = PI * flux * r_p * r_p * cfg.r_star * cfg.r_star / (
            cfg.orbit * cfg.orbit * cfg.distance_planet * cfg.distance_planet * packages)
        e *= stellar_area_factor(cfg)
        if crescent:
            e *= 0.19  # crescent disk fraction (:2527-2531)
        return float(e)
    return emissivity_total / (cfg.distance_planet ** 2 * packages)


def _kernel_static(cfg: ArtesConfig, det: DetectorSetup, atm, crescent: bool) -> KernelStatic:
    return KernelStatic(
        nx=det.nx, ny=det.ny,
        photon_source=1 if cfg.photon_source == "star" else 2,
        photon_emission=1 if cfg.photon_emission == "isotropic" else 2,
        photon_scattering=cfg.photon_scattering,
        stellar_direction=cfg.stellar_direction,
        crescent=crescent,
        thermal_weight=cfg.thermal_weight,
        max_scatter=cfg.max_scatter,
        max_crossings=4 * (atm.nr + atm.ntheta + atm.nphi) + 16,
        track_flow=cfg.flow_global or cfg.flow_theta,
        has_surface=cfg.surface_albedo > 0.0,
        debug_stokes=getattr(cfg, "debug_stokes", False),
    )


def photometry_from_detector(detector: np.ndarray) -> np.ndarray:
    """Integrated Stokes fluxes + MC errors (ARTES.f90:977-1004)."""
    p = np.zeros(11)
    sums = detector[..., 0].sum(axis=(0, 1))      # (4,)
    p[0], p[2], p[4], p[6] = sums
    p[8] = np.hypot(sums[1], sums[2])
    p[9] = p[8] / p[0] if p[0] != 0.0 else 0.0
    for k in range(4):
        n = detector[..., k, 2].sum()
        if n > 0:
            m1 = detector[..., k, 0].sum() / n
            m2 = detector[..., k, 1].sum() / n
            var = m2 - m1 * m1
            if var > 0:
                p[2 * k + 1] = np.sqrt(var) * np.sqrt(n)
    if p[2] ** 2 + p[4] ** 2 > 0:
        dpi = np.sqrt(((p[2] * p[3]) ** 2 + (p[4] * p[5]) ** 2) /
                      (2.0 * (p[2] ** 2 + p[4] ** 2)))
        if p[0] != 0 and p[8] != 0:
            p[10] = p[9] * np.sqrt((dpi / p[8]) ** 2 + (p[1] / p[0]) ** 2)
    return p
