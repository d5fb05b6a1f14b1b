# Frozen copy of ArtesConfig, DetectorSetup and detector_setup from
# artes_tpu_torch/config.py at commit bba47c3 (the artes.in parser left out).
"""The reference's run configuration and detector geometry (ARTES.f90:451-514)."""

from __future__ import annotations

import math
from dataclasses import dataclass

from portbench.reference.constants import AU, PARSEC, PI, R_SUN

class ConfigError(Exception):
    pass


@dataclass
class ArtesConfig:
    # general
    log_file: bool = False
    email: str = ""
    # photon
    photon_source: str = "star"            # "star" | "planet"
    packages: int = 100000
    fstop: float = 1.0e-5
    photon_minimum: float = 1.0e-20
    thermal_weight: bool = True
    photon_scattering: bool = True
    photon_emission: str = "isotropic"     # "isotropic" | "biased"
    photon_bias: float = 0.8
    # scattering-order cap (extension key: the reference runs photons to
    # roulette death, ARTES.f90:786-951; the batched kernels bound the pool
    # loop — TRUNCATION.md quantifies the bias, and capped photons are
    # surfaced as n_alive_at_cap in the run report)
    max_scatter: int = 256
    # star
    t_star: float = 5800.0
    r_star: float = R_SUN                  # [m]
    stellar_direction: bool = False
    theta_star: float = PI / 2.0           # [rad]
    phi_star: float = 0.0                  # [rad]
    # planet
    surface_albedo: float = 0.0
    oblateness: float = 0.0
    orbit: float = 5.0 * AU                # [m]
    ring: bool = False
    # detector
    mode: str = "imaging_mono"             # "spectrum"|"phase"|"imaging_mono"|"imaging_broad"
    det_theta: float = 90.0 * PI / 180.0   # [rad]
    det_phi: float = 90.0 * PI / 180.0     # [rad]
    npix: int = 25
    distance_planet: float = 10.0 * PARSEC  # [m]
    # output
    flow_global: bool = False
    flow_theta: bool = False
    # debug (CLI --debug-stokes, not an artes.in key): in-kernel Stokes
    # anomaly check, the reference's error 050 (ARTES.f90:830-835)
    debug_stokes: bool = False

    def validate(self) -> "ArtesConfig":
        if self.photon_source not in ("star", "planet"):
            raise ConfigError(f"photon:source must be star|planet, got {self.photon_source}")
        if self.mode not in ("spectrum", "phase", "imaging_mono", "imaging_broad"):
            raise ConfigError(f"detector:type invalid: {self.mode}")
        if not (0.0 <= self.fstop <= 1.0):
            raise ConfigError("photon:fstop must be in [0,1]")
        if not (0.0 <= self.photon_bias < 1.0):
            raise ConfigError("photon:bias must be in [0,1)")
        if self.max_scatter < 1:
            raise ConfigError("photon:max_scatter must be >= 1")
        return self


@dataclass
class DetectorSetup:
    """Derived detector geometry (ARTES.f90:451-514)."""

    nx: int
    ny: int
    det_theta: float
    det_phi: float
    direction: tuple      # unit vector toward the observer
    x_max: float          # image half-size [m]
    y_max: float
    x_fov: float          # [mas]
    y_fov: float
    pixel_scale: float    # [mas/pixel]
    phase_observer: float  # [deg]


def detector_setup(cfg: ArtesConfig, r_max: float,
                   det_theta: float | None = None,
                   det_phi: float | None = None) -> DetectorSetup:
    """Compute detector direction, FoV and pixel grid.

    ``r_max`` is the outer grid radius rfront(nr). For spectrum/phase modes the
    detector collapses to a single pixel (ARTES.f90:453-465); phase mode pins
    theta to 90 deg and sweeps phi externally (ARTES.f90:213-250).
    """
    nx = ny = cfg.npix
    th = cfg.det_theta if det_theta is None else det_theta
    ph = cfg.det_phi if det_phi is None else det_phi
    if cfg.mode == "spectrum":
        nx = ny = 1
    elif cfg.mode == "phase":
        nx = ny = 1
        th = PI / 2.0
        if det_phi is None:
            ph = 1.0e-5
    # clamp phi away from 0/pi singular image-plane bases (ARTES.f90:492-493)
    if abs(ph) < 1.0e-3 or ph > 2.0 * PI - 1.0e-3:
        ph = 1.0e-3
    if PI - 1.0e-3 < ph < PI + 1.0e-3:
        ph = PI - 1.0e-3

    x_max = 1.3 * r_max * (cfg.oblateness + 1.0)
    y_max = x_max
    x_fov = 2.0 * math.atan(x_max / cfg.distance_planet) * 3600.0 * 180.0 / PI * 1000.0
    y_fov = x_fov
    direction = (
        math.sin(th) * math.cos(ph),
        math.sin(th) * math.sin(ph),
        math.cos(th),
    )
    cosang = (
        math.sin(cfg.theta_star) * math.cos(cfg.phi_star) * direction[0]
        + math.sin(cfg.theta_star) * math.sin(cfg.phi_star) * direction[1]
        + math.cos(cfg.theta_star) * direction[2]
    )
    phase_observer = math.degrees(math.acos(max(-1.0, min(1.0, cosang))))
    return DetectorSetup(
        nx=nx, ny=ny, det_theta=th, det_phi=ph, direction=direction,
        x_max=x_max, y_max=y_max, x_fov=x_fov, y_fov=y_fov,
        pixel_scale=x_fov / nx, phase_observer=phase_observer,
    )
