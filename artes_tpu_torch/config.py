"""Run configuration: the artes.in schema with 3-layer precedence.

The reference layers configuration as defaults (ARTES.f90:280-336) <- artes.in
key=value file (ARTES.f90:380-397) <- ``-k key=value`` CLI overrides
(ARTES.f90:4295-4304), with the schema enforced in ``input_parameters``
(ARTES.f90:4361-4500; unknown keys are a hard error). This module mirrors that
contract, including unit conversions (stellar radius in R_sun, orbit in AU,
detector distance in pc, angles in degrees -> radians) and the clamping of
near-degenerate detector/star angles.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

from artes_tpu_torch.constants import AU, PARSEC, PI, R_SUN


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


_ONOFF = {"on": True, "off": False}


def _onoff(value: str, key: str) -> bool:
    if value not in _ONOFF:
        raise ConfigError(f"{key} expects on/off, got {value!r}")
    return _ONOFF[value]


def apply_key(cfg: ArtesConfig, key: str, value: str) -> None:
    """Apply one ``section:name=value`` pair (ARTES.f90:4361-4500)."""
    key = key.strip()
    value = value.strip().strip("'\"")
    # Fortran-style exponents 1d-5
    fval = lambda: float(value.replace("d", "e").replace("D", "E"))

    if key == "general:log":
        cfg.log_file = _onoff(value, key)
    elif key == "general:email":
        cfg.email = value
    elif key == "photon:source":
        cfg.photon_source = value
    elif key == "photon:fstop":
        cfg.fstop = fval()
    elif key == "photon:minimum":
        cfg.photon_minimum = fval()
    elif key == "photon:weight":
        cfg.thermal_weight = _onoff(value, key)
    elif key == "photon:scattering":
        cfg.photon_scattering = _onoff(value, key)
    elif key == "photon:emission":
        if value not in ("isotropic", "biased"):
            raise ConfigError(f"photon:emission expects isotropic/biased, got {value!r}")
        cfg.photon_emission = value
    elif key == "photon:bias":
        cfg.photon_bias = fval()
    elif key == "photon:max_scatter":
        cfg.max_scatter = int(value)
    elif key == "star:temperature":
        cfg.t_star = fval()
    elif key == "star:radius":
        cfg.r_star = fval() * R_SUN
    elif key == "star:direction":
        cfg.stellar_direction = _onoff(value, key)
    elif key == "star:theta":
        if value:
            theta = fval() * PI / 180.0
            cfg.theta_star = min(max(theta, 1.0e-3), PI - 1.0e-3)
    elif key == "star:phi":
        if value:
            cfg.phi_star = fval() * PI / 180.0
    elif key == "planet:surface_albedo":
        cfg.surface_albedo = fval()
    elif key == "planet:oblateness":
        cfg.oblateness = fval()
    elif key == "planet:orbit":
        cfg.orbit = fval() * AU
    elif key == "planet:ring":
        cfg.ring = _onoff(value, key)
    elif key == "detector:type":
        cfg.mode = value
    elif key == "detector:theta":
        theta = fval() * PI / 180.0
        cfg.det_theta = min(max(theta, 1.0e-3), PI - 1.0e-3)
    elif key == "detector:phi":
        cfg.det_phi = fval() * PI / 180.0
    elif key == "detector:pixel":
        cfg.npix = int(value)
    elif key == "detector:distance":
        cfg.distance_planet = fval() * PARSEC
    elif key == "output:flow_global":
        cfg.flow_global = _onoff(value, key)
    elif key == "output:flow_latitudinal":
        cfg.flow_theta = _onoff(value, key)
    else:
        raise ConfigError(f"Unknown keyword in input file: {key}")


def parse_lines(lines, cfg: ArtesConfig | None = None) -> ArtesConfig:
    """Parse artes.in-style lines, skipping comments (*, -, =) and blanks."""
    cfg = cfg or ArtesConfig()
    for raw in lines:
        line = raw.rstrip("\n")
        stripped = line.strip()
        if not stripped or stripped[0] in "*-=;#":
            continue
        if "=" not in stripped:
            continue
        key, _, value = stripped.partition("=")
        apply_key(cfg, key, value)
    return cfg


def load_config(path, overrides=()) -> ArtesConfig:
    """Load artes.in and apply ``key=value`` override strings, then validate."""
    with open(path) as fh:
        cfg = parse_lines(fh)
    for item in overrides:
        key, _, value = item.partition("=")
        apply_key(cfg, key, value)
    return cfg.validate()


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


def snapshot(cfg: ArtesConfig) -> str:
    """Render the effective configuration back to artes.in syntax.

    Mirrors the reference's reproducibility contract: inputs are copied into
    the output directory with CLI overrides appended (ARTES.f90:4283-4304).
    """
    inv = {True: "on", False: "off"}
    lines = [
        "* ARTES-TPU effective configuration",
        f"general:log={inv[cfg.log_file]}",
        f"general:email={cfg.email}",
        f"photon:source={cfg.photon_source}",
        f"photon:fstop={cfg.fstop:g}",
        f"photon:minimum={cfg.photon_minimum:g}",
        f"photon:weight={inv[cfg.thermal_weight]}",
        f"photon:scattering={inv[cfg.photon_scattering]}",
        f"photon:emission={cfg.photon_emission}",
        f"photon:bias={cfg.photon_bias:g}",
        f"photon:max_scatter={cfg.max_scatter}",
        f"star:temperature={cfg.t_star:g}",
        f"star:radius={cfg.r_star / R_SUN:g}",
        f"star:direction={inv[cfg.stellar_direction]}",
        f"star:theta={math.degrees(cfg.theta_star):g}",
        f"star:phi={math.degrees(cfg.phi_star):g}",
        f"planet:surface_albedo={cfg.surface_albedo:g}",
        f"planet:oblateness={cfg.oblateness:g}",
        f"planet:orbit={cfg.orbit / AU:g}",
        f"planet:ring={inv[cfg.ring]}",
        f"detector:type={cfg.mode}",
        f"detector:theta={math.degrees(cfg.det_theta):g}",
        f"detector:phi={math.degrees(cfg.det_phi):g}",
        f"detector:pixel={cfg.npix}",
        f"detector:distance={cfg.distance_planet / PARSEC:g}",
        f"output:flow_global={inv[cfg.flow_global]}",
        f"output:flow_latitudinal={inv[cfg.flow_theta]}",
    ]
    return "\n".join(lines) + "\n"


def replace(cfg: ArtesConfig, **kw) -> ArtesConfig:
    return dataclasses.replace(cfg, **kw)
