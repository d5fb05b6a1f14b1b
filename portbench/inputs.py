"""A configuration file's atmosphere as host arrays, which the program and the
reference each take.

A configuration (``configs/<name>.json``) states its grid, its wavelengths,
a Rayleigh gas of a radial optical depth at the first wavelength, and clouds
read from data files beside it (``configs/<file>``: per wavelength the
single-scattering albedo, the extinction relative to the first wavelength and
the 180 x 16 scattering matrix). A cloud replaces the gas in the shells and
(theta, phi) zones it names (``"all"``, or ``"odd"``: those whose theta plus
phi index is odd) and has the stated radial optical depth over those shells
at the first wavelength. The arithmetic is that of
``presets._from_table`` and ``cells.mie_patchy_deck`` of the port, so the
arrays equal the ones its BASELINE chains build.

A traffic mix (``traffic/<name>.json``) states the mode, the pixels, the
photons a job, the wavelengths and, where it views the planet at other phase
angles than the default, the angles; an ``artes`` block in either file sets
further fields of the run's configuration. :func:`run_config` and
:func:`job_views` read both files for the program and the reference alike,
and refuse a key they do not know.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np

from portbench import rayleigh_table
from portbench.reference.constants import PI, R_JUP

HERE = pathlib.Path(__file__).resolve().parent
CONFIGS = HERE / "configs"

# the keys a traffic file may hold ("what" says in words what it is)
TRAFFIC_KEYS = {"mode", "npix", "photons_per_job", "wavelengths", "phase_deg", "artes", "what"}
# fields of the run's configuration that the traffic's own keys set, which an
# ``artes`` block may not
SET_BY_TRAFFIC = {"mode", "npix", "packages"}
# ARTES's phase curve: 73 angles at 2.5-degree steps, the ends kept off 0 and
# 180 (ARTES.f90:215-229); from 170 degrees photons are emitted toward the
# crescent only (ARTES.f90:1041)
PHASE_ANGLES_DEG = [1.0e-5] + [2.5 * i for i in range(1, 72)] + [180.0 - 1.0e-5]
CRESCENT_FROM_DEG = 170.0


def _zone_mask(zones: str, ntheta: int, nphi: int) -> np.ndarray:
    it, ip = np.meshgrid(np.arange(ntheta), np.arange(nphi), indexing="ij")
    masks = {"all": np.ones((ntheta, nphi), bool), "odd": (it + ip) % 2 == 1}
    return masks[zones]


def atmosphere_arrays(config: dict) -> dict:
    """The keyword arguments of an ``Atmosphere`` (the port's or the
    reference's, which share their fields) for ``config``."""
    grid = config["grid"]
    nr = grid["nr"]
    shell_m = grid["shell_km"] * 1e3
    rfront = R_JUP + np.linspace(0.0, shell_m, nr + 1)
    theta = np.asarray(grid["theta_deg"], dtype=float)
    phi = np.asarray(grid["phi_deg"], dtype=float)
    if len(phi) == 0:
        phi = np.array([0.0])
    ntheta, nphi = len(theta) - 1, len(phi)
    wl_um = np.asarray(config["wavelengths_um"], dtype=float)
    nl = len(wl_um)

    gas = config["gas"]
    kappa_sca, scatter_gas = rayleigh_table.generate(list(wl_um))
    k_target = gas["tau"] / shell_m                     # [m-1]
    density_si = k_target / (kappa_sca[0] / 10.0)       # [kg m-3]
    k_sca = np.zeros((nr, ntheta, nphi, nl))
    k_abs = np.zeros((nr, ntheta, nphi, nl))
    scatter = np.zeros((nr, ntheta, nphi, nl, 180, 16))
    k_sca[:] = density_si * kappa_sca / 10.0
    scatter[:] = scatter_gas.transpose(2, 0, 1)[None, None, None]

    shell = float(rfront[1] - rfront[0])
    for cloud in config.get("clouds", []):
        with open(CONFIGS / cloud["table"]) as fh:
            tab = json.load(fh)
        if tab["wavelengths_um"] != config["wavelengths_um"]:
            raise ValueError(f"{cloud['table']}: its wavelengths are not the configuration's")
        lo, hi = cloud["shells"]
        in_deck = np.zeros(nr, bool)
        in_deck[lo:hi] = True
        k_cloud = cloud["tau"] / (in_deck.sum() * shell)                 # [1/m]
        zone = _zone_mask(cloud["zones"], ntheta, nphi)
        for it, ip in zip(*np.nonzero(zone)):
            for w in range(nl):
                k = k_cloud * tab["extinction_rel"][w]
                albedo = tab["albedo"][w]
                k_sca[in_deck, it, ip, w] = k * albedo
                k_abs[in_deck, it, ip, w] = k * (1.0 - albedo)
                scatter[in_deck, it, ip, w] = np.asarray(tab["scatter"][w])
    return dict(
        rfront=rfront, thetafront=theta * PI / 180.0, phifront=phi * PI / 180.0,
        wavelengths=wl_um * 1e-6, density=np.full((nr, ntheta, nphi), density_si),
        temperature=np.zeros((nr, ntheta, nphi)), k_sca=k_sca, k_abs=k_abs, scatter=scatter)


def run_config(make, config: dict, traffic: dict):
    """The run's configuration: ``make()`` (the program's or the reference's
    ``ArtesConfig``) with the configuration's ``artes`` block, then the
    traffic's, then the traffic's mode and pixels. A traffic key or an
    ``artes`` field that is not known is refused, never passed over."""
    unknown = set(traffic) - TRAFFIC_KEYS
    if unknown:
        raise ValueError(f"traffic keys not known: {sorted(unknown)}")
    cfg = make()
    fields = {f.name for f in dataclasses.fields(cfg)} - SET_BY_TRAFFIC
    for where, block in (("configuration", config.get("artes", {})),
                         ("traffic", traffic.get("artes", {}))):
        bad = set(block) - fields
        if bad:
            raise ValueError(f"{where} 'artes' fields not known: {sorted(bad)}")
        for key, value in block.items():
            setattr(cfg, key, value)
    cfg.mode = traffic["mode"]
    cfg.npix = traffic.get("npix", cfg.npix)
    return cfg.validate()


def job_views(config: dict, traffic: dict) -> list[tuple[int, float | None]]:
    """The jobs of one cycle, ``(wavelength index, phase angle in degrees or
    None for the configuration's view)``: every wavelength at every angle."""
    wl = traffic["wavelengths"]
    wls = range(len(config["wavelengths_um"])) if wl == "all" else wl
    phase = traffic.get("phase_deg")
    angles = [None] if phase is None else PHASE_ANGLES_DEG if phase == "all" else phase
    return [(int(w), None if a is None else float(a)) for w in wls for a in angles]


def detector_of(detector_setup, cfg, r_max: float, phase_deg: float | None):
    """``(detector, crescent)`` of a job, as ``runner.run_phase_curve`` sets
    them at a phase angle: the detector's phi is the angle."""
    if phase_deg is None:
        return detector_setup(cfg, r_max), False
    return (detector_setup(cfg, r_max, det_phi=phase_deg * PI / 180.0),
            phase_deg >= CRESCENT_FROM_DEG)
