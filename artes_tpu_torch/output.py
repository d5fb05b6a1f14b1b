"""Run outputs.

Counterpart of ``artes_tpu.output`` (the reference's ``write_output``,
ARTES.f90:3472-3772, the run report, :3843-4152, and ``plot.dat``,
:1328-1348): spectrum, phase, photometry, luminosity, optical depth, cell
depth and normalization tables, the Stokes, error, cell-luminosity and flow
FITS images, the banner/log report and the error log. File formats and
units match the reference and the JAX package.
"""

from __future__ import annotations

import math
import os
import shutil
import subprocess
import time

import numpy as np

from artes_tpu_torch.config import ArtesConfig, DetectorSetup
from artes_tpu_torch.constants import PI, SIGMA_SB, planck_lambda
from artes_tpu_torch.io.fitsio import write_fits
from artes_tpu_torch.runner import WavelengthResult, detector_errors


class OutputDirs:
    """output/<run>/{input,output,plot} tree (ARTES.f90:4271-4293)."""

    def __init__(self, root, run_name):
        self.base = os.path.join(os.fspath(root), "output", run_name)
        self.input = os.path.join(self.base, "input")
        self.output = os.path.join(self.base, "output")
        self.plot = os.path.join(self.base, "plot")
        for d in (self.base, self.input, self.output, self.plot):
            os.makedirs(d, exist_ok=True)

    def path(self, name):
        return os.path.join(self.output, name)


def _append(path, header, row):
    exists = os.path.isfile(path)
    with open(path, "a") as fh:
        if not exists:
            fh.write(header + "\n\n")
        fh.write(" ".join(f"{v: .16e}" if isinstance(v, float) else str(v) for v in row) + "\n")


def write_spectrum_row(dirs: OutputDirs, wavelength_m: float, res: WavelengthResult):
    """spectrum.dat: wavelength [micron] + Stokes IQUV [W m-2 micron-1]
    (ARTES.f90:3591-3619)."""
    d = res.detector
    _append(dirs.path("spectrum.dat"),
            "# Wavelength [micron] - Stokes I, Q, U, V [W m-2 micron-1]",
            [wavelength_m * 1e6,
             1e-6 * d[..., 0, 0].sum(), 1e-6 * d[..., 1, 0].sum(),
             1e-6 * d[..., 2, 0].sum(), 1e-6 * d[..., 3, 0].sum()])


def write_phase_row(dirs: OutputDirs, phase_deg: float, res: WavelengthResult):
    """phase.dat (ARTES.f90:3521-3563)."""
    d = res.detector
    err = detector_errors(res.detector)
    if phase_deg < 1.0:
        phase_deg = 0.0
    elif phase_deg > 179.0:
        phase_deg = 180.0
    row = [phase_deg]
    for k in range(4):
        row += [1e-6 * d[..., k, 0].sum(), 1e-6 * float(err[..., k].sum())]
    _append(dirs.path("phase.dat"),
            "# Phase [deg] - Stokes I, I err, Q, Q err, U, U err, V, V err [W m-2 micron-1]",
            row)


def write_stokes_fits(dirs: OutputDirs, det: DetectorSetup, res: WavelengthResult):
    """stokes.fits + error.fits (ARTES.f90:3565-3570): per-pixel surface
    brightness [W m-2 micron-1 mas-2], NAXIS order (4, ny, nx)."""
    img = res.detector[..., 0] * 1e-6 / (det.pixel_scale * det.pixel_scale)
    write_fits(dirs.path("stokes.fits"), [(None, img.transpose(2, 1, 0))])
    err = detector_errors(res.detector)
    write_fits(dirs.path("error.fits"), [(None, err.transpose(2, 1, 0))])


def write_photometry(dirs: OutputDirs, wavelength_m: float, res: WavelengthResult):
    """photometry.dat (ARTES.f90:3574-3588)."""
    p = res.photometry
    _append(dirs.path("photometry.dat"),
            "# Wavelength [micron] - Stokes I, I err, Q, Q err, U, U err, V, V err [W m-2 micron-1]",
            [wavelength_m * 1e6] + [1e-6 * p[i] for i in range(8)])


def write_luminosity(dirs: OutputDirs, wavelength_m: float, res: WavelengthResult,
                     packages: int):
    """luminosity.dat: emitted vs emergent (ARTES.f90:3654-3685)."""
    e_pack = res.prep.emissivity_total / packages
    _append(dirs.path("luminosity.dat"),
            "# Wavelength [micron] - Emitted luminosity [W micron-1] - "
            "Emergent luminosity [W micron-1] - Emergent luminosity [a.u.]",
            [wavelength_m * 1e6, res.flux_emitted * e_pack * 1e-6,
             res.flux_exit * e_pack * 1e-6, res.flux_exit])


def write_cell_luminosity(dirs: OutputDirs, lum):
    """cell_luminosity.fits (ARTES.f90:3658), NAXIS order (nphi, ntheta, nr)."""
    write_fits(dirs.path("cell_luminosity.fits"), [(None, np.asarray(lum).transpose(2, 1, 0))])


def write_flow_global(dirs: OutputDirs, flow, cell_depth: int = 0):
    """flow_global.fits: per-cell unit flow vectors (ARTES.f90:3715-3742).

    ``flow``: (nr, ntheta, nphi, 3) summed energy x distance projections,
    zeroed below the photon floor and normalised per cell; NAXIS order
    (nphi, ntheta, nr, 3)."""
    f = np.array(flow, np.float64)
    f[:cell_depth] = 0.0
    norm = np.linalg.norm(f, axis=-1, keepdims=True)
    f = np.where(norm > 0, f / np.maximum(norm, 1e-300), 0.0)
    write_fits(dirs.path("flow_global.fits"), [(None, f.transpose(2, 1, 0, 3))])


def write_flow_latitudinal(dirs: OutputDirs, flow, flux_exit: float, cell_depth: int = 0):
    """flow_latitudinal.fits: (nr, ntheta, nphi, 4) boundary-crossing
    tallies [up, down, south, north], zeroed below the photon floor and
    normalised to the emergent flux when that is positive
    (ARTES.f90:3744-3770)."""
    f = np.array(flow, np.float64)
    f[:cell_depth] = 0.0
    if flux_exit > 0:
        f = f / flux_exit
    write_fits(dirs.path("flow_latitudinal.fits"), [(None, f.transpose(2, 1, 0, 3))])


def write_normalization(dirs: OutputDirs, cfg: ArtesConfig, atm, wavelength_m: float):
    """normalization.dat: stellar flux normalization constants (ARTES.f90:3623-3652)."""
    flux = PI * planck_lambda(cfg.t_star, wavelength_m)
    r_p = atm.rfront[-1]
    norm1 = flux * cfg.r_star**2 / cfg.distance_planet**2
    norm2 = flux * r_p**2 * cfg.r_star**2 / (cfg.orbit**2 * cfg.distance_planet**2)
    _append(dirs.path("normalization.dat"),
            "# Wavelength [micron] - Norm1 [W m-2 micron-1] - Norm2 [W m-2 micron-1]",
            [wavelength_m * 1e6, 1e-6 * norm1, 1e-6 * norm2])


def write_cell_depth(dirs: OutputDirs, wavelength_m: float, cell_depth: int):
    _append(dirs.path("cell_depth.dat"), "# Wavelength [micron] - Cell depth",
            [wavelength_m * 1e6, cell_depth])


def write_optical_depth(dirs: OutputDirs, atm, wl_index: int):
    """optical_depth.dat: radial tau of column (0,0) (ARTES.f90:2457-2493)."""
    dr = np.diff(atm.rfront)
    tot = float((dr * atm.k_ext[:, 0, 0, wl_index]).sum())
    sca = float((dr * atm.k_sca[:, 0, 0, wl_index]).sum())
    ab = float((dr * atm.k_abs[:, 0, 0, wl_index]).sum())
    _append(dirs.path("optical_depth.dat"),
            "# Wavelength [micron] - Total optical depth - Absorption optical depth"
            " - Scattering optical depth",
            [atm.wavelengths[wl_index] * 1e6, tot, ab, sca])


def write_plot_dat(dirs: OutputDirs, cfg: ArtesConfig, atm, det: DetectorSetup):
    """plot.dat handshake for plotting tools (ARTES.f90:1328-1348)."""
    with open(os.path.join(dirs.base, "plot.dat"), "w") as fh:
        fh.write("[plot]\n")
        fh.write(f"photon_source={1 if cfg.photon_source == 'star' else 2}\n")
        fh.write(f"distance={cfg.distance_planet:.7e}\n")
        fh.write(f"planet_radius={atm.rfront[0]:.7e}\n")
        fh.write(f"ntheta={atm.ntheta}\n")
        fh.write(f"fov={det.x_fov:.7e}\n")


class RunReport:
    """Banner + staged run report (ARTES.f90:3843-4152) to screen or output.log."""

    BANNER = r"""########################################################
                     ARTES-TPU
  Atmospheric Radiative Transfer for Exoplanet Science
              PyTorch/CUDA engine
--------------------------------------------------------"""

    def __init__(self, dirs: OutputDirs, log_file: bool):
        self._fh = open(os.path.join(dirs.base, "output.log"), "w") if log_file else None
        self.t_start = time.time()

    def emit(self, text: str):
        if self._fh:
            self._fh.write(text + "\n")
            self._fh.flush()
        else:
            print(text)

    def stage1(self, cfg: ArtesConfig, atm, det: DetectorSetup):
        self.emit(self.BANNER)
        self.emit("--> Build planet atmosphere\n")
        self.emit(f"Planet radius [km]: {atm.rfront[-1] / 1e3:.2e}")
        self.emit(f"Atmosphere height [km]: {(atm.rfront[-1] - atm.rfront[0]) / 1e3:.2e}")
        self.emit(f"Oblateness: {cfg.oblateness:.2e}")
        self.emit(f"Surface albedo: {cfg.surface_albedo:.2e}")
        self.emit(f"Radial grid cells: {atm.nr}")
        self.emit(f"Latitudinal grid cells: {atm.ntheta}")
        self.emit(f"Longitudial grid cells: {atm.nphi}")
        self.emit(f"Field of view [mas x mas]: {det.x_fov:.2e} x {det.y_fov:.2e}")
        self.emit(f"Pixel scale [mas pixel-1]: {det.pixel_scale:.2e}")

    def stage2(self, cfg: ArtesConfig, atm, det: DetectorSetup, packages: int,
               wl_index: int = 0, cell_depth: int = 0):
        self.emit("--------------------------------------------------------")
        self.emit("--> Photon transfer\n")
        self.emit(f"Photon source: {cfg.photon_source}")
        self.emit(f"Emitted photons: {float(packages):.2e}")
        if cfg.photon_source == "star" and cfg.mode != "phase":
            self.emit(f"Phase angle [deg]: {det.phase_observer:.2e}")
        lum = 4.0 * PI * cfg.r_star**2 * SIGMA_SB * cfg.t_star**4
        self.emit(f"Stellar luminosity [W]: {lum:.2e}")
        if cfg.mode != "spectrum":
            for kind, label in (("ext", "Total"), ("sca", "Scattering"), ("abs", "Absorption")):
                self.emit(f"{label} optical depth:")
                tau = atm.column_optical_depth(wl_index, kind, cell_depth)
                for it in range(atm.ntheta):
                    for ip in range(atm.nphi):
                        self.emit(f"[Theta, phi] = [{it}, {ip}] --> {tau[it, ip]:.4e}")

    def stage3(self, cfg: ArtesConfig, atm, res: WavelengthResult, wl_index: int = 0):
        p = res.photometry
        self.emit("--------------------------------------------------------")
        if p[0] <= 0:
            self.emit("Error: Stokes I is zero")
            return
        self.emit("Planet integrated flux\n")
        for lab, v in zip("IQUV", (p[0], p[2], p[4], p[6])):
            self.emit(f"Stokes {lab} [W m-2 micron-1]: {v * 1e-6:.2e}")
        if cfg.photon_source == "star":
            flux = PI * planck_lambda(cfg.t_star, atm.wavelengths[wl_index])
            norm = (flux * atm.rfront[-1]**2 * cfg.r_star**2
                    / (cfg.orbit**2 * cfg.distance_planet**2))
            norm2 = flux * cfg.r_star**2 / cfg.distance_planet**2
            for lab, v in zip("IQUV", (p[0], p[2], p[4], p[6])):
                self.emit(f"Normalized Stokes {lab}: {v / norm:.2e}")
            for lab, v in zip("IQUV", (p[0], p[2], p[4], p[6])):
                self.emit(f"Stellar normalized Stokes {lab}: {v / norm2:.2e}")
        self.emit(f"-Q/I: {-p[2] / p[0]:.2e}")
        self.emit(f" U/I: {p[4] / p[0]:.2e}")
        self.emit(f" V/I: {p[6] / p[0]:.2e}")
        self.emit(f"Degree of polarization [%]: {100 * p[9]:.2e} +/- {100 * p[10]:.2e}")
        self.emit(f"Direction of polarization [deg]: "
                  f"{0.5 * np.arctan2(p[4], p[2]) * 180 / PI:.2e}")

    def truncation(self, n_capped: int, packages: int, max_scatter: int):
        """Report photons stopped at the scattering-order cap
        (photon:max_scatter) and warn when their fraction exceeds the MC
        error scale 1/sqrt(N)."""
        if n_capped <= 0 or packages <= 0:
            return
        frac = n_capped / packages
        self.emit(f"Photons at scattering cap ({max_scatter}): "
                  f"{n_capped} ({100.0 * frac:.2e} %)")
        if frac > 1.0 / math.sqrt(packages):
            self.emit("WARNING: truncated fraction exceeds the MC error "
                      "scale — raise photon:max_scatter")

    def stage4(self, n_error: int = 0):
        dt = time.time() - self.t_start
        h, rem = divmod(int(dt), 3600)
        m, s = divmod(rem, 60)
        self.emit(f"CPU time [hour:min:sec]: {h:02d}:{m:02d}:{s:02d}")
        if n_error:
            self.emit("WARNING: check error log!")
        self.emit("########################################################")
        if self._fh:
            self._fh.close()
            self._fh = None


_ERR_SITES = {0: "scatter march", 1: "first walk", 2: "prewalk",
              3: "detector peel", 4: "stokes anomaly"}


def write_error_log(dirs: OutputDirs, entries, records=None):
    """error.log: numbered error tallies plus captured error-event state
    dumps (ARTES.f90:3397-3416)."""
    path = os.path.join(dirs.base, "error.log")
    with open(path, "a") as fh:
        for code, count in entries:
            if count:
                fh.write(f"error {code} x{count}\n")
        for row in (records if records is not None else []):
            code, pid = int(row[0]), int(row[1])
            fh.write(
                f"error {code:03d} photon {pid} at {_ERR_SITES.get(int(row[15]), '?')}:"
                f" pos=({row[2]:.9e}, {row[3]:.9e}, {row[4]:.9e})"
                f" dir=({row[5]:.6f}, {row[6]:.6f}, {row[7]:.6f})"
                f" cell=({int(row[8])}, {int(row[9])}, {int(row[10])})"
                f" face=({int(row[11])}, {int(row[12])})"
                f" I={row[13]:.6e} n_scat={int(row[14])}\n")
    return path


def send_completion_email(cfg: ArtesConfig, run_name: str):
    """Completion e-mail via mail/ssmtp when configured (ARTES.f90:4094-4146)."""
    if not cfg.email:
        return False
    body = f"Job {run_name} is finished.\n\nHave a nice day!\n"
    if shutil.which("mail"):
        subprocess.run(["mail", "-s", "ARTES-TPU is finished", cfg.email],
                       input=body.encode(), check=False)
        return True
    if shutil.which("ssmtp"):
        msg = f"To:{cfg.email}\nFrom:ARTES-TPU\nSubject: ARTES-TPU is finished\n\n{body}"
        subprocess.run(["ssmtp", cfg.email], input=msg.encode(), check=False)
        return True
    return False
