"""Run orchestration: wavelength and mode loops, photometry.

Counterpart of ``artes_tpu.runner`` (the reference's ``run`` dispatcher,
ARTES.f90:121-267): spectrum mode re-runs transport per wavelength,
imaging_broad sums one detector over the wavelengths, imaging_mono is a
single run, and phase mode sweeps 73 detector azimuths. Each run transports its
photons in chunks of at most 2^30 with continuous 64-bit photon ids, so the
(seed, id) -> photon stream mapping does not depend on the chunking.

Dispatch follows the tables' device and type and nothing else: float32
CUDA tables run the hand-written kernel of their configuration
(``pool_cuda.run_stream_cuda``: radial, 3-D or marching); float64 tables
(``--f64``) and CPU tables run the plain PyTorch version
(``kernel.run_stream``) on their device, the card or the CPU, as the JAX
package runs its XLA pool at float64 on its device (the kernels, like the
Pallas kernel, are float32 only). Nothing falls back. With a
``parallel.mesh.Mesh`` the tables are built on the mesh rank's device and
every chunk is split over the ranks by photon id and summed over them
(``parallel.mesh.run_stream_mesh``); every rank gets the whole result. An
explicit ``dispatch`` (``kernel.run_batch``, ``parallel.mesh.sharded_dispatch``
or any function of ``(tables, static, photon_ids, seed)``) takes precedence
over both, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from artes_tpu_torch import spans
from artes_tpu_torch.config import ArtesConfig, DetectorSetup, detector_setup
from artes_tpu_torch.constants import PI, planck_lambda
from artes_tpu_torch.parallel.mesh import run_stream_mesh
from artes_tpu_torch.transport import pool_cuda
from artes_tpu_torch.transport import rng as R
from artes_tpu_torch.transport.kernel import (ERR_RECORD_K, ERR_RECORD_W, KernelStatic,
                                              run_stream, select_error_records)
from artes_tpu_torch.transport.tables import PreparedWavelength, build_tables

CHUNK = 1 << 30
# float64 on the card against float64 on the CPU, the same photons: every
# count equal and every sum within this of its tally's largest (CUDA's and
# glibc's exp, log, acos and sincos may differ by an ulp)
F64_DEVICE_RTOL = 1e-9

PHASE_ANGLES_DEG = [1.0e-5] + [2.5 * i for i in range(1, 72)] + [180.0 - 1.0e-5]  # (:215-229)


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


@dataclasses.dataclass
class WavelengthResult:
    detector: np.ndarray        # (nx, ny, 4, 3) energy-scaled moments
    photometry: np.ndarray      # (11,) (ARTES.f90:977-1004)
    flux_emitted: float         # unitless Stokes-I tallies (thermal)
    flux_exit: float
    n_error: int                # photons abandoned (marches, prewalks, Stokes anomalies)
    n_alive_at_cap: int
    cell_depth: int
    prep: PreparedWavelength
    # [031 no candidate face, 032 runaway traversal, 034 degenerate floor
    # bounce, peel walk], the reference's numbered error log
    error_codes: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(4, np.int64))
    n_stokes_anomaly: int = 0   # error 050 (--debug-stokes)
    # the first and last ERR_RECORD_K error records in photon-id order
    error_records: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, ERR_RECORD_W)))
    # flow diagnostics (output:flow_global / flow_latitudinal), else None
    flow_global: np.ndarray | None = None   # (nr, ntheta, nphi, 3)
    flow_theta: np.ndarray | None = None    # (nr, ntheta, nphi, 4)


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


def chunk_ids(lo: int, n: int, device) -> torch.Tensor:
    """The photon ids ``lo .. lo + n - 1`` (low id words, int64 on
    ``device``) that :func:`run_wavelength` hands a ``dispatch``."""
    return torch.arange(lo, lo + n, dtype=torch.int64, device=device)


def run_wavelength(atm, cfg: ArtesConfig, det: DetectorSetup, wl_index: int,
                   packages: int, seed: int = 0, batch_size: int = 1 << 17,
                   dtype=torch.float32, device="cuda", crescent: bool = False,
                   progress: bool = False, mesh=None, dispatch=None) -> WavelengthResult:
    """Transport ``packages`` photons at one wavelength on ``device``, or
    over the ranks of ``mesh`` (a ``parallel.mesh.Mesh``; its rank's device
    takes the place of ``device``).

    ``batch_size`` bounds the number of photons the plain version emits
    together. float32 on a card runs the kernels; float64 runs the plain
    version on the device it is given, the card included.

    ``dispatch``, a function ``(tables, static, photon_ids, seed) -> dict``
    with ``kernel.run_batch``'s keys, takes precedence over ``mesh`` and the
    device's own path (the JAX package's explicit dispatch,
    ``artes_tpu/runner.py:229-251``): it gets chunks of at most
    ``batch_size`` photon ids (the low id word, int64 on the tables'
    device) that never cross a 2^32 boundary, with the high id word folded
    into the seed as ``(seed + (start >> 32) * 0x9E3779B9) & 0xFFFFFFFF``.
    Nothing reaches it unless a caller passes it.

    The call is one job of ``spans`` (recorded inside ``spans.recording()``
    or a profiler session): ``job`` (``wl``, ``packages``, ``view_deg``: the
    detector's phi in degrees, ``crescent``: whether photons are emitted
    toward the crescent, ``path``: kernel, plain, mesh or dispatch, and
    ``launches``, the pool kernels launched)
    holds ``tables`` (``build_tables``), ``prepare`` (the kernel's static
    configuration, the path, the host's sums), a ``chunk`` a chunk (``n``,
    ``id_hi``, ``id_lo``; the kernel's ``launch`` in it, then ``wait``, where
    the host waits for the device, and ``accumulate``, the chunk's copies
    and host sums), and ``finish`` (package energy, scaling, photometry).
    """
    with spans.job(wl=wl_index, packages=packages, view_deg=det.det_phi * 180.0 / PI,
                   crescent=bool(crescent)) as job:
        device = torch.device(device) if mesh is None else mesh.device
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but torch finds no CUDA device")
        if device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {device}")
        launches = sum(pool_cuda.LAUNCHES.values()) if job else 0
        prep = build_tables(atm, cfg, det, wl_index, dtype=dtype, device=device)
        with spans.span("prepare"):
            static = _kernel_static(cfg, det, atm, crescent)

            width = max(1024, min(1 << int(np.ceil(np.log2(max(packages, 2)))), batch_size))
            chunk = CHUNK
            if dispatch is not None:
                chunk, path = batch_size, "dispatch"

                def kern(n, id_hi, id_lo):
                    return dispatch(prep.tables, static, chunk_ids(id_lo, n, device),
                                    R.key_hi(seed, id_hi))
            elif mesh is not None:
                path = "mesh"

                def kern(n, id_hi, id_lo):
                    return run_stream_mesh(prep.tables, static, n, seed, id_hi, id_lo, mesh, width)
            elif device.type == "cuda" and pool_cuda.supports(prep.tables, static):
                path = "kernel"

                def kern(n, id_hi, id_lo):
                    return pool_cuda.run_stream_cuda(prep.tables, static, n, seed, id_hi, id_lo)
            else:
                path = "plain"

                def kern(n, id_hi, id_lo):
                    return run_stream(prep.tables, static, n, seed, width, id_hi, id_lo)

            detector = np.zeros((det.nx * det.ny, 4, 3), np.float64)
            shape3 = (atm.nr, atm.ntheta, atm.nphi)
            flow_g = np.zeros(shape3 + (3,), np.float64) if static.track_flow else None
            flow_t = np.zeros(shape3 + (4,), np.float64) if static.track_flow else None
            flux_emitted = flux_exit = 0.0
            n_alive = n_error = n_anom = 0
            error_codes = np.zeros(4, np.int64)
            records = []
            if progress:
                chunk = min(chunk, max(1 << 20, -(-packages // 5)))
        start = 0
        while start < packages:
            # chunks never straddle a 2^32 id boundary: the kernel keys each
            # photon by (seed + id_hi * GOLDEN, low id word)
            n = min(chunk, packages - start, (1 << 32) - (start & 0xFFFFFFFF))
            with spans.span("chunk", n=n, id_hi=start >> 32, id_lo=start & 0xFFFFFFFF):
                out = kern(n, start >> 32, start & 0xFFFFFFFF)
                with spans.span("wait"):
                    if device.type == "cuda":
                        torch.cuda.current_stream(device).synchronize()
                with spans.span("accumulate"):
                    detector += out["detector"].cpu().numpy().astype(np.float64)
                    if static.track_flow:
                        flow_g += out["flow_global"].cpu().numpy().reshape(flow_g.shape)
                        flow_t += out["flow_theta"].cpu().numpy().reshape(flow_t.shape)
                    flux_emitted += float(out["flux_emitted"])
                    flux_exit += float(out["flux_exit"])
                    n_alive += int(out["n_alive_at_cap"])
                    n_error += int(out["n_error"])
                    n_anom += int(out.get("n_stokes_anomaly", 0))
                    error_codes += torch.as_tensor(out["error_codes"]).cpu().numpy()
                    if "error_records" in out:
                        records.append(torch.as_tensor(out["error_records"],
                                                       dtype=torch.float64).cpu())
            start += n
            if progress:
                print(f"  [{100 * start // packages:3d}%] {start:,} / {packages:,} photons",
                      file=sys.stderr, flush=True)

        with spans.span("finish"):
            e_pack = package_energy(cfg, atm, wl_index, packages, prep.emissivity_total,
                                    crescent)
            det_img = detector.reshape(det.nx, det.ny, 4, 3)
            scaled = np.empty_like(det_img)
            scaled[..., 0] = det_img[..., 0] * e_pack      # (ARTES.f90:959-975)
            scaled[..., 1] = det_img[..., 1] * e_pack * e_pack
            scaled[..., 2] = det_img[..., 2]
            result = WavelengthResult(
                detector=scaled, photometry=photometry_from_detector(scaled),
                flux_emitted=flux_emitted, flux_exit=flux_exit, n_error=n_error,
                n_alive_at_cap=n_alive, cell_depth=prep.cell_depth, prep=prep,
                error_codes=error_codes, n_stokes_anomaly=n_anom,
                error_records=select_error_records(records, ERR_RECORD_K).numpy(),
                flow_global=flow_g, flow_theta=flow_t)
        if job:
            job.set(path=path, launches=sum(pool_cuda.LAUNCHES.values()) - launches)
        return result


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


def detector_errors(detector: np.ndarray) -> np.ndarray:
    """Per-pixel standard errors incl. degree of polarization
    (ARTES.f90:3479-3519). Returns (nx, ny, 5)."""
    nx, ny = detector.shape[:2]
    err = np.zeros((nx, ny, 5))
    with np.errstate(invalid="ignore", divide="ignore"):
        n = detector[..., 2]
        m1 = np.where(n > 0, detector[..., 0] / np.maximum(n, 1), 0.0)
        m2 = np.where(n > 0, detector[..., 1] / np.maximum(n, 1), 0.0)
        var = m2 - m1 * m1
        err[..., :4] = np.where((n > 0) & (var > 0), np.sqrt(np.maximum(var, 0)) * np.sqrt(n), 0.0)
    q, u = detector[..., 1, 0], detector[..., 2, 0]
    i = detector[..., 0, 0]
    pol2 = q * q + u * u
    pol = np.sqrt(pol2)
    with np.errstate(invalid="ignore", divide="ignore"):
        dpol = np.where(pol2 > 0, np.sqrt(
            ((q * err[..., 1]) ** 2 + (u * err[..., 2]) ** 2) / np.maximum(2 * pol2, 1e-300)), 0.0)
        err[..., 4] = np.where(
            (i > 0) & (pol > 0),
            (pol / np.maximum(i, 1e-300)) * np.sqrt(
                (dpol / np.maximum(pol, 1e-300)) ** 2 + (err[..., 0] / np.maximum(i, 1e-300)) ** 2),
            0.0)
    return err


def run_spectrum(atm, cfg, packages, seed=0, wl_subset=None, **kw):
    """Per-wavelength Stokes spectrum (single-pixel detector): one
    independent run per wavelength with seed ``seed + wl``."""
    det = detector_setup(cfg, float(atm.rfront[-1]))
    wls = list(range(atm.n_wavelength)) if wl_subset is None else list(wl_subset)
    results = [run_wavelength(atm, cfg, det, wl, packages, seed=seed + wl, **kw)
               for wl in wls]
    return det, results


def run_imaging_mono(atm, cfg, packages, seed=0, wl_index=0, **kw):
    det = detector_setup(cfg, float(atm.rfront[-1]))
    return det, run_wavelength(atm, cfg, det, wl_index, packages, seed=seed, **kw)


def run_imaging_broad(atm, cfg, packages, seed=0, **kw):
    """Accumulate one detector across all wavelengths (ARTES.f90:168-204)."""
    det = detector_setup(cfg, float(atm.rfront[-1]))
    tallies = [run_wavelength(atm, cfg, det, wl, packages, seed=seed + wl, **kw)
               for wl in range(atm.n_wavelength)]
    total = sum(res.detector for res in tallies)
    summed = dataclasses.replace(tallies[-1], detector=total,
                                 photometry=photometry_from_detector(total))
    return det, summed, tallies


def run_phase_curve(atm, cfg, packages, seed=0, wl_index=0, **kw):
    """73 phase angles at 2.5-degree steps (ARTES.f90:213-250), the disk
    sampled on its crescent ring from 170 degrees (:1041)."""
    results = []
    for i, ang in enumerate(PHASE_ANGLES_DEG):
        det = detector_setup(cfg, float(atm.rfront[-1]), det_phi=ang * PI / 180.0)
        res = run_wavelength(atm, cfg, det, wl_index, packages, seed=seed + i,
                             crescent=ang >= 170.0, **kw)
        results.append((ang, det, res))
    return results
