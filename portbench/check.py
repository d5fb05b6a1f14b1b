"""Whether what the timed path produced is correct.

Once the window has closed, jobs drawn from the seed are run again by the
plain reference (``portbench/reference``, in the configuration's float32, on
the same device), from the same atmosphere arrays, configuration and view
(``inputs.run_config``, ``inputs.detector_of``), on the same photon ids
(0 .. n - 1) and the same seed: the reference builds its own tables,
transports, scales the tallies by its own package energy and computes its own
photometry. Three numbers are compared with limits of the cell's own
(``checks/<workload>.json``):

* ``tally_z``: the largest gap between the program's and the reference's
  tallies, in units of their combined Monte Carlo standard error: each
  energy-scaled Stokes flux of the disk and of each block of pixels the
  reference booked enough peels in, and the photons each side abandoned a
  photon (in error, or still alive at the scattering cap; a two-sample
  Poisson test). Where the job has more photons than the check replays, the
  reference's photons are the job's first ones and the gap is statistical;
  where it replays them all, the two follow the same photons and the gap is
  one of rounding.
* ``peels_gap``: the relative gap between the two sides' Stokes I peels
  booked per photon, which no energy scaling can hide.
* ``photometry_gap``: the largest relative gap between the program's
  photometry and the reference's arithmetic on the program's detector; the
  two compute it alike, so the limit is 0.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import inputs
from portbench.reference import config as rcfg
from portbench.reference import kernel as rkernel
from portbench.reference import runner as rrunner
from portbench.reference import tables as rtables
from portbench.reference.atmosphere import Atmosphere

REF_WIDTH = 1 << 20     # photons the reference emits together
# a job's counts of the photons it abandoned: in error, or alive at the cap
ABANDONED = ("n_error", "n_alive_at_cap")


def reference_setup(config: dict, traffic: dict, wl_index: int, device, atm=None,
                    dtype=None, phase_deg=None):
    """``(atm, cfg, det, prep, static, crescent)``: the reference's own
    atmosphere, configuration, detector, tables (in ``dtype``, the
    configuration's precision by default) and kernel constants for one job,
    and whether it emits toward the crescent."""
    if atm is None:
        atm = Atmosphere(**inputs.atmosphere_arrays(config))
    cfg = inputs.run_config(rcfg.ArtesConfig, config, traffic)
    det, crescent = inputs.detector_of(rcfg.detector_setup, cfg, float(atm.rfront[-1]),
                                       phase_deg)
    dtype = dtype or getattr(torch, config["precision"])
    prep = rtables.build_tables(atm, cfg, det, wl_index, dtype=dtype, device=device)
    return atm, cfg, det, prep, rrunner._kernel_static(cfg, det, atm, crescent), crescent


def reference_detector(config: dict, traffic: dict, wl_index: int, photons: int, seed: int,
                       device, atm=None, dtype=None, phase_deg=None) -> tuple[np.ndarray, dict]:
    """The reference's energy-scaled detector (nx, ny, 4, 3) of photons
    0 .. ``photons`` - 1 at ``seed``, as ``runner.run_wavelength`` defines it,
    and its counts of abandoned photons (``n_error``, ``n_alive_at_cap``)."""
    atm, cfg, det, prep, static, crescent = reference_setup(config, traffic, wl_index, device,
                                                            atm, dtype, phase_deg)
    out = rkernel.run_stream(prep.tables, static, photons, seed, min(photons, REF_WIDTH))
    raw = out["detector"].to(torch.float64).cpu().numpy().reshape(det.nx, det.ny, 4, 3)
    e = rrunner.package_energy(cfg, atm, wl_index, photons, prep.emissivity_total, crescent)
    scaled = np.empty_like(raw)
    scaled[..., 0] = raw[..., 0] * e
    scaled[..., 1] = raw[..., 1] * e * e
    scaled[..., 2] = raw[..., 2]
    return scaled, {k: int(out[k]) for k in ABANDONED}


def _flux_se(block: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per Stokes parameter the summed flux of ``block`` (..., 4, 3) and its
    Monte Carlo standard error, as the photometry computes it
    (ARTES.f90:977-1004)."""
    s = block.reshape(-1, 4, 3).sum(axis=0)
    flux, sq, n = s[:, 0], s[:, 1], s[:, 2]
    se = np.zeros(4)
    for k in range(4):
        if n[k] > 0:
            m1, m2 = flux[k] / n[k], sq[k] / n[k]
            var = m2 - m1 * m1
            if var > 0:
                se[k] = math.sqrt(var) * math.sqrt(n[k])
    return flux, se


def observables(det: np.ndarray, block: int, keep=None) -> dict:
    """``name -> (value, standard error)``: the disk's Stokes fluxes and each
    ``block`` x ``block`` block's (where ``keep`` names it, or all)."""
    out = {}
    flux, se = _flux_se(det)
    for k, s in enumerate("IQUV"):
        out[s] = (flux[k], se[k])
    nx, ny = det.shape[:2]
    if nx > 1:
        for bx in range(0, nx, block):
            for by in range(0, ny, block):
                name = f"block{bx // block}_{by // block}"
                if keep is not None and name not in keep:
                    continue
                flux, se = _flux_se(det[bx:bx + block, by:by + block])
                for k, s in enumerate("IQUV"):
                    out[f"{name}.{s}"] = (flux[k], se[k])
    return out


def blocks_booked(det: np.ndarray, block: int, min_count: float) -> set:
    """The blocks in which the Stokes I row counts at least ``min_count`` peels."""
    nx, ny = det.shape[:2]
    return {f"block{bx // block}_{by // block}"
            for bx in range(0, nx, block) for by in range(0, ny, block)
            if det[bx:bx + block, by:by + block, 0, 2].sum() >= min_count}


def count_z(a_prog: int, n_prog: int, a_ref: int, n_ref: int) -> float:
    """The gap between two rates of a count (``a`` of ``n`` photons) in
    standard errors of their difference, the two rates pooled (a two-sample
    Poisson test); 0 where neither side counts any."""
    if a_prog == 0 and a_ref == 0:
        return 0.0
    rate = (a_prog + a_ref) / (n_prog + n_ref)
    return abs(a_prog / n_prog - a_ref / n_ref) / math.sqrt(rate / n_prog + rate / n_ref)


def tally_z(prog: np.ndarray, ref: np.ndarray, block: int, min_count: float,
            counts: tuple = ()) -> tuple[float, str]:
    """The largest |program - reference| / sqrt(se_p^2 + se_r^2) over the
    flux observables, and over ``counts`` (``(name, a_prog, n_prog, a_ref,
    n_ref)``, by :func:`count_z`), and its name; an observable both sides
    give exactly (no error) counts 0 if equal and infinity if not."""
    keep = blocks_booked(ref, block, min_count)
    a = observables(prog, block, keep)
    b = observables(ref, block, keep)
    gaps = []
    for name, (va, sa) in a.items():
        vb, sb = b[name]
        d = abs(va - vb)
        den = math.sqrt(sa * sa + sb * sb)
        gaps.append(((0.0 if d == 0 else math.inf) if den == 0 else d / den, name))
    gaps += [(count_z(*c[1:]), c[0]) for c in counts]
    worst, where = 0.0, ""
    for z, name in gaps:
        if not z <= worst:          # NaN counts as the worst
            worst, where = z, name
    return worst, where


def peels_gap(prog: np.ndarray, prog_photons: int, ref: np.ndarray, ref_photons: int) -> float:
    a = prog[..., 0, 2].sum() / prog_photons
    b = ref[..., 0, 2].sum() / ref_photons
    return float(abs(a - b) / b) if b > 0 else (0.0 if a == b else math.inf)


def photometry_gap(prog_det: np.ndarray, prog_photometry: np.ndarray) -> float:
    ref = rrunner.photometry_from_detector(prog_det)
    gap = np.abs(np.asarray(prog_photometry) - ref) / np.maximum(np.abs(ref), 1e-300)
    gap = np.where(np.asarray(prog_photometry) == ref, 0.0, gap)
    return float(gap.max())


def sample_jobs(n_jobs: int, k: int, seed: int) -> list[int]:
    """``k`` of the window's job indices, drawn from the run's seed."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xC4EC]))
    return sorted(int(i) for i in rng.choice(n_jobs, size=min(k, n_jobs), replace=False))


def check_jobs(jobs: list, config: dict, traffic: dict, check: dict, seed: int,
               device) -> dict:
    """``(numbers, where)``: the numbers compared, each with its limit,
    ``{name: {"value", "limit"}}``, and where the worst ``tally_z`` was found."""
    atm = Atmosphere(**inputs.atmosphere_arrays(config))
    worst_z, where, worst_c, worst_p = 0.0, "", 0.0, 0.0
    done = [j for j in jobs if j.get("detector") is not None]
    for i in sample_jobs(len(done), check["jobs"], seed):
        job = done[i]
        n_ref = min(job["packages"], check["photons"])
        ref, ref_counts = reference_detector(config, traffic, job["wl"], n_ref, job["seed"],
                                             device, atm=atm, phase_deg=job.get("phase_deg"))
        counts = [(k, job[k], job["packages"], ref_counts[k], n_ref) for k in ABANDONED]
        z, name = tally_z(job["detector"], ref, check["block"], check["min_count"], counts)
        if not z <= worst_z:
            worst_z, where = z, f"job {job['index']} {name}"
        c = peels_gap(job["detector"], job["packages"], ref, n_ref)
        worst_c = c if not c <= worst_c else worst_c
        worst_p = max(worst_p, photometry_gap(job["detector"], job["photometry"]))
    if not done:
        worst_z, where, worst_c = math.inf, "no job finished", math.inf
    limits = check["limits"]
    return {"tally_z": {"value": worst_z, "limit": limits["tally_z"]},
            "peels_gap": {"value": worst_c, "limit": limits["peels_gap"]},
            "photometry_gap": {"value": worst_p, "limit": limits["photometry_gap"]}}, where


def passes(numbers: dict) -> bool:
    return all(v["value"] <= v["limit"] for v in numbers.values())
