"""BASELINE.md's two end-to-end chains that start from the opacity tooling,
run from the port alone:

* **#3**, a self-luminous gas giant with molecular opacities
  (tools/baseline3_artifact.py:104-180): ``ptprofile.self_luminous`` (t_eff
  900 K, 40 levels) -> ``molecules.generate_layers`` -> ``cli build`` of a
  hydrostatic grid with ``gas: on`` -> a thermal spectrum,
  ``runner.run_wavelength`` per wavelength (2e7 photons, seed 7) -> the
  conservation check of :func:`unscattered_oracle_flux`
  (tools/baseline3_artifact.py:235-256). The reference's molecular tables
  are not in the repository, so :func:`write_molecule_dir` writes a
  synthetic set in their contract (``opacity.molecules``), made from a
  numpy seed.
* **#4**, a 3-D patchy Mie cloud deck imaged at 25 x 25
  (tools/baseline4_artifact.py:32-120): the native Mie solver's cloud table
  on the 39 x 8 x 8 grid of ``cells.mie_patchy_deck`` (two scattering
  matrices), a 2^24-photon ``imaging_mono`` image (seed 41 warms up, seed 42
  is timed) and the kernel against its plain version at 2^16 photons, seed
  7. The image is held against BASELINE4.json (:data:`BASELINE4`, TPU v5e)
  within :data:`LIMITS_4`; its abandoned photons are reported by code beside
  the record's and its 3-sigma band.

Run (on the card unless ``--device cpu``, which runs the plain version)::

    python -m artes_tpu_torch.baselines 3|4 [--device cpu] [--photons N]

Each chain prints a line a step and, last, one JSON object with its
figures, the kernel launches it made (the kernel-against-plain check of #4
not counted) and ``ok``; the exit code is 1 when a check misses. The checks
against the records hold at the records' photon counts; at another count
the figures are reported and only the conservation rule (#3), whose
tolerance follows the count, is checked. Everything is written to a
temporary directory.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time

import numpy as np
import torch

from artes_tpu_torch.constants import PI, planck_lambda
from artes_tpu_torch.transport.tables import compute_cell_depth

# BASELINE4.json (TPU v5e, 2^24 photons, seed 42) and the limits the port's
# image is held to: lit pixels, Stokes I total (relative, the flagship
# anchor's limit), the largest -Q/I, the cloud's albedo
BASELINE4 = {"lit_pixels": 181, "stokes_I_total": 323060.8873910196,
             "max_minus_Q_over_I": 0.9204819539027274, "n_error": 1375,
             "albedo": 0.9587269929906982}
LIMITS_4 = {"lit_pixels": 3, "stokes_I_total": 2e-3, "max_minus_Q_over_I": 0.01,
            "albedo": 1e-12}
PHOTONS_4 = 1 << 24
CHECK_PHOTONS_4 = 1 << 16
PHOTONS_3 = 20_000_000
LEVELS_3 = 40
WL_RANGE_3 = (0.9, 1.4)                  # [micron]
SEED_3 = 7
MOLECULE_SEED = 3
# the synthetic molecular tables: a log-uniform wavelength grid whose step
# puts 44 samples in [0.9, 1.4] micron and the 45th just beyond it (the one
# molecules.layer_table keeps past wl_max), and a P-T grid around the #3
# profile's 1e-3-1e2 bar and 758-3744 K
MOLECULE_DLNWL = 0.0101
MOLECULE_WL = 0.9 * np.exp(MOLECULE_DLNWL * np.arange(-20, 80))
MOLECULE_P = np.logspace(-3.0, 2.0, 11)            # [bar]
MOLECULE_T = np.geomspace(700.0, 4000.0, 8)        # [K]


def write_molecule_dir(path, seed=MOLECULE_SEED):
    """Write ``PTgrid.dat`` and one ``opacity_aver_NNNN.dat`` per P-T point
    (the contract of ``opacity.molecules``) for a synthetic absorber:
    log10 of the opacity x VMR [cm2/molecule] is -25 plus a pressure slope
    of 0.3-0.6 and a temperature slope of 0.5-1.5 (per dex, about 1 bar and
    1000 K) plus four Gaussian absorption bands of 0.8-2.5 dex between 0.85
    and 1.45 micron, all drawn from ``seed``. The law is linear in log P
    and log T, so ``PTGrid.interpolate`` reproduces it between the grid
    points. Returns ``path``."""
    rng = np.random.default_rng(seed)
    centre = rng.uniform(0.85, 1.45, 4)
    width = rng.uniform(0.015, 0.06, 4)
    depth = rng.uniform(0.8, 2.5, 4)
    slope_p, slope_t = rng.uniform(0.3, 0.6), rng.uniform(0.5, 1.5)
    wl = MOLECULE_WL
    bands = (depth[:, None] * np.exp(-0.5 * ((wl - centre[:, None]) / width[:, None]) ** 2)).sum(0)
    os.makedirs(path, exist_ok=True)
    rows = []
    for t in MOLECULE_T:
        for p in MOLECULE_P:
            idx = len(rows) + 1
            log_k = -25.0 + slope_p * np.log10(p) + slope_t * np.log10(t / 1000.0) + bands
            np.savetxt(os.path.join(path, f"opacity_aver_{idx:04d}.dat"),
                       np.column_stack([wl, 10.0 ** log_k]))
            rows.append((idx, p, t))
    with open(os.path.join(path, "PTgrid.dat"), "w") as fh:
        fh.write("# File - Pressure [bar] - Temperature [K]\n")
        for idx, p, t in rows:
            fh.write(f"{idx}\t{float(p)!r}\t{float(t)!r}\n")
    return path


def unscattered_oracle_flux(atm, wl, distance, n_mu=96, n_r=16):
    """Deterministic unscattered emergent flux toward the detector
    [W m-2 m-1] (tools/baseline3_artifact.py:28-101): the sum over cells of
    L_cell <e^-tau(p -> detector)> / (4 pi d^2), the no-scattering limit of
    the thermal transport. On a spherically symmetric grid tau depends only
    on (r, mu), mu the cosine between the radius vector and the detector
    direction: a volume-weighted midpoint quadrature in r^3 (``n_r`` points
    a cell) and a uniform one in mu (``n_mu``), tau the exact chord sum over
    the shells ahead (extinction), rays that run into the photon floor
    dropped. The tool loops over rays and shells in Python; this evaluates
    a cell's rays and shells as arrays, the same arithmetic summed in
    another order."""
    k = atm.k_ext[:, 0, 0, wl]
    k_abs = atm.k_abs[:, 0, 0, wl]
    rf = atm.rfront
    cd = compute_cell_depth(atm, wl, photon_source=2)
    temp = atm.temperature[:, 0, 0]
    vol = 4.0 / 3.0 * PI * (rf[1:] ** 3 - rf[:-1] ** 3)
    planck = np.where(temp > 0, planck_lambda(np.maximum(temp, 1.0), atm.wavelengths[wl]), 0.0)
    lum = 4.0 * PI * vol * k_abs * planck          # [W m-1] per cell
    lum[:cd] = 0.0
    mus = np.linspace(-1.0, 1.0, n_mu + 1)
    mus = (mus[:-1] + mus[1:]) / 2.0
    lo, hi = rf[:-1], rf[1:]                        # every shell's faces
    total = 0.0
    for j in np.nonzero(lum)[0]:
        r3 = np.linspace(rf[j] ** 3, rf[j + 1] ** 3, n_r + 1)
        rs = ((r3[:-1] + r3[1:]) / 2.0) ** (1.0 / 3.0)
        b = rs[:, None] * np.sqrt(np.maximum(0.0, 1.0 - mus * mus))   # (n_r, n_mu) impact
        s0 = (rs[:, None] * mus)[..., None]                            # position on the ray
        bb = b[..., None]
        h_hi = np.sqrt(np.maximum(0.0, hi * hi - bb * bb))             # (n_r, n_mu, nr)
        h_lo = np.where(lo > bb, np.sqrt(np.maximum(0.0, lo * lo - bb * bb)), 0.0)
        tau = np.zeros_like(h_hi)
        # the line's two segments in each shell, [-h_hi, -h_lo] and [h_lo, h_hi],
        # as far as they lie ahead of s0
        for a0, a1 in ((-h_hi, -h_lo), (h_lo, h_hi)):
            seg = np.minimum(np.maximum(0.0, np.minimum(a1, 1e99) - np.maximum(a0, s0)), a1 - a0)
            tau += np.where((hi > bb) & (seg > 0.0) & (a1 > s0), seg * k, 0.0)
        seen = ~((b < rf[cd]) & (mus < 0.0))       # rays inward past the floor end there
        total += lum[j] * np.exp(-tau.sum(-1))[seen].sum() / (n_r * n_mu)
    return total / (4.0 * PI * distance ** 2)


def _device_name(device) -> str:
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _launches(before: dict) -> dict:
    from artes_tpu_torch.transport import pool_cuda

    return {k: v - before[k] for k, v in pool_cuda.LAUNCHES.items() if v > before[k]}


def conservation_tolerance(photons: int) -> float:
    """tools/baseline3_artifact.py:239-249: ratio - 1 must lie in
    [-tol, 1.5 albedo_max + tol], tol = max(5 / sqrt(N), 0.005)."""
    return max(5.0 / math.sqrt(photons), 0.005)


def say(msg):
    print(msg, flush=True)


def chain_3(workdir, photons=PHOTONS_3, device="cuda") -> dict:
    """BASELINE #3's chain in ``workdir`` (its molecule tables, ``input/b3/``
    and the transport), returning its figures; see the module docstring."""
    from artes_tpu_torch import cli
    from artes_tpu_torch.atmosphere import load_artifact
    from artes_tpu_torch.config import detector_setup, load_config
    from artes_tpu_torch.opacity import molecules, ptprofile
    from artes_tpu_torch.runner import run_wavelength
    from artes_tpu_torch.transport import pool_cuda

    t_all = time.perf_counter()
    d = os.path.join(workdir, "input", "b3")
    os.makedirs(os.path.join(d, "opacity"))
    pressure, temperature = ptprofile.self_luminous(t_eff=900.0, kappa=1e-2, log_g=3.4,
                                                    levels=LEVELS_3)
    ptprofile.write_profile(os.path.join(d, "pressureTemperature.dat"), pressure, temperature)
    t0 = time.perf_counter()
    mol = write_molecule_dir(os.path.join(workdir, "molecules"))
    # the builder's cells are the lower levels-1 rows of the profile
    molecules.generate_layers(mol, pressure[:-1], temperature[:-1], *WL_RANGE_3,
                              os.path.join(d, "opacity"))
    t_opac = time.perf_counter() - t0
    with open(os.path.join(d, "atmosphere.in"), "w") as fh:
        fh.write("[grid]\nradius: 1.\ntheta:\nphi:\n\n"
                 "[composition]\ngas: on\nmolweight: 2.3\nlog_g: 3.4\n")
    with open(os.path.join(d, "artes.in"), "w") as fh:
        fh.write("photon:source=planet\nphoton:emission=isotropic\n"
                 "detector:type=spectrum\ndetector:theta=90\ndetector:phi=90\n")
    t0 = time.perf_counter()
    if cli.main(["build", "b3", "--root", workdir]) != 0:
        raise RuntimeError("cli build b3 failed")
    t_build = time.perf_counter() - t0
    say(f"#3: {LEVELS_3}-level self-luminous profile, synthetic molecules (seed {MOLECULE_SEED}) "
        f"in {t_opac:.2f} s, atmosphere built in {t_build:.2f} s")

    cfg = load_config(os.path.join(d, "artes.in"))
    atm = load_artifact(os.path.join(d, "atmosphere.fits"))
    det = detector_setup(cfg, float(atm.rfront[-1]))
    before = dict(pool_cuda.LAUNCHES)
    t0 = time.perf_counter()
    run_wavelength(atm, cfg, det, 0, 1 << 16, seed=SEED_3, device=device)     # warm-up
    t_warm = time.perf_counter() - t0
    tol = conservation_tolerance(photons)
    rows = []
    for wl in range(atm.n_wavelength):
        t0 = time.perf_counter()
        res = run_wavelength(atm, cfg, det, wl, photons, seed=SEED_3, device=device)
        dt = time.perf_counter() - t0
        detected = float(res.detector[..., 0, 0].sum())            # I [W m-2 m-1]
        oracle = unscattered_oracle_flux(atm, wl, cfg.distance_planet)
        albedo_max = float(atm.albedo[:, 0, 0, wl].max())
        ratio = detected / max(oracle, 1e-300)
        rows.append({"wavelength_um": float(atm.wavelengths[wl] * 1e6),
                     "photons_per_s": photons / dt, "seconds": dt,
                     "detected_flux_W_m2_per_m": detected, "oracle_flux_W_m2_per_m": oracle,
                     "detected_over_oracle": ratio, "albedo_max": albedo_max,
                     "cell_depth": res.cell_depth, "n_error": res.n_error,
                     "within_rule": bool(-tol <= ratio - 1.0 <= 1.5 * albedo_max + tol)})
        say(f"#3 wl {rows[-1]['wavelength_um']:.6f} um: {photons / dt / 1e6:.2f}M photons/s, "
            f"detected/oracle {ratio:.5f} (albedo max {albedo_max:.4g}, cell depth "
            f"{res.cell_depth}, abandoned {res.n_error})")
    rates = [r["photons_per_s"] for r in rows]
    n_error = sum(r["n_error"] for r in rows)
    return {
        "chain": 3, "config": "BASELINE #3: self-luminous gas giant, molecular opacities",
        "device": _device_name(device), "photons_per_wavelength": photons,
        "nr": atm.nr, "n_wavelength": atm.n_wavelength,
        "opacity_generation_seconds": t_opac, "atmosphere_build_seconds": t_build,
        "kernel_warmup_seconds": t_warm,
        "throughput_photons_per_s": {"median": float(np.median(rates)),
                                     "min": float(np.min(rates)), "max": float(np.max(rates))},
        "conservation": {"tolerance": tol,
                         "worst_excess_beyond_albedo_allowance": float(max(
                             r["detected_over_oracle"] - 1.0 - 1.5 * r["albedo_max"]
                             for r in rows)),
                         "worst_deficit": float(min(r["detected_over_oracle"] - 1.0
                                                    for r in rows)),
                         "wavelengths_within_rule": sum(r["within_rule"] for r in rows)},
        "n_error_total": n_error, "launches": _launches(before),
        "total_seconds": time.perf_counter() - t_all, "rows": rows,
        "ok": bool(all(r["within_rule"] for r in rows) and n_error == 0),
    }


def _transport(tables, static, n, seed, device, plain=False):
    """One launch of the configuration's kernel (a card), or its plain
    version (the CPU, or ``plain``), as host tallies."""
    from artes_tpu_torch.transport import kernel, pool_cuda

    if torch.device(device).type == "cuda" and not plain:
        out = pool_cuda.run_stream_cuda(tables, static, n, seed)
    else:
        out = kernel.run_stream(tables, static, n, seed, min(n, 1 << 17))
    return {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in out.items()}


def image_figures(detector) -> dict:
    """tools/baseline4_artifact.py:102-107: lit pixels, the Stokes I total
    and the largest -Q/I of a raw detector (npix, 4, 3)."""
    img = np.asarray(detector, np.float64)
    i = img[:, 0, 0]
    return {"lit_pixels": int((i != 0).sum()), "stokes_I_total": float(i.sum()),
            "max_minus_Q_over_I": float((-img[:, 1, 0] / np.maximum(i, 1e-300)).max())}


def check_4(result) -> dict:
    """Each figure of #4 against :data:`BASELINE4` within :data:`LIMITS_4`
    (the Stokes I total relative); ``n_error`` against the record's 3-sigma
    band, reported and not held."""
    got = dict(result["image"], albedo=result["albedo"])
    checks = {}
    for key, limit in LIMITS_4.items():
        ref = BASELINE4[key]
        gap = abs(got[key] - ref) / (abs(ref) if key == "stokes_I_total" else 1.0)
        checks[key] = {"value": got[key], "record": ref, "gap": gap, "limit": limit,
                       "ok": bool(gap <= limit)}
    band = 3.0 * math.sqrt(BASELINE4["n_error"])
    checks["n_error"] = {"value": result["n_error"], "record": BASELINE4["n_error"],
                         "gap": abs(result["n_error"] - BASELINE4["n_error"]), "limit": band,
                         "ok": bool(abs(result["n_error"] - BASELINE4["n_error"]) <= band),
                         "held": False}
    return checks


def chain_4(photons=PHOTONS_4, device="cuda") -> dict:
    """BASELINE #4's chain, returning its figures; see the module
    docstring."""
    from artes_tpu_torch.cells import imaging_tables, mie_patchy_deck
    from artes_tpu_torch.transport import pool_cuda

    t0 = time.perf_counter()
    atm, albedo = mie_patchy_deck()
    t_atm = time.perf_counter() - t0
    n_matrices = len(np.unique(atm.scatter[..., 0, :, :].reshape(-1, 180 * 16), axis=0))
    say(f"#4: Mie cloud table (albedo {albedo!r}) and the {atm.nr} x {atm.ntheta} x {atm.nphi} "
        f"grid with {n_matrices} scattering matrices in {t_atm:.2f} s")
    tables, static = imaging_tables(25, device, atm=atm)
    before = dict(pool_cuda.LAUNCHES)
    t0 = time.perf_counter()
    _transport(tables, static, photons, 41, device)                      # warm-up
    t_warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = _transport(tables, static, photons, 42, device)
    dt = time.perf_counter() - t0
    launches = _launches(before)
    codes = out["error_codes"].tolist()
    result = {
        "chain": 4, "config": "BASELINE #4: 3-D patchy Mie clouds, detector image",
        "device": _device_name(device), "photons": photons, "albedo": albedo,
        "grid": [atm.nr, atm.ntheta, atm.nphi], "n_matrices": n_matrices,
        "atmosphere_seconds": t_atm, "warmup_seconds": t_warm, "seconds": dt,
        "throughput_photons_per_s": photons / dt, "image": image_figures(out["detector"]),
        "n_error": int(out["n_error"]),
        "error_codes": dict(zip(("031", "032", "034", "peel walk"), codes)),
        "launches": launches,
    }
    say(f"#4: {photons} photons seed 42 in {dt:.3f} s ({photons / dt / 1e6:.2f}M photons/s): "
        f"{result['image']['lit_pixels']} lit pixels, Stokes I {result['image']['stokes_I_total']!r}"
        f", max -Q/I {result['image']['max_minus_Q_over_I']!r}; abandoned {result['n_error']} "
        f"{result['error_codes']}")
    if torch.device(device).type == "cuda":
        # kernel against plain version on the same photons (not counted above)
        k = _transport(tables, static, CHECK_PHOTONS_4, 7, device)
        p = _transport(tables, static, CHECK_PHOTONS_4, 7, device, plain=True)
        dk, dp = k["detector"].double(), p["detector"].double()
        result["cross_kernel"] = {
            "photons": CHECK_PHOTONS_4,
            "counts_maxdiff": int((dk[..., 2] - dp[..., 2]).abs().max()),
            "image_I_rel": float(abs(dk[:, 0, 0].sum() - dp[:, 0, 0].sum())
                                 / abs(dp[:, 0, 0].sum())),
            # the gate's pixel_V: Stokes V pixel by pixel, scaled by V itself
            "image_V_pixel_rel": float((dk[:, 3, 0] - dp[:, 3, 0]).abs().sum()
                                       / dp[:, 3, 0].abs().sum())}
        say(f"#4 kernel vs plain, {CHECK_PHOTONS_4} photons seed 7: {result['cross_kernel']}")
    if photons == PHOTONS_4:
        result["checks"] = check_4(result)
        result["ok"] = all(c["ok"] for c in result["checks"].values() if c.get("held", True))
    else:
        result["ok"] = bool(np.isfinite(out["detector"].numpy()).all())
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m artes_tpu_torch.baselines",
                                description="BASELINE #3 (molecular thermal spectrum) or #4 "
                                            "(3-D Mie cloud image) end to end")
    p.add_argument("chain", type=int, choices=(3, 4))
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--photons", type=float, default=None,
                   help=f"photons (a wavelength for #3); default {PHOTONS_3:.0e} (#3), "
                        f"2^24 (#4)")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: torch finds no CUDA device")
    if args.chain == 3:
        with tempfile.TemporaryDirectory(prefix="artes_b3_") as workdir:
            result = chain_3(workdir, int(args.photons or PHOTONS_3), args.device)
    else:
        result = chain_4(int(args.photons or PHOTONS_4), args.device)
    print(json.dumps(result))
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
