"""BASELINE.md's five end-to-end chains, run from the port alone.

Three run presets through the runner's entry points and are held against
the TPU records of BASELINE_RUNS.json (:data:`BASELINE2`,
:data:`BASELINE2_CURVE`, :data:`BASELINE5`, TPU v5e):

* **#1**, a reflected-light spectrum (examples/baseline_configs.py:30-40):
  ``presets.rayleigh_single_layer(tau=5)`` at 0.50-0.75 micron,
  ``runner.run_spectrum``, 1e6 photons a wavelength, seed 0 + wl. Every
  wavelength's I / I_star_norm and -Q/I with their Monte Carlo sigma. The
  0.50 micron wavelength has tau 5 and the wavelength-free Rayleigh matrix:
  it is the flagship's optical structure, so its -Q/I is held within
  3 sqrt(sigma^2 + sigma_5^2) of #5's pol_frac and its I / norm within
  3 sigma of #5's. Its kernel is held against the plain version at the
  gate's photons.
* **#2**, the 73-angle polarized phase curve
  (tools/baseline_scale_artifacts.py:35-74): ``presets.hg_cloud_deck(tau=6,
  g=0.6, p_linear=0.4)``, ``runner.run_phase_curve`` at 1e7 photons an
  angle, angle i at seed 3 + i, the crescent from 170 degrees. Held: the
  peak of the polarization at 97.5 degrees, its height within 3 sqrt(2)
  sigma, the forward/back I ratio within 3 sqrt(2) times its relative
  sigma, every angle's I and pol_frac within 3 sqrt(2) sigma (floors
  :data:`FLOORS_2`); the record has no sigma, so sigma is the port's own.
  The kernel against the plain version at 97.5 and 177.5 degrees.
* **#5**, (a) the flagship at 1e10 photons, seed 5, through
  ``runner.run_wavelength``'s chunk loop: ten chunks of at most 2^30 ids,
  the high id word 0, 1 and 2 (tools/baseline_scale_artifacts.py:76-107),
  read from the run's ``chunk`` spans (:func:`chunk_schedule`).
  Held: Stokes I within 2e-3 (the flagship anchor's limit); with the
  run's sums added as the TPU kernel adds them (:func:`record_sums`),
  pol_frac within 3 sqrt(sigma^2 + sigma_5^2) and Stokes I within 3 sqrt(2)
  sigma; no photon abandoned; the capped photons within 3 sqrt(a + b) of
  the record's (:func:`check_5`). (b) ``config5``
  (examples/baseline_configs.py:80-98, ``cells.baseline5_thermal_layer``):
  the same kind of layer at tau 3, 700 K and k_abs = 0.1 k_sca, lit by the
  star and glowing, 2^24 photons each, seed 0, full Stokes reported; the
  thermal kernel held against its plain version.

These three hold their kernels against their plain versions on the tables
of ``cells.CHAIN_CELLS`` (:func:`kernel_vs_plain`), where the gate's limits
are read too.

Two start from the opacity tooling:

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

    python -m artes_tpu_torch.baselines 1|2|3|4|5 [--device cpu] [--photons N]

Each chain prints a line a step and, last, one JSON object with its
figures, the card's name and power limit, the kernel launches it made (the
kernel-against-plain checks not counted) and ``ok``; the exit code is 1
when a held check misses. The checks against the records hold at the
records' photon counts; at another count the figures are reported and only
their finiteness and the conservation rule (#3), whose tolerance follows
the count, are checked. Everything is written to a temporary directory.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import sys
import tempfile
import time

import numpy as np
import torch

from artes_tpu_torch import cells, spans
from artes_tpu_torch.constants import PI, planck_lambda
from artes_tpu_torch.transport.tables import compute_cell_depth

# BASELINE_RUNS.json (TPU v5e). #2: the HG cloud deck's phase curve, 1e7
# photons an angle, seed 3 + angle; its rows (phase [deg], Stokes I
# [W m-2 m-1], pol_frac). #5: the flagship at 1e10 photons, seed 5
BASELINE2 = {"forward_over_back_I": 193820.59877185532,
             "max_pol_frac": 0.16999506487748486, "max_pol_angle_deg": 97.5,
             "photons_per_s": 69994143.02722307}
BASELINE2_CURVE = (
    (1e-05, 5.563439024407108e-13, 9.183269332625388e-05),
    (2.5, 5.552214710483416e-13, 0.00028580662167948333),
    (5.0, 5.53568908271755e-13, 0.0008953699838278624),
    (7.5, 5.508931103214137e-13, 0.0018327186222533661),
    (10.0, 5.470080901835294e-13, 0.003337325964257415),
    (12.5, 5.427097760525396e-13, 0.004983798858905317),
    (15.0, 5.372472388745479e-13, 0.007284532495786013),
    (17.5, 5.313081070256661e-13, 0.009974284564445992),
    (20.0, 5.247463927281426e-13, 0.012602600478698043),
    (22.5, 5.172783278168868e-13, 0.015926250210493636),
    (25.0, 5.088649979408016e-13, 0.019530370137477295),
    (27.5, 5.00689588048878e-13, 0.023669857968690658),
    (30.0, 4.915860826755182e-13, 0.027784133690931613),
    (32.5, 4.816814605275747e-13, 0.03256729281615179),
    (35.0, 4.726166808296702e-13, 0.03761403732323471),
    (37.5, 4.62468195414852e-13, 0.0424749646907752),
    (40.0, 4.5282290793640084e-13, 0.04797343235052083),
    (42.5, 4.421706113893799e-13, 0.05399413640387479),
    (45.0, 4.313977982762342e-13, 0.05965478467152179),
    (47.5, 4.2054055281343565e-13, 0.06580162236971578),
    (50.0, 4.098737282420051e-13, 0.07207356955331587),
    (52.5, 3.9861446215569153e-13, 0.07861685281959511),
    (55.0, 3.876634213145215e-13, 0.08529564436476113),
    (57.5, 3.7743533836336844e-13, 0.09174926756404472),
    (60.0, 3.6651363658448004e-13, 0.09862878259716831),
    (62.5, 3.554449093118106e-13, 0.10580819379380914),
    (65.0, 3.4445007213731506e-13, 0.11248002577181564),
    (67.5, 3.3388937761433093e-13, 0.1191655135930406),
    (70.0, 3.230839236151742e-13, 0.12607953017906567),
    (72.5, 3.128501332258602e-13, 0.1323832674264865),
    (75.0, 3.0256874940593183e-13, 0.13874553586285646),
    (77.5, 2.9186593495585035e-13, 0.14455258757067552),
    (80.0, 2.819276813747768e-13, 0.1499112551426932),
    (82.5, 2.721106047245738e-13, 0.15507567472907496),
    (85.0, 2.6249979771964024e-13, 0.15919019522151612),
    (87.5, 2.531035620882101e-13, 0.16309247379374628),
    (90.0, 2.433269091942376e-13, 0.1660624612599808),
    (92.5, 2.3434486376521093e-13, 0.16815163232191058),
    (95.0, 2.2544041119382623e-13, 0.16950665205425614),
    (97.5, 2.1701863808277577e-13, 0.16999506487748486),
    (100.0, 2.0840002910854003e-13, 0.16918880955194515),
    (102.5, 2.0000698186393573e-13, 0.1678716541282356),
    (105.0, 1.920017338163546e-13, 0.16523605359996602),
    (107.5, 1.83822562203825e-13, 0.16217925267894237),
    (110.0, 1.7613135296959678e-13, 0.157459618986536),
    (112.5, 1.6869533933297174e-13, 0.15268855210081875),
    (115.0, 1.6164106368838082e-13, 0.14701829657098645),
    (117.5, 1.5402282475857332e-13, 0.14102723874859005),
    (120.0, 1.4739135943476526e-13, 0.1338643032609857),
    (122.5, 1.4068214795435644e-13, 0.12677708963713472),
    (125.0, 1.3389166444129286e-13, 0.11919224192068317),
    (127.5, 1.2711845654167084e-13, 0.11115888830365718),
    (130.0, 1.2114048109505772e-13, 0.10286171379937345),
    (132.5, 1.1476607454081447e-13, 0.09484315823897604),
    (135.0, 1.0884437160433318e-13, 0.08689105975479684),
    (137.5, 1.0277077298406988e-13, 0.0785785152074093),
    (140.0, 9.670230398281481e-14, 0.07034070020134593),
    (142.5, 9.018278227566251e-14, 0.0626367615117032),
    (145.0, 8.39928002650501e-14, 0.05502866195816184),
    (147.5, 7.815749308411799e-14, 0.04787422634245249),
    (150.0, 7.17466249621196e-14, 0.04085698308743699),
    (152.5, 6.494058750084482e-14, 0.034636863214440254),
    (155.0, 5.836331925511007e-14, 0.028176708915170344),
    (157.5, 5.074351785514488e-14, 0.022702092421283213),
    (160.0, 4.349208795722335e-14, 0.017574156525357716),
    (162.5, 3.6176396314967524e-14, 0.01302681034584375),
    (165.0, 2.8685920275148074e-14, 0.009014728071949954),
    (167.5, 2.1115215814816943e-14, 0.0057626945423580435),
    (170.0, 1.4368359062845956e-14, 0.003147624684172757),
    (172.5, 8.441221737233961e-15, 0.001079233045017006),
    (175.0, 3.8756375045874585e-15, 9.545669830267553e-05),
    (177.5, 9.653334310315258e-16, 0.0006387088271259439),
    (179.99999, 2.870406478805582e-18, 0.0037228274044719184),
)
BASELINE5 = {"pol_frac": 0.4032326968274678, "pol_frac_mc_err": 4.179936761733731e-06,
             "stokes_IQUV_W_m2_um": (4.384910843295346e-19, -1.7681394245116648e-19, 2.5111794827992805e-24, 0.0),
             "n_error": 0, "n_alive_at_cap": 43,
             "photons_per_s": 126453067.10435955}
PHOTONS_1 = 1_000_000
WAVELENGTHS_1 = cells.BASELINE1_WAVELENGTHS               # [micron]
PHOTONS_2 = 10_000_000
SEED_2 = 3
# #2's per-angle floors: I relative, pol_frac absolute
FLOORS_2 = {"I": 2e-3, "pol_frac": 1e-3}
PHOTONS_5 = 10_000_000_000
SEED_5 = 5
PHOTONS_5B = 1 << 24
LIMIT_I_5 = 2e-3                         # chip_smoke.py's flagship anchor
CHECK_SEED = 7                           # the kernel-against-plain checks
LIMIT_NAMES = {"closed": "AGREE", "jumps": "AGREE_3D", "march": "AGREE_MARCH"}
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
        result["ok"] = held_ok(result["checks"])
    else:
        result["ok"] = bool(np.isfinite(out["detector"].numpy()).all())
    return result


def _card(device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    from artes_tpu_torch.measure import card_line
    return card_line()


def kernel_vs_plain(tables, static) -> dict:
    """A configuration's kernel against its plain version on the card, at
    ``cells.gate_photons``, seed :data:`CHECK_SEED`: the gaps of
    ``pool_cuda.gaps``, the limits that hold it and whether they do."""
    from artes_tpu_torch.cells import gate_photons
    from artes_tpu_torch.transport import kernel, pool_cuda

    n = gate_photons(tables, static)
    limits = pool_cuda.limits_of(tables, static)
    g = pool_cuda.gaps(pool_cuda.run_stream_cuda(tables, static, n, CHECK_SEED),
                       kernel.run_stream(tables, static, n, CHECK_SEED, n))
    return {"photons": n, "seed": CHECK_SEED, "variant": pool_cuda.kernel_of(tables, static)[1],
            "limits": LIMIT_NAMES[kernel.walk_mode(tables, static)], "gaps": g,
            "ok": pool_cuda.agrees(g, limits)}


def _sigmas(detector) -> tuple[float, float]:
    """Monte Carlo sigma of a one-pixel detector's Stokes I and of its degree
    of polarization (``runner.detector_errors``)."""
    from artes_tpu_torch.runner import detector_errors

    err = detector_errors(detector)[0, 0]
    return float(err[0]), float(err[4])


def _check(value, record, gap, limit) -> dict:
    return {"value": value, "record": record, "gap": gap, "limit": limit,
            "ok": bool(gap <= limit)}


def held_ok(checks) -> bool:
    """Whether every held check is within its limit (one marked
    ``"held": False`` is reported only)."""
    return all(c["ok"] for c in checks.values() if c.get("held", True))


def record_5_I_over_norm() -> float:
    """#5's record as I / I_star_norm (examples/baseline_configs.py:23-27):
    its Stokes I over the stellar norm of the flagship at 0.7 micron."""
    from artes_tpu_torch import presets
    from artes_tpu_torch.cells import stellar_norm
    from artes_tpu_torch.config import ArtesConfig

    return BASELINE5["stokes_IQUV_W_m2_um"][0] * 1e6 / stellar_norm(
        ArtesConfig(), presets.rayleigh_single_layer(tau=5.0))


def check_1(result) -> dict:
    """#1's 0.50 micron row against #5's record: -Q/I within 3 sqrt(sigma^2 +
    sigma_5^2) of its pol_frac, I / norm within 3 sigma of its."""
    row = result["rows"][0]
    ref_p, ref_i = BASELINE5["pol_frac"], record_5_I_over_norm()
    return {"minus_Q_over_I": _check(
                row["minus_Q_over_I"], ref_p, abs(row["minus_Q_over_I"] - ref_p),
                3.0 * math.hypot(row["sigma_minus_Q_over_I"], BASELINE5["pol_frac_mc_err"])),
            "I_over_norm": _check(row["I_over_norm"], ref_i, abs(row["I_over_norm"] - ref_i),
                                  3.0 * row["sigma_I_over_norm"])}


def chain_1(photons=PHOTONS_1, device="cuda") -> dict:
    """BASELINE #1's chain, returning its figures; see the module docstring."""
    from artes_tpu_torch import runner
    from artes_tpu_torch.config import ArtesConfig
    from artes_tpu_torch.transport import pool_cuda

    atm = cells.baseline1_layer()
    cfg = ArtesConfig()
    cfg.mode = "spectrum"
    before = dict(pool_cuda.LAUNCHES)
    runner.run_spectrum(atm, cfg, 1 << 12, wl_subset=[0], device=device)       # warm-up
    rows = []
    for wl in range(atm.n_wavelength):
        t0 = time.perf_counter()
        _, (res,) = runner.run_spectrum(atm, cfg, photons, wl_subset=[wl], device=device)
        dt = time.perf_counter() - t0
        p, norm = res.photometry, cells.stellar_norm(cfg, atm, wl)
        sigma_i, sigma_p = _sigmas(res.detector)
        rows.append({"wavelength_um": float(atm.wavelengths[wl] * 1e6),
                     "I_over_norm": float(p[0] / norm), "sigma_I_over_norm": sigma_i / norm,
                     "minus_Q_over_I": float(-p[2] / p[0]), "sigma_minus_Q_over_I": sigma_p,
                     "n_error": res.n_error, "n_alive_at_cap": res.n_alive_at_cap,
                     "seconds": dt, "photons_per_s": photons / dt})
        r = rows[-1]
        say(f"#1 {r['wavelength_um']:.2f} um: I/norm {r['I_over_norm']!r} +/- "
            f"{r['sigma_I_over_norm']:.3g}, -Q/I {r['minus_Q_over_I']!r} +/- "
            f"{r['sigma_minus_Q_over_I']:.3g}, {photons / dt / 1e6:.2f}M photons/s")
    result = {"chain": 1, "config": "BASELINE #1: Rayleigh tau=5 layer, reflected Stokes "
                                    "spectrum at 0.50-0.75 micron",
              "device": _device_name(device), "photons_per_wavelength": photons, "seed": 0,
              "rows": rows, "launches": _launches(before)}
    ok = all(np.isfinite([r["I_over_norm"], r["minus_Q_over_I"]]).all() for r in rows)
    if torch.device(device).type == "cuda":
        result["cross_kernel"] = kernel_vs_plain(*cells.CHAIN_CELLS["baseline1_0.50um"](device))
        say(f"#1 kernel vs plain at 0.50 um: {result['cross_kernel']}")
        ok = ok and result["cross_kernel"]["ok"]
    if photons == PHOTONS_1:
        result["checks"] = check_1(result)
        ok = ok and held_ok(result["checks"])
    result["ok"] = bool(ok)
    return result


def figures_2(curve) -> dict:
    """tools/baseline_scale_artifacts.py:56-68 on a curve of rows with
    ``phase_deg``, ``I`` and ``pol_frac``."""
    i_vals = np.asarray([c["I"] for c in curve])
    with np.errstate(divide="ignore", invalid="ignore"):     # few photons: no back light
        ratio = float(i_vals[0] / i_vals[-1])
    return {"forward_over_back_I": ratio,
            "max_pol_frac": float(max(c["pol_frac"] for c in curve)),
            "max_pol_angle_deg": float(max(curve, key=lambda c: c["pol_frac"])["phase_deg"])}


def check_2(curve) -> dict:
    """#2's curve (rows with ``sigma_I`` and ``sigma_pol_frac`` beside the
    figures of :func:`figures_2`) against :data:`BASELINE2` and
    :data:`BASELINE2_CURVE`; see the module docstring."""
    fig = figures_2(curve)
    k = 3.0 * math.sqrt(2.0)
    peak = next(c for c in curve if c["phase_deg"] == fig["max_pol_angle_deg"])
    first, last = curve[0], curve[-1]
    rel_fb = math.hypot(first["sigma_I"] / first["I"], last["sigma_I"] / last["I"])
    checks = {
        "max_pol_angle_deg": _check(fig["max_pol_angle_deg"], BASELINE2["max_pol_angle_deg"],
                                    abs(fig["max_pol_angle_deg"]
                                        - BASELINE2["max_pol_angle_deg"]), 0.0),
        "max_pol_frac": _check(fig["max_pol_frac"], BASELINE2["max_pol_frac"],
                               abs(fig["max_pol_frac"] - BASELINE2["max_pol_frac"]),
                               k * peak["sigma_pol_frac"]),
        "forward_over_back_I": _check(fig["forward_over_back_I"],
                                      BASELINE2["forward_over_back_I"],
                                      abs(fig["forward_over_back_I"]
                                          / BASELINE2["forward_over_back_I"] - 1.0), k * rel_fb)}
    # every angle: the worst gap over its limit, and how many angles hold
    for key, scale in (("I", True), ("pol_frac", False)):
        ratios = []
        for c, (ang, ref_i, ref_p) in zip(curve, BASELINE2_CURVE):
            ref = ref_i if scale else ref_p
            sigma = c["sigma_I"] / c["I"] if scale else c["sigma_pol_frac"]
            gap = abs(c[key] / ref - 1.0) if scale else abs(c[key] - ref)
            ratios.append((gap / max(k * sigma, FLOORS_2[key]), ang))
        worst, ang = max(ratios)
        checks[f"every_angle_{key}"] = {
            "value": sum(r <= 1.0 for r, _ in ratios), "record": len(BASELINE2_CURVE),
            "gap": worst, "limit": 1.0, "worst_angle_deg": ang, "ok": bool(worst <= 1.0)}
    return checks


def chain_2(photons=PHOTONS_2, device="cuda") -> dict:
    """BASELINE #2's chain, returning its figures; see the module docstring."""
    from artes_tpu_torch import runner
    from artes_tpu_torch.config import ArtesConfig, detector_setup
    from artes_tpu_torch.transport import pool_cuda

    atm = cells.hg_cloud_deck()
    cfg = ArtesConfig()
    cfg.mode = "phase"
    r_out = float(atm.rfront[-1])
    before = dict(pool_cuda.LAUNCHES)
    # warm both launches (plain sampling and the crescent from 170 degrees)
    for ang, crescent in ((0.5, False), (178.0, True)):
        runner.run_wavelength(atm, cfg, detector_setup(cfg, r_out, det_phi=ang * PI / 180.0), 0,
                              1 << 13, device=device, crescent=crescent)
    t0 = time.perf_counter()
    rows = runner.run_phase_curve(atm, cfg, photons, seed=SEED_2, device=device)
    wall = time.perf_counter() - t0
    curve = []
    for ang, _, res in rows:
        p = res.photometry
        sigma_i, sigma_p = _sigmas(res.detector)
        curve.append({"phase_deg": ang, "I": float(p[0]), "Q": float(p[2]), "U": float(p[4]),
                      "pol_frac": float(p[9]), "sigma_I": sigma_i, "sigma_pol_frac": sigma_p,
                      "n_error": res.n_error})
    fig = figures_2(curve)
    say(f"#2: {len(curve)} angles x {photons:.0e} photons in {wall:.2f} s "
        f"({len(curve) * photons / wall / 1e6:.2f}M photons/s): forward/back I "
        f"{fig['forward_over_back_I']!r}, max pol_frac {fig['max_pol_frac']!r} at "
        f"{fig['max_pol_angle_deg']} deg")
    result = {"chain": 2, "config": "BASELINE #2: triple-HG cloud deck tau=6 g=0.6 "
                                    "p_linear=0.4, 73-angle phase curve",
              "device": _device_name(device), "photons_per_angle": photons, "seed": SEED_2,
              **fig, "wall_seconds": wall, "photons_per_s": len(curve) * photons / wall,
              "n_error_total": sum(c["n_error"] for c in curve), "curve": curve,
              "launches": _launches(before)}
    ok = all(np.isfinite([c["I"], c["pol_frac"]]).all() for c in curve)
    if torch.device(device).type == "cuda":
        result["cross_kernel"] = {}
        for ang in (97.5, 177.5):
            cross = kernel_vs_plain(*cells.CHAIN_CELLS[f"baseline2_{ang}deg"](device))
            result["cross_kernel"][str(ang)] = cross
            say(f"#2 kernel vs plain at {ang} deg: {cross}")
            ok = ok and cross["ok"]
    if photons == PHOTONS_2:
        result["checks"] = check_2(curve)
        ok = ok and held_ok(result["checks"])
    result["ok"] = bool(ok)
    return result


def record_sums(atm, cfg, det, chunks, seed, iquv, device="cuda") -> dict:
    """The scale run's Stokes sums ``iquv`` as the TPU kernel that made the
    record adds them. Its 8192 lanes each add their scatter peels into
    float32 sums over a chunk (artes_tpu/transport/pallas_stream.py:1781-1784;
    131072 photons a lane in a 2^30 chunk), whose rounding drops a share of
    the peels once a lane's sum is large. The radial kernel's build
    ``pool_radial_lanes`` runs the first chunk of each size of ``chunks``
    (``(id_hi, id_lo, n)``) on that many lanes and sums the same peels both
    ways; each chunk of the run takes the float32 sums' difference from the
    double ones, over I, on the chunk of its size. Returns the differences,
    the sums and pol_frac so corrected, and the seconds it took. The build
    is a CUDA kernel: on another device this raises."""
    from artes_tpu_torch import _build, runner
    from artes_tpu_torch.transport import pool_cuda

    if torch.device(device).type != "cuda":
        raise ValueError(f"the record's float32 lanes run on a CUDA card, not on {device}")
    prep = runner.build_tables(atm, cfg, det, 0, dtype=torch.float32, device=device)
    static = runner._kernel_static(cfg, det, atm, False)
    read = _build.load("pool_radial_lanes").artes_pool_radial_lane_sums
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    read.restype = ctypes.c_int
    host = (ctypes.c_double * 4)()
    t0 = time.perf_counter()
    rel = {}
    for hi, lo, n in chunks:
        if n in rel:
            continue
        if read(ctypes.addressof(host), 1) != 4:
            raise RuntimeError("pool_radial_lanes: the lane sums cannot be read")
        out = pool_cuda.run_stream_cuda(prep.tables, static, n, seed, hi, lo,
                                        build="pool_radial_lanes")
        exact = out["detector"][0, :, 0].double().cpu().tolist()
        if read(ctypes.addressof(host), 1) != 4:
            raise RuntimeError("pool_radial_lanes: the lane sums cannot be read")
        rel[n] = {"id_hi": hi, "id_lo": lo, "photons": n,
                  "float32_minus_double_over_I": [(host[k] - exact[k]) / exact[0]
                                                  for k in range(4)]}
    sums = summed_as_record(iquv, chunks, {n: c["float32_minus_double_over_I"]
                                           for n, c in rel.items()})
    return {"lanes": _build.TPU_LANES, "chunks": list(rel.values()),
            "stokes_IQUV_W_m2_um": sums, "pol_frac": math.hypot(sums[1], sums[2]) / sums[0],
            "seconds": time.perf_counter() - t0}


def summed_as_record(iquv, chunks, diffs) -> list:
    """Stokes sums ``iquv`` of a run of ``chunks`` (``(id_hi, id_lo, n)``)
    with each chunk's float32-minus-double difference added, ``diffs[n]``
    (four, over I) for a chunk of ``n`` photons, in proportion to its share
    of the photons."""
    total = sum(n for _, _, n in chunks)
    return [iquv[k] + iquv[0] * sum(n * diffs[n][k] for _, _, n in chunks) / total
            for k in range(4)]


def check_5(scale) -> dict:
    """#5's scale run against :data:`BASELINE5`; see the module docstring.
    pol_frac is compared as the record's kernel sums it
    (``scale["record_sums"]``, :func:`record_sums`), and so is Stokes I a
    second time, within 3 sqrt(2) of its sigma (the record's taken as the
    port's): the TPU kernel's float32 lanes put the record's I 4.1e-4 below
    the port's own sums and its pol_frac 1.40e-4 above them, 33 of the
    pol_frac limit's sigmas (PERF.md)."""
    ref = BASELINE5
    a, b = scale["n_alive_at_cap"], ref["n_alive_at_cap"]
    pol = scale["record_sums"]["pol_frac"]
    i_rec, i_ref = scale["record_sums"]["stokes_IQUV_W_m2_um"][0], ref["stokes_IQUV_W_m2_um"][0]
    return {"pol_frac": _check(pol, ref["pol_frac"], abs(pol - ref["pol_frac"]),
                               3.0 * math.hypot(scale["pol_frac_mc_err"], ref["pol_frac_mc_err"])),
            "stokes_I_as_record_sums": _check(i_rec, i_ref, abs(i_rec / i_ref - 1.0),
                                              3.0 * math.sqrt(2.0) * scale["stokes_I_mc_err"]
                                              / scale["stokes_IQUV_W_m2_um"][0]),
            "stokes_I": _check(scale["stokes_IQUV_W_m2_um"][0], ref["stokes_IQUV_W_m2_um"][0],
                               abs(scale["stokes_IQUV_W_m2_um"][0]
                                   / ref["stokes_IQUV_W_m2_um"][0] - 1.0), LIMIT_I_5),
            "n_error": _check(scale["n_error"], ref["n_error"], abs(scale["n_error"]), 0),
            "n_alive_at_cap": _check(a, b, abs(a - b), 3.0 * math.sqrt(a + b))}


def chunk_schedule(recorded) -> list:
    """``(id_hi, id_lo, n)`` of each ``chunk`` span of a recording, in
    order: the chunks ``runner.run_wavelength`` ran."""
    return [(c.attrs["id_hi"], c.attrs["id_lo"], c.attrs["n"]) for c in recorded
            if c.name == "chunk"]


def chain_5(photons=PHOTONS_5, device="cuda", photons_b=PHOTONS_5B) -> dict:
    """BASELINE #5's chain, returning its figures; see the module docstring."""
    from artes_tpu_torch import presets, runner
    from artes_tpu_torch.config import ArtesConfig, detector_setup
    from artes_tpu_torch.transport import pool_cuda

    atm = presets.rayleigh_single_layer(tau=5.0)
    cfg = ArtesConfig()
    cfg.mode = "spectrum"
    det = detector_setup(cfg, float(atm.rfront[-1]))
    before = dict(pool_cuda.LAUNCHES)
    runner.run_wavelength(atm, cfg, det, 0, 1 << 16, seed=SEED_5, device=device)   # warm-up
    with spans.recording() as recorded:
        t0 = time.perf_counter()
        res = runner.run_wavelength(atm, cfg, det, 0, photons, seed=SEED_5, device=device)
        wall = time.perf_counter() - t0
    chunks = chunk_schedule(recorded.spans)
    p = res.photometry
    scale = {"photons": photons, "seed": SEED_5, "wall_seconds": wall,
             "photons_per_s": photons / wall, "tpu_photons_per_s": BASELINE5["photons_per_s"],
             "stokes_IQUV_W_m2_um": [float(p[k] * 1e-6) for k in (0, 2, 4, 6)],
             "stokes_I_mc_err": float(p[1] * 1e-6),
             "pol_frac": float(p[9]), "pol_frac_mc_err": float(p[10]),
             "n_error": res.n_error, "n_alive_at_cap": res.n_alive_at_cap,
             "chunks_id_hi_id_lo_n": chunks}
    say(f"#5 (a): {photons:.4g} photons in {len(chunks)} chunks {chunks} in {wall:.2f} s "
        f"({photons / wall / 1e6:.2f}M photons/s; TPU record {BASELINE5['photons_per_s']:.5g}): "
        f"I {scale['stokes_IQUV_W_m2_um'][0]!r} W m-2 um-1, pol_frac {scale['pol_frac']!r} +/- "
        f"{scale['pol_frac_mc_err']:.3g}, abandoned {res.n_error}, capped {res.n_alive_at_cap}")
    if photons == PHOTONS_5:
        rec = record_sums(atm, cfg, det, chunks, SEED_5, scale["stokes_IQUV_W_m2_um"], device)
        scale["record_sums"] = rec
        say(f"#5 (a) summed as the record's kernel sums ({rec['lanes']} float32 lanes, "
            f"{rec['seconds']:.1f} s): float32 minus double over I "
            + "; ".join(f"{c['photons']} photons at ({c['id_hi']}, {c['id_lo']}) "
                        f"{c['float32_minus_double_over_I']}" for c in rec["chunks"])
            + f"; I {rec['stokes_IQUV_W_m2_um'][0]!r}, pol_frac {rec['pol_frac']!r} (the run's "
            f"own {scale['pol_frac']!r}, the record {BASELINE5['pol_frac']!r})")
    atm_b = cells.baseline5_thermal_layer()
    sources = {}
    for source in ("star", "planet"):
        cfg_b = ArtesConfig()
        cfg_b.photon_source = source
        cfg_b.mode = "spectrum"
        det_b = detector_setup(cfg_b, float(atm_b.rfront[-1]))
        t0 = time.perf_counter()
        r = runner.run_wavelength(atm_b, cfg_b, det_b, 0, photons_b, device=device)
        dt = time.perf_counter() - t0
        q = r.photometry
        sources[source] = {"stokes_IQUV_W_m2_um": [float(q[k] * 1e-6) for k in (0, 2, 4, 6)],
                           "pol_frac": float(q[9]), "n_error": r.n_error, "seconds": dt,
                           "photons_per_s": photons_b / dt}
        say(f"#5 (b) {source}: {photons_b} photons seed 0, IQUV "
            f"{sources[source]['stokes_IQUV_W_m2_um']} W m-2 um-1 in {dt:.3f} s")
    result = {"chain": 5, "config": "BASELINE #5: (a) the flagship at 1e10 photons; (b) "
                                    "reflected + thermal, Rayleigh tau=3 at 700 K",
              "device": _device_name(device), "scale": scale,
              "reflected_thermal": {"photons": photons_b, "seed": 0, "sources": sources},
              "launches": _launches(before)}
    ok = bool(np.isfinite(scale["stokes_IQUV_W_m2_um"]).all() and all(
        np.isfinite(s["stokes_IQUV_W_m2_um"]).all() for s in sources.values()))
    if torch.device(device).type == "cuda":
        result["cross_kernel"] = kernel_vs_plain(*cells.CHAIN_CELLS["baseline5_700K"](device))
        say(f"#5 (b) thermal kernel vs plain: {result['cross_kernel']}")
        ok = ok and result["cross_kernel"]["ok"]
    if photons == PHOTONS_5:
        result["checks"] = check_5(scale)
        ok = ok and held_ok(result["checks"])
    result["ok"] = bool(ok)
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m artes_tpu_torch.baselines",
                                description="BASELINE #1-#5 end to end: #1 reflected spectrum, "
                                            "#2 phase curve, #3 molecular thermal spectrum, "
                                            "#4 3-D Mie cloud image, #5 1e10 photons and "
                                            "reflected + thermal")
    p.add_argument("chain", type=int, choices=(1, 2, 3, 4, 5))
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--photons", type=float, default=None,
                   help=f"photons (a wavelength for #1 and #3, an angle for #2; for #5 the "
                        f"scale run's, and at most 2^24 for its reflected + thermal part); "
                        f"default {PHOTONS_1:.0e} (#1), {PHOTONS_2:.0e} (#2), {PHOTONS_3:.0e} "
                        f"(#3), 2^24 (#4), {PHOTONS_5:.0e} (#5)")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: torch finds no CUDA device")
    n = None if args.photons is None else int(args.photons)
    if args.chain == 3:
        with tempfile.TemporaryDirectory(prefix="artes_b3_") as workdir:
            result = chain_3(workdir, n or PHOTONS_3, args.device)
    elif args.chain == 5:
        result = chain_5(n or PHOTONS_5, args.device, min(n or PHOTONS_5B, PHOTONS_5B))
    else:
        chain = {1: chain_1, 2: chain_2, 4: chain_4}[args.chain]
        result = chain(n or {1: PHOTONS_1, 2: PHOTONS_2, 4: PHOTONS_4}[args.chain], args.device)
    result["card"] = _card(args.device)
    print(json.dumps(result))
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
