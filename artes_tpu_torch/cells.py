"""The configurations the port's checks drive, built in one place.

Atmospheres:

* :func:`flagship`: BASELINE #1 of the JAX package's bench (bench.py:51-61),
  Rayleigh tau=5 in one radial cell.
* :func:`hydrostatic39`: 39 shells with an exponentially graded opacity
  (bench.py:110-114), the kind of grid users build with ``ptprofile``.
* :func:`thermal_bench`: the bench's self-luminous shell
  (bench.py:199-214), a pure absorber; :func:`thermal_scattering_shell`
  the half-scattering thermal shell of tests/test_pallas_stream.py:163-191,
  whose photons scatter and leave (``flux_exit`` > 0).
* :func:`lambert_layer`: the thin Rayleigh layer over a Lambert surface of
  tests/test_pallas_stream.py:251-276 (README's surface row), and as
  :func:`lambert_thick` a five-shell layer of tau = 16 whose photons scatter
  on to the default cap of ``photon:max_scatter``;
  :func:`thermal_surface_shell` the half-scattering thermal shell over a
  surface of tests/test_pallas_stream.py:404-429; :func:`lambert_sphere` the
  transparent 10 km shell of tests/test_transport.py:141-159, whose
  geometric albedo at full phase is 2/3 over a white surface.
* :func:`thin_rayleigh_shell` and :func:`transparent_thermal_shell`: the
  optically thin shells of the analytic oracles of tests/test_transport.py,
  with their expectations :func:`thin_shell_phase_oracle` (single Rayleigh
  scattering at every phase angle) and :func:`thermal_shell_oracle`
  (L / (4 pi d^2)).

* :func:`grid3d_2496`: the 39 x 8 x 8 patchy cloud deck of the bench
  (bench.py:161-175), BASELINE #4's class of grid; :func:`patchy3d_small`
  the 2 x 3 x 4 grid of tests/test_pallas_stream.py:197, and
  :func:`wedge_grid` its zones on 4 x 3 x ``nphi`` cells;
  :func:`grid3d_thermal_atm` a self-luminous, half-scattering 3-D grid with
  a patchy deck, whose theta faces include the equatorial plane and are not
  mirrored about it;
  :func:`uniform_3d` the flagship's opacity on a 3-D grid (every cell the
  same), which must give the flagship's spectrum; :func:`blended_5184` a
  grid of 5,184 cells whose every cell holds its own blend of two species;
  :func:`mie_patchy_deck` BASELINE #4's atmosphere itself
  (tools/baseline4_artifact.py:32-71): the same 39 x 8 x 8 grid over a clear
  Rayleigh column whose patchy deck carries a Mie cloud table from the
  native solver, two scattering matrices in all.

Configurations, as ``(TransportTables, KernelStatic)``:

* :func:`run_tables`: any atmosphere under ``ArtesConfig`` keys;
  :func:`spectrum_tables` its default spectrum-mode run;
  :func:`imaging_tables` the flagship imaged on npix x npix pixels (the
  bench's ``imaging_throughput_25px`` and ``_101px``, bench.py:216-235);
  :func:`crescent_offaxis` the crescent with an off-axis star of
  tests/test_pallas_stream.py:433-446.
* :data:`KERNEL_CELLS`: every configuration ``chip_smoke.py`` holds the CUDA
  kernel against its plain version on, one or more per instantiation, and
  (:func:`anomalous_rayleigh`) the Stokes-anomaly check of ``--debug-stokes``
  through each of the three kernels and scattering off through two;
  :data:`FLOW_KEYS` switches both flow outputs on; :func:`gate_photons`
  gives the photon count a cell is held at.

:func:`write_input` writes an ``input/<name>/`` directory for the CLI; its
defaults are the README quick-start input.
"""

from __future__ import annotations

import os
import pathlib

import numpy as np
import torch

from artes_tpu_torch import presets
from artes_tpu_torch.constants import R_JUP
from artes_tpu_torch.opacity import isotropic, rayleigh

QUICKSTART_OPACITY = "opacity01: 1, 5e-4, 0, nr, 0, ntheta, 0, nphi"


def flagship():
    return presets.rayleigh_single_layer(tau=5.0)


def hydrostatic39():
    atm = presets.rayleigh_single_layer(tau=4.0, nr=39, shell_km=97.5)
    prof = np.exp(np.linspace(2.0, -2.0, 39))[:, None, None, None]
    atm.k_sca = atm.k_sca * prof
    atm.k_abs = atm.k_abs * prof
    atm.refresh_derived()
    return atm


def thermal_bench():
    return presets.thermal_shell(tau_abs=0.8, nr=4)


def thermal_scattering_shell():
    tab = isotropic.generate([10.0], absorption=0.5, scattering=0.5)
    density = (1.0 / 500e3) / ((tab.absorption[0] + tab.scattering[0]) / 10.0)
    return presets._from_table(tab, R_JUP + np.linspace(0.0, 500e3, 4), (0.0, 180.0), (),
                               density, temperature=900.0)


def lambert_layer(tau=0.5):
    return presets.rayleigh_single_layer(tau=tau, nr=2)


def lambert_thick():
    """Conservative Rayleigh scattering of tau = 16 in five shells: over a
    white surface about one photon in fifteen is still alive after the 256
    scattering orders that ``photon:max_scatter`` allows by default."""
    return presets.rayleigh_single_layer(tau=16.0, nr=5)


def thermal_surface_shell():
    atm = presets.thermal_shell(tau_abs=0.4, nr=3)
    # some scattering, so that marches reach the surface
    atm.k_sca[:] = 0.5 * atm.k_abs
    atm.scatter[:] = presets.rayleigh_single_layer(nr=1).scatter[0, 0, 0]
    atm.refresh_derived()
    return atm


def lambert_sphere():
    """A transparent 10 km shell around a Jupiter-size surface."""
    return presets._from_table(rayleigh.generate([0.7]), R_JUP + np.array([0.0, 1.0e4]),
                               (0.0, 180.0), (), density_si=1.0e-12)


def anomalous_rayleigh(theta_deg=(0.0, 180.0)):
    """Rayleigh tau = 3 with an unphysical matrix, m21 = 3 P11, which drives
    Q above I (tests/test_forensics.py:44): error 050 under --debug-stokes."""
    atm = presets.rayleigh_single_layer(tau=3.0, theta_deg=theta_deg)
    atm.scatter[..., 4] = 3.0 * atm.scatter[..., 0]
    return atm


def grid3d_2496():
    theta = tuple(np.linspace(0.0, 180.0, 9))
    phi = tuple(np.linspace(0.0, 360.0, 9)[:-1])
    atm = presets.patchy_3d(tau_clear=0.2, tau_cloud=3.0, nr=39, theta_deg=theta, phi_deg=phi)
    deck = np.zeros(39, bool)
    deck[20:28] = True          # the patchy deck; a clear column above and below
    clear = atm.k_sca.min(axis=(1, 2), keepdims=True)
    atm.k_sca = np.where(deck[:, None, None, None], atm.k_sca, clear)
    atm.refresh_derived()
    return atm


def patchy3d_small():
    return presets.patchy_3d(0.5, 6.0)


def wedge_grid(nphi: int):
    """:func:`patchy3d_small`'s patchy zones on 4 shells, theta faces at 60 and
    120 degrees and ``nphi`` equal phi wedges (none cut where ``nphi`` is 1):
    the jump walks' phi crossings at every size class of their table
    (``pool_cuda.PHI_TABLE_MAX``)."""
    phi = tuple(np.linspace(0.0, 360.0, nphi + 1)[:-1]) if nphi > 1 else ()
    return presets.patchy_3d(0.5, 6.0, nr=4, phi_deg=phi)


def _patch(atm, scale, shells):
    """Scale the opacity of every other (theta, phi) zone of the radial
    ``shells`` by ``scale``."""
    zone = (np.add.outer(np.arange(atm.ntheta), np.arange(atm.nphi)) % 2 == 0)
    factor = np.ones(atm.k_sca.shape)
    factor[shells] = np.where(zone, scale, 1.0)[None, :, :, None]
    atm.k_sca = atm.k_sca * factor
    atm.k_abs = atm.k_abs * factor
    atm.refresh_derived()
    return atm


def grid3d_thermal_atm():
    """8 x 4 x 6 half-scattering cells at 900 K: a patchy deck in shells 2-5
    under and over plain shells, so the opacity jumps at radial, theta and
    phi faces alike; theta faces at 40, 90 (the plane) and 150 degrees, not
    mirrored about the equator."""
    tab = isotropic.generate([10.0], absorption=0.5, scattering=0.5)
    density = (1.0 / 500e3) / ((tab.absorption[0] + tab.scattering[0]) / 10.0)
    atm = presets._from_table(tab, R_JUP + np.linspace(0.0, 500e3, 9),
                              (0.0, 40.0, 90.0, 150.0, 180.0),
                              tuple(np.linspace(0.0, 360.0, 7)[:-1]), density, temperature=900.0)
    return _patch(atm, 4.0, slice(2, 6))


def uniform_3d():
    return presets.rayleigh_single_layer(tau=5.0, theta_deg=tuple(np.linspace(0.0, 180.0, 7)),
                                         phi_deg=tuple(np.linspace(0.0, 360.0, 6)[:-1]))


def blended_5184(seed=11):
    """12 x 18 x 24 cells, each its own blend of Rayleigh and forward-peaked
    Henyey-Greenstein scattering (no two cells share a matrix) at its own
    opacity."""
    from artes_tpu_torch.opacity import henyey_greenstein

    rs = np.random.default_rng(seed)
    ray = rayleigh.generate([0.7])
    hg = henyey_greenstein.generate([0.7], absorption=0.05, scattering=1.0, g1=0.7,
                                    p_linear=0.3)
    atm = presets._from_table(ray, R_JUP + np.linspace(0.0, 300e3, 13),
                              tuple(np.linspace(0.0, 180.0, 19)),
                              tuple(np.linspace(0.0, 360.0, 25)[:-1]), density_si=1.0)
    shape = atm.k_sca.shape
    mix = rs.uniform(0.0, 1.0, shape)
    tau_cell = rs.uniform(0.02, 0.6, shape)          # optical depth across one shell
    k_ext = tau_cell / 25e3
    ssa = 1.0 - 0.05 * (1.0 - mix)
    atm.k_sca = k_ext * ssa
    atm.k_abs = k_ext * (1.0 - ssa)
    m_ray = ray.scatter.transpose(2, 0, 1)[0]
    m_hg = hg.scatter.transpose(2, 0, 1)[0]
    atm.scatter = mix[..., None, None] * m_ray + (1.0 - mix[..., None, None]) * m_hg
    atm.refresh_derived()
    return atm


# a 70 km core under a 70000 km shell: nothing occults the shell
_THIN_RFRONT = 1.0e-3 * R_JUP + np.array([0.0, 7.0e7])


def write_refractive_index(path):
    """The forsterite-like visible-band refractive index of
    tools/baseline4_artifact.py:44-47 (n = 1.65, k = 0.003)."""
    with open(path, "w") as fh:
        for w in (0.1, 0.5, 1.0, 10.0):
            fh.write(f"{w} 1.65 0.003\n")


def mie_patchy_deck(nr=39, deck=(20, 28), nzone=8):
    """BASELINE #4's atmosphere at 0.7 micron (tools/baseline4_artifact.py:32-71)
    and its cloud's single-scattering albedo: Rayleigh tau = 0.2 over ``nr``
    shells of 97.5 km on ``nzone`` x ``nzone`` (theta, phi) zones, and in
    shells ``deck`` a Mie cloud of tau = 3 (power-law sizes a^-3.5 over
    0.1-5 micron, 30 sizes, 5 hollow fractions) in every zone whose
    (theta + phi) index is odd. The defaults are the recorded run's."""
    import tempfile

    from artes_tpu_torch.opacity import mie

    wl = 0.7
    with tempfile.TemporaryDirectory() as td:
        ri = os.path.join(td, "cloud.dat")
        write_refractive_index(ri)
        mie_tab = mie.generate(ri, [wl], nr=30, nf=5, amin=0.1, amax=5.0, apow=3.5, fmax=0.0)
    atm = presets.rayleigh_single_layer(
        tau=0.2, nr=nr, shell_km=97.5, wavelengths=(wl,),
        theta_deg=tuple(np.linspace(0.0, 180.0, nzone + 1)),
        phi_deg=tuple(np.linspace(0.0, 360.0, nzone + 1)[:-1]))
    shell_m = float(atm.rfront[1] - atm.rfront[0])
    in_deck = np.zeros(nr, bool)
    in_deck[deck[0]:deck[1]] = True
    k_cloud = 3.0 / (in_deck.sum() * shell_m)                       # [1/m]
    mie_sca = np.asarray(mie_tab.scatter).transpose(2, 0, 1)[0]     # (180, 16)
    albedo = float(mie_tab.scattering[0] / mie_tab.extinction[0])
    for it in range(atm.ntheta):
        for ip in range(atm.nphi):
            if (it + ip) % 2 == 0:
                continue
            atm.k_sca[in_deck, it, ip, 0] = k_cloud * albedo
            atm.k_abs[in_deck, it, ip, 0] = k_cloud * (1.0 - albedo)
            atm.scatter[in_deck, it, ip, 0] = mie_sca
    atm.refresh_derived()
    return atm, albedo


def thin_rayleigh_shell():
    """Rayleigh shell of radial tau about 8e-4 (test_transport.py:47-79)."""
    return presets._from_table(rayleigh.generate([0.7]), _THIN_RFRONT, (0.0, 180.0), (),
                               density_si=1.0e-6)


def transparent_thermal_shell():
    """Isothermal 900 K absorbing shell of tau about 7e-3
    (test_transport.py:82-105)."""
    tab = isotropic.generate([10.0], absorption=1.0, scattering=0.0)
    return presets._from_table(tab, _THIN_RFRONT, (0.0, 180.0), (), density_si=1.0e-9,
                               temperature=900.0)


def thin_shell_phase_oracle(atm, phase_deg):
    """Single scattering in an optically thin shell seen at phase angle
    ``phase_deg`` (scattering angle Theta = 180 - phase): ``(I / (norm pi),
    -Q / I)`` = ((4/3) k P11(Theta), sin^2 Theta / (1 + cos^2 Theta)), with
    k the extinction per outer radius, 4/3 the mean chord of a uniformly
    entered unit sphere, ``norm`` the stellar normalisation of
    ``normalization.dat`` and P11 interpolated between the matrix rows
    (centred at i + 0.5 deg)."""
    k_scaled = atm.k_sca[0, 0, 0, 0] * atm.rfront[-1]
    theta = np.radians(180.0 - phase_deg)
    p11 = np.interp(180.0 - phase_deg, np.arange(180) + 0.5, atm.scatter[0, 0, 0, 0, :, 0])
    return ((4.0 / 3.0) * k_scaled * p11,
            np.sin(theta) ** 2 / (1.0 + np.cos(theta) ** 2))


def stellar_norm(cfg, atm, wl_index=0):
    """Stellar flux normalisation of a planet of outer radius rfront[-1]
    (ARTES.f90:3984)."""
    from artes_tpu_torch.constants import PI, planck_lambda

    return (PI * planck_lambda(cfg.t_star, atm.wavelengths[wl_index]) * atm.rfront[-1] ** 2
            * cfg.r_star ** 2 / (cfg.orbit ** 2 * cfg.distance_planet ** 2))


def thermal_shell_oracle(atm, cfg, wl_index=0):
    """Flux of a transparent isothermal shell at the observer: V kappa B /
    d^2, i.e. L / (4 pi d^2) with L = 4 pi V kappa B."""
    from artes_tpu_torch.constants import planck_lambda

    b = planck_lambda(float(atm.temperature[0, 0, 0]), atm.wavelengths[wl_index])
    return atm.cell_volume().sum() * atm.k_abs[0, 0, 0, wl_index] * b / cfg.distance_planet ** 2


CELLS = {"flagship": flagship, "hydrostatic39": hydrostatic39}


def run_tables(atm, device, dtype=torch.float32, crescent=False, mode="spectrum", **keys):
    """``(TransportTables, KernelStatic)`` of ``atm`` under a default
    ``ArtesConfig`` in ``mode`` with the attributes ``keys`` set."""
    from artes_tpu_torch.config import ArtesConfig, detector_setup
    from artes_tpu_torch.runner import _kernel_static
    from artes_tpu_torch.transport.tables import build_tables

    cfg = ArtesConfig()
    cfg.mode = mode
    for k, v in keys.items():
        setattr(cfg, k, v)
    det = detector_setup(cfg, float(atm.rfront[-1]))
    return (build_tables(atm, cfg, det, 0, dtype=dtype, device=device).tables,
            _kernel_static(cfg, det, atm, crescent))


def spectrum_tables(atm, device, dtype=torch.float32):
    """``(TransportTables, KernelStatic)`` of a default spectrum-mode config."""
    return run_tables(atm, device, dtype)


def imaging_tables(npix, device, dtype=torch.float32, atm=None, **keys):
    """The flagship (or ``atm``) imaged on ``npix`` x ``npix`` pixels at the
    default 90 deg phase."""
    return run_tables(flagship() if atm is None else atm, device, dtype,
                      mode="imaging_mono", npix=npix, **keys)


def phase_tables(atm, phase_deg, device, dtype=torch.float32):
    """``(TransportTables, KernelStatic)`` of ``atm`` seen at one angle of the
    phase curve, as ``runner.run_phase_curve`` sets it up (the crescent from
    170 deg)."""
    from artes_tpu_torch.config import ArtesConfig, detector_setup
    from artes_tpu_torch.constants import PI
    from artes_tpu_torch.runner import _kernel_static
    from artes_tpu_torch.transport.tables import build_tables

    cfg = ArtesConfig()
    cfg.mode = "phase"
    det = detector_setup(cfg, float(atm.rfront[-1]), det_phi=phase_deg * PI / 180.0)
    return (build_tables(atm, cfg, det, 0, dtype=dtype, device=device).tables,
            _kernel_static(cfg, det, atm, phase_deg >= 170.0))


def hg_cloud_deck():
    """BASELINE #2's triple-HG cloud deck (tools/baseline_scale_artifacts.py:37)."""
    return presets.hg_cloud_deck(tau=6.0, g=0.6, p_linear=0.4)


# BASELINE #1's wavelengths (examples/baseline_configs.py:30-40) [micron]
BASELINE1_WAVELENGTHS = tuple(0.5 + 0.05 * i for i in range(6))


def baseline1_layer():
    """BASELINE #1's Rayleigh tau = 5 layer at its six wavelengths."""
    return presets.rayleigh_single_layer(tau=5.0, wavelengths=BASELINE1_WAVELENGTHS)


def baseline5_thermal_layer():
    """BASELINE #5's second part (examples/baseline_configs.py:80-88): a
    Rayleigh tau = 3 layer at 0.7 micron, 700 K, k_abs = 0.1 k_sca."""
    atm = presets.rayleigh_single_layer(tau=3.0, wavelengths=(0.7,))
    atm.temperature[:] = 700.0
    atm.k_abs[:] = atm.k_sca * 0.1
    return presets.Atmosphere(
        rfront=atm.rfront, thetafront=atm.thetafront, phifront=atm.phifront,
        wavelengths=atm.wavelengths, density=atm.density, temperature=atm.temperature,
        k_sca=atm.k_sca, k_abs=atm.k_abs, scatter=atm.scatter)


def crescent_offaxis(device, dtype=torch.float32):
    """Crescent sampling with the star at theta* = 1.2, phi* = 0.4 on a
    Rayleigh tau=1 two-shell grid (tests/test_pallas_stream.py:433-446)."""
    return run_tables(presets.rayleigh_single_layer(tau=1.0, nr=2), device, dtype,
                      crescent=True, stellar_direction=True, theta_star=1.2, phi_star=0.4)


FLOW_KEYS = dict(flow_global=True, flow_theta=True)
SURFACE_MAX_SCATTER = 8
# photons a cell when a kernel is held against its plain version, by the walks
# the cell takes (``kernel.walk_mode``): what the plain version affords. Marched
# grids of at most MARCH_SMALL_CELLS cells run the closed-form count.
GATE_PHOTONS = {"closed": 1 << 20, "jumps": 1 << 18, "march": 1 << 16}
MARCH_SMALL_CELLS = 4
# the gate's plain versions run this many worker processes at a time on one
# card (chip_smoke.py phase 3, measure.py contraction): each is bound by its
# launches on the host
PLAIN_TOGETHER = 4


def gate_photons(tables, static) -> int:
    """The photon count at which ``pool_cuda.AGREE*`` hold a configuration."""
    from artes_tpu_torch.transport.kernel import walk_mode

    mode = walk_mode(tables, static)
    if mode == "march" and tables.opacity.shape[0] <= MARCH_SMALL_CELLS:
        mode = "closed"
    return GATE_PHOTONS[mode]

KERNEL_CELLS = {
    "flagship": lambda dev: spectrum_tables(flagship(), dev),
    "hydrostatic39": lambda dev: spectrum_tables(hydrostatic39(), dev),
    "imaging25": lambda dev: imaging_tables(25, dev),
    "imaging101": lambda dev: imaging_tables(101, dev),
    "thermal_iso": lambda dev: run_tables(thermal_bench(), dev, photon_source="planet"),
    "thermal_biased": lambda dev: run_tables(thermal_bench(), dev, photon_source="planet",
                                             photon_emission="biased"),
    "thermal_scattering": lambda dev: run_tables(thermal_scattering_shell(), dev,
                                                 photon_source="planet"),
    "thermal_imaging25": lambda dev: imaging_tables(25, dev, atm=thermal_scattering_shell(),
                                                    photon_source="planet"),
    "crescent_offaxis": crescent_offaxis,
    # BASELINE #2's cloud deck at 177.5 deg: the crescent's grazing entries
    "hg_crescent": lambda dev: phase_tables(hg_cloud_deck(), 177.5, dev),
    "grid3d_2496": lambda dev: spectrum_tables(grid3d_2496(), dev),
    "grid3d_imaging25": lambda dev: imaging_tables(25, dev, atm=grid3d_2496()),
    "grid3d_thermal": lambda dev: run_tables(grid3d_thermal_atm(), dev, photon_source="planet"),
    "grid3d_thermal_imaging25": lambda dev: imaging_tables(25, dev, atm=grid3d_thermal_atm(),
                                                           photon_source="planet"),
    "patchy3d_small": lambda dev: spectrum_tables(patchy3d_small(), dev),
    "blended_5184": lambda dev: spectrum_tables(blended_5184(), dev),
    "mie_patchy_imaging25": lambda dev: imaging_tables(25, dev, atm=mie_patchy_deck()[0]),
    # Lambert surfaces: marching walks on radial and 3-D grids
    "lambert_tau05": lambda dev: run_tables(lambert_layer(), dev, surface_albedo=1.0),
    "lambert_imaging25": lambda dev: imaging_tables(25, dev, atm=lambert_layer(),
                                                    surface_albedo=0.8),
    "thermal_surface": lambda dev: run_tables(thermal_surface_shell(), dev,
                                              photon_source="planet", surface_albedo=0.7),
    "thermal_surface_imaging25": lambda dev: imaging_tables(
        25, dev, atm=thermal_surface_shell(), photon_source="planet", surface_albedo=0.7),
    # every scattering order up to the default cap, on five shells
    "lambert_thick": lambda dev: run_tables(lambert_thick(), dev, surface_albedo=1.0),
    # scattering orders cut at SURFACE_MAX_SCATTER on the two 39-shell grids:
    # the plain version marches every order through up to 200 passes
    "hydrostatic39_surface": lambda dev: run_tables(hydrostatic39(), dev, surface_albedo=0.5,
                                                    max_scatter=SURFACE_MAX_SCATTER),
    "grid3d_2496_surface": lambda dev: run_tables(grid3d_2496(), dev, surface_albedo=0.5,
                                                  max_scatter=SURFACE_MAX_SCATTER),
    # flow diagnostics: the closed-form hook on radial grids, marching walks on 3-D ones
    "hydrostatic39_flow": lambda dev: run_tables(hydrostatic39(), dev, **FLOW_KEYS),
    "thermal_flow": lambda dev: run_tables(thermal_scattering_shell(), dev,
                                           photon_source="planet", **FLOW_KEYS),
    "imaging25_flow": lambda dev: imaging_tables(25, dev, **FLOW_KEYS),
    "thermal_imaging25_flow": lambda dev: imaging_tables(
        25, dev, atm=thermal_scattering_shell(), photon_source="planet", **FLOW_KEYS),
    "grid3d_2496_flow": lambda dev: run_tables(grid3d_2496(), dev, **FLOW_KEYS),
    "grid3d_thermal_flow": lambda dev: run_tables(grid3d_thermal_atm(), dev,
                                                  photon_source="planet", **FLOW_KEYS),
    "patchy3d_imaging25_surface_flow": lambda dev: imaging_tables(
        25, dev, atm=patchy3d_small(), surface_albedo=0.5, **FLOW_KEYS),
    "grid3d_thermal_surface_flow": lambda dev: imaging_tables(
        25, dev, atm=grid3d_thermal_atm(), photon_source="planet", surface_albedo=0.5,
        **FLOW_KEYS),
    # --debug-stokes (error 050) through each kernel, and scattering off
    "anomaly_radial": lambda dev: run_tables(anomalous_rayleigh(), dev, debug_stokes=True),
    "anomaly_grid3d": lambda dev: run_tables(anomalous_rayleigh((0.0, 90.0, 180.0)), dev,
                                             debug_stokes=True),
    "anomaly_surface": lambda dev: run_tables(anomalous_rayleigh(), dev, debug_stokes=True,
                                              surface_albedo=0.5),
    "noscatter_flagship": lambda dev: run_tables(flagship(), dev, photon_scattering=False),
    "noscatter_patchy3d": lambda dev: run_tables(patchy3d_small(), dev,
                                                 photon_scattering=False),
}

# the configurations of the BASELINE chains that baselines.py holds the kernel
# against its plain version on (``baselines.kernel_vs_plain``), which the
# gate's limits hold too: #1 at 0.50 micron, #2's deck at 97.5 and 177.5 deg
# (the latter is KERNEL_CELLS' hg_crescent), #5's 700 K layer as a planet
CHAIN_CELLS = {
    "baseline1_0.50um": lambda dev: spectrum_tables(baseline1_layer(), dev),
    "baseline2_97.5deg": lambda dev: phase_tables(hg_cloud_deck(), 97.5, dev),
    "baseline2_177.5deg": lambda dev: phase_tables(hg_cloud_deck(), 177.5, dev),
    "baseline5_700K": lambda dev: run_tables(baseline5_thermal_layer(), dev,
                                             photon_source="planet"),
}


def write_artes_in(d, fstop=None, keys=()):
    """artes.in of a stellar spectrum seen from theta = phi = 90 deg, with
    ``keys`` (``key=value`` lines) appended."""
    lines = ["photon:source=star", "detector:type=spectrum",
             "detector:theta=90", "detector:phi=90"]
    if fstop is not None:
        lines.insert(1, f"photon:fstop={fstop}")
    pathlib.Path(d, "artes.in").write_text("\n".join(lines + list(keys)) + "\n")


def write_input(root, name="demo", wavelengths=(0.7,), radial="100",
                opacity=QUICKSTART_OPACITY, fstop=None) -> pathlib.Path:
    """Write ``root/input/<name>/`` (Rayleigh opacity FITS, atmosphere.in,
    artes.in) and build its ``atmosphere.fits``; returns the directory."""
    from artes_tpu_torch.atmosphere import build_and_write
    from artes_tpu_torch.opacity.base import write_opacity_fits

    d = pathlib.Path(root, "input", name)
    os.makedirs(d / "opacity")
    write_opacity_fits(d / "opacity" / "rayleigh.fits", rayleigh.generate(list(wavelengths)))
    (d / "atmosphere.in").write_text(
        f"[grid]\nradius: 1.\nradial: {radial}\ntheta:\nphi:\n\n[composition]\n"
        f"gas: off\nfits01: rayleigh.fits\n{opacity}\n")
    write_artes_in(d, fstop)
    build_and_write(str(d))
    return d


def write_artifact_input(root, name, atm, keys=()) -> pathlib.Path:
    """``root/input/<name>/`` holding ``atm`` as ``atmosphere.fits`` and an
    :func:`write_artes_in` file with ``keys``; returns the directory."""
    from artes_tpu_torch.atmosphere import write_artifact

    d = pathlib.Path(root, "input", name)
    os.makedirs(d)
    write_artifact(str(d / "atmosphere.fits"), atm)
    write_artes_in(d, keys=keys)
    return d
