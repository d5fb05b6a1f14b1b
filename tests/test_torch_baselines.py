"""BASELINE #3's and #4's chains in the port against the JAX package, on the
CPU.

* A ``gas: on`` hydrostatic input (self-luminous profile, the synthetic
  molecular layers of ``baselines.write_molecule_dir``, a Mie cloud FITS in a
  zone) built by both CLIs' ``build``: ``atmosphere.fits`` and
  ``atmosphere.dat`` byte-equal, ``load_artifact`` equal.
* At float64, the plain version against JAX's ``run_stream`` (the helpers of
  tests/test_torch_pool.py and tests/test_torch_grid3d.py: counts bit-equal,
  moments within rtol 1e-10): #4's Mie deck narrowed to 4 shells and 4 x 4
  zones imaged at 25 x 25, and #3's atmosphere cut to 5 shells as a thermal
  spectrum at its two wavelengths.
* ``baselines.unscattered_oracle_flux`` within 1e-12 of
  tools/baseline3_artifact.py's on the 5-shell atmosphere.
* ``cells.mie_patchy_deck`` equal, array for array, to
  tools/baseline4_artifact.py's ``build_atmosphere``.
* ``python -m artes_tpu_torch.baselines 3|4 --device cpu`` at a few photons:
  every figure finite, the conservation rule held (#3).
"""

import dataclasses
import importlib.util
import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import artes_tpu.atmosphere as j_atmosphere
from artes_tpu import cli as j_cli
from artes_tpu.config import ArtesConfig, detector_setup
from artes_tpu.runner import _kernel_static
from artes_tpu.transport.tables import build_tables
from artes_tpu_torch import atmosphere as t_atmosphere
from artes_tpu_torch import baselines, cells
from artes_tpu_torch import cli as t_cli
from artes_tpu_torch.opacity import mie, molecules, ptprofile
from artes_tpu_torch.opacity.base import read_opacity_fits, write_opacity_fits
from artes_tpu_torch.transport import convert
from test_torch_grid3d import assert_matches_jax_3d
from test_torch_pool import assert_matches_jax
from test_torch_standalone import _same
from torch_threads import one_thread, one_thread_env  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_atmosphere(atm):
    """The JAX package's ``Atmosphere`` holding the arrays of the port's."""
    return j_atmosphere.Atmosphere(**{f.name: getattr(atm, f.name)
                                      for f in dataclasses.fields(atm)})


def write_gas_input(root, levels, wl_range, cloud_zone=None):
    """``root/input/b3/``: the #3 chain's input (self-luminous profile of
    ``levels`` levels, synthetic molecular layers over ``wl_range``), with a
    Mie cloud table painted into ``cloud_zone`` (an ``opacity01`` line)."""
    d = pathlib.Path(root, "input", "b3")
    os.makedirs(d / "opacity")
    pressure, temperature = ptprofile.self_luminous(t_eff=900.0, kappa=1e-2, log_g=3.4,
                                                    levels=levels)
    ptprofile.write_profile(d / "pressureTemperature.dat", pressure, temperature)
    mol = baselines.write_molecule_dir(pathlib.Path(root, "molecules"))
    paths = molecules.generate_layers(mol, pressure[:-1], temperature[:-1], *wl_range,
                                      d / "opacity")
    composition = "gas: on\nmolweight: 2.3\nlog_g: 3.4\n"
    if cloud_zone:
        cells.write_refractive_index(d / "cloud.dat")
        write_opacity_fits(d / "opacity" / "cloud.fits",
                           mie.generate(d / "cloud.dat", read_opacity_fits(paths[0]).wavelength,
                                        nr=12, nf=3, amin=0.2, amax=3.0, apow=3.5))
        composition += f"fits01: cloud.fits\nopacity01: {cloud_zone}\n"
    (d / "atmosphere.in").write_text("[grid]\nradius: 1.\ntheta: 60, 120\nphi: 180\n\n"
                                     if cloud_zone else "[grid]\nradius: 1.\ntheta:\nphi:\n\n")
    with open(d / "atmosphere.in", "a") as fh:
        fh.write("[composition]\n" + composition)
    (d / "artes.in").write_text("photon:source=planet\nphoton:emission=isotropic\n"
                                "detector:type=spectrum\ndetector:theta=90\ndetector:phi=90\n")
    return d


def test_gas_on_build_matches_jax(tmp_path):
    write_gas_input(tmp_path / "port", 8, (0.9, 0.96), cloud_zone="1, 2e-7, 2, 5, 1, 2, 0, 2")
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    assert t_cli.main(["build", "b3", "--root", str(tmp_path / "port")]) == 0
    assert j_cli.main(["build", "b3", "--root", str(tmp_path / "jax")]) == 0
    for name in ("atmosphere.fits", "atmosphere.dat"):
        got = (tmp_path / "port" / "input" / "b3" / name).read_bytes()
        assert got == (tmp_path / "jax" / "input" / "b3" / name).read_bytes(), name
    path = tmp_path / "port" / "input" / "b3" / "atmosphere.fits"
    got, ref = t_atmosphere.load_artifact(path), j_atmosphere.load_artifact(path)
    assert (got.nr, got.ntheta, got.nphi, got.n_wavelength) == (7, 3, 2, 8)
    assert (got.k_sca[2:5, 1] > got.k_sca[2:5, 0]).all()       # the cloud zone
    _same(got, ref, "atmosphere")


def _tables(atm, wl, **keys):
    """JAX float64 tables of wavelength ``wl`` and their port twins."""
    cfg = ArtesConfig()
    for k, v in keys.items():
        setattr(cfg, k, v)
    det = detector_setup(cfg, float(atm.rfront[-1]))
    static = _kernel_static(cfg, det, atm, False)
    jt = build_tables(atm, cfg, det, wl, dtype=jnp.float64).tables
    return jt, static, convert.tables_from_jax(jt, dtype=torch.float64), \
        convert.static_from_jax(static)


def test_mie_deck_plain_matches_jax_f64():
    atm, _ = cells.mie_patchy_deck(nr=4, deck=(1, 3), nzone=4)
    jt, static, tt, st = _tables(_jax_atmosphere(atm), 0, mode="imaging_mono", npix=25)
    assert tt.jump is not None and static.nx * static.ny == 625
    assert_matches_jax_3d(jt, static, tt, st, 256, seed=42)


@pytest.fixture(scope="module")
def small_gas_atmosphere(tmp_path_factory):
    """#3's chain cut to 6 levels (5 shells) and two wavelengths."""
    root = tmp_path_factory.mktemp("b3")
    d = write_gas_input(root, 6, (0.9, 0.905))
    assert t_cli.main(["build", "b3", "--root", str(root)]) == 0
    return t_atmosphere.load_artifact(d / "atmosphere.fits")


@pytest.mark.parametrize("wl", [0, 1])
def test_thermal_molecular_plain_matches_jax_f64(small_gas_atmosphere, wl):
    atm = small_gas_atmosphere
    assert (atm.nr, atm.n_wavelength) == (5, 2)
    jt, static, tt, st = _tables(_jax_atmosphere(atm), wl, mode="spectrum",
                                  photon_source="planet")
    assert static.photon_source == 2 and static.nx * static.ny == 1
    got = assert_matches_jax(jt, static, tt, st, 1024)
    assert float(got["flux_emitted"]) > 0.0


def test_oracle_matches_tool(small_gas_atmosphere):
    tool = _tool("baseline3_artifact")
    atm, distance = small_gas_atmosphere, ArtesConfig().distance_planet
    for wl in range(atm.n_wavelength):
        ref = tool.unscattered_oracle_flux(_jax_atmosphere(atm), wl, distance, n_mu=24, n_r=6)
        got = baselines.unscattered_oracle_flux(atm, wl, distance, n_mu=24, n_r=6)
        assert ref > 0.0 and got == pytest.approx(ref, rel=1e-12, abs=0.0)
        assert baselines.unscattered_oracle_flux(atm, wl, distance) > 0.0


def test_mie_deck_matches_tool():
    ref, ref_albedo = _tool("baseline4_artifact").build_atmosphere()
    got, albedo = cells.mie_patchy_deck()
    assert albedo == ref_albedo == baselines.BASELINE4["albedo"]
    _same(got, ref, "atmosphere")
    for name in ("k_ext", "albedo", "p_int"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name), err_msg=name)


@pytest.mark.parametrize("chain,photons", [(3, 256), (4, 4096)])
def test_chain_runs_on_the_cpu(chain, photons):
    env = one_thread_env(PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-m", "artes_tpu_torch.baselines", str(chain),
                           "--device", "cpu", "--photons", str(photons)],
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["ok"] and result["device"] == "cpu" and result["launches"] == {}
    if chain == 3:
        assert result["n_wavelength"] == 45 and len(result["rows"]) == 45
        assert result["n_error_total"] == 0
        assert all(r["within_rule"] and np.isfinite(r["detected_over_oracle"])
                   for r in result["rows"])
    else:
        assert result["n_matrices"] == 2 and result["grid"] == [39, 8, 8]
        assert 0 < result["image"]["lit_pixels"] <= 625
        assert 0.0 < result["image"]["max_minus_Q_over_I"] < 1.0
