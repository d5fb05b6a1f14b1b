"""The port stands alone: ``artes_tpu_torch`` and ``chip_smoke.py`` import
nothing of ``artes_tpu`` (whose ``__init__`` tries ``import jax``) and
nothing of ``jax``.

* A subprocess with a stub in ``sys.modules['artes_tpu']`` that raises on
  any use, and ``jax`` blocked, builds the README quick-start input and a
  3-D input and runs the port's CLI on both on the CPU.
* A source scan finds no such import under ``artes_tpu_torch/`` nor in
  ``chip_smoke.py``.
* Each host module the port copied (constants, config, atmosphere, presets,
  io.fitsio, opacity) gives what its original gives on the same inputs:
  equal ``ArtesConfig``, equal ``Atmosphere`` arrays, byte-equal FITS, equal
  opacity tables.
"""

import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

import artes_tpu.atmosphere as j_atmosphere
import artes_tpu.config as j_config
import artes_tpu.constants as j_constants
import artes_tpu.io.fitsio as j_fitsio
import artes_tpu.opacity as j_opacity
import artes_tpu.opacity.base as j_base
import artes_tpu.presets as j_presets
import artes_tpu_torch.atmosphere as t_atmosphere
import artes_tpu_torch.config as t_config
import artes_tpu_torch.constants as t_constants
import artes_tpu_torch.io.fitsio as t_fitsio
import artes_tpu_torch.opacity as t_opacity
import artes_tpu_torch.opacity.base as t_base
import artes_tpu_torch.presets as t_presets
from torch_threads import one_thread, one_thread_env  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_port_runs_with_artes_tpu_and_jax_blocked(tmp_path):
    script = f"""
import sys, types

class Blocked(types.ModuleType):
    def __getattr__(self, name):
        if name.startswith('__'):       # introspection (inspect walks sys.modules); a
            raise AttributeError(name)  # missing __path__ fails `import artes_tpu.x` too
        raise ImportError("artes_tpu is blocked: the port must not touch it (" + name + ")")

sys.modules['artes_tpu'] = Blocked('artes_tpu')
sys.modules['jax'] = None
try:
    import artes_tpu.config
except ImportError:
    pass
else:
    raise SystemExit("the stub does not block artes_tpu")
import numpy as np
from artes_tpu_torch import cells, cli
from artes_tpu_torch.transport import pool_cuda
root = {str(tmp_path)!r}
cells.write_input(root)
cells.write_artifact_input(root, 'patchy', cells.patchy3d_small())
assert cli.main(['demo', '1024', '-o', 'flat', '--device', 'cpu', '--root', root]) == 0
assert cli.main(['patchy', '512', '-o', 'deep', '--device', 'cpu', '--root', root]) == 0
assert sum(pool_cuda.LAUNCHES.values()) == 0
loaded = [m for m, v in sys.modules.items() if v is not None
          and (m == 'jax' or m.startswith('jax.') or m.startswith('artes_tpu.'))]
assert not loaded, loaded
print('ran alone')
"""
    env = one_thread_env(
        PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "ran alone" in proc.stdout
    for run in ("flat", "deep"):
        rows = np.loadtxt(tmp_path / "output" / run / "output" / "spectrum.dat", ndmin=2)
        assert rows.shape == (1, 5) and np.isfinite(rows).all() and rows[0, 1] > 0.0


def test_no_import_of_the_jax_package():
    pattern = re.compile(r"^\s*(?:import|from)\s+(?:artes_tpu|jax)(?:[.\s]|$)", re.MULTILINE)
    files = sorted((REPO / "artes_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    hits = [f"{f.relative_to(REPO)}: {m.group(0).strip()}"
            for f in files for m in pattern.finditer(f.read_text())]
    assert not hits, hits


def _same(a, b, what):
    """Equal values of any nesting: dataclasses, dicts, sequences, arrays."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, what
        names = [f.name for f in dataclasses.fields(a)]
        assert names == [f.name for f in dataclasses.fields(b)], what
        for n in names:
            _same(getattr(a, n), getattr(b, n), f"{what}.{n}")
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        for k in a:
            _same(a[k], b[k], f"{what}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b or (a != a and b != b), what


def _check_constants(tmp_path):
    names = [n for n in vars(j_constants) if n.isupper()]
    assert len(names) >= 8
    assert names == [n for n in vars(t_constants) if n.isupper()]
    for n in names:
        assert getattr(t_constants, n) == getattr(j_constants, n), n
    temps, wl = np.array([300.0, 900.0, 5800.0]), np.array([0.5e-6, 3.0e-6, 10.0e-6])
    _same(t_constants.planck_lambda(temps, wl), j_constants.planck_lambda(temps, wl), "planck")


ARTES_IN = """photon:source=planet
photon:fstop=0.2
photon:emission=biased
photon:bias=0.6
detector:type=imaging_mono
detector:theta=70
detector:phi=35
detector:pixel=15
planet:oblateness=0.1
planet:surface_albedo=0.3
star:theta=40
star:phi=10
output:flow_global=on
"""


def _check_config(tmp_path):
    path = tmp_path / "artes.in"
    path.write_text(ARTES_IN)
    overrides = ["photon:fstop=0.05", "detector:distance=12"]
    ref, got = j_config.load_config(path, overrides), t_config.load_config(path, overrides)
    _same(got, ref, "ArtesConfig")
    assert got.fstop == 0.05 and got.mode == "imaging_mono"
    assert t_config.snapshot(got) == j_config.snapshot(ref)
    _same(t_config.detector_setup(got, 7.1e7), j_config.detector_setup(ref, 7.1e7), "detector")
    _same(t_config.detector_setup(got, 7.1e7, det_phi=1.0),
          j_config.detector_setup(ref, 7.1e7, det_phi=1.0), "detector at phi")
    with pytest.raises(j_config.ConfigError):
        j_config.load_config(path, ["nonsense:key=1"])
    with pytest.raises(t_config.ConfigError):
        t_config.load_config(path, ["nonsense:key=1"])


ATMOSPHERE_IN = """[grid]
radius: 1.
radial: 30, 60, 100
theta: 60, 90, 120
phi: 90, 180, 270

[composition]
gas: off
fits01: rayleigh.fits
fits02: haze.fits
opacity01: 1, 5e-4, 0, nr, 0, ntheta, 0, nphi
opacity02: 2, 2e-3, 1, 3, 1, 3, 0, 2
"""


def _check_atmosphere(tmp_path):
    built = {}
    for tag, atm_mod, opac, base in (("ref", j_atmosphere, j_opacity, j_base),
                                     ("got", t_atmosphere, t_opacity, t_base)):
        d = tmp_path / tag
        (d / "opacity").mkdir(parents=True)
        base.write_opacity_fits(d / "opacity" / "rayleigh.fits",
                                opac.rayleigh.generate([0.6, 0.9]))
        base.write_opacity_fits(d / "opacity" / "haze.fits", opac.henyey_greenstein.generate(
            [0.6, 0.9], absorption=0.1, scattering=1.0, g1=0.6, p_linear=0.4))
        (d / "atmosphere.in").write_text(ATMOSPHERE_IN)
        built[tag] = (atm_mod.build_and_write(str(d)), atm_mod.load_artifact(
            str(d / "atmosphere.fits")))
    for which in (0, 1):
        ref, got = built["ref"][which], built["got"][which]
        assert (got.nr, got.ntheta, got.nphi, got.n_wavelength) == (3, 4, 4, 2)
        _same(vars(got), vars(ref), "Atmosphere")
        _same(got.cell_volume(1.2, 1.2, 1.0), ref.cell_volume(1.2, 1.2, 1.0), "volume")
        _same(got.column_optical_depth(1, "sca"), ref.column_optical_depth(1, "sca"), "tau")
    assert (tmp_path / "got" / "atmosphere.fits").read_bytes() == \
        (tmp_path / "ref" / "atmosphere.fits").read_bytes()
    _same(t_atmosphere.SINBETA, j_atmosphere.SINBETA, "SINBETA")


def _check_presets(tmp_path):
    calls = [("rayleigh_single_layer", dict(tau=2.0, nr=3, theta_deg=(0.0, 90.0, 180.0))),
             ("hg_cloud_deck", {}), ("thermal_shell", dict(tau_abs=0.8, nr=4)),
             ("patchy_3d", dict(tau_clear=0.5, tau_cloud=6.0))]
    for name, kw in calls:
        _same(vars(getattr(t_presets, name)(**kw)), vars(getattr(j_presets, name)(**kw)), name)


def _check_fitsio(tmp_path):
    rs = np.random.default_rng(4)
    hdus = [(None, rs.normal(size=(3, 4)).astype(np.float64)),
            ("GRID", rs.normal(size=(2, 3, 5)).astype(np.float32)),
            ("COUNTS", rs.integers(-9, 9, (7,)).astype(np.int32)),
            ("ONE", np.array([1.5]))]
    j_fitsio.write_fits(tmp_path / "ref.fits", hdus)
    t_fitsio.write_fits(tmp_path / "got.fits", hdus)
    assert (tmp_path / "got.fits").read_bytes() == (tmp_path / "ref.fits").read_bytes()
    ref, got = j_fitsio.read_fits(tmp_path / "ref.fits"), t_fitsio.read_fits(tmp_path / "ref.fits")
    assert len(got) == len(ref) == 4
    for (name_g, data_g), (name_r, data_r), (name, data) in zip(got, ref, hdus):
        assert name_g == name_r == name
        _same(data_g, data_r, "data")
        np.testing.assert_array_equal(data_g, data)
    _same(t_fitsio.read_fits_map(tmp_path / "ref.fits"),
          j_fitsio.read_fits_map(tmp_path / "ref.fits"), "map")


def _check_opacity(tmp_path):
    wl = [0.5, 0.7, 1.1]
    tables = [("rayleigh", (wl,), {}), ("isotropic", (wl,), dict(absorption=0.3, scattering=0.7)),
              ("henyey_greenstein", (wl,), dict(absorption=0.05, scattering=1.0, g1=0.8,
                                                p_linear=0.5))]
    for name, args, kw in tables:
        ref = getattr(j_opacity, name).generate(*args, **kw)
        got = getattr(t_opacity, name).generate(*args, **kw)
        _same(got, ref, name)
        _same(got.opacity_block, ref.opacity_block, name + " block")
        j_base.write_opacity_fits(tmp_path / "ref.fits", ref)
        t_base.write_opacity_fits(tmp_path / "got.fits", got)
        assert (tmp_path / "got.fits").read_bytes() == (tmp_path / "ref.fits").read_bytes(), name
        _same(t_base.read_opacity_fits(tmp_path / "ref.fits"),
              j_base.read_opacity_fits(tmp_path / "ref.fits"), name + " read back")
    six = np.random.default_rng(1).normal(size=(180, 6, 2))
    _same(t_base.expand_6_to_16(six), j_base.expand_6_to_16(six), "6 to 16")
    _same(t_base.make_wavelength_grid(0.5, 2.0, 0.1), j_base.make_wavelength_grid(0.5, 2.0, 0.1),
          "wavelength grid")


CHECKS = {"constants": _check_constants, "config": _check_config,
          "atmosphere": _check_atmosphere, "presets": _check_presets,
          "io.fitsio": _check_fitsio, "opacity": _check_opacity}


@pytest.mark.parametrize("module", sorted(CHECKS))
def test_host_module_copy_matches_original(module, tmp_path):
    CHECKS[module](tmp_path)
