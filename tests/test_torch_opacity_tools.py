"""The port's opacity tooling and native loaders against the JAX package's,
on the CPU.

* :data:`CHECKS`, one case each of ``opacity.ptprofile`` (both profiles
  equal, the written files byte-equal), ``opacity.gas`` (the same table from
  a numpy-seeded absorption file), ``opacity.molecules`` (the same layers
  from ``baselines.write_molecule_dir`` and from the 2 x 2 grid of
  tests/test_mie_molecules.py, ``gas_opacity_NN.fits`` byte-equal) and
  ``opacity.mie`` (the port's ``computepart``, built by ``_build`` under
  ``build/``, gives arrays bit-equal to the original solver's; BASELINE #4's
  cloud albedo);
* the port's solver in the Rayleigh limit and its normalised table (the
  tests of tests/test_mie_molecules.py:20-48);
* ``io.fitsio.read_fits_native`` equal to the original's and to the
  pure-Python reader on every BITPIX; a read error raises;
* a ``_build`` host build of a broken copy of ``mie.cc`` raises with g++'s
  output, and a solver run that fails raises.
"""

import os
import shutil

import numpy as np
import pytest

import artes_tpu.io.fitsio as j_fitsio
from artes_tpu.opacity import gas as j_gas
from artes_tpu.opacity import mie as j_mie
from artes_tpu.opacity import molecules as j_molecules
from artes_tpu.opacity import ptprofile as j_ptprofile
import artes_tpu_torch.io.fitsio as t_fitsio
from artes_tpu_torch import _build, baselines, cells
from artes_tpu_torch.opacity import gas as t_gas
from artes_tpu_torch.opacity import mie as t_mie
from artes_tpu_torch.opacity import molecules as t_molecules
from artes_tpu_torch.opacity import ptprofile as t_ptprofile
from artes_tpu_torch.opacity.base import p11_norm
from test_mie_molecules import make_molecule_dir
from test_torch_standalone import _same
from torch_threads import one_thread  # noqa: F401


@pytest.fixture(scope="module")
def ri_file(tmp_path_factory):
    """The constant refractive index 1.5 + 0.01i of tests/test_mie_molecules.py."""
    path = tmp_path_factory.mktemp("ri") / "const.dat"
    with open(path, "w") as fh:
        fh.write("# wavelength n k\n")
        for wl in (0.1, 1.0, 10.0, 1000.0):
            fh.write(f"{wl} 1.5 0.01\n")
    return path


def _check_ptprofile(tmp_path):
    for kw in ({}, dict(t_iso=1200.0, p_min=1e-4, p_max=10.0, levels=25)):
        _same(t_ptprofile.isothermal(**kw), j_ptprofile.isothermal(**kw), f"isothermal {kw}")
    for kw in ({}, dict(t_eff=900.0, kappa=1e-2, log_g=3.4, levels=40)):
        got, ref = t_ptprofile.self_luminous(**kw), j_ptprofile.self_luminous(**kw)
        _same(got, ref, f"self_luminous {kw}")
        t_ptprofile.write_profile(tmp_path / "got.dat", *got)
        j_ptprofile.write_profile(tmp_path / "ref.dat", *ref)
        assert (tmp_path / "got.dat").read_bytes() == (tmp_path / "ref.dat").read_bytes()
        _same(t_ptprofile.read_profile(tmp_path / "ref.dat"),
              j_ptprofile.read_profile(tmp_path / "ref.dat"), "read back")


def _check_gas(tmp_path):
    rs = np.random.default_rng(5)
    w = np.sort(rs.uniform(0.5, 2.5, 80))
    np.savetxt(tmp_path / "absorption.dat", np.column_stack([w, 10.0 ** rs.uniform(-24, -20, 80)]))
    for kw in (dict(wl_min=0.8, wl_max=2.0), dict(wl_min=0.8, wl_max=2.0, step=0.1),
               dict(wl_min=0.6, wl_max=1.5, vmr=1e-2, depolarization=0.0)):
        got = t_gas.generate(tmp_path / "absorption.dat", **kw)
        ref = j_gas.generate(tmp_path / "absorption.dat", **kw)
        assert len(got.wavelength) > 3
        _same(got, ref, f"gas {kw}")
        _same(t_gas.rayleigh_cross_section_gas(got.wavelength, 0.02),
              j_gas.rayleigh_cross_section_gas(got.wavelength, 0.02), "cross-section")


def _check_molecules(tmp_path):
    small = make_molecule_dir(tmp_path)
    synthetic = baselines.write_molecule_dir(tmp_path / "synthetic")
    for d in (small, synthetic):
        t_grid, j_grid = t_molecules.PTGrid(d), j_molecules.PTGrid(d)
        for p, t in ((1.0, 141.4213562), (10.0, 200.0), (0.05, 150.0), (1e-3, 758.0),
                     (3.7, 1900.0), (99.0, 3744.0)):
            assert t_grid.corner_indices(p, t) == j_grid.corner_indices(p, t)
            _same(t_grid.interpolate(p, t), j_grid.interpolate(p, t), f"interpolate {p} {t}")
    pressure, temperature = t_ptprofile.self_luminous(t_eff=900.0, levels=6)
    for d, wl_range in ((small, (0.6, 1.8)), (synthetic, (0.9, 1.4))):
        _same(t_molecules.layer_table(t_molecules.PTGrid(d), 0.3, 1100.0, *wl_range),
              j_molecules.layer_table(j_molecules.PTGrid(d), 0.3, 1100.0, *wl_range), "layer")
        got = t_molecules.generate_layers(d, pressure[:-1], temperature[:-1], *wl_range,
                                          tmp_path / "got")
        ref = j_molecules.generate_layers(d, pressure[:-1], temperature[:-1], *wl_range,
                                          tmp_path / "ref")
        assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in ref] == \
            [f"gas_opacity_{i:02d}.fits" for i in range(5, 0, -1)]
        for g, r in zip(got, ref):
            assert open(g, "rb").read() == open(r, "rb").read(), g
    # the synthetic set: 45 wavelengths in BASELINE #3's range, as its record has
    tab = t_molecules.layer_table(t_molecules.PTGrid(synthetic), 1.0, 1500.0, 0.9, 1.4)
    assert len(tab.wavelength) == 45 and tab.wavelength[0] == 0.9 and tab.wavelength[-2] <= 1.4


def _check_mie(tmp_path):
    ri4 = tmp_path / "cloud.dat"
    cells.write_refractive_index(ri4)
    ri = tmp_path / "const.dat"
    ri.write_text("".join(f"{wl} 1.5 0.01\n" for wl in (0.1, 1.0, 10.0, 1000.0)))
    cases = [(ri4, [0.7], dict(nr=30, nf=5, amin=0.1, amax=5.0, apow=3.5, fmax=0.0)),
             (ri, [1.0, 2.0], dict(nr=10, nf=3, amin=0.5, amax=2.0, apow=3.5, fmax=0.3)),
             (ri, [0.5, 3.0], dict(nr=20, nf=1, r_eff=1.0, v_eff=0.1))]
    for path, wl, kw in cases:
        got, ref = t_mie.compute_particle(path, wl, **kw), j_mie.compute_particle(path, wl, **kw)
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype and g.shape == r.shape
            np.testing.assert_array_equal(g, r)
        _same(t_mie.generate(path, wl, **kw), j_mie.generate(path, wl, **kw), f"mie {kw}")
    assert t_mie.solver_path().startswith(_build.BUILD_DIR)
    tab = t_mie.generate(*cases[0][:2], **cases[0][2])
    assert float(tab.scattering[0] / tab.extinction[0]) == baselines.BASELINE4["albedo"]


CHECKS = {"opacity.ptprofile": _check_ptprofile, "opacity.gas": _check_gas,
          "opacity.molecules": _check_molecules, "opacity.mie": _check_mie}


@pytest.mark.parametrize("module", sorted(CHECKS))
def test_opacity_tool_copy_matches_original(module, tmp_path):
    CHECKS[module](tmp_path)


def test_mie_rayleigh_limit(ri_file):
    """x << 1: kappa_sca follows the analytic Rayleigh cross-section."""
    a, wl = 0.01, 10.0
    opacity, scatter6 = t_mie.compute_particle(ri_file, [wl], nr=1, nf=1, amin=a, amax=a,
                                               apow=0.0, fmax=0.0)
    x = 2 * np.pi * a / wl
    m = 1.5 + 0.01j
    qsca = (8 / 3) * x**4 * abs((m * m - 1) / (m * m + 2)) ** 2
    csca = qsca * np.pi * a**2 * 1e-8
    mass = (4 / 3) * np.pi * (a * 1e-4) ** 3
    assert opacity[3, 0] == pytest.approx(csca / mass, rel=1e-3)
    f11 = scatter6[:, 0, 0]
    assert f11[0] / f11[90] == pytest.approx(2.0, rel=0.05)


def test_mie_table_is_normalised(ri_file):
    tab = t_mie.generate(ri_file, [1.0, 2.0], nr=10, nf=3, amin=0.5, amax=2.0, apow=3.5,
                         fmax=0.3)
    assert tab.scatter.shape == (180, 16, 2)
    np.testing.assert_allclose(p11_norm(tab.scatter), 1.0, rtol=1e-10)
    assert (tab.extinction >= tab.scattering - 1e-12).all()
    assert (tab.absorption > 0).all()
    assert np.all(np.abs(tab.scatter[:, 1, :]) <= tab.scatter[:, 0, :] + 1e-12)


def test_read_fits_native_every_bitpix(tmp_path):
    rs = np.random.default_rng(6)
    hdus = [("BYTES", rs.integers(0, 255, (3, 4)).astype(np.uint8)),
            (None, None),
            ("SHORT", rs.integers(-2000, 2000, (2, 3, 5)).astype(np.int16)),
            ("INT", rs.integers(-2**30, 2**30, (7,)).astype(np.int32)),
            ("LONG", rs.integers(-2**52, 2**52, (4, 2)).astype(np.int64)),
            ("FLOAT", rs.normal(size=(5, 3)).astype(np.float32)),
            ("DOUBLE", rs.normal(size=(2, 2, 2, 3)))]
    t_fitsio.write_fits(tmp_path / "all.fits", hdus)
    got = t_fitsio.read_fits_native(tmp_path / "all.fits")
    ref = j_fitsio.read_fits_native(tmp_path / "all.fits")
    pure = t_fitsio.read_fits(tmp_path / "all.fits")
    assert len(got) == len(ref) == len(pure) == len(hdus)
    for (name, data), (name_r, data_r), (name_p, data_p), (name_w, data_w) in zip(
            got, ref, pure, hdus):
        assert name == name_r == name_p == name_w
        if data_w is None:
            assert data is None and data_r is None and data_p is None
            continue
        _same(data, data_r, name)
        assert data.dtype == np.float64 and data.shape == data_p.shape == data_w.shape
        np.testing.assert_array_equal(data, data_p.astype(np.float64))


def test_read_fits_native_raises(tmp_path):
    with pytest.raises(OSError, match="cannot open"):
        t_fitsio.read_fits_native(tmp_path / "missing.fits")
    t_fitsio.write_fits(tmp_path / "a.fits", [("A", np.arange(4000.0))])
    (tmp_path / "cut.fits").write_bytes((tmp_path / "a.fits").read_bytes()[:2880 + 8000])
    with pytest.raises(OSError, match="truncated data"):
        t_fitsio.read_fits_native(tmp_path / "cut.fits")


def test_broken_host_build_raises(tmp_path, monkeypatch):
    native = tmp_path / "native"
    shutil.copytree(_build.NATIVE_DIR, native)
    src = native / "mie" / "mie.cc"
    src.write_text(src.read_text().replace("int main(", "int main(undeclared_type x, ", 1))
    monkeypatch.setattr(_build, "NATIVE_DIR", str(native))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        _build.build_host("computepart")
    assert "mie.cc" in str(err.value) and "undeclared_type" in str(err.value)
    assert not list((tmp_path / "build").iterdir())


def test_failed_solver_run_raises(tmp_path):
    with pytest.raises(RuntimeError, match="computepart failed"):
        t_mie.compute_particle(tmp_path / "no_such_index.dat", [1.0], nr=2, nf=1)
