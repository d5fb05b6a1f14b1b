"""The port's spectrum path end to end against the JAX package.

* ``artes_tpu_torch.runner.run_spectrum`` at float64 on the CPU against
  ``artes_tpu.runner.run_spectrum`` (the XLA kernel) on a two-wavelength
  Rayleigh atmosphere: detector at rtol 1e-10, counts equal.
* ``python -m artes_tpu_torch.cli`` against ``artes_tpu.cli`` at ``--f64``
  on the README quick-start input: ``spectrum.dat`` rows at rtol 1e-10, the
  other per-wavelength tables identical.
* The port imports and runs a spectrum with jax blocked.
* ``--device cuda`` without a card raises; nothing falls back to the CPU.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artes_tpu import cli as jax_cli
from artes_tpu import output as jax_out
from artes_tpu import runner as jax_runner
from artes_tpu.atmosphere import load_artifact
from artes_tpu.config import ArtesConfig
from artes_tpu_torch import cells, cli, output, runner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def quickstart(tmp_path):
    """The README quick-start input: one 100 km Rayleigh layer at 0.7 micron."""
    cells.write_input(tmp_path)
    return tmp_path


def test_run_spectrum_matches_jax_f64(tmp_path):
    d = cells.write_input(tmp_path, "two", [0.6, 0.8], "50, 100",
                          "opacity01: 1, 2e-3, 0, 2, 0, ntheta, 0, nphi", fstop=0.1)
    atm = load_artifact(d / "atmosphere.fits")
    cfg = ArtesConfig()
    cfg.mode = "spectrum"
    cfg.fstop = 0.1
    n = 2048
    _, ref = jax_runner.run_spectrum(atm, cfg, n, seed=3, dtype=jnp.float64)
    _, got = runner.run_spectrum(atm, cfg, n, seed=3, dtype=torch.float64, device="cpu")
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.detector[..., 2], r.detector[..., 2])
        np.testing.assert_allclose(g.detector[..., :2], r.detector[..., :2],
                                   rtol=1e-10, atol=0.0)
        np.testing.assert_allclose(g.photometry, r.photometry, rtol=1e-10, atol=1e-300)
        assert g.cell_depth == r.cell_depth
        assert g.n_alive_at_cap == r.n_alive_at_cap
        assert g.n_error == r.n_error == 0


def _table(path):
    return np.loadtxt(path, comments="#", ndmin=2)


def test_cli_spectrum_matches_jax_cli_f64(quickstart):
    root = str(quickstart)
    assert jax_cli.main(["demo", "4096", "-o", "ref", "--f64", "--root", root]) == 0
    assert cli.main(["demo", "4096", "-o", "r", "--f64", "--device", "cpu",
                     "--root", root]) == 0
    ref = quickstart / "output" / "ref" / "output"
    got = quickstart / "output" / "r" / "output"
    assert sorted(os.listdir(got)) == sorted(os.listdir(ref))
    spec_g, spec_r = _table(got / "spectrum.dat"), _table(ref / "spectrum.dat")
    assert spec_g.shape == spec_r.shape == (1, 5)
    assert spec_g[0, 1] > 0.0
    np.testing.assert_allclose(spec_g, spec_r, rtol=1e-10, atol=0.0)
    for name in os.listdir(ref):
        if name != "spectrum.dat":
            assert (got / name).read_text() == (ref / name).read_text(), name
    run = quickstart / "output" / "r"
    for name in ("artes.in", "atmosphere.fits", "artes.in.effective"):
        assert (run / "input" / name).is_file(), name
    assert (run / "plot.dat").read_text() == (quickstart / "output" / "ref" / "plot.dat").read_text()


def test_port_runs_with_jax_blocked(quickstart):
    script = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "from artes_tpu_torch import cli\n"
        "from artes_tpu_torch.transport import pool_cuda\n"
        f"rc = cli.main(['demo', '1024', '-o', 'nojax', '--device', 'cpu', '--root', {str(quickstart)!r}])\n"
        "assert rc == 0 and sum(pool_cuda.LAUNCHES.values()) == 0\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m, v in sys.modules.items()\n"
        "               if v is not None)\n"
        "print('ran without jax')\n")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(quickstart), env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "ran without jax" in proc.stdout
    rows = _table(quickstart / "output" / "nojax" / "output" / "spectrum.dat")
    assert rows.shape == (1, 5) and np.isfinite(rows).all() and rows[0, 1] > 0.0


def test_device_cuda_without_card_raises(quickstart, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["demo", "1024", "-o", "c", "--root", str(quickstart)])
    assert not (quickstart / "output" / "c").exists()


def test_unported_modes_raise(quickstart):
    """A Lambert surface and flow diagnostics run through the CLI on radial
    and 3-D grids alike, and the flow outputs leave their files; ``--f64``
    runs on the card, and without one it raises instead of running on the
    CPU."""
    from artes_tpu import presets
    from artes_tpu_torch.io.fitsio import read_fits
    cells.write_artifact_input(quickstart, "patchy", presets.patchy_3d())
    runs = {"surface": (["demo", "-k", "planet:surface_albedo=0.5"], ()),
            "3-D surface": (["patchy", "-k", "planet:surface_albedo=0.5"], ()),
            "flow": (["demo", "-k", "output:flow_global=on"], ("flow_global.fits",)),
            "3-D flow": (["patchy", "-k", "output:flow_global=on", "-k",
                          "output:flow_latitudinal=on"],
                         ("flow_global.fits", "flow_latitudinal.fits"))}
    for what, (args, files) in runs.items():
        run = what.replace(" ", "_")
        assert cli.main([args[0], "1024", "-o", run, "--device", "cpu", "--root",
                         str(quickstart), *args[1:]]) == 0, what
        out = quickstart / "output" / run / "output"
        rows = _table(out / "spectrum.dat")
        assert np.isfinite(rows).all() and rows[0, 1] > 0.0, what
        assert sorted(f for f in os.listdir(out) if f.startswith("flow")) == sorted(files)
        for name in files:
            plane = read_fits(out / name)[0][1]
            assert np.isfinite(plane).all() and np.abs(plane).max() > 0.0, (what, name)
    if not torch.cuda.is_available():
        # --f64 runs on the card by default; with no card it raises rather
        # than fall back to the CPU (where a card is present it runs there)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["demo", "1024", "-o", "m", "--f64", "--root", str(quickstart)])


def test_error_log_matches_jax(tmp_path):
    rs = np.random.default_rng(2)
    records = rs.normal(size=(3, 16))
    records[:, [0, 1, 8, 9, 10, 11, 12, 14]] = rs.integers(0, 500, (3, 8))
    records[:, 15] = [0, 3, 9]                          # known sites and an unknown one
    entries = [("031/geometry no-candidate", 2), ("05x/peel walk", 0), ("050/stokes anomaly", 1)]
    ref = jax_out.write_error_log(jax_out.OutputDirs(tmp_path, "ref"), entries, records)
    got = output.write_error_log(output.OutputDirs(tmp_path, "got"), entries, records)
    assert open(got).read() == open(ref).read()


def test_photometry_and_errors_match_jax():
    rs = np.random.default_rng(8)
    det = np.zeros((3, 2, 4, 3))
    det[..., 2] = rs.integers(0, 50, (3, 2, 1))
    det[..., 0] = rs.normal(size=(3, 2, 4)) * det[..., 2]
    det[..., 1] = det[..., 0] ** 2 / np.maximum(det[..., 2], 1) + rs.uniform(0, 5, (3, 2, 4))
    det[0, 0] = 0.0                                     # an empty pixel
    np.testing.assert_array_equal(runner.detector_errors(det), jax_runner.detector_errors(det))
    np.testing.assert_array_equal(runner.photometry_from_detector(det),
                                  jax_runner.photometry_from_detector(det))
