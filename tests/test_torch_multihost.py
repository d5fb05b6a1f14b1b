"""Processes of a launcher (``artes_tpu_torch.parallel.multihost``) and the
CLI's ``--mesh`` and ``--resume``, on the CPU.

* Two gloo processes own the wavelengths of a spectrum block-cyclically
  (the counterpart of tests/test_multihost.py, at 400 photons): the merged
  rows equal the port's one-process ``run_spectrum`` at rtol 1e-12 and the
  JAX package's at rtol 1e-10.
* ``python -m artes_tpu_torch.cli ... --mesh --device cpu --f64`` in two
  processes with a launcher's environment, on a two-wavelength quick-start
  input: ``spectrum.dat`` equals the ``artes_tpu`` CLI's ``--f64 --mesh``
  at rtol 1e-10 and every other file is byte-equal; rank 1 wrote nothing.
  Then ``--resume`` over the mesh on a ``spectrum.dat`` cut to its first
  row, and once more with nothing left to do, against the ``artes_tpu``
  CLI's ``--resume`` on the same cut.
* Without a launcher ``initialize()`` does nothing, ``--mesh --device cpu``
  raises and names ``torchrun``, and ``--mesh`` without a card raises.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from artes_tpu_torch import cells, cli, presets, runner
from artes_tpu_torch.config import ArtesConfig
from artes_tpu_torch.parallel import multihost
from test_torch_mesh import run_ranks
from torch_threads import one_thread  # noqa: F401

WAVELENGTHS = (0.5, 0.6, 0.7, 0.8)

WORKER_SPECTRUM = r"""
import json, sys
import torch
torch.set_num_threads(1)
from artes_tpu_torch import presets, runner
from artes_tpu_torch.config import ArtesConfig
from artes_tpu_torch.parallel import multihost

assert multihost.initialize("gloo", timeout_s=120)
rank = torch.distributed.get_rank()
atm = presets.rayleigh_single_layer(tau=2.0, wavelengths=(0.5, 0.6, 0.7, 0.8))
cfg = ArtesConfig()
cfg.mode = "spectrum"
wls = multihost.my_wavelength_indices(atm.n_wavelength)
_, results = runner.run_spectrum(atm, cfg, 400, seed=5, wl_subset=wls, dtype=torch.float64,
                                 device="cpu")
rows = {wl: [float(res.detector[..., k, 0].sum()) for k in range(4)]
        + [float(res.detector[..., k, 2].sum()) for k in range(4)]
        for wl, res in zip(wls, results)}
with open(sys.argv[1] + f".rank{rank}", "w") as fh:
    json.dump({"coordinator": multihost.is_coordinator(), "wls": wls,
               "rows": {str(k): v for k, v in rows.items()}}, fh)
torch.distributed.destroy_process_group()
"""


def test_two_processes_own_wavelengths(tmp_path):
    import json

    import jax.numpy as jnp
    from artes_tpu import runner as jax_runner
    from artes_tpu.config import ArtesConfig as JaxConfig

    run_ranks(tmp_path, 2, ["-c", WORKER_SPECTRUM, str(tmp_path / "rows")])
    merged = {}
    for rank in range(2):
        data = json.loads((tmp_path / f"rows.rank{rank}").read_text())
        assert data["coordinator"] == (rank == 0)
        assert data["wls"] == list(range(rank, 4, 2))
        merged.update({int(k): v for k, v in data["rows"].items()})
    assert sorted(merged) == [0, 1, 2, 3]

    torch.set_num_threads(1)
    atm = presets.rayleigh_single_layer(tau=2.0, wavelengths=WAVELENGTHS)
    cfg = ArtesConfig()
    cfg.mode = "spectrum"
    _, mine = runner.run_spectrum(atm, cfg, 400, seed=5, dtype=torch.float64, device="cpu")
    jcfg = JaxConfig()
    jcfg.mode = "spectrum"
    _, ref = jax_runner.run_spectrum(atm, jcfg, 400, seed=5, dtype=jnp.float64)
    for wl in range(4):
        for res, rtol in ((mine[wl], 1e-12), (ref[wl], 1e-10)):
            expect = ([float(res.detector[..., k, 0].sum()) for k in range(4)]
                      + [float(res.detector[..., k, 2].sum()) for k in range(4)])
            np.testing.assert_array_equal(merged[wl][4:], expect[4:])
            np.testing.assert_allclose(merged[wl][:4], expect[:4], rtol=rtol, atol=0.0,
                                       err_msg=f"wavelength {wl}")


WORKER_RESUME = r"""
import sys
import torch.distributed as dist
from artes_tpu_torch import cli
from artes_tpu_torch.parallel import multihost

assert multihost.initialize("gloo", timeout_s=120)
args = ["demo", "4096", "-o", "mesh", "--f64", "--device", "cpu", "--mesh", "--resume",
        "--root", sys.argv[1]]
assert cli.main(args) == 0
dist.barrier()
print("second resume", file=sys.stderr, flush=True)
assert cli.main(args) == 0
assert dist.is_initialized()         # the CLI leaves a group it did not start
dist.destroy_process_group()
"""


def _cut_to_first_row(run_dir):
    path = run_dir / "output" / "spectrum.dat"
    lines = path.read_text().splitlines(keepends=True)
    rows = [i for i, line in enumerate(lines) if line.strip() and not line.startswith("#")]
    assert len(rows) == 2
    path.write_text("".join(lines[:rows[1]]))


def _assert_same_tree(got, ref):
    got, ref = got / "output", ref / "output"
    assert sorted(os.listdir(got)) == sorted(os.listdir(ref))
    for name in os.listdir(ref):
        if name == "spectrum.dat":
            a = np.loadtxt(got / name, comments="#", ndmin=2)
            b = np.loadtxt(ref / name, comments="#", ndmin=2)
            assert a.shape == b.shape == (2, 5)
            np.testing.assert_allclose(a, b, rtol=1e-10, atol=0.0)
        else:
            assert (got / name).read_bytes() == (ref / name).read_bytes(), name


def test_cli_mesh_and_resume_match_jax_cli(tmp_path, capsys):
    from artes_tpu import cli as jax_cli

    cells.write_input(tmp_path, "demo", wavelengths=(0.7, 0.9))
    root = str(tmp_path)
    logs = run_ranks(tmp_path, 2, ["-m", "artes_tpu_torch.cli", "demo", "4096", "-o", "mesh",
                                   "--f64", "--device", "cpu", "--mesh", "--root", root])
    assert "Wavelength:   0.900 micron" in logs[0] and "ARTES-TPU" in logs[0]
    assert "Wavelength" not in logs[1] and "ARTES-TPU" not in logs[1]
    assert "CUDA kernel launches" not in logs[0]
    assert jax_cli.main(["demo", "4096", "-o", "ref", "--f64", "--mesh", "--root", root]) == 0
    got, ref = tmp_path / "output" / "mesh", tmp_path / "output" / "ref"
    _assert_same_tree(got, ref)
    assert (got / "plot.dat").read_bytes() == (ref / "plot.dat").read_bytes()
    assert sorted(os.listdir(got / "input")) == sorted(os.listdir(ref / "input"))

    # --resume: the second wavelength is run again, then nothing is left
    for run in (got, ref):
        _cut_to_first_row(run)
    logs = run_ranks(tmp_path, 2, ["-c", WORKER_RESUME, root])
    first, second = logs[0].split("second resume")
    assert "resume: skipping 1 completed wavelengths" in first
    assert "Wavelength:   0.900 micron" in first and "0.700 micron" not in first
    assert "resume: nothing to do" in second and "Wavelength" not in second
    assert "resume:" not in logs[1] and "Wavelength" not in logs[1]
    capsys.readouterr()
    args = ["demo", "4096", "-o", "ref", "--f64", "--mesh", "--resume", "--root", root]
    assert jax_cli.main(args) == 0
    assert "resume: skipping 1 completed wavelengths" in capsys.readouterr().err
    assert jax_cli.main(args) == 0
    assert "resume: nothing to do" in capsys.readouterr().err
    _assert_same_tree(got, ref)


def test_resume_one_process_matches_jax_cli(tmp_path, capsys):
    """``--resume`` without a mesh: stage 2 of the report only when the first
    wavelength is run again."""
    from artes_tpu import cli as jax_cli

    cells.write_input(tmp_path, "demo", wavelengths=(0.7, 0.9))
    root = str(tmp_path)
    mine = ["demo", "4096", "-o", "mine", "--f64", "--device", "cpu", "--root", root]
    theirs = ["demo", "4096", "-o", "ref", "--f64", "--root", root]
    assert cli.main(mine) == 0 and jax_cli.main(theirs) == 0
    got, ref = tmp_path / "output" / "mine", tmp_path / "output" / "ref"
    for run in (got, ref):
        path = run / "output" / "spectrum.dat"
        lines = path.read_text().splitlines(keepends=True)
        path.write_text("".join(lines[:2] + lines[3:]))      # drop the first wavelength
    capsys.readouterr()
    assert cli.main(mine + ["--resume"]) == 0
    out = capsys.readouterr()
    assert "resume: skipping 1 completed wavelengths" in out.err
    assert "Photon transfer" in out.out
    assert jax_cli.main(theirs + ["--resume"]) == 0
    a = np.loadtxt(got / "output" / "spectrum.dat", comments="#", ndmin=2)
    b = np.loadtxt(ref / "output" / "spectrum.dat", comments="#", ndmin=2)
    np.testing.assert_allclose(a, b, rtol=1e-10, atol=0.0)
    np.testing.assert_allclose(a[:, 0], [0.9, 0.7], rtol=1e-12)
    for name in os.listdir(ref / "output"):
        if name != "spectrum.dat":
            assert (got / "output" / name).read_bytes() == (ref / "output" / name).read_bytes()


def test_no_launcher(tmp_path, monkeypatch):
    for key in multihost.LAUNCHER_ENV:
        monkeypatch.delenv(key, raising=False)
    assert not multihost.launched()
    assert multihost.initialize() is False
    assert not torch.distributed.is_initialized()
    assert multihost.my_wavelength_indices(5) == [0, 1, 2, 3, 4]
    assert multihost.is_coordinator()
    from artes_tpu_torch.parallel import make_mesh
    with pytest.raises(RuntimeError, match="initialised"):
        make_mesh("cpu")
    cells.write_input(tmp_path, "demo")
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node"):
        cli.main(["demo", "256", "-o", "m", "--device", "cpu", "--mesh", "--root", str(tmp_path)])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["demo", "256", "-o", "m", "--mesh", "--root", str(tmp_path)])
    assert not (tmp_path / "output").exists()
    # a launcher's environment does not bring NCCL up without a card
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29999")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.initialize("nccl")
    assert not torch.distributed.is_initialized()
