"""The inputs that both sides take: the run's configuration and views from a
configuration and a traffic file, the cloud's data file, and the counts'
test."""

import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

from portbench import check, inputs, run
from portbench.reference import config as rcfg


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_run_config_is_the_same_for_program_and_reference():
    """A traffic's ``artes`` block reaches both configurations alike."""
    from artes_tpu_torch.config import ArtesConfig

    cell = run.Cell.load("rayleigh_image25")
    traffic = dict(cell.traffic, artes={"det_theta": 1.2, "det_phi": 0.7})
    port = inputs.run_config(ArtesConfig, cell.config, traffic)
    ref = inputs.run_config(rcfg.ArtesConfig, cell.config, traffic)
    assert (port.det_theta, port.det_phi, port.mode, port.npix) == (1.2, 0.7, "imaging_mono", 25)
    assert _fields(port) == _fields(ref)


@pytest.mark.parametrize("where,change", [
    ("traffic", {"phase_angle": 30.0}),
    ("traffic", {"artes": {"det_phii": 0.5}}),
    ("traffic", {"artes": {"mode": "phase"}}),
    ("config", {"artes": {"max_scatterings": 10}}),
])
def test_run_config_refuses_keys_it_does_not_know(where, change):
    cell = run.Cell.load("rayleigh_spectrum")
    config, traffic = dict(cell.config), dict(cell.traffic)
    (config if where == "config" else traffic).update(change)
    with pytest.raises(ValueError, match="not known"):
        inputs.run_config(rcfg.ArtesConfig, config, traffic)


def test_job_views():
    config = run.Cell.load("rayleigh_spectrum").config
    assert inputs.job_views(config, {"wavelengths": "all"}) == [(w, None) for w in range(6)]
    views = inputs.job_views(config, {"wavelengths": [0, 2], "phase_deg": [30, 175.0]})
    assert views == [(0, 30.0), (0, 175.0), (2, 30.0), (2, 175.0)]
    views = inputs.job_views(config, {"wavelengths": [0], "phase_deg": "all"})
    assert len(views) == 73 and views[36] == (0, 90.0)


@pytest.mark.parametrize("phase", [60.0, 175.0], ids=["phase60", "crescent175"])
def test_phase_view_reaches_program_and_reference(phase):
    """A traffic that views the planet at another phase angle moves the
    image, and the program and the reference both take it: every photon
    replayed, the check reads no gap."""
    cell = run.Cell.load("rayleigh_image25")
    cell.traffic = dict(cell.traffic, phase_deg=[phase])
    moved, _ = check.reference_detector(cell.config, cell.traffic, 0, 512, 5, "cpu",
                                        phase_deg=phase)
    default, _ = check.reference_detector(cell.config, cell.traffic, 0, 512, 5, "cpu")
    assert not np.array_equal(moved[..., 0], default[..., 0])
    res = run.run_cell(cell, 161803398875, 0.0, False, device="cpu", photons=2048,
                       jobs_only=1, log=lambda m: None)
    assert res["correct"], res["checks"]
    assert res["checks"]["tally_z"]["value"] == 0.0 and res["where"] == ""


def test_count_z():
    assert check.count_z(0, 100, 0, 10) == 0.0
    assert check.count_z(50, 1000, 5, 100) == 0.0
    # 10 of 1000 against 0 of 1000: the pooled rate 0.005
    assert check.count_z(10, 1000, 0, 1000) == pytest.approx(0.01 / math.sqrt(2 * 0.005 / 1000))


@pytest.mark.skipif(importlib.util.find_spec("jax") is None,
                    reason="the JAX package's Mie solver needs jax")
def test_mie_cloud_file_is_the_jax_packages_solution():
    """The deck's cloud (albedo and 180 x 16 matrix) is what the JAX package's
    Mie solver gives for BASELINE #4's recipe (tools/baseline4_artifact.py:
    38-47), not only what the port's solver wrote. It runs in a process of its
    own, so that no test here loads the JAX package."""
    code = """
import json, os, sys, tempfile
import numpy as np
from artes_tpu.opacity import mie
with tempfile.TemporaryDirectory() as td:
    ri = os.path.join(td, "cloud.dat")
    with open(ri, "w") as fh:
        for w in (0.1, 0.5, 1.0, 10.0):
            fh.write(f"{w} 1.65 0.003\\n")
    tab = mie.generate(ri, [0.7], nr=30, nf=5, amin=0.1, amax=5.0, apow=3.5, fmax=0.0)
print(json.dumps({"albedo": float(tab.scattering[0] / tab.extinction[0]),
                  "scatter": np.asarray(tab.scatter).transpose(2, 0, 1)[0].tolist()}))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True,
                         text=True, timeout=600, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    jax_solution = json.loads(out.stdout.strip().splitlines()[-1])
    with open(inputs.CONFIGS / "mie_patchy_deck.cloud.json") as fh:
        cloud = json.load(fh)
    assert cloud["albedo"] == [jax_solution["albedo"]]
    np.testing.assert_array_equal(np.asarray(cloud["scatter"][0]),
                                  np.asarray(jax_solution["scatter"]))
