"""The frozen reference against the port's plain version, and its imports."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import check, inputs, run

CASES = [  # (workload, wavelength index, photons)
    ("rayleigh_spectrum", 0, 384),
    ("rayleigh_spectrum", 5, 384),
    ("rayleigh_image25", 0, 384),
    ("mie_deck_image25", 0, 96),
]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("workload,wl,photons", CASES)
def test_reference_equals_port_plain(workload, wl, photons, dtype):
    """On the same photons, the frozen reference's energy-scaled detector is
    the port's plain ``run_wavelength``'s on the CPU: counts bit-equal, sums
    equal but for the order of their float64 additions."""
    from artes_tpu_torch import runner
    from artes_tpu_torch.atmosphere import Atmosphere
    from artes_tpu_torch.config import ArtesConfig, detector_setup

    cell = run.Cell.load(workload)
    atm = Atmosphere(**inputs.atmosphere_arrays(cell.config))
    cfg = inputs.run_config(ArtesConfig, cell.config, cell.traffic)
    det = detector_setup(cfg, float(atm.rfront[-1]))
    seed = 2718281828
    port = runner.run_wavelength(atm, cfg, det, wl, photons, seed=seed, dtype=dtype,
                                 device="cpu")
    ref, counts = check.reference_detector(cell.config, cell.traffic, wl, photons, seed, "cpu",
                                           dtype=dtype)
    assert port.detector[..., 2].sum() > 0
    assert counts == {k: getattr(port, k) for k in check.ABANDONED}
    np.testing.assert_array_equal(port.detector[..., 2], ref[..., 2])
    np.testing.assert_allclose(port.detector[..., :2], ref[..., :2], rtol=1e-12, atol=0)
    assert check.photometry_gap(port.detector, port.photometry) == 0.0


def test_reference_imports_nothing_of_the_port():
    """Every module under portbench/reference, imported in a fresh process,
    leaves no artes_tpu_torch, artes_tpu or jax module loaded; nor does its
    source name one."""
    ref = pathlib.Path(run.HERE) / "reference"
    names = sorted(p.stem for p in ref.glob("*.py") if p.stem != "__init__")
    code = ("import sys\n" + "".join(f"import portbench.reference.{n}\n" for n in names)
            + "print(sorted({m.split('.')[0] for m in sys.modules} & "
              "{'artes_tpu_torch', 'artes_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"
    for p in ref.glob("*.py"):
        for line in p.read_text().splitlines():
            stripped = line.strip()
            if stripped.startswith(("import ", "from ")):
                assert "artes_tpu" not in stripped and "jax" not in stripped, (p, line)


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "artes_tpu_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxlike.sub", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "artes_tpu.transport", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert run.forbidden_modules() == ["artes_tpu", "jax"]
