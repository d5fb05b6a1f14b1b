"""BASELINE #1's, #2's and #5's chains (``artes_tpu_torch.baselines``) against
the JAX package and the records of BASELINE_RUNS.json, on the CPU.

* #1's and #2's atmospheres from the port's ``presets`` equal JAX's, array
  by array.
* At float64, the plain version against JAX's ``run_stream`` (counts
  bit-equal, moments within rtol 1e-10, tests/test_torch_pool.py's rule
  for the rare photon JAX's jitted azimuth Newton parts): #1 at wavelengths
  0 and 5 with ``run_spectrum``'s seeds, #2 at 1e-5, 97.5 and 177.5 degrees
  (the crescent) with ``run_phase_curve``'s seeds.
* #1's 0.50 micron wavelength equals the flagship on the same photons at
  float64 (counts equal, I / norm and -Q/I within 1e-9): what lets
  ``baselines.check_1`` hold it against #5's record.
* Photon ids past 2^32: the flagship at float64 against JAX's
  ``run_stream`` at (id_hi, id_lo) = (1, 0) and (2, 2^32 - 2^10).
* ``runner.run_wavelength``'s chunk schedule for 1e10 photons (the launch
  stubbed to record ``(n, id_hi, id_lo)``) equals the JAX runner's
  (artes_tpu/runner.py:198-208), and the run's ``chunk`` spans, which
  ``baselines.chunk_schedule`` reads for #5, report it.
* ``baselines``' constants equal BASELINE_RUNS.json's; ``figures_2`` on the
  record's own curve gives its three figures; each ``check_*`` passes the
  record and refuses a mutant; ``summed_as_record`` weighs each chunk's
  float32 difference by its photons.
* ``python -m artes_tpu_torch.baselines 1|2|5 --device cpu`` at a few
  photons exits 0 with finite figures.
"""

import json
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artes_tpu import presets as j_presets
from artes_tpu import runner as j_runner
from artes_tpu.config import ArtesConfig, detector_setup
from artes_tpu.runner import _kernel_static
from artes_tpu.transport import kernel as JK
from artes_tpu.transport.tables import build_tables
from artes_tpu_torch import baselines, presets, runner, spans
from artes_tpu_torch.config import ArtesConfig as TorchConfig
from artes_tpu_torch.config import detector_setup as t_detector_setup
from artes_tpu_torch.constants import PI
from artes_tpu_torch.transport import convert
from artes_tpu_torch.transport import kernel as TK
from test_torch_pool import JAX_WIDTH, _close, _diverging, _tallies, assert_matches_jax
from test_torch_standalone import _same
from torch_threads import one_thread, one_thread_env  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
N = 1 << 10
# BASELINE #2's angles: their index in the phase curve gives their seed
ANGLES_2 = (1.0e-5, 97.5, 177.5)


def _atm(chain, package):
    if chain == 1:
        return package.rayleigh_single_layer(tau=5.0, wavelengths=baselines.WAVELENGTHS_1)
    if chain == 2:
        return package.hg_cloud_deck(tau=6.0, g=0.6, p_linear=0.4)
    return package.rayleigh_single_layer(tau=5.0)


def _tables(atm, mode, wl=0, det_phi=None, crescent=False):
    """JAX float64 tables of ``atm`` under a default ``ArtesConfig`` in
    ``mode`` and their port twins."""
    cfg = ArtesConfig()
    cfg.mode = mode
    det = detector_setup(cfg, float(atm.rfront[-1]), det_phi=det_phi)
    static = _kernel_static(cfg, det, atm, crescent)
    jt = build_tables(atm, cfg, det, wl, dtype=jnp.float64).tables
    return jt, static, convert.tables_from_jax(jt, dtype=torch.float64), \
        convert.static_from_jax(static)


@pytest.mark.parametrize("chain", [1, 2])
def test_atmosphere_equals_jax(chain):
    _same(_atm(chain, presets), _atm(chain, j_presets), f"#{chain}")


@pytest.mark.parametrize("wl", [0, 5])
def test_spectrum_plain_matches_jax_f64(wl):
    jt, static, tt, st = _tables(_atm(1, j_presets), "spectrum", wl=wl)
    assert_matches_jax(jt, static, tt, st, N, seed=wl)        # run_spectrum: seed 0 + wl


@pytest.mark.parametrize("angle", ANGLES_2)
def test_phase_curve_plain_matches_jax_f64(angle):
    i = runner.PHASE_ANGLES_DEG.index(angle)
    jt, static, tt, st = _tables(_atm(2, j_presets), "phase", det_phi=angle * PI / 180.0,
                                 crescent=angle >= 170.0)
    assert static.crescent == (angle == 177.5)
    got = assert_matches_jax(jt, static, tt, st, N, seed=baselines.SEED_2 + i)
    assert float(got["detector"][0, 0, 0]) > 0.0


def test_half_micron_equals_the_flagship():
    """#1 at 0.50 micron and the flagship (0.7 micron) on the same photons:
    the same optical structure, so the same counts, I / norm and -Q/I."""
    from artes_tpu_torch.cells import stellar_norm

    cfg = TorchConfig()
    cfg.mode = "spectrum"
    got = {}
    for chain in (1, 5):
        atm = _atm(chain, presets)
        det = t_detector_setup(cfg, float(atm.rfront[-1]))
        res = runner.run_wavelength(atm, cfg, det, 0, N, seed=3, dtype=torch.float64,
                                    device="cpu")
        p = res.photometry
        got[chain] = (res.detector[..., 2], p[0] / stellar_norm(cfg, atm), -p[2] / p[0])
    assert _atm(1, presets).wavelengths[0] == pytest.approx(0.5e-6)
    np.testing.assert_array_equal(got[1][0], got[5][0])
    assert got[1][0].sum() > 0
    for k in (1, 2):
        assert got[1][k] == pytest.approx(got[5][k], rel=1e-9, abs=0.0)


@pytest.mark.parametrize("id_hi,id_lo", [(1, 0), (2, (1 << 32) - N)])
def test_photon_ids_past_2_32_match_jax_f64(id_hi, id_lo):
    jt, static, tt, st = _tables(_atm(5, j_presets), "spectrum")
    seed = baselines.SEED_5

    def jax_run(lo, k):
        return _tallies(JK.run_stream(jt, static, k, seed, JAX_WIDTH, id_hi, id_lo + lo))

    def port_run(lo, k):
        return _tallies(TK.run_stream(tt, st, k, seed, k, id_hi, id_lo + lo))

    ref, got = jax_run(0, N), port_run(0, N)
    assert got[0][0, 0, 2] > 0
    bad = _diverging(jax_run, port_run, 0, N)
    assert len(bad) <= 2, bad
    for pid in bad:                   # JAX's jitted azimuth Newton (tests/test_torch_pool.py)
        ref = tuple(r - x for r, x in zip(ref, jax_run(pid, 1)))
        got = tuple(g - x for g, x in zip(got, port_run(pid, 1)))
    assert _close(got, ref)
    # another high word is another photon stream
    assert not np.array_equal(port_run(0, N)[0], _tallies(TK.run_stream(tt, st, N, seed, N))[0])


def test_chunk_schedule_of_1e10_photons_equals_jax(monkeypatch):
    """Ten chunks of at most 2^30 ids, none across 2^32 or 2^33."""
    n = baselines.PHOTONS_5
    port, ref = [], []

    def port_stub(tables, static, k, seed, width, id_hi, id_lo):
        port.append((k, id_hi, id_lo))
        return {"detector": torch.zeros((1, 4, 3), dtype=torch.float64),
                "flux_emitted": 0.0, "flux_exit": 0.0, "n_alive_at_cap": 0, "n_error": 0,
                "error_codes": torch.zeros(4, dtype=torch.int64)}

    def jax_stub(tables, static, k, seed, width, id_hi, id_lo):
        ref.append((int(k), int(id_hi), int(id_lo)))
        return {"detector": np.zeros((1, 4, 3)), "flux_emitted": 0.0, "flux_exit": 0.0,
                "n_error": 0, "n_alive_at_cap": 0, "error_codes": np.zeros(4, np.int64)}

    monkeypatch.setattr(runner, "run_stream", port_stub)
    monkeypatch.setattr(j_runner, "run_stream", jax_stub)
    atm, cfg = _atm(5, presets), TorchConfig()
    with spans.recording() as recorded:
        runner.run_wavelength(atm, cfg, t_detector_setup(cfg, float(atm.rfront[-1])), 0, n,
                              seed=baselines.SEED_5, dtype=torch.float64, device="cpu")
    reported = [(k, hi, lo) for hi, lo, k in baselines.chunk_schedule(recorded.spans)]
    jatm, jcfg = _atm(5, j_presets), ArtesConfig()
    j_runner.run_wavelength(jatm, jcfg, detector_setup(jcfg, float(jatm.rfront[-1])), 0, n,
                            seed=baselines.SEED_5, dtype=jnp.float64)
    assert port == ref == reported
    assert len(port) == 10 and sum(k for k, _, _ in port) == n
    starts = [(hi << 32) + lo for _, hi, lo in port]
    assert starts == [i << 30 for i in range(10)]
    assert {hi for _, hi, _ in port} == {0, 1, 2}
    assert all(lo + k <= 1 << 32 for k, _, lo in port)


def test_constants_equal_the_record():
    record = json.loads((REPO / "BASELINE_RUNS.json").read_text())
    two, five = record["baseline2_phase_curve"], record["baseline5_scale_run"]
    for key in ("forward_over_back_I", "max_pol_frac", "max_pol_angle_deg", "photons_per_s"):
        assert baselines.BASELINE2[key] == two[key], key
    assert two["photons_per_angle"] == baselines.PHOTONS_2 and two["angles"] == 73
    assert [(c["phase_deg"], c["I"], c["pol_frac"]) for c in two["curve"]] \
        == list(baselines.BASELINE2_CURVE)
    assert [c[0] for c in baselines.BASELINE2_CURVE] == runner.PHASE_ANGLES_DEG
    for key in ("pol_frac", "pol_frac_mc_err", "n_error", "n_alive_at_cap", "photons_per_s"):
        assert baselines.BASELINE5[key] == five[key], key
    assert list(baselines.BASELINE5["stokes_IQUV_W_m2_um"]) == five["stokes_IQUV_W_m2_um"]
    assert five["photons"] == baselines.PHOTONS_5


def _record_curve(sigma=1e-4):
    return [{"phase_deg": a, "I": i, "pol_frac": p, "sigma_I": sigma * i, "sigma_pol_frac": sigma}
            for a, i, p in baselines.BASELINE2_CURVE]


def test_figures_2_of_the_record():
    got = baselines.figures_2(_record_curve())
    assert got == {k: baselines.BASELINE2[k]
                   for k in ("forward_over_back_I", "max_pol_frac", "max_pol_angle_deg")}


def _record_1():
    return {"rows": [{"I_over_norm": baselines.record_5_I_over_norm(), "sigma_I_over_norm": 5e-4,
                      "minus_Q_over_I": baselines.BASELINE5["pol_frac"],
                      "sigma_minus_Q_over_I": 4.2e-4}]}


def _record_5():
    ref = baselines.BASELINE5
    scale = {k: ref[k] for k in ("pol_frac", "pol_frac_mc_err", "stokes_IQUV_W_m2_um",
                                 "n_error", "n_alive_at_cap")}
    return dict(scale, stokes_I_mc_err=1.5e-4 * ref["stokes_IQUV_W_m2_um"][0],
                record_sums={"pol_frac": ref["pol_frac"],
                             "stokes_IQUV_W_m2_um": ref["stokes_IQUV_W_m2_um"]})


def _mutant_1(result):
    row = result["rows"][0]
    row["minus_Q_over_I"] += 4.0 * np.hypot(row["sigma_minus_Q_over_I"],
                                            baselines.BASELINE5["pol_frac_mc_err"])
    return result


def _mutant_2(curve):
    peak = next(c for c in curve if c["phase_deg"] == 95.0)
    peak["pol_frac"] = baselines.BASELINE2["max_pol_frac"] + 2e-3
    return curve


def _mutant_5_error(scale):
    return dict(scale, n_error=1)


def _mutant_5_pol(scale):
    pol = scale["record_sums"]["pol_frac"] + 4.0 * np.hypot(
        scale["pol_frac_mc_err"], baselines.BASELINE5["pol_frac_mc_err"])
    return dict(scale, record_sums=dict(scale["record_sums"], pol_frac=pol))


def _mutant_5_i(scale):
    i = scale["stokes_IQUV_W_m2_um"][0]
    iquv = list(scale["record_sums"]["stokes_IQUV_W_m2_um"])
    iquv[0] += 4.0 * np.sqrt(2.0) * scale["stokes_I_mc_err"] / i * iquv[0]
    return dict(scale, record_sums=dict(scale["record_sums"], stokes_IQUV_W_m2_um=iquv))


@pytest.mark.parametrize("check,record,mutant,missed", [
    (baselines.check_1, _record_1, _mutant_1, {"minus_Q_over_I"}),
    (baselines.check_2, _record_curve, _mutant_2,
     {"max_pol_angle_deg", "max_pol_frac", "every_angle_pol_frac"}),
    (baselines.check_5, _record_5, _mutant_5_error, {"n_error"}),
    (baselines.check_5, _record_5, _mutant_5_pol, {"pol_frac"}),
    (baselines.check_5, _record_5, _mutant_5_i, {"stokes_I_as_record_sums"}),
], ids=["1-pol_frac-4-sigma", "2-peak-at-95", "5-n_error-1", "5-pol_frac-4-sigma",
        "5-I-as-record-sums-4-sigma"])
def test_check_passes_the_record_and_refuses_a_mutant(check, record, mutant, missed):
    assert all(c["ok"] for c in check(record()).values())
    got = check(mutant(record()))
    assert {k for k, c in got.items() if not c["ok"]} == missed
    assert not baselines.held_ok(got)


def test_summed_as_record_weighs_the_chunks_by_their_photons():
    iquv = [4.0, -1.6, 0.2, 0.0]
    chunks = [(0, 0, 1 << 30), (0, 1 << 30, 1 << 30), (1, 0, 1 << 28)]
    diffs = {1 << 30: [-4e-4, 8e-5, 0.0, 0.0], 1 << 28: [-1e-4, 2e-5, 1e-6, 0.0]}
    got = baselines.summed_as_record(iquv, chunks, diffs)
    share = np.array([8.0, 1.0]) / 9.0
    want = [iquv[k] + iquv[0] * (share[0] * diffs[1 << 30][k] + share[1] * diffs[1 << 28][k])
            for k in range(4)]
    assert np.allclose(got, want, rtol=1e-15, atol=0.0)
    assert baselines.summed_as_record(iquv, chunks, {n: [0.0] * 4 for n in diffs}) == iquv


@pytest.mark.parametrize("chain,photons", [(1, 512), (2, 64), (5, 512)])
def test_chain_runs_on_the_cpu(chain, photons):
    env = one_thread_env(PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-m", "artes_tpu_torch.baselines", str(chain),
                           "--device", "cpu", "--photons", str(photons)],
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["ok"] and result["device"] == result["card"] == "cpu"
    assert result["launches"] == {} and "checks" not in result
    if chain == 1:
        assert len(result["rows"]) == 6
        assert all(np.isfinite([r["I_over_norm"], r["minus_Q_over_I"],
                                r["sigma_I_over_norm"]]).all()
                   and r["I_over_norm"] > 0 for r in result["rows"])
    elif chain == 2:
        curve = result["curve"]
        assert [c["phase_deg"] for c in curve] == runner.PHASE_ANGLES_DEG
        assert all(np.isfinite([c["I"], c["pol_frac"]]).all() for c in curve)
        assert curve[0]["I"] > 0 and 0.0 < result["max_pol_frac"] < 1.0
    else:
        scale = result["scale"]
        assert scale["chunks_id_hi_id_lo_n"] == [[0, 0, photons]]
        assert np.isfinite(scale["stokes_IQUV_W_m2_um"]).all() and scale["n_error"] == 0
        assert 0.0 < scale["pol_frac"] < 1.0
        sources = result["reflected_thermal"]["sources"]
        assert sorted(sources) == ["planet", "star"]
        assert all(np.isfinite(s["stokes_IQUV_W_m2_um"]).all() and s["stokes_IQUV_W_m2_um"][0] > 0
                   for s in sources.values())
