"""The cost model and the end-to-end metrics on fixed counts and records."""

import math
import time

import numpy as np
import pytest
import torch

from portbench import costmodel, run


def test_pool_work_closed_form():
    """One radial shell: a walk is 2 x 2 face roots and 2 segments."""
    walk = 2 * 2 * 12 + 2 * 1 * 3
    n_bytes, n_ops = costmodel.pool_work("closed", (1, 1, 1), 1, 1, False, 1000,
                                         emitted=1 << 20, rounds=5_000_000)
    assert n_bytes == 1000 + 160
    assert n_ops == (1 << 20) * (40 + walk) + 5_000_000 * (787 + walk)


def test_pool_work_jump_walks_image():
    """39 x 8 x 8 cells imaged on 25 x 25 pixels: the walks add 7 cone faces
    and 8 phi half-planes, two walks a round."""
    walk = 2 * 40 * 12 + 2 * 39 * 3 + 7 * 30 + 8 * 14
    n_bytes, n_ops = costmodel.pool_work("jumps", (39, 8, 8), 625, 2496, False, 123456,
                                         emitted=1 << 24, rounds=10 ** 8)
    assert walk == 1516
    assert n_bytes == 123456 + 160 + 625 * 80
    assert n_ops == (1 << 24) * (40 + walk) + 10 ** 8 * (787 + 2 * walk)
    assert costmodel.pool_work("march", (39, 8, 8), 625, 2496, False, 1, 1, 1) is None


def test_bound_is_the_larger_of_bytes_and_operations():
    assert costmodel.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert costmodel.bound_s(0, 67e12) == pytest.approx(1.0)
    assert costmodel.bound_s(3.35e9, 67e12) == pytest.approx(1.0)


def _run(jobs, window_s, config=None, trace=None):
    cell = run.Cell.load("rayleigh_spectrum")
    if config is not None:
        cell.config = config
    return run.Run(cell=cell, jobs=jobs, setup_s=4.5, window_s=window_s, trace=trace)


def test_photons_per_s_and_time_to_accuracy():
    jobs = [{"packages": 1 << 30, "sigma_pol": 2e-5, "t0": 0.0, "t1": 3.0},
            {"packages": 1 << 30, "sigma_pol": 1e-5, "t0": 3.0, "t1": 5.0}]
    r = _run(jobs, 5.0, dict(run.Cell.load("rayleigh_spectrum").config, epsilon_pol=1e-5))
    assert run.read_metric("photons_per_s", r) == pytest.approx(2 * (1 << 30) / 5.0)
    # 2.5 s a job times the mean of (2)^2 and (1)^2
    assert run.read_metric("time_to_accuracy_s", r) == pytest.approx(2.5 * 2.5)
    assert run.read_metric("setup_s", r) == 4.5
    assert run.read_metric("pol_var_per_photon", r) == pytest.approx(
        (1 << 30) * (4e-10 + 1e-10) / 2)
    assert run.read_metric("host_ms_per_job", r) is None     # not traced
    # a quantity split by cells is read by the quantity's reader
    assert run.metric_reader("photons_per_s.short").name == "photons_per_s.py"
    assert run.read_metric("photons_per_s.short", r) == run.read_metric("photons_per_s", r)


class _Trace:
    def __init__(self, busy, kernel):
        self._busy, self._kernel = busy, kernel

    def busy_s(self):
        return self._busy

    def kernel_s(self, name):
        return self._kernel if "pool_radial" in name else 0.0


def test_traced_metrics():
    det = np.zeros((1, 1, 4, 3))
    det[..., 1, 2] = 4_000_000
    jobs = [{"packages": 1 << 20, "sigma_pol": 1e-3, "t0": 0.0, "t1": 0.1, "wl": 0,
             "detector": det}]
    r = _run(jobs, 0.1, trace=_Trace(busy=0.09, kernel=0.08))
    assert run.read_metric("device_idle_pct", r) == pytest.approx(10.0)
    assert run.read_metric("host_ms_per_job", r) == pytest.approx(10.0)
    n_bytes, n_ops = r.work(jobs[0])
    walk = 2 * 2 * 12 + 2 * 3
    assert n_ops == (1 << 20) * (40 + walk) + 4_000_000 * (787 + walk)
    assert run.read_metric("pool_radial_roofline", r) == pytest.approx(
        100 * costmodel.bound_s(n_bytes, n_ops) / 0.08)
    assert run.read_metric("pool_grid3d_roofline", r) is None


def _slow_jobs(monkeypatch, seconds_a_job):
    from artes_tpu_torch import runner

    from portbench import check

    def slow(atm, cfg, det, wl, n, seed=0, **_):
        time.sleep(seconds_a_job)

        class R:
            detector, photometry = np.ones((1, 1, 4, 3)), np.zeros(11)
            n_error = n_alive_at_cap = 0
        return R

    monkeypatch.setattr(runner, "run_wavelength", slow)
    monkeypatch.setattr(check, "check_jobs", lambda jobs, *a: (
        {"tally_z": {"value": 0.0, "limit": 1.0}}, ""))


def test_window_runs_every_job_it_starts(monkeypatch):
    """A job that overruns ``--seconds`` is finished and counted, photons and
    time alike; none starts after ``--seconds``."""
    _slow_jobs(monkeypatch, 0.3)
    cell = run.Cell.load("rayleigh_image25")
    res = run.run_cell(cell, 5, 0.5, False, device="cpu", photons=1000, log=lambda m: None)
    assert res["attempted"] == 2          # started at 0 and about 0.3 s
    rate = res["metrics"]["photons_per_s"]["value"]
    assert 2000 / 0.7 < rate < 2000 / 0.6       # the window ran to about 0.6 s
    assert math.isfinite(res["metrics"]["time_to_accuracy_s"]["value"])


def test_window_runs_whole_cycles_of_wavelengths(monkeypatch):
    """A spectrum's window ends with its cycle of six wavelengths."""
    _slow_jobs(monkeypatch, 0.02)
    cell = run.Cell.load("rayleigh_spectrum")
    res = run.run_cell(cell, 5, 0.01, False, device="cpu", photons=1000, log=lambda m: None)
    assert res["attempted"] == 6
    res = run.run_cell(cell, 5, 0.5, False, device="cpu", photons=1000, log=lambda m: None)
    assert res["attempted"] >= 18 and res["attempted"] % 6 == 0


def test_job_seeds_are_32_bit_and_take_large_run_seeds():
    seeds = {run.job_seed(s, i) for s in (0, 2 ** 31 + 11, 2 ** 40) for i in range(4)}
    assert len(seeds) == 12 and all(0 <= s < 2 ** 32 for s in seeds)
    assert run.job_seed(7, 3) == run.job_seed(7, 3)


def test_reference_tables_in_float32():
    cell = run.Cell.load("mie_deck_image25")
    assert getattr(torch, cell.config["precision"]) == torch.float32
