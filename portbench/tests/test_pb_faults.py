"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a run on
the CPU (the plain version in the kernel's place) at a small photon count, at
which the check replays every photon of a job: the sound run reads no gap, and
the control and each fault a cell can have must fail one of its numbers."""

import pytest

from portbench import control, run

WORKLOADS = ["rayleigh_spectrum", "mie_deck_image25", "rayleigh_spectrum_1e5",
             "rayleigh_image25"]
# photons a job: enough that negating Stokes Q reads about twice the
# statistical cells' tally_z limit while every photon is replayed
PHOTONS = {"mie_deck_image25": 4096}


def _run(workload, fault, seed=31415926535):
    cell = run.Cell.load(workload)
    with control.planted(fault, cell, "cpu"):
        return run.run_cell(cell, seed, 0.0, False, device="cpu",
                            photons=PHOTONS.get(workload, 8192), jobs_only=1, log=lambda m: None)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(workload):
    res = _run(workload, "none")
    assert res["correct"], res["checks"]
    assert res["checks"]["tally_z"]["value"] == 0.0
    assert res["checks"]["peels_gap"]["value"] == 0.0


@pytest.mark.parametrize("fault", ["control", "unchanged", "half", "altered", "capped"])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_fault_is_refused(workload, fault):
    res = _run(workload, fault)
    assert not res["correct"], res["checks"]
