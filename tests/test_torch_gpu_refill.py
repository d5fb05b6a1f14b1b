"""The radial kernel's refilled lanes go on into their photon's first round.

In ``pool_radial``'s persistent loop a lane whose photon died draws the next
one, emits it and runs its prewalk and first march; where that march ends in
an interaction the lane goes on into the photon's first scattering round in
the same pass, beside the warp's other lanes. So nearly every lane of a warp
is in the round branch at each pass. The card test reads the launch's lane
counters on the flagship and BASELINE #2's cloud deck at 177.5 degrees
(``hg_crescent``), recorded, against the same launch unrecorded. On a machine
with a card (no JAX there, so the conftest is left out):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_refill.py -q -s
"""

import pytest
import torch

from artes_tpu_torch import spans
from artes_tpu_torch.cells import KERNEL_CELLS
from artes_tpu_torch.parallel import mesh
from artes_tpu_torch.transport import pool_cuda
from torch_threads import one_thread  # noqa: F401

SEED = 7
# the stellar spectrum's cells, at photons enough a lane of the persistent
# grid (about 500) that the drain, in which each warp's last photons end at
# falling occupancy, weighs little: at 2^22 photons, 31 a lane, the round
# branch reads 88-90% (2^24: 96.7-97.3%; 2^26: 99.2-99.3%; H100)
REFILL_CELLS = {"flagship": 1 << 26, "hg_crescent": 1 << 26}
# the least share of a round pass's 32 lanes that run a round
ROUND_LANES_MIN = 0.95


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(REFILL_CELLS))
def test_refilled_lanes_run_their_first_round(cuda, name):
    """A recorded launch's round passes keep at least ``ROUND_LANES_MIN`` of
    their 32 lanes busy, and the launch has every count, error record and
    scatter peel of the same launch unrecorded, its sums within
    ``mesh.SPLIT_RTOL``; the refill branch's lanes are the photons emitted
    plus the threads launched (each thread's last pass finds no photon)."""
    tables, static = KERNEL_CELLS[name](cuda)
    n = REFILL_CELLS[name]
    assert pool_cuda.kernel_of(tables, static) == ("pool_radial", "stellar")
    off = pool_cuda.run_stream_cuda(tables, static, n, SEED)
    with spans.recording() as rec:
        on = pool_cuda.run_stream_cuda(tables, static, n, SEED)
    (launch,) = [s for s in rec.spans if s.name == "launch"]
    a = launch.attrs
    g = mesh.split_gaps(on, off)
    share = {branch: a[f"{branch}_lanes"] / (32 * a[f"{branch}_passes"])
             for branch in ("refill", "round")}
    both = (a["refill_lanes"] + a["round_lanes"]) / (32 * (a["refill_passes"] + a["round_passes"]))
    print(f"refill [{name}, {n} photons]: lanes refill {100 * share['refill']:.2f}%, round "
          f"{100 * share['round']:.2f}%, both {100 * both:.2f}%; passes refill "
          f"{a['refill_passes']}, round {a['round_passes']}; {a['device_ms']:.3f} ms, drain "
          f"{a['drain_ms']:.4f} ms; recorded against unrecorded: {g}")
    assert g["counts"] == 0 and g["records"] == 0 and g["values"] <= mesh.SPLIT_RTOL, g
    assert a["photons_emitted"] == n == int(off["n_emitted"])
    assert a["rounds"] == int(off["detector"][:, 1, 2].sum())
    assert a["capped"] == int(off["n_alive_at_cap"])
    assert a["refill_lanes"] == n + a["blocks"] * pool_cuda.THREADS
    assert share["round"] >= ROUND_LANES_MIN, share
