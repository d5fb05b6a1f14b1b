"""The 3-D kernel's table of phi half-plane crossings at every size class.

``pool_grid3d``'s jump walks evaluate their NP phi half-plane crossings once
a walk into a table in shared memory where the grid has 2 to
``pool_cuda.PHI_TABLE_MAX`` phi faces, and re-evaluate them at every
crossing past it. The card tests hold the kernel against its plain version
on grids of 1, 2, 8, ``PHI_TABLE_MAX`` and ``PHI_TABLE_MAX + 1`` phi faces
and read the launch's walk counters. The tests without the gpu marker run on
the CPU. On a machine with a card (no JAX there, so the conftest is left
out):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_wedge.py -q -s
"""

import os
import re

import pytest
import torch

from artes_tpu_torch import _build, cells, spans
from artes_tpu_torch.cells import gate_photons, spectrum_tables
from artes_tpu_torch.transport import kernel, pool_cuda
from torch_threads import one_thread  # noqa: F401

SEED = 7
# one grid a size class of the table: none, the least, the deck's, the most, one past
WEDGES = (1, 2, 8, pool_cuda.PHI_TABLE_MAX, pool_cuda.PHI_TABLE_MAX + 1)
COUNT_KEYS = ("n_emitted", "n_alive_at_cap", "n_error", "n_stokes_anomaly")


def tabled(nphi: int) -> bool:
    return 1 < nphi <= pool_cuda.PHI_TABLE_MAX


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_phi_table_max_is_the_kernels():
    """The wrapper's ``PHI_TABLE_MAX`` is the kernel's (the launch's layout
    check holds it on the card too), and the table stays inside the four
    resident blocks of 256 threads: 32 KB a block at most."""
    with open(os.path.join(_build.CSRC_DIR, "pool_grid3d.cu")) as fh:
        source = fh.read()
    (value,) = re.findall(r"constexpr int PHI_TABLE_MAX = (\d+);", source)
    assert int(value) == pool_cuda.PHI_TABLE_MAX
    assert pool_cuda.PHI_TABLE_MAX * pool_cuda.THREADS * 4 <= 32 << 10


@pytest.mark.parametrize("source", ["pool_radial", "pool_grid3d", "pool_march"])
def test_counter_slots_by_kernel(source):
    """``pool_grid3d`` counts its jump walks in two slots after the four lane
    counters, ``pool_radial`` stamps its drain in two; ``pool_march`` counts
    the four lane counters alone (its layout on the card says so too)."""
    keys = pool_cuda.counter_keys(source)
    assert keys == {"pool_grid3d": pool_cuda.LANE_KEYS + pool_cuda.WALK_KEYS,
                    "pool_radial": pool_cuda.LANE_KEYS + pool_cuda.DRAIN_KEYS,
                    "pool_march": pool_cuda.LANE_KEYS}[source]
    tables, static = spectrum_tables(cells.wedge_grid(8), torch.device("cpu"))
    layout = pool_cuda._layout(source, static, tables.opacity.shape[0])
    flat_f, flat_i, v = pool_cuda._alloc(layout, torch.device("cpu"))
    assert v["lanes"].numel() == len(keys)
    assert v["rec_count"].data_ptr() == flat_i[-1:].data_ptr()
    assert v["lanes"].storage_offset() + len(keys) == flat_i.numel() - 1


@pytest.mark.parametrize("nphi", WEDGES)
def test_wedge_grids_take_the_jump_walks(nphi):
    """Each wedge grid is a jump-walk configuration of ``nphi`` phi faces
    (``pool_grid3d`` on a card), which the plain version transports."""
    tables, static = spectrum_tables(cells.wedge_grid(nphi), torch.device("cpu"))
    assert tables.grid.nphi == nphi and tables.grid.ntheta == 3 and tables.grid.nr == 4
    assert kernel.walk_mode(tables, static) == "jumps"
    assert pool_cuda.kernel_of(tables, static) == ("pool_grid3d", "grid3d_stellar")
    out = kernel.run_stream(tables, static, 256, SEED, 256)
    assert int(out["n_emitted"]) == 256 and out["detector"].isfinite().all()
    assert float(out["detector"][0, 0, 2]) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("nphi", WEDGES)
def test_wedge_table_counts_equal_plain(cuda, nphi):
    """At the gate's photons, every count of the kernel equals the plain
    version's, as on the other jump-walk cells (the walks' wedges are the
    plain version's bit for bit, table or not), and every gap is within
    ``AGREE_3D``; the launch counts at least a walk a photon (its prewalk),
    every walk tabled from 2 to ``PHI_TABLE_MAX`` phi faces and none past it
    or without phi faces."""
    tables, static = spectrum_tables(cells.wedge_grid(nphi), cuda)
    n = gate_photons(tables, static)
    with spans.recording() as rec:
        k = pool_cuda.run_stream_cuda(tables, static, n, SEED)
    p = kernel.run_stream(tables, static, n, SEED, n)
    (launch,) = [s for s in rec.spans if s.name == "launch"]
    a = launch.attrs
    g = pool_cuda.gaps(k, p)
    print(f"wedges {nphi}: walks {a['jump_walks']}, tabled {a['jump_walks_tabled']}, "
          f"blocks {a['blocks']}; gaps {g}")
    assert torch.equal(k["detector"][..., 2].cpu(), p["detector"][..., 2].cpu())
    assert [int(k[key]) for key in COUNT_KEYS] == [int(p[key]) for key in COUNT_KEYS]
    assert torch.equal(k["error_codes"].cpu(), p["error_codes"].cpu())
    assert pool_cuda.agrees(g, pool_cuda.limits_of(tables, static)), g
    assert a["jump_walks"] >= a["photons_emitted"] == n
    assert a["jump_walks_tabled"] == (a["jump_walks"] if tabled(nphi) else 0)
    assert a["blocks"] == pool_cuda.launch_blocks(tables, static, n)
