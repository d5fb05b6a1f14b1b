# Frozen copy of chip_smoke.py::bound, pool_work and the OPS_* counts at
# commit bba47c3, reading a job's counts instead of a launch's result.
"""The least time one H100 could take for a pool-kernel launch: its bytes and
float32 operations, counted from the physics the launch did (photons emitted,
booked scatter peels, the walks' faces by the grid's shape), never from what
one implementation of the kernel happens to execute."""

from __future__ import annotations

import torch

from portbench.check import reference_setup
from portbench.reference.kernel import walk_mode

# peaks of one H100 SXM (NVIDIA's data sheet): device memory, float32 outside
# the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67.0e12

# float32 operations counted by hand in csrc/pool_common.cuh: one scattering
# round without its walks (peel_prep 170, sample_beta 215, sample_alpha 205,
# direction_cosine 45, matrix_at 52, polarization_rotation 100), one
# emission, one face root (a quadratic: 12), one cone face's root pair, one
# phi half-plane crossing
OPS_ROUND, OPS_EMIT, OPS_ROOT, OPS_CONE, OPS_PHI = 787, 40, 12, 30, 14
OPS_SELECT = 24                       # cell_face's two-tier selection
# one flow booking, a square root or a trigonometric function counted as one
# operation: a marching pass (pool_march.cu::flow_book), a closed-form
# segment (pool_radial.cu::book_segment)
OPS_FLOW_PASS, OPS_FLOW_SEGMENT = 37, 29


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least seconds the card could take to move ``n_bytes`` and do
    ``n_ops`` float32 operations."""
    return max(n_bytes / PEAK_BYTES_S, n_ops / PEAK_F32_S)


def table_bytes(tables) -> int:
    """Bytes of every table of a ``TransportTables`` (the reference's, in the
    program's float32), each read once."""
    g = tables.grid
    tensors = [v for v in vars(tables).values() if isinstance(v, torch.Tensor)]
    tensors += [v for v in vars(g).values() if isinstance(v, torch.Tensor)]
    if tables.jump is not None:        # built for the jump walks only
        tensors += [v for v in vars(tables.jump).values() if isinstance(v, torch.Tensor)]
    return sum(t.numel() * t.element_size() for t in tensors)


def launch_shape(config: dict, traffic: dict, wl_index: int) -> dict:
    """What :func:`pool_work` needs of a job's launch but its counts: the walk,
    the grid's shape, the pixels, the cells, flow, and the bytes of the
    tables the reference builds for it on the host in the configuration's
    precision."""
    _, _, _, prep, static, _ = reference_setup(config, traffic, wl_index, "cpu")
    g = prep.tables.grid
    return dict(mode=walk_mode(prep.tables, static), grid_shape=(g.nr, g.ntheta, g.nphi),
                npix=static.nx * static.ny, ncell=int(prep.tables.opacity.shape[0]),
                track_flow=static.track_flow, tables_nbytes=table_bytes(prep.tables))


def pool_work(mode: str, grid_shape: tuple, npix: int, ncell: int, track_flow: bool,
              tables_nbytes: int, emitted: int, rounds: int, booked: int = 0,
              cell_face: int | None = None) -> tuple[int, int] | None:
    """``(bytes, operations)`` of one pool-kernel launch of walk ``mode``
    (``"closed"``, ``"jumps"`` or ``"march"``). Bytes: every table once, every
    tally once. Operations, a lower count: every emitted photon is born and
    walks its path once; every booked scatter peel (``rounds``: the Stokes Q
    row's count) is one scattering round with its peel walk and, on a 3-D
    grid, the path total that its march is checked against. A radial walk
    takes the roots of nr + 1 faces twice (in, out) and 3 operations a
    segment; a 3-D jump walk adds the root pair of every cone face and the
    crossing of every phi half-plane. A marching kernel's walks are the
    ``cell_face`` passes it counted (None where the program does not report
    them: then there is no count)."""
    nr, ntheta, nphi = grid_shape
    n_bytes = tables_nbytes + 8 * (10 + 10) \
        + (npix * 8 * (8 + 2) if npix > 1 else 0) + (ncell * 7 * 8 if track_flow else 0)
    if mode == "march":
        if cell_face is None:
            return None
        face = 2 * OPS_ROOT + OPS_SELECT + (2 * OPS_CONE if ntheta > 1 else 0) \
            + (2 * OPS_PHI if nphi > 1 else 0)
        n_ops = emitted * OPS_EMIT + rounds * OPS_ROUND + cell_face * face \
            + booked * OPS_FLOW_PASS
        return n_bytes, n_ops
    walk = 2 * (nr + 1) * OPS_ROOT + 2 * nr * 3
    walks_a_round = 1
    if mode == "jumps":
        walk += (ntheta - 1) * OPS_CONE + nphi * OPS_PHI
        walks_a_round = 2
    n_ops = emitted * (OPS_EMIT + walk) + rounds * (OPS_ROUND + walks_a_round * walk) \
        + booked * OPS_FLOW_SEGMENT
    return n_bytes, n_ops


def roofline_pct(run, kernel: str) -> float | None:
    """Percent of its roofline that ``kernel`` ran at over a traced window: the
    sum over the window's jobs of :func:`bound_s` of :func:`pool_work` over the
    trace's device seconds of every operation named ``kernel``. None where
    the trace holds no such kernel or a job has no count."""
    if run.trace is None:
        return None
    seconds = run.trace.kernel_s(kernel)
    if seconds <= 0:
        return None
    works = [run.work(j) for j in run.jobs]
    if any(w is None for w in works):
        return None
    return 100.0 * sum(bound_s(*w) for w in works) / seconds
