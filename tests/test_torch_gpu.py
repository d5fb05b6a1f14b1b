"""The CUDA kernels on the card, against their plain PyTorch versions.

Needs a CUDA device, nvcc and no JAX; without a card every test skips. On a
machine with a card (which has no JAX, so the JAX-pinning conftest is left
out):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import os
import shutil

import numpy as np
import pytest
import torch

from artes_tpu_torch import _build, cells, config, probe_splat
from artes_tpu_torch.parallel import mesh
from artes_tpu_torch.cells import CELLS, KERNEL_CELLS, gate_photons, spectrum_tables
from artes_tpu_torch.transport import kernel, pool_cuda

SEED = 7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def setup(name, device, dtype=torch.float32):
    return spectrum_tables(CELLS[name](), device, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CELLS))
def test_cuda_kernel_matches_plain(cuda, name):
    """The count, the capped photons and all eight sums within
    ``pool_cuda.AGREE`` at 2^20 photons, the size the limits were set at:
    the two compilers contract FMAs differently, so rare trajectories flip."""
    tables, static = setup(name, cuda)
    n = 1 << 20
    k = pool_cuda.run_stream_cuda(tables, static, n, SEED)
    p = kernel.run_stream(tables, static, n, SEED, n)
    assert k["detector"].isfinite().all()
    g = pool_cuda.gaps(k, p)
    assert pool_cuda.agrees(g), g
    assert int(k["n_emitted"]) == n


@pytest.mark.gpu
def test_cuda_wrapper_counts_launches_and_checks_inputs(cuda):
    tables, static = setup("flagship", cuda)
    before = dict(pool_cuda.LAUNCHES)
    after = dict(before, stellar=before["stellar"] + 1)
    pool_cuda.run_stream_cuda(tables, static, 4096, SEED)
    pool_cuda.run_stream_cuda(tables, static, 0, SEED)          # nothing to launch
    torch.cuda.synchronize()
    assert pool_cuda.LAUNCHES == after
    tables64, static64 = setup("flagship", cuda, torch.float64)
    with pytest.raises(ValueError, match="float32"):
        pool_cuda.run_stream_cuda(tables64, static64, 4096, SEED)
    with pytest.raises(ValueError, match="32-bit window"):
        pool_cuda.run_stream_cuda(tables, static, 16, SEED, id_lo=(1 << 32) - 8)
    assert pool_cuda.LAUNCHES == after


def held_against_plain(tables, static, n):
    """Kernel and plain version on the same photons: one more launch of the
    configuration's instantiation, every gap within the limits of its walks."""
    variant = pool_cuda.kernel_of(tables, static)[1]
    before = pool_cuda.LAUNCHES[variant]
    k = pool_cuda.run_stream_cuda(tables, static, n, SEED)
    p = kernel.run_stream(tables, static, n, SEED, n)
    assert pool_cuda.LAUNCHES[variant] == before + 1
    assert k["detector"].isfinite().all()
    assert k["detector"].shape == p["detector"].shape == (static.nx * static.ny, 4, 3)
    g = pool_cuda.gaps(k, p)
    print(f"gaps [{variant}]: {g}")
    assert pool_cuda.agrees(g, pool_cuda.limits_of(tables, static)), g
    return k, p


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(set(KERNEL_CELLS) - set(CELLS)))
def test_cuda_instantiations_match_plain(cuda, name):
    """Thermal, image, crescent/off-axis, 3-D, surface and flow cells: every
    gap of ``pool_cuda.gaps`` (per pixel, per count column, fluxes, flow
    arrays, abandoned photons) within the limits of the cell's walks
    (``AGREE``, ``AGREE_3D``, ``AGREE_MARCH``) at ``cells.gate_photons``, the
    sizes the limits were set at, each through its instantiation."""
    tables, static = KERNEL_CELLS[name](cuda)
    k, p = held_against_plain(tables, static, gate_photons(tables, static))
    mode = kernel.walk_mode(tables, static)
    rec = k["error_records"]
    assert len(rec) == min(k["n_error_records"], 2 * kernel.ERR_RECORD_K)
    assert torch.equal(rec[:, 1], torch.sort(rec[:, 1]).values)          # photon-id order
    n_err = int(k["n_error"])
    # a Stokes anomaly (--debug-stokes) is code 50 at site 4
    anomaly = (rec[:, 0] == 50.0) & (rec[:, 15] == 4.0)
    assert static.debug_stokes or (not anomaly.any() and int(k["n_stokes_anomaly"]) == 0)
    if mode == "jumps":
        # one record per abandoned photon, each also an event of the plain
        # version unless its trajectory flipped
        assert k["n_error_records"] == n_err
        assert set(rec[:, 0].tolist()) <= {31.0, 32.0, 34.0, 50.0}
        assert ((rec[:, 15] == 0) | anomaly).all()
        shared = set(rec[:, 1].tolist()) & set(p["error_records"][:, 1].tolist())
        assert len(shared) >= len(rec) // 2
    elif mode == "march":
        # failed birth peels abandon without a record; failed scatter peels
        # leave one (code 50 at site 3) without abandoning
        peel = int(k["error_codes"][3])
        assert n_err - peel <= k["n_error_records"] <= n_err + peel
        assert set(rec[:, 0].tolist()) <= {31.0, 32.0, 34.0, 50.0}
        assert ((rec[:, 0] == 50.0) == ((rec[:, 15] == 3.0) | anomaly)).all()
        assert int(k["n_cell_face"]) > int(k["n_emitted"])
    else:
        # the closed form abandons photons on Stokes anomalies alone
        assert n_err == k["n_error_records"] == int(k["n_stokes_anomaly"])
        assert anomaly.all()
    assert (k["flow_global"] is not None) == static.track_flow
    if static.track_flow:
        # every transport march books at least the segment or pass it ends in
        assert int(k["n_flow_booked"]) > int(k["n_emitted"]) // 2
        # a cell's projections are parts of the energy x distance booked there
        assert float(torch.linalg.norm(k["flow_global"], dim=-1).sum()) \
            <= float(p["flow_path"].sum()) * (1 + 1e-2)


# Small faults of the surface and flow code, each with the cells whose gate
# must see it: (file under csrc/, text to replace, replacement, cells)
MUTANTS = {
    "lambert direction u for sqrt(u)": (
        "pool_march.cu", "direction_cosine(sqrtf(u[1]), TWO_PI_F * u[2], normal, lambert);",
        "direction_cosine(u[1], TWO_PI_F * u[2], normal, lambert);",
        ("lambert_tau05", "grid3d_2496_surface")),
    "surface peel without its cosine": (
        "pool_march.cu", "expf(-fminf(w.tau, 500.0f)) * cos_det / PI_F * stokes[0];",
        "expf(-fminf(w.tau, 500.0f)) / PI_F * stokes[0];",
        ("lambert_tau05", "thermal_surface")),
    # faults of the flow_global projections alone, which flow_theta cannot see
    "flow_global theta projection with its sign turned": (
        "pool_common.cuh", "red_add(fl.g + 3 * cell + 1, (double)wt);",
        "red_add(fl.g + 3 * cell + 1, -(double)wt);",
        ("grid3d_2496_flow", "hydrostatic39_flow")),
    "flow_global theta and phi projections swapped, marching": (
        "pool_march.cu",
        "(c_t * c_p * d[0] + c_t * s_p * d[1] - s_t * d[2]) * w,\n"
        "           (-s_p * d[0] + c_p * d[1]) * w, column, energy);",
        "(-s_p * d[0] + c_p * d[1]) * w,\n"
        "           (c_t * c_p * d[0] + c_t * s_p * d[1] - s_t * d[2]) * w, column, energy);",
        ("grid3d_2496_flow",)),
    "flow_theta up and down swapped, marching": (
        "pool_march.cu", "st.axis == 1 ? (outward ? 0 : 1)", "st.axis == 1 ? (outward ? 1 : 0)",
        ("grid3d_2496_flow", "grid3d_thermal_surface_flow")),
    "flow_theta up and down swapped, closed form": (
        "pool_radial.cu", "crossed ? column : -1, energy);",
        "crossed ? 1 - column : -1, energy);",
        ("hydrostatic39_flow", "thermal_flow")),
    "flow booked into the cell entered": (
        "pool_march.cu",
        "flow_book(fl, G, pos, dir, stokes[0], step, cf, st, cell, !interact);",
        "flow_book(fl, G, pos, dir, stokes[0], step, interact ? cf : "
        "(min(max(st.cell[0], 0), T.nr - 1) * G.nt + st.cell[1]) * G.np + st.cell[2], st, cell, "
        "!interact);",
        ("grid3d_2496_flow", "patchy3d_imaging25_surface_flow")),
    # the jump-walk kernel's shortcut: a photon whose sampled depth exceeds
    # its path's total leaves, or is absorbed at the floor, without marching
    "exit precheck left on": (
        "pool_march.cu",
        "    const int out = march_cells<IMAGE, FLOW>(",
        "    const Walk path = tau_walk_march(T, G, S, pos, dir, cell, face, cnt[C_PASSES]);\n"
        "    const int out = (!path.error && tau >= path.tau)\n"
        "        ? (path.surface ? M_FLOOR : M_EXIT)\n"
        "        : march_cells<IMAGE, FLOW>(",
        ("lambert_tau05", "grid3d_2496_flow")),
    # the runtime flags of --debug-stokes and photon:scattering=off
    "Stokes-anomaly check dropped, closed form": (
        "pool_radial.cu", "const bool anomalous = debug_stokes && stokes_anomaly(st);",
        "const bool anomalous = false;",
        ("anomaly_radial",)),
    # Stokes V: only the Mie deck's matrices carry F34 (elements 11 and 14)
    "F34 with its sign turned": (
        "pool_common.cuh", "    m[e] = a + (b - a) * frac;\n",
        "    m[e] = (e == 11 || e == 14 ? -1.0f : 1.0f) * (a + (b - a) * frac);\n",
        ("mie_patchy_imaging25",)),
    "scattering-off flag ignored, jump walks": (
        "pool_grid3d.cu", "const bool no_scatter = (flags & F_NO_SCATTER) != 0;",
        "const bool no_scatter = false;",
        ("noscatter_patchy3d",)),
}


@pytest.fixture(scope="module")
def plain_results():
    """The plain version's result a cell, shared by the mutants of a cell."""
    return {}


@pytest.mark.gpu
@pytest.mark.parametrize("fault", sorted(MUTANTS))
def test_mutant_kernels_fail_the_gate(cuda, fault, tmp_path, monkeypatch, plain_results):
    """A copy of the CUDA sources with one fault, built beside the real
    libraries: the gate that holds the kernel against its plain version must
    refuse it on every cell named for the fault."""
    file, old, new, cell_names = MUTANTS[fault]
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    text = (csrc / file).read_text()
    assert text.count(old) == 1, f"{fault}: the text to replace occurs {text.count(old)} times"
    (csrc / file).write_text(text.replace(old, new))
    monkeypatch.setattr(_build, "CSRC_DIR", os.fspath(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", os.fspath(tmp_path / "build"))
    monkeypatch.setattr(_build, "_LIBS", {})
    for name in cell_names:
        tables, static = KERNEL_CELLS[name](cuda)
        n = gate_photons(tables, static)
        if name not in plain_results:
            plain_results[name] = kernel.run_stream(tables, static, n, SEED, n)
        g = pool_cuda.gaps(pool_cuda.run_stream_cuda(tables, static, n, SEED),
                           plain_results[name])
        limits = pool_cuda.limits_of(tables, static)
        over = {key: g[key] for key in limits
                if not pool_cuda.agrees({key: g[key]}, {key: limits[key]})}
        print(f"mutant [{fault}] on {name}: gaps over their limits {over}")
        assert over, f"{fault} passes the gate on {name}: {g}"


@pytest.mark.gpu
def test_cuda_grid_of_5184_blended_cells(cuda):
    """More cells than the TPU kernel's tables held (4,096), every cell its
    own blend of two species: per-cell tables in global memory need no cell
    cap and no mixture dedup. (Held against the plain version as the
    ``blended_5184`` cell of ``test_cuda_instantiations_match_plain``.)"""
    tables, static = KERNEL_CELLS["blended_5184"](cuda)
    assert tables.opacity.shape[0] == 5184
    assert len(torch.unique(tables.scatter_rows.reshape(5184, -1), dim=0)) == 5184
    assert pool_cuda.supports(tables, static)
    k = pool_cuda.run_stream_cuda(tables, static, 1 << 16, SEED)
    assert int(k["n_emitted"]) == 1 << 16 and float(k["detector"][0, 0, 2]) > 1e4
    assert k["detector"].isfinite().all()


# the gate cells of --debug-stokes and photon:scattering=off, by kernel
FLAG_CELLS = {"anomaly_radial": "pool_radial", "anomaly_grid3d": "pool_grid3d",
              "anomaly_surface": "pool_march", "noscatter_flagship": "pool_radial",
              "noscatter_patchy3d": "pool_grid3d"}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(FLAG_CELLS))
def test_cuda_runs_debug_stokes_and_scattering_off(cuda, name):
    """The Stokes-anomaly check and scattering off run in the kernels: each
    cell through its kernel within its limits (``stokes_anomaly`` among the
    gaps), anomalies recorded as code 50 at site 4, no peel without
    scattering; float64 runs the plain version on the card, launches no
    kernel and equals float64 on the CPU (``runner.F64_DEVICE_RTOL``)."""
    tables, static = KERNEL_CELLS[name](cuda)
    assert pool_cuda.kernel_of(tables, static)[0] == FLAG_CELLS[name]
    k, p = held_against_plain(tables, static, gate_photons(tables, static))
    if static.debug_stokes:
        assert int(k["n_stokes_anomaly"]) > int(k["n_emitted"]) // 100
        assert int(p["n_stokes_anomaly"]) > 0
        rec = k["error_records"]
        assert ((rec[:, 0] == 50.0) & (rec[:, 15] == 4.0)).any()
    else:
        assert float(k["detector"][:, 1:, 2].sum()) == 0.0 == float(p["detector"][:, 1:, 2].sum())
        assert int(k["n_alive_at_cap"]) == 0
    from artes_tpu_torch import runner
    cfg, atm = config.ArtesConfig(), cells.flagship()
    det = config.detector_setup(cfg, float(atm.rfront[-1]))
    before = dict(pool_cuda.LAUNCHES)
    on_card, on_cpu = (runner.run_wavelength(atm, cfg, det, 0, 4096, seed=SEED,
                                             dtype=torch.float64, device=dev)
                       for dev in (cuda, "cpu"))
    assert pool_cuda.LAUNCHES == before
    assert on_card.prep.tables.opacity.device.type == "cuda"
    np.testing.assert_array_equal(on_card.detector[..., 2], on_cpu.detector[..., 2])
    assert on_card.detector[..., 0, 2].sum() > 0
    np.testing.assert_allclose(on_card.detector[..., :2], on_cpu.detector[..., :2],
                               rtol=runner.F64_DEVICE_RTOL, atol=0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("npix", [625, 2025, 10201])
def test_probe_splat_kernels_match_plain(cuda, npix):
    """The splat kernel (128 blocks of 64, global atomics): counts bit-equal
    and values within ``VALUE_RTOL`` of the plain version, at the full 2000
    rounds."""
    before = dict(probe_splat.LAUNCHES)
    vals, counts = probe_splat.splat(npix, device=cuda)
    sink = probe_splat.baseline(50, device=cuda)
    ref_vals, ref_counts = probe_splat.splat_plain(npix, device=cuda)
    assert torch.equal(counts, ref_counts)
    torch.testing.assert_close(vals, ref_vals, rtol=probe_splat.VALUE_RTOL, atol=0.0)
    assert torch.equal(sink, probe_splat.baseline_plain(50, device=cuda))
    assert probe_splat.LAUNCHES == {k: v + 1 for k, v in before.items()}


# the mesh launch (parallel.mesh): the photon axis over sub-ranges and ranks
SPLIT_CELLS = ("grid3d_2496", "grid3d_thermal_surface_flow", "grid3d_thermal_imaging25")


@pytest.mark.gpu
@pytest.mark.parametrize("name", SPLIT_CELLS)
def test_split_over_sub_ranges_equals_one_launch(cuda, name):
    """The mesh's arithmetic on one card: k = 2, 3 and 7 sub-ranges of
    ``mesh.split_ids`` launched in turn and merged equal one launch of the
    same photons, every count and error record equal and the sums within
    ``mesh.SPLIT_RTOL``: each photon's draws come from its id alone, whichever
    lane of the persistent grids (pool_radial, pool_grid3d) runs it."""
    tables, static = KERNEL_CELLS[name](cuda)
    n = gate_photons(tables, static)
    one = pool_cuda.run_stream_cuda(tables, static, n, SEED)
    assert int(one["n_error_records"]) > 0
    for k in (2, 3, 7):
        g = mesh.split_gaps(mesh.run_split(tables, static, n, SEED, k), one)
        print(f"{name} split {k}: {g}")
        assert g["counts"] == 0 and g["records"] == 0 and g["values"] <= mesh.SPLIT_RTOL, g


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["hydrostatic39_flow", "thermal_imaging25_flow",
                                  "patchy3d_imaging25_surface_flow"])
def test_flow_block_copies_alike_split_and_straight(cuda, name, monkeypatch):
    """The same photons with the flow sums in a copy a block (a global
    buffer, added into the result once a block), as 2, 3 and 7 sub-ranges of
    ``mesh.split_ids`` launched in turn and merged, and added straight into
    the result (``FLOW_BUF_MAX`` 0): every count, error record and
    ``n_flow_booked`` equal, the flow and Stokes sums within 1e-12 of their
    largest (only the order of the additions moves)."""
    tables, static = KERNEL_CELLS[name](cuda)
    n = gate_photons(tables, static)
    blocks = pool_cuda.launch_blocks(tables, static, n)
    assert pool_cuda.flow_buf(tables.opacity.shape[0], blocks) > 0
    copies = pool_cuda.run_stream_cuda(tables, static, n, SEED)
    for k in (2, 3, 7):
        g = mesh.split_gaps(mesh.run_split(tables, static, n, SEED, k), copies)
        print(f"{name} split {k}: {g}")
        assert g["counts"] == 0 and g["records"] == 0 and g["values"] <= 1e-12, g
    monkeypatch.setattr(pool_cuda, "FLOW_BUF_MAX", 0)
    straight = pool_cuda.run_stream_cuda(tables, static, n, SEED)
    assert int(straight["n_flow_booked"]) == int(copies["n_flow_booked"]) > 0
    g = mesh.split_gaps(straight, copies)
    print(f"{name} block copies against straight adds: {g}")
    assert g["counts"] == 0 and g["records"] == 0 and g["values"] <= 1e-12, g


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["lambert_tau05", "grid3d_2496_flow"])
def test_pool_march_split_equals_one_launch(cuda, name):
    """``pool_march``'s persistent grid on a surface cell and a marching flow
    cell: 2, 3 and 7 sub-ranges launched in turn and merged equal one launch,
    every count, ``n_cell_face``, ``n_flow_booked`` and error record equal,
    the sums within ``mesh.SPLIT_RTOL``."""
    tables, static = KERNEL_CELLS[name](cuda)
    assert pool_cuda.kernel_of(tables, static)[0] == "pool_march"
    n = gate_photons(tables, static)
    one = pool_cuda.run_stream_cuda(tables, static, n, SEED)
    assert int(one["n_cell_face"]) > n
    for k in (2, 3, 7):
        g = mesh.split_gaps(mesh.run_split(tables, static, n, SEED, k), one)
        print(f"{name} split {k}: {g}")
        assert g["counts"] == 0 and g["records"] == 0 and g["values"] <= mesh.SPLIT_RTOL, g


@pytest.mark.gpu
def test_launch_blocks_is_the_marching_kernels_grid(cuda):
    """``launch_blocks`` of a marching configuration is the grid
    ``pool_march`` launches: the blocks the card holds at once, a whole
    number a streaming multiprocessor, fewer for a small launch; a flow
    buffer sized for it is taken, one a block short is refused."""
    tables, static = KERNEL_CELLS["grid3d_2496_flow"](cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    resident = pool_cuda.launch_blocks(tables, static, 1 << 30)
    assert resident % sms == 0 and 1 <= resident // sms <= 8, (resident, sms)
    assert pool_cuda.launch_blocks(tables, static, 1000) == 4
    n = gate_photons(tables, static)
    assert pool_cuda.launch_blocks(tables, static, n) == min(resident, -(-n // pool_cuda.THREADS))
    out = pool_cuda.run_stream_cuda(tables, static, n, SEED)
    assert int(out["n_emitted"]) == n
    fn = pool_cuda.launch_blocks
    try:
        pool_cuda.launch_blocks = lambda *a: fn(*a) - 1
        with pytest.raises(RuntimeError, match="cudaError"):
            pool_cuda.run_stream_cuda(tables, static, n, SEED)
    finally:
        pool_cuda.launch_blocks = fn


@pytest.mark.gpu
def test_split_without_offsets_is_refused(cuda, monkeypatch):
    """A mutant of the split: every rank starts at the chunk's first id."""
    tables, static = KERNEL_CELLS[SPLIT_CELLS[0]](cuda)
    n = gate_photons(tables, static)
    one = pool_cuda.run_stream_cuda(tables, static, n, SEED)
    split_ids = mesh.split_ids
    monkeypatch.setattr(mesh, "split_ids", lambda *a: np.concatenate(
        [split_ids(*a)[:, :2], np.full((a[-1], 1), a[3], np.uint32)], axis=1))
    bad = mesh.run_split(tables, static, n, SEED, 3)
    print(f"mutant [split without offsets]: {mesh.split_gaps(bad, one)}")
    assert not mesh.split_agrees(bad, one)


@pytest.mark.gpu
def test_nccl_mesh_of_one_card_equals_one_launch(cuda, monkeypatch):
    """``run_stream_mesh`` over a one-rank NCCL group is ``run_stream_cuda``."""
    import torch.distributed as dist
    from artes_tpu_torch.parallel import make_mesh, multihost, run_stream_mesh
    from test_torch_mesh import free_port

    for key, value in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", str(free_port())),
                       ("WORLD_SIZE", "1"), ("RANK", "0"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(key, value)
    assert multihost.initialize("nccl", timeout_s=300)
    try:
        m = make_mesh("cuda")
        assert (m.rank, m.size, m.device) == (0, 1, torch.device("cuda", 0))
        tables, static = KERNEL_CELLS["grid3d_2496_flow"](m.device)
        n = gate_photons(tables, static)
        before = mesh.LAUNCHES["mesh"]
        got = run_stream_mesh(tables, static, n, SEED, 0, 0, m)
        assert mesh.LAUNCHES["mesh"] == before + 1
        assert got["detector"].device == m.device
        one = pool_cuda.run_stream_cuda(tables, static, n, SEED)
        g = mesh.split_gaps(got, one)
        assert g["counts"] == 0 and g["records"] == 0 and g["values"] <= mesh.SPLIT_RTOL, g
    finally:
        dist.destroy_process_group()
