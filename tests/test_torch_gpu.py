"""The CUDA kernels on the card, against their plain PyTorch versions.

Needs a CUDA device, nvcc and no JAX; without a card every test skips. On a
machine with a card (which has no JAX, so the JAX-pinning conftest is left
out):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import os
import shutil
import types

import numpy as np
import pytest
import torch

from artes_tpu_torch import _build, cells, config, probe_splat, runner, spans
from artes_tpu_torch.parallel import mesh
from artes_tpu_torch.cells import CELLS, KERNEL_CELLS, gate_photons, spectrum_tables
from artes_tpu_torch.transport import kernel, pool_cuda
from test_torch_gate import FORMER_LIMITS
from torch_threads import one_thread  # noqa: F401

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


# the main path's gate cells: the flagship, the bench's graded grid and
# BASELINE #2's crescent at 177.5 deg
MAIN_PATH_CELLS = ("flagship", "hydrostatic39", "hg_crescent")
MAIN_PATH_SMALL = 1e-3
# how far over its limit a mutant's largest gap must be on each of its cells
MUTANT_MARGIN = 3.0

# Small faults of the kernels, each with the cells whose gate must see it:
# (file under csrc/, text to replace, replacement, cells)
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
    # the jump walk's one pass over the radial faces: shell j - 1's kbar
    # chords weighed with the kbar of the shell above (seen only where kbar
    # steps between shells: not on the Mie deck, whose zone (0, 0) is clear)
    "jump walk chords with the kbar of the shell above": (
        "pool_grid3d.cu", "add_shell(__ldg(G.kbar + j - 1), e_lo,",
        "add_shell(__ldg(G.kbar + j), e_lo,",
        ("grid3d_2496", "blended_5184", "grid3d_thermal")),
    # small faults of the main path, pool_radial <false, false, false>: each
    # moves the flagship's I and Q sums by under MAIN_PATH_SMALL
    "peel matrix angle from a rounded degree": (
        "pool_common.cuh", "acosf(mu) / DEG_F, m);", "acosf(mu) * 57.29f, m);",
        MAIN_PATH_CELLS),
    "zenith CDF without its last row": (
        "pool_common.cuh", "const float target = u3 * cum(N_ANGLE);",
        "const float target = u3 * cum(N_ANGLE - 1);", MAIN_PATH_CELLS),
    "azimuth mirror past a slipped half": (
        "pool_common.cuh", "if (u2 > 0.5f) beta += PI_F;", "if (u2 > 0.5002f) beta += PI_F;",
        MAIN_PATH_CELLS),
    "stellar beam short of the limb": (
        "pool_common.cuh", "const float r_disk = sqrtf(u1);",
        "const float r_disk = 0.9999f * sqrtf(u1);", MAIN_PATH_CELLS),
    # hg_crescent's tallies do not move under it at seed 7 (no count, Stokes I
    # by 4e-10), so only the two cells that see it are named
    "roulette at twice its threshold": (
        "pool_radial.cu", "if (d[0] < S.fstop) {", "if (d[0] < 2.0f * S.fstop) {",
        ("flagship", "hydrostatic39")),
    "roulette weight on conservative scatterings": (
        "pool_radial.cu", "alb / (1.0f - S.fstop) : 1.0f;",
        "alb / (1.0f - S.fstop) : 1.0f / (1.0f - S.fstop);", ("flagship", "hydrostatic39")),
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
    refuse it on every cell named for the fault, its largest gap at least
    ``MUTANT_MARGIN`` times its limit. Each reading also prints the verdict
    of the former limits (``test_torch_gate.FORMER_LIMITS``); a main-path
    fault must move the flagship's I and Q sums by under ``MAIN_PATH_SMALL``."""
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
        ratio = pool_cuda.worst_ratio(g, limits)
        old = FORMER_LIMITS[kernel.walk_mode(tables, static)]
        verdict = "pass" if pool_cuda.agrees(g, old) else "refuse"
        print(f"mutant [{fault}] on {name}: largest gap / limit {ratio:.4g}, gaps over their "
              f"limits {over}; the former limits: {verdict} (largest gap / limit "
              f"{pool_cuda.worst_ratio(g, old):.4g}); stokes {g['stokes']}, count {g['count']:.4g}")
        assert ratio >= MUTANT_MARGIN, f"{fault} passes the gate on {name} by a margin: {g}"
        if name == "flagship":                  # only main-path faults name it
            assert max(g["stokes"][:2]) < MAIN_PATH_SMALL, f"{fault} is not small: {g}"


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


# the instantiations the benchmark's cells run: the radial kernel's stellar
# spectrum and image, the 3-D kernel's image (the Mie deck), the marching
# kernel's stellar spectrum over a surface (the Lambert layer) on a radial and
# a 3-D grid, and one of its flow instantiations
LANE_CELLS = {"flagship": 1 << 22, "imaging25": 1 << 20, "mie_patchy_imaging25": 1 << 18,
              "lambert_tau05": 1 << 20, "grid3d_2496_surface": 1 << 16,
              "grid3d_2496_flow": 1 << 16}
TALLY_KEYS = ("detector", "flux_emitted", "flux_exit", "n_error", "error_codes",
              "n_stokes_anomaly", "n_alive_at_cap", "n_emitted", "n_error_records")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(LANE_CELLS))
def test_lane_counters_change_no_tally(cuda, name):
    """A launch with its lane counters on (recorded) against the same launch
    with them off: every count and error record equal, every sum equal or,
    where the blocks' atomic double additions land in another order (as in
    two launches with the counters off), within ``mesh.SPLIT_RTOL``; the
    refill branch's lanes are the photons emitted plus the threads launched
    (each thread's last pass finds no photon); no pass counts more than 32
    lanes; the radial kernel's stellar image counts none. The deck's 3-D
    kernel also counts its jump walks, at least one a photon (its prewalk),
    every one read from its table of phi crossings; the other two kernels
    count none."""
    tables, static = KERNEL_CELLS[name](cuda)
    n = LANE_CELLS[name]
    off = pool_cuda.run_stream_cuda(tables, static, n, SEED)
    with spans.recording() as rec:
        on = pool_cuda.run_stream_cuda(tables, static, n, SEED)
    again = pool_cuda.run_stream_cuda(tables, static, n, SEED)
    (launch,) = [s for s in rec.spans if s.name == "launch"]
    a = launch.attrs

    def same(x, y):
        return [k for k in TALLY_KEYS
                if torch.equal(torch.as_tensor(x[k]).cpu(), torch.as_tensor(y[k]).cpu())]

    print(f"lanes [{name}]: {a}; bit-equal, on and off: {same(on, off)}; off twice: "
          f"{same(again, off)}; sums, on and off: {mesh.split_gaps(on, off)['values']:.3e}, "
          f"off twice: {mesh.split_gaps(again, off)['values']:.3e}")
    g = mesh.split_gaps(on, off)
    assert g["counts"] == 0 and g["records"] == 0 and g["values"] <= mesh.SPLIT_RTOL, g
    assert a["kernel"] == pool_cuda.kernel_of(tables, static)[1]
    assert a["photons_emitted"] == n == int(on["n_emitted"])
    assert a["blocks"] == pool_cuda.launch_blocks(tables, static, n)
    assert a["device_ms"] > 0 and a["rounds"] == int(on["detector"][:, 1, 2].sum())
    if a["kernel"] == "image":                    # pool_radial.cu::CountsLanes
        assert not set(pool_cuda.LANE_KEYS) & set(a)
    else:
        assert a["refill_lanes"] == a["photons_emitted"] + a["blocks"] * pool_cuda.THREADS
        assert a["refill_lanes"] <= 32 * a["refill_passes"]
        assert 0 < a["round_lanes"] <= 32 * a["round_passes"]
    if a["source"] == "pool_grid3d":
        assert a["jump_walks"] >= a["photons_emitted"]
        assert a["jump_walks_tabled"] == a["jump_walks"]
    else:
        assert not set(pool_cuda.WALK_KEYS) & set(a)


# the marching kernel's cells: radial and 3-D grids over a surface, stellar and
# thermal, spectrum and image, and a 3-D grid with flow
MARCH_FACE_CELLS = ("lambert_tau05", "lambert_imaging25", "thermal_surface",
                    "grid3d_2496_surface", "grid3d_2496_flow")


@pytest.mark.gpu
@pytest.mark.parametrize("name", MARCH_FACE_CELLS)
def test_launch_span_carries_cell_face(cuda, name):
    """A recorded ``pool_march`` launch's span carries ``cell_face``, the
    kernel's own count of its ``cell_face`` passes: the result's
    ``n_cell_face``, more than one a photon; the other kernels' spans carry
    none."""
    tables, static = KERNEL_CELLS[name](cuda)
    n = gate_photons(tables, static)
    with spans.recording() as rec:
        out = pool_cuda.run_stream_cuda(tables, static, n, SEED)
        flagship = pool_cuda.run_stream_cuda(*KERNEL_CELLS["flagship"](cuda), 1 << 16, SEED)
    march, radial = [s.attrs for s in rec.spans if s.name == "launch"]
    print(f"cell_face [{name}]: {march['cell_face']} passes, {n} photons")
    assert march["source"] == "pool_march" and radial["source"] == "pool_radial"
    assert march["cell_face"] == int(out["n_cell_face"]) > n
    assert "cell_face" not in radial and flagship["n_cell_face"] is None


# the radial kernel's stellar spectrum (the spectrum cells), BASELINE #2's deck
# at 177.5 degrees (the phase curve's crescent), and the stellar image, which
# counts no lanes but stamps its drain
DRAIN_CELLS = {"flagship": 1 << 22, "hg_crescent": 1 << 20, "imaging25": 1 << 20}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(DRAIN_CELLS))
def test_drain_stamps_change_no_tally(cuda, name, monkeypatch):
    """``pool_radial``'s drain stamps: a recorded launch against the same
    launch unrecorded, counts and error records equal and sums within 1e-14;
    the recorded span's ``drain_ms`` within [0, ``device_ms``]; unrecorded,
    the kernel is given no counter buffer and nothing is stamped."""
    tables, static = KERNEL_CELLS[name](cuda)
    n = DRAIN_CELLS[name]
    buffers = []
    library = pool_cuda._library

    def spy(source, lib=None):
        cdll = library(source, lib)
        launch = getattr(cdll, f"artes_{source}_launch")

        def counted(args, stream):
            buffers.append(args._obj.counters)  # the counters' pointer of the PoolLaunch
            return launch(args, stream)
        return types.SimpleNamespace(**{f"artes_{source}_launch": counted,
                                        f"artes_{source}_blocks":
                                        getattr(cdll, f"artes_{source}_blocks")})

    monkeypatch.setattr(pool_cuda, "_library", spy)
    off = pool_cuda.run_stream_cuda(tables, static, n, SEED)
    with spans.recording() as rec:
        on = pool_cuda.run_stream_cuda(tables, static, n, SEED)
    (launch,) = [s for s in rec.spans if s.name == "launch"]
    a = launch.attrs
    g = mesh.split_gaps(on, off)
    print(f"drain [{name}]: {a['drain_ms']:.4f} of {a['device_ms']:.4f} ms; sums, on and off: "
          f"{g['values']:.3e}")
    assert g["counts"] == 0 and g["records"] == 0 and g["values"] <= 1e-14, g
    assert a["source"] == "pool_radial" and 0.0 <= a["drain_ms"] <= a["device_ms"]
    assert buffers[0] is None and buffers[1] is not None
    layout, flat_f, flat_i = off["packed"]
    assert not pool_cuda.tally_views(layout, flat_f, flat_i)["lanes"].any()


@pytest.mark.gpu
def test_device_ms_is_the_profilers_kernel_time(cuda):
    """The launch span's CUDA-event time within 2% of the profiler's kernel
    time, one launch of 2^24 photons on the flagship."""
    from torch.profiler import ProfilerActivity, profile

    tables, static = KERNEL_CELLS["flagship"](cuda)
    pool_cuda.run_stream_cuda(tables, static, 1 << 20, SEED)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof, spans.recording() as rec:
        pool_cuda.run_stream_cuda(tables, static, 1 << 24, SEED)
        torch.cuda.synchronize()
    (kern,) = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA
               and "pool_radial_kernel" in e.name()]
    (launch,) = [s for s in rec.spans if s.name == "launch"]
    ratio = launch.attrs["device_ms"] / (kern.duration_ns() * 1e-6)
    print(f"device_ms {launch.attrs['device_ms']:.4f} against the profiler's "
          f"{kern.duration_ns() * 1e-6:.4f} ms: {ratio:.5f}")
    assert abs(ratio - 1.0) <= 0.02


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["flagship", "mie_patchy_imaging25"])
def test_cuda_only_profiler_records_jobs_on_its_clock(cuda, name):
    """A job under a CUDA-only profiler session (the benchmark's traced
    window) records its spans; the kernel's interval in the trace starts after
    its ``launch`` span starts and ends before its chunk's ``wait`` ends,
    within 20 us."""
    from torch.profiler import ProfilerActivity, profile

    atm = cells.mie_patchy_deck()[0] if name != "flagship" else cells.flagship()
    cfg = config.ArtesConfig()
    cfg.mode, cfg.npix = ("spectrum", 1) if name == "flagship" else ("imaging_mono", 25)
    det = config.detector_setup(cfg, float(atm.rfront[-1]))
    runner.run_wavelength(atm, cfg, det, 0, 1 << 16, device="cuda")      # warm
    spans.take()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        runner.run_wavelength(atm, cfg, det, 0, 1 << 20, device="cuda")
    kept = spans.take()
    by = {s.name: s for s in kept}
    assert {"job", "tables", "tables.cells", "chunk", "launch", "wait", "accumulate",
            "finish"} <= set(by)
    assert by["job"].attrs["path"] == "kernel" and by["job"].attrs["launches"] == 1
    (kern,) = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA
               and "pool_" in e.name() and "_kernel" in e.name()]
    chunk_wait = next(s for s in kept if s.name == "wait" and s.parent == by["chunk"].id)
    start, end = kern.start_ns(), kern.start_ns() + kern.duration_ns()
    print(f"[{name}] kernel {start - by['launch'].start} ns after the launch span's start, "
          f"{chunk_wait.end - end} ns before the wait's end")
    assert start >= by["launch"].start - 20_000 and end <= chunk_wait.end + 20_000
