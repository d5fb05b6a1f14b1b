"""Smoke run of the PyTorch/CUDA port (``artes_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero before the result lines:

1. env: torch, CUDA, nvcc, the card's name and power limit;
2. build: compiles ``artes_tpu_torch/csrc/pool_radial.cu``,
   ``pool_grid3d.cu``, ``pool_march.cu`` and ``probe_splat.cu`` with nvcc
   and the host programs ``native/mie/mie.cc`` (the Mie solver) and
   ``native/fits/fitsread.cc`` (the FITS reader) with g++, all at once, and
   prints the ptxas registers and spills of every kernel instantiation;
3. kernel vs plain: every instantiation of the three pool kernels (stellar,
   thermal, image, thermal image; radial, 3-D and marching; with and without
   flow) against its plain PyTorch version on the card, seed 7, float32, on
   the cells of ``cells.KERNEL_CELLS``. Radial cells at 2^20 photons (flagship, nr=39
   graded grid, 25x25 and 101x101 images, the bench's thermal shell with
   isotropic and biased emission, the scattering thermal shell as spectrum
   and 25x25 image, crescent with an off-axis star) within
   ``pool_cuda.AGREE``; 3-D cells at 2^18 photons, which the plain version's
   cell-by-cell march affords (the bench's 39 x 8 x 8 patchy deck as
   spectrum and 25x25 image, a self-luminous patchy 3-D grid as spectrum and
   25x25 image, the 2 x 3 x 4 patchy grid, a grid of 5,184 cells each with
   its own blend of two species, BASELINE #4's Mie cloud deck as a 25x25
   image) within ``pool_cuda.AGREE_3D``:
   counts per count column, per-pixel I and counts, the Stokes sums and
   squares, the capped photons, both fluxes, the abandoned photons and the
   per-code error counts. Lambert surfaces and flow diagnostics: the thin
   Rayleigh layer over a white surface as spectrum and (albedo 0.8) 25x25
   image and the half-scattering thermal shell over a surface as spectrum
   and image at 2^20 photons; a five-shell layer of tau = 16 over a white
   surface, whose photons scatter on to the default cap of 256 orders; the
   nr=39 grid and the 39 x 8 x 8 deck over a surface of albedo 0.5
   (scattering orders cut at ``cells.SURFACE_MAX_SCATTER``: the plain
   version's time grows with the orders), the deck and the self-luminous 3-D grid
   with both flow outputs, the 2 x 3 x 4 grid imaged over a surface with
   flow, and the self-luminous 3-D grid imaged over a surface with flow, at
   2^16 photons (the plain version marches every walk cell by cell), all
   within ``pool_cuda.AGREE_MARCH``; the closed-form flow hook on the nr=39
   grid, the scattering thermal shell and their 25x25 images at 2^20
   photons within ``pool_cuda.AGREE``, the two flow arrays included; the
   runtime flags: ``--debug-stokes`` on a Rayleigh layer whose matrix drives
   Q above I (error 050) through each of the three kernels, and
   ``photon:scattering=off`` on the flagship and the 2 x 3 x 4 grid, the
   photons abandoned on an anomaly among the gaps;
4. probe splat: the splat micro-benchmark kernel at 625, 2025 and 10201
   pixels and its loop-only baseline against their plain versions
   (counts equal, values within ``probe_splat.VALUE_RTOL``), the splat's
   cost a round net of the loop (both on the same grid, each a slope over
   its rounds), the latency of the loop's step and the chain's bound, and
   the library's calls for the same sums: one ``index_add_`` of the
   materialised peels' values, and with a second ``index_add_`` of their
   counts;
   xla paths (:func:`phase_xla_paths`): ``kernel.run_batch`` at 2^16
   photons on the flagship, the 39 x 8 x 8 deck, the Lambert layer and the
   nr=39 grid with flow against the plain pool on the same photons (counts
   equal, sums within ``BATCH_RTOL``), and at each cell's gate photons
   against the kernel within its gate; the CLI's ``demo`` with ``--f64`` on the card and on the CPU at
   2^14 photons (wall times; counts equal, sums within
   ``runner.F64_DEVICE_RTOL``, a photon that parts named by id); the phase
   prints its duration;
5. anchors, through the kernels: (a) the flagship at 2^27 photons with the
   ids and seed of the recorded TPU run (BENCH_r05.json ``detector_I_raw``
   = 6354867.5): I within 2e-3, no photon at the scattering cap; (b) the
   25x25 image at 2^24 photons summed over its pixels equals the spectrum
   of the same photons (counts within 4, I within 1e-6); (c) a transparent
   isothermal shell gives V kappa B / d^2 within 2% at 2^24 photons; (d)
   the phase curve of a thin Rayleigh shell at 2^24 photons an angle
   follows single scattering, (4/3) k P11(180 - alpha) within 5% and -Q/I
   within 0.05 of sin^2 / (1 + cos^2), for alpha <= 160 deg; (e) a 3-D
   grid whose 30 cells all hold the flagship's opacity gives the
   flagship's spectrum at 2^24 photons within Monte Carlo noise (I per
   photon within ``UNIFORM_3D_REL``), abandoning at most
   ``UNIFORM_3D_ERRORS`` of its photons; (f) the Lambert sphere: a
   transparent shell over a white surface at full phase has I / norm = 2/3
   within 1% and |Q/I| < 2e-3 at 2^24 photons; (g) in a thermal run with
   flow over a surface, the energy crossing the top shell's outer face
   (``flow_theta[nr-1, :, :, 0]``) is ``flux_exit`` within 2e-5 (in float32 a
   photon within rounding of the outer face leaves without a step to book);
6. opacity chains: both FITS readers (``io.fitsio.read_fits`` and the
   native ``read_fits_native``) timed on the 119.6 MB ``atmosphere.fits`` of
   the 5,184-cell grid, same arrays; then ``python -m
   artes_tpu_torch.baselines 4`` and ``3``, one process each: BASELINE #4's
   Mie cloud image at 2^24 photons within ``baselines.LIMITS_4`` of
   BASELINE4.json (its abandoned photons reported by code beside the
   record's) and its kernel against its plain version at 2^16 photons, and
   BASELINE #3's molecular thermal spectrum, 45 wavelengths of 2e7 photons,
   each within the conservation rule of ``baselines.unscattered_oracle_flux``
   and none abandoned;
7. mesh: (a) the flagship, the 39 x 8 x 8 deck, the nr=39 grid with flow,
   the 25x25 image and the self-luminous 3-D grid imaged over a surface with
   flow, each at its gate photons as one launch and as 2, 3 and 7 sub-ranges
   of ``mesh.split_ids`` launched in turn on the card and merged
   (``mesh.run_split``): every count and error record equal, the sums within
   ``mesh.SPLIT_RTOL``; (b) the mesh launch measured over every visible card
   (one spawned process a card, NCCL): the flagship at 2^20 photons through
   ``run_stream_mesh`` against one launch on one card (counts and records
   equal), the reduction alone, one NCCL ``all_reduce`` of its payload, the
   plain version of the same split, and ``sharded_dispatch`` of 2^14
   photons against one ``run_batch`` on one card (counts and records equal,
   sums within ``mesh.SPLIT_RTOL``);
8. main path: ``python -m artes_tpu_torch.cli`` as a user runs it, one
   process each, 2^24 photons: spectrum on the README quick-start input
   and on the nr=39 grid, a 25x25 image of the quick-start input, its
   73-angle phase curve, a thermal spectrum of the bench's thermal shell
   and a thermal 25x25 image of the scattering thermal shell; on 3-D
   grids the spectrum and the 25x25 image of the 39 x 8 x 8 patchy deck
   and of the self-luminous patchy grid, with ``error.log`` read back when
   photons were abandoned; with a Lambert surface and with flow, at 2^24
   photons the quick-start input over a surface of albedo 0.5, the nr=39
   grid with both flow outputs and the 39 x 8 x 8 deck over a surface with
   both flow outputs, and at 2^22 photons one run for each other surface
   or flow instantiation, one with ``--debug-stokes`` on the layer that
   drives Q above I and one with ``photon:scattering=off`` on the
   self-luminous 3-D grid (its birth peels alone reach the detector; three
   processes at a time), each checked for its
   launch, its ``spectrum.dat``
   or ``stokes.fits``, its ``flow_global.fits`` (unit vectors where not
   zero) and ``flow_latitudinal.fits``, and its ``error.log``; with
   ``--mesh`` over every visible card (one spawned worker a card, NCCL) the
   quick-start spectrum at 2^24 photons and the 39 x 8 x 8 deck as a 25x25
   image over a surface with both flow outputs at 2^22 photons, each
   against the same command on one card: every file equal (values within
   ``MESH_CLI_RTOL`` of their array's largest, ``error.log`` byte for
   byte) and one launch a rank; then
   ``python -m artes_tpu_torch.probe_splat``,
   the splat micro-benchmark's own entry point. Each process starts with
   its launch counts at 0 and prints them at its end; every kernel must
   have been launched. The kernels line adds the chains' launches (phase 6)
   to the rows of ``thermal`` and ``grid3d_image``.

Each kernel's bound is the larger of its bytes (every table read once, every
tally written once) over 3.35 TB/s and a lower count of its float32
operations over 67 TFLOP/s (``bound_ms``); a marching kernel's count holds
the ``cell_face`` passes the run made and a flow kernel's the bookings it
made, which the kernels tally. The mesh launch's bound is a rank's share
of the flagship's operations, every table read once on each card, plus
the reduction's payload over NVLink (450 GB/s each way) where there is more
than one card; its library call is one NCCL ``all_reduce`` of that payload.
It then prints the card line, a JSON line of the kernels and, last,
``{"ok": true, "device": {...}}``. Nothing runs without a CUDA device.
``python3 chip_smoke.py --mesh`` runs phases 1, 2 and 7 and the ``--mesh``
CLI runs alone, over every visible card, and prints the mesh's row.
"""

import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_R05_DETECTOR_I_RAW = 6354867.5     # BENCH_r05.json, TPU v5e, 2^27 photons, seed 12
SMOKE_PHOTONS = 1 << 24
POOL_REPLACES = "artes_tpu/transport/pallas_stream.py:2049"
# the cell whose kernel and plain times stand for each instantiation
VARIANT_CELL = {"stellar": "flagship", "thermal": "thermal_iso", "image": "imaging25",
                "thermal_image": "thermal_imaging25", "grid3d_stellar": "grid3d_2496",
                "grid3d_thermal": "grid3d_thermal", "grid3d_image": "grid3d_imaging25",
                "grid3d_thermal_image": "grid3d_thermal_imaging25",
                "stellar_flow": "hydrostatic39_flow", "thermal_flow": "thermal_flow",
                "image_flow": "imaging25_flow", "thermal_image_flow": "thermal_imaging25_flow",
                "march_stellar": "lambert_tau05", "march_thermal": "thermal_surface",
                "march_image": "lambert_imaging25",
                "march_thermal_image": "thermal_surface_imaging25",
                "march_stellar_flow": "grid3d_2496_flow",
                "march_thermal_flow": "grid3d_thermal_flow",
                "march_image_flow": "patchy3d_imaging25_surface_flow",
                "march_thermal_image_flow": "grid3d_thermal_surface_flow"}
KERNEL_SOURCE = {"pool_radial": "artes_tpu_torch/csrc/pool_radial.cu",
                 "pool_grid3d": "artes_tpu_torch/csrc/pool_grid3d.cu",
                 "pool_march": "artes_tpu_torch/csrc/pool_march.cu"}
PROBE_SIZES = (625, 2025, 10201)
MAIN_PATH_PHOTONS_SMALL = 1 << 22
MAIN_PATH_TOGETHER = 3          # CLI processes of the main path's runs at a time
PLAIN_TOGETHER = 3              # plain versions at a time in phase 3 (each bound by its launches)
# anchor (e): |I_3D / I_flagship - 1| per photon and the abandoned share, at
# 2^24 photons (NVIDIA H100 80GB HBM3, 700 W; readings in PERF.md section 6)
UNIFORM_3D_REL = 1.0e-3
UNIFORM_3D_ERRORS = 1.0e-4
# peaks of one H100 SXM (NVIDIA's data sheet): device memory, float32
# outside the tensor cores, NVLink each way
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67.0e12
NVLINK_BYTES_S = 450e9
# the mesh launch: the cells split over sub-ranges on one card, the splits,
# the photons of the measured mesh, how far a --mesh CLI run's files may
# stray from one card's (the order of double additions only)
MESH_REPLACES = "artes_tpu/transport/pallas_stream.py:2391"
MESH_CELLS = ("flagship", "grid3d_2496", "hydrostatic39_flow", "imaging25",
              "grid3d_thermal_surface_flow")
MESH_SPLITS = (2, 3, 7)
MESH_PROBE_PHOTONS = 1 << 20
MESH_CLI_RTOL = 1e-9
# the XLA paths: the batch transport's cells and photons, how far its sums
# may stray from the plain pool's on the same photons (the order of the
# card's atomic adds only), the photons of the sharded dispatch and of the
# float64 CLI run, and how far float64 on the card may stray from the CPU
XLA_CELLS = ("flagship", "grid3d_2496", "lambert_tau05", "hydrostatic39_flow")
XLA_PHOTONS = 1 << 16
BATCH_RTOL = 1e-6
SHARDED_PHOTONS = 1 << 14
F64_PHOTONS = 1 << 14


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def _smi(query, nounits=False):
    """The first card's ``nvidia-smi --query-gpu=<query>`` line."""
    proc = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader" + (",nounits" if nounits else "")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        fail(f"nvidia-smi: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def card_line():
    return _smi("name,power.limit")


def timed(fn, reps):
    """Median wall time [ms] of ``fn`` on the card (CUDA events), and its last result."""
    import torch
    times, out = [], None
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return sorted(times)[len(times) // 2], out


def phase_env():
    import torch
    say("env", f"python {sys.version.split()[0]} torch {torch.__version__} "
               f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
               f"count {torch.cuda.device_count()}")
    from artes_tpu_torch import _build
    proc = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True, text=True)
    say("env", "nvcc " + proc.stdout.strip().splitlines()[-1])
    say("env", "card " + card_line())


def phase_build():
    from artes_tpu_torch import _build
    names = ("pool_radial", "pool_grid3d", "pool_march", "probe_splat")
    hosts = tuple(_build.HOST_BUILDS)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names) + len(hosts)) as ex:   # one compiler a source, all at once
        built = [ex.submit(_build.build, n) for n in names] \
            + [ex.submit(_build.build_host, n) for n in hosts]
        paths = dict(zip(names, (f.result() for f in built)))
        host_paths = dict(zip(hosts, (f.result() for f in built[len(names):])))
    say("build", f"{', '.join(n + '.cu' for n in names)} (nvcc) and "
                 f"{', '.join(_build.HOST_BUILDS[n][0] for n in hosts)} (g++) built in "
                 f"{time.perf_counter() - t0:.1f} s")
    for name, path in host_paths.items():
        say("build", f"{name} -> {os.path.relpath(path, HERE)}")
    for name, path in paths.items():
        say("build", f"{name} -> {os.path.relpath(path, HERE)}")
        with open(path + ".log") as fh:
            for line in fh:
                if "entry function" in line or "registers" in line or "spill" in line:
                    say("build", "ptxas " + line.strip())


def bound(n_bytes, n_ops):
    """``(bound_ms, bound_by)``: the least time the card could take to move
    ``n_bytes`` and do ``n_ops`` float32 operations."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S * 1e3, n_ops / PEAK_F32_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


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


def pool_bound(tables, static, out):
    """``(bound_ms, bound_by)`` of one pool-kernel launch (:func:`pool_work`)."""
    return bound(*pool_work(tables, static, out))


def pool_work(tables, static, out):
    """``(bytes, operations)`` of one pool-kernel launch from what this run
    needed. Bytes: every
    table once, every tally once. Operations, a lower count from the run's
    own tallies: every emitted photon is born and walks its path once; every
    booked scatter peel is one scattering round with its peel walk and, on a
    3-D grid, the path total that its march is checked against (a round
    whose peel is rejected, the march itself and the integer hashes of the
    draws are left out). A radial walk
    takes the roots of nr + 1 faces twice (in, out) and 3 operations a
    segment; a 3-D jump walk adds the root pair of every cone face and the
    crossing of every phi half-plane. A marching kernel's walks are the
    ``cell_face`` passes it counted. Flow costs what the kernel counted: the
    passes (marching) or walked segments (closed form) that booked."""
    import torch
    g = tables.grid
    tensors = [v for v in vars(tables).values() if isinstance(v, torch.Tensor)]
    tensors += [v for v in vars(g).values() if isinstance(v, torch.Tensor)]
    if tables.jump is not None:        # built for the jump walks only
        tensors += [v for v in vars(tables.jump).values() if isinstance(v, torch.Tensor)]
    from artes_tpu_torch.transport import kernel
    mode = kernel.walk_mode(tables, static)
    npix = static.nx * static.ny
    ncell = tables.opacity.shape[0]
    n_bytes = sum(t.numel() * t.element_size() for t in tensors) + 8 * (10 + 10) \
        + (npix * 8 * (8 + 2) if npix > 1 else 0) + (ncell * 7 * 8 if static.track_flow else 0)
    rounds = int(out["detector"][:, 1, 2].sum())
    emitted = int(out["n_emitted"])
    booked = int(out["n_flow_booked"]) if static.track_flow else 0
    if mode == "march":
        face = 2 * OPS_ROOT + OPS_SELECT + (2 * OPS_CONE if g.ntheta > 1 else 0) \
            + (2 * OPS_PHI if g.nphi > 1 else 0)
        n_ops = emitted * OPS_EMIT + rounds * OPS_ROUND + int(out["n_cell_face"]) * face \
            + booked * OPS_FLOW_PASS
        return n_bytes, n_ops
    walk = 2 * (g.nr + 1) * OPS_ROOT + 2 * g.nr * 3
    walks_a_round = 1
    if mode == "jumps":
        walk += (g.ntheta - 1) * OPS_CONE + g.nphi * OPS_PHI
        walks_a_round = 2
    n_ops = emitted * (OPS_EMIT + walk) + rounds * (OPS_ROUND + walks_a_round * walk) \
        + booked * OPS_FLOW_SEGMENT
    return n_bytes, n_ops


def _plain_run(name, seed):
    """A cell's plain version in a worker process: its time [ms] and its
    result on the host."""
    import torch
    from artes_tpu_torch.cells import KERNEL_CELLS, gate_photons
    from artes_tpu_torch.transport import kernel
    tables, static = KERNEL_CELLS[name]("cuda")
    n = gate_photons(tables, static)
    ms, out = timed(lambda: kernel.run_stream(tables, static, n, seed, n), 1)
    return ms, {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in out.items()}


def phase_kernel_vs_plain():
    """Each cell's kernel against its plain version; fails at the first cell
    that disagrees, else returns per-cell rows. The kernels are timed first,
    alone on the card; then the plain versions, which are bound by their
    launches on the host, run ``PLAIN_TOGETHER`` processes at a time."""
    import torch
    from artes_tpu_torch.cells import KERNEL_CELLS, gate_photons
    from artes_tpu_torch.transport import kernel, pool_cuda
    seed = 7
    timed_k = {}
    for name in KERNEL_CELLS:
        tables, static = KERNEL_CELLS[name]("cuda")
        n = gate_photons(tables, static)
        pool_cuda.run_stream_cuda(tables, static, n, seed)          # warm-up
        ms, out_k = timed(lambda: pool_cuda.run_stream_cuda(tables, static, n, seed), 5)
        timed_k[name] = dict(mode=kernel.walk_mode(tables, static), n=n, static=static,
                             limits=pool_cuda.limits_of(tables, static),
                             variant=pool_cuda.kernel_of(tables, static)[1], ms=ms, out=out_k,
                             bound=pool_bound(tables, static, out_k))
    rows = {}
    ex = ProcessPoolExecutor(PLAIN_TOGETHER, mp_context=torch.multiprocessing.get_context("spawn"))
    try:
        plain = {name: ex.submit(_plain_run, name, seed) for name in KERNEL_CELLS}
        for name in KERNEL_CELLS:
            c = timed_k[name]
            mode, n, static, limits, variant, ms, out_k = (
                c[k] for k in ("mode", "n", "static", "limits", "variant", "ms", "out"))
            bound_ms, bound_by = c["bound"]
            plain_ms, out_p = plain[name].result()
            dk, dp = out_k["detector"].double().cpu(), out_p["detector"].double().cpu()
            g = pool_cuda.gaps(out_k, out_p)
            max_abs = float((dk[..., 0] - dp[..., 0]).abs().max())
            tot_k, tot_p = dk.sum(0), dp.sum(0)
            say("kernel-vs-plain",
                f"{name} [{variant}, {dk.shape[0]} px]: N (I row) kernel {int(tot_k[0, 2])} "
                f"plain {int(tot_p[0, 2])}, N (Q/U/V rows) kernel {int(tot_k[1, 2])} plain "
                f"{int(tot_p[1, 2])}; capped kernel {int(out_k['n_alive_at_cap'])} plain "
                f"{int(out_p['n_alive_at_cap'])}; abandoned kernel {int(out_k['n_error'])} "
                f"{out_k['error_codes'].tolist()} plain {int(out_p['n_error'])} "
                f"{out_p['error_codes'].tolist()}; flux emitted "
                f"{float(out_k['flux_emitted']):.7g} / "
                f"{float(out_p['flux_emitted']):.7g}, exit {float(out_k['flux_exit']):.7g} / "
                f"{float(out_p['flux_exit']):.7g}; gaps "
                + " ".join(f"{k}={v:.3e}" if isinstance(v, float) else
                           f"{k}=" + ",".join(f"{x:.3e}" for x in v) for k, v in g.items())
                + "; plain sums (I,Q,U,V) " + " ".join(f"{x:.7g}" for x in tot_p[:, 0].tolist())
                + f"; max|dIQUV| {max_abs:.6g}; kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
                f"bound {bound_ms:.4f} ms by {bound_by} ({n} photons"
                + (f", {int(out_k['n_cell_face'])} cell_face passes" if mode == "march" else "")
                + (f", {int(out_k['n_flow_booked'])} flow bookings" if static.track_flow else "")
                + ")")
            if not (dk.isfinite().all() and pool_cuda.agrees(g, limits)):
                fail(f"kernel disagrees with its plain version on {name} (limits {limits})")
            # every abandoned photon leaves a record, but for failed birth peels;
            # a failed scatter peel leaves one unless its round's march failed too
            n_err, n_rec = int(out_k["n_error"]), int(out_k["n_error_records"])
            peel = int(out_k["error_codes"][3])
            if not (n_err - peel <= n_rec <= n_err + peel) or \
                    len(out_k["error_records"]) != min(n_rec, 2 * kernel.ERR_RECORD_K):
                fail(f"{name}: {n_err} photons abandoned, {peel} peel walks failed, but "
                     f"{n_rec} error records")
            rows[name] = dict(variant=variant, ms=ms, plain_ms=plain_ms, max_abs_err=max_abs,
                              bound_ms=bound_ms, bound_by=bound_by)
    finally:
        ex.shutdown(cancel_futures=True)        # after a failure, start no other plain version
    return rows


def phase_probe():
    import torch
    from artes_tpu_torch import probe_splat as P
    dev = torch.device("cuda")
    rows = {}
    for npix in PROBE_SIZES:
        (vals, counts), (ref_vals, ref_counts) = (
            P.splat(npix, device=dev), P.splat_plain(npix, device=dev))
        rel = float(((vals - ref_vals).abs() / ref_vals.abs().clamp_min(1e-300)).max())
        if not (torch.equal(counts, ref_counts) and rel <= P.VALUE_RTOL):
            fail(f"probe_splat disagrees with its plain version at {npix} px: counts equal "
                 f"{torch.equal(counts, ref_counts)}, value rel {rel:.3e}")
        rows[npix] = dict(max_abs_err=float((vals - ref_vals).abs().max()))
    sink, ref_sink = P.baseline(device=dev), P.baseline_plain(device=dev)
    if not torch.equal(sink, ref_sink):
        fail("probe_splat baseline disagrees with its plain version")
    base_err = float((sink - ref_sink).abs().max())
    base_us, net_us = P.us_per_round(PROBE_SIZES)
    base_ms = base_us * P.N_ROUNDS * 1e-3
    # the loop is a chain of dependent steps in each lane: its least time is
    # the chain's length times one step's latency, measured by clock64, at
    # the card's highest SM clock
    step_cycles = P.chain_cycles()
    sm_mhz = float(_smi("clocks.max.sm", nounits=True))
    chain_ms = P.N_ROUNDS * step_cycles / sm_mhz * 1e-3
    base_plain_ms, _ = timed(lambda: P.baseline_plain(device=dev), 1)
    peels = P.N_ROUNDS * P.LANES
    for npix in PROBE_SIZES:
        plain_ms, _ = timed(lambda: P.splat_plain(npix, device=dev), 1)
        # bytes: the outputs once (the inputs are three scalars); operations:
        # one add a feature a peel
        bound_ms, bound_by = bound(npix * 8 * (P.NVALS + P.NCNT), peels * (P.NVALS + P.NCNT))
        rows[npix].update(ms=(net_us[npix] + base_us) * P.N_ROUNDS * 1e-3, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
        say("probe", f"npix {npix}: splat {net_us[npix]:.4f} us/round net of the loop "
                     f"({P.LANES} peels a round, {P.NVALS} value + {P.NCNT} count atomics "
                     f"each); kernel {rows[npix]['ms']:.3f} ms, plain {plain_ms:.1f} ms for "
                     f"{P.N_ROUNDS} rounds; counts equal, max|dvalue| "
                     f"{rows[npix]['max_abs_err']:.3g}; bound {bound_ms:.4f} ms by {bound_by}")
    # the library's calls for the same sums, the peels materialised first
    # (the kernel never stores them): one index_add_ of their value features
    # (library_ms), and with a second one of their counts, the same function
    # as the kernel (library_counts_ms)
    for npix in PROBE_SIZES:
        values_ms, counts_ms = P.library_yardsticks(npix)
        rows[npix].update(library_ms=values_ms, library_counts_ms=counts_ms)
        say("probe", f"npix {npix}: one index_add_ of the {peels} "
                     f"materialised peels' values {values_ms:.3f} ms, with a second of their "
                     f"counts {counts_ms:.3f} ms")
    say("probe", "launches in this phase: "
                 + " ".join(f"{k}={v}" for k, v in P.LAUNCHES.items()))
    # the loop alone: one multiply-add a lane a round, 8 bytes a lane out
    bound_ms, bound_by = bound(8 * P.LANES, 2 * peels)
    base_n = P.N_ROUNDS * P.BASE_SPAN
    say("probe", f"baseline loop {base_us:.6f} us/round (slope between {base_n} and "
                 f"{2 * base_n} rounds, {P.LANES // 64} blocks of 64 as the splat), "
                 f"{base_ms:.5f} ms for {P.N_ROUNDS} rounds, plain {base_plain_ms:.1f} ms; sinks "
                 f"equal; a step of the chain {step_cycles:.3f} cycles (clock64), so "
                 f"{P.N_ROUNDS} steps take at least {chain_ms:.5f} ms at {sm_mhz:.0f} MHz; "
                 f"operations bound {bound_ms:.5f} ms")
    return rows, dict(ms=base_ms, plain_ms=base_plain_ms, max_abs_err=base_err,
                      bound_ms=bound_ms, bound_by=bound_by, chain_bound_ms=chain_ms,
                      step_cycles=step_cycles, library_ms=None)


def _gap_text(g):
    """The gaps of ``pool_cuda.gaps`` on one line."""
    return " ".join(f"{key}={v:.3e}" if isinstance(v, float) else
                    f"{key}=" + ",".join(f"{x:.3e}" for x in v) for key, v in g.items())


def _same_counts(a, b):
    """Whether two results of the plain transport have every count equal."""
    import torch
    keys = ("n_error", "n_alive_at_cap", "n_stokes_anomaly", "n_error_records")
    return (torch.equal(a["detector"][..., 2].cpu(), b["detector"][..., 2].cpu())
            and torch.equal(a["error_codes"].cpu(), b["error_codes"].cpu())
            and all(int(a[k]) == int(b[k]) for k in keys))


def _sums_rel(a, b):
    """The largest difference of a float tally of ``a`` from ``b``'s (the
    detector's sums and squares, the fluxes, the flow), over that tally's
    largest magnitude."""
    import torch
    worst = 0.0
    for k in ("detector", "flux_emitted", "flux_exit", "flow_global", "flow_theta"):
        if b.get(k) is None:
            continue
        x, y = (torch.as_tensor(o[k]).double().cpu() for o in (a, b))
        if k == "detector":
            x, y = x[..., :2], y[..., :2]
        scale = float(y.abs().max())
        d = float((x - y).abs().max())
        worst = max(worst, d / scale if scale else (0.0 if d == 0 else float("inf")))
    return worst


def _f64_tables(root, device):
    """The float64 tables and static config of the CLI's ``demo`` input."""
    import torch
    from artes_tpu_torch import runner
    from artes_tpu_torch.atmosphere import load_artifact
    from artes_tpu_torch.config import detector_setup, load_config
    from artes_tpu_torch.transport.tables import build_tables
    atm_dir = os.path.join(root, "input", "demo")
    cfg = load_config(os.path.join(atm_dir, "artes.in"))
    atm = load_artifact(os.path.join(atm_dir, "atmosphere.fits"))
    det = detector_setup(cfg, float(atm.rfront[-1]))
    return (build_tables(atm, cfg, det, 0, dtype=torch.float64, device=device).tables,
            runner._kernel_static(cfg, det, atm, False))


def _parting(run, lo, n, rtol):
    """The photon ids in ``lo .. lo + n - 1`` whose card and CPU results
    differ, by bisection; ``run(lo, n)`` gives both."""
    card, cpu = run(lo, n)
    if _same_counts(card, cpu) and _sums_rel(card, cpu) <= rtol:
        return []
    if n == 1:
        return [lo]
    return _parting(run, lo, n // 2, rtol) + _parting(run, lo + n // 2, n - n // 2, rtol)


def phase_xla_paths():
    """The paths of the JAX package that are XLA there and plain PyTorch
    here, on the card. (a) ``kernel.run_batch`` at ``XLA_PHOTONS``, seed 7,
    ids 0 .. n-1 on ``XLA_CELLS``, against the plain pool ``run_stream`` on
    the same photons (every count equal, sums within ``BATCH_RTOL``), the
    kernel timed on them too; then at the cell's gate photons
    (``cells.gate_photons``, where its limits were read) against the
    kernel within its gate (``pool_cuda.gaps``, ``limits_of``); no kernel
    may launch on the plain paths. (b)
    ``--f64``: the CLI's ``demo`` at ``F64_PHOTONS`` on the card and with
    ``--device cpu``, one process each (wall times, ``spectrum.dat`` within
    ``runner.F64_DEVICE_RTOL``), and the same run's transport in this
    process on both devices: every count equal, sums within
    ``F64_DEVICE_RTOL``, a photon that parts reported by id. The sharded
    dispatch runs in the mesh phase's ranks (:func:`_mesh_probe`)."""
    import numpy as np
    import torch
    from artes_tpu_torch import cells
    from artes_tpu_torch.cells import KERNEL_CELLS, gate_photons
    from artes_tpu_torch.runner import F64_DEVICE_RTOL
    from artes_tpu_torch.transport import kernel, pool_cuda
    t0 = time.perf_counter()
    seed, n = 7, XLA_PHOTONS
    rows = {}
    for name in XLA_CELLS:
        tables, static = KERNEL_CELLS[name]("cuda")
        ids = torch.arange(n, dtype=torch.int64, device="cuda")
        before = dict(pool_cuda.LAUNCHES)
        batch_ms, batch = timed(lambda: kernel.run_batch(tables, static, ids, seed), 1)
        pool_ms, pool = timed(lambda: kernel.run_stream(tables, static, n, seed, n), 1)
        if pool_cuda.LAUNCHES != before:
            fail(f"the plain paths launched a kernel on {name}")
        pool_cuda.run_stream_cuda(tables, static, n, seed)                  # warm-up
        kernel_ms, k = timed(lambda: pool_cuda.run_stream_cuda(tables, static, n, seed), 5)
        rel = _sums_rel(batch, pool)
        same = _same_counts(batch, pool)
        # the gate's limits hold at the photons they were read at
        # (cells.gate_photons); at fewer, fewer photons' ulps cancel
        n_gate = gate_photons(tables, static)
        if n_gate != n:
            batch_g = kernel.run_batch(tables, static,
                                       torch.arange(n_gate, dtype=torch.int64, device="cuda"),
                                       seed)
            k = pool_cuda.run_stream_cuda(tables, static, n_gate, seed)
            batch = batch_g
        g = pool_cuda.gaps(k, batch)
        limits = pool_cuda.limits_of(tables, static)
        say("xla-paths", f"{name}: run_batch {batch_ms:.1f} ms, plain pool run_stream "
                         f"{pool_ms:.1f} ms, kernel {kernel_ms:.3f} ms ({n} photons, seed 7); "
                         f"batch against pool: counts {'equal' if same else 'DIFFERENT'}, sums "
                         f"within {rel:.3e}; batch against kernel at the gate's {n_gate} "
                         f"photons: gaps " + _gap_text(g))
        if not (same and rel <= BATCH_RTOL):
            fail(f"run_batch is not the plain pool on {name}")
        if not pool_cuda.agrees(g, limits):
            fail(f"run_batch disagrees with the kernel on {name} (limits {limits})")
        rows[name] = dict(batch_ms=batch_ms, pool_ms=pool_ms, kernel_ms=kernel_ms)

    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
    with tempfile.TemporaryDirectory(prefix="artes_f64_") as root:
        cells.write_input(root, "demo")
        walls, spectra = {}, {}
        for label, dev in (("card", "cuda"), ("cpu", "cpu")):
            t1 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "artes_tpu_torch.cli", "demo", str(F64_PHOTONS), "-o",
                 f"f64_{label}", "--root", root, "--f64", "--device", dev],
                cwd=root, env=env, capture_output=True, text=True, timeout=600)
            walls[label] = time.perf_counter() - t1
            if proc.returncode != 0:
                fail(f"CLI --f64 --device {dev} exited {proc.returncode}:\n{proc.stdout}\n"
                     f"{proc.stderr}")
            found = LAUNCH_LINE.search(proc.stdout)
            if (label == "card") != bool(found) or (found and int(found.group(1)) != 0):
                fail(f"CLI --f64 --device {dev}: a float64 run launches no kernel:\n"
                     f"{proc.stdout}")
            spectra[label] = np.loadtxt(os.path.join(root, "output", f"f64_{label}", "output",
                                                     "spectrum.dat"), ndmin=2)
        scale = float(np.abs(spectra["cpu"][:, 1:]).max())
        spec_rel = float(np.abs(spectra["card"] - spectra["cpu"]).max()) / scale
        # the CLI's transport again, in this process on both devices (seed 0
        # at the first wavelength, one chunk of F64_PHOTONS)
        tabs = [_f64_tables(root, dev) for dev in ("cuda", "cpu")]

        def run(lo, count):
            return tuple(kernel.run_stream(*tab, count, 0, max(count, 1), 0, lo) for tab in tabs)

        card, cpu = run(0, F64_PHOTONS)
        rel = _sums_rel(card, cpu)
        same = _same_counts(card, cpu)
        parting = [] if same and rel <= F64_DEVICE_RTOL else \
            _parting(run, 0, F64_PHOTONS, F64_DEVICE_RTOL)
        say("xla-paths", f"--f64 demo, {F64_PHOTONS} photons: the card {walls['card']:.1f} s, "
                         f"--device cpu {walls['cpu']:.1f} s of wall time (process start "
                         f"included); spectrum.dat within {spec_rel:.3e}; transport card against "
                         f"CPU: counts {'equal' if same else 'DIFFERENT'}, sums within {rel:.3e}"
                         f" (limit {F64_DEVICE_RTOL:g}); photons that part: {parting or 'none'}")
        if not same or rel > F64_DEVICE_RTOL or spec_rel > F64_DEVICE_RTOL:
            fail(f"float64 on the card is not float64 on the CPU: photons {parting}")
    rows["f64"] = dict(card_s=walls["card"], cpu_s=walls["cpu"], rel=rel)
    say("xla-paths", f"phase took {time.perf_counter() - t0:.1f} s")
    return rows


def phase_anchors():
    import numpy as np
    import torch
    from artes_tpu_torch.config import ArtesConfig, detector_setup
    from artes_tpu_torch import cells, runner
    from artes_tpu_torch.transport import pool_cuda

    # (a) the PR-1 flagship anchor against the recorded TPU tally
    tables, static = cells.spectrum_tables(cells.flagship(), "cuda")
    n = 1 << 27
    ms, out = timed(lambda: pool_cuda.run_stream_cuda(tables, static, n, 12), 1)
    det = out["detector"].cpu()
    i_raw = float(det[0, 0, 0])
    rel = abs(i_raw - BENCH_R05_DETECTOR_I_RAW) / BENCH_R05_DETECTOR_I_RAW
    n_cap = int(out["n_alive_at_cap"])
    say("anchor", f"flagship 2^27 photons seed 12: detector_I_raw {i_raw:.1f} vs TPU record "
                  f"{BENCH_R05_DETECTOR_I_RAW} (rel {rel:.3e}); peels {int(det[0, 0, 2])}; "
                  f"n_alive_at_cap {n_cap}; {ms:.1f} ms = {n / (ms * 1e-3):.4g} photons/s on "
                  f"{card_line()}")
    if not (det.isfinite().all() and rel <= 2e-3 and n_cap == 0):
        fail("anchor run disagrees with the recorded TPU tally")

    # (b) image = spectrum on the same photons
    n = SMOKE_PHOTONS
    img_tables, img_static = cells.imaging_tables(25, "cuda")
    ms_img, img = timed(lambda: pool_cuda.run_stream_cuda(img_tables, img_static, n, 12), 1)
    ms_spec, spec = timed(lambda: pool_cuda.run_stream_cuda(tables, static, n, 12), 1)
    total, spec = img["detector"].cpu().sum(0), spec["detector"].cpu()[0]
    d_n = (total[:, 2] - spec[:, 2]).abs().max().item()
    rel_i = abs(float(total[0, 0] - spec[0, 0])) / float(spec[0, 0])
    say("anchor", f"25x25 image = spectrum, 2^24 photons: counts {int(total[0, 2])} vs "
                  f"{int(spec[0, 2])} (max |dN| {d_n:.0f}), I rel {rel_i:.3e}; image kernel "
                  f"{ms_img:.1f} ms, spectrum kernel {ms_spec:.1f} ms")
    if not (d_n <= 4 and rel_i <= 1e-6):
        fail("the image summed over its pixels is not the spectrum")

    # (e) a 3-D grid of equal cells is the flagship
    u_tables, u_static = cells.spectrum_tables(cells.uniform_3d(), "cuda")
    ms_u, uni = timed(lambda: pool_cuda.run_stream_cuda(u_tables, u_static, n, 12), 1)
    i_u = float(uni["detector"].cpu()[0, 0, 0])
    rel_u = abs(i_u - float(spec[0, 0])) / float(spec[0, 0])
    share = int(uni["n_error"]) / n
    say("anchor", f"uniform 3-D grid (1 x 6 x 5 cells) = flagship, 2^24 photons: I {i_u:.4f} vs "
                  f"{float(spec[0, 0]):.4f} (rel {rel_u:.3e}); abandoned {int(uni['n_error'])} "
                  f"{uni['error_codes'].tolist()} ({share:.3e} of the photons); 3-D kernel "
                  f"{ms_u:.1f} ms, radial kernel {ms_spec:.1f} ms")
    if not (rel_u <= UNIFORM_3D_REL and share <= UNIFORM_3D_ERRORS):
        fail("the uniform 3-D grid misses the flagship's spectrum")

    # (c) transparent thermal shell: L / (4 pi d^2)
    atm = cells.transparent_thermal_shell()
    cfg = ArtesConfig()
    cfg.mode = "spectrum"
    cfg.photon_source = "planet"
    det_s = detector_setup(cfg, float(atm.rfront[-1]))
    res = runner.run_wavelength(atm, cfg, det_s, 0, n, seed=5, device="cuda")
    ratio = res.photometry[0] / cells.thermal_shell_oracle(atm, cfg)
    say("anchor", f"transparent thermal shell, 2^24 photons: I / (V kappa B / d^2) "
                  f"{ratio:.5f}")
    if not abs(ratio - 1.0) <= 0.02:
        fail("the transparent thermal shell misses L / (4 pi d^2)")

    # (d) thin Rayleigh shell: single-scattering phase curve
    atm = cells.thin_rayleigh_shell()
    cfg = ArtesConfig()
    cfg.mode = "phase"
    t0 = time.perf_counter()
    results = runner.run_phase_curve(atm, cfg, n, seed=3, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    norm = cells.stellar_norm(cfg, atm) * np.pi
    worst_i = worst_p = 0.0
    for ang, _, r in results:
        if ang > 160.0:
            continue
        intensity, pol = cells.thin_shell_phase_oracle(atm, ang)
        p = r.photometry
        worst_i = max(worst_i, abs(p[0] / norm / intensity - 1.0))
        worst_p = max(worst_p, abs(-p[2] / p[0] - pol))
    say("anchor", f"thin Rayleigh shell phase curve, {len(results)} angles x 2^24 photons "
                  f"({wall:.1f} s wall): worst |I / single scattering - 1| {worst_i:.4f}, "
                  f"worst |-Q/I - P(Theta)| {worst_p:.4f} for alpha <= 160 deg")
    if not (worst_i <= 0.05 and worst_p <= 0.05):
        fail("the thin-shell phase curve misses single scattering")

    # (f) the Lambert sphere: geometric albedo 2/3 at full phase
    atm = cells.lambert_sphere()
    cfg = ArtesConfig()
    cfg.mode = "spectrum"
    cfg.surface_albedo = 1.0
    cfg.det_phi = 1.0e-3
    det_s = detector_setup(cfg, float(atm.rfront[-1]))
    res = runner.run_wavelength(atm, cfg, det_s, 0, n, seed=11, device="cuda")
    albedo = res.photometry[0] / cells.stellar_norm(cfg, atm)
    q_over_i = res.photometry[2] / res.photometry[0]
    say("anchor", f"Lambert sphere, 2^24 photons: I / norm {albedo:.5f} (2/3 = {2 / 3:.5f}), "
                  f"Q/I {q_over_i:.2e}; abandoned {res.n_error} {res.error_codes.tolist()}")
    if not (abs(albedo / (2.0 / 3.0) - 1.0) <= 0.01 and abs(q_over_i) < 2e-3):
        fail("the Lambert sphere misses the geometric albedo 2/3")

    # (g) what crosses the top shell's outer face is what leaves
    for label, atm, keys in (
            ("radial, closed form", cells.thermal_scattering_shell(), {}),
            ("radial over a surface", cells.thermal_surface_shell(), {"surface_albedo": 0.7}),
            ("3-D over a surface", cells.grid3d_thermal_atm(), {"surface_albedo": 0.5})):
        cfg = ArtesConfig()
        cfg.mode = "spectrum"
        cfg.photon_source = "planet"
        cfg.flow_global = cfg.flow_theta = True
        for k, v in keys.items():
            setattr(cfg, k, v)
        det_s = detector_setup(cfg, float(atm.rfront[-1]))
        res = runner.run_wavelength(atm, cfg, det_s, 0, 1 << 22, seed=5, device="cuda")
        top = float(res.flow_theta[-1, :, :, 0].sum())
        say("anchor", f"thermal flow, {label}, 2^22 photons: sum flow_theta[top shell, up] "
                      f"{top:.6f} vs flux_exit {res.flux_exit:.6f} "
                      f"(rel {abs(top / res.flux_exit - 1.0):.3e})")
        if not abs(top / res.flux_exit - 1.0) <= 2e-5:
            fail("the energy crossing the outer face is not flux_exit")


def _time_readers(path, turns=5):
    """Each FITS reader's median and least wall time [s] on ``path``,
    ``turns`` reads each in alternation, after one read of each; fails
    unless both read the same arrays."""
    import numpy as np
    from artes_tpu_torch.io.fitsio import read_fits, read_fits_native
    readers = {"read_fits": read_fits, "read_fits_native": read_fits_native}
    first = {name: read(path) for name, read in readers.items()}
    for (n_a, a), (n_b, b) in zip(*first.values()):
        if n_a != n_b or (a is None) != (b is None) or \
                (a is not None and not np.array_equal(a, b)):
            fail(f"the FITS readers disagree on {path}, HDU {n_a}")
    times = {name: [] for name in readers}
    for _ in range(turns):
        for name, read in readers.items():
            t0 = time.perf_counter()
            read(path)
            times[name].append(time.perf_counter() - t0)
    return {name: (sorted(t)[len(t) // 2], min(t)) for name, t in times.items()}


def _chain(number):
    """``python -m artes_tpu_torch.baselines <number>`` in a process of its
    own: its result line, its wall time."""
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "artes_tpu_torch.baselines", str(number)],
                          cwd=HERE, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        fail(f"baselines {number} exited {proc.returncode} without a result:\n"
             f"{proc.stdout}\n{proc.stderr}")
    for line in lines[:-1]:
        say("chains", line)
    if proc.returncode != 0 or not result["ok"]:
        fail(f"baselines {number} exited {proc.returncode}, ok {result['ok']}: "
             f"{json.dumps({k: v for k, v in result.items() if k != 'rows'})}\n{proc.stderr}")
    return result, wall


def phase_chains():
    """The opacity chains: both FITS readers timed on blended_5184's
    artifact, then BASELINE #4 and #3 through ``artes_tpu_torch.baselines``
    (its own process each: the launches it counts are its own) against the
    records' limits. Returns the chains' launches per instantiation."""
    from artes_tpu_torch import cells
    from artes_tpu_torch.atmosphere import write_artifact
    with tempfile.TemporaryDirectory(prefix="artes_fits_") as tmp:
        path = os.path.join(tmp, "atmosphere.fits")
        write_artifact(path, cells.blended_5184())
        size = os.path.getsize(path)
        times = _time_readers(path)
    say("chains", f"blended_5184's atmosphere.fits ({size} bytes) read on the card's host: "
                  + "; ".join(f"{name} median {med:.4f} s, least {low:.4f} s"
                              for name, (med, low) in times.items())
                  + "; the same arrays")
    launches = {}
    four, wall4 = _chain(4)
    checks = four["checks"]
    say("chains", f"#4 ({wall4:.1f} s wall): " + "; ".join(
        f"{k} {c['value']!r} against {c['record']!r} (gap {c['gap']:.4g}, limit {c['limit']:.4g}"
        + (", reported only)" if not c.get("held", True) else ")") for k, c in checks.items())
        + f"; abandoned by code {four['error_codes']}; {four['throughput_photons_per_s']:.6g} "
        f"photons/s; kernel vs plain {four['cross_kernel']}; launches {four['launches']}")
    three, wall3 = _chain(3)
    rates = three["throughput_photons_per_s"]
    say("chains", f"#3 ({wall3:.1f} s wall): {three['conservation']['wavelengths_within_rule']} "
                  f"of {three['n_wavelength']} wavelengths within the conservation rule (tol "
                  f"{three['conservation']['tolerance']}, worst excess beyond the albedo allowance "
                  f"{three['conservation']['worst_excess_beyond_albedo_allowance']:.4e}, worst "
                  f"deficit {three['conservation']['worst_deficit']:.4e}); n_error "
                  f"{three['n_error_total']}; photons/s median {rates['median']:.6g} min "
                  f"{rates['min']:.6g} max {rates['max']:.6g}; launches {three['launches']}")
    for result in (four, three):
        for k, v in result["launches"].items():
            launches[k] = launches.get(k, 0) + v
    if launches.get("grid3d_image", 0) <= 0 or launches.get("thermal", 0) <= 0:
        fail(f"the chains did not launch grid3d_image and thermal: {launches}")
    return launches


LAUNCH_LINE = re.compile(r"CUDA kernel launches: pool=(\d+) \((.*)\)")
MESH_LINE = re.compile(r"mesh launches: (\d+) over (\d+) ranks")
ERROR_TALLY = re.compile(r"^error (\d{2}[\dx])/.* x(\d+)$")
ERROR_RECORD = re.compile(r"^error (\d{3}) photon (\d+) at ([a-z ]+): pos=\((.*)\) dir=\((.*)\) "
                          r"cell=\((-?\d+), (-?\d+), (-?\d+)\) face=\((\d+), (\d+)\) "
                          r"I=(\S+) n_scat=(\d+)$")


def _cli(root, env, atm_name, run, *keys, photons=SMOKE_PHOTONS, extra=()):
    """One CLI process (with ``extra`` arguments); returns its output
    directory, its launches per instantiation (and, with ``--mesh``, its mesh
    launches under "mesh") and its wall time."""
    from artes_tpu_torch.transport import pool_cuda
    t0 = time.perf_counter()
    args = [a for k in keys for a in ("-k", k)]
    proc = subprocess.run(
        [sys.executable, "-m", "artes_tpu_torch.cli", atm_name, str(photons),
         "-o", run, "--root", root, *args, *extra],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"CLI {run} exited {proc.returncode}:\n{proc.stdout}\n{proc.stderr}")
    found = LAUNCH_LINE.search(proc.stdout)
    if not found or int(found.group(1)) <= 0:
        fail(f"CLI {run} did not launch the kernel:\n{proc.stdout}")
    by = {k: int(v) for k, v in (kv.split("=") for kv in found.group(2).split())}
    if sorted(by) != sorted(pool_cuda.LAUNCHES):
        fail(f"CLI {run} launch line names other instantiations: {found.group(0)}")
    if "--mesh" in extra:
        found = MESH_LINE.search(proc.stdout)
        if not found:
            fail(f"CLI {run} printed no mesh launches:\n{proc.stdout}")
        by["mesh"], by["ranks"] = int(found.group(1)), int(found.group(2))
    return os.path.join(root, "output", run, "output"), by, wall


# the sites a record may name, by its code: a march (031, 032, 034) is a
# scatter march or, with marching walks, a first walk; 031 also a prewalk; a
# failed scatter peel (tallied under 05x) and a Stokes anomaly (050) are
# recorded as code 050
RECORD_SITES = {"031": ("scatter march", "first walk", "prewalk"),
                "032": ("scatter march", "first walk"), "034": ("scatter march", "first walk"),
                "050": ("detector peel", "stokes anomaly")}


def _read_error_log(path, marching=False):
    """``(events tallied, records)`` of a run's ``error.log``: none when the
    run tallied no error; else every line must parse, the tallies come first
    and every record names a code that was tallied and a site of that code.
    Jump-walk runs record every abandoned photon (the first and last 8);
    marching runs also tally failed peel walks (``05x``), of which failed
    birth peels leave no record."""
    if not os.path.isfile(path):
        return 0, 0
    tallies, records = {}, 0
    with open(path) as fh:
        for line in fh.read().splitlines():
            tally, record = ERROR_TALLY.match(line), ERROR_RECORD.match(line)
            if tally and not records:
                tallies[tally.group(1)] = int(tally.group(2))
                continue
            code = record.group(1) if record else None
            site = record.group(3) if record else None
            if code is None or ("05x" if site == "detector peel" else code) not in tallies \
                    or site not in RECORD_SITES[code] \
                    or (not marching and site not in ("scatter march", "stokes anomaly")):
                fail(f"{path}: line not understood: {line}")
            floats = [float(x) for x in (record.group(4) + "," + record.group(5)).split(",")]
            if len(floats) != 6 or not all(abs(x) <= 1.0 + 1e-5 for x in floats):
                fail(f"{path}: a record's position or direction leaves the unit ball: {line}")
            records += 1
    total, peel = sum(tallies.values()), tallies.get("05x", 0)
    expected = (min(total - peel, 16), min(total, 16)) if marching else (min(total, 16),) * 2
    if not tallies or not expected[0] <= records <= expected[1]:
        fail(f"{path}: tallies {tallies} but {records} records")
    return total, records


def phase_main_path():
    """The CLI as a user runs it, one process per run, then the probe's own
    entry point. Each process starts with its launch counts at 0 and prints
    them at its end; the launches of the earlier phases, made in this
    process, are not in them."""
    import numpy as np
    from artes_tpu_torch.io.fitsio import read_fits
    from artes_tpu_torch import cells
    from artes_tpu_torch.transport import pool_cuda

    launches = dict.fromkeys(list(pool_cuda.LAUNCHES) + ["mesh"], 0)
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
    with tempfile.TemporaryDirectory(prefix="artes_smoke_") as root:
        cells.write_input(root, "demo")
        cells.write_artifact_input(root, "h39", cells.hydrostatic39())
        cells.write_artifact_input(root, "thermal", cells.thermal_bench(),
                                   ["photon:source=planet"])
        cells.write_artifact_input(root, "thermal_scat", cells.thermal_scattering_shell(),
                                   ["photon:source=planet"])
        cells.write_artifact_input(root, "grid3d", cells.grid3d_2496())
        cells.write_artifact_input(root, "grid3d_thermal", cells.grid3d_thermal_atm(),
                                   ["photon:source=planet"])

        def count(by):
            for k, v in by.items():
                launches[k] += v

        for atm_name in ("demo", "h39"):
            out, by, wall = _cli(root, env, atm_name, "spec_" + atm_name)
            count(by)
            rows = np.loadtxt(os.path.join(out, "spectrum.dat"), ndmin=2)
            i, q, u = rows[:, 1], rows[:, 2], rows[:, 3]
            if not (np.isfinite(rows).all() and (i > 0).all()
                    and (np.abs(q) <= i).all() and (np.abs(u) <= i).all()):
                fail(f"spectrum.dat of {atm_name} is not physical: {rows}")
            say("main-path", f"cli spectrum {atm_name} {SMOKE_PHOTONS} photons: I {i[0]:.6e} "
                             f"Q {q[0]:.6e} U {u[0]:.6e} (-Q/I {-q[0] / i[0]:.5f}); launches "
                             f"{by}; {wall:.1f} s wall incl. process start")

        # the other runs of the radial and 3-D slices, MAIN_PATH_TOGETHER at a time
        image = ["detector:type=imaging_mono", "detector:pixel=25"]
        together = (("demo", "image_demo", image), ("thermal_scat", "image_thermal", image),
                    ("demo", "phase_demo", ["detector:type=phase"]),
                    ("thermal", "spec_thermal", ["detector:type=spectrum"]),
                    ("grid3d", "spec_grid3d", []), ("grid3d", "image_grid3d", image),
                    ("grid3d_thermal", "spec_grid3d_thermal", []),
                    ("grid3d_thermal", "image_grid3d_thermal", image))
        with ThreadPoolExecutor(MAIN_PATH_TOGETHER) as ex:
            ran = dict(zip((spec[1] for spec in together),
                           ex.map(lambda spec: _cli(root, env, spec[0], spec[1], *spec[2]),
                                  together)))

        for run in ("image_demo", "image_thermal"):
            out, by, wall = ran[run]
            count(by)
            img = read_fits(os.path.join(out, "stokes.fits"))[0][1]     # (4, ny, nx)
            i, q, u = img[0], img[1], img[2]
            tol = 1e-6 * np.abs(i).max()
            if not (img.shape == (4, 25, 25) and np.isfinite(img).all() and (i >= 0).all()
                    and (np.abs(q) <= i + tol).all() and (np.abs(u) <= i + tol).all()):
                fail(f"stokes.fits of {run} is not physical")
            lit = i > 0
            peak = float(np.max(-q[lit] / i[lit])) if lit.any() else 0.0
            say("main-path", f"cli imaging_mono {run} 25x25 {SMOKE_PHOTONS} photons: "
                             f"{int(lit.sum())} lit pixels, peak -Q/I {peak:.4f}, sum I "
                             f"{float(i.sum()):.6e}; launches {by}; {wall:.1f} s wall")

        out, by, wall = ran["phase_demo"]
        count(by)
        rows = np.loadtxt(os.path.join(out, "phase.dat"), ndmin=2)
        if not (rows.shape == (73, 9) and np.isfinite(rows).all() and sum(by.values()) == 73):
            fail(f"phase curve: {rows.shape} rows, launches {by}")
        say("main-path", f"cli phase demo 73 x {SMOKE_PHOTONS} photons: I(0) {rows[0, 1]:.6e} "
                         f"I(90) {rows[36, 1]:.6e} I(180) {rows[-1, 1]:.6e}; launches {by}; "
                         f"{wall:.1f} s wall")

        for run, mode in (("spec_thermal", "spectrum"), ("image_thermal", None)):
            if mode is not None:
                out, by, wall = ran[run]
                count(by)
            else:
                out = os.path.join(root, "output", run, "output")
            lum = np.loadtxt(os.path.join(out, "luminosity.dat"), ndmin=2)
            if not (np.isfinite(lum).all() and lum[0, 1] > 0 and 0 <= lum[0, 2] <= lum[0, 1]):
                fail(f"luminosity.dat of {run} is not physical: {lum}")
            say("main-path", f"cli thermal {run}: emitted {lum[0, 1]:.6e} emergent "
                             f"{lum[0, 2]:.6e} W/micron" + (f"; launches {by}; {wall:.1f} s wall"
                                                             if mode else ""))

        # 3-D grids: spectrum and 25x25 image, stellar and thermal
        for run, keys, variant in (
                ("spec_grid3d", [], "grid3d_stellar"),
                ("image_grid3d", image, "grid3d_image"),
                ("spec_grid3d_thermal", [], "grid3d_thermal"),
                ("image_grid3d_thermal", image, "grid3d_thermal_image")):
            out, by, wall = ran[run]
            count(by)
            if by[variant] != 1 or sum(by.values()) != 1:
                fail(f"cli {run} did not run {variant} once: {by}")
            if keys:
                img = read_fits(os.path.join(out, "stokes.fits"))[0][1]
                total_i, shape_ok = float(img[0].sum()), img.shape == (4, 25, 25)
                finite = bool(np.isfinite(img).all() and (img[0] >= 0).all())
            else:
                rows = np.loadtxt(os.path.join(out, "spectrum.dat"), ndmin=2)
                total_i, shape_ok = float(rows[0, 1]), rows.shape == (1, 5)
                finite = bool(np.isfinite(rows).all())
            if not (shape_ok and finite and total_i > 0.0):
                fail(f"cli {run}: output is not physical (I {total_i})")
            n_err, n_rec = _read_error_log(os.path.join(root, "output", run, "error.log"))
            say("main-path", f"cli {run} {SMOKE_PHOTONS} photons: I {total_i:.6e}; abandoned "
                             f"{n_err} photons, {n_rec} records in error.log; launches "
                             f"{ {k: v for k, v in by.items() if v} }; {wall:.1f} s wall")

        # Lambert surfaces and flow diagnostics: one run an instantiation
        cells.write_artifact_input(root, "thermal_surf", cells.thermal_surface_shell(),
                                   ["photon:source=planet"])
        cells.write_artifact_input(root, "patchy", cells.patchy3d_small())
        cells.write_artifact_input(root, "anomalous", cells.anomalous_rayleigh())
        surface, flow = "planet:surface_albedo=0.5", ["output:flow_global=on",
                                                      "output:flow_latitudinal=on"]
        small = MAIN_PATH_PHOTONS_SMALL
        runs = (("demo", "surface_demo", [surface], "march_stellar", SMOKE_PHOTONS),
                ("h39", "flow_h39", flow, "stellar_flow", SMOKE_PHOTONS),
                ("grid3d", "surface_flow_grid3d", [surface] + flow, "march_stellar_flow",
                 SMOKE_PHOTONS),
                ("thermal_scat", "flow_thermal", flow, "thermal_flow", small),
                ("demo", "flow_image_demo", image + flow, "image_flow", small),
                ("thermal_scat", "flow_image_thermal", image + flow, "thermal_image_flow", small),
                ("thermal_surf", "surface_thermal", [surface], "march_thermal", small),
                ("demo", "surface_image_demo", image + [surface], "march_image", small),
                ("thermal_surf", "surface_image_thermal", image + [surface],
                 "march_thermal_image", small),
                ("grid3d_thermal", "flow_grid3d_thermal", flow, "march_thermal_flow", small),
                ("patchy", "surface_flow_image_patchy", image + [surface] + flow,
                 "march_image_flow", small),
                ("grid3d_thermal", "surface_flow_image_grid3d_thermal",
                 image + [surface] + flow, "march_thermal_image_flow", small),
                ("anomalous", "debug_stokes_anomalous", [], "stellar", small),
                ("grid3d_thermal", "noscatter_grid3d_thermal", ["photon:scattering=off"],
                 "grid3d_thermal", small))
        extra = {"debug_stokes_anomalous": ["--debug-stokes"]}

        def drive(spec):
            return _cli(root, env, spec[0], spec[1], *spec[2], photons=spec[4],
                        extra=extra.get(spec[1], []))

        # the three 2^24 runs one after the other, so that their wall times
        # stand alone; the nine small ones, which are mostly process start,
        # MAIN_PATH_TOGETHER at a time
        with ThreadPoolExecutor(MAIN_PATH_TOGETHER) as ex:
            results = [drive(spec) for spec in runs[:3]] + list(ex.map(drive, runs[3:]))
        for (atm_name, run, keys, variant, photons), (out, by, wall) in zip(runs, results):
            count(by)
            if by[variant] != 1 or sum(by.values()) != 1:
                fail(f"cli {run} did not run {variant} once: {by}")
            if image[0] in keys:
                img = read_fits(os.path.join(out, "stokes.fits"))[0][1]
                total_i = float(img[0].sum())
                ok = img.shape == (4, 25, 25) and bool(np.isfinite(img).all()
                                                       and (img[0] >= 0).all())
            else:
                rows = np.loadtxt(os.path.join(out, "spectrum.dat"), ndmin=2)
                total_i = float(rows[0, 1])
                ok = rows.shape == (1, 5) and bool(np.isfinite(rows).all())
            # on the anomalous layer every photon is abandoned at its first
            # scattering, before its peel: nothing reaches the detector
            if not (ok and (total_i > 0.0 or run in extra)):
                fail(f"cli {run}: output is not physical (I {total_i})")
            flow_note = ""
            if flow[0] in keys:
                vec = read_fits(os.path.join(out, "flow_global.fits"))[0][1]
                lat = read_fits(os.path.join(out, "flow_latitudinal.fits"))[0][1]
                norms = np.linalg.norm(vec, axis=-1)
                lit = norms > 0
                if not (vec.shape[-1] == 3 and lat.shape[-1] == 4 and vec.shape[:-1] == lat.shape[:-1]
                        and lit.any() and np.allclose(norms[lit], 1.0, rtol=1e-12)
                        and np.isfinite(lat).all() and (lat >= 0).all() and lat.sum() > 0):
                    fail(f"cli {run}: the flow files are not physical")
                flow_note = (f"; flow_global.fits {int(lit.sum())} of {lit.size} cells with a "
                             f"unit vector, flow_latitudinal.fits sum {float(lat.sum()):.6e}")
            elif any(name.startswith("flow") for name in os.listdir(out)):
                fail(f"cli {run} wrote flow files without being asked to")
            n_err, n_rec = _read_error_log(os.path.join(root, "output", run, "error.log"),
                                           marching=variant.startswith("march_"))
            if run in extra and not n_rec:
                fail(f"cli {run}: --debug-stokes abandoned no photon on the anomalous layer")
            say("main-path", f"cli {run} {photons} photons: I {total_i:.6e}{flow_note}; "
                             f"{n_err} error events, {n_rec} records in error.log; launches "
                             f"{ {k: v for k, v in by.items() if v} }; {wall:.1f} s wall")

        for k, v in mesh_main_path(root, env).items():
            launches[k] += v

        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "artes_tpu_torch.probe_splat"],
                              cwd=root, env=env, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            fail(f"probe_splat exited {proc.returncode}:\n{proc.stdout}\n{proc.stderr}")
        found = re.search(r"CUDA kernel launches: probe_splat=(\d+) probe_splat_baseline=(\d+)",
                          proc.stdout)
        if not found:
            fail(f"probe_splat printed no launch counts:\n{proc.stdout}")
        launches["probe_splat"], launches["probe_splat_baseline"] = map(int, found.groups())
        say("main-path", "probe_splat: " + "; ".join(proc.stdout.strip().splitlines())
            + f"; {time.perf_counter() - t0:.1f} s wall")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        fail(f"the main path never launched {missing}: {launches}")
    return launches


def phase_mesh_split():
    """(a) The mesh's arithmetic on one card: each of ``MESH_CELLS`` at its
    gate photons as one launch and as k = 2, 3 and 7 sub-ranges of
    ``mesh.split_ids`` launched in turn on the card and merged by
    ``mesh.merge_outputs``: every count and error record equal, the sums
    within ``mesh.SPLIT_RTOL``. Returns the largest |difference| of a
    Stokes moment."""
    from artes_tpu_torch.cells import KERNEL_CELLS, gate_photons
    from artes_tpu_torch.parallel import mesh
    from artes_tpu_torch.transport import pool_cuda
    seed, worst = 7, 0.0
    for name in MESH_CELLS:
        tables, static = KERNEL_CELLS[name]("cuda")
        n = gate_photons(tables, static)
        one = pool_cuda.run_stream_cuda(tables, static, n, seed)
        for k in MESH_SPLITS:
            merged = mesh.run_split(tables, static, n, seed, k)
            g = mesh.split_gaps(merged, one)
            d = float((merged["detector"][..., :2] - one["detector"][..., :2]).abs().max())
            worst = max(worst, d)
            say("mesh-split", f"{name} ({n} photons, {int(one['n_error'])} abandoned, "
                              f"{int(one['n_error_records'])} error events) as {k} sub-ranges: "
                              f"largest count difference {g['counts']:.0f}, records "
                              f"{'identical' if g['records'] == 0 else 'DIFFERENT'}, sums within "
                              f"{g['values']:.3e} of their largest; max|dIQUV| {d:.3g}")
            if not mesh.split_agrees(merged, one):
                fail(f"{name} split over {k} sub-ranges is not one launch: {g}")
    return worst


def _mesh_probe(rank, size, port, path):
    """One rank of the measured mesh (a spawned process): the flagship at
    ``MESH_PROBE_PHOTONS`` through ``run_stream_mesh`` over every visible
    card, its reduction alone, one NCCL ``all_reduce`` of the same payload,
    and on rank 0 one launch of all the photons on its own card."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(size),
                      RANK=str(rank), LOCAL_RANK=str(rank))
    import torch
    import torch.distributed as dist
    from artes_tpu_torch.cells import KERNEL_CELLS
    from artes_tpu_torch.parallel import mesh, multihost
    from artes_tpu_torch.transport import pool_cuda
    multihost.initialize("nccl", timeout_s=600)
    m = mesh.make_mesh("cuda")
    tables, static = KERNEL_CELLS["flagship"](m.device)
    n, seed = MESH_PROBE_PHOTONS, 7
    mesh.run_stream_mesh(tables, static, n, seed, 0, 0, m)          # warm-up, build barrier
    ms, got = timed(lambda: mesh.run_stream_mesh(tables, static, n, seed, 0, 0, m), 5)
    count, _, start = (int(x) for x in mesh.split_ids(n, seed, 0, 0, size)[rank])
    # a rank's launch as run_stream_mesh makes it: its records left on the card
    mine = pool_cuda.run_stream_cuda(tables, static, count, seed, 0, start, host_records=False)
    reduce_ms, _ = timed(lambda: mesh.all_reduce_outputs(mine, m), 20)
    flat_f, flat_i = mesh.pack_tallies(mine, m.device)
    payload = torch.zeros(flat_f.numel() + flat_i.numel(), dtype=torch.float64, device=m.device)
    library_ms, _ = timed(lambda: dist.all_reduce(payload), 20)
    # the sharded dispatch: run_batch on a rank's slice of the ids, summed
    ids = torch.arange(SHARDED_PHOTONS, dtype=torch.int64, device=m.device)
    dispatch = mesh.sharded_dispatch(m)
    sharded_ms, sharded = timed(lambda: dispatch(tables, static, ids, seed), 1)
    result = None
    if rank == 0:
        from artes_tpu_torch.transport import kernel
        one_batch_ms, one_batch = timed(lambda: kernel.run_batch(tables, static, ids, seed), 1)
        one_ms, one = timed(lambda: pool_cuda.run_stream_cuda(tables, static, n, seed), 5)
        n_bytes, n_ops = pool_work(tables, static, one)
        link_bytes = 8 * payload.numel() + 8 * (2 * mesh.ERR_RECORD_K + 1) * mesh.ERR_RECORD_W
        link_ms = 2 * (size - 1) / size * link_bytes / NVLINK_BYTES_S * 1e3
        bound_ms, bound_by = bound(n_bytes, n_ops / size)
        result = dict(size=size, photons=n, ms=ms, one_ms=one_ms, reduce_ms=reduce_ms,
                      library_ms=library_ms, payload_bytes=8 * payload.numel(),
                      bound_ms=bound_ms + link_ms, bound_by=bound_by, link_ms=link_ms,
                      gaps=mesh.split_gaps(got, one),
                      max_abs_err=float((got["detector"][..., :2]
                                         - one["detector"][..., :2]).abs().max()),
                      card=torch.cuda.get_device_name(m.device), sharded_ms=sharded_ms,
                      one_batch_ms=one_batch_ms, sharded_gaps=mesh.split_gaps(sharded, one_batch))
    dist.barrier(device_ids=[m.device.index])
    if rank == 0:
        with open(path, "w") as fh:
            json.dump(result, fh)
    dist.destroy_process_group()


def phase_mesh_probe():
    """The mesh launch measured over every visible card (one spawned process
    a card, NCCL), against one launch on one card; and the plain version of
    the same split on this process's card."""
    import torch
    import torch.multiprocessing as mp
    from artes_tpu_torch.cells import KERNEL_CELLS
    from artes_tpu_torch.parallel import mesh
    size = torch.cuda.device_count()
    with tempfile.TemporaryDirectory(prefix="artes_mesh_") as tmp:
        path = os.path.join(tmp, "probe.json")
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        mp.start_processes(_mesh_probe, args=(size, port, path), nprocs=size,
                           start_method="spawn")
        with open(path) as fh:
            row = json.load(fh)
    g = row.pop("gaps")
    if not (g["counts"] == 0 and g["records"] == 0 and g["values"] <= 1e-12):
        fail(f"the mesh over {size} cards is not one launch on one card: {g}")
    gs = row.pop("sharded_gaps")
    say("mesh", f"sharded_dispatch over {size} ranks: flagship run_batch of {SHARDED_PHOTONS} "
                f"photons {row['sharded_ms']:.1f} ms against {row['one_batch_ms']:.1f} ms for one "
                f"run_batch on one card; largest count difference {gs['counts']:.0f}, records "
                f"{'identical' if gs['records'] == 0 else 'DIFFERENT'}, sums within "
                f"{gs['values']:.3e}")
    if not (gs["counts"] == 0 and gs["records"] == 0 and gs["values"] <= mesh.SPLIT_RTOL):
        fail(f"sharded_dispatch over {size} cards is not one run_batch: {gs}")
    tables, static = KERNEL_CELLS["flagship"]("cuda")
    n = row["photons"]
    row["plain_ms"], _ = timed(lambda: mesh.run_split(tables, static, n, 7, size, plain=True,
                                                      width=n), 1)
    say("mesh", f"world size {size} ({row['card']}, NCCL): flagship {row['photons']} photons "
                f"through run_stream_mesh {row['ms']:.3f} ms against {row['one_ms']:.3f} ms on one "
                f"card; its reduction alone {row['reduce_ms'] * 1e3:.1f} us; one NCCL all_reduce "
                f"of the {row['payload_bytes']} payload bytes {row['library_ms'] * 1e3:.1f} us; "
                f"counts and records equal, sums within {g['values']:.3e}; plain version of the "
                f"split {row['plain_ms']:.1f} ms; bound {row['bound_ms']:.4f} ms by "
                f"{row['bound_by']} (link {row['link_ms'] * 1e3:.3f} us)")
    return row


def _same_outputs(a, b):
    """The largest difference between the files of two runs' output
    directories, each over its array's largest magnitude (tables and FITS
    images); fails unless both hold the same files and every other file,
    ``error.log`` beside the directory included, is byte-equal."""
    import numpy as np
    from artes_tpu_torch.io.fitsio import read_fits
    if sorted(os.listdir(a)) != sorted(os.listdir(b)):
        fail(f"{a} and {b} hold other files: {sorted(os.listdir(a))} {sorted(os.listdir(b))}")
    worst = 0.0
    for name in sorted(os.listdir(a)):
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if name.endswith((".dat", ".fits")):
            read = (lambda p: np.loadtxt(p, ndmin=2)) if name.endswith(".dat") \
                else (lambda p: read_fits(p)[0][1])
            x, y = read(pa), read(pb)
            scale = float(np.abs(y).max()) if y.size else 0.0
            d = float(np.abs(x - y).max()) if y.size else 0.0
            if x.shape != y.shape or not np.isfinite(x).all():
                fail(f"{pa}: shape {x.shape} against {y.shape}, or not finite")
            worst = max(worst, d / scale if scale > 0 else (0.0 if d == 0 else float("inf")))
        elif open(pa, "rb").read() != open(pb, "rb").read():
            fail(f"{pa} differs from {pb}")
    logs = [os.path.join(os.path.dirname(p), "error.log") for p in (a, b)]
    texts = [open(p).read() if os.path.isfile(p) else None for p in logs]
    if texts[0] != texts[1]:
        fail(f"{logs[0]} differs from {logs[1]}")
    return worst


def mesh_main_path(root, env):
    """(b) ``python -m artes_tpu_torch.cli ... --mesh`` over every visible
    card (NCCL, one spawned worker a card) against the same command on one
    card: the quick-start spectrum at 2^24 photons, and the 39 x 8 x 8 deck
    as a 25x25 image over a surface of albedo 0.5 with both flow outputs at
    2^22 photons. Every file equal (values within ``MESH_CLI_RTOL`` of their
    array's largest, ``error.log`` and the other files byte-equal), one
    launch a rank. Returns the launches of the mesh runs."""
    import torch
    size = torch.cuda.device_count()
    image = ["detector:type=imaging_mono", "detector:pixel=25"]
    keys = image + ["planet:surface_albedo=0.5", "output:flow_global=on",
                    "output:flow_latitudinal=on"]
    launches = {}
    for atm_name, run, run_keys, photons in (
            ("demo", "mesh_spec_demo", [], SMOKE_PHOTONS),
            ("grid3d", "mesh_image_surface_flow_grid3d", keys, MAIN_PATH_PHOTONS_SMALL)):
        one, by_one, wall_one = _cli(root, env, atm_name, run + "_one", *run_keys, photons=photons)
        out, by, wall = _cli(root, env, atm_name, run, *run_keys, photons=photons,
                             extra=["--mesh"])
        pool = sum(v for k, v in by.items() if k not in ("mesh", "ranks"))
        if by["ranks"] != size or by["mesh"] != size or pool != size \
                or sum(by_one.values()) != 1:
            fail(f"cli {run}: {size} ranks should launch once each: {by} (one card {by_one})")
        worst = _same_outputs(out, one)
        if worst > MESH_CLI_RTOL:
            fail(f"cli {run}: the mesh run differs from one card by {worst:.3e}")
        n_err, n_rec = _read_error_log(os.path.join(root, "output", run, "error.log"),
                                       marching=bool(run_keys))
        say("main-path", f"cli {run} --mesh, world size {size}, {photons} photons: every file "
                         f"equal to one card's, values within {worst:.3e}; {n_err} error events, "
                         f"{n_rec} records; launches {by}; {wall:.1f} s wall against "
                         f"{wall_one:.1f} s on one card")
        for k, v in by.items():
            if k != "ranks":
                launches[k] = launches.get(k, 0) + v
    return launches


def mesh_kernel_row(row, launches, split_err):
    """The kernels line's row of the mesh launch: its launches on the main
    path (one a rank a run), the measured mesh's time, the plain version of
    the same split, the bound of a rank's share plus the link, and one NCCL
    ``all_reduce`` of the payload as the library's call."""
    return {"name": "mesh_launch", "route": "cuda", "source": "artes_tpu_torch/parallel/mesh.py",
            "replaces": MESH_REPLACES, "launches": launches,
            "max_abs_err": max(row["max_abs_err"], split_err), "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]}


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an NVIDIA card")
    if not os.path.isdir(os.path.join(HERE, "artes_tpu_torch")):
        fail("run chip_smoke.py from the root of a checkout of the repository")
    sys.modules["jax"] = None          # the port runs without JAX
    sys.path.insert(0, HERE)

    phase_env()
    phase_build()
    if sys.argv[1:] == ["--mesh"]:
        # the mesh phases alone, over every visible card
        split_err = phase_mesh_split()
        mesh_row = phase_mesh_probe()
        with tempfile.TemporaryDirectory(prefix="artes_smoke_") as root:
            env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
            from artes_tpu_torch import cells
            cells.write_input(root, "demo")
            cells.write_artifact_input(root, "grid3d", cells.grid3d_2496())
            launches = mesh_main_path(root, env)
        print(card_line())
        print(json.dumps({"kernels": [mesh_kernel_row(mesh_row, launches["mesh"], split_err)]}))
        return
    rows = phase_kernel_vs_plain()
    probe_rows, base_row = phase_probe()
    phase_xla_paths()
    phase_anchors()
    chain_launches = phase_chains()
    split_err = phase_mesh_split()
    mesh_row = phase_mesh_probe()
    launches = phase_main_path()

    from artes_tpu_torch.transport import pool_cuda
    sources = {v: "pool_radial" for v in pool_cuda.VARIANTS + pool_cuda.VARIANTS_FLOW}
    sources.update({v: "pool_grid3d" for v in pool_cuda.VARIANTS_3D})
    sources.update({v: "pool_march" for v in pool_cuda.VARIANTS_MARCH})
    kernels = []
    for variant, cell in VARIANT_CELL.items():
        mine = [r for r in rows.values() if r["variant"] == variant]
        source = sources[variant]
        short = variant.split("_", 1)[1] if source != "pool_radial" else variant
        kernels.append({"name": f"{source}.{short}", "route": "cuda",
                        "source": KERNEL_SOURCE[source],
                        "replaces": POOL_REPLACES,
                        "launches": launches[variant] + chain_launches.get(variant, 0),
                        "max_abs_err": max(r["max_abs_err"] for r in mine),
                        "ms": rows[cell]["ms"], "plain_ms": rows[cell]["plain_ms"],
                        "bound_ms": rows[cell]["bound_ms"], "bound_by": rows[cell]["bound_by"],
                        # no single PyTorch call transports photons
                        "library_ms": None})
    probe = probe_rows[PROBE_SIZES[0]]
    kernels.append({"name": "probe_splat", "route": "cuda",
                    "source": "artes_tpu_torch/csrc/probe_splat.cu",
                    "replaces": "tools/probe_splat.py:108",
                    "launches": launches["probe_splat"],
                    "max_abs_err": max(r["max_abs_err"] for r in probe_rows.values()),
                    "ms": probe["ms"], "plain_ms": probe["plain_ms"],
                    "bound_ms": probe["bound_ms"], "bound_by": probe["bound_by"],
                    "library_ms": probe["library_ms"],
                    "library_counts_ms": probe["library_counts_ms"]})
    kernels.append({"name": "probe_splat_baseline", "route": "cuda",
                    "source": "artes_tpu_torch/csrc/probe_splat.cu",
                    "replaces": "tools/probe_splat.py:134",
                    "launches": launches["probe_splat_baseline"], **base_row})
    kernels.append(mesh_kernel_row(mesh_row, launches["mesh"], split_err))
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
