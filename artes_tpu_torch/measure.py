"""Measurements on the card that ``chip_smoke.py`` does not make.

Run from the root of a checkout on a machine with a CUDA card::

    python -m artes_tpu_torch.measure compare <other checkout>
    python -m artes_tpu_torch.measure rates
    python -m artes_tpu_torch.measure contraction
    python -m artes_tpu_torch.measure clocks [--cells flagship,hydrostatic39] [--photons N]
    python -m artes_tpu_torch.measure gate [--walk closed|jumps|march] [--seeds 7,8,9,10]
    python -m artes_tpu_torch.measure parting <cell> [--seed 9] [--count 3]

``compare`` times the kernels of another checkout of this repository (an
earlier commit, unpacked beside this one) and of this one on the same card,
in turns (other, this, this, other), one process each, on the cells of
``COMPARE_CELLS`` (``cells.KERNEL_CELLS``, seed 7): the radial pool kernel on
the flagship at 2^20 and 2^24 photons and on hydrostatic39, imaging25 and
thermal_iso at 2^20; the closed-form flow instantiations at 2^20; the 3-D
kernel on every jump-walk gate cell of its four instantiations at 2^18
(grid3d_2496, grid3d_thermal, grid3d_imaging25, grid3d_thermal_imaging25,
blended_5184 and the Mie deck mie_patchy_imaging25); the marching
kernel on every surface and marching flow cell at its gate photons
(``MARCH_CELLS``); the probe splat at 625, 2025 and 10201 pixels; and the
mesh reduction alone, a flagship launch of 2^20 photons summed over a
one-rank NCCL group as ``run_stream_mesh`` sums it; and the plain versions
of the jump walks' cells of ``PLAIN_CELLS`` at 2^18 photons, once each after
a warm run (host clock). It prints each time
(median of 5 after a warm launch, CUDA events), whether every count (the
detector's, the photons emitted, capped and abandoned, the error codes, the
``cell_face`` passes and the flow bookings) is equal and every sum within
1e-12 relative between the two checkouts, the probe splat's library
yardsticks (``probe_splat.library_yardsticks``) and each checkout's own
yardstick of the splat, ``probe_splat.us_per_round`` (the loop a round and
the splat net of it, as that checkout times them).

``rates`` holds the float32 error tallies of the marching kernel against its
plain version where ``cells.SURFACE_MAX_SCATTER`` cuts the gate's orders:
hydrostatic39 and the 39 x 8 x 8 deck over a surface of albedo 0.5, every
order up to the default cap, 2^16 photons, seed 7, each per-code tally
against 3 sigma of Poisson, ``|a - b| <= 3 sqrt(a + b)``. For each it
then sorts the failed scatter peels (records of code 50 at site 3, every one
kept) by event, photon id and scattering count, into those of the kernel
alone, of the plain version alone and of both, and walks each lone event's
peel again from its recorded position, cell and face with the plain
version's marching walk in float32 and in float64 (``kernel._tau_walk_march``):
the share of them that fails again says whether a lone failure is the
recorded state's float32 rounding or the version's own. Last, the 3-D
kernel's abandoned photons on grid3d_2496 on the TPU's own photons: 2^25 at
seed 30 after a warm launch at seed 29, as bench.py times it (BENCH_r05:
774), held within 3 sqrt(a + b) of the record.

``contraction`` builds ``csrc/pool_radial.cu`` and ``csrc/pool_march.cu``
under ``build/contraction/`` (never loaded by the main path) with nvcc's
contraction of multiply-adds on ("contracted") and off ("-fmad=false"),
whatever ``_build.SOURCE_FLAGS`` holds. For each kernel it reads every
gate cell of ``cells.KERNEL_CELLS`` the kernel serves, once with each build:
the gaps of ``pool_cuda.gaps`` to the plain version at
``cells.gate_photons``, seed 7 (the plain versions ``cells.PLAIN_TOGETHER``
processes at a time), each cell's worst gap over its limit, and its kernel
time (median of 5 after a warm launch, CUDA events) with the builds in
turns (in order, then back). It prints the rule's verdict on -fmad=false
against the contracted build: it is adopted only if no cell's worst gap
over its limit rises, the kernel's worst falls, and its time on the
flagship (``pool_radial``) or lambert_tau05 (``pool_march``) grows by at
most :data:`CONTRACTION_MAX_COST`. Then, as PR 8 read them, more variants of
``pool_march.cu``: the walks' chains rounded op by op with
``-fmad=false``, and the contracted build with one chain at a time rounded
op by op (``__fmul_rn``, ``__fadd_rn``): the sphere quadratic's constant term
``qc``, its ``qa``, ``qb`` and ``Cq``, the discriminant, the phi half-plane and
the position updates. Each ``pool_march`` build runs the uncut surface cells
of ``rates`` at 2^16 and 2^20 photons, seed 7, and prints its error tallies:
the failed peels say which chain decides them.

``clocks`` runs the instrumented build of the radial kernel,
``pool_radial_clocks`` (``csrc/pool_radial.cu`` with ``ARTES_POOL_CLOCKS``,
never loaded by the main path), which times every phase of the kernel's loop
per warp with ``clock64``: emission (with the id fetch), prewalk and first
march, roulette and ``peel_prep``, ``sample_beta``, ``sample_alpha``, the
rotation (``direction_cosine``, ``matrix_at``, ``polarization_rotation``), the
peel walk and the march. For each phase it prints its share of the warps'
cycles, its cycles an entry and its SIMT efficiency, the mean share of a
warp's 32 lanes active at entry (``popc(__activemask())``), and the build's
``ptxas -v`` registers and spills.

``gate`` reads the limits of ``pool_cuda.LIMITS``, one walk (``--walk``) or
all three: every configuration of the walk, the gate cells of
``cells.KERNEL_CELLS`` and the BASELINE chains' ``cells.CHAIN_CELLS``, kernel
against plain version at ``cells.gate_photons`` at each seed (the plain
versions ``cells.PLAIN_TOGETHER`` processes at a time). It prints every gap
of ``pool_cuda.gaps`` a reading, then for each key the worst reading with the
configuration and seed that gave it, today's limit and the one the rule
``pool_cuda.limits_from`` gives (floors ``pool_cuda.floors_of``), and the
rule's table; it exits 1 when a reading is over today's limit.

``parting`` looks for the float32 operation that parts the kernel from its
plain version on a gate cell: it builds a probe library (under
build/probe_ops/, with the pool kernels' nvcc flags) that rounds each
function of ``PROBE_OPS`` as the kernels do and counts, on 2^24 inputs from
each function's domain, where ``torch``'s own differs; then it finds by
bisection the first photons whose counts, capped or abandoned photons part
at the cell's gate photons, and runs each again through the plain version
with ``torch``'s function swapped for the kernels' rounding of it, one
function at a time and all at once: a swap that makes the photon's tallies
the kernel's names the operation that parts it.

Every line names the card (``nvidia-smi`` name and power limit).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import re
import subprocess
import sys

PHOTONS = 1 << 20
# the surface cells and the marching flow cells, each at its gate photons
MARCH_CELLS = (("lambert_tau05", PHOTONS), ("thermal_surface", PHOTONS),
               ("lambert_imaging25", PHOTONS), ("thermal_surface_imaging25", PHOTONS),
               ("lambert_thick", 1 << 16), ("hydrostatic39_surface", 1 << 16),
               ("grid3d_2496_surface", 1 << 16), ("grid3d_2496_flow", 1 << 16),
               ("grid3d_thermal_flow", 1 << 16), ("patchy3d_imaging25_surface_flow", 1 << 16),
               ("grid3d_thermal_surface_flow", 1 << 16))
COMPARE_CELLS = (("flagship", 1 << 20), ("flagship", 1 << 24), ("hydrostatic39", PHOTONS),
                 ("imaging25", PHOTONS), ("thermal_iso", PHOTONS),
                 ("hydrostatic39_flow", PHOTONS), ("thermal_flow", PHOTONS),
                 ("imaging25_flow", PHOTONS), ("thermal_imaging25_flow", PHOTONS),
                 ("grid3d_2496", 1 << 18), ("grid3d_thermal", 1 << 18),
                 ("grid3d_imaging25", 1 << 18), ("grid3d_thermal_imaging25", 1 << 18),
                 ("blended_5184", 1 << 18), ("mie_patchy_imaging25", 1 << 18)) + MARCH_CELLS
# the plain versions compare times: the jump walks' (host clock, one run)
PLAIN_CELLS = (("grid3d_2496", 1 << 18), ("grid3d_thermal", 1 << 18), ("blended_5184", 1 << 18))
PROBE_SIZES = (625, 2025, 10201)
REPS = 5
SUM_RTOL = 1e-12
SEED = 7
TPU_GRID3D_N_ERROR = 774               # BENCH_r05.json, TPU v5e, 2^25 photons, seed 30
CONTRACTION_KERNELS = ("pool_radial", "pool_march")
# the cell whose kernel time decides each kernel's flag, and the most the
# flag may cost there
CONTRACTION_TIME_CELL = {"pool_radial": "flagship", "pool_march": "lambert_tau05"}
CONTRACTION_MAX_COST = 1.12
PHASES = ("emission", "prewalk + first march", "roulette + peel_prep", "sample_beta",
          "sample_alpha", "rotation", "peel walk", "march")

# what runs in each checkout: the kernels' times and tallies as JSON on the
# last line of its output (the other checkout's package, never this one's)
_TIMES = r'''
import json, sys, time, torch
sys.modules["jax"] = None
from artes_tpu_torch.cells import KERNEL_CELLS
from artes_tpu_torch.transport import kernel, pool_cuda
from artes_tpu_torch import probe_splat as P
cells, plain_cells, sizes, reps = json.loads(sys.argv[1])
dev = torch.device("cuda")

def timed(fn):
    out = fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record(); out = fn(); b.record(); torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2], out

def tallies(out):
    flow = [out[k].cpu().reshape(-1).tolist() for k in ("flow_global", "flow_theta")
            if out.get(k) is not None]
    return dict(detector=out["detector"].cpu().reshape(-1).tolist(),
                fluxes=[float(out["flux_emitted"]), float(out["flux_exit"])], flow=flow,
                ints=[int(out[k]) for k in ("n_emitted", "n_alive_at_cap", "n_error",
                                            "n_cell_face", "n_flow_booked")
                      if out.get(k) is not None] + out["error_codes"].cpu().tolist())

res = {"cells": {}, "plain": {}, "probe": {}}
for name, n in cells:
    tables, static = KERNEL_CELLS[name](dev)
    ms, out = timed(lambda: pool_cuda.run_stream_cuda(tables, static, n, 7))
    res["cells"][f"{name}@{n}"] = dict(ms=ms, **tallies(out))
# plain versions, once each after a warm run of 2^12 photons (host clock)
for name, n in plain_cells:
    tables, static = KERNEL_CELLS[name](dev)
    kernel.run_stream(tables, static, 1 << 12, 7, 1 << 12)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = kernel.run_stream(tables, static, n, 7, n)
    torch.cuda.synchronize()
    res["plain"][f"{name}@{n}"] = dict(ms=(time.perf_counter() - t0) * 1e3, **tallies(out))
for npix in sizes:
    ms, (vals, counts) = timed(lambda: P.splat(npix, device=dev))
    res["probe"][str(npix)] = dict(ms=ms, vals=float(vals.sum()), counts=int(counts.sum()))
# the checkout's own yardstick: the loop's and the splat's cost a round
base_us, net_us = P.us_per_round(sizes)
res["rounds"] = dict(base=base_us, net={str(k): v for k, v in net_us.items()})
# the mesh reduction alone: a flagship launch of 2^20 photons summed over a
# one-rank NCCL group, as run_stream_mesh launches it
import inspect, os, socket
from artes_tpu_torch.parallel import mesh, multihost
with socket.socket() as sock:
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="1", RANK="0",
                  LOCAL_RANK="0")
multihost.initialize("nccl", timeout_s=300)
m = mesh.make_mesh("cuda")
tables, static = KERNEL_CELLS["flagship"](dev)
kw = ({"host_records": False} if "host_records" in
      inspect.signature(pool_cuda.run_stream_cuda).parameters else {})
mine = pool_cuda.run_stream_cuda(tables, static, 1 << 20, 7, **kw)
mesh.all_reduce_outputs(mine, m)
reduce_ms, got = timed(lambda: mesh.all_reduce_outputs(mine, m))
res["mesh"] = dict(ms=reduce_ms, counts=int(got["detector"][..., 2].sum()),
                   sums=float(got["detector"][..., 0].sum()))
torch.distributed.destroy_process_group()
print(json.dumps(res))
'''


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True)
    return proc.stdout.strip().splitlines()[0]


def _times(checkout: str) -> dict:
    """One process in ``checkout``: its kernels' times and tallies."""
    env = dict(os.environ, PYTHONPATH=checkout)
    arg = json.dumps([COMPARE_CELLS, PLAIN_CELLS, PROBE_SIZES, REPS])
    proc = subprocess.run([sys.executable, "-c", _TIMES, arg], cwd=checkout, env=env,
                          capture_output=True, text=True, timeout=1800)
    if proc.returncode != 0:
        raise RuntimeError(f"{checkout}: exit {proc.returncode}\n{proc.stdout}\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _rel(a: list, b: list) -> float:
    """The largest |a - b| / |b| over the elements (0 where both are 0)."""
    worst = 0.0
    for x, y in zip(a, b):
        if x != y:
            worst = max(worst, abs(x - y) / abs(y) if y != 0 else math.inf)
    return worst


def _same(a: dict, b: dict) -> tuple[bool, float]:
    """Whether two runs' counts are equal, and their sums' largest relative
    difference."""
    det_a, det_b = a["detector"], b["detector"]
    counts = det_a[2::3] == det_b[2::3] and a["ints"] == b["ints"]
    sums = [x for i, x in enumerate(det_a) if i % 3 != 2]
    ref = [x for i, x in enumerate(det_b) if i % 3 != 2]
    flows = [v for f in a["flow"] for v in f], [v for f in b["flow"] for v in f]
    return counts, max(_rel(sums, ref), _rel(a["fluxes"], b["fluxes"]), _rel(*flows))


def compare(other: str) -> int:
    from artes_tpu_torch import probe_splat as P
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    other = os.path.abspath(other)
    card = card_line()
    runs = [("other", other), ("this", here), ("this", here), ("other", other)]
    got = {"other": [], "this": []}
    for label, path in runs:
        got[label].append(_times(path))
        print(f"[compare] {label} ({path}) done", flush=True)
    ok = True
    for key in got["this"][0]["cells"]:
        t = [r["cells"][key]["ms"] for r in got["this"]]
        o = [r["cells"][key]["ms"] for r in got["other"]]
        counts, rel = _same(got["this"][0]["cells"][key], got["other"][0]["cells"][key])
        ok = ok and counts and rel <= SUM_RTOL
        print(f"[compare] {key}: other {o[0]:.3f} / {o[1]:.3f} ms, this {t[0]:.3f} / "
              f"{t[1]:.3f} ms ({min(o) / min(t):.3f}x); counts "
              f"{'equal' if counts else 'DIFFERENT'}, sums within {rel:.3e}; {card}")
    for key in got["this"][0]["plain"]:
        t = [r["plain"][key]["ms"] for r in got["this"]]
        o = [r["plain"][key]["ms"] for r in got["other"]]
        counts, rel = _same(got["this"][0]["plain"][key], got["other"][0]["plain"][key])
        print(f"[compare] plain {key}: other {o[0]:.1f} / {o[1]:.1f} ms, this {t[0]:.1f} / "
              f"{t[1]:.1f} ms ({min(o) / min(t):.3f}x); counts "
              f"{'equal' if counts else 'DIFFERENT'}, sums within {rel:.3e}; {card}")
    for npix in got["this"][0]["probe"]:
        t = [r["probe"][npix]["ms"] for r in got["this"]]
        o = [r["probe"][npix]["ms"] for r in got["other"]]
        same = all(got["this"][0]["probe"][npix][k] == r["probe"][npix][k]
                   for r in got["other"] for k in ("counts", "vals"))
        lib_v, lib_vc = P.library_yardsticks(int(npix))
        print(f"[compare] probe_splat {npix} px: other {o[0]:.3f} / {o[1]:.3f} ms, this "
              f"{t[0]:.3f} / {t[1]:.3f} ms ({min(o) / min(t):.3f}x); totals "
              f"{'equal' if same else 'DIFFERENT'}; index_add_ values {lib_v:.3f} ms, values "
              f"and counts {lib_vc:.3f} ms; {card}")
    for label in ("other", "this"):
        rounds = [r["rounds"] for r in got[label]]
        print(f"[compare] probe yardstick, {label}: baseline loop "
              + " / ".join(f"{r['base']:.5f}" for r in rounds) + " us/round; splat net of it "
              + "; ".join(f"{npix} px " + " / ".join(f"{r['net'][npix]:.4f}" for r in rounds)
                          for npix in rounds[0]["net"]) + f" us/round; {card}")
    t = [r["mesh"]["ms"] for r in got["this"]]
    o = [r["mesh"]["ms"] for r in got["other"]]
    mine = got["this"][0]["mesh"]
    same = all(mine["counts"] == r["mesh"]["counts"]
               and _rel([mine["sums"]], [r["mesh"]["sums"]]) <= SUM_RTOL for r in got["other"])
    ok = ok and same
    print(f"[compare] mesh reduction alone (flagship, 2^20 photons, one NCCL rank): other "
          f"{o[0] * 1e3:.1f} / {o[1] * 1e3:.1f} us, this {t[0] * 1e3:.1f} / {t[1] * 1e3:.1f} us "
          f"({min(o) / min(t):.3f}x); totals {'equal' if same else 'DIFFERENT'}; {card}")
    return 0 if ok else 1


def _peel_events(out) -> dict:
    """``{(photon id, scatterings): record}`` of a run's failed scatter peels."""
    rec = out["error_records"]
    rows = rec[(rec[:, 0] == 50.0) & (rec[:, 15] == 3.0)]
    return {(int(r[1]), int(r[14])): r for r in rows}


def _walk_fails(tables, static, rows) -> float:
    """The share of recorded states whose peel walk toward the observer fails
    again in the plain version on ``tables``."""
    import torch
    from artes_tpu_torch.transport import kernel
    if len(rows) == 0:
        return math.nan
    rows = torch.stack(rows).to(tables.opacity.device)
    w = kernel._tau_walk_march(tables, static, rows[:, 2:5].to(tables.opacity.dtype),
                               tables.det_dir, rows[:, 8:11].long(), rows[:, 11:13].long(),
                               torch.ones(len(rows), dtype=torch.bool, device=rows.device))
    return float((w["error"] | w["capped"]).double().mean())


def rates() -> int:
    import torch
    from artes_tpu_torch import cells
    from artes_tpu_torch.transport import kernel, pool_cuda
    card = card_line()
    ok = True
    for name, atm in (("hydrostatic39_surface", cells.hydrostatic39()),
                      ("grid3d_2496_surface", cells.grid3d_2496())):
        tables, static = cells.run_tables(atm, "cuda", surface_albedo=0.5)
        n = 1 << 16
        k = pool_cuda.run_stream_cuda(tables, static, n, SEED, err_k=pool_cuda.REC_CAP)
        p = kernel.run_stream(tables, static, n, SEED, n, err_k=n)
        tallies = {}
        for key, pick in (("031", lambda o: o["error_codes"][0]),
                          ("032", lambda o: o["error_codes"][1]),
                          ("034", lambda o: o["error_codes"][2]),
                          ("peel", lambda o: o["error_codes"][3]),
                          ("n_error", lambda o: o["n_error"]),
                          ("n_alive_at_cap", lambda o: o["n_alive_at_cap"])):
            a, b = int(pick(k)), int(pick(p))
            within = abs(a - b) <= 3.0 * math.sqrt(a + b)
            ok = ok and within
            tallies[key] = f"{a} / {b}{'' if within else ' OUTSIDE 3 sigma'}"
        print(f"[rates] {name} uncut (max_scatter {static.max_scatter}), {n} photons, seed "
              f"{SEED}, kernel / plain: {tallies}; {card}", flush=True)
        ev_k, ev_p = _peel_events(k), _peel_events(p)
        only_k = [ev_k[e] for e in sorted(set(ev_k) - set(ev_p))]
        only_p = [ev_p[e] for e in sorted(set(ev_p) - set(ev_k))]
        t64, s64 = cells.run_tables(atm, "cuda", dtype=torch.float64, surface_albedo=0.5)
        pids_k = {e[0] for e in ev_k}
        print(f"[rates] {name} failed scatter peels by event: kernel alone {len(only_k)}, "
              f"plain alone {len(only_p)}, both {len(set(ev_k) & set(ev_p))}; of the plain "
              f"version's lone events {sum(int(r[1]) in pids_k for r in only_p)} on photons "
              f"with a kernel event elsewhere; walked again from the recorded state, the "
              f"plain version's lone events fail {_walk_fails(tables, static, only_p):.3f} "
              f"in float32 and {_walk_fails(t64, s64, only_p):.3f} in float64, the kernel's "
              f"lone events {_walk_fails(tables, static, only_k):.3f} and "
              f"{_walk_fails(t64, s64, only_k):.3f}", flush=True)
    tables, static = cells.spectrum_tables(cells.grid3d_2496(), "cuda")
    n = 1 << 25
    pool_cuda.run_stream_cuda(tables, static, n, 29)                  # bench.py's warm launch
    out = pool_cuda.run_stream_cuda(tables, static, n, 30)
    torch.cuda.synchronize()
    a, b = int(out["n_error"]), TPU_GRID3D_N_ERROR
    within = abs(a - b) <= 3.0 * math.sqrt(a + b)
    ok = ok and within
    print(f"[rates] grid3d_2496, {n} photons, seed 30: kernel abandoned {a} "
          f"{out['error_codes'].tolist()} ({a / n:.3e} of the photons) against the TPU's {b} "
          f"(BENCH_r05): |a - b| {abs(a - b)}, 3 sqrt(a + b) {3.0 * math.sqrt(a + b):.1f}, "
          f"{'within' if within else 'OUTSIDE'}; {card}")
    return 0 if ok else 1


# pool_march.cu's float32 chains, rounded op by op: (site, file, text, replacement)
_OP_BY_OP_FORM = ("__fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(a2, u[0]), v[0]), "
                  "__fmul_rn(__fmul_rn(b2, u[1]), v[1])), __fmul_rn(__fmul_rn(c2, u[2]), v[2]))")
_SITES = (
    ("qc", "pool_geom3d.cuh", "__fmaf_rn(-r_face, r_face, r.Cq)",
     "__fsub_rn(r.Cq, __fmul_rn(r_face, r_face))"),
    ("qa, qb, Cq", "pool_geom3d.cuh",
     "return __fmaf_rn(__fmul_rn(c2, u[2]), v[2],\n"
     "                   __fmaf_rn(__fmul_rn(a2, u[0]), v[0], "
     "__fmul_rn(__fmul_rn(b2, u[1]), v[1])));",
     "return " + _OP_BY_OP_FORM + ";"),
    ("disc", "pool_geom3d.cuh", "__fmaf_rn(qb, qb, -__fmul_rn(__fmul_rn(4.0f, qa), qc))",
     "__fsub_rn(__fmul_rn(qb, qb), __fmul_rn(__fmul_rn(4.0f, qa), qc))"),
    ("phi", "pool_geom3d.cuh",
     "__fmaf_rn(__fmul_rn(S.ob[1], d[1]), cos_p,\n"
     "                                -__fmul_rn(__fmul_rn(S.ob[0], d[0]), sin_p))",
     "__fsub_rn(__fmul_rn(__fmul_rn(S.ob[1], d[1]), cos_p), "
     "__fmul_rn(__fmul_rn(S.ob[0], d[0]), sin_p))"),
    ("phi", "pool_geom3d.cuh",
     "__fmaf_rn(__fmul_rn(S.ob[0], p[0]), sin_p,\n"
     "                            -__fmul_rn(__fmul_rn(S.ob[1], p[1]), cos_p))",
     "__fsub_rn(__fmul_rn(__fmul_rn(S.ob[0], p[0]), sin_p), "
     "__fmul_rn(__fmul_rn(S.ob[1], p[1]), cos_p))"),
    ("pos", "pool_march.cu", "pos[i] = __fmaf_rn(st.dist, d[i], pos[i]);",
     "pos[i] = __fadd_rn(pos[i], __fmul_rn(st.dist, d[i]));"),
    ("pos", "pool_march.cu", "pos[i] = __fmaf_rn(step, dir[i], pos[i]);",
     "pos[i] = __fadd_rn(pos[i], __fmul_rn(step, dir[i]));"),
)
_CHAIN_SITES = ("qc", "qa, qb, Cq", "disc", "phi", "pos")
# each kernel's builds: label -> (sites of _SITES rounded op by op, extra
# nvcc flags); the first two are the ones the adoption rule of -fmad=false
# compares, pool_march's others PR 8's chain variants
_GATE_BUILDS = {"contracted": ((), ()), "-fmad=false": ((), ("-fmad=false",))}
_CONTRACTION = {
    "pool_radial": _GATE_BUILDS,
    "pool_march": {**_GATE_BUILDS,
                   "-fmad=false, chains op by op": (_CHAIN_SITES, ("-fmad=false",)),
                   **{f"{site} op by op": ((site,), ()) for site in _CHAIN_SITES}},
}


def _contraction_build(source: str, label: str) -> str:
    """Build ``csrc/<source>.cu``'s variant ``label`` of :data:`_CONTRACTION`
    under build/contraction/; its path."""
    import shutil
    from artes_tpu_torch import _build
    sites, extra = _CONTRACTION[source][label]
    root = os.path.join(os.path.dirname(_build.BUILD_DIR), "contraction",
                        source + "_" + re.sub(r"\W+", "_", label))
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, root)
    for site, name, old, new in _SITES:
        if site in sites:
            path = os.path.join(root, name)
            with open(path) as fh:
                text = fh.read()
            if text.count(old) != 1:
                raise RuntimeError(f"{label}: {name} holds {text.count(old)} of {old!r}")
            with open(path, "w") as fh:
                fh.write(text.replace(old, new))
    lib = os.path.join(root, f"lib{source}.so")
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, *extra, "-o", lib,
                           os.path.join(root, source + ".cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{source} {label}: nvcc failed\n{proc.stdout}{proc.stderr}")
    return lib


def _plain_run(name: str, seed: int) -> tuple[float, dict]:
    """A configuration of :func:`gate_configs` run by its plain version at
    its gate photons on the card (in a worker process): its time [ms] and
    its result on the host."""
    import time
    import torch
    from artes_tpu_torch.cells import gate_photons
    from artes_tpu_torch.transport import kernel
    tables, static = gate_configs()[name]("cuda")
    n = gate_photons(tables, static)
    t0 = time.perf_counter()
    out = kernel.run_stream(tables, static, n, seed, n)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return ms, {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in out.items()}


def contraction_verdict(ratios: dict, times: dict) -> tuple[bool, str]:
    """Whether -fmad=false is adopted for a kernel in place of contraction,
    and why: ``ratios`` maps each build to ``{cell: worst gap over limit}``,
    ``times`` each build to the deciding cell's kernel time."""
    label = "-fmad=false"
    off, on = ratios[label], ratios["contracted"]
    risen = [c for c in on if off[c] > on[c]]
    worst_on, worst_off = max(on.values()), max(off.values())
    cost = times[label] / times["contracted"]
    adopt = not risen and worst_off < worst_on and cost <= CONTRACTION_MAX_COST
    return adopt, (f"cells whose ratio rises {risen or 'none'}; worst ratio {worst_on:.4g} -> "
                   f"{worst_off:.4g}; time {cost:.4f}x (at most {CONTRACTION_MAX_COST})")


def _gate_reading(source: str, libs: dict, card: str) -> None:
    """Each gate cell of ``source``'s kernel with both builds of ``libs``:
    gaps to the plain version, kernel times in turns, and the verdict on
    -fmad=false against the contracted build."""
    import torch
    from concurrent.futures import ProcessPoolExecutor
    from artes_tpu_torch import _build, cells
    from artes_tpu_torch.cells import KERNEL_CELLS, gate_photons
    from artes_tpu_torch.transport import pool_cuda
    setups = {}
    for name, make in KERNEL_CELLS.items():
        tables, static = make("cuda")
        if pool_cuda.kernel_of(tables, static)[0] == source:
            setups[name] = (tables, static, gate_photons(tables, static))
    ex = ProcessPoolExecutor(cells.PLAIN_TOGETHER,
                             mp_context=torch.multiprocessing.get_context("spawn"))
    try:
        labels = tuple(libs)
        times = {label: {name: [] for name in setups} for label in labels}
        outs = {}
        for label in labels + labels[::-1]:                       # in turns
            _build._LIBS[source] = ctypes.CDLL(libs[label])
            for name, (tables, static, n) in setups.items():
                pool_cuda.run_stream_cuda(tables, static, n, SEED)               # warm-up
                ms = []
                for _ in range(REPS):
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    out = pool_cuda.run_stream_cuda(tables, static, n, SEED)
                    b.record()
                    torch.cuda.synchronize()
                    ms.append(a.elapsed_time(b))
                times[label][name].append(sorted(ms)[len(ms) // 2])
                outs.setdefault((label, name), out)
        plain = {name: ex.submit(_plain_run, name, SEED) for name in setups}
        ratios = {label: {} for label in labels}
        for name, (tables, static, n) in setups.items():
            ref = plain[name].result()[1]
            limits = pool_cuda.limits_of(tables, static)
            for label in labels:
                g = pool_cuda.gaps(outs[label, name], ref)
                ratios[label][name] = pool_cuda.worst_ratio(g, limits)
                print(f"[contraction] {source} {label}: {name}, {n} photons, seed {SEED}: "
                      + " ".join(f"{k}={_fmt(v)}" for k, v in g.items())
                      + f"; worst gap / limit {ratios[label][name]:.4g}; kernel "
                      + " / ".join(f"{t:.3f}" for t in times[label][name]) + f" ms; {card}",
                      flush=True)
    finally:
        ex.shutdown(cancel_futures=True)
        _build._LIBS.pop(source, None)
    cell = CONTRACTION_TIME_CELL[source]
    best = {label: min(times[label][cell]) for label in labels}
    adopt, why = contraction_verdict(ratios, best)
    print(f"[contraction] {source} verdict on -fmad=false: "
          f"{'adopt' if adopt else 'keep contraction'}: {why}; time cell {cell}; {card}",
          flush=True)


def contraction() -> int:
    import torch
    from concurrent.futures import ThreadPoolExecutor
    from artes_tpu_torch import _build, cells
    from artes_tpu_torch.transport import pool_cuda
    card = card_line()
    builds = [(source, label) for source in CONTRACTION_KERNELS for label in _CONTRACTION[source]]
    with ThreadPoolExecutor(len(builds)) as pool:       # one nvcc a build, all at once
        paths = dict(zip(builds, pool.map(lambda b: _contraction_build(*b), builds)))
    # the gate reading of the two builds the rule compares; pool_march's
    # chain variants are read on the uncut surface cells below
    for source in CONTRACTION_KERNELS:
        _gate_reading(source, {label: paths[source, label] for label in _GATE_BUILDS}, card)
    setups = [(name, *cells.run_tables(atm, "cuda", surface_albedo=0.5)) for name, atm in
              (("hydrostatic39_surface", cells.hydrostatic39()),
               ("grid3d_2496_surface", cells.grid3d_2496()))]
    try:
        for label in _CONTRACTION["pool_march"]:
            _build._LIBS["pool_march"] = ctypes.CDLL(paths["pool_march", label])
            for name, tables, static in setups:
                for n in (1 << 16, 1 << 20):
                    out = pool_cuda.run_stream_cuda(tables, static, n, SEED)
                    torch.cuda.synchronize()
                    print(f"[contraction] pool_march {label}: {name} uncut, {n} photons, seed "
                          f"{SEED}: 031 / 032 / 034 / peel {out['error_codes'].tolist()}, "
                          f"capped {int(out['n_alive_at_cap'])}; {card}", flush=True)
    finally:
        _build._LIBS.pop("pool_march", None)
    return 0


def ptxas_summary(name: str) -> str:
    """Registers and spills of the stellar instantiation
    (``pool_radial_kernel<false, false, false>``) from library ``name``'s
    ``-Xptxas -v`` report."""
    from artes_tpu_torch import _build
    with open(_build.library_path(name) + ".log") as fh:
        text = fh.read()
    # the report's entry lines name the mangled kernel; Lb0ELb0ELb0E is <false, false, false>
    block = re.search(r"Compiling entry function '(_Z\w*pool_radial_kernelILb0ELb0ELb0E\w*)'"
                      r"(.*?)(?=Compiling entry function|\Z)", text, re.S)
    if block is None:
        return "no ptxas report for the stellar instantiation"
    regs = re.search(r"Used (\d+) registers", block.group(2))
    spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block.group(2))
    return (f"{regs.group(1) if regs else '?'} registers, "
            f"{spill.group(1) if spill else '?'} B spill stores, "
            f"{spill.group(2) if spill else '?'} B spill loads")


def _read_clocks():
    """The instrumented build's (phases + 1, 3) rows since the last read:
    cycles, entries, lanes active at entry; the last row is the warps' whole
    time. Reading resets them."""
    import torch
    from artes_tpu_torch import _build
    fn = _build.load("pool_radial_clocks").artes_pool_radial_clocks
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    host = (ctypes.c_ulonglong * (3 * (len(PHASES) + 1)))()
    rows = fn(ctypes.addressof(host), 1)
    if rows != len(PHASES) + 1:
        raise RuntimeError(f"pool_radial_clocks returned {rows} rows")
    return torch.tensor(list(host), dtype=torch.float64).reshape(rows, 3)


def clocks(names: list[str], n: int) -> int:
    """Print the phase split of each radial cell of ``names`` at ``n`` photons."""
    import torch
    from artes_tpu_torch.cells import KERNEL_CELLS
    from artes_tpu_torch.transport import pool_cuda
    card = card_line()
    for name in names:
        tables, static = KERNEL_CELLS[name]("cuda")
        pool_cuda.run_stream_cuda(tables, static, n, SEED, build="pool_radial_clocks")     # warm-up
        torch.cuda.synchronize()
        _read_clocks()
        out = pool_cuda.run_stream_cuda(tables, static, n, SEED, build="pool_radial_clocks")
        torch.cuda.synchronize()
        rows = _read_clocks()
        total = rows[-1, 0]
        print(f"[clocks] {name}, {n} photons: {int(out['n_emitted'])} emitted, "
              f"{int(out['detector'][:, 1, 2].sum())} scatter peels; warps' cycles "
              f"{total:.4g}, {rows[:-1, 0].sum() / total:.3f} of them in the phases below; "
              f"pool_radial_clocks {ptxas_summary('pool_radial_clocks')}; {card}")
        for k, label in enumerate(PHASES):
            cycles, entries, lanes = rows[k].tolist()
            if entries == 0:
                continue
            print(f"[clocks]   {label:22s} {cycles / total:6.3f} of the cycles, "
                  f"{cycles / entries:9.1f} cycles an entry, {int(entries)} warp entries, "
                  f"SIMT efficiency {lanes / entries / 32.0:.3f}")
    return 0


def gate_configs() -> dict:
    """Every configuration a table of ``pool_cuda.LIMITS`` holds: the gate
    cells of ``cells.KERNEL_CELLS`` and the BASELINE chains' own,
    ``cells.CHAIN_CELLS``."""
    from artes_tpu_torch import cells
    return {**cells.KERNEL_CELLS, **cells.CHAIN_CELLS}


def _fmt(v) -> str:
    return f"{v:.4g}" if isinstance(v, float) else ",".join(f"{x:.4g}" for x in v)


def gate(walks: list[str], seed_list: list[int]) -> int:
    """Read every configuration of each walk in ``walks`` (kernel against
    plain version at its gate photons, each seed of ``seed_list``) and print
    the worst gap of each key with the configuration and seed that gave it,
    beside today's limit and the one ``pool_cuda.limits_from`` gives; 1 when
    a reading is over today's limit."""
    import torch
    from concurrent.futures import ProcessPoolExecutor
    from artes_tpu_torch import cells
    from artes_tpu_torch.baselines import LIMIT_NAMES
    from artes_tpu_torch.cells import gate_photons
    from artes_tpu_torch.transport import kernel, pool_cuda
    card = card_line()
    ok = True
    for walk in walks:
        setups = {}
        for name, make in gate_configs().items():
            tables, static = make("cuda")
            if kernel.walk_mode(tables, static) == walk:
                setups[name] = (tables, static, gate_photons(tables, static))
        old = pool_cuda.LIMITS[walk]
        ex = ProcessPoolExecutor(cells.PLAIN_TOGETHER,
                                 mp_context=torch.multiprocessing.get_context("spawn"))
        readings = []                                   # (name, seed, gaps, event counts)
        try:
            plain = {(name, seed): ex.submit(_plain_run, name, seed)
                     for seed in seed_list for name in setups}
            for (name, seed), fut in plain.items():
                tables, static, n = setups[name]
                out = pool_cuda.run_stream_cuda(tables, static, n, seed)
                ms, ref = fut.result()
                g = pool_cuda.gaps(out, ref)
                readings.append((name, seed, g, pool_cuda.event_counts(ref)))
                over = [key for key in old if not pool_cuda.agrees({key: g[key]}, {key: old[key]})]
                ok = ok and not over
                print(f"[gate] {walk} {name}, {n} photons, seed {seed}: "
                      + " ".join(f"{k}={_fmt(v)}" for k, v in g.items())
                      + f"; worst gap / limit {pool_cuda.worst_ratio(g, old):.4g}, over "
                      f"{over or 'none'}; plain {ms:.1f} ms; {card}", flush=True)
        finally:
            ex.shutdown(cancel_futures=True)
        floors = pool_cuda.floors_of([r[3] for r in readings])
        new = pool_cuda.limits_from([r[2] for r in readings], old, floors)
        for key, lim in old.items():
            tup = isinstance(lim, tuple)
            for i, (o, n_new) in enumerate(zip(lim, new[key]) if tup else [(lim, new[key])]):
                vals = [(r[2][key][i] if tup else r[2][key], r[0], r[1]) for r in readings]
                val, name, seed = max(vals, key=lambda v: math.inf if math.isnan(v[0]) else v[0])
                print(f"[gate] {walk} {key}{f'[{i}]' if tup else ''}: worst {val:.4g} ({name}, "
                      f"seed {seed}); limit {o:.4g} -> {n_new!r} (floor {floors[key]:.4g}); "
                      f"{card}")
        print(f"[gate] {walk}: {len(setups)} configurations x seeds {seed_list}; "
              f"{LIMIT_NAMES[walk]} by the rule = {new!r}; {card}", flush=True)
    return 0 if ok else 1


# the float32 functions the plain version calls through torch, rounded as the
# pool kernels round them (nvcc with _build.SOURCE_FLAGS' -fmad=false): the
# probe library that ``parting`` builds under build/probe_ops/
PROBE_OPS = ("arccos", "cos", "sin", "exp", "log", "tan", "arctan2")
_PROBE_OPS_SRC = r"""
#include <cuda_runtime.h>
__global__ void unary(int op, const float* x, float* y, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float v = x[i];
    y[i] = op == 0 ? acosf(v) : op == 1 ? cosf(v) : op == 2 ? sinf(v)
         : op == 3 ? expf(v) : op == 4 ? logf(v) : tanf(v);
  }
}
__global__ void binary(const float* a, const float* b, float* y, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    y[i] = atan2f(a[i], b[i]);
}
extern "C" int artes_probe_op(int op, const float* a, const float* b, float* y, long long n) {
  if (n > 0) {
    if (op == 6) binary<<<1024, 256>>>(a, b, y, n);
    else unary<<<1024, 256>>>(op, a, y, n);
  }
  return (int)cudaDeviceSynchronize();
}
"""


def _probe_ops():
    """The probe library's ``artes_probe_op``, built at first use."""
    from artes_tpu_torch import _build
    root = os.path.join(os.path.dirname(_build.BUILD_DIR), "probe_ops")
    os.makedirs(root, exist_ok=True)
    src, lib = os.path.join(root, "probe_ops.cu"), os.path.join(root, "libprobe_ops.so")
    with open(src, "w") as fh:
        fh.write(_PROBE_OPS_SRC)
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-fmad=false", "-o", lib, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"probe_ops: nvcc failed\n{proc.stdout}{proc.stderr}")
    fn = ctypes.CDLL(lib).artes_probe_op
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
    fn.restype = ctypes.c_int
    return fn


def _as_kernel(fn, name, orig):
    """``torch.<name>`` with its float32 CUDA calls rounded as the kernels
    round them."""
    import torch
    op = PROBE_OPS.index(name)

    def call(*args, **kw):
        if kw or not all(isinstance(a, torch.Tensor) and a.is_cuda and a.dtype == torch.float32
                         for a in args):
            return orig(*args, **kw)
        a = torch.broadcast_tensors(*args) if len(args) == 2 else args
        a = [x.contiguous() for x in a]
        y = torch.empty_like(a[0])
        torch.cuda.synchronize()
        rc = fn(op, a[0].data_ptr(), a[-1].data_ptr(), y.data_ptr(), y.numel())
        if rc != 0:
            raise RuntimeError(f"probe_ops {name}: cudaError {rc}")
        return y
    return call


def parting(name: str, seed: int, count: int) -> int:
    """Where the kernel and its plain version part on ``name`` at its gate
    photons and ``seed``: each function of :data:`PROBE_OPS` against the
    kernels' rounding of it on 2^24 inputs from its domain, then the first
    ``count`` photons (by id, found by bisection) whose counts, capped or
    abandoned photons part, each run again by the plain version with each
    function, and with all, rounded as the kernels round them."""
    import torch
    from artes_tpu_torch.cells import gate_photons
    from artes_tpu_torch.transport import kernel, pool_cuda
    card = card_line()
    fn = _probe_ops()
    orig = {op: getattr(torch, op) for op in PROBE_OPS}
    gen = torch.Generator("cuda").manual_seed(seed)
    m = 1 << 24
    u = torch.rand(m, device="cuda", generator=gen)
    domain = {"arccos": 2 * u - 1, "cos": 8 * u, "sin": 8 * u, "exp": -60 * u, "log": u + 1e-7,
              "tan": 1.5 * u, "arctan2": (2 * u - 1, torch.roll(2 * u - 1, 1))}
    for op in PROBE_OPS:
        x = domain[op] if isinstance(domain[op], tuple) else (domain[op],)
        mine = _as_kernel(fn, op, orig[op])(*x)
        ref = orig[op](*x)
        diff = mine != ref
        ulps = (mine.view(torch.int32) - ref.view(torch.int32)).abs().max()
        print(f"[parting] torch.{op} against the kernels' rounding on {m} inputs: "
              f"{int(diff.sum())} differ, by at most {int(ulps)} ulp; {card}", flush=True)
    tables, static = gate_configs()[name]("cuda")
    n = gate_photons(tables, static)

    def tallies(out):
        return (out["detector"][..., 2].cpu().tolist(), int(out["n_alive_at_cap"]),
                int(out["n_error"]), out["error_codes"].cpu().tolist())

    def both(lo, k):
        return (tallies(pool_cuda.run_stream_cuda(tables, static, k, seed, 0, lo)),
                tallies(kernel.run_stream(tables, static, k, seed, k, 0, lo)))

    def bisect(lo, k, want):
        a, b = both(lo, k)
        if a == b or want == 0:
            return []
        if k == 1:
            return [lo]
        found = bisect(lo, k // 2, want)
        return found + bisect(lo + k // 2, k - k // 2, want - len(found))

    photons = bisect(0, n, count)
    print(f"[parting] {name}, {n} photons, seed {seed}: the first {len(photons)} photons that "
          f"part: {photons}; {card}", flush=True)
    for pid in photons:
        mine = tallies(pool_cuda.run_stream_cuda(tables, static, 1, seed, 0, pid))
        for label, ops in [("none", ())] + [(op, (op,)) for op in PROBE_OPS] + \
                [("all", PROBE_OPS)]:
            try:
                for op in ops:
                    setattr(torch, op, _as_kernel(fn, op, orig[op]))
                plain = tallies(kernel.run_stream(tables, static, 1, seed, 1, 0, pid))
            finally:
                for op in ops:
                    setattr(torch, op, orig[op])
            print(f"[parting] photon {pid}, plain with {label} rounded as the kernels: "
                  f"{'equal to the kernel' if plain == mine else 'parts'} (kernel counts "
                  f"{mine[0]}, capped, abandoned {mine[1:3]}; plain {plain[0]}, {plain[1:3]})",
                  flush=True)
    return 0


def main(argv=None) -> int:
    import torch
    p = argparse.ArgumentParser(prog="python -m artes_tpu_torch.measure")
    sub = p.add_subparsers(dest="what", required=True)
    sub.add_parser("compare").add_argument("checkout")
    sub.add_parser("rates")
    sub.add_parser("contraction")
    c = sub.add_parser("clocks")
    c.add_argument("--cells", default="flagship,hydrostatic39")
    c.add_argument("--photons", type=int, default=PHOTONS)
    d = sub.add_parser("gate")
    d.add_argument("--walk", choices=("closed", "jumps", "march"))
    d.add_argument("--seeds", default="7,8,9,10")
    e = sub.add_parser("parting")
    e.add_argument("cell")
    e.add_argument("--seed", type=int, default=9)
    e.add_argument("--count", type=int, default=3)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("measure runs on a CUDA device; none found")
    sys.modules["jax"] = None
    if args.what == "compare":
        return compare(args.checkout)
    if args.what == "rates":
        return rates()
    if args.what == "contraction":
        return contraction()
    if args.what == "parting":
        return parting(args.cell, args.seed, args.count)
    if args.what == "gate":
        walks = [args.walk] if args.walk else ["closed", "jumps", "march"]
        return gate(walks, [int(x) for x in args.seeds.split(",")])
    return clocks(args.cells.split(","), args.photons)


if __name__ == "__main__":
    sys.exit(main())
