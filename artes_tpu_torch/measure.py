"""Measurements on the card that ``chip_smoke.py`` does not make.

Run from the root of a checkout on a machine with a CUDA card::

    python -m artes_tpu_torch.measure compare <other checkout>
    python -m artes_tpu_torch.measure rates
    python -m artes_tpu_torch.measure contraction
    python -m artes_tpu_torch.measure clocks [--cells flagship,hydrostatic39] [--photons N]
    python -m artes_tpu_torch.measure seeds <cell> [--seeds 7,8,9,10]

``compare`` times the kernels of another checkout of this repository (an
earlier commit, unpacked beside this one) and of this one on the same card,
in turns (other, this, this, other), one process each, on the cells of
``COMPARE_CELLS`` (``cells.KERNEL_CELLS``, seed 7): the radial pool kernel on
the flagship at 2^20 and 2^24 photons and on hydrostatic39, imaging25 and
thermal_iso at 2^20; the closed-form flow instantiations at 2^20; the 3-D
kernel on grid3d_2496, grid3d_thermal and blended_5184 at 2^18; the marching
kernel on every surface and marching flow cell at its gate photons
(``MARCH_CELLS``); the probe splat at 625, 2025 and 10201 pixels; and the
mesh reduction alone, a flagship launch of 2^20 photons summed over a
one-rank NCCL group as ``run_stream_mesh`` sums it. It prints each time
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
kernel's abandoned photons on grid3d_2496 at 2^24 photons, seed 30 (the
seed of the TPU's 774 of 2^25).

``contraction`` builds variants of ``csrc/pool_march.cu`` under ``build/``
(never loaded by the main path): the default (the walks' geometry in
explicit chains of fused multiply-adds, the rest as nvcc contracts it), the
rest with ``-fmad=false``, that with the chains rounded op by op too, and
the default with one chain at a time rounded op by op (``__fmul_rn``,
``__fadd_rn``): the sphere quadratic's constant term ``qc``, its ``qa``,
``qb`` and ``Cq``, the discriminant, the phi half-plane and the position
updates. Each runs the uncut surface cells of ``rates`` at 2^16 and 2^20
photons, seed 7, and prints its error tallies: the failed peels say which
chain decides them.

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

``seeds`` holds a gate cell of ``cells.KERNEL_CELLS`` against its plain
version at its gate photons at each seed, and prints every gap of
``pool_cuda.gaps`` beside the limit that holds the cell: the readings a
limit is set from.

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
                 ("blended_5184", 1 << 18)) + MARCH_CELLS
PROBE_SIZES = (625, 2025, 10201)
REPS = 5
SUM_RTOL = 1e-12
SEED = 7
PHASES = ("emission", "prewalk + first march", "roulette + peel_prep", "sample_beta",
          "sample_alpha", "rotation", "peel walk", "march")

# what runs in each checkout: the kernels' times and tallies as JSON on the
# last line of its output (the other checkout's package, never this one's)
_TIMES = r'''
import json, sys, torch
sys.modules["jax"] = None
from artes_tpu_torch.cells import KERNEL_CELLS
from artes_tpu_torch.transport import pool_cuda
from artes_tpu_torch import probe_splat as P
cells, sizes, reps = json.loads(sys.argv[1])
dev = torch.device("cuda")

def timed(fn):
    out = fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record(); out = fn(); b.record(); torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2], out

res = {"cells": {}, "probe": {}}
for name, n in cells:
    tables, static = KERNEL_CELLS[name](dev)
    ms, out = timed(lambda: pool_cuda.run_stream_cuda(tables, static, n, 7))
    flow = [out[k].cpu().reshape(-1).tolist() for k in ("flow_global", "flow_theta")
            if out.get(k) is not None]
    res["cells"][f"{name}@{n}"] = dict(
        ms=ms, detector=out["detector"].cpu().reshape(-1).tolist(),
        fluxes=[float(out["flux_emitted"]), float(out["flux_exit"])], flow=flow,
        ints=[int(out[k]) for k in ("n_emitted", "n_alive_at_cap", "n_error", "n_cell_face",
                                    "n_flow_booked")
              if out.get(k) is not None] + out["error_codes"].cpu().tolist())
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
    arg = json.dumps([COMPARE_CELLS, PROBE_SIZES, REPS])
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
    n = 1 << 24
    out = pool_cuda.run_stream_cuda(tables, static, n, 30)
    torch.cuda.synchronize()
    print(f"[rates] grid3d_2496, {n} photons, seed 30: kernel abandoned {int(out['n_error'])} "
          f"{out['error_codes'].tolist()} ({int(out['n_error']) / n:.3e} of the photons); {card}")
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
# variant -> (sites rounded op by op, extra nvcc flags)
_CONTRACTION = {"default": ((), ()), "-fmad=false": ((), ("-fmad=false",)),
                "-fmad=false, chains op by op": (_CHAIN_SITES, ("-fmad=false",)),
                **{f"{site} op by op": ((site,), ()) for site in _CHAIN_SITES}}


def _contraction_build(label: str) -> str:
    """Build pool_march.cu's variant ``label`` under build/; its path."""
    import shutil
    from artes_tpu_torch import _build
    sites, extra = _CONTRACTION[label]
    root = os.path.join(os.path.dirname(_build.BUILD_DIR), "contraction",
                        re.sub(r"\W+", "_", label))
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
    lib = os.path.join(root, "libpool_march.so")
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, *extra, "-o", lib,
                           os.path.join(root, "pool_march.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{label}: nvcc failed\n{proc.stdout}{proc.stderr}")
    return lib


def contraction() -> int:
    import torch
    from concurrent.futures import ThreadPoolExecutor
    from artes_tpu_torch import _build, cells
    from artes_tpu_torch.transport import pool_cuda
    card = card_line()
    with ThreadPoolExecutor(len(_CONTRACTION)) as pool:
        libs = dict(zip(_CONTRACTION, pool.map(_contraction_build, _CONTRACTION)))
    setups = [(name, *cells.run_tables(atm, "cuda", surface_albedo=0.5)) for name, atm in
              (("hydrostatic39_surface", cells.hydrostatic39()),
               ("grid3d_2496_surface", cells.grid3d_2496()))]
    try:
        for label, lib in libs.items():
            _build._LIBS["pool_march"] = ctypes.CDLL(lib)
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
        pool_cuda.run_stream_cuda(tables, static, n, SEED, clocks=True)     # warm-up
        torch.cuda.synchronize()
        _read_clocks()
        out = pool_cuda.run_stream_cuda(tables, static, n, SEED, clocks=True)
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


def seeds(name: str, seed_list: list[int]) -> int:
    from artes_tpu_torch.cells import KERNEL_CELLS, gate_photons
    from artes_tpu_torch.transport import kernel, pool_cuda
    card = card_line()
    tables, static = KERNEL_CELLS[name]("cuda")
    n, limits = gate_photons(tables, static), pool_cuda.limits_of(tables, static)
    ok = True
    for seed in seed_list:
        g = pool_cuda.gaps(pool_cuda.run_stream_cuda(tables, static, n, seed),
                           kernel.run_stream(tables, static, n, seed, n))
        over = [key for key in limits if not pool_cuda.agrees({key: g[key]}, {key: limits[key]})]
        ok = ok and not over
        print(f"[seeds] {name}, {n} photons, seed {seed}: " + " ".join(
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}=" + ",".join(f"{x:.4g}" for x in v)
            for k, v in g.items()) + f"; over their limits: {over or 'none'} ({card})",
            flush=True)
    return 0 if ok else 1


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
    d = sub.add_parser("seeds")
    d.add_argument("cell")
    d.add_argument("--seeds", default="7,8,9,10")
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
    if args.what == "seeds":
        return seeds(args.cell, [int(x) for x in args.seeds.split(",")])
    return clocks(args.cells.split(","), args.photons)


if __name__ == "__main__":
    sys.exit(main())
