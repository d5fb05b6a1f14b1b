"""The hand-written CUDA pool kernels and their wrapper.

Replaces ``artes_tpu.transport.pallas_stream.run_stream_pallas``: three
kernels, chosen by the walks a configuration takes
(``kernel.walk_mode``):

* ``csrc/pool_radial.cu``: radial grids without a Lambert surface,
  closed-form walks, with or without flow diagnostics;
* ``csrc/pool_grid3d.cu``: 3-D grids without a surface and without flow,
  jump walks and the marching ``cell_face`` walk behind an exit precheck;
* ``csrc/pool_march.cu``: any grid with a Lambert surface and 3-D grids with
  flow, marching walks for everything, the surface event and its peel, the
  flow booking, peel and prewalk errors.

Stellar or thermal sources, any detector size, float32 tables, with or
without the Stokes-anomaly check of ``--debug-stokes`` and with scattering
on or off (runtime flags). :func:`run_stream_cuda` takes the tables on a
CUDA device and returns the tallies of
:func:`~artes_tpu_torch.transport.kernel.run_stream`, its plain PyTorch
version. It launches on PyTorch's current stream; a kernel that can abandon
photons (any but the radial kernel without ``--debug-stokes``) is waited
for, for its error records.

Every kernel has an instantiation per source (stellar, thermal) and
detector (single pixel, image), and the radial and marching ones per flow
switch (:data:`VARIANTS` ... :data:`VARIANTS_MARCH`). ``LAUNCHES`` counts
kernel launches per instantiation, where the kernel is launched and nowhere
else, so a run can show that it went through the kernel.

One contract holds for the three kernels: a launch fills one
:class:`PoolLaunch`, the mirror of ``struct PoolLaunch`` of
``csrc/pool_common.cuh``, and makes one call, ``artes_<kernel>_launch``,
which writes the grid it launched into the struct; ``artes_<kernel>_blocks``
gives that grid beforehand and ``artes_<kernel>_layout`` the sizes that
:func:`_library` checks. Each kernel's out_i counters are named once, in
:data:`OUT_I_SLOTS`, and read by name.

A launch's tallies live in two allocations, one float64 and one int64
(:func:`tally_views`): every tally of the result is a view into them, so the
mesh sums a launch with one ``all_reduce`` of each (``parallel.mesh``).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from artes_tpu_torch import _build, spans
from artes_tpu_torch.transport import geometry as G
from artes_tpu_torch.transport import rng as R
from artes_tpu_torch.transport import sampling as S
from artes_tpu_torch.transport.kernel import (ERR_RECORD_K, ERR_RECORD_W, KernelStatic,
                                              TransportTables, detector_from_tallies,
                                              emit_basis, select_error_records, walk_mode)

# instantiation names by variant (bit 0 thermal, bit 1 image, bit 2 flow)
VARIANTS = ("stellar", "thermal", "image", "thermal_image")
VARIANTS_FLOW = tuple(v + "_flow" for v in VARIANTS)
VARIANTS_3D = tuple("grid3d_" + v for v in VARIANTS)
VARIANTS_MARCH = tuple("march_" + v for v in VARIANTS + VARIANTS_FLOW)
LAUNCHES = dict.fromkeys(VARIANTS + VARIANTS_FLOW + VARIANTS_3D + VARIANTS_MARCH, 0)

THREADS = 256
# the lane counters of the three kernels (pool_common.cuh::lane_pass) while
# spans record: a warp's passes through the persistent loop's refill branch and
# the lanes active at each, then the same for its scattering rounds
LANE_KEYS = ("refill_passes", "refill_lanes", "round_passes", "round_lanes")
# pool_grid3d's walk counters after them (pool_grid3d.cu::count_walk): its jump
# walks, and those that read the walk's table of phi half-plane crossings
WALK_KEYS = ("jump_walks", "jump_walks_tabled")
# pool_radial's drain stamps after them (pool_radial.cu::drain_stamp), in every
# instantiation: the earliest time a block left the persistent loop (as its
# complement) and the latest, %globaltimer in ns; the launch span's drain_ms
DRAIN_KEYS = ("drain_first", "drain_last")
# the most phi faces a grid may have for the jump walks to keep their phi
# crossings in a table (pool_grid3d.cu::PHI_TABLE_MAX); past it they recount
PHI_TABLE_MAX = 32
N_SCAL = 32
N_OUT_D = 10
N_IMG_D = 8
N_IMG_I = 2
# each kernel's out_i counters by name, in the order its reduce_block adds
# them (pool_radial.cu N_OUT_IR, pool_geom3d.cuh C_*, pool_march.cu C_*):
# the scatter peels, the photons capped at max_scatter, the photons emitted,
# the birth peels (with pool_march's surface peels); then pool_radial's photons
# abandoned on a Stokes anomaly, the only ones it abandons, and in its flow
# instantiations the walked segments that booked flow; pool_grid3d's photons
# abandoned, by code 031, 032 and 034, and on a Stokes anomaly; pool_march's
# also its failed peel walks (code 05x), its passes of cell_face and those
# that booked flow
OUT_I_SLOTS = {
    "pool_radial": ("scatter_peels", "capped", "emitted", "birth_peels", "anomalies"),
    "pool_radial_flow": ("scatter_peels", "capped", "emitted", "birth_peels", "anomalies",
                         "flow_booked"),
    "pool_grid3d": ("scatter_peels", "capped", "emitted", "birth_peels", "abandoned", "e031",
                    "e032", "e034", "anomalies"),
    "pool_march": ("scatter_peels", "capped", "emitted", "birth_peels", "abandoned", "e031",
                   "e032", "e034", "anomalies", "peel_walks_failed", "cell_face",
                   "flow_booked"),
}
FLOW_BUF_MAX = 256 << 20        # bytes of the blocks' copies of the flow sums
F_CRESCENT, F_BIASED, F_DEBUG_STOKES, F_NO_SCATTER = 1, 2, 4, 8
# rows of the 3-D kernel's error-record buffer (64 bytes each); errors are
# about 1e-4 of the photons, so one launch of up to 2^30 photons may drop
# rows of the middle, never a count
REC_CAP = 1 << 16

# How far the kernel may stray from its plain version on the same photon
# streams in float32. "count" is the Stokes-I row's count (scatter plus birth
# peels) and "count_quv" the Q, U, V rows' count (scatter peels), each summed
# over the pixels and relative to the plain sum; "pixel_I" and "pixel_N" are
# sum_p |dI_p| / sum_p I_p and sum_p |dN_p| / sum_p N_p over the pixels (the
# Stokes-I row), which see a shifted or transposed image; "pixel_V" is
# sum_p |dV_p| / sum_p |V_p| over the pixels' Stokes V, scaled by V itself
# ("stokes" scales V's gap by I, and "squares" cannot see V's sign); "capped"
# is the photons stopped at max_scatter, "n_error" the photons abandoned but
# on a Stokes anomaly and "error_codes" the largest per-code difference (the
# marching walks' peel-walk code among them), each as a share of the photons
# emitted; "stokes" the sums of I, Q, U, V as |dS_k| <= lim_k * I; "squares"
# each sum of squares relative to its own plain value; "flux_emitted" and
# "flux_exit" relative to the plain value (0 when both are 0); "flow_global"
# sum |d flow| over all cells and columns relative to the energy x distance
# the plain version booked in all (its "flow_path": the signed projections
# nearly cancel in a cell, their unsigned total does not); "flow_theta" sum
# |d flow| / sum flow, whose terms are energies (both 0 when there is no
# flow); "stokes_anomaly" the photons abandoned on a Stokes anomaly
# (--debug-stokes, error 050), as a share of the photons emitted.
#
# AGREE holds the closed-form walks of radial grids, AGREE_3D the jump walks
# of 3-D grids, AGREE_MARCH the marching walks (Lambert surfaces on any grid,
# flow on 3-D grids), each at cells.gate_photons. Each table is the output of
# limits_from over readings of `python -m artes_tpu_torch.measure gate`: the
# kernels built with -fmad=false (_build.SOURCE_FLAGS) against the plain
# version, whose walks add their terms in the kernels' order
# (radial.left_scan), at seeds 7-10 on every configuration
# the table holds, the gate cells of cells.KERNEL_CELLS and the BASELINE
# chains' cells.CHAIN_CELLS (NVIDIA H100 80GB HBM3, 700 W). Closed-form
# walks (20 configurations, 2^20 photons): every count equal at every seed;
# the worst sums Stokes I 1.262e-8 (thermal_biased, seed 8), a sum of squares
# 1.321e-7, the flow 6e-16. Jump walks (9 configurations, 2^18): every count
# equal; Stokes I 8.348e-9 (grid3d_thermal, seed 7), Stokes V pixel by pixel
# 3.916e-8 on the Mie deck (seed 10). So their counts sit on
# their floors (3 of the 12,056 peels of AGREE's sparsest configuration are
# more than the former 1.2e-4, which stays; 3 of 242,817 for AGREE_3D) and their
# sums on 3 x the worst reading or 1e-9. Marching walks (12 configurations,
# 2^16 or, on grids of at most 4 cells, 2^20): rare photons still part, the
# most on lambert_thick (count 3.859e-4, Stokes I 4.312e-4, seed 9, its 256
# orders) and on the 2 x 3 x 4 grid imaged over a surface with flow
# (count 2.711e-4, flow_global 6.572e-5); there the limits are 3 x those
# readings, about a tenth of the former. Stokes V is zero on every cell but the
# Mie deck, so AGREE and AGREE_MARCH hold it at 0, and "stokes_anomaly" read 0
# on all five --debug-stokes and scattering-off cells, so each of its limits
# is 0.
AGREE = {"count": 0.00012, "count_quv": 0.00012, "pixel_I": 3.785509433481169e-08,
         "pixel_N": 0.00024883875248838755, "pixel_V": 0.0, "capped": 2.86102294921875e-06,
         "n_error": 0.0, "error_codes": 0.0,
         "stokes": (3.785509433481169e-08, 1.351228438584348e-09, 1e-09, 1e-09),
         "squares": (7.574496148885004e-08, 1.321348718203276e-07, 1.0604796661686927e-07,
                     1e-09),
         "flux_emitted": 1e-09, "flux_exit": 1e-09, "flow_global": 1e-09, "flow_theta": 1e-09,
         "stokes_anomaly": 0.0}
AGREE_3D = {"count": 1.235503426462836e-05, "count_quv": 1.235503426462836e-05,
            "pixel_I": 2.5043863590565514e-08, "pixel_N": 1.235503426462836e-05,
            "pixel_V": 1.1748001744010348e-07, "capped": 1.1444091796875e-05,
            "n_error": 1.1444091796875e-05, "error_codes": 1.1444091796875e-05,
            "stokes": (2.5043863590565514e-08, 1.4989177993731333e-09, 1e-09, 1e-09),
            "squares": (6.549480219809434e-08, 1.848117578789449e-08, 2.3659487024632975e-08,
                        1.3429841011361575e-08),
            "flux_emitted": 1e-09, "flux_exit": 1e-09, "flow_global": 0.0, "flow_theta": 0.0,
            "stokes_anomaly": 0.0}
AGREE_MARCH = {"count": 0.0011577584396799104, "count_quv": 0.0011190139362759256,
               "pixel_I": 0.0012935704371267091, "pixel_N": 0.0011577584396799104,
               "pixel_V": 0.0, "capped": 0.000457763671875, "n_error": 0.0003662109375,
               "error_codes": 0.0003662109375,
               "stokes": (0.0012935704371267091, 0.000404356649343037, 0.00020039982441817658,
                          1e-09),
               "squares": (0.0009039246993598995, 0.0010492648187941669, 0.0030338059746613526,
                           1e-09),
               "flux_emitted": 1e-09, "flux_exit": 5.351413100815897e-07,
               "flow_global": 0.00019716019698504312, "flow_theta": 0.00046758728836258603,
               "stokes_anomaly": 0.0}
LIMITS = {"closed": AGREE, "jumps": AGREE_3D, "march": AGREE_MARCH}
# the rule of limits_from: RULE_FACTOR x the worst reading, floored at
# FLOOR_EVENTS events of the gap's denominator (EVENT_KEYS: booked peels or
# photons emitted, event_counts) or at SUM_FLOOR for a sum
RULE_FACTOR = 3.0
FLOOR_EVENTS = 3.0
SUM_FLOOR = 1e-9
EVENT_KEYS = {"count": "peels", "count_quv": "peels_quv", "pixel_N": "peels",
              "capped": "emitted", "n_error": "emitted", "error_codes": "emitted",
              "stokes_anomaly": "emitted"}

_PTR, _INT, _UINT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float


class PoolLaunch(ctypes.Structure):
    """One launch of a pool kernel: ``struct PoolLaunch`` of pool_common.cuh
    field for field (:func:`_library` holds the two sizes alike), device
    pointers as integers (``None`` for null). Every kernel takes it through
    ``artes_<kernel>_launch``, which writes ``blocks``, the grid it launched,
    and ``artes_<kernel>_blocks``, which returns that grid."""

    _fields_ = ([(name, _PTR) for name in (
        "rfront", "opacity", "albedo", "scatter", "prefix", "p_int", "consts", "scal",
        "emis_cum", "cell_weight", "theta_tan", "theta_cos", "theta_flags", "phi_sin",
        "phi_cos", "phifront", "kbar", "dk", "dr", "dtt", "dpp", "rf2")]
        + [(name, _INT) for name in ("nr", "ntheta", "nphi", "cell_depth", "max_crossings")]
        + [(name, _FLOAT) for name in ("same_eps", "sel2", "boundary_tol", "surface_albedo")]
        + [(name, _UINT) for name in ("n_photons", "key_hi", "id_lo")]
        + [(name, _INT) for name in ("max_scatter", "variant", "flags", "nx", "ny")]
        + [(name, _PTR) for name in ("img_sums", "img_counts", "out_d", "out_i", "flow_g",
                                     "flow_t", "flow_buf")]
        + [("flow_buf_blocks", _INT), ("rec", _PTR), ("rec_count", _PTR), ("rec_cap", _INT),
           ("next_id", _PTR), ("counters", _PTR), ("threads", _INT), ("blocks", _INT)])


def _ptr(x: torch.Tensor | None) -> int | None:
    return None if x is None else x.data_ptr()


def supports(tables: TransportTables, static: KernelStatic) -> bool:
    """True when a kernel covers this configuration: every configuration in
    float32 (float64 runs the plain version only)."""
    return tables.opacity.dtype == torch.float32


def flags_of(static: KernelStatic) -> int:
    """The runtime flags of a launch (``F_*`` of pool_common.cuh)."""
    return ((F_CRESCENT if static.crescent else 0)
            | (F_BIASED if static.photon_emission == 2 else 0)
            | (F_DEBUG_STOKES if static.debug_stokes else 0)
            | (0 if static.photon_scattering else F_NO_SCATTER))


def variant_of(static: KernelStatic) -> int:
    """The instantiation a configuration runs: bit 0 thermal, bit 1 image,
    bit 2 flow."""
    return (int(static.photon_source == 2) | (int(static.nx * static.ny > 1) << 1)
            | (int(static.track_flow) << 2))


def kernel_of(tables: TransportTables, static: KernelStatic) -> tuple[str, str]:
    """``(source name, instantiation name)`` of the kernel a configuration
    runs; the instantiation is a key of :data:`LAUNCHES`."""
    mode = walk_mode(tables, static)
    variant = variant_of(static)
    if mode == "closed":
        return "pool_radial", (VARIANTS + VARIANTS_FLOW)[variant]
    if mode == "jumps":
        return "pool_grid3d", VARIANTS_3D[variant]
    return "pool_march", VARIANTS_MARCH[variant]


def flow_buf(ncell: int, blocks: int) -> int:
    """The doubles of the buffer that holds a copy of the flow sums for each
    of a launch's ``blocks`` blocks on a grid of ``ncell`` cells
    (``pool_common.cuh::flow_begin``); 0 where it would pass
    ``FLOW_BUF_MAX`` bytes, and the kernel adds straight into the result
    instead, where the blocks meet on the same addresses."""
    n = blocks * 7 * ncell
    return n if 8 * n <= FLOW_BUF_MAX else 0


def _rel(d, ref) -> float:
    d, ref = float(d), float(ref)
    if d == 0.0:
        return 0.0
    return abs(d) / abs(ref) if ref != 0.0 else math.inf


def gaps(kernel_out: dict, plain_out: dict) -> dict:
    """Gaps between two results of ``run_stream`` (or
    :func:`run_stream_cuda`) on the same configuration, keyed as
    :data:`AGREE`; "stokes" and "squares" hold the four components."""
    k, p = (o["detector"].double().cpu() for o in (kernel_out, plain_out))
    diff = k - p
    tot_k, tot_p = k.sum(0), p.sum(0)
    tot_d = (tot_k - tot_p).abs()
    capped = abs(int(kernel_out["n_alive_at_cap"]) - int(plain_out["n_alive_at_cap"]))
    n = int(plain_out["n_emitted"])
    codes = (kernel_out["error_codes"].cpu() - plain_out["error_codes"].cpu()).abs().max()
    return {"count": _rel(tot_d[0, 2], tot_p[0, 2]),
            "count_quv": max(_rel(tot_d[c, 2], tot_p[c, 2]) for c in (1, 2, 3)),
            "pixel_I": _rel(diff[:, 0, 0].abs().sum(), p[:, 0, 0].abs().sum()),
            "pixel_N": _rel(diff[:, 0, 2].abs().sum(), p[:, 0, 2].sum()),
            "pixel_V": _rel(diff[:, 3, 0].abs().sum(), p[:, 3, 0].abs().sum()),
            "capped": capped / n,
            "n_error": abs(_geometry_errors(kernel_out) - _geometry_errors(plain_out)) / n,
            "error_codes": int(codes) / n,
            "stokes": [_rel(d, tot_p[0, 0]) for d in tot_d[:, 0]],
            "squares": [_rel(d, s) for d, s in zip(tot_d[:, 1], tot_p[:, 1])],
            "flux_emitted": _rel(float(kernel_out["flux_emitted"]) - float(plain_out["flux_emitted"]),
                                 plain_out["flux_emitted"]),
            "flux_exit": _rel(float(kernel_out["flux_exit"]) - float(plain_out["flux_exit"]),
                              plain_out["flux_exit"]),
            "flow_global": _flow_gap(kernel_out, plain_out, "flow_global"),
            "flow_theta": _flow_gap(kernel_out, plain_out, "flow_theta"),
            "stokes_anomaly": abs(int(kernel_out["n_stokes_anomaly"])
                                  - int(plain_out["n_stokes_anomaly"])) / n}


def _geometry_errors(out: dict) -> int:
    """The photons a run abandoned but on a Stokes anomaly."""
    return int(out["n_error"]) - int(out["n_stokes_anomaly"])


def _flow_gap(kernel_out: dict, plain_out: dict, key: str) -> float:
    k, p = kernel_out.get(key), plain_out.get(key)
    if k is None and p is None:
        return 0.0
    if k is None or p is None:
        return math.inf
    k, p = k.double().cpu(), p.double().cpu()
    scale = plain_out["flow_path"].sum().cpu() if key == "flow_global" else p.abs().sum()
    return _rel((k - p).abs().sum(), scale)


def limits_of(tables: TransportTables, static: KernelStatic) -> dict:
    """The limits that hold a configuration, by the walks it takes:
    :data:`AGREE` closed-form, :data:`AGREE_3D` jump walks,
    :data:`AGREE_MARCH` marching walks."""
    return LIMITS[walk_mode(tables, static)]


def agrees(g: dict, limits: dict = AGREE) -> bool:
    """True when every gap of :func:`gaps` is within ``limits`` (a NaN gap
    is not)."""
    return all(all(x <= lim for x, lim in zip(g[key], limits[key]))
               if isinstance(limits[key], tuple) else g[key] <= limits[key]
               for key in limits)


def worst_ratio(g: dict, limits: dict) -> float:
    """The largest gap of :func:`gaps` over its limit (a gap over a limit of
    0 is infinite, none is 0; a NaN gap is infinite)."""
    worst = 0.0
    for key, limit in limits.items():
        pairs = zip(g[key], limit) if isinstance(limit, tuple) else [(g[key], limit)]
        for gap, lim in pairs:
            ratio = gap / lim if lim > 0 else (math.inf if gap != 0 else 0.0)
            worst = max(worst, math.inf if math.isnan(ratio) else ratio)
    return worst


def event_counts(plain_out: dict) -> dict:
    """What the event gaps of :func:`gaps` divide by, of a plain result:
    the Stokes-I row's booked peels ("peels"), the fewest of the Q, U, V
    rows' ("peels_quv") and the photons emitted ("emitted")."""
    tot = plain_out["detector"].double().cpu().sum(0)
    return {"peels": float(tot[0, 2]), "peels_quv": float(tot[1:, 2].min()),
            "emitted": float(plain_out["n_emitted"])}


def floors_of(counts: list[dict]) -> dict:
    """Each key's floor for :func:`limits_from` over configurations whose
    :func:`event_counts` are ``counts``: for an event key, the share that
    :data:`FLOOR_EVENTS` events make of its denominator where that share is
    largest (denominators of 0 left out); for a sum, :data:`SUM_FLOOR`."""
    return {key: max((FLOOR_EVENTS / c[EVENT_KEYS[key]] for c in counts
                      if c[EVENT_KEYS[key]] > 0), default=0.0)
            if key in EVENT_KEYS else SUM_FLOOR for key in AGREE}


def limits_from(readings: list[dict], old: dict, floors: dict) -> dict:
    """The rule that sets a table of limits from ``readings``, gap dicts of
    :func:`gaps` over seeds and configurations: each key (each component of
    "stokes" and "squares") gets ``min(old, max(RULE_FACTOR x the worst
    reading, floor))``. A limit of 0 stays 0 and none rises; a NaN reading
    counts as infinite."""
    def worst(values):
        return max((math.inf if math.isnan(v) else v for v in values), default=0.0)

    new = {}
    for key, lim in old.items():
        if isinstance(lim, tuple):
            new[key] = tuple(min(o, max(RULE_FACTOR * worst(r[key][i] for r in readings),
                                        floors[key]))
                             for i, o in enumerate(lim))
        else:
            new[key] = min(lim, max(RULE_FACTOR * worst(r[key] for r in readings), floors[key]))
    return new


def _library(source: str, lib: str | None = None) -> ctypes.CDLL:
    """Library ``lib`` of kernel ``source`` (``csrc/<source>.cu``, or a
    variant build of it, ``_build.VARIANT_BUILDS``), built at first use, with
    the prototypes of its entry points ``artes_<source>_launch(PoolLaunch*,
    stream)`` and ``artes_<source>_blocks(const PoolLaunch*)``. Its layout
    must be the wrapper's: the table sizes, the kernel's out_i slots
    (:data:`OUT_I_SLOTS`) and counters (:func:`counter_keys`), and
    ``sizeof(PoolLaunch)``; ``pool_grid3d`` adds :data:`PHI_TABLE_MAX`."""
    cdll = _build.load(lib or source)
    launch = getattr(cdll, f"artes_{source}_launch")
    if launch.argtypes is None:
        layout = (N_SCAL, N_OUT_D, len(OUT_I_SLOTS[source]), N_IMG_D, N_IMG_I, ERR_RECORD_W,
                  len(counter_keys(source)), ctypes.sizeof(PoolLaunch))
        if source == "pool_grid3d":
            layout += (PHI_TABLE_MAX,)
        sizes = (ctypes.c_int * 16)()
        get = getattr(cdll, f"artes_{source}_layout")
        get.argtypes = [ctypes.POINTER(ctypes.c_int)]
        get.restype = ctypes.c_int
        got = tuple(sizes[:get(sizes)])
        if got != layout:
            raise RuntimeError(f"{lib or source} layout {got} does not match the wrapper's "
                               f"{layout}")
        blocks = getattr(cdll, f"artes_{source}_blocks")
        blocks.argtypes = [ctypes.POINTER(PoolLaunch)]
        blocks.restype = ctypes.c_int
        launch.restype = ctypes.c_int
        launch.argtypes = [ctypes.POINTER(PoolLaunch), _PTR]
    return cdll


def launch_blocks(tables: TransportTables, static: KernelStatic, n: int,
                  lib: str | None = None) -> int:
    """The blocks of ``THREADS`` that :func:`run_stream_cuda` launches for
    ``n`` photons: the kernel's persistent grid, the blocks the card holds
    at once (fewer for a small launch), as ``artes_<kernel>_blocks`` of
    library ``lib`` (the configuration's kernel, or a variant build of it)
    gives it; the library is built at first use. ``pool_grid3d``'s blocks
    depend on the grid's phi faces too, which size their shared memory."""
    source = kernel_of(tables, static)[0]
    args = PoolLaunch(variant=variant_of(static), n_photons=n, threads=THREADS,
                      nphi=tables.grid.nphi)
    with torch.cuda.device(tables.opacity.device):
        blocks = getattr(_library(source, lib), f"artes_{source}_blocks")(ctypes.byref(args))
    if blocks < 1:
        raise RuntimeError(f"{lib or source}: no resident blocks for variant {args.variant}")
    return blocks


def _scalars(t: TransportTables, static: KernelStatic) -> torch.Tensor:
    """The kernels' scalar table (layout of ``enum S_*`` in pool_common.cuh)."""
    g = t.grid
    dev = t.opacity.device
    host = torch.as_tensor(np.concatenate([
        [g.ob_ax, g.ob_by, g.ob_cz], *emit_basis(t, static), [g.pos_eps, g.sel1]]),
        dtype=torch.float32).to(dev)
    one = [v.reshape(1).to(torch.float32) for v in (t.fstop, t.photon_minimum,
                                                     t.x_max, t.y_max)]
    return torch.cat(one + [t.det_dir.to(torch.float32), t.det_trig.to(torch.float32),
                            g.rfront[t.cell_depth].reshape(1), host,
                            g.theta_cos[:2].to(torch.float32),
                            t.photon_bias.reshape(1).to(torch.float32)])


def _constants(device) -> torch.Tensor:
    return torch.as_tensor(np.concatenate([S.BETA_BASIS.reshape(-1), S.BETA_EDGE_SIN2,
                                           S.BETA_EDGE_COS2]),
                           dtype=torch.float32).to(device)


def _check_inputs(t: TransportTables) -> None:
    dev = t.opacity.device
    if dev.type != "cuda":
        raise ValueError(f"run_stream_cuda needs tables on a CUDA device, got {dev}")
    g = t.grid
    nr, nt, np_ = g.nr, g.ntheta, g.nphi
    nc = nr * nt * np_
    shapes = {"rfront": (g.rfront, (nr + 1,)), "theta_cos": (g.theta_cos, (nt + 1,)),
              "theta_tan": (g.theta_tan, (nt + 1,)), "phi_sin": (g.phi_sin, (np_,)),
              "phi_cos": (g.phi_cos, (np_,)),
              "opacity": (t.opacity, (nc,)), "albedo": (t.albedo, (nc,)),
              "scatter_rows": (t.scatter_rows, (nc * 180, 16)),
              "alpha_prefix": (t.alpha_prefix, (nc, 4, 181)), "p_int": (t.p_int, (nc, 4)),
              "emis_cum": (t.emis_cum, (nc,)), "cell_weight": (t.cell_weight, (nc,))}
    if t.jump is not None:
        j = t.jump
        shapes.update({"kbar": (j.kbar, (nr,)), "dk": (j.dk, (nc,)),
                       "dr": (j.dr, (nr - 1, nt * np_)), "dtt": (j.dtt, (nt - 1, nr * np_)),
                       "dpp": (j.dpp, (np_, nr * nt)), "rf2": (j.rf2, (nr - 1,))})
    for name, (x, shape) in shapes.items():
        if x.dtype != torch.float32:
            raise ValueError(f"run_stream_cuda runs float32 tables; {name} is {x.dtype}")
        if x.device != dev or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous {shape} tensor on {dev}, "
                             f"got {tuple(x.shape)} on {x.device}")
    if nc * 180 * 16 >= 1 << 31:
        raise ValueError(f"{nc} cells overflow the kernel's 32-bit table offsets")


def _decode_records(rec: torch.Tensor) -> torch.Tensor:
    """A kernel's float32 record rows as float64 rows in photon-id order;
    column 1 holds the photon id's bit pattern."""
    out = rec.to(torch.float64)
    out[:, 1] = (rec[:, 1].contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
                 ).to(torch.float64)
    return out[torch.argsort(out[:, 1], stable=True)].cpu()


def _launch_args(t: TransportTables, static: KernelStatic, source: str, n: int, key_hi: int,
                 id_lo: int, v: dict, rec, next_id, buf, counters):
    """The :class:`PoolLaunch` of a launch of kernel ``source`` and the
    tensors made for it, which must outlive the launch: ``(args, keep)``.
    ``v`` holds the launch's tally views (:func:`tally_views`), ``rec`` its
    error-record rows, ``next_id`` its photon counter, ``buf`` its flow
    buffer and ``counters`` its counters' view (each may be None)."""
    g = t.grid
    dev = t.opacity.device
    scal, consts = _scalars(t, static), _constants(dev)
    keep = [scal, consts]
    args = PoolLaunch(
        rfront=g.rfront.data_ptr(), opacity=t.opacity.data_ptr(), albedo=t.albedo.data_ptr(),
        scatter=t.scatter_rows.data_ptr(), prefix=t.alpha_prefix.data_ptr(),
        p_int=t.p_int.data_ptr(), consts=consts.data_ptr(), scal=scal.data_ptr(),
        emis_cum=t.emis_cum.data_ptr(), cell_weight=t.cell_weight.data_ptr(), nr=g.nr,
        n_photons=n, key_hi=key_hi, id_lo=id_lo, max_scatter=int(static.max_scatter),
        variant=variant_of(static), flags=flags_of(static), nx=static.nx, ny=static.ny,
        img_sums=v["img_d"].data_ptr(), img_counts=v["img_i"].data_ptr(),
        out_d=v["out_d"].data_ptr(), out_i=v["out_i"].data_ptr(), flow_g=_ptr(v["flow_g"]),
        flow_t=_ptr(v["flow_t"]), flow_buf=_ptr(buf),
        flow_buf_blocks=0 if buf is None else buf.numel() // (7 * t.opacity.shape[0]),
        rec=rec.data_ptr(), rec_count=v["rec_count"].data_ptr(), rec_cap=REC_CAP,
        next_id=next_id.data_ptr(), counters=_ptr(counters), threads=THREADS)
    if source != "pool_radial":
        # the 3-D grid (pool_geom3d.cuh::Grid3), which the radial kernel does not read
        theta_flags = (g.thetaplane_cone.to(torch.int32) | (g.theta_above.to(torch.int32) << 1)
                       ).contiguous()
        phifront = G.phi_fronts(g).contiguous()
        keep += [theta_flags, phifront]
        for name, x in (("theta_tan", g.theta_tan), ("theta_cos", g.theta_cos),
                        ("theta_flags", theta_flags), ("phi_sin", g.phi_sin),
                        ("phi_cos", g.phi_cos), ("phifront", phifront)):
            setattr(args, name, x.data_ptr())
        args.ntheta, args.nphi = g.ntheta, g.nphi
        args.cell_depth, args.max_crossings = int(t.cell_depth), int(static.max_crossings)
        args.same_eps, args.sel2, args.boundary_tol = g.same_eps, g.sel2, g.boundary_tol
    if source == "pool_grid3d":
        for name in ("kbar", "dk", "dr", "dtt", "dpp", "rf2"):
            setattr(args, name, getattr(t.jump, name).data_ptr())
    if source == "pool_march":
        args.surface_albedo = float(t.surface_albedo)
    return args, keep


def _record_rows(dev):
    """A kernel's error-record buffer: the kernel writes its first rows and
    counts them in the launch's int64 tallies."""
    return torch.empty((REC_CAP, ERR_RECORD_W), dtype=torch.float32, device=dev)


def record_block(rec: torch.Tensor, count: torch.Tensor, k: int = ERR_RECORD_K) -> torch.Tensor:
    """A launch's records as ``select_error_records`` keeps them, on the
    device and without waiting for the kernel: a float64 ``(2k + 1,
    ERR_RECORD_W)`` block whose row 0 holds the number of rows kept and whose
    next rows hold the first ``k`` and the last ``k`` records in photon-id
    order (all of them when at most ``2k``), column 1 the photon id; ``rec``
    is the kernel's buffer and ``count`` its row count, a device scalar."""
    dev = rec.device
    n = torch.clamp(count.reshape(()).to(torch.int64), max=REC_CAP)
    ids = rec[:, 1].contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    slot = torch.arange(REC_CAP, device=dev)
    order = torch.sort(torch.where(slot < n, ids, 1 << 40), stable=True).indices
    j = torch.arange(2 * k, device=dev)
    take = order[torch.where((n > 2 * k) & (j >= k), n - 2 * k + j, j)]
    rows = rec[take].to(torch.float64)
    rows[:, 1] = ids[take].to(torch.float64)
    kept = torch.minimum(n, torch.tensor(2 * k, device=dev))
    rows = torch.where((j < kept)[:, None], rows, 0.0)
    head = torch.zeros((1, ERR_RECORD_W), dtype=torch.float64, device=dev)
    head[0, 0] = kept
    return torch.cat([head, rows])


def _layout(source: str, static: KernelStatic, ncell: int) -> tuple:
    """``(source, track_flow, rows, ncell, slots)``: what the two tally
    allocations hold. float64: the kernel's out_d, img_d (rows x 8), and
    with flow flow_g (ncell x 3) and flow_t (ncell x 4); int64: out_i, whose
    counters are named by ``slots`` (:data:`OUT_I_SLOTS`), img_i (rows x 2),
    the counters of :func:`counter_keys` and the error records' row count (a
    32-bit counter in the low word of the last element)."""
    npix = static.nx * static.ny
    flow = bool(static.track_flow)
    slots = OUT_I_SLOTS["pool_radial_flow" if source == "pool_radial" and flow else source]
    return source, flow, npix if npix > 1 else 1, ncell, slots


def counter_keys(source: str) -> tuple:
    """The names of the counters kernel ``source`` counts while spans record:
    :data:`LANE_KEYS`, and after them :data:`WALK_KEYS` in ``pool_grid3d``,
    :data:`DRAIN_KEYS` in ``pool_radial``; :data:`LANE_KEYS` alone in
    ``pool_march``."""
    return {"pool_grid3d": LANE_KEYS + WALK_KEYS, "pool_radial": LANE_KEYS + DRAIN_KEYS,
            "pool_march": LANE_KEYS}[source]


def _alloc(layout, dev):
    source, flow, rows, ncell, slots = layout
    flat_f = torch.zeros(N_OUT_D + rows * N_IMG_D + (7 * ncell if flow else 0),
                         dtype=torch.float64, device=dev)
    flat_i = torch.zeros(len(slots) + rows * N_IMG_I + len(counter_keys(source)) + 1,
                         dtype=torch.int64, device=dev)
    return flat_f, flat_i, tally_views(layout, flat_f, flat_i)


def tally_views(layout, flat_f: torch.Tensor, flat_i: torch.Tensor) -> dict:
    """The kernel's tally buffers as views into the two allocations:
    ``out_d``, ``img_d``, ``flow_g``, ``flow_t`` (None without flow),
    ``out_i``, ``img_i``, ``lanes`` and ``rec_count``."""
    source, flow, rows, ncell, slots = layout
    n_out_i = len(slots)
    at = N_OUT_D + rows * N_IMG_D
    at_i = n_out_i + rows * N_IMG_I
    return {"out_d": flat_f[:N_OUT_D], "img_d": flat_f[N_OUT_D:at].view(rows, N_IMG_D),
            "flow_g": flat_f[at:at + 3 * ncell].view(ncell, 3) if flow else None,
            "flow_t": flat_f[at + 3 * ncell:at + 7 * ncell].view(ncell, 4) if flow else None,
            "out_i": flat_i[:n_out_i],
            "img_i": flat_i[n_out_i:at_i].view(rows, N_IMG_I),
            "lanes": flat_i[at_i:at_i + len(counter_keys(source))],
            "rec_count": flat_i[-1:].view(torch.int32)[:1]}


def result_of(layout, flat_f: torch.Tensor, flat_i: torch.Tensor, records,
              err_k: int = ERR_RECORD_K) -> dict:
    """The result of :func:`run_stream_cuda` from a launch's two tally
    allocations (one launch's, or their sums over a mesh) and its error
    records (float64 rows in photon-id order, of which the first and last
    ``err_k`` are kept); no value is read on the host. ``packed`` holds the
    layout and the two allocations."""
    source, flow, rows, ncell, slots = layout
    v = tally_views(layout, flat_f, flat_i)
    out_d = v["out_d"]
    out_i = dict(zip(slots, v["out_i"]))
    if rows > 1:
        sums, counts = v["img_d"].reshape(rows, 2, 4).transpose(1, 2), v["img_i"]
    else:
        sums = out_d[:8].reshape(1, 2, 4).transpose(1, 2)
        counts = torch.stack([out_i["scatter_peels"] + out_i["birth_peels"],
                              out_i["scatter_peels"]]).reshape(1, 2)
    anomalies = out_i["anomalies"]
    # the closed form has no failure modes: only Stokes anomalies abandon
    n_error = out_i.get("abandoned", anomalies)
    zero = torch.zeros((), dtype=torch.int64, device=flat_i.device)
    codes = torch.stack([out_i.get(k, zero) for k in ("e031", "e032", "e034",
                                                      "peel_walks_failed")])
    return {
        "detector": detector_from_tallies(sums, counts),
        "flux_emitted": out_d[8],
        "flux_exit": out_d[9],
        "flow_global": v["flow_g"],
        "flow_theta": v["flow_t"],
        "n_error": n_error,
        "error_codes": codes,
        "n_stokes_anomaly": anomalies,
        "n_alive_at_cap": out_i["capped"],
        "n_emitted": out_i["emitted"],
        "error_records": select_error_records([records], err_k),
        "n_error_records": flat_i[-1],
        "n_cell_face": out_i.get("cell_face"),
        "n_flow_booked": out_i.get("flow_booked") if flow else None,
        "packed": (layout, flat_f, flat_i),
    }


def run_stream_cuda(tables: TransportTables, static: KernelStatic, n_photons: int,
                    seed: int, id_hi: int = 0, id_lo: int = 0, err_k: int = ERR_RECORD_K,
                    build: str | None = None, host_records: bool = True):
    """Transport photons ``id_lo .. id_lo + n_photons - 1`` (high id word
    ``id_hi``) through the CUDA kernel of the configuration
    (:func:`kernel_of`); returns the tallies of
    :func:`~artes_tpu_torch.transport.kernel.run_stream` as device tensors
    (the error records on the CPU), views into the launch's two allocations
    (:func:`result_of`), but ``flow_path``, which the gate takes from the
    plain version; and two counts of the work done: ``n_cell_face``, the
    ``cell_face`` passes a marching kernel made, and ``n_flow_booked``, the
    walked segments (closed form) or passes (marching) that booked flow
    (``None`` where a kernel has no such count). The id range must not cross
    a 2^32 boundary. A kernel that can abandon photons (any but the radial
    kernel without ``--debug-stokes``) is waited for, for its error records;
    with ``host_records`` False it is not: ``record_block`` then holds the
    records on the device (:func:`record_block`) and ``error_records`` is
    empty. ``build`` launches a variant build of the radial kernel
    (``_build.VARIANT_BUILDS``: ``pool_radial_clocks``, ``pool_radial_lanes``)
    in its place, which ``LAUNCHES`` does not count.

    The call is the span ``launch`` of ``artes_tpu_torch.spans``, from entry
    to return, with a child ``wait`` where it waits for the kernel's
    records. While it records, the launch is bracketed by two CUDA events on
    its stream and the three kernels count their warps' passes through the
    persistent loop, into the launch's own integer tallies, and
    ``pool_radial`` stamps when its blocks leave the loop; once the spans are
    read the span holds ``kernel`` (the instantiation), ``source``,
    ``blocks``, ``photons_emitted``, ``rounds`` (scattering rounds that
    booked a peel), ``capped``, ``device_ms`` (the events' elapsed time: the
    kernel's, and where the stream idles before it, the host's time to
    launch it), from ``pool_march`` ``cell_face`` (its ``n_cell_face``), and
    from every kernel but ``pool_radial``'s stellar image, which counts none
    (``pool_radial.cu::CountsLanes``), :data:`LANE_KEYS`, and from
    ``pool_grid3d`` :data:`WALK_KEYS`: its jump
    walks, and those that read their phi crossings from the walk's table
    (all of them where the grid has 2 to :data:`PHI_TABLE_MAX` phi faces, none
    elsewhere), and from ``pool_radial``, every instantiation, ``drain_ms``:
    from the first block's exit from the persistent loop to the last's, the
    tail of the launch in which SMs empty (:data:`DRAIN_KEYS`)."""
    with spans.span("launch") as s:
        return _run_stream_cuda(s, tables, static, n_photons, seed, id_hi, id_lo, err_k, build,
                                host_records)


def _run_stream_cuda(s, tables, static, n_photons, seed, id_hi, id_lo, err_k, build,
                     host_records):
    """:func:`run_stream_cuda` inside its ``launch`` span ``s``."""
    source, name = kernel_of(tables, static)
    if build is not None and _build.VARIANT_BUILDS[build][0] != source:
        raise ValueError(f"{build} is a build of {_build.VARIANT_BUILDS[build][0]}, not of "
                         f"{source}")
    _check_inputs(tables)
    if source == "pool_grid3d" and tables.jump is None:
        raise ValueError("jump walks need the jump tables (tables.build_tables makes them)")
    n = int(n_photons)
    if n < 0 or n >= 1 << 32 or int(id_lo) < 0 or int(id_lo) + n > 1 << 32:
        raise ValueError(f"photon ids [{id_lo}, {id_lo} + {n}) leave the 32-bit window")
    npix = static.nx * static.ny
    if npix >= 1 << 31:
        raise ValueError(f"{npix} pixels overflow the kernel's 32-bit pixel index")
    dev = tables.opacity.device
    ncell = tables.opacity.shape[0]
    layout = _layout(source, static, ncell)
    flat_f, flat_i, v = _alloc(layout, dev)
    rec = _record_rows(dev)
    records = torch.zeros((0, ERR_RECORD_W), dtype=torch.float64)
    # only the radial kernel without the anomaly check abandons no photon
    abandons = source != "pool_radial" or static.debug_stokes
    if n > 0:
        lib = build or source
        # the persistent grid's photon counter (pool_common.cuh::next_photon)
        next_id = torch.zeros(1, dtype=torch.int64, device=dev)
        buf = None
        if static.track_flow:
            # the blocks' copies of the flow sums, zeroed, where they fit
            n_buf = flow_buf(ncell, launch_blocks(tables, static, n, lib))
            buf = torch.zeros(n_buf, dtype=torch.float64, device=dev) if n_buf else None
        # the lane, walk and drain counters (counter_keys) and the events, while
        # recording
        counters = v["lanes"] if s else None
        args, keep = _launch_args(tables, static, source, n, R.key_hi(seed, id_hi), int(id_lo),
                                  v, rec, next_id, buf, counters)
        launch = getattr(_library(source, lib), f"artes_{source}_launch")
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            if s:
                events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                events[0].record()
            rc = launch(ctypes.byref(args), stream)
            if s:
                events[1].record()
        if rc != 0:
            raise RuntimeError(f"{name} launch failed: cudaError {rc}")
        if build is None:
            LAUNCHES[name] += 1
        if s:
            s.set(kernel=name, source=source, blocks=args.blocks)
            spans.later(lambda: _read_launch(s, events, layout, v["out_i"], counters))
        if abandons and host_records:
            with spans.span("wait"):
                n_rec = int(v["rec_count"])             # waits for the kernel
            records = _decode_records(rec[:min(n_rec, REC_CAP)])
        del keep, next_id, buf
    out = result_of(layout, flat_f, flat_i, records, err_k)
    if not host_records:
        out["record_block"] = (record_block(rec, v["rec_count"]) if abandons else torch.zeros(
            (2 * ERR_RECORD_K + 1, ERR_RECORD_W), dtype=torch.float64, device=dev))
    return out


def _read_launch(s, events, layout, out_i, counters) -> None:
    """Set a launch span's device values (:func:`run_stream_cuda`) when the
    spans are read: the out_i counters of ``layout``'s slots it reports
    (``cell_face`` where the kernel counts it), the drain stamps as
    ``drain_ms``, and the other counters of
    :func:`counter_keys`, left out where all stayed zero (an instantiation
    that counts none)."""
    events[1].synchronize()
    source, slots = layout[0], layout[-1]
    count = dict(zip(slots, out_i.tolist()))
    s.set(device_ms=events[0].elapsed_time(events[1]), rounds=count["scatter_peels"],
          capped=count["capped"], photons_emitted=count["emitted"])
    if "cell_face" in count:
        s.set(cell_face=count["cell_face"])
    counts = dict(zip(counter_keys(source), [] if counters is None else counters.tolist()))
    first, last = (counts.pop(k, 0) for k in DRAIN_KEYS)
    if last:
        # the earliest stamp is kept as its complement (pool_radial.cu::drain_stamp)
        s.set(drain_ms=(last - ~first) * 1e-6)
    if any(counts.values()):
        s.set(**counts)
