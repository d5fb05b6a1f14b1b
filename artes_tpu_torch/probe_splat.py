"""Micro-benchmark of the image splat on the card (``csrc/probe_splat.cu``).

The Hopper counterpart of ``tools/probe_splat.py`` (two TPU kernels: the
MXU one-hot splat and its loop-only baseline). 8192 fake lanes run an LCG
for ``n_rounds`` rounds; each round every lane picks a pixel and adds
``ncnt`` count features and ``nvals`` value features into it. :func:`splat`
and :func:`baseline` run on the card by default and take the device of their
output: on a CUDA device they launch the kernels, on the CPU (asked for with
``device="cpu"``) they run the plain PyTorch versions (``index_add_`` per
round). :func:`us_per_round` times the splat net of the loop, the cost model
of ``pool_radial.cu``'s image splat (ten global atomics a peel: 8 values, 2
counts): both kernels run the same grid, and each is timed as a slope over
its rounds with its arrays allocated and zeroed outside the timed window;
:func:`chain_cycles` measures the latency of the loop's step, which bounds
the baseline; :func:`library_yardsticks` times the library's calls for the
same sums. ``LAUNCHES`` counts each kernel's launches where it is launched.

    python -m artes_tpu_torch.probe_splat [npix ...]     # on a card
"""

from __future__ import annotations

import ctypes
import sys

import torch

from artes_tpu_torch import _build

LANES = 8192
N_ROUNDS = 2000
NVALS, NCNT = 8, 2                 # the image detector's features per peel
# the loop alone costs a few ns a round (a dependent multiply-add a lane),
# so its slope is taken over BASE_SPAN times the rounds, where the time
# between the two launches stands well above the events' resolution
BASE_SPAN = 64
LAUNCHES = {"probe_splat": 0, "probe_splat_baseline": 0}
# Atomics add in any order. At the default sizes the double sums are exact
# all the same (every value is a multiple of 2^-26 below 4 and every sum
# stays below 2^17), so kernel and plain version agree bit for bit; the
# limit leaves room for rounding at larger sizes.
VALUE_RTOL = 1e-12

_MASK32 = 0xFFFFFFFF
_vp = ctypes.c_void_p


def _library():
    lib = _build.load("probe_splat")
    if lib.artes_probe_splat_launch.argtypes is None:
        lib.artes_probe_splat_launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_uint,
                                                 ctypes.c_int, ctypes.c_int, _vp, _vp, _vp]
        lib.artes_probe_baseline_launch.argtypes = [ctypes.c_int, ctypes.c_uint, _vp, _vp]
        lib.artes_probe_chain_clock_launch.argtypes = [ctypes.c_int, ctypes.c_uint, _vp, _vp,
                                                       _vp]
        lib.artes_probe_lanes.argtypes = []
        for fn in (lib.artes_probe_splat_launch, lib.artes_probe_baseline_launch,
                   lib.artes_probe_chain_clock_launch, lib.artes_probe_lanes):
            fn.restype = ctypes.c_int
        if lib.artes_probe_lanes() != LANES:
            raise RuntimeError("probe_splat.cu lane count does not match the wrapper")
    return lib


def _lanes(seed, device):
    return (torch.arange(LANES, dtype=torch.int64, device=device) + int(seed)) & _MASK32


def _step(x):
    return (x * 1664525 + 1013904223) & _MASK32


def _features(nvals, ncnt, device):
    thresholds = torch.tensor([0.5 + 0.1 * f for f in range(ncnt)], dtype=torch.float32,
                              device=device)
    scales = torch.tensor([1.0 + 0.25 * f for f in range(nvals)], dtype=torch.float32,
                          device=device)
    return thresholds, scales


def splat_plain(npix, n_rounds=N_ROUNDS, seed=1, nvals=NVALS, ncnt=NCNT, device="cpu"):
    """The plain version: ``(values (npix, nvals) float64, counts (npix,
    ncnt) int64)``."""
    x = _lanes(seed, device)
    vals = torch.zeros((npix, nvals), dtype=torch.float64, device=device)
    counts = torch.zeros((npix, ncnt), dtype=torch.int64, device=device)
    thresholds, scales = _features(nvals, ncnt, device)
    for _ in range(n_rounds):
        x = _step(x)
        pix = (x >> 17) % npix
        v0 = (x >> 8).to(torch.float32) * 2.0 ** -24
        counts.index_add_(0, pix, (v0[:, None] < thresholds).to(torch.int64))
        vals.index_add_(0, pix, (v0[:, None] * scales).to(torch.float64))
    return vals, counts


def baseline_plain(n_rounds=N_ROUNDS, seed=1, device="cpu"):
    """The plain version of the loop alone: each lane's last ``x >> 8``."""
    x = _lanes(seed, device)
    for _ in range(n_rounds):
        x = _step(x)
    return (x >> 8).to(torch.float64)


def splat(npix, n_rounds=N_ROUNDS, seed=1, nvals=NVALS, ncnt=NCNT, device="cuda", out=None):
    """The splat on ``device`` (kernel on a CUDA device, the plain version on
    the CPU). ``out``, a zeroed ``(vals, counts)`` pair on the card, is added
    into instead of a new pair."""
    device = torch.device(device)
    if device.type != "cuda":
        return splat_plain(npix, n_rounds, seed, nvals, ncnt, device)
    if out is None:
        out = (torch.zeros((npix, nvals), dtype=torch.float64, device=device),
               torch.zeros((npix, ncnt), dtype=torch.int64, device=device))
    vals, counts = out
    if vals.shape != (npix, nvals) or counts.shape != (npix, ncnt) or \
            (vals.dtype, counts.dtype) != (torch.float64, torch.int64) or \
            not (vals.is_cuda and counts.device == vals.device):
        raise ValueError("out must be (npix, nvals) float64 and (npix, ncnt) int64 on the card")
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        rc = _library().artes_probe_splat_launch(npix, n_rounds, seed, nvals, ncnt,
                                                 vals.data_ptr(), counts.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"probe_splat launch failed: cudaError {rc}")
    LAUNCHES["probe_splat"] += 1
    return vals, counts


def baseline(n_rounds=N_ROUNDS, seed=1, device="cuda", sink=None):
    """The loop without the splat on ``device`` (kernel on a CUDA device);
    ``sink``, a ``(LANES,)`` float64 tensor on the card, is written instead
    of a new one."""
    device = torch.device(device)
    if device.type != "cuda":
        return baseline_plain(n_rounds, seed, device)
    if sink is None:
        sink = torch.empty(LANES, dtype=torch.float64, device=device)
    if sink.shape != (LANES,) or sink.dtype != torch.float64 or not sink.is_cuda:
        raise ValueError("sink must be (LANES,) float64 on the card")
    with torch.cuda.device(sink.device):
        stream = torch.cuda.current_stream(sink.device).cuda_stream
        rc = _library().artes_probe_baseline_launch(n_rounds, seed, sink.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"probe_splat baseline launch failed: cudaError {rc}")
    LAUNCHES["probe_splat_baseline"] += 1
    return sink


def chain_cycles(steps=1 << 16, device="cuda") -> float:
    """SM cycles of one step of the baseline's dependent LCG chain, read by
    ``clock64`` around ``steps`` steps in one warp (a measurement; on the
    card only)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("chain_cycles reads the card's cycle counter")
    cycles = torch.zeros(1, dtype=torch.int64, device=device)
    last = torch.zeros(1, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for _ in range(2):                                          # warm, then read
            rc = _library().artes_probe_chain_clock_launch(steps, 1, cycles.data_ptr(),
                                                           last.data_ptr(), stream)
            if rc != 0:
                raise RuntimeError(f"probe_chain_clock launch failed: cudaError {rc}")
    return int(cycles.item()) / steps


def _event_ms(fn, reps, setup=None):
    """Median time [ms] of ``fn`` on the card over ``reps`` runs (CUDA
    events); ``setup`` runs before each, outside the events."""
    times = []
    for _ in range(reps):
        if setup is not None:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return sorted(times)[len(times) // 2]


def _slope_us(launch, n_rounds, reps, setup=None):
    """Time a round [us] as the slope between launches of ``n_rounds`` and
    ``2 n_rounds`` rounds: what a launch costs besides its rounds cancels."""
    launch(n_rounds)                                                  # warm-up
    one = _event_ms(lambda: launch(n_rounds), reps, setup)
    two = _event_ms(lambda: launch(2 * n_rounds), reps, setup)
    return (two - one) * 1e3 / n_rounds


def library_yardsticks(npix, reps=5, device="cuda"):
    """The library's calls for the splat's sums at ``npix``, the peels
    materialised first (the kernel never stores them): ``(values_ms,
    values_counts_ms)``, one ``index_add_`` of the peels' value features, and
    that plus a second ``index_add_`` of their count features (int64), the
    same function as the kernel. Both must equal the plain version's sums."""
    device = torch.device(device)
    x, pix, vals, cnts = _lanes(1, device), [], [], []
    thresholds, scales = _features(NVALS, NCNT, device)
    for _ in range(N_ROUNDS):
        x = _step(x)
        pix.append((x >> 17) % npix)
        v0 = (x >> 8).to(torch.float32) * 2.0 ** -24
        vals.append(v0[:, None] * scales)
        cnts.append((v0[:, None] < thresholds).to(torch.int64))
    pix, vals, cnts = torch.cat(pix), torch.cat(vals).to(torch.float64), torch.cat(cnts)
    v_out = torch.zeros((npix, NVALS), dtype=torch.float64, device=device)
    c_out = torch.zeros((npix, NCNT), dtype=torch.int64, device=device)

    def values():
        v_out.zero_().index_add_(0, pix, vals)

    def both():
        values()
        c_out.zero_().index_add_(0, pix, cnts)

    out = []
    for fn in (values, both):
        fn()                                                      # warm-up
        out.append(_event_ms(fn, reps))
    ref_v, ref_c = splat_plain(npix, device=device)
    if not (torch.equal(c_out, ref_c) and torch.allclose(v_out, ref_v, rtol=VALUE_RTOL, atol=0)):
        raise RuntimeError("index_add_ of the materialised peels is not the probe splat's sum")
    return out[0], out[1]


def us_per_round(sizes=(625, 2025, 10201), n_rounds=N_ROUNDS, reps=5, device="cuda"):
    """Kernel time a round [us] of the loop alone and of the splat net of
    the loop, at each pixel count: ``(baseline_us, {npix: net_us})``. Each
    is a slope over rounds (:func:`_slope_us`; the loop's over
    ``BASE_SPAN`` times the rounds), the arrays allocated once and the
    splat's zeroed before each launch, outside the timed window."""
    device = torch.device(device)
    sink = torch.empty(LANES, dtype=torch.float64, device=device)
    base = _slope_us(lambda n: baseline(n, device=device, sink=sink), n_rounds * BASE_SPAN,
                     reps)
    net = {}
    for npix in sizes:
        out = (torch.zeros((npix, NVALS), dtype=torch.float64, device=device),
               torch.zeros((npix, NCNT), dtype=torch.int64, device=device))
        net[npix] = _slope_us(lambda n: splat(npix, n, device=device, out=out), n_rounds, reps,
                              setup=lambda: [t.zero_() for t in out]) - base
    return base, net


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("probe_splat times the kernels on a CUDA device; none found")
    base_us, net_us = us_per_round([int(a) for a in sys.argv[1:]] or (625, 2025, 10201))
    print(f"baseline loop: {base_us:.5f} us/round ({LANES} lanes)")
    for npix, us in net_us.items():
        print(f"npix={npix}: splat {us:.3f} us/round net of the loop")
    print("CUDA kernel launches: " + " ".join(f"{k}={v}" for k, v in LAUNCHES.items()))
