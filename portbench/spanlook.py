"""Lay the program's spans of one traced run over its device trace.

    python3 -m portbench.spanlook --workload <name> --seed <n> --seconds <s>

from the root of a checkout on a machine with a card. It runs the cell once
with ``--trace 1`` (``run.run_cell``), then prints one JSON line (also written
to the file ``--out`` names, if given) with:

* ``metrics``: the run's per-layer metrics, as the benchmark reports them,
  and ``photons_per_s``, the window's photons over its time, traced;
* ``aligned_pct``: the share of ``launch`` spans whose pool kernel in the
  trace starts after the span's start and ends before the end of its chunk's
  ``wait`` span, each within 20 us (:func:`alignment`), and
  ``device_ms_ratio``, the launches' CUDA-event time over the trace's kernel
  time; ``lost_records``, true where the trace holds fewer pool kernels
  than the window has launches;
* ``self_ms_per_job``: each span name's self time a job;
* ``idle_by_span_ms``: the window's device-idle time by the span that covers
  the host (a leaf's name, ``wait``, ``job`` or ``chunk`` for their own time
  between children, ``none`` outside every job), and ``gaps``: the longest
  idle gaps, each split the same way;
* ``lanes``: each pool kernel's lane use by branch (refill, round, both),
  and ``refill_identity_pct``, the share of launches whose refill lanes equal
  the photons emitted plus the threads launched.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import statistics
import sys

from portbench import program_spans as P
from portbench import run as R

THREADS = 256
GAPS = 10           # the longest idle gaps listed
SLACK_US = 20.0     # how far a kernel may lie outside its launch's window


@contextlib.contextmanager
def kept_trace():
    """Keep the ``DeviceTrace`` that ``run.run_cell`` makes inside the block
    (it returns none, and this module reads ``run.py`` as it is): yields the
    list it lands in."""
    kept, made = [], R.DeviceTrace

    class Kept(made):
        def __init__(self):
            super().__init__()
            kept.append(self)

    R.DeviceTrace = Kept
    try:
        yield kept
    finally:
        R.DeviceTrace = made


def alignment(spans, intervals, slack_ns: int) -> dict:
    """Each ``launch`` span against the pool kernel of the trace that overlaps
    its window (from the launch's start to the end of its chunk's ``wait``)
    the most: the share of launches whose kernel lies in the window within
    ``slack_ns``, the margins (us: the kernel's start after the window's, the
    window's end after the kernel's; least, median, most), the first misses
    as ``[launch, start margin, end margin, seconds since the first launch]``
    (margins None where no kernel overlaps: a record the trace lacks), and
    the launches' CUDA-event time over their kernels'."""
    kernels = sorted((s, e) for s, e, name in intervals if "pool_" in name and "_kernel" in name)
    firsts = [k[0] for k in kernels]
    longest = max((e - s for s, e in kernels), default=0)
    kids = P.children(spans)
    launches = sorted((s for s in spans if s.name == "launch"), key=lambda s: s.start)
    held, ratios, starts, ends, misses = 0, [], [], [], []
    for k, launch in enumerate(launches):
        waits = [c for c in kids.get(launch.parent, ()) if c.name == "wait"]
        lo, hi = launch.start, waits[-1].end if waits else launch.end
        i = bisect.bisect_left(firsts, lo - longest - 10 ** 8)
        best, overlap = None, 0
        while i < len(kernels) and kernels[i][0] < hi + 10 ** 8:
            ks, ke = kernels[i]
            if min(ke, hi) - max(ks, lo) > overlap:
                best, overlap = kernels[i], min(ke, hi) - max(ks, lo)
            i += 1
        ok = best is not None and best[0] >= lo - slack_ns and best[1] <= hi + slack_ns
        held += ok
        if best is not None:
            starts.append((best[0] - lo) * 1e-3)
            ends.append((hi - best[1]) * 1e-3)
            if "device_ms" in launch.attrs:
                ratios.append(launch.attrs["device_ms"] * 1e6 / (best[1] - best[0]))
        if not ok and len(misses) < 10:
            misses.append([k, round(starts[-1], 1) if best else None,
                           round(ends[-1], 1) if best else None,
                           round((launch.start - launches[0].start) * 1e-9, 4)])

    def spread(values):
        return [min(values), statistics.median(values), max(values)] if values else None

    return {"kernels": len(kernels), "launches": len(launches),
            "aligned_pct": 100.0 * held / len(launches) if launches else None,
            "margins_us": {"start": spread(starts), "end": spread(ends)}, "misses": misses,
            "device_ms_ratio": spread(ratios)}


def idle_split(spans, busy: list, lo: int, hi: int) -> tuple[dict, list]:
    """The device's idle time in ``[lo, hi)`` by covering span name, and the
    idle gaps, longest first, each with its own split
    (``program_spans.idle_by_span``), in ms."""
    total: dict = {}
    gaps = []
    for a, b, split in P.idle_by_span(spans, busy, lo, hi):
        for key, v in split.items():
            total[key] = total.get(key, 0) + v
        gaps.append((b - a, {key: round(v * 1e-6, 4) for key, v in split.items() if v}))
    gaps.sort(key=lambda g: -g[0])
    return ({k: v * 1e-6 for k, v in sorted(total.items(), key=lambda kv: -kv[1])},
            [[round(g * 1e-6, 4), split] for g, split in gaps])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--out", help="a file to write the JSON line to as well")
    args = p.parse_args(argv)
    import torch
    from artes_tpu_torch import spans as S

    torch.set_num_threads(1)
    cell = R.Cell.load(args.workload)

    def log(msg):
        print(f"spanlook: {msg}", file=sys.stderr, flush=True)

    with kept_trace() as kept:
        result = R.run_cell(cell, args.seed, args.seconds, True, log=log)
    window_s = result["device"]["window_s"]
    trace = kept[-1]
    spans = [s for s in S.recorded() if s.end is not None]
    jobs = [s for s in spans if s.name == "job"]
    busy = P.merged((s, e) for s, e, _ in trace.intervals)
    lo = min([jobs[0].start] + [b[0] for b in busy[:1]])
    hi = max([jobs[-1].end] + [b[1] for b in busy[-1:]])
    by_span, gaps = idle_split(spans, busy, lo, hi)
    self_ms = {name: secs * 1e3 / len(jobs) for name, (secs, _) in S.self_times(spans).items()}
    launches = [s.attrs for s in spans if s.name == "launch" and "refill_lanes" in s.attrs]
    identity = [a["refill_lanes"] == a["photons_emitted"] + a["blocks"] * THREADS
                for a in launches]
    fake = R.Run(cell=cell, jobs=[], setup_s=0.0, window_s=window_s, trace=trace)
    out = {"workload": args.workload, "seed": args.seed, "correct": result["correct"],
           "jobs": len(jobs), "spans": len(spans), "dropped": S.dropped(),
           "photons_per_s": sum(j.attrs["packages"] for j in jobs) / window_s,
           "metrics": {k: v["value"] for k, v in result["metrics"].items()},
           **alignment(spans, trace.intervals, int(SLACK_US * 1e3)),
           "lost_records": P.lost_records(spans, trace),
           "window_s": window_s, "busy_s": result["device"]["busy_s"],
           "self_ms_per_job": dict(sorted(self_ms.items(), key=lambda kv: -kv[1])),
           "idle_by_span_ms": by_span, "gaps": gaps[:GAPS],
           "lanes": {k: P.lane_parts(fake, k) for k in ("pool_radial", "pool_grid3d")},
           "refill_identity_pct": 100.0 * sum(identity) / len(identity) if identity else None,
           "launches_per_job": statistics.mean(j.attrs.get("launches", 0) for j in jobs),
           "card": R.card_line()}
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
