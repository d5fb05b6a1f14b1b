"""The program's own spans of a traced window, for the metric readers that
read them (``artes_tpu_torch.spans``).

A traced window runs under a profiler session, and the program records every
job that starts while one is active: the window's jobs, not the warm job
before it. A reader reads them without taking them. Each span carries
``name``, ``start`` and ``end`` (ns, on the clock of the device trace's
intervals), ``id``, ``parent``, ``job`` and ``attrs`` (its counters). A
checkout whose program has no recorder, or whose recorder dropped spans,
gives no spans, and its readers report nothing. The sums here use the spans'
fields alone, none of the program's helpers, so that no change of the program
moves the yardstick.

The leaf spans are the host's named work, which the device waits for when it
idles: the table build's parts (``tables.*``), the job's set-up of its path
and sums (``prepare``), the kernel wrapper (``launch``) less its ``wait`` for
the kernel, the host sums (``accumulate``) and the job's end (``finish``).
:func:`idle_by_span` puts each piece of the device's idle time under the span
that covers the host then, and ``idle_unexplained_pct`` is the share that no
leaf covers.
"""

from __future__ import annotations

import bisect
import importlib

LEAVES = ("prepare", "launch", "accumulate", "finish")
WARP = 32


def window(run):
    """The closed spans of the traced window, or None (not traced, no
    recorder, spans dropped, or no job recorded)."""
    if run.trace is None:
        return None
    try:
        spans = importlib.import_module("artes_tpu_torch.spans")
    except ImportError:
        return None
    kept = spans.recorded()
    if spans.dropped():
        return None
    closed = [s for s in kept if s.end is not None]
    return closed if any(s.name == "job" for s in closed) else None


def children(spans) -> dict:
    """Each span id's children."""
    out: dict = {}
    for s in spans:
        out.setdefault(s.parent, []).append(s)
    return out


def per_job_ms(run, names, less=("wait",)):
    """The mean over the window's jobs of the time of their spans named in
    ``names``, each less its children named in ``less``, in ms."""
    spans = window(run)
    if spans is None:
        return None
    kids = children(spans)
    jobs = {s.job: 0 for s in spans if s.name == "job"}
    for s in spans:
        if s.name in names and s.job in jobs:
            jobs[s.job] += s.end - s.start - sum(c.end - c.start for c in kids.get(s.id, ())
                                                 if c.name in less)
    return sum(jobs.values()) / len(jobs) * 1e-6


def is_leaf(name: str) -> bool:
    return name.startswith("tables.") or name in LEAVES


def merged(intervals) -> list:
    """The union of ``(start, end)`` intervals as sorted disjoint ``[start,
    end]`` pairs."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return out


def minus(a: list, b: list) -> list:
    """``a`` less ``b``, both sorted and disjoint (:func:`merged`)."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append([s, b[k][0]])
            s = max(s, b[k][1])
            k += 1
        if s < e:
            out.append([s, e])
    return out


def covering(spans) -> list:
    """Sorted disjoint ``(start, end, name)`` pieces of host time, each named
    by the span that covers it: a leaf (``launch`` less its ``wait``, which
    is ``launch.wait``), else ``wait``, ``chunk`` or ``job`` for what is
    left of them."""
    leaf = [s for s in spans if is_leaf(s.name)]
    leaf_ids = {s.id for s in leaf}
    inner = [s for s in spans if s.name == "wait" and s.parent in leaf_ids]
    inner_ids = {s.id for s in inner}
    inner_of: dict = {}
    for w in inner:
        inner_of.setdefault(w.parent, []).append((w.start, w.end))
    pieces: list = []
    for group in (leaf + inner, [s for s in spans if s.name == "wait" and s.id not in inner_ids],
                  [s for s in spans if s.name == "chunk"], [s for s in spans if s.name == "job"]):
        taken = merged((a, b) for a, b, _ in pieces)
        for s in group:
            name = "launch.wait" if s.id in inner_ids else s.name
            own = minus([[s.start, s.end]], merged(inner_of.get(s.id, [])))
            pieces += [(a, b, name) for a, b in minus(own, _within(taken, s.start, s.end))]
    return sorted(pieces)


def _within(intervals: list, lo: int, hi: int) -> list:
    """The sorted disjoint ``intervals`` that meet ``[lo, hi)``."""
    i, out = max(bisect.bisect_left(intervals, [lo, lo]) - 1, 0), []
    while i < len(intervals) and intervals[i][0] < hi:
        if intervals[i][1] > lo:
            out.append(intervals[i])
        i += 1
    return out


def idle_by_span(spans, busy: list, lo: int, hi: int) -> list:
    """The device's idle gaps in ``[lo, hi)`` (``busy``: sorted disjoint
    intervals), each as ``(start, end, {name: ns})``, its time split by the
    span that covers the host (:func:`covering`; ``none`` for no span)."""
    pieces = covering(spans)
    gaps, j = [], 0
    for a, b in minus([[lo, hi]], busy):
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        split: dict = {}
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            s, e, name = pieces[k]
            split[name] = split.get(name, 0) + min(e, b) - max(s, a)
            k += 1
        split["none"] = (b - a) - sum(split.values())
        gaps.append((a, b, split))
    return gaps


def busy(run) -> list:
    """The device's busy time in the trace: sorted disjoint intervals."""
    return merged((s, e) for s, e, _ in run.trace.intervals)


def lost_records(spans, trace) -> bool:
    """True where the window's ``launch`` spans outnumber the trace's pool
    kernels: the profiler lost a kernel's record, and the trace's idle time
    holds that kernel's time."""
    launches = sum(s.name == "launch" for s in spans)
    kernels = sum("pool_" in name and "_kernel" in name for _, _, name in trace.intervals)
    return launches > kernels


def idle_unexplained_pct(run):
    """The share of the window, in %, in which the device idles and no leaf
    span covers the host: the window's idle time (``device_idle_pct``'s)
    less the idle time the leaves cover (:func:`idle_by_span`); None where
    the trace lost a kernel's record (:func:`lost_records`)."""
    spans = window(run)
    if spans is None or lost_records(spans, run.trace):
        return None
    held = busy(run)
    lo = min([s.start for s in spans] + [b[0] for b in held[:1]])
    hi = max([s.end for s in spans] + [b[1] for b in held[-1:]])
    explained = sum(ns for _, _, split in idle_by_span(spans, held, lo, hi)
                    for name, ns in split.items() if is_leaf(name))
    idle_s = run.window_s - run.trace.busy_s()
    return 100.0 * (idle_s - explained * 1e-9) / run.window_s


def lane_parts(run, source: str):
    """``{"refill": %, "round": %, "both": %}``: the lanes active in the
    warps' passes through each branch of the persistent loop, over 32 lanes
    a pass, summed over the window's launches of kernel ``source`` that
    counted them; None where none did."""
    spans = window(run)
    if spans is None:
        return None
    counted = [s.attrs for s in spans
               if s.name == "launch" and s.attrs.get("source") == source
               and "refill_passes" in s.attrs]
    if not counted:
        return None
    sums = {k: sum(a[k] for a in counted)
            for k in ("refill_passes", "refill_lanes", "round_passes", "round_lanes")}

    def pct(lanes, passes):
        return 100.0 * lanes / (WARP * passes) if passes else None

    return {"refill": pct(sums["refill_lanes"], sums["refill_passes"]),
            "round": pct(sums["round_lanes"], sums["round_passes"]),
            "both": pct(sums["refill_lanes"] + sums["round_lanes"],
                        sums["refill_passes"] + sums["round_passes"])}


def lane_pct(run, source: str):
    """Both branches' share of :func:`lane_parts`."""
    parts = lane_parts(run, source)
    return None if parts is None else parts["both"]
