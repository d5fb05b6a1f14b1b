"""The device's side of a traced window, from ``torch.profiler`` (CUPTI).

The window runs under ``torch.profiler.profile`` with CUDA activity only (no
host operator events: the runner makes hundreds of small host operations a
job, and tracing them would cost more than the jobs). What the device did is
read from the profiler's raw events: every kernel, copy and fill with its
start and length.
"""

from __future__ import annotations

import torch


class DeviceTrace:
    """What the card ran between :meth:`__enter__` and :meth:`__exit__`."""

    def __init__(self):
        self.intervals: list[tuple[int, int, str]] = []   # (start ns, end ns, name)
        self._prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        events = self._prof.profiler.kineto_results.events()
        for e in events:
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            start, length = e.start_ns(), e.duration_ns()
            if length > 0:
                self.intervals.append((start, start + length, e.name()))
        self.intervals.sort()
        self._prof = None
        return False

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the card (the union of the
        intervals)."""
        total, end = 0, None
        for s, e, _ in self.intervals:
            if end is None or s >= end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total * 1e-9

    def seconds_by_name(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for s, e, name in self.intervals:
            out[name] = out.get(name, 0.0) + (e - s) * 1e-9
        return out

    def kernel_s(self, kernel: str) -> float:
        """Seconds of every operation whose name holds ``kernel`` (a kernel's
        name in its source, as ``pool_radial_kernel``)."""
        return sum(v for k, v in self.seconds_by_name().items() if kernel in k)

    def idle_gaps(self, k: int = 10) -> list[list]:
        """The ``k`` longest gaps between device operations, each named by the
        operations on its two sides: what the host was preparing between
        them."""
        gaps, end, last = [], None, None
        for s, e, name in self.intervals:
            if end is not None and s > end:
                gaps.append([f"after {_short(last)} before {_short(name)}", (s - end) * 1e-9])
            if end is None or e > end:
                end, last = e, name
        return sorted(gaps, key=lambda g: -g[1])[:k]

    def top_ops(self, k: int = 10) -> list[list]:
        """The ``k`` operations (by name without template arguments) that took
        the most device time."""
        by: dict[str, float] = {}
        for name, v in self.seconds_by_name().items():
            by[_short(name)] = by.get(_short(name), 0.0) + v
        return sorted(([n, v] for n, v in by.items()), key=lambda g: -g[1])[:k]


def _short(name: str) -> str:
    """An operation's name without its template arguments and parameters."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    for sep in ("<", "("):
        name = name.split(sep, 1)[0]
    return name.strip()[:60]
