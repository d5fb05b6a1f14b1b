"""The share of the traced window, in %, in which the device idles and no
leaf span of the program covers the host (``tables.*``, ``prepare``,
``launch`` less its ``wait``, ``accumulate``, ``finish``): idle time under a
``wait``, a job's own time between its parts, or between jobs.
``device_idle_pct`` less what the spans explain; nothing where the trace
lost a pool kernel's record (its time would read as idle)."""

from portbench.program_spans import idle_unexplained_pct


def read(run):
    return idle_unexplained_pct(run)
