"""The radial pool kernel's drain: over the window's ``pool_radial``
launches, 100 x the sum of their ``drain_ms`` (from the first block's exit
from the persistent loop to the last block's, while SMs empty; stamped by the
kernel while the program records) over the sum of their ``device_ms``, in %.
Nothing where a launch lacks either value or the spans were dropped."""

from portbench.program_spans import window


def read(run):
    spans = window(run)
    if spans is None:
        return None
    launches = [s.attrs for s in spans
                if s.name == "launch" and s.attrs.get("source") == "pool_radial"]
    if not launches or any("drain_ms" not in a or "device_ms" not in a for a in launches):
        return None
    device_ms = sum(a["device_ms"] for a in launches)
    return 100.0 * sum(a["drain_ms"] for a in launches) / device_ms if device_ms > 0 else None
