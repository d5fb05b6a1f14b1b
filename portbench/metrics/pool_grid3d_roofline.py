"""The 3-D pool kernel's share of its roofline: the least time the H100 could
take for every launch of the window (``costmodel``) over the device time of
every ``pool_grid3d`` kernel in the trace."""

from portbench.costmodel import roofline_pct


def read(run):
    return roofline_pct(run, "pool_grid3d_kernel")
