"""The marching pool kernel's lane use: the lanes active in its warps' passes
through the persistent loop (refill and scattering-round branches together)
over 32 lanes a pass, summed over the window's ``pool_march`` launches, in
%; the kernel counts them while the program records."""

from portbench.program_spans import lane_pct


def read(run):
    return lane_pct(run, "pool_march")
