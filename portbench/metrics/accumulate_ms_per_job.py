"""The runner's host work after the kernel, a job, from the program's
spans: the ``accumulate`` spans (a chunk's copies to the host and its sums)
and the ``finish`` span (package energy, scaling, photometry), less any
``wait`` inside them, summed over a job, mean over the window's jobs, in
ms."""

from portbench.program_spans import per_job_ms


def read(run):
    return per_job_ms(run, ("accumulate", "finish"))
