"""The kernel wrapper's host time a job, from the program's spans: the
``launch`` spans (``pool_cuda.run_stream_cuda``, entry to return) less their
``wait`` for the kernel, summed over a job, mean over the window's jobs, in
ms."""

from portbench.program_spans import per_job_ms


def read(run):
    return per_job_ms(run, ("launch",))
