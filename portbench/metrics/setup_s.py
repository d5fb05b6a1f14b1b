"""From the process's start to the first timed job: imports, CUDA context,
the built libraries (built on a checkout's first run), the atmosphere and one
warm job."""


def read(run):
    return run.setup_s
