"""The table build a job, from the program's spans: the mean over the
window's jobs of their ``tables`` span (``build_tables``: grid geometry,
photon floor, cell rows and uploads, jump tables), in ms."""

from portbench.program_spans import per_job_ms


def read(run):
    return per_job_ms(run, ("tables",))
