"""Host time a job: the jobs' host-clock spans (each ends synchronised, as
``run_wavelength`` copies its tallies to the host) less the device-busy time
of the traced window, over the jobs. The harness starts no device work
between jobs, so all device time falls inside the spans."""


def read(run):
    if run.trace is None:
        return None
    spans = sum(j["t1"] - j["t0"] for j in run.jobs)
    return (spans - run.trace.busy_s()) / len(run.jobs) * 1e3
