"""Photon packages of all jobs in the window over the window's wall time."""


def read(run):
    return sum(j["packages"] for j in run.jobs) / run.window_s
