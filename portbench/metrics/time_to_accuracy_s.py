"""Projected wall time for one job to bring the disk's degree of polarization
to the configuration's Monte Carlo standard error ``epsilon_pol``: the
window's time a job times the mean over its jobs of (sigma_pol / epsilon)^2,
sigma_pol from each job's detector moments (ARTES.f90:977-1004)."""


def read(run):
    eps = run.cell.config["epsilon_pol"]
    ratio = sum((j["sigma_pol"] / eps) ** 2 for j in run.jobs) / len(run.jobs)
    return run.window_s / len(run.jobs) * ratio
