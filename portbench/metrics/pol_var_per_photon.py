"""The estimator's variance a photon: the mean over the window's jobs of
photons x sigma_pol^2, sigma_pol the Monte Carlo error of the disk's degree of
polarization from the job's detector moments. A change that transports
faster by spending more variance a photon shows here."""


def read(run):
    values = [j["packages"] * j["sigma_pol"] ** 2 for j in run.jobs if j["sigma_pol"] > 0]
    return sum(values) / len(values) if values else None
