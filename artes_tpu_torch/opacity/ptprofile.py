"""Pressure-temperature profile generators
(python/pressureTemperature{Isothermal,SelfLuminous}.py).

Both write the two-column ``pressureTemperature.dat`` (pressure [bar],
temperature [K]) consumed by the atmosphere builder's hydrostatic grid.
"""

from __future__ import annotations

import numpy as np


def isothermal(t_iso=800.0, p_min=1e-3, p_max=1e2, levels=40):
    """Isothermal log-spaced profile (pressureTemperatureIsothermal.py:16-23)."""
    pressure = np.logspace(np.log10(p_min), np.log10(p_max), levels)  # [bar]
    temperature = np.full(levels, float(t_iso))
    return pressure, temperature


def self_luminous(t_eff=800.0, kappa=1e-2, log_g=3.4, p_min=1e-3, p_max=1e2, levels=20):
    """Eddington-approximation T(tau) profile (pressureTemperatureSelfLuminous.py:18-31).

    tau = kappa * P / g with P in [Ba] and g = 10**log_g in cgs;
    T^4 = (3/4) T_eff^4 (2/3 + tau).
    """
    g = 10.0 ** log_g
    pressure = np.logspace(np.log10(p_min), np.log10(p_max), levels)  # [bar]
    p_ba = pressure * 1e6
    tau = kappa * p_ba / g
    temperature = (0.75 * t_eff**4 * (2.0 / 3.0 + tau)) ** 0.25
    return pressure, temperature


def write_profile(path, pressure, temperature):
    with open(path, "w") as fh:
        fh.write("# Pressure [bar] - Temperature [K]\n\n")
        for p, t in zip(pressure, temperature):
            fh.write(f"{p:.18e} {t:.18e}\n")


def read_profile(path):
    data = np.loadtxt(path)
    return data[:, 0], data[:, 1]
