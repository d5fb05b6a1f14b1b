# Frozen copy of artes_tpu_torch/constants.py at commit bba47c3.
"""Physical constants (SI) used across the engine.

Values match the reference definitions (ARTES.f90:8-16) so that energy
normalisations agree bit-for-bit at float64.
"""

import math

PI = math.pi
K_B = 1.3806488e-23        # Boltzmann constant [m2 kg s-2 K-1]
SIGMA_SB = 5.670373e-8     # Stefan-Boltzmann constant [J s-1 m-2 K-4]
H_PLANCK = 6.62606957e-34  # Planck constant [m2 kg s-1]
C_LIGHT = 2.99792458e8     # Speed of light [m s-1]
R_SUN = 6.95500e8          # Solar radius [m]
PARSEC = 3.08572e16        # Parsec [m]
AU = 1.49598e11            # Astronomical unit [m]
R_JUP = 69911e3            # Jupiter radius [m] (atmosphere.py:117)

AVOGADRO = 6.02214129e23   # [mol-1] (opacityRayleigh.py:45)
LOSCHMIDT = 2.6867805e19   # [cm-3]  (opacityRayleigh.py:46)
GAS_CONSTANT = 8.3144621   # [J K-1 mol-1] (atmosphere.py:113)


def planck_lambda(temperature, wavelength):
    """Planck spectral radiance B_lambda [W m-2 m-1 sr-1].

    Reference: ARTES.f90:1350-1367 (``planck_function``). The stellar branch
    there multiplies by pi to get surface flux; callers do that explicitly
    here.
    """
    import numpy as np

    x = H_PLANCK * C_LIGHT / (wavelength * K_B * temperature)
    return (2.0 * H_PLANCK * C_LIGHT * C_LIGHT / wavelength**5) / (np.exp(x) - 1.0)
