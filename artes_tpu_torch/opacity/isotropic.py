"""Isotropic scattering opacity generator (python/opacityIsotropic.py).

Constant opacities and P11 = 1/(4*pi) in every bin (opacityIsotropic.py:51-56).
"""

from __future__ import annotations

import numpy as np

from artes_tpu_torch.constants import PI
from artes_tpu_torch.opacity.base import N_ANGLE, OpacityTable


def generate(wavelengths_um, absorption=0.0, scattering=1.0) -> OpacityTable:
    wl = np.asarray(wavelengths_um, dtype=float)
    n = len(wl)
    scatter = np.zeros((N_ANGLE, 16, n))
    scatter[:, 0, :] = 1.0 / (4.0 * PI)
    return OpacityTable(
        wl,
        np.full(n, absorption + scattering),
        np.full(n, absorption),
        np.full(n, scattering),
        scatter,
    )
