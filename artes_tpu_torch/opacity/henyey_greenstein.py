"""Triple Henyey-Greenstein opacity generator (python/opacityHenyeyGreenstein.py).

P11 is a weighted sum of three HG lobes; polarization is attached through
pLinear/pCircular/skew factors (opacityHenyeyGreenstein.py:75-93).
"""

from __future__ import annotations

import math

import numpy as np

from artes_tpu_torch.constants import PI
from artes_tpu_torch.opacity.base import OpacityTable, bin_average_matrix


def hg_p11(cos_alpha, g1=0.9, w1=1.0, g2=0.0, w2=0.0, g3=0.0, w3=0.0):
    p = w1 * (1.0 - g1 * g1) / (1.0 + g1 * g1 - 2.0 * g1 * cos_alpha) ** 1.5
    p += w2 * (1.0 - g2 * g2) / (1.0 + g2 * g2 - 2.0 * g2 * cos_alpha) ** 1.5
    p += w3 * (1.0 - g3 * g3) / (1.0 + g3 * g3 - 2.0 * g3 * cos_alpha) ** 1.5
    return p


def hg_matrix16(cos_alpha, g1=0.9, w1=1.0, g2=0.0, w2=0.0, g3=0.0, w3=0.0,
                p_linear=0.0, p_circular=0.0, skew=0.0):
    """Unnormalised 16-element triple-HG matrix (opacityHenyeyGreenstein.py:75-93).

    Note the skew term operates on cos_alpha directly, matching the reference's
    use of the sampled cosine as the argument of its ``alphaF`` expression.
    """
    m = np.zeros(16)
    alpha_f = cos_alpha * (1.0 + 3.13 * skew * math.exp(-7.0 * cos_alpha / PI))
    cos_alpha_f = math.cos(alpha_f)
    m[0] = hg_p11(cos_alpha, g1, w1, g2, w2, g3, w3)
    m[1] = -p_linear * m[0] * (1.0 - cos_alpha**2) / (1.0 + cos_alpha**2)
    m[4] = m[1]
    m[5] = m[0]
    m[10] = m[0] * (2.0 * cos_alpha) / (1.0 + cos_alpha**2)
    m[11] = p_circular * m[5] * (1.0 - cos_alpha_f**2) / (1.0 + cos_alpha_f**2)
    m[14] = -m[11]
    m[15] = m[10]
    return m


def hg_norm(g1=0.9, w1=1.0, g2=0.0, w2=0.0, g3=0.0, w3=0.0, n=200001):
    theta = np.linspace(0.0, PI, n)
    y = hg_p11(np.cos(theta), g1, w1, g2, w2, g3, w3) * np.sin(theta)
    h = theta[1] - theta[0]
    integral = h / 3.0 * (y[0] + y[-1] + 4.0 * y[1:-1:2].sum() + 2.0 * y[2:-2:2].sum())
    return 2.0 * PI * integral


def generate(wavelengths_um, absorption=0.0, scattering=1.0,
             g1=0.9, w1=1.0, g2=0.0, w2=0.0, g3=0.0, w3=0.0,
             p_linear=0.0, p_circular=0.0, skew=0.0) -> OpacityTable:
    wl = np.asarray(wavelengths_um, dtype=float)
    n = len(wl)
    norm = hg_norm(g1, w1, g2, w2, g3, w3)
    scatter = bin_average_matrix(
        lambda c: hg_matrix16(c, g1, w1, g2, w2, g3, w3, p_linear, p_circular, skew),
        wl,
        norm_per_wl=np.full(n, norm),
    )
    return OpacityTable(
        wl,
        np.full(n, absorption + scattering),
        np.full(n, absorption),
        np.full(n, scattering),
        scatter,
    )
