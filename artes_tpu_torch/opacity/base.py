"""Opacity artifact schema shared by every generator.

An opacity FITS file holds two HDUs (python/opacityRayleigh.py:124-133):

* ``opacity``: shape (4, n_lambda) — rows are wavelength [micron],
  extinction, absorption, scattering [cm2 g-1].
* ``scattermatrix``: shape (180, 16, n_lambda) — 16-element scattering
  matrix averaged over 1-degree bins (bin j spans [j, j+1] degrees; the
  engine treats samples as centred at j+0.5 degrees), normalised so that
  the P11 element integrates to 1 over the sphere.

6-element matrices (F11,F12,F22,F33,F34,F44) expand to 16 elements via
python/atmosphere.py:42-58.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from artes_tpu_torch.constants import PI
from artes_tpu_torch.io.fitsio import read_fits, write_fits

N_ANGLE = 180


@dataclasses.dataclass
class OpacityTable:
    wavelength: np.ndarray    # [micron], (n_lambda,)
    extinction: np.ndarray    # [cm2 g-1]
    absorption: np.ndarray
    scattering: np.ndarray
    scatter: np.ndarray       # (180, 16, n_lambda), normalised

    @property
    def opacity_block(self) -> np.ndarray:
        return np.stack([self.wavelength, self.extinction, self.absorption, self.scattering])


def bin_centers_rad() -> np.ndarray:
    """Angular sample points (j+0.5) degrees in radians (atmosphere.py:25-27)."""
    return (np.arange(N_ANGLE) + 0.5) * PI / 180.0


def expand_6_to_16(scatter6: np.ndarray) -> np.ndarray:
    """(180, 6, n_lambda) -> (180, 16, n_lambda). atmosphere.py:42-58.

    Order of the 6 inputs: F11, F12, F22, F33, F34, F44.
    """
    n = scatter6.shape[2]
    out = np.zeros((N_ANGLE, 16, n), dtype=scatter6.dtype)
    out[:, 0] = scatter6[:, 0]
    out[:, 1] = scatter6[:, 1]
    out[:, 4] = scatter6[:, 1]
    out[:, 5] = scatter6[:, 2]
    out[:, 10] = scatter6[:, 3]
    out[:, 11] = scatter6[:, 4]
    out[:, 14] = -scatter6[:, 4]
    out[:, 15] = scatter6[:, 5]
    return out


def _simpson_even_avg(y: np.ndarray, x: np.ndarray) -> float:
    """Composite Simpson integral matching scipy.integrate.simps(even='avg').

    The reference normalises with scipy's default handling of an even sample
    count (atmosphere.py:60-65), which averages Simpson-on-first/trapezoid-last
    with trapezoid-first/Simpson-on-last.
    """
    n = len(y)
    if n % 2 == 1:
        return _simpson_odd(y, x)
    first = _simpson_odd(y[:-1], x[:-1]) + 0.5 * (y[-1] + y[-2]) * (x[-1] - x[-2])
    last = 0.5 * (y[0] + y[1]) * (x[1] - x[0]) + _simpson_odd(y[1:], x[1:])
    return 0.5 * (first + last)


def _simpson_odd(y: np.ndarray, x: np.ndarray) -> float:
    h = np.diff(x)
    total = 0.0
    for i in range(0, len(y) - 2, 2):
        h0, h1 = h[i], h[i + 1]
        hsum, hprod = h0 + h1, h0 * h1
        h0divh1 = h0 / h1
        total += (hsum / 6.0) * (
            y[i] * (2.0 - 1.0 / h0divh1)
            + y[i + 1] * (hsum * hsum / hprod)
            + y[i + 2] * (2.0 - h0divh1)
        )
    return total


def p11_norm(scatter: np.ndarray) -> np.ndarray:
    """Normalisation constants: 2*pi*Simpson(P11 sin(theta)) per wavelength."""
    angle = bin_centers_rad()
    sin_a = np.sin(angle)
    return np.array(
        [2.0 * PI * _simpson_even_avg(scatter[:, 0, j] * sin_a, angle) for j in range(scatter.shape[2])]
    )


def normalize_scatter(scatter: np.ndarray) -> np.ndarray:
    """Normalise each wavelength's matrix so int P11 dOmega = 1 (atmosphere.py:60-65)."""
    norm = p11_norm(scatter)
    return scatter / norm[None, None, :]


def write_opacity_fits(path, table: OpacityTable) -> None:
    write_fits(path, [("opacity", table.opacity_block), ("scattermatrix", table.scatter)])


def read_opacity_fits(path) -> OpacityTable:
    hdus = read_fits(path)
    opacity = hdus[0][1]
    scatter = hdus[1][1]
    if scatter.shape[1] == 6:
        scatter = expand_6_to_16(scatter)
    return OpacityTable(
        wavelength=opacity[0],
        extinction=opacity[1],
        absorption=opacity[2],
        scattering=opacity[3],
        scatter=scatter,
    )


def make_wavelength_grid(wl_min: float, wl_max: float, step: float) -> np.ndarray:
    """Inclusive wavelength ladder (opacityRayleigh.py:41-43)."""
    n = int((wl_max - wl_min) / step) + 1
    return wl_min + step * np.arange(n)


def bin_average_matrix(matrix_of_cos, wavelengths, norm_per_wl=None) -> np.ndarray:
    """Average an analytic matrix function over 1-degree bins.

    ``matrix_of_cos(cos_alpha) -> (16,)``. The reference averages the two bin
    edges (opacityRayleigh.py:113-122).
    """
    nl = len(wavelengths)
    out = np.zeros((N_ANGLE, 16, nl))
    edges = np.cos(np.arange(N_ANGLE + 1) * PI / 180.0)
    lo = np.stack([matrix_of_cos(c) for c in edges[:-1]])   # (180, 16)
    hi = np.stack([matrix_of_cos(c) for c in edges[1:]])
    avg = 0.5 * (lo + hi)
    for i in range(nl):
        out[:, :, i] = avg
    if norm_per_wl is not None:
        out /= np.asarray(norm_per_wl)[None, None, :]
    return out
