# Frozen copy of the engine-side model of artes_tpu_torch/atmosphere.py (lines 1-123)
# at commit bba47c3, without the file I/O; only its imports are changed.
"""Atmosphere artifact: offline construction and engine-side model.

The construction mirrors python/atmosphere.py: it composes per-cell scattering and
absorption opacities [m-1] and opacity-weighted blended 16-element scattering
matrices over zone specs, builds the radial grid either hydrostatically from a
P-T profile (atmosphere.py:127-167) or from explicit faces in km
(atmosphere.py:169-183), and writes the 9-HDU ``atmosphere.fits``
(atmosphere.py:449-460) with the exact reference HDU order and array layouts:

  radial [m] (nr,), polar [deg] (ntheta,), azimuthal [deg] (nphi,),
  wavelength [micron] (nl,), density (nphi, ntheta-1, nr-1),
  temperature (nphi, ntheta-1, nr-1),
  scattering/absorption [m-1] (nl, nphi, ntheta-1, nr-1),
  scattermatrix (180, 16, nl, nphi, ntheta-1, nr-1).

The engine-side :class:`Atmosphere` transposes to (nr, ntheta, nphi, ...) and
precomputes everything ``get_atmosphere`` (ARTES.f90:2054-2235) and
``grid_initialize`` mode 1 (ARTES.f90:2247-2323) derive: total opacity,
albedo, P11..P14 angular integrals, theta/phi trig tables and cell volumes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from portbench.reference.constants import PI

N_ANGLE = 180

# Bin-averaged trig tables over half-degree-offset bins (ARTES.f90:404-420):
# entry i (0-based) covers [i, i+1] degrees, value = average of the edges.
_I = np.arange(1, N_ANGLE + 1, dtype=float)
SINBETA = 0.5 * (np.sin(_I * PI / 180.0) + np.sin((_I - 1.0) * PI / 180.0))
COSBETA = 0.5 * (np.cos(_I * PI / 180.0) + np.cos((_I - 1.0) * PI / 180.0))
SIN2BETA = 0.5 * (np.sin(2 * _I * PI / 180.0) + np.sin(2 * (_I - 1.0) * PI / 180.0))
COS2BETA = 0.5 * (np.cos(2 * _I * PI / 180.0) + np.cos(2 * (_I - 1.0) * PI / 180.0))


@dataclasses.dataclass
class Atmosphere:
    """Engine-side atmosphere (host numpy, float64)."""

    rfront: np.ndarray        # (nr+1,) [m]
    thetafront: np.ndarray    # (ntheta+1,) [rad]
    phifront: np.ndarray      # (nphi,) [rad]
    wavelengths: np.ndarray   # (nl,) [m]
    density: np.ndarray       # (nr, ntheta, nphi) [kg m-3]
    temperature: np.ndarray   # (nr, ntheta, nphi) [K]
    k_sca: np.ndarray         # (nr, ntheta, nphi, nl) [m-1]
    k_abs: np.ndarray         # (nr, ntheta, nphi, nl) [m-1]
    scatter: np.ndarray       # (nr, ntheta, nphi, nl, 180, 16)

    # ---- sizes ----
    @property
    def nr(self) -> int:
        return len(self.rfront) - 1

    @property
    def ntheta(self) -> int:
        return len(self.thetafront) - 1

    @property
    def nphi(self) -> int:
        return len(self.phifront)

    @property
    def n_wavelength(self) -> int:
        return len(self.wavelengths)

    # ---- derived tables (get_atmosphere, ARTES.f90:2174-2230) ----
    def refresh_derived(self):
        """Recompute k_ext/albedo/p_int after in-place edits to
        k_sca/k_abs/scatter (the derived tables are built once at
        construction; callers mutating the primaries must refresh)."""
        self.__post_init__()

    def __post_init__(self):
        self.k_ext = self.k_sca + self.k_abs
        with np.errstate(invalid="ignore", divide="ignore"):
            albedo = np.where(self.k_ext > 0.0, self.k_sca / np.maximum(self.k_ext, 1e-300), 0.0)
        self.albedo = np.maximum(albedo, 1.0e-20)
        # P11..P14 angular integrals with the bin-averaged sin table
        w = SINBETA * PI / 180.0  # (180,)
        self.p_int = np.einsum("...ae,a->...e", self.scatter[..., :4], w)  # (nr,nt,np,nl,4)
        # thetaplane: 1 = cone, 2 = z=0 plane (ARTES.f90:2097-2104)
        tf_deg = self.thetafront * 180.0 / PI
        self.thetaplane = np.where(np.abs(tf_deg - 90.0) < 1.0e-6, 2, 1).astype(np.int32)
        self.theta_cos = np.cos(self.thetafront)
        self.theta_tan = np.tan(self.thetafront)
        self.phi_sin = np.sin(self.phifront)
        self.phi_cos = np.cos(self.phifront)

    def cell_volume(self, oblate_x=1.0, oblate_y=1.0, oblate_z=1.0) -> np.ndarray:
        """Cell volumes [m3] incl. oblateness factor (ARTES.f90:2277-2307)."""
        r3 = self.rfront**3
        dr3 = r3[1:] - r3[:-1]                       # (nr,)
        dcos = self.theta_cos[:-1] - self.theta_cos[1:]  # (ntheta,)
        if self.nphi == 1:
            dphi = np.array([2.0 * PI])
        else:
            edges = np.append(self.phifront, 2.0 * PI)
            dphi = edges[1:] - edges[:-1]
        vol = (
            oblate_x * oblate_y * oblate_z / 3.0
            * dr3[:, None, None] * dcos[None, :, None] * dphi[None, None, :]
        )
        return vol

    def column_optical_depth(self, wl_index: int, kind: str = "ext",
                             cell_from: int = 0) -> np.ndarray:
        """Radial optical depth per (theta,phi) column (ARTES.f90:3934-3971)."""
        k = {"ext": self.k_ext, "sca": self.k_sca, "abs": self.k_abs}[kind]
        dr = np.diff(self.rfront)
        return np.einsum("r,rtp->tp", dr[cell_from:], k[cell_from:, :, :, wl_index])
