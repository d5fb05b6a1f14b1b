"""P-T-dependent molecular gas opacities (python/opacityMolecules.py equivalent).

Interpolates pre-tabulated molecular opacities bilinearly in (log P, log T)
over a PTgrid and emits one ``gas_opacity_NN.fits`` per pressure layer with
H2 Rayleigh scattering matrices attached — the input set the atmosphere
builder consumes for ``gas: on`` runs.

Data-directory contract (the reference ships this under dat/molecules/):
  * ``PTgrid.dat``: header line then rows ``index  pressure[bar]  T[K]``
  * ``opacity_aver_NNNN.dat``: two columns, wavelength [micron] and
    opacity x VMR [cm2/molecule], one file per PT point (1-based NNNN).
"""

from __future__ import annotations

import os

import numpy as np

from artes_tpu_torch.constants import AVOGADRO, LOSCHMIDT, PI
from artes_tpu_torch.opacity.base import OpacityTable, bin_average_matrix, write_opacity_fits
from artes_tpu_torch.opacity.rayleigh import (
    h2_refractive_index,
    rayleigh_matrix16,
    rayleigh_p11_norm,
)


class PTGrid:
    def __init__(self, data_dir):
        self.data_dir = os.fspath(data_dir)
        grid = np.genfromtxt(os.path.join(self.data_dir, "PTgrid.dat"), skip_header=1)
        self.index = grid[:, 0].astype(int)
        self.pressure = grid[:, 1]     # [bar]
        self.temperature = grid[:, 2]  # [K]
        self.t_values = np.unique(self.temperature)

    def load_opacity(self, file_number: int):
        path = os.path.join(self.data_dir, f"opacity_aver_{int(file_number):04d}.dat")
        data = np.loadtxt(path)
        return data[:, 0], data[:, 1]

    def corner_indices(self, pressure_bar: float, temperature: float):
        """The four (P,T) grid corners bracketing the query point
        (opacityMolecules.py:47-118), clamped at the grid edges."""
        t = self.t_values
        iu = int(np.searchsorted(t, temperature, side="left"))
        if iu >= len(t):
            t_hi, t_lo = t[-1], t[-2]
        elif t[iu] == temperature or iu == 0:
            t_hi = t_lo = t[min(iu, len(t) - 1)]
        else:
            t_hi, t_lo = t[iu], t[iu - 1]

        def p_bracket(t_val):
            mask = self.temperature == t_val
            p = self.pressure[mask]
            idx = np.nonzero(mask)[0]
            order = np.argsort(p)
            p, idx = p[order], idx[order]
            j = int(np.searchsorted(p, pressure_bar, side="left"))
            if j >= len(p):
                return idx[-1], idx[-1] if len(p) == 1 else idx[-2]
            if p[j] == pressure_bar or j == 0:
                return idx[j], idx[j]
            return idx[j], idx[j - 1]

        up_hi, lo_hi = p_bracket(t_hi)
        up_lo, lo_lo = p_bracket(t_lo)
        # order: [upperP upperT, lowerP upperT, upperP lowerT, lowerP lowerT]
        return [up_hi, lo_hi, up_lo, lo_lo]

    def interpolate(self, pressure_bar: float, temperature: float):
        """Bilinear interpolation in (log P, log T) of log opacity
        (opacityMolecules.py:120-166). Returns (wavelength, opacity)."""
        idx = self.corner_indices(pressure_bar, temperature)
        wl, op0 = self.load_opacity(self.index[idx[0]])
        ops = [op0] + [self.load_opacity(self.index[i])[1] for i in idx[1:]]
        logs = [np.log10(np.maximum(o, 1e-500)) for o in ops]
        logs = [np.maximum(l, -500.0) for l in logs]

        p2, p1 = self.pressure[idx[0]], self.pressure[idx[1]]
        t2, t1 = self.temperature[idx[0]], self.temperature[idx[2]]
        lp, lt = np.log10(pressure_bar), np.log10(temperature)
        lp1, lp2 = np.log10(p1), np.log10(p2)
        lt1, lt2 = np.log10(t1), np.log10(t2)

        if lp1 == lp2 and lt1 == lt2:
            out = logs[0]
        elif lp1 == lp2:
            out = logs[2] + (logs[0] - logs[2]) * (lt - lt1) / (lt2 - lt1)
        elif lt1 == lt2:
            out = logs[1] + (logs[0] - logs[1]) * (lp - lp1) / (lp2 - lp1)
        else:
            r1 = (lp2 - lp) / (lp2 - lp1) * logs[3] + (lp - lp1) / (lp2 - lp1) * logs[2]
            r2 = (lp2 - lp) / (lp2 - lp1) * logs[1] + (lp - lp1) / (lp2 - lp1) * logs[0]
            out = (lt2 - lt) / (lt2 - lt1) * r1 + (lt - lt1) / (lt2 - lt1) * r2
        return wl, 10.0 ** out


def layer_table(grid: PTGrid, pressure_bar, temperature, wl_min, wl_max,
                mmw=2.02, depolarization=0.0) -> OpacityTable:
    """One pressure layer: molecular absorption + H2 Rayleigh scattering
    (opacityMolecules.py:246-322)."""
    wl_all, absorption_mol = grid.interpolate(pressure_bar, temperature)
    mass = mmw / AVOGADRO  # [g]
    absorption_mol = absorption_mol / mass  # [cm2/molecule] -> [cm2 g-1]

    sel = (wl_all >= wl_min)
    keep = sel & (wl_all <= wl_max)
    # include one sample beyond wl_max like the reference's break-after-append
    over = np.nonzero(wl_all > wl_max)[0]
    if len(over) and sel[over[0]]:
        keep[over[0]] = True
    wl = wl_all[keep]
    absorption = absorption_mol[keep]

    ri = h2_refractive_index(wl)
    rindex = (ri * ri - 1.0) ** 2 / (ri * ri + 2.0) ** 2
    dep = (6.0 + 3.0 * depolarization) / (6.0 - 7.0 * depolarization)
    cross = 24.0 * PI**3 * rindex * dep / ((wl * 1e-4) ** 4 * LOSCHMIDT**2)
    kappa_sca = cross / mass

    norm = rayleigh_p11_norm(depolarization)
    scatter = bin_average_matrix(lambda c: rayleigh_matrix16(c, depolarization),
                                 wl, norm_per_wl=np.full(len(wl), norm))
    return OpacityTable(wl, kappa_sca + absorption, absorption, kappa_sca, scatter)


def generate_layers(data_dir, pressure_bar, temperature, wl_min, wl_max,
                    out_dir, mmw=2.02, depolarization=0.0):
    """Write gas_opacity_NN.fits for every layer of a P-T profile.

    Layer numbering follows the reference: NN = n_layers - i for profile row i
    (deepest pressure gets the highest NN; opacityMolecules.py:194), so
    gas_opacity_01.fits is the deepest layer, matching the builder's
    radial ordering (atmosphere.py:227-236).
    """
    grid = PTGrid(data_dir)
    os.makedirs(out_dir, exist_ok=True)
    n = len(pressure_bar)
    paths = []
    for i in range(n):
        tab = layer_table(grid, pressure_bar[i], temperature[i], wl_min, wl_max,
                          mmw, depolarization)
        nn = n - i
        path = os.path.join(out_dir, f"gas_opacity_{nn:02d}.fits")
        write_opacity_fits(path, tab)
        paths.append(path)
    return paths
