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

import configparser
import dataclasses
import os

import numpy as np

from artes_tpu_torch.constants import GAS_CONSTANT, PI, R_JUP
from artes_tpu_torch.io.fitsio import read_fits, write_fits
from artes_tpu_torch.opacity.base import N_ANGLE, normalize_scatter, read_opacity_fits

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


# ----------------------------------------------------------------------------
# Artifact I/O (atmosphere.fits, reference layout)
# ----------------------------------------------------------------------------

def write_artifact(path, atm: Atmosphere) -> None:
    """Write atmosphere.fits in the reference HDU order/layout (atmosphere.py:449-460)."""
    nl = atm.n_wavelength
    # engine (nr,nt,np,...) -> artifact layouts
    density = atm.density.transpose(2, 1, 0)
    temperature = atm.temperature.transpose(2, 1, 0)
    k_sca = atm.k_sca.transpose(3, 2, 1, 0)
    k_abs = atm.k_abs.transpose(3, 2, 1, 0)
    scatter = atm.scatter.transpose(4, 5, 3, 2, 1, 0)
    write_fits(path, [
        ("radial", atm.rfront.astype(np.float64)),
        ("polar", (atm.thetafront * 180.0 / PI).astype(np.float64)),
        ("azimuthal", (atm.phifront * 180.0 / PI).astype(np.float64)),
        ("wavelength", (atm.wavelengths * 1.0e6).astype(np.float64)),
        ("density", density.astype(np.float64)),
        ("temperature", temperature.astype(np.float64)),
        ("scattering", k_sca.astype(np.float64)),
        ("absorption", k_abs.astype(np.float64)),
        ("scattermatrix", scatter.astype(np.float64)),
    ])


def load_artifact(path) -> Atmosphere:
    """Read atmosphere.fits (HDUs in fixed order, ARTES.f90:2071-2198).

    Always through the pure-Python reader, which read the 119.6 MB artifact
    of ``cells.blended_5184`` in 0.152 s against the native
    ``read_fits_native``'s 0.234 s (medians of five, the host of an NVIDIA
    H100 80GB HBM3; PERF.md section 3)."""
    hdus = read_fits(path)
    data = [h[1] for h in hdus]
    radial, polar, azimuthal, wavelength = data[0], data[1], data[2], data[3]
    density, temperature, k_sca, k_abs, scatter = data[4], data[5], data[6], data[7], data[8]
    return Atmosphere(
        rfront=np.asarray(radial, dtype=np.float64),
        thetafront=np.asarray(polar, dtype=np.float64) * PI / 180.0,
        phifront=np.asarray(azimuthal, dtype=np.float64) * PI / 180.0,
        wavelengths=np.asarray(wavelength, dtype=np.float64) * 1.0e-6,
        density=np.asarray(density, dtype=np.float64).transpose(2, 1, 0),
        temperature=np.asarray(temperature, dtype=np.float64).transpose(2, 1, 0),
        k_sca=np.asarray(k_sca, dtype=np.float64).transpose(3, 2, 1, 0),
        k_abs=np.asarray(k_abs, dtype=np.float64).transpose(3, 2, 1, 0),
        scatter=np.asarray(scatter, dtype=np.float64).transpose(5, 4, 3, 2, 0, 1),
    )


# ----------------------------------------------------------------------------
# Construction (python/atmosphere.py equivalent)
# ----------------------------------------------------------------------------

@dataclasses.dataclass
class ZoneSpec:
    """One opacityNN zone line: fits#, density [g cm-3], index ranges."""
    fits_index: int
    density: float          # [g cm-3]; stored in [kg m-3] after parse
    r_in: int
    r_out: int
    theta_in: int
    theta_out: int
    phi_in: int
    phi_out: int


def _parse_list(value: str):
    return [c.strip() for c in value.split(",") if c.strip()]


def build_atmosphere(directory, normalize_opacities: bool = True) -> Atmosphere:
    """Build the atmosphere from ``<directory>/atmosphere.in`` + opacity FITS files.

    Follows python/atmosphere.py end to end: normalisation of opacity FITS
    phase matrices, radial grid (hydrostatic or explicit), theta/phi faces,
    zone painting with opacity-weighted matrix blending, temperature from the
    P-T profile and the optional 2-cell ring layer.
    """
    directory = os.fspath(directory)
    parser = configparser.ConfigParser(inline_comment_prefixes=(";", "#"))
    with open(os.path.join(directory, "atmosphere.in")) as fh:
        parser.read_file(fh)

    r_planet = float(parser.get("grid", "radius")) * R_JUP  # [Rjup] -> [m]
    use_gas = parser.getboolean("composition", "gas", fallback=False)
    ring_opt = parser.get("composition", "ring", fallback="").strip()

    pt_path = os.path.join(directory, "pressureTemperature.dat")
    has_pt = os.path.isfile(pt_path)

    density_gas = None
    temperature_prof = None
    if has_pt:
        mmw = float(parser.get("composition", "molweight")) * 1.0e-3  # [g/mol]->[kg/mol]
        log_g = float(parser.get("composition", "log_g"))
        gravity = 1.0e-2 * 10.0**log_g  # [cm s-2] -> [m s-2] (atmosphere.py:133)
        pt = np.loadtxt(pt_path)
        pressure = pt[:, 0][::-1] * 1.0e5   # [bar]->[Pa], deepest first
        temperature_prof = pt[:, 1][::-1]
        n_lev = len(pressure)
        scale_height = GAS_CONSTANT * temperature_prof / (mmw * gravity)  # [m]
        density_gas = pressure / (gravity * scale_height)                 # [kg m-3]
        radial = np.zeros(n_lev)
        for i in range(1, n_lev):
            radial[i] = radial[i - 1] - scale_height[i] * np.log(pressure[i] / pressure[i - 1])
        # faces count nr = n_lev; cells use the lower n_lev-1 values
        pressure = pressure[:-1]
        temperature_prof = temperature_prof[:-1]
        scale_height_cells = scale_height[:-1]
        density_gas = density_gas[:-1]
        radial_cells = radial[:-1]
    else:
        rr = _parse_list(parser.get("grid", "radial", fallback=""))
        radial = np.array([0.0] + [float(v) * 1.0e3 for v in rr])  # [km]->[m]
    radial = radial + r_planet
    if np.any(np.diff(radial) <= 0.0):
        # a zero-thickness cell makes adjacent radial faces coincide, which
        # degenerates the traversal geometry (the reference would silently
        # build it and error photon-by-photon at run time)
        raise ValueError(
            "grid:radial faces must be strictly increasing; got "
            + ", ".join(f"{v:.6g}" for v in (radial - r_planet) / 1.0e3)
            + " km")
    nr = len(radial) - 1  # number of cells

    tt = _parse_list(parser.get("grid", "theta", fallback=""))
    theta = np.array([0.0] + [float(v) for v in tt] + [180.0])
    ntheta = len(theta) - 1

    pp = _parse_list(parser.get("grid", "phi", fallback=""))
    phi = np.array([0.0] + [float(v) for v in pp])
    nphi = len(phi)

    # ---- species opacities ----
    gas_tables = []
    if use_gas:
        i = 1
        while os.path.isfile(os.path.join(directory, "opacity", f"gas_opacity_{i:02d}.fits")):
            tab = read_opacity_fits(os.path.join(directory, "opacity", f"gas_opacity_{i:02d}.fits"))
            if normalize_opacities:
                tab.scatter = normalize_scatter(tab.scatter)
            gas_tables.append(tab)
            i += 1
        if density_gas is not None and len(gas_tables) != len(density_gas):
            raise ValueError(
                f"expected {len(density_gas)} gas_opacity_NN.fits files, found {len(gas_tables)}")

    other_tables = []
    i = 1
    while parser.has_option("composition", f"fits{i:02d}"):
        name = parser.get("composition", f"fits{i:02d}").strip()
        tab = read_opacity_fits(os.path.join(directory, "opacity", name))
        if normalize_opacities:
            tab.scatter = normalize_scatter(tab.scatter)
        other_tables.append(tab)
        i += 1

    if gas_tables:
        wavelengths_um = gas_tables[0].wavelength
    elif other_tables:
        wavelengths_um = other_tables[0].wavelength
    else:
        raise ValueError("no opacity sources configured")
    nl = len(wavelengths_um)

    # ---- zone specs ----
    zones = []
    i = 1
    while parser.has_option("composition", f"opacity{i:02d}"):
        aa = _parse_list(parser.get("composition", f"opacity{i:02d}"))
        r_out = nr if "nr" in aa[3] else int(aa[3])
        t_out = ntheta if "ntheta" in aa[5] else int(aa[5])
        p_out = nphi if "nphi" in aa[7] else int(aa[7])
        zones.append(ZoneSpec(
            fits_index=int(aa[0]),
            density=float(aa[1]) * 1.0e3,   # [g cm-3] -> [kg m-3]
            r_in=int(aa[2]), r_out=r_out,
            theta_in=int(aa[4]), theta_out=t_out,
            phi_in=int(aa[6]), phi_out=p_out,
        ))
        i += 1

    # ---- paint cells (engine layout nr, ntheta, nphi) ----
    k_sca = np.zeros((nr, ntheta, nphi, nl))
    k_abs = np.zeros((nr, ntheta, nphi, nl))
    scatter = np.zeros((nr, ntheta, nphi, nl, N_ANGLE, 16))
    density = np.zeros((nr, ntheta, nphi))

    if use_gas:
        for ir in range(nr):
            tab = gas_tables[ir]
            # [cm2 g-1]/10 = [m2 kg-1] (atmosphere.py:235)
            k_abs[ir] += density_gas[ir] * tab.absorption / 10.0
            k_sca[ir] += density_gas[ir] * tab.scattering / 10.0
            scatter[ir, :, :, :, :, :] = tab.scatter.transpose(2, 0, 1)[None, None, :, :, :]
            density[ir] += density_gas[ir]

    for z in zones:
        tab = other_tables[z.fits_index - 1]
        o_sca = z.density * tab.scattering / 10.0  # (nl,) [m-1]
        o_abs = z.density * tab.absorption / 10.0
        sl = np.s_[z.r_in:z.r_out, z.theta_in:z.theta_out, z.phi_in:z.phi_out]
        zone_mat = tab.scatter.transpose(2, 0, 1)  # (nl, 180, 16)
        existing = k_sca[sl] + k_abs[sl]           # (..., nl)
        total = o_sca + o_abs + existing
        with np.errstate(invalid="ignore", divide="ignore"):
            weight = np.where(total > 0, (o_sca + o_abs) / np.maximum(total, 1e-300), 1.0)
        empty = density[sl] == 0.0
        w = np.where(empty[..., None], 1.0, weight)
        scatter[sl] = (
            scatter[sl] * (1.0 - w)[..., None, None]
            + w[..., None, None] * zone_mat[None, None, None]
        )
        k_sca[sl] += o_sca
        k_abs[sl] += o_abs
    # density painting uses densityOther[composition-1] (atmosphere.py:374-379)
    zone_densities = [z.density for z in zones]
    for z in zones:
        sl = np.s_[z.r_in:z.r_out, z.theta_in:z.theta_out, z.phi_in:z.phi_out]
        density[sl] += zone_densities[z.fits_index - 1]

    temperature = np.zeros((nr, ntheta, nphi))
    if has_pt:
        temperature[:, :, :] = temperature_prof[:nr, None, None]

    # ---- optional ring: 2 extra radial cells (atmosphere.py:404-445) ----
    if ring_opt:
        aa = _parse_list(ring_opt)
        fits_idx = int(aa[0])
        ring_density = float(aa[1])          # [g cm-3] as painted (atmosphere.py:420)
        ring_temp = float(aa[2])
        gap_km, width_km = float(aa[3]), float(aa[4])
        t_in, t_out = int(aa[5]), int(aa[6])
        r_max = radial.max()
        radial = np.append(radial, [r_max + gap_km * 1e3, r_max + width_km * 1e3])
        tab = other_tables[fits_idx - 1]
        ring_sca = np.zeros((2, ntheta, nphi, nl))
        ring_abs = np.zeros((2, ntheta, nphi, nl))
        ring_mat = np.zeros((2, ntheta, nphi, nl, N_ANGLE, 16))
        ring_rho = np.zeros((2, ntheta, nphi))
        ring_tg = np.zeros((2, ntheta, nphi))
        # NB the reference uses the ring density in [g cm-3] directly against
        # the [m2 kg-1] opacities (atmosphere.py:433-434); kept verbatim.
        ring_sca[1, t_in:t_out] = (ring_density * tab.scattering / 10.0)[None, None, :]
        ring_abs[1, t_in:t_out] = (ring_density * tab.absorption / 10.0)[None, None, :]
        ring_mat[1, t_in:t_out] = tab.scatter.transpose(2, 0, 1)[None, None]
        ring_rho[1, t_in:t_out] = ring_density
        ring_tg[1, t_in:t_out] = ring_temp
        k_sca = np.concatenate([k_sca, ring_sca], axis=0)
        k_abs = np.concatenate([k_abs, ring_abs], axis=0)
        scatter = np.concatenate([scatter, ring_mat], axis=0)
        density = np.concatenate([density, ring_rho], axis=0)
        temperature = np.concatenate([temperature, ring_tg], axis=0)

    atm = Atmosphere(
        rfront=radial,
        thetafront=theta * PI / 180.0,
        phifront=phi * PI / 180.0,
        wavelengths=np.asarray(wavelengths_um) * 1.0e-6,
        density=density,
        temperature=temperature,
        k_sca=k_sca,
        k_abs=k_abs,
        scatter=scatter,
    )
    if has_pt:
        atm.profile_summary = np.column_stack([
            pressure * 1.0e-5, temperature_prof, density_gas * 1.0e-3,
            scale_height_cells * 1.0e-3, radial_cells * 1.0e-3,
        ])
    return atm


def build_and_write(directory) -> Atmosphere:
    """Build and persist atmosphere.fits (+ atmosphere.dat when hydrostatic)."""
    atm = build_atmosphere(directory)
    write_artifact(os.path.join(directory, "atmosphere.fits"), atm)
    if hasattr(atm, "profile_summary"):
        header = "# Pressure [bar] - Temperature [K] - Gas density [g/cm3] - Scale Height [km] - Altitude [km]\n\n"
        with open(os.path.join(directory, "atmosphere.dat"), "w") as fh:
            fh.write(header)
            np.savetxt(fh, atm.profile_summary)
    return atm
