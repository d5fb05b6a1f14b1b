"""Mie/DHS cloud opacity generation (python/opacityMie.py equivalent).

Drives the native ``computepart`` solver (C++, ``native/mie/mie.cc``, built
with g++ by ``_build`` at first use) exactly as the reference drives its
prebuilt ComputePart binary (opacityMie.py:92-106): write ``mie.in`` + the
wavelength list, run the solver, read ``particle.fits`` back, expand the
6-element matrix to 16 and renormalise (opacityMie.py:109-144). A failed
build or solver run raises.
"""

from __future__ import annotations

import os
import subprocess
import tempfile

import numpy as np

from artes_tpu_torch import _build
from artes_tpu_torch.io.fitsio import read_fits
from artes_tpu_torch.opacity.base import (
    OpacityTable,
    expand_6_to_16,
    normalize_scatter,
)


def solver_path() -> str:
    """The native computepart binary, built on first use."""
    return _build.build_host("computepart")


def compute_particle(ri_file, wavelengths_um, nr=1000, nf=20, density=1.0,
                     amin=0.1, amax=5.0, apow=0.0, fmax=0.0,
                     r_eff=None, v_eff=None, workdir=None):
    """Run the DHS/Mie solver; returns (opacity_block (4,nl), scatter6 (180,6,nl)).

    Mirrors the mie.in contract (opacityMie.py:92-98) including the
    (r_eff, v_eff) overrule via extra argv (opacityMie.py:100-105).
    """
    binary = solver_path()
    ri_file = os.path.abspath(os.fspath(ri_file))
    ctx = tempfile.TemporaryDirectory() if workdir is None else None
    tmp = workdir or ctx.name
    try:
        with open(os.path.join(tmp, "mie.in"), "w") as fh:
            fh.write(f"{nr}\n{nf}\n'{ri_file}'\n")
            fh.write(f"100.\t{density}\t{amin}\t{amax}\t{apow}\t{fmax}")
        with open(os.path.join(tmp, "wavelength.dat"), "w") as fh:
            for wl in wavelengths_um:
                fh.write(f"{wl}\n")
        cmd = [binary, "mie.in", "wavelength.dat"]
        if r_eff is not None and r_eff > 0.0:
            cmd += [str(r_eff), str(v_eff)]
        proc = subprocess.run(cmd, cwd=tmp, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"computepart failed (exit {proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        hdus = read_fits(os.path.join(tmp, "particle.fits"))
        return np.asarray(hdus[0][1]), np.asarray(hdus[1][1])
    finally:
        if ctx is not None:
            ctx.cleanup()


def generate(ri_file, wavelengths_um, **kwargs) -> OpacityTable:
    """Full cloud-opacity pipeline: solver -> 16-element normalised table."""
    opacity, scatter6 = compute_particle(ri_file, wavelengths_um, **kwargs)
    scatter = normalize_scatter(expand_6_to_16(scatter6))
    return OpacityTable(
        wavelength=opacity[0],
        extinction=opacity[1],
        absorption=opacity[2],
        scattering=opacity[3],
        scatter=scatter,
    )
