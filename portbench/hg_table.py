"""BASELINE #2's cloud table, ``configs/hg_cloud_deck.cloud.json``: one
Henyey-Greenstein lobe of the triple-HG generator (python/
opacityHenyeyGreenstein.py) at 0.8 micron, g = 0.6, linear polarization 0.4,
single-scattering albedo 0.95 (``presets.hg_cloud_deck(tau=6.0, g=0.6,
p_linear=0.4)`` of the port, ``tools/baseline_scale_artifacts.py:35-74``).

    python3 -m portbench.hg_table

writes the file; :func:`table` is what it holds, which a test reruns. The
table is data to the harness: ``inputs.atmosphere_arrays`` reads the file,
not this module.
"""

from __future__ import annotations

import json
import pathlib

WAVELENGTHS_UM = [0.8]
G, P_LINEAR, SSA = 0.6, 0.4, 0.95
PATH = pathlib.Path(__file__).resolve().parent / "configs" / "hg_cloud_deck.cloud.json"


def table() -> dict:
    """The cloud file's contents: per wavelength the single-scattering
    albedo, the extinction relative to the first wavelength and the 180 x 16
    scattering matrix, from the port's generator."""
    from artes_tpu_torch.opacity import henyey_greenstein

    tab = henyey_greenstein.generate(WAVELENGTHS_UM, absorption=(1.0 - SSA) / SSA,
                                     scattering=1.0, g1=G, p_linear=P_LINEAR)
    return {"what": "BASELINE #2's cloud: one Henyey-Greenstein lobe, g = 0.6, linear "
                    "polarization 0.4, single-scattering albedo 0.95, at 0.8 micron "
                    "(artes_tpu_torch.opacity.henyey_greenstein.generate, as "
                    "presets.hg_cloud_deck builds it); python3 -m portbench.hg_table writes it",
            "wavelengths_um": WAVELENGTHS_UM,
            "albedo": (tab.scattering / tab.extinction).tolist(),
            "extinction_rel": (tab.extinction / tab.extinction[0]).tolist(),
            "scatter": tab.scatter.transpose(2, 0, 1).tolist()}


def main() -> None:
    PATH.write_text(json.dumps(table()))


if __name__ == "__main__":
    main()
