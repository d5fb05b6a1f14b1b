"""The control of the output check, and the faults it must refuse.

The control is the reference put in the program's place, computed in
bfloat16, the precision below the float32 that the configurations state: its
tables are built in bfloat16 and each uniform draw is the float32 draw
rounded to bfloat16 (kept inside (0, 1), as the float32 draw is). A run with
the control in place must come out not correct; so must a run whose kernel
call returns its tallies unchanged (zeros), transports half of its photons
and takes the mean over the rest, or alters Stokes Q where it is produced.

Two more readings show what the check sees short of that: ``draws``, the
reference in the program's place in float32 with only its uniform draws
rounded to bfloat16 (the geometry and the tables kept in float32, so photons
still scatter), and ``capped``, the program with its scattering cap
(``max_scatter``) cut to :data:`CAP`, which abandons the photons that
scatter more.

    python3 -m portbench.control --workload <name> --seeds 1,2,3 [--fault control]

runs one window a seed in one process, of as many jobs at the cell's own size
as a run's check reads, and prints each seed's numbers compared beside their
limits, one JSON line a seed. ``--fault none`` reads the sound program.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys

import numpy as np
import torch

from portbench import check, inputs
from portbench.reference import config as rcfg
from portbench.reference import rng as rrng
from portbench.reference.runner import photometry_from_detector

FAULTS = ("none", "control", "unchanged", "half", "altered", "draws", "capped")
BF16_TINY = 2.0 ** -126
BF16_ONE_MINUS = 1.0 - 2.0 ** -9
CAP = 16


@contextlib.contextmanager
def bfloat16_draws(every: bool = False):
    """The reference's uniform draws accept bfloat16: the float32 draw
    rounded, and kept strictly inside (0, 1). With ``every``, draws asked
    for in float32 are rounded alike and handed back in float32."""
    plain = rrng.uniform_n_kk

    def draws(k0, k1, base_site, n, dtype=torch.float32):
        if dtype == torch.bfloat16:
            return [torch.clamp(u.to(torch.bfloat16), BF16_TINY, BF16_ONE_MINUS)
                    for u in plain(k0, k1, base_site, n, torch.float32)]
        if every and dtype == torch.float32:
            return [torch.clamp(u.to(torch.bfloat16).to(dtype), BF16_TINY, BF16_ONE_MINUS)
                    for u in plain(k0, k1, base_site, n, dtype)]
        return plain(k0, k1, base_site, n, dtype)

    rrng.uniform_n_kk = draws
    try:
        yield
    finally:
        rrng.uniform_n_kk = plain


class _Result:
    def __init__(self, detector, counts):
        self.detector = detector
        self.photometry = photometry_from_detector(detector)
        self.n_error, self.n_alive_at_cap = counts["n_error"], counts["n_alive_at_cap"]


def _kernel_fault(fault: str, plain):
    """``plain`` (a kernel call of the runner: ``pool_cuda.run_stream_cuda``
    or ``kernel.run_stream``) with ``fault`` planted in what it returns."""
    def call(tables, static, n, seed, *rest):
        if fault == "half":
            out = dict(plain(tables, static, n // 2, seed, *rest))
            det = out["detector"].clone()
            det[..., :2] *= 2.0          # the mean over the half transported
            out["detector"] = det
            return out
        out = dict(plain(tables, static, n, seed, *rest))
        det = out["detector"].clone()
        if fault == "unchanged":
            det.zero_()
        elif fault == "altered":
            det[:, 1, 0] = -det[:, 1, 0]
        out["detector"] = det
        return out
    return call


def _phase_of(cell) -> dict:
    """Each job view's phase angle (or None) by its detector's phi: what ties
    a call of ``run_wavelength`` back to its job's view."""
    cfg = inputs.run_config(rcfg.ArtesConfig, cell.config, cell.traffic)
    r_max = float(inputs.atmosphere_arrays(cell.config)["rfront"][-1])
    return {inputs.detector_of(rcfg.detector_setup, cfg, r_max, p)[0].det_phi: p
            for p in {p for _, p in cell.views()}}


@contextlib.contextmanager
def planted(fault: str, cell, device: str):
    """Run the window with ``fault`` in place (see :data:`FAULTS`)."""
    from artes_tpu_torch import runner
    from artes_tpu_torch.transport import pool_cuda

    saved = (runner.run_wavelength, runner.run_stream, pool_cuda.run_stream_cuda)
    if fault in ("control", "draws"):
        phase_of = _phase_of(cell)

        def control(atm, cfg, det, wl, n, seed=0, **_):
            dtype = torch.bfloat16 if fault == "control" else torch.float32
            with bfloat16_draws(every=fault == "draws"):
                return _Result(*check.reference_detector(
                    cell.config, cell.traffic, wl, n, seed, device, dtype=dtype,
                    phase_deg=phase_of[det.det_phi]))
        runner.run_wavelength = control
    elif fault == "capped":
        def capped(atm, cfg, *args, **kw):
            return saved[0](atm, dataclasses.replace(cfg, max_scatter=CAP), *args, **kw)
        runner.run_wavelength = capped
    elif fault != "none":
        runner.run_stream = _kernel_fault(fault, saved[1])
        pool_cuda.run_stream_cuda = _kernel_fault(fault, saved[2])
    try:
        yield
    finally:
        runner.run_wavelength, runner.run_stream, pool_cuda.run_stream_cuda = saved


def main(argv=None) -> int:
    from portbench import run

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--fault", choices=FAULTS, default="control")
    p.add_argument("--photons", type=int, default=None,
                   help="photons a job in place of the traffic's (for the readings of "
                        "'draws', whose float32 reference takes about 2000 times the "
                        "program's time)")
    args = p.parse_args(argv)
    cell = run.Cell.load(args.workload)
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        with planted(args.fault, cell, "cuda"):
            res = run.run_cell(cell, seed, 0.0, False, jobs_only=cell.check["jobs"],
                               photons=args.photons,
                               log=lambda m: print(m, file=sys.stderr, flush=True))
        line = {"workload": args.workload, "fault": args.fault, "seed": seed,
                "correct": res["correct"], "jobs": res["attempted"], "where": res["where"],
                "checks": {k: {"value": float(np.float64(v["value"])), "limit": v["limit"]}
                           for k, v in res["checks"].items()}}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
