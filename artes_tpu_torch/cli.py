"""Command-line interface: the reference's run contract.

Usage (the contract of ``artes_tpu.cli``)::

    python -m artes_tpu_torch.cli <atmosphere> <photons> -o <run> [-k key=value ...]
        [--seed N] [--f64] [--device cuda|cpu] [--mesh] [--resume] [--debug-stokes]
    python -m artes_tpu_torch.cli build <atmosphere>
    torchrun --nproc-per-node N -m artes_tpu_torch.cli <atmosphere> <photons> --mesh ...

Reads ``input/<atmosphere>/artes.in`` and ``atmosphere.fits``, runs the
detector mode it names (spectrum, imaging_mono, imaging_broad or phase) and
writes ``output/<run>/{input,output,plot}`` with a snapshot of the inputs.
``--device cuda`` (the default) runs the CUDA kernel of the configuration
(radial, 3-D or marching), ``--debug-stokes`` and ``photon:scattering=off``
included, and fails when there is no card; ``--device cpu`` runs the plain
PyTorch version. ``--f64`` runs the plain version in float64 on the device
asked for, the card by default (the kernels are float32 only, as the JAX
package's Pallas kernel is; its float64 runs take the XLA pool on its
device); nothing falls back to the CPU. ``output:flow_global`` and
``output:flow_latitudinal`` leave ``flow_global.fits`` and
``flow_latitudinal.fits`` in every mode but ``imaging_broad`` (the last
wavelength's or phase angle's). Abandoned photons and failed peel walks
(geometry errors, Stokes anomalies) are tallied per code in ``error.log``
with the state of the first and last ones in photon-id order.

``--mesh`` splits every run's photons by id over the processes of a
launcher (``torchrun``: NCCL on cards, gloo with ``--device cpu``) or, with
``--device cuda`` and no launcher, over every visible card, one spawned
worker each; the tallies are summed over the processes and rank 0 alone
writes. ``--resume`` runs only the wavelengths that ``spectrum.dat`` does
not hold yet.
"""

from __future__ import annotations

import argparse
import os
import shutil
import socket
import sys

import numpy as np
import torch
import torch.distributed as dist


def build_main(argv=None):
    p = argparse.ArgumentParser(prog="artes_tpu_torch build")
    p.add_argument("atmosphere", help="name under input/")
    p.add_argument("--root", default=".")
    args = p.parse_args(argv)
    from artes_tpu_torch.atmosphere import build_and_write

    atm = build_and_write(os.path.join(args.root, "input", args.atmosphere))
    print(f"atmosphere.fits written: nr={atm.nr} ntheta={atm.ntheta} "
          f"nphi={atm.nphi} n_wavelength={atm.n_wavelength}")
    return 0


def run_main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser(
        prog="artes_tpu_torch",
        description="Polarized Monte Carlo radiative transfer on PyTorch/CUDA")
    p.add_argument("atmosphere", help="input directory name under input/")
    p.add_argument("photons", type=float, help="number of photon packages")
    p.add_argument("-o", "--output", default="run", help="output directory name")
    p.add_argument("-k", "--keyword", action="append", default=[],
                   metavar="key=value", help="override any artes.in key")
    p.add_argument("--root", default=".")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch-size", type=int, default=1 << 17,
                   help="photons the plain version emits together (CPU)")
    p.add_argument("--f64", action="store_true",
                   help="run transport in float64: the plain version on --device (the card by "
                        "default; the CUDA kernels are float32 only)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--mesh", action="store_true",
                   help="split the photons of every run over the processes of a launcher "
                        "(torchrun), or with --device cuda and no launcher over every visible "
                        "card, one spawned worker each")
    p.add_argument("--resume", action="store_true",
                   help="skip wavelengths already present in spectrum.dat "
                        "(per-wavelength outputs are idempotent)")
    p.add_argument("--progress", action="store_true",
                   help="per-chunk progress ticker on stderr")
    p.add_argument("--debug-stokes", action="store_true",
                   help="Stokes-anomaly check I^2 >= Q^2+U^2+V^2 after every scatter "
                        "(error 050); anomalous photons are abandoned and tallied "
                        "(the CUDA kernels and the plain version alike)")
    args = p.parse_args(argv)

    from artes_tpu_torch.parallel import make_mesh, multihost

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: torch finds no CUDA device")
    if not args.mesh:
        return _run(args, None)
    if not multihost.launched():
        if args.device == "cpu":
            raise RuntimeError("--mesh --device cpu needs a launcher: run it under "
                               "torchrun --nproc-per-node N")
        return _spawn(argv)
    owned = not dist.is_initialized()
    multihost.initialize("nccl" if args.device == "cuda" else "gloo")
    try:
        return _run(args, make_mesh(args.device))
    finally:
        if owned:
            dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(argv) -> int:
    """``--mesh --device cuda`` without a launcher: one worker per visible
    card over a localhost rendezvous. A worker that fails ends the others
    and the run raises."""
    import torch.multiprocessing as mp

    from artes_tpu_torch import cli     # the workers unpickle cli._worker

    size = torch.cuda.device_count()
    mp.start_processes(cli._worker, args=(argv, size, _free_port()), nprocs=size,
                       start_method="spawn")
    return 0


def _worker(rank: int, argv, size: int, port: int) -> None:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(size),
                      RANK=str(rank), LOCAL_RANK=str(rank))
    run_main(argv)


def _resume_todo(dirs, atm, mesh):
    """The wavelengths not yet in ``spectrum.dat``: read by the coordinator
    (the only rank with ``dirs``) and broadcast, so that every rank runs the
    same list."""
    todo = None
    if dirs is not None:
        done = set()
        if os.path.isfile(dirs.path("spectrum.dat")):
            with open(dirs.path("spectrum.dat")) as fh:
                rows = [line.split() for line in fh if line.strip() and not line.startswith("#")]
            done = {round(float(row[0]), 9) for row in rows}
        todo = [wl for wl in range(atm.n_wavelength)
                if round(atm.wavelengths[wl] * 1e6, 9) not in done]
    if mesh is not None:
        box = [todo]
        dist.broadcast_object_list(box, src=0, group=mesh.group, device=mesh.device)
        todo = box[0]
    return todo


def _run(args, mesh) -> int:
    """The run of ``args``; over ``mesh`` every rank computes, the
    coordinator (rank 0) alone writes the output tree, the report,
    ``error.log`` and the progress lines."""
    from artes_tpu_torch.atmosphere import load_artifact
    from artes_tpu_torch.config import detector_setup, load_config, snapshot
    from artes_tpu_torch import output as out
    from artes_tpu_torch import runner
    from artes_tpu_torch.parallel.mesh import LAUNCHES as mesh_launches
    from artes_tpu_torch.transport import pool_cuda

    coordinator = mesh is None or mesh.rank == 0
    atm_dir = os.path.join(args.root, "input", args.atmosphere)
    cfg = load_config(os.path.join(atm_dir, "artes.in"), overrides=args.keyword)
    cfg.debug_stokes = args.debug_stokes
    atm = load_artifact(os.path.join(atm_dir, "atmosphere.fits"))
    packages = int(args.photons)
    det = detector_setup(cfg, float(atm.rfront[-1]))

    dirs = report = None
    if coordinator:
        # output tree + snapshot of the full input tree (ARTES.f90:4283-4293)
        dirs = out.OutputDirs(args.root, args.output)
        for name in sorted(os.listdir(atm_dir)):
            src = os.path.join(atm_dir, name)
            if os.path.isfile(src):
                shutil.copy(src, dirs.input)
            elif os.path.isdir(src):
                shutil.copytree(src, os.path.join(dirs.input, name), dirs_exist_ok=True)
        with open(os.path.join(dirs.input, "artes.in.effective"), "w") as fh:
            fh.write(snapshot(cfg))
        report = out.RunReport(dirs, cfg.log_file)
        report.stage1(cfg, atm, det)
        out.write_plot_dat(dirs, cfg, atm, det)

    kw = dict(seed=args.seed, batch_size=args.batch_size,
              dtype=torch.float64 if args.f64 else torch.float32, device=args.device,
              progress=coordinator and (sys.stderr.isatty() or args.progress), mesh=mesh)
    thermal = cfg.photon_source != "star"
    runs = []

    def write_flow(res):
        # (over)written per run, as the reference's write_output does
        # (ARTES.f90:3713-3770)
        if cfg.flow_global and res.flow_global is not None:
            out.write_flow_global(dirs, res.flow_global, res.cell_depth)
        if cfg.flow_theta and res.flow_theta is not None:
            out.write_flow_latitudinal(dirs, res.flow_theta, res.flux_exit, res.cell_depth)

    if cfg.mode == "spectrum":
        todo = list(range(atm.n_wavelength))
        if args.resume:
            todo = _resume_todo(dirs, atm, mesh)
            if coordinator and len(todo) < atm.n_wavelength:
                print(f"resume: skipping {atm.n_wavelength - len(todo)} completed "
                      f"wavelengths", file=sys.stderr)
        det, results = runner.run_spectrum(atm, cfg, packages, wl_subset=todo, **kw)
        if coordinator:
            if 0 in todo:
                report.stage2(cfg, atm, det, packages, 0, results[0].cell_depth)
            for wl, res in zip(todo, results):
                wl_m = atm.wavelengths[wl]
                out.write_spectrum_row(dirs, wl_m, res)
                out.write_optical_depth(dirs, atm, wl)
                out.write_cell_depth(dirs, wl_m, res.cell_depth)
                write_flow(res)
                if thermal:
                    out.write_luminosity(dirs, wl_m, res, packages)
                else:
                    out.write_normalization(dirs, cfg, atm, wl_m)
                runs.append(res)
                print(f"Wavelength: {wl_m * 1e6:7.3f} micron", file=sys.stderr)
            if runs:
                report.stage3(cfg, atm, runs[-1], atm.n_wavelength - 1)
            else:
                print("resume: nothing to do", file=sys.stderr)

    elif cfg.mode == "imaging_mono":
        det, res = runner.run_imaging_mono(atm, cfg, packages, **kw)
        if coordinator:
            report.stage2(cfg, atm, det, packages, 0, res.cell_depth)
            wl_m = atm.wavelengths[0]
            out.write_stokes_fits(dirs, det, res)
            out.write_photometry(dirs, wl_m, res)
            out.write_cell_depth(dirs, wl_m, res.cell_depth)
            if thermal:
                out.write_luminosity(dirs, wl_m, res, packages)
                out.write_cell_luminosity(dirs, res.prep.cell_luminosity)
            else:
                out.write_normalization(dirs, cfg, atm, wl_m)
            write_flow(res)
            runs.append(res)
            report.stage3(cfg, atm, res)

    elif cfg.mode == "imaging_broad":
        det, summed, tallies = runner.run_imaging_broad(atm, cfg, packages, **kw)
        if coordinator:
            runs = tallies
            report.stage2(cfg, atm, det, packages, 0, runs[0].cell_depth)
            out.write_stokes_fits(dirs, det, summed)
            for wl in range(atm.n_wavelength):
                out.write_optical_depth(dirs, atm, wl)
            report.stage3(cfg, atm, summed)

    elif cfg.mode == "phase":
        results = runner.run_phase_curve(atm, cfg, packages, **kw)
        if coordinator:
            report.stage2(cfg, atm, results[0][1], packages, 0, results[0][2].cell_depth)
            for ang, _, res in results:
                out.write_phase_row(dirs, ang, res)
                if not thermal and ang < 1.0:
                    out.write_normalization(dirs, cfg, atm, atm.wavelengths[0])
                write_flow(res)
                runs.append(res)
                print(f"\rPhase angle: {ang:6.1f} degrees", end="", file=sys.stderr)
            print(file=sys.stderr)

    launches = dict(pool_cuda.LAUNCHES, mesh=mesh_launches["mesh"])
    if mesh is not None:
        # every rank's launches, summed on the coordinator's lines
        counts = torch.tensor(list(launches.values()), dtype=torch.int64, device=mesh.device)
        dist.all_reduce(counts, group=mesh.group)
        launches = dict(zip(launches, counts.tolist()))
    if not coordinator:
        return 0
    n_mesh = launches.pop("mesh")
    # n_capped sums over every run (wavelength / phase angle), so the
    # denominator is the total emitted count
    n_error = sum(res.n_error for res in runs)
    error_codes = sum((res.error_codes for res in runs), np.zeros(4, np.int64))
    if n_error or error_codes.any():
        # per-code tallies mirroring the reference's numbered error log
        # (ARTES.f90:3397-3416, :4218-4228)
        entries = [(code, int(cnt)) for code, cnt in zip(
            ("031/geometry no-candidate", "032/runaway traversal",
             "034/degenerate surface bounce", "05x/peel walk"), error_codes) if cnt]
        n_anomaly = sum(res.n_stokes_anomaly for res in runs)
        if n_anomaly:
            entries.append(("050/stokes anomaly", n_anomaly))
        records = []
        for res in runs:
            if len(records) < 16:
                records.extend(list(res.error_records))
        out.write_error_log(dirs, entries, records[:16])
    report.truncation(sum(res.n_alive_at_cap for res in runs),
                      packages * max(len(runs), 1), cfg.max_scatter)
    if args.device == "cuda":
        report.emit(f"CUDA kernel launches: pool={sum(launches.values())} ("
                    + " ".join(f"{k}={v}" for k, v in launches.items()) + ")")
    if mesh is not None:
        report.emit(f"mesh launches: {n_mesh} over {mesh.size} ranks")
    report.stage4(n_error)
    out.send_completion_email(cfg, args.output)
    return 0


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "build":
        return build_main(argv[1:])
    return run_main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
