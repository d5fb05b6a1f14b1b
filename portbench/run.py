"""Run one cell of the benchmark of artes_tpu_torch once, on one NVIDIA H100.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is an entry of ``workloads`` in
``BENCHMARK.json``: a configuration (``portbench/configs/<config>.json``) under a
traffic mix (``portbench/traffic/<traffic>.json``), with the limits of its
output check in ``portbench/checks/<workload>.json``. Each metric is a reader
of its own, ``portbench/metrics/<metric>.py`` (:func:`metric_reader`). A later
cell, mix or metric is new files and a new entry; nothing here names one.

Set-up (counted in ``setup_s``, from the process's start): the atmosphere's
arrays from the configuration, the port's libraries (built into the checkout's
``build/`` on the first run there), and one warm job of the cell's own
instantiation. The window then calls ``artes_tpu_torch.runner.run_wavelength``
once a job, float32 tables on the card, so every job takes the kernel path
``pool_cuda.run_stream_cuda``. A job is one wavelength of a spectrum or one
image, at one phase angle where the traffic names angles; jobs cycle over the
traffic's wavelengths and angles (``inputs.job_views``) with seeds drawn from
``--seed`` and the job's index. No job is cut: the window ends when the last
job started before ``--seconds`` returns. With ``--trace 1`` the window runs
under the profiler (``trace.py``) and the per-layer metrics are reported, else
the end-to-end ones. After the window the reference checks jobs drawn from the
seed (``check.py``); the numbers compared and their limits are the last lines
on standard error and the last key of the result, the one JSON line on
standard output.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
import json
import math
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

from portbench import check, costmodel, inputs
from portbench.reference.runner import photometry_from_detector
from portbench.trace import DeviceTrace

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
# JAX, its libraries and the JAX package (top-level module names): none may
# be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "artes_tpu")
WARM_PHOTONS = 1 << 20


def process_age_s() -> float:
    """Seconds since this process started (Linux's /proc)."""
    with open("/proc/self/stat") as fh:
        start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as fh:
        uptime = float(fh.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list[str]:
    """The loaded modules whose whole top-level name is forbidden."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_json(path: pathlib.Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def job_seed(seed: int, index: int) -> int:
    """A job's 32-bit transport seed, drawn from the run's seed."""
    return int(np.random.SeedSequence([seed % (1 << 64), index]).generate_state(1)[0])


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    check: dict
    end_to_end: list
    per_layer: list

    @classmethod
    def load(cls, name: str) -> "Cell":
        bench = load_json(ROOT / "BENCHMARK.json")
        entry = next((w for w in bench["workloads"] if w["name"] == name), None)
        if entry is None:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        e2e_names = {m["name"] for m in e2e}
        # a per-layer metric without "workloads" belongs to every cell that
        # reports the end-to-end metric it moves
        layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)]
        return cls(name=name, chips=entry["chips"],
                   config=load_json(HERE / "configs" / f"{entry['config']}.json"),
                   traffic=load_json(HERE / "traffic" / f"{entry['traffic']}.json"),
                   check=load_json(HERE / "checks" / f"{name}.json"),
                   end_to_end=e2e, per_layer=layer)

    def views(self) -> list[tuple[int, float | None]]:
        """The jobs of one cycle: ``(wavelength index, phase angle or None)``."""
        return inputs.job_views(self.config, self.traffic)


@dataclasses.dataclass
class Run:
    """What the metric readers read: the cell, its jobs, the window and, in a
    traced run, the device's trace."""

    cell: Cell
    jobs: list
    setup_s: float
    window_s: float
    trace: object = None
    _shapes: dict = dataclasses.field(default_factory=dict)

    def work(self, job: dict):
        """``(bytes, float32 operations)`` of the job's pool-kernel launch by
        the frozen cost model, or None where it has no count."""
        if job["wl"] not in self._shapes:
            self._shapes[job["wl"]] = costmodel.launch_shape(self.cell.config, self.cell.traffic,
                                                             job["wl"])
        return costmodel.pool_work(**self._shapes[job["wl"]], emitted=job["packages"],
                                   rounds=int(job["detector"][..., 1, 2].sum()))


def metric_reader(name: str) -> pathlib.Path:
    """The reader of metric ``name``: ``metrics/<name>.py``, or, for a quantity
    split by the cells that report it (``<quantity>.<part>``) with no reader
    of its own, the quantity's, ``metrics/<quantity>.py``."""
    own = HERE / "metrics" / f"{name}.py"
    return own if own.is_file() else HERE / "metrics" / f"{name.split('.', 1)[0]}.py"


def read_metric(name: str, run: Run):
    """The value of metric ``name`` by its reader (:func:`metric_reader`)."""
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  metric_reader(name))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(run)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    try:
        proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
    return proc.stdout.strip().splitlines()[0]


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             photons: int | None = None, jobs_only: int | None = None, log=print) -> dict:
    """Set up, run the window and check it; returns the result's fields.

    The window runs whole cycles of the traffic's jobs, so that every
    window holds the same mix of them: it ends when ``seconds`` have passed
    and the cycle in progress is done. ``device``, ``photons`` (each job's, in
    place of the traffic's) and ``jobs_only`` (that many jobs, whatever the
    time) let a test or ``control.py`` drive a run on the CPU, at a small
    size, or for the jobs its check reads."""
    from artes_tpu_torch import runner
    from artes_tpu_torch.atmosphere import Atmosphere
    from artes_tpu_torch.config import ArtesConfig, detector_setup

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats()
    atm = Atmosphere(**inputs.atmosphere_arrays(cell.config))
    cfg = inputs.run_config(ArtesConfig, cell.config, cell.traffic)
    views = cell.views()
    dets = {phase: inputs.detector_of(detector_setup, cfg, float(atm.rfront[-1]), phase)
            for phase in {p for _, p in views}}
    packages = int(photons or cell.traffic["photons_per_job"])

    def job(index: int, view: tuple, n: int, job_seed_: int) -> dict:
        wl, phase = view
        det, crescent = dets[phase]
        t0 = time.perf_counter()
        res = runner.run_wavelength(atm, cfg, det, wl, n, seed=job_seed_,
                                    dtype=torch.float32, device=device, crescent=crescent)
        t1 = time.perf_counter()
        # a job's record holds what a metric reader may read: a later reader
        # comes as a file of its own and cannot add a field here
        return {"index": index, "wl": wl, "phase_deg": phase, "seed": job_seed_, "packages": n,
                "t0": t0, "t1": t1, "detector": res.detector, "photometry": res.photometry,
                "n_error": res.n_error, "n_alive_at_cap": res.n_alive_at_cap}

    job(-1, views[0], min(packages, WARM_PHOTONS), job_seed(seed, 1 << 32))   # warm
    if on_card:
        torch.cuda.synchronize()
    setup_s = process_age_s()
    log(f"set-up {setup_s:.3f} s; window of {seconds} s, {packages} photons a job")

    jobs, failed = [], 0
    tracer = DeviceTrace() if trace else None
    with tracer or contextlib.nullcontext():
        w0 = time.perf_counter()
        index = 0
        while (index < jobs_only if jobs_only else
               index % len(views) or time.perf_counter() - w0 < seconds):
            try:
                jobs.append(job(index, views[index % len(views)], packages,
                                job_seed(seed, index)))
            except RuntimeError as e:
                log(f"job {index} failed: {e}")
                failed += 1
            index += 1
        w1 = time.perf_counter()
    window_s = w1 - w0
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.empty_cache()
    log(f"window {window_s:.3f} s: {len(jobs)} jobs, {failed} failed; seconds a job by "
        f"wavelength: " + ", ".join(
            f"{wl}: {np.mean([j['t1'] - j['t0'] for j in jobs if j['wl'] == wl]):.4f}"
            for wl in sorted({w for w, _ in views}) if any(j["wl"] == wl for j in jobs)))

    for j in jobs:
        j["sigma_pol"] = float(photometry_from_detector(j["detector"])[10])
    run = Run(cell=cell, jobs=jobs, setup_s=setup_s, window_s=window_s, trace=tracer)
    metrics = {}
    wanted = cell.per_layer if trace else cell.end_to_end
    for m in wanted:
        value = read_metric(m["name"], run) if jobs else None
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    t0 = time.perf_counter()
    numbers, where = check.check_jobs(jobs, cell.config, cell.traffic, cell.check, seed, device)
    log(f"check of {min(cell.check['jobs'], len(jobs))} job(s) in {time.perf_counter() - t0:.3f} s")
    result = {"correct": check.passes(numbers) and bool(jobs), "attempted": index,
              "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                         "count": cell.chips, "memory_peak_bytes": int(memory_peak)}}
    if tracer is not None:
        result["device"]["busy_s"] = tracer.busy_s()
        result["device"]["window_s"] = window_s
        result["breakdown"] = {"device_ops": tracer.top_ops(), "idle_gaps": tracer.idle_gaps()}
    result["where"] = where
    result["checks"] = numbers
    return result


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else str(x)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # every build and kernel cache of the program stays inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    # one process with few threads: the host's share of a job is Python and
    # numpy on one core, and idle pool threads only widen the runs' spread
    torch.set_num_threads(1)
    cell = Cell.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); torch finds "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2

    def log(msg):
        print(f"portbench: {msg}", file=sys.stderr, flush=True)

    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), log=log)
    card = card_line()
    log(f"card: {card}")
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded in this process: {', '.join(bad)}")
        return 3
    where = result.pop("where")
    numbers = result.pop("checks")
    result["card"] = card
    result["checks"] = {k: {"value": _finite(v["value"]), "limit": v["limit"]}
                        for k, v in numbers.items()}
    log(f"correct: {result['correct']} (worst tally_z at {where})")
    for k, v in numbers.items():
        print(f"{k} {float(v['value'])!r} limit {v['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
