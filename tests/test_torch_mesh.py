"""The mesh launch (``artes_tpu_torch.parallel.mesh``) on the CPU.

* :func:`split_ids` is bit-equal to ``pallas_stream._device_si`` on a grid
  of counts, devices and id words (fewer photons than devices, uneven
  splits, a high id word, a range ending at 2^32).
* Two gloo ranks (subprocesses with a launcher's environment, float64, the
  plain version) run :func:`run_stream_mesh` and ``runner.run_wavelength``
  over the mesh on four configurations: the flagship; an 8 x 2 x 1 grid
  whose crossing cap abandons a third of its photons (more records than a
  run keeps); flow diagnostics on four shells; a 5 x 5 image over a Lambert
  surface. Counts are bit-equal to one process, moments within rtol 1e-12,
  error records identical, and every rank holds the whole result.
* The same runs against the JAX package's own multi-device path:
  ``artes_tpu.runner.run_wavelength`` with ``sharded_dispatch`` over the 8
  virtual CPU devices at float64: counts bit-equal, moments within rtol
  1e-10 (seed 5, where the two packages agree photon for photon).
* Three photons over four ranks: the empty sub-ranges add nothing.
* The reduction is one ``all_reduce`` of the float64 tallies and one of the
  int64 tallies, and equals ``merge_outputs`` of the two sub-ranges run in
  one process.

Every worker has a timeout, and so has its process group, so a rank that
dies cannot hang the suite.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from artes_tpu_torch import cells, presets, runner
from artes_tpu_torch.config import ArtesConfig, detector_setup
from artes_tpu_torch.parallel import mesh as M
from artes_tpu_torch.transport import kernel as TK
from torch_threads import one_thread, one_thread_env  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 5
N_STREAM = 255          # split 128 + 127 over two ranks
N_RUN = 256             # the JAX sharded dispatch takes multiples of its 8 devices
FLOW = dict(flow_global=True, flow_theta=True)

# name: (atmosphere, ArtesConfig keys, KernelStatic overrides)
CASES = {
    "flagship": (cells.flagship, {}, {}),
    "grid3d abandons": (lambda: presets.rayleigh_single_layer(
        tau=6.0, nr=8, theta_deg=(0.0, 90.0, 180.0)), {}, dict(max_crossings=2)),
    "flow": (lambda: presets.rayleigh_single_layer(tau=3.0, nr=4), FLOW, {}),
    "image over a surface": (lambda: presets.rayleigh_single_layer(tau=0.5, nr=2),
                             dict(surface_albedo=0.8, mode="imaging_mono", npix=5), {}),
}


def case_config(name, config_cls=ArtesConfig):
    """``(atm, cfg, overrides)`` of a case; ``config_cls`` lets the JAX
    package's ``ArtesConfig`` take the same keys."""
    make, keys, over = CASES[name]
    cfg = config_cls()
    cfg.mode = "spectrum"
    for k, v in keys.items():
        setattr(cfg, k, v)
    return make(), cfg, over


def case_tables(name):
    atm, cfg, over = case_config(name)
    keys = {k: getattr(cfg, k) for k in CASES[name][1]}
    tables, static = cells.run_tables(atm, "cpu", torch.float64, **keys)
    return tables, dataclasses.replace(static, **over)


def case_run(name, **kw):
    """``runner.run_wavelength`` of a case at float64 on the CPU (``kw``:
    ``mesh``), with the case's static overrides."""
    atm, cfg, over = case_config(name)
    orig = runner._kernel_static
    runner._kernel_static = lambda *a: dataclasses.replace(orig(*a), **over)
    try:
        det = detector_setup(cfg, float(atm.rfront[-1]))
        return runner.run_wavelength(atm, cfg, det, 0, N_RUN, seed=SEED, dtype=torch.float64,
                                     device="cpu", **kw)
    finally:
        runner._kernel_static = orig


WORKER = r"""
import sys
import torch
torch.set_num_threads(1)
sys.path.insert(0, sys.argv[1])
from test_torch_mesh import CASES, N_STREAM, SEED, case_run, case_tables
from artes_tpu_torch.parallel import make_mesh, multihost, run_stream_mesh

assert multihost.initialize("gloo", timeout_s=120)
mesh = make_mesh("cpu")
# the all_reduce calls of each run_stream_mesh, by the dtype they sum
reduces = []
all_reduce = torch.distributed.all_reduce
def counted(tensor, *args, **kwargs):
    reduces.append(str(tensor.dtype))
    return all_reduce(tensor, *args, **kwargs)
torch.distributed.all_reduce = counted
results = {}
for name in sys.argv[3].split(","):
    tables, static = case_tables(name)
    n = int(sys.argv[4]) if len(sys.argv) > 4 else N_STREAM
    reduces.clear()
    results[name] = {"stream": run_stream_mesh(tables, static, n, SEED, 0, 0, mesh, 64),
                     "reduces": sorted(reduces)}
    if len(sys.argv) <= 4:
        results[name]["run"] = case_run(name, mesh=mesh)
torch.save(results, sys.argv[2] + f".rank{mesh.rank}")
torch.distributed.destroy_process_group()
"""


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(tmp_path, size, argv, timeout=300):
    """``python argv`` in ``size`` processes with a launcher's environment
    (localhost rendezvous); every process must exit 0 within ``timeout``
    seconds, else all are killed and the test fails."""
    port = free_port()
    procs, logs = [], []
    for rank in range(size):
        env = one_thread_env(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                             WORLD_SIZE=str(size), RANK=str(rank), LOCAL_RANK=str(rank),
                             PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        env.pop("XLA_FLAGS", None)
        log = open(tmp_path / f"rank{rank}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen([sys.executable, *argv], env=env, cwd=str(tmp_path),
                                      stdout=log, stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"a rank of {size} did not finish within {timeout} s")
    finally:
        for log in logs:
            log.close()
    for rank, p in enumerate(procs):
        assert p.returncode == 0, (tmp_path / f"rank{rank}.log").read_text()[-3000:]
    return [(tmp_path / f"rank{rank}.log").read_text() for rank in range(size)]


def run_mesh(tmp_path, size, names, n=None):
    """Each rank's results of the WORKER on the cases ``names``."""
    base = str(tmp_path / "out")
    argv = ["-c", WORKER, os.path.dirname(os.path.abspath(__file__)), base, ",".join(names)]
    run_ranks(tmp_path, size, argv + ([str(n)] if n is not None else []))
    return [torch.load(f"{base}.rank{r}", weights_only=False) for r in range(size)]


def test_split_ids_bit_equal_to_device_si():
    from artes_tpu.transport.pallas_stream import _device_si

    for n in (0, 1, 3, 7, 8, 1000, 1 << 20, (1 << 30) + 5):
        for n_dev in (1, 2, 3, 4, 7, 8):
            for id_hi, id_lo in ((0, 0), (0, 12345), (3, 0), (0xFFFFFFFF, 999)):
                for seed in (0, 7, 0xFFFFFFFF):
                    got = M.split_ids(n, seed, id_hi, id_lo, n_dev)
                    ref = _device_si(n, seed, id_hi, id_lo, n_dev)
                    assert got.dtype == ref.dtype == np.uint32
                    np.testing.assert_array_equal(got, ref)
    # a range that ends exactly at 2^32
    for n_dev in (1, 3, 8):
        got = M.split_ids(1000, 5, 2, (1 << 32) - 1000, n_dev)
        np.testing.assert_array_equal(got, _device_si(1000, 5, 2, (1 << 32) - 1000, n_dev))
        assert int(got[:, 0].astype(np.int64).sum()) == 1000
        assert int(got[-1, 2]) + int(got[-1, 0]) == 1 << 32
    assert M.round_up_batch(1001, 8) == 1008 and M.round_up_batch(1008, 8) == 1008


def assert_same_tallies(got, ref, rtol):
    """Counts and integer tallies equal, moments, fluxes and flow within
    ``rtol``; both results of ``run_stream`` (dicts)."""
    np.testing.assert_array_equal(got["detector"][..., 2].numpy(), ref["detector"][..., 2].numpy())
    np.testing.assert_allclose(got["detector"][..., :2].numpy(), ref["detector"][..., :2].numpy(),
                               rtol=rtol, atol=0.0)
    for key in ("n_error", "n_alive_at_cap", "n_stokes_anomaly", "n_emitted", "n_error_records"):
        assert int(got[key]) == int(ref[key]), key
    np.testing.assert_array_equal(np.asarray(got["error_codes"]), np.asarray(ref["error_codes"]))
    for key in ("flux_emitted", "flux_exit"):
        np.testing.assert_allclose(float(got[key]), float(ref[key]), rtol=rtol, atol=0.0)
    for key in ("flow_global", "flow_theta", "flow_path"):
        assert (got[key] is None) == (ref[key] is None), key
        if ref[key] is not None:
            np.testing.assert_allclose(got[key].numpy(), ref[key].numpy(), rtol=rtol,
                                       atol=rtol * float(ref[key].abs().max()))


def assert_same_run(got, ref, rtol):
    """Two ``runner.WavelengthResult``: counts and error tallies equal,
    moments, fluxes and flow within ``rtol``."""
    np.testing.assert_array_equal(got.detector[..., 2], ref.detector[..., 2])
    np.testing.assert_allclose(got.detector[..., :2], ref.detector[..., :2], rtol=rtol, atol=0.0)
    assert (got.n_error, got.n_alive_at_cap) == (ref.n_error, ref.n_alive_at_cap)
    np.testing.assert_array_equal(got.error_codes, ref.error_codes)
    np.testing.assert_allclose([got.flux_emitted, got.flux_exit],
                               [ref.flux_emitted, ref.flux_exit], rtol=rtol, atol=0.0)
    for a, b in ((got.flow_global, ref.flow_global), (got.flow_theta, ref.flow_theta)):
        assert (a is None) == (b is None)
        if b is not None:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.abs(b).max())


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return run_mesh(tmp_path_factory.mktemp("mesh2"), 2, sorted(CASES))


@pytest.mark.parametrize("name", sorted(CASES))
def test_two_gloo_ranks_equal_one_process(name, two_ranks):
    torch.set_num_threads(1)
    tables, static = case_tables(name)
    ref = TK.run_stream(tables, static, N_STREAM, SEED, 64)
    got = two_ranks[0][name]["stream"]
    assert_same_tallies(got, ref, 1e-12)
    assert torch.equal(got["error_records"], ref["error_records"])
    # every rank holds the whole result
    other = two_ranks[1][name]["stream"]
    assert_same_tallies(other, got, 0.0)
    assert torch.equal(other["error_records"], got["error_records"])
    one = case_run(name)
    mine = two_ranks[0][name]["run"]
    assert_same_run(mine, one, 1e-12)
    np.testing.assert_array_equal(mine.error_records, one.error_records)
    if name == "grid3d abandons":
        assert int(ref["n_error_records"]) > 2 * TK.ERR_RECORD_K
        assert len(got["error_records"]) == 2 * TK.ERR_RECORD_K


@pytest.mark.parametrize("name", sorted(CASES))
def test_packed_reduction_equals_merge_outputs(name, two_ranks):
    """The mesh's reduction (one float64 and one int64 ``all_reduce`` of the
    packed tallies, the record blocks gathered) equals ``merge_outputs`` of
    the same two sub-ranges run here: counts and records bit-equal."""
    torch.set_num_threads(1)
    tables, static = case_tables(name)
    ref = M.run_split(tables, static, N_STREAM, SEED, 2, width=64)
    got = two_ranks[0][name]["stream"]
    assert_same_tallies(got, ref, 1e-12)
    assert torch.equal(got["error_records"], ref["error_records"])
    assert M.split_gaps(got, ref)["counts"] == 0
    assert two_ranks[0][name]["reduces"] == ["torch.float64", "torch.int64"]


@pytest.mark.parametrize("name", sorted(CASES))
def test_two_gloo_ranks_equal_jax_multi_device(name, two_ranks, monkeypatch):
    import jax
    import jax.numpy as jnp
    from artes_tpu import runner as jax_runner
    from artes_tpu.config import ArtesConfig as JaxConfig
    from artes_tpu.config import detector_setup as jax_detector_setup
    from artes_tpu.parallel import make_mesh, sharded_dispatch

    assert len(jax.devices()) == 8
    atm, cfg, over = case_config(name, JaxConfig)
    orig = jax_runner._kernel_static
    monkeypatch.setattr(jax_runner, "_kernel_static",
                        lambda *a: dataclasses.replace(orig(*a), **over))
    det = jax_detector_setup(cfg, float(atm.rfront[-1]))
    ref = jax_runner.run_wavelength(atm, cfg, det, 0, N_RUN, seed=SEED, batch_size=N_RUN,
                                    dtype=jnp.float64, dispatch=sharded_dispatch(make_mesh()))
    assert_same_run(two_ranks[0][name]["run"], ref, 1e-10)
    assert ref.detector[..., 0, 2].sum() > 0


def test_empty_sub_ranges(tmp_path):
    """Three photons over four ranks: rank 3 runs none."""
    assert M.split_ids(3, SEED, 0, 0, 4)[:, 0].tolist() == [1, 1, 1, 0]
    results = run_mesh(tmp_path, 4, ["flagship", "grid3d abandons"], n=3)
    torch.set_num_threads(1)
    for name in ("flagship", "grid3d abandons"):
        tables, static = case_tables(name)
        ref = TK.run_stream(tables, static, 3, SEED, 64)
        for rank in range(4):
            got = results[rank][name]["stream"]
            assert_same_tallies(got, ref, 1e-12)
            assert torch.equal(got["error_records"], ref["error_records"])
            assert int(got["n_emitted"]) == 3
    # and the plain version's tallies of no photon are zeros
    empty = TK.run_stream(tables, static, 0, SEED, 64)
    assert float(empty["detector"].abs().sum()) == 0.0 and int(empty["n_emitted"]) == 0
    assert len(empty["error_records"]) == 0


def test_split_on_one_device_is_one_run(monkeypatch):
    """Consecutive sub-ranges launched in turn and merged on the host
    (``run_split``) equal one run: the check ``chip_smoke.py`` makes on the
    card with the kernel. A split whose ranks all start at the chunk's first
    id is refused."""
    torch.set_num_threads(1)
    tables, static = case_tables("grid3d abandons")
    n = 96
    one = TK.run_stream(tables, static, n, SEED, 64)
    assert int(one["n_error_records"]) > 2 * TK.ERR_RECORD_K
    for k in (2, 3, 7):
        merged = M.run_split(tables, static, n, SEED, k, width=64)
        assert_same_tallies(merged, one, 1e-12)
        assert torch.equal(merged["error_records"], one["error_records"])
        assert M.split_agrees(merged, one)
    g = M.split_gaps(merged, one)
    assert g["counts"] == 0 and g["records"] == 0 and g["values"] <= M.SPLIT_RTOL
    split_ids = M.split_ids
    monkeypatch.setattr(M, "split_ids", lambda *a: np.concatenate(
        [split_ids(*a)[:, :2], np.full((a[-1], 1), a[3], np.uint32)], axis=1))
    bad = M.run_split(tables, static, n, SEED, 3, width=64)
    assert not M.split_agrees(bad, one)
    assert M.split_gaps(bad, one)["counts"] > 0
