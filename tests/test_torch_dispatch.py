"""``runner.run_wavelength(dispatch=)`` and ``parallel.sharded_dispatch``
against the JAX package, at float64 on the CPU.

* A pass-through dispatch (the port's ``kernel.run_batch``) in chunks of
  ``batch_size`` equals JAX's ``run_wavelength(dispatch=run_batch)``:
  counts bit-equal, moments, fluxes and flow within rtol 1e-10.
* A recording dispatch, with the chunk ids stubbed (no 2^32 photons are
  made), receives the same ``(first id, count, folded seed)`` sequence as
  JAX's on a run of 2^32 + 300 photons whose chunks do not divide 2^32:
  clipped at the boundary, the high id word folded into the seed.
* ``sharded_dispatch`` over two gloo ranks (``test_torch_mesh``'s
  launcher, one pair of processes for the module) equals one process's
  ``run_batch`` (counts and error records equal, sums within 1e-12) and
  JAX's ``sharded_dispatch(make_mesh())`` over its 8 virtual CPU devices
  (rtol 1e-10); a batch the world size does not divide raises
  ``ValueError`` on every rank, as a batch that 8 does not divide does in
  JAX.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from artes_tpu_torch import runner
from artes_tpu_torch.config import detector_setup
from artes_tpu_torch.parallel import mesh as M
from artes_tpu_torch.transport import kernel as TK
from test_torch_mesh import (N_RUN, SEED, assert_same_run, assert_same_tallies, case_config,
                             case_tables, run_ranks)

# the cases of test_torch_mesh run through the dispatches; chunks of 128 ids
DISPATCH_CASES = ("flagship", "flow", "image over a surface")
BATCH = 128

WORKER = r"""
import sys
import torch
torch.set_num_threads(1)
sys.path.insert(0, sys.argv[1])
from test_torch_dispatch import BATCH, DISPATCH_CASES, case_run
from test_torch_mesh import N_RUN, SEED, case_tables
from artes_tpu_torch.parallel import make_mesh, multihost, sharded_dispatch

assert multihost.initialize("gloo", timeout_s=120)
mesh = make_mesh("cpu")
dispatch = sharded_dispatch(mesh)
results = {}
for name in DISPATCH_CASES:
    tables, static = case_tables(name)
    ids = torch.arange(N_RUN, dtype=torch.int64)
    results[name] = {"batch": dispatch(tables, static, ids, SEED),
                     "run": case_run(name, dispatch)}
try:
    dispatch(tables, static, torch.arange(N_RUN - 1), SEED)
    results["indivisible"] = None
except ValueError as err:
    results["indivisible"] = str(err)
torch.save(results, sys.argv[2] + f".rank{mesh.rank}")
torch.distributed.destroy_process_group()
"""


def case_run(name, dispatch):
    """``runner.run_wavelength`` of a ``test_torch_mesh`` case at float64 on
    the CPU through ``dispatch`` in chunks of ``BATCH``."""
    atm, cfg, over = case_config(name)
    orig = runner._kernel_static
    runner._kernel_static = lambda *a: dataclasses.replace(orig(*a), **over)
    try:
        det = detector_setup(cfg, float(atm.rfront[-1]))
        return runner.run_wavelength(atm, cfg, det, 0, N_RUN, seed=SEED, batch_size=BATCH,
                                     dtype=torch.float64, device="cpu", dispatch=dispatch)
    finally:
        runner._kernel_static = orig


def jax_case_run(name, dispatch, monkeypatch):
    """The same run through the JAX package's ``run_wavelength``."""
    import jax.numpy as jnp
    from artes_tpu import runner as jax_runner
    from artes_tpu.config import ArtesConfig as JaxConfig
    from artes_tpu.config import detector_setup as jax_detector_setup

    atm, cfg, over = case_config(name, JaxConfig)
    orig = jax_runner._kernel_static
    monkeypatch.setattr(jax_runner, "_kernel_static",
                        lambda *a: dataclasses.replace(orig(*a), **over))
    det = jax_detector_setup(cfg, float(atm.rfront[-1]))
    return jax_runner.run_wavelength(atm, cfg, det, 0, N_RUN, seed=SEED, batch_size=BATCH,
                                     dtype=jnp.float64, dispatch=dispatch)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dispatch2")
    base = str(tmp / "out")
    run_ranks(tmp, 2, ["-c", WORKER, os.path.dirname(os.path.abspath(__file__)), base])
    return [torch.load(f"{base}.rank{r}", weights_only=False) for r in range(2)]


@pytest.mark.parametrize("name", DISPATCH_CASES)
def test_pass_through_dispatch_matches_jax(name, monkeypatch):
    from artes_tpu.transport import kernel as JK

    calls = []

    def through(tables, static, ids, seed):
        calls.append(len(ids))
        return TK.run_batch(tables, static, ids, seed)

    got = case_run(name, through)
    assert calls == [BATCH, N_RUN - BATCH]
    ref = jax_case_run(name, JK.run_batch, monkeypatch)
    assert_same_run(got, ref, 1e-10)
    assert got.detector[..., 0, 2].sum() > 0
    # the dispatch path is the pool's photons: equal to the default path
    assert_same_run(got, case_run(name, None), 1e-12)


def test_recorded_chunks_equal_jax(monkeypatch):
    """2^32 + 300 photons in chunks of 3 * 2^30: [0, 3 * 2^30), then 2^30
    ids clipped at 2^32, then 300 ids from 0 under the folded seed."""
    import jax.numpy as jnp
    from artes_tpu import runner as jax_runner

    packages, batch, seed = (1 << 32) + 300, 3 << 30, 0xFFFFFFF0
    atm, cfg, over = case_config("flagship")
    npix = 1
    ncell = atm.nr * atm.ntheta * atm.nphi

    def recorder(calls, zeros):
        def record(tables, static, ids, s):
            calls.append((*ids, int(s)))
            return zeros()
        return record

    def port_zeros():
        return {"detector": torch.zeros((npix, 4, 3), dtype=torch.float64),
                "flow_global": None, "flow_theta": None,
                "flux_emitted": torch.zeros(()), "flux_exit": torch.zeros(()),
                "n_error": torch.zeros((), dtype=torch.int64),
                "error_codes": torch.zeros(4, dtype=torch.int64),
                "n_alive_at_cap": torch.zeros((), dtype=torch.int64)}

    def jax_zeros():
        return {"detector": np.zeros((npix, 4, 3)), "flow_global": np.zeros((ncell, 3)),
                "flow_theta": np.zeros((ncell, 4)), "flux_emitted": 0.0, "flux_exit": 0.0,
                "n_error": 0, "error_codes": np.zeros(4, np.int64), "n_alive_at_cap": 0}

    class Ids:
        """``jnp`` with an ``arange`` that records its range instead."""
        def __getattr__(self, key):
            return getattr(jnp, key)

        @staticmethod
        def arange(lo, hi, dtype=None):
            return (int(lo), int(hi) - int(lo))

    monkeypatch.setattr(runner, "chunk_ids", lambda lo, n, device: (lo, n))
    got, ref = [], []
    det = detector_setup(cfg, float(atm.rfront[-1]))
    runner.run_wavelength(atm, cfg, det, 0, packages, seed=seed, batch_size=batch,
                          dtype=torch.float64, device="cpu", dispatch=recorder(got, port_zeros))
    from artes_tpu.config import ArtesConfig as JaxConfig
    from artes_tpu.config import detector_setup as jax_detector_setup
    jatm, jcfg, _ = case_config("flagship", JaxConfig)
    monkeypatch.setattr(jax_runner, "jnp", Ids())
    jax_runner.run_wavelength(jatm, jcfg, jax_detector_setup(jcfg, float(jatm.rfront[-1])), 0,
                              packages, seed=seed, batch_size=batch, dtype=jnp.float64,
                              dispatch=recorder(ref, jax_zeros))
    assert got == ref
    assert got == [(0, batch, seed), (batch, (1 << 32) - batch, seed),
                   (0, 300, (seed + 0x9E3779B9) & 0xFFFFFFFF)]


@pytest.mark.parametrize("name", DISPATCH_CASES)
def test_sharded_dispatch_equals_one_rank_and_jax(name, two_ranks, monkeypatch):
    from artes_tpu.parallel import make_mesh, sharded_dispatch

    tables, static = case_tables(name)
    one = TK.run_batch(tables, static, torch.arange(N_RUN), SEED)
    for rank in range(2):
        got = two_ranks[rank][name]["batch"]
        assert_same_tallies(got, one, 1e-12)
        assert torch.equal(got["error_records"], one["error_records"])
    run = two_ranks[0][name]["run"]
    assert_same_run(run, case_run(name, TK.run_batch), 1e-12)
    np.testing.assert_array_equal(run.error_records, two_ranks[1][name]["run"].error_records)
    ref = jax_case_run(name, sharded_dispatch(make_mesh()), monkeypatch)
    assert_same_run(run, ref, 1e-10)


def test_indivisible_batch_raises(two_ranks):
    import jax.numpy as jnp
    from artes_tpu.parallel import make_mesh, sharded_dispatch

    for rank in range(2):
        assert "not divisible by 2 devices" in two_ranks[rank]["indivisible"]
    tables, static = case_tables("flagship")
    mesh = M.Mesh(group=None, rank=0, size=3, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="not divisible by 3"):
        M.sharded_dispatch(mesh)(tables, static, torch.arange(8), SEED)
    from artes_tpu.config import ArtesConfig as JaxConfig
    from artes_tpu.transport.tables import build_tables
    from artes_tpu.runner import _kernel_static
    from artes_tpu.config import detector_setup as jax_detector_setup
    atm, cfg, _ = case_config("flagship", JaxConfig)
    det = jax_detector_setup(cfg, float(atm.rfront[-1]))
    jt = build_tables(atm, cfg, det, 0, dtype=jnp.float64).tables
    with pytest.raises(ValueError, match="not divisible by 8"):
        sharded_dispatch(make_mesh())(jt, _kernel_static(cfg, det, atm, False),
                                      jnp.arange(12, dtype=jnp.uint32), SEED)
