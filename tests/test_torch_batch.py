"""The batch transport (``kernel.start_batch``, ``scatter_rounds``,
``run_batch``) and ``sampling.alpha_tables`` against the JAX package.

At float64 on the CPU, with identical tables (``convert.tables_from_jax``)
and the same (seed, photon id) streams, on every walk the pool covers: the
flagship (closed form), a 5 x 5 image, the scattering thermal shell, the
patchy 2 x 3 x 4 grid (jump walks), a Lambert surface (marching walks),
a graded five-shell grid with both flow outputs, scattering off and
``--debug-stokes``:

* ``run_batch`` on ids drawn by ``numpy.random.default_rng`` (one of them
  above 2^31) equals JAX's XLA ``run_batch``: counts bit-equal, moments,
  fluxes and flow within rtol 1e-10, ``n_error``, ``error_codes`` and
  ``n_alive_at_cap`` equal;
* on contiguous ids it equals the port's own ``run_stream`` over the same
  photons at rtol 1e-12 (its ``n_alive_at_cap`` too, but without
  scattering, where the batch reports the photons whose first march
  interacted, as JAX's does, and the pool none);
* ``start_batch`` followed by ``scatter_rounds`` in two calls of k and
  ``max_scatter - k`` rounds equals one ``run_batch`` bit for bit.

JAX's batch has no Stokes check, so its ``--debug-stokes`` case is a
physical atmosphere where the check finds nothing at float64; the
anomalous matrix of ``cells.anomalous_rayleigh`` is held against the
port's pool, anomalies and error records included.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artes_tpu.config import ArtesConfig, detector_setup
from artes_tpu.runner import _kernel_static
from artes_tpu.transport import kernel as JK
from artes_tpu.transport import sampling as JS
from artes_tpu.transport.tables import build_tables
from artes_tpu_torch import cells, presets
from artes_tpu_torch.transport import convert
from artes_tpu_torch.transport import kernel as TK
from artes_tpu_torch.transport import sampling as TS

SEED = 11
N_BATCH = 192
FLOW = dict(flow_global=True, flow_theta=True)


def hydrostatic5():
    """The graded grid of ``cells.hydrostatic39`` in five shells: the JAX
    closed form unrolls its walks over the shells, and 39 cost minutes to
    compile."""
    atm = presets.rayleigh_single_layer(tau=4.0, nr=5, shell_km=97.5)
    prof = np.exp(np.linspace(2.0, -2.0, 5))[:, None, None, None]
    atm.k_sca = atm.k_sca * prof
    atm.k_abs = atm.k_abs * prof
    atm.refresh_derived()
    return atm


# name: (atmosphere, ArtesConfig keys)
CASES = {
    "flagship": (cells.flagship, {}),
    "image 5x5": (cells.flagship, dict(mode="imaging_mono", npix=5)),
    "thermal shell": (cells.thermal_scattering_shell, dict(photon_source="planet")),
    "patchy 3-D jumps": (cells.patchy3d_small, {}),
    "lambert march": (cells.lambert_layer, dict(surface_albedo=0.8)),
    "hydrostatic flow": (hydrostatic5, FLOW),
    # a thermal source: without scattering only the birth peels are seen
    "scattering off": (cells.thermal_scattering_shell,
                       dict(photon_source="planet", photon_scattering=False)),
    "debug stokes": (cells.flagship, dict(debug_stokes=True)),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def setup(atm, keys):
    """JAX tables and static config of ``atm`` under ``keys`` at float64,
    and their carried-over port twins."""
    cfg = ArtesConfig()
    cfg.mode = "spectrum"
    for k, v in keys.items():
        setattr(cfg, k, v)
    det = detector_setup(cfg, float(atm.rfront[-1]))
    static = _kernel_static(cfg, det, atm, False)
    jt = build_tables(atm, cfg, det, 0, dtype=jnp.float64).tables
    return jt, static, convert.tables_from_jax(jt), convert.static_from_jax(static)


def case(name):
    make, keys = CASES[name]
    return setup(make(), keys)


def batch_ids(seed=SEED, n=N_BATCH):
    """``n`` distinct uint32 ids from ``default_rng(seed)``, the last above
    2^31."""
    rs = np.random.default_rng(seed)
    ids = rs.choice(1 << 24, size=n - 1, replace=False).astype(np.uint32)
    return np.concatenate([ids, [(1 << 31) + int(rs.integers(1 << 30))]]).astype(np.uint32)


def assert_same(got, ref, rtol, flow=True):
    """Counts and error tallies equal, moments, fluxes and flow within rtol."""
    g_det, r_det = np.asarray(got["detector"]), np.asarray(ref["detector"])
    assert g_det.shape == r_det.shape
    np.testing.assert_array_equal(g_det[..., 2], r_det[..., 2])
    np.testing.assert_allclose(g_det[..., :2], r_det[..., :2], rtol=rtol, atol=0.0)
    assert int(got["n_error"]) == int(ref["n_error"])
    np.testing.assert_array_equal(np.asarray(got["error_codes"]), np.asarray(ref["error_codes"]))
    for key in ("flux_emitted", "flux_exit"):
        np.testing.assert_allclose(float(got[key]), float(ref[key]), rtol=rtol, atol=0.0)
    if flow:
        for key in ("flow_global", "flow_theta"):
            r = np.asarray(ref[key])
            np.testing.assert_allclose(np.asarray(got[key]), r, rtol=rtol,
                                       atol=rtol * float(np.abs(r).max()))


def _agree(got, ref, flow):
    try:
        assert_same(got, ref, 1e-10, flow)
    except AssertionError:
        return False
    return True


def _diverging(jax_run, port_run, ids, flow):
    """The ids whose JAX and port tallies disagree, by bisection."""
    if _agree(port_run(ids), jax_run(ids), flow):
        return []
    if len(ids) == 1:
        return [int(ids[0])]
    h = len(ids) // 2
    return (_diverging(jax_run, port_run, ids[:h], flow)
            + _diverging(jax_run, port_run, ids[h:], flow))


def _without(out, parts):
    """``out`` with the tallies of ``parts`` taken away (numpy)."""
    res = {k: np.asarray(out[k], dtype=np.float64) for k in
           ("detector", "flux_emitted", "flux_exit", "flow_global", "flow_theta", "n_error",
            "error_codes") if out.get(k) is not None}
    for p in parts:
        for k in res:
            res[k] = res[k] - np.asarray(p[k], dtype=np.float64)
    return res


@pytest.mark.parametrize("name", sorted(CASES))
def test_run_batch_matches_jax_run_batch(name):
    """At most two photons may part from the jitted JAX batch: its azimuth
    Newton evaluates one residual twice with different contractions
    (``test_torch_pool``'s module docstring). Each is found by bisection and
    must equal the JAX batch run eagerly; the other photons' totals must
    agree."""
    jt, static, tt, st = case(name)
    ids = batch_ids()

    def jax_run(sub):
        return JK.run_batch(jt, static, jnp.asarray(sub), SEED)

    def port_run(sub):
        return TK.run_batch(tt, st, torch.from_numpy(sub.astype(np.int64)), SEED)

    ref, got = jax_run(ids), port_run(ids)
    bad = _diverging(jax_run, port_run, ids, static.track_flow)
    assert len(bad) <= 2, f"{len(bad)} photons disagree with the jitted JAX batch: {bad}"
    for pid in bad:
        one = np.array([pid], np.uint32)
        with jax.disable_jit():
            eager = jax_run(one)
        assert_same(port_run(one), eager, 1e-10, static.track_flow)
    singles = [np.array([pid], np.uint32) for pid in bad]
    assert_same(_without(got, [port_run(o) for o in singles]),
                _without(ref, [jax_run(o) for o in singles]), 1e-10, flow=static.track_flow)
    assert int(got["n_alive_at_cap"]) == int(ref["n_alive_at_cap"])
    assert got["n_emitted"] == N_BATCH
    assert np.asarray(got["detector"])[:, 0, 2].sum() > 0
    if name == "debug stokes":
        assert int(got["n_stokes_anomaly"]) == 0
    if name == "scattering off":
        assert float(got["detector"][:, 1:, 2].sum()) == 0.0
        assert int(got["n_alive_at_cap"]) > 0


@pytest.mark.parametrize("name", sorted(CASES))
def test_run_batch_equals_run_stream(name):
    _, static, tt, st = case(name)
    lo = (1 << 31) - 100                    # the batch crosses 2^31
    got = TK.run_batch(tt, st, torch.arange(lo, lo + N_BATCH), SEED)
    ref = TK.run_stream(tt, st, N_BATCH, SEED, 64, 0, lo)
    assert_same(got, ref, 1e-12, flow=static.track_flow)
    for key in ("n_stokes_anomaly", "n_error_records", "n_emitted"):
        assert int(got[key]) == int(ref[key]), key
    assert torch.equal(got["error_records"], ref["error_records"])
    if static.photon_scattering:
        assert int(got["n_alive_at_cap"]) == int(ref["n_alive_at_cap"])


@pytest.mark.parametrize("what", ["stokes anomalies", "abandoned photons"])
def test_error_tallies_and_records_equal_run_stream(what):
    """``--debug-stokes`` on a matrix that drives Q above I, and a crossing
    cap that abandons a third of the photons (more records than a run
    keeps): anomalies, error codes and records as the pool's, ids past 2^31
    given as uint32."""
    if what == "stokes anomalies":
        tables, static = cells.run_tables(cells.anomalous_rayleigh(), "cpu", torch.float64,
                                          debug_stokes=True)
    else:
        tables, static = cells.run_tables(presets.rayleigh_single_layer(
            tau=6.0, nr=8, theta_deg=(0.0, 90.0, 180.0)), "cpu", torch.float64)
        static = dataclasses.replace(static, max_crossings=2)
    lo = (1 << 31) - 50
    got = TK.run_batch(tables, static, np.arange(lo, lo + N_BATCH, dtype=np.uint32), SEED)
    ref = TK.run_stream(tables, static, N_BATCH, SEED, 48, 0, lo)
    assert int(ref["n_stokes_anomaly" if static.debug_stokes else "error_codes"].sum()) > 0
    assert int(ref["n_error_records"]) > 2 * TK.ERR_RECORD_K
    assert_same(got, ref, 1e-12, flow=False)
    for key in ("n_stokes_anomaly", "n_error_records", "n_alive_at_cap"):
        assert int(got[key]) == int(ref[key]), key
    assert torch.equal(got["error_records"], ref["error_records"])


@pytest.mark.parametrize("name", ["flagship", "lambert march", "hydrostatic flow",
                                  "patchy 3-D jumps"])
def test_resumed_rounds_equal_one_run_batch(name):
    _, _, tt, st = case(name)
    st = dataclasses.replace(st, max_scatter=12)
    ids = torch.from_numpy(batch_ids().astype(np.int64))
    one = TK.run_batch(tt, st, ids, SEED)
    state, out = TK.start_batch(tt, st, ids, SEED)
    assert set(state) == {"pos", "dirn", "cell", "face", "stokes", "alive", "counter",
                          "photon_ids", "n_scat"}
    k = 5
    state, out = TK.scatter_rounds(tt, st, state, SEED, k, out)
    alive_k = int(out["n_alive_at_cap"])
    state, out = TK.scatter_rounds(tt, st, state, SEED, st.max_scatter - k, out)
    assert alive_k >= int(out["n_alive_at_cap"]) == int(one["n_alive_at_cap"])
    assert int(state["n_scat"].max()) <= st.max_scatter
    for key, val in one.items():
        if key == "n_emitted" or val is None:
            continue
        assert torch.equal(torch.as_tensor(out[key]), torch.as_tensor(val)), key


def test_start_batch_state_matches_jax():
    """The resumable state after the first march: the same photons alive,
    at the same positions, with the same draw-site counters."""
    jt, static, tt, st = case("patchy 3-D jumps")
    ids = batch_ids()
    ref_state, _ = JK.start_batch(jt, static, jnp.asarray(ids), SEED)
    state, _ = TK.start_batch(tt, st, torch.from_numpy(ids.astype(np.int64)), SEED)
    alive = np.asarray(ref_state["alive"])
    np.testing.assert_array_equal(state["alive"].numpy(), alive)
    np.testing.assert_array_equal(state["counter"].numpy()[alive],
                                  np.asarray(ref_state["counter"])[alive])
    for key in ("pos", "dirn", "stokes"):
        np.testing.assert_allclose(state[key].numpy()[alive], np.asarray(ref_state[key])[alive],
                                   rtol=1e-12, atol=1e-15)
    np.testing.assert_array_equal(state["photon_ids"].numpy(), ids.astype(np.int64))


def test_alpha_tables_equal_jax():
    _, _, tt, _ = case("patchy 3-D jumps")
    prefix = tt.alpha_prefix
    coarse, fine = TS.alpha_tables(prefix)
    ref_c, ref_f = JS.alpha_tables(jnp.asarray(prefix.numpy()))
    assert coarse.shape == (prefix.shape[0], 4, TS.N_COARSE + 1)
    assert fine.shape == (prefix.shape[0], TS.N_COARSE, 4, TS.N_FINE + 1)
    np.testing.assert_array_equal(coarse.numpy(), np.asarray(ref_c))
    np.testing.assert_array_equal(fine.numpy(), np.asarray(ref_f))
    # the last edge of a fine block is the first of the next one
    assert torch.equal(fine[:, :-1, :, -1], fine[:, 1:, :, 0])
