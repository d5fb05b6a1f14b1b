"""The plain PyTorch pool kernel against the JAX package's ``run_stream``.

Both packages get identical tables (``convert.tables_from_jax``) and the
same (seed, photon id) streams, on the flagship config and the graded nr=39
grid that bench.py builds.

* float64, 4096 photons: splat counts bit-equal, moments at rtol 1e-10,
  error tallies and capped counts equal (:func:`assert_matches_jax`, which
  the thermal and imaging tests share). The jitted JAX kernel evaluates
  the azimuth Newton residual of ``sampling.sample_beta`` twice with
  different FMA contractions in one fusion, so for rare photons with
  unpolarized light its bracket test sees a residual of the other sign and
  falls back to bisection (e.g. flagship seed 7, photon 1105: beta 0.9565
  instead of u1*pi = 0.9810). Photons whose totals disagree are found by
  bisecting the id range and must then equal the same JAX function run
  without jit at the same tolerance.
* float32: different compilers, so the check is statistical (limits about
  3x the measured disagreement).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artes_tpu import presets
from artes_tpu.config import ArtesConfig, detector_setup
from artes_tpu.runner import _kernel_static
from artes_tpu.transport import kernel as JK
from artes_tpu.transport.tables import build_tables
from artes_tpu_torch import cells
from artes_tpu_torch.cells import CELLS as CONFIGS
from artes_tpu_torch.cells import spectrum_tables
from artes_tpu_torch.transport import convert, pool_cuda
from artes_tpu_torch.transport import kernel as TK
from torch_threads import one_thread  # noqa: F401

SEED = 7
JAX_WIDTH = 1024


def setup(name, dtype, crescent=False, **cfg_keys):
    """JAX tables and static config of a CONFIGS name or an atmosphere, and
    their carried-over port twins."""
    atm = CONFIGS[name]() if isinstance(name, str) else name
    cfg = ArtesConfig()
    cfg.mode = "spectrum"
    for k, v in cfg_keys.items():
        setattr(cfg, k, v)
    det = detector_setup(cfg, float(atm.rfront[-1]))
    static = _kernel_static(cfg, det, atm, crescent)
    jt = build_tables(atm, cfg, det, 0, dtype=getattr(jnp, dtype)).tables
    tt = convert.tables_from_jax(jt, dtype=getattr(torch, dtype))
    return jt, static, tt, convert.static_from_jax(static)


def _tallies(out):
    """(detector, [flux_emitted, flux_exit]) of a run_stream result, numpy."""
    return (np.asarray(out["detector"]),
            np.array([float(out["flux_emitted"]), float(out["flux_exit"])]))


def _close(a, b):
    return (np.array_equal(a[0][..., 2], b[0][..., 2])
            and np.allclose(a[0][..., :2], b[0][..., :2], rtol=1e-10, atol=0.0)
            and np.allclose(a[1], b[1], rtol=1e-10, atol=0.0))


def _diverging(jax_run, port_run, lo, n):
    """Photon ids in [lo, lo+n) whose JAX and port tallies disagree."""
    if _close(jax_run(lo, n), port_run(lo, n)):
        return []
    if n == 1:
        return [lo]
    h = n // 2
    return _diverging(jax_run, port_run, lo, h) + _diverging(jax_run, port_run, lo + h, n - h)


def assert_matches_jax(jt, static, tt, st, n, seed=SEED):
    """The plain version against JAX ``run_stream`` at float64 on photons 0
    .. n-1: every per-pixel, per-count-column count equal, moments and
    fluxes at rtol 1e-10, error and capped tallies equal. At most two
    photons may disagree with the jitted JAX kernel (its azimuth Newton
    residual, see the module docstring); each must equal eager JAX."""
    ref = JK.run_stream(jt, static, n, seed, JAX_WIDTH)
    got = TK.run_stream(tt, st, n, seed, n)
    assert int(got["n_error"]) == int(ref["n_error"]) == 0
    np.testing.assert_array_equal(got["error_codes"].numpy(), np.asarray(ref["error_codes"]))
    assert int(got["n_alive_at_cap"]) == int(ref["n_alive_at_cap"])
    assert got["n_emitted"] == int(ref["n_emitted"]) == n
    assert got["detector"].shape == (static.nx * static.ny, 4, 3)

    def jax_run(lo, k):
        return _tallies(JK.run_stream(jt, static, k, seed, JAX_WIDTH, 0, lo))

    def port_run(lo, k):
        return _tallies(TK.run_stream(tt, st, k, seed, k, 0, lo))

    bad = _diverging(jax_run, port_run, 0, n)
    assert len(bad) <= 2, f"{len(bad)} photons disagree with the jitted JAX kernel: {bad}"
    for pid in bad:
        with jax.disable_jit():
            eager = _tallies(JK.run_stream(jt, static, 1, seed, 128, 0, pid))
        assert _close(eager, port_run(pid, 1)), f"photon {pid} disagrees with eager JAX"
    # every other photon: the totals without the replayed ones
    ref_t, got_t = _tallies(ref), _tallies(got)
    for pid in bad:
        ref_t = tuple(r - x for r, x in zip(ref_t, jax_run(pid, 1)))
        got_t = tuple(g - x for g, x in zip(got_t, port_run(pid, 1)))
    np.testing.assert_array_equal(got_t[0][..., 2], ref_t[0][..., 2])
    np.testing.assert_allclose(got_t[0][..., :2], ref_t[0][..., :2], rtol=1e-10, atol=0.0)
    np.testing.assert_allclose(got_t[1], ref_t[1], rtol=1e-10, atol=0.0)
    return got


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plain_pool_matches_jax_f64(name):
    jt, static, tt, st = setup(name, "float64")
    assert_matches_jax(jt, static, tt, st, 4096)


# measured on the CPU at 2^14 photons, seed 7: flagship |dN|/N 9.0e-5,
# I rel 1.25e-4; hydrostatic39 |dN|/N 3.6e-4, I rel 5.4e-4
F32_LIMITS = {"flagship": (3e-4, 4e-4), "hydrostatic39": (1e-3, 1.6e-3)}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plain_pool_matches_jax_f32(name):
    jt, static, tt, st = setup(name, "float32")
    n = 1 << 14
    ref = np.asarray(JK.run_stream(jt, static, n, SEED, 4096)["detector"], np.float64)
    got = TK.run_stream(tt, st, n, SEED, n)
    det = got["detector"].numpy()
    d_n = abs(det[0, 0, 2] - ref[0, 0, 2]) / ref[0, 0, 2]
    rel_i = abs(det[0, 0, 0] - ref[0, 0, 0]) / abs(ref[0, 0, 0])
    lim_n, lim_i = F32_LIMITS[name]
    assert d_n <= lim_n and rel_i <= lim_i, (d_n, rel_i)
    assert int(got["n_error"]) == 0 and np.isfinite(det).all()


def _surface_and_flow():
    atm = presets.rayleigh_single_layer(tau=1.0)
    return {
        "surface": (atm, dict(surface_albedo=0.5), "pool_march", "march_stellar"),
        "flow": (atm, dict(flow_global=True), "pool_radial", "stellar_flow"),
        "3-D flow": (presets.patchy_3d(), dict(flow_theta=True, photon_source="planet"),
                     "pool_march", "march_thermal_flow"),
    }


def test_supports():
    ported = {"thermal": (presets.thermal_shell(), dict(photon_source="planet")),
              "multi-pixel": (presets.rayleigh_single_layer(tau=1.0),
                              dict(mode="imaging_mono", npix=5)),
              "off-axis star": (presets.rayleigh_single_layer(tau=1.0),
                                dict(stellar_direction=True, theta_star=1.2)),
              "3-D": (presets.patchy_3d(), {})}
    ported.update({k: v[:2] for k, v in _surface_and_flow().items()})
    for what, (atm, keys) in list(ported.items()) + [(n, (CONFIGS[n](), {})) for n in CONFIGS]:
        _, _, tt, st = setup(atm, "float32", **keys)
        assert pool_cuda.supports(tt, st), what
        _, _, tt64, st64 = setup(atm, "float64", **keys)
        assert not pool_cuda.supports(tt64, st64), what      # the kernel runs float32
    for what, (atm, keys, source, name) in _surface_and_flow().items():
        _, _, tt, st = setup(atm, "float32", **keys)
        assert pool_cuda.kernel_of(tt, st) == (source, name), what
        assert name in pool_cuda.LAUNCHES
        out = TK.run_stream(tt, st, 16, SEED, 16)               # the plain version runs it
        assert out["n_emitted"] == 16 and bool(out["detector"].isfinite().all())
        with pytest.raises(ValueError, match="CUDA device"):     # and the kernel needs a card
            pool_cuda.run_stream_cuda(tt, st, 16, SEED)
    # the Stokes-anomaly check and scattering off are runtime flags of every kernel
    for keys in (dict(debug_stokes=True), dict(photon_scattering=False)):
        _, _, tt, st = setup(presets.rayleigh_single_layer(tau=1.0), "float32", **keys)
        assert pool_cuda.supports(tt, st), keys
        assert pool_cuda.flags_of(st) in (pool_cuda.F_DEBUG_STOKES, pool_cuda.F_NO_SCATTER)
        with pytest.raises(ValueError, match="CUDA device"):
            pool_cuda.run_stream_cuda(tt, st, 16, SEED)


def test_agreement_check_holds_every_tally():
    """``pool_cuda.gaps`` / ``agrees``, the kernel-vs-plain gate of
    chip_smoke.py and test_torch_gpu.py, on a plain result and mutants."""
    tables, static = spectrum_tables(CONFIGS["flagship"](), "cpu")
    out = TK.run_stream(tables, static, 4096, SEED, 4096)
    det = out["detector"]

    def with_det(d, **keys):
        return dict(out, detector=d, **keys)

    assert pool_cuda.agrees(pool_cuda.gaps(out, out))
    u_flip = det.clone()
    u_flip[0, 2, 0] *= -1.0                     # Q' = cQ + sU keeps I and Q
    g = pool_cuda.gaps(with_det(u_flip), out)
    assert g["count"] == g["capped"] == g["stokes"][0] == g["stokes"][1] == 0.0
    assert g["stokes"][2] == pytest.approx(2.0 * abs(float(det[0, 2, 0] / det[0, 0, 0])))
    sums_for_squares = det.clone()
    sums_for_squares[0, :, 1] = det[0, :, 0]
    assert not pool_cuda.agrees(pool_cuda.gaps(with_det(sums_for_squares), out))
    for where in ((0, 3, 0), (0, 1, 1), (0, 0, 2)):
        bad = det.clone()
        bad[where] = float("nan")
        assert not pool_cuda.agrees(pool_cuda.gaps(with_det(bad), out)), where
    capped = with_det(det, n_alive_at_cap=out["n_alive_at_cap"] + 1)
    assert pool_cuda.gaps(capped, out)["capped"] == 1 / 4096
    assert not pool_cuda.agrees(pool_cuda.gaps(capped, out))


def test_agreement_check_sees_pixels_and_columns():
    """The gaps an image and a thermal run add: a transposed image, a birth
    peel counted in every Stokes row, and the fluxes."""
    n = 2048
    out = TK.run_stream(*cells.imaging_tables(5, "cpu"), n, SEED, n)
    det = out["detector"]
    transposed = det.reshape(5, 5, 4, 3).transpose(0, 1).reshape(25, 4, 3)
    g = pool_cuda.gaps(dict(out, detector=transposed), out)
    assert g["count"] == g["stokes"][0] == 0.0          # the sums cannot see it
    assert g["pixel_I"] > 0.1 and g["pixel_N"] > 0.1
    assert not pool_cuda.agrees(g)

    tables, static = cells.run_tables(cells.thermal_scattering_shell(), "cpu",
                                      photon_source="planet")
    th = TK.run_stream(tables, static, n, SEED, n)
    all_rows = th["detector"].clone()
    all_rows[:, 1:, 2] = all_rows[:, :1, 2]               # births in every row
    g = pool_cuda.gaps(dict(th, detector=all_rows), th)
    assert g["count"] == 0.0 and g["count_quv"] > 0.1 and not pool_cuda.agrees(g)
    assert pool_cuda.agrees(pool_cuda.gaps(th, th))
    g = pool_cuda.gaps(dict(th, flux_exit=th["flux_exit"] * 1.01), th)
    assert g["flux_exit"] == pytest.approx(0.01) and not pool_cuda.agrees(g)

    # a pure absorber has no Q, U, V peels: any there is an infinite gap
    absorber = TK.run_stream(*cells.run_tables(cells.thermal_bench(), "cpu",
                                               photon_source="planet"), 256, SEED, 256)
    all_rows = absorber["detector"].clone()
    all_rows[:, 1:, 2] = all_rows[:, :1, 2]
    g = pool_cuda.gaps(dict(absorber, detector=all_rows), absorber)
    assert g["count_quv"] == float("inf") and not pool_cuda.agrees(g)


def test_agreement_check_sees_circular_polarization():
    """Stokes V, which only a scattering matrix with F34 makes (the Mie
    deck): a V with its sign turned in every pixel keeps the sums of
    squares, and moves the V total by a share of Stokes I that "stokes" may
    not see where V nearly cancels over the image; "pixel_V", scaled by V
    itself, reads 2. V where the plain version has none is an infinite
    gap."""
    tables, static = cells.KERNEL_CELLS["mie_patchy_imaging25"]("cpu")
    out = TK.run_stream(tables, static, 2048, SEED, 2048)
    det = out["detector"]
    assert float(det[:, 3, 0].abs().sum()) > 0.0 and float(det[:, 3, 1].sum()) > 0.0
    turned = det.clone()
    turned[:, 3, 0] *= -1.0
    g = pool_cuda.gaps(dict(out, detector=turned), out)
    assert g["pixel_V"] == pytest.approx(2.0) and g["squares"][3] == 0.0
    assert not pool_cuda.agrees(g, pool_cuda.AGREE_3D)
    assert pool_cuda.agrees(pool_cuda.gaps(out, out), pool_cuda.AGREE_3D)

    tables, static = spectrum_tables(CONFIGS["flagship"](), "cpu")
    flat = TK.run_stream(tables, static, 1024, SEED, 1024)
    assert float(flat["detector"][:, 3, :2].abs().sum()) == 0.0      # no F34, no V
    some_v = flat["detector"].clone()
    some_v[:, 3, 0] = 1e-9
    g = pool_cuda.gaps(dict(flat, detector=some_v), flat)
    assert g["pixel_V"] == float("inf") and not pool_cuda.agrees(g)


def test_cuda_wrapper_refuses_cpu_tensors():
    _, _, tt, st = setup("flagship", "float32")
    before = dict(pool_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA device"):
        pool_cuda.run_stream_cuda(tt, st, 1024, SEED)
    assert pool_cuda.LAUNCHES == before == dict.fromkeys(
        pool_cuda.VARIANTS + pool_cuda.VARIANTS_FLOW + pool_cuda.VARIANTS_3D
        + pool_cuda.VARIANTS_MARCH, 0)
