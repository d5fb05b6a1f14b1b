"""Flow diagnostics in the plain PyTorch version against the JAX package.

``flow_global`` (energy x distance projected on the local r, theta and phi
unit vectors) and ``flow_theta`` (the energy of full crossings up, down,
south and north) are booked per cell by the transport march: through the
``flow`` hook of the closed-form ``radial.march`` on a radial grid without a
surface, in the marching loop everywhere else. At float64 on the CPU, with
identical tables and (seed, photon id) streams:

* the closed-form hook against ``artes_tpu.transport.radial.march`` with a
  flow object, at rtol 1e-10;
* ``run_stream`` on a radial grid (tests/test_flow.py:78-99), on the patchy
  3-D grid, and over a Lambert surface (test_torch_flow_surface.py): counts
  bit-equal, moments and fluxes at rtol 1e-10, the flow arrays at rtol 1e-9
  (the two packages sum the photons of a cell in different orders);
* in a thermal run the energy that crosses the top shell's outer face is
  ``flux_exit``, in both packages;
* the gaps the card's kernel-vs-plain gate reads see swapped flow columns,
  flow booked into the neighbouring cell and one projection with its sign
  turned, each relative to the unsigned energy x distance booked;
* both CLIs write the same ``flow_global.fits``, ``flow_latitudinal.fits``,
  ``spectrum.dat`` and ``error.log`` on a radial and a 3-D input with a
  surface and both flow outputs.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artes_tpu import cli as jax_cli
from artes_tpu import presets
from artes_tpu import runner as jax_runner
from artes_tpu.io.fitsio import read_fits
from artes_tpu.transport import kernel as JK
from artes_tpu.transport import radial as JRAD
from artes_tpu_torch import cells, cli, runner
from artes_tpu_torch.transport import kernel as TK
from artes_tpu_torch.transport import pool_cuda
from artes_tpu_torch.transport import radial as TRAD
from test_torch_grid3d import JAX_WIDTH, SEED, assert_matches_jax_3d
from test_torch_pool import _close, _tallies, setup
from torch_threads import one_thread  # noqa: F401

FLOW = dict(flow_global=True, flow_theta=True)


class FlowAcc:
    """The flow object ``artes_tpu.transport.radial.march`` books into."""

    def __init__(self, nr):
        self.g = np.zeros((nr, 3))
        self.t = np.zeros((nr, 4))

    def add_g(self, m, wr, wt, wp):
        self.g[m] += [float(jnp.sum(wr)), float(jnp.sum(wt)), float(jnp.sum(wp))]

    def add_t(self, m, col, w):
        self.t[m, col] += float(jnp.sum(w))


@pytest.mark.parametrize("floor", [0, 2])
def test_radial_flow_hook_matches_jax(floor):
    rs = np.random.default_rng(3)
    nr, n = 5, 400
    rf = np.linspace(0.6, 1.0, nr + 1)
    kx = rs.uniform(0.5, 6.0, nr)
    a2, b2, c2 = 0.81, 0.81, 1.0
    r = rs.uniform(rf[floor] * 1.001, 0.999, n)
    ct = rs.uniform(-1.0, 1.0, n)
    ph = rs.uniform(0.0, 2.0 * np.pi, n)
    st = np.sqrt(1.0 - ct * ct)
    pos = np.stack([r * st * np.cos(ph) / 0.9, r * st * np.sin(ph) / 0.9, r * ct])
    dirn = rs.normal(size=(3, n))
    dirn /= np.linalg.norm(dirn, axis=0)
    tau = rs.exponential(1.5, n)
    active = rs.uniform(size=n) > 0.1
    energy = rs.uniform(0.2, 1.0, n)

    ref_flow = FlowAcc(nr)
    ref = JRAD.march(a2, b2, c2, [jnp.asarray(x) for x in rf], [jnp.asarray(x) for x in kx],
                     jnp.asarray(rf[floor]), 1e-15, *(jnp.asarray(v) for v in pos),
                     *(jnp.asarray(v) for v in dirn), jnp.asarray(tau), jnp.asarray(active),
                     jnp.int32, energy=jnp.asarray(energy), flow=ref_flow)
    flow = tuple(torch.zeros(shape, dtype=torch.float64) for shape in ((nr, 3), (nr, 4), (nr,)))
    got = TRAD.march(a2, b2, c2, torch.as_tensor(rf), torch.as_tensor(kx),
                     torch.as_tensor(rf[floor]), 1e-15, *(torch.as_tensor(v) for v in pos),
                     *(torch.as_tensor(v) for v in dirn), torch.as_tensor(tau),
                     torch.as_tensor(active), energy=torch.as_tensor(energy), flow=flow)
    for key in ("inter", "exited", "surface"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]), err_msg=key)
    scale = np.abs(ref_flow.g).max()
    np.testing.assert_allclose(flow[0].numpy(), ref_flow.g, rtol=1e-10, atol=1e-13 * scale)
    np.testing.assert_allclose(flow[1].numpy(), ref_flow.t, rtol=1e-10, atol=0.0)
    assert (ref_flow.t[:, :2] > 0).any() and not ref_flow.t[:, 2:].any()
    assert not flow[1][:floor].any()                     # nothing moves below the floor
    # the unsigned energy x distance of a shell bounds its three projections
    assert (flow[2][floor:] > 0).all() and not flow[2][:floor].any()
    assert (torch.linalg.norm(flow[0], dim=-1) <= flow[2] * (1 + 1e-12)).all()
    # without the hook the march is what it was
    plain = TRAD.march(a2, b2, c2, torch.as_tensor(rf), torch.as_tensor(kx),
                       torch.as_tensor(rf[floor]), 1e-15, *(torch.as_tensor(v) for v in pos),
                       *(torch.as_tensor(v) for v in dirn), torch.as_tensor(tau),
                       torch.as_tensor(active))
    assert all(torch.equal(plain[k], got[k]) for k in plain)


CASES = {
    "radial tau 3": (lambda: presets.rayleigh_single_layer(tau=3.0, nr=4), FLOW, "closed"),
    "radial thermal": (cells.thermal_scattering_shell, dict(FLOW, photon_source="planet"),
                       "closed"),
    "patchy 3-D": (lambda: presets.patchy_3d(0.5, 6.0), FLOW, "march"),
    "patchy 3-D over a surface": (lambda: presets.patchy_3d(0.5, 6.0),
                                  dict(FLOW, surface_albedo=0.5), "march"),
    "radial over a surface": (lambda: presets.rayleigh_single_layer(tau=1.0, nr=3),
                              dict(FLOW, surface_albedo=0.6), "march"),
    "3-D thermal over a surface": (cells.grid3d_thermal_atm,
                                   dict(FLOW, photon_source="planet", surface_albedo=0.5),
                                   "march"),
}


def flow_arrays(out):
    return {key: np.array(out[key], np.float64) for key in ("flow_global", "flow_theta")}


def assert_flow_close(ref, got):
    """``ref`` and ``got``: the dicts of :func:`flow_arrays`."""
    for key, width in (("flow_global", 3), ("flow_theta", 4)):
        want, have = ref[key], got[key]
        assert have.shape == want.shape and want.shape[1] == width
        assert np.abs(want).max() > 0
        # a sum over photons of signed terms: absolute floor at 1e-12 of the largest entry
        np.testing.assert_allclose(have, want, rtol=1e-9, atol=1e-12 * np.abs(want).max(),
                                   err_msg=key)


# the cases over a Lambert surface run in test_torch_flow_surface.py, so that
# the two files share the time between workers
SURFACE_CASES = sorted(case for case in CASES if "surface_albedo" in CASES[case][1])


@pytest.mark.parametrize("case", sorted(set(CASES) - set(SURFACE_CASES)))
def test_plain_flow_matches_jax_f64(case):
    check_plain_flow(case)


def check_plain_flow(case):
    """The plain version with flow against JAX ``run_stream`` at float64:
    counts bit-equal, moments at rtol 1e-10, the flow arrays at rtol 1e-9,
    with photons where jitted XLA bisects replayed eagerly."""
    make, keys, mode = CASES[case]
    jt, static, tt, st = setup(make(), "float64", **keys)
    assert static.track_flow and TK.walk_mode(tt, st) == mode
    n = 256
    ref, got = assert_matches_jax_3d(jt, static, tt, st, n)
    ref_flow, got_flow = flow_arrays(ref), flow_arrays(got)

    def jax_run(lo, k):
        return JK.run_stream(jt, static, k, SEED, JAX_WIDTH, 0, lo)

    def port_run(lo, k):
        return TK.run_stream(tt, st, k, SEED, k, 0, lo)

    def same(a, b):
        fa, fb = flow_arrays(a), flow_arrays(b)
        return _close(_tallies(a), _tallies(b)) and all(
            np.allclose(fb[k], fa[k], rtol=1e-9, atol=1e-12 * np.abs(fa[k]).max()) for k in fa)

    def diverging(lo, k):
        if same(jax_run(lo, k), port_run(lo, k)):
            return []
        if k == 1:
            return [lo]
        return diverging(lo, k // 2) + diverging(lo + k // 2, k - k // 2)

    # photons where jitted XLA bisects the azimuth Newton step
    # (test_torch_pool.py) walk another path; when that is a photon's last
    # scattering only its flow shows it. Each must equal eager JAX, and its
    # flow is taken out of both sums
    bad = diverging(0, n)
    assert len(bad) <= 2, f"{len(bad)} photons disagree with the jitted JAX kernel: {bad}"
    for pid in bad:
        with jax.disable_jit():
            assert same(JK.run_stream(jt, static, 1, SEED, 128, 0, pid), port_run(pid, 1)), pid
        for total, one in ((ref_flow, jax_run(pid, 1)), (got_flow, port_run(pid, 1))):
            for key, value in flow_arrays(one).items():
                total[key] -= value
    assert_flow_close(ref_flow, got_flow)
    if static.photon_source == 2 and not bad:
        # what crosses the top shell's outer face is what leaves the grid
        ncol = tt.grid.ntheta * tt.grid.nphi
        for out in (ref, got):
            top = np.asarray(out["flow_theta"], np.float64)[-ncol:, 0].sum()
            assert top == pytest.approx(float(out["flux_exit"]), rel=1e-12)
            assert top > 0
    if tt.grid.ntheta == 1:
        assert not got["flow_theta"][:, 2:].any()        # no theta face to cross


def test_flow_gaps_see_columns_and_cells():
    """``pool_cuda.gaps`` on a plain result and mutants of its flow arrays."""
    tables, static = cells.run_tables(presets.patchy_3d(0.5, 6.0), "cpu", **FLOW)
    out = TK.run_stream(tables, static, 1024, 7, 1024)
    limits = pool_cuda.limits_of(tables, static)
    assert limits is pool_cuda.AGREE_MARCH
    g = pool_cuda.gaps(out, out)
    assert g["flow_global"] == g["flow_theta"] == 0.0 and pool_cuda.agrees(g, limits)
    swapped = out["flow_theta"][:, [1, 0, 2, 3]]
    g = pool_cuda.gaps(dict(out, flow_theta=swapped), out)
    assert g["flow_theta"] > 0.1 and g["flow_global"] == 0.0 and not pool_cuda.agrees(g, limits)
    shifted = torch.roll(out["flow_global"], 1, dims=0)          # the neighbouring cell
    g = pool_cuda.gaps(dict(out, flow_global=shifted), out)
    assert g["flow_global"] > limits["flow_global"] and not pool_cuda.agrees(g, limits)
    # the gap is relative to the energy x distance booked, which bounds every
    # cell's projections, so a turned sign of one projection weighs what that
    # projection carries
    path = out["flow_path"]
    assert path.shape == (24,) and (torch.linalg.norm(out["flow_global"], dim=-1) <= path).all()
    for column in range(3):
        signs = torch.ones(3, dtype=torch.float64)
        signs[column] = -1.0
        g = pool_cuda.gaps(dict(out, flow_global=out["flow_global"] * signs), out)
        want = 2.0 * float(out["flow_global"][:, column].abs().sum() / path.sum())
        assert g["flow_global"] == pytest.approx(want, rel=1e-12)
        assert g["flow_global"] > limits["flow_global"] and g["flow_theta"] == 0.0
    g = pool_cuda.gaps(dict(out, flow_global=None), out)
    assert g["flow_global"] == float("inf") and not pool_cuda.agrees(g, limits)
    # a configuration without flow has nothing to compare
    tables, static = cells.spectrum_tables(presets.patchy_3d(0.5, 6.0), "cpu")
    quiet = TK.run_stream(tables, static, 64, 7, 64)
    assert quiet["flow_global"] is None and quiet["flow_path"] is None
    assert pool_cuda.gaps(quiet, quiet)["flow_global"] == 0.0
    assert pool_cuda.limits_of(tables, static) is pool_cuda.AGREE_3D


def test_runner_sums_flow_over_chunks(monkeypatch):
    """``run_wavelength`` reshapes the flow arrays to the grid and sums them
    over chunks; without flow outputs they are ``None``."""
    from artes_tpu_torch.config import ArtesConfig, detector_setup

    atm = presets.patchy_3d(0.5, 6.0)
    cfg = ArtesConfig()
    cfg.mode = "spectrum"
    cfg.flow_global = True
    det = detector_setup(cfg, float(atm.rfront[-1]))
    kw = dict(seed=3, dtype=torch.float64, device="cpu")
    whole = runner.run_wavelength(atm, cfg, det, 0, 600, **kw)
    monkeypatch.setattr(runner, "CHUNK", 256)
    parts = runner.run_wavelength(atm, cfg, det, 0, 600, **kw)
    assert whole.flow_global.shape == (2, 3, 4, 3) and whole.flow_theta.shape == (2, 3, 4, 4)
    np.testing.assert_allclose(parts.flow_global, whole.flow_global, rtol=1e-12, atol=1e-18)
    np.testing.assert_allclose(parts.flow_theta, whole.flow_theta, rtol=1e-12, atol=0.0)
    np.testing.assert_array_equal(parts.detector[..., 2], whole.detector[..., 2])
    cfg.flow_global = False
    quiet = runner.run_wavelength(atm, cfg, det, 0, 64, **kw)
    assert quiet.flow_global is None and quiet.flow_theta is None


CLI_INPUTS = {
    "radial": lambda: presets.rayleigh_single_layer(tau=1.0, nr=3),
    "patchy": lambda: presets.patchy_3d(0.5, 6.0, nr=3),
}


@pytest.mark.parametrize("name", sorted(CLI_INPUTS))
def test_cli_flow_files_match_jax_cli_f64(name, tmp_path, monkeypatch):
    """Surface and both flow outputs through both CLIs, as spectrum and as
    image; the crossing cap is lowered in both so that walks fail and
    ``error.log`` is written. Seed 1: at seed 0 photon 110 of the radial
    input is one where jitted XLA bisects the azimuth Newton step
    (test_torch_pool.py), and one photon of 128 turns a cell's unit vector."""
    root = str(tmp_path)
    cells.write_artifact_input(root, name, CLI_INPUTS[name]())
    for mod in (jax_runner, runner):
        orig = mod._kernel_static
        monkeypatch.setattr(mod, "_kernel_static", lambda *a, _orig=orig: dataclasses.replace(
            _orig(*a), max_crossings=4))
    keys = ["-k", "planet:surface_albedo=0.5", "-k", "output:flow_global=on",
            "-k", "output:flow_latitudinal=on"]
    image = ["-k", "detector:type=imaging_mono", "-k", "detector:pixel=5"]
    for run, extra in (("spec", []), ("image", image)):
        assert jax_cli.main([name, "128", "-o", run + "_ref", "--f64", "--seed", "1",
                             "--root", root, *keys, *extra]) == 0
        assert cli.main([name, "128", "-o", run, "--f64", "--seed", "1", "--device", "cpu",
                         "--root", root, *keys, *extra]) == 0
        ref, got = (tmp_path / "output" / (run + tag) for tag in ("_ref", ""))
        files = sorted(os.listdir(got / "output"))
        assert files == sorted(os.listdir(ref / "output"))
        assert {"flow_global.fits", "flow_latitudinal.fits"} <= set(files)
        for plane in ("flow_global.fits", "flow_latitudinal.fits"):
            want = read_fits(ref / "output" / plane)[0][1]
            have = read_fits(got / "output" / plane)[0][1]
            assert have.shape == want.shape and np.abs(want).max() > 0
            np.testing.assert_allclose(have, want, rtol=1e-9, atol=1e-12 * np.abs(want).max(),
                                       err_msg=plane)
        vec = read_fits(got / "output" / "flow_global.fits")[0][1]
        norms = np.linalg.norm(vec, axis=-1)
        np.testing.assert_allclose(norms[norms > 0], 1.0, rtol=1e-12)
        ref_log = (ref / "error.log").read_text().splitlines()
        got_log = (got / "error.log").read_text().splitlines()
        tallies = [line for line in ref_log if "photon" not in line]
        assert tallies and tallies == [line for line in got_log if "photon" not in line]
        records = [line for line in ref_log if "photon" in line]
        assert records and set(records) <= set(got_log)
    spec = [np.loadtxt(tmp_path / "output" / r / "output" / "spectrum.dat", ndmin=2)
            for r in ("spec_ref", "spec")]
    np.testing.assert_allclose(spec[1], spec[0], rtol=1e-10, atol=0.0)
    img = [read_fits(tmp_path / "output" / r / "output" / "stokes.fits")[0][1]
           for r in ("image_ref", "image")]
    assert img[1].shape == (4, 5, 5) and np.abs(img[0]).max() > 0
    np.testing.assert_allclose(img[1], img[0], rtol=1e-10, atol=1e-300)
