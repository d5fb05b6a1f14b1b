"""Host table builders of the port against the JAX package's, field by field.

``make_grid_geometry``, ``compute_cell_depth`` and ``build_tables`` run on
the same ``Atmosphere`` in both packages and must agree exactly (the port
builds in numpy float64 and casts once, as the JAX package does);
``convert.tables_from_jax`` carries the JAX tables across unchanged.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artes_tpu import presets
from artes_tpu.config import ArtesConfig, detector_setup
from artes_tpu.runner import _kernel_static
from artes_tpu.transport import geometry as JG
from artes_tpu.transport import tables as JT
from artes_tpu_torch import runner as TRUN
from artes_tpu_torch.cells import flagship, hydrostatic39
from artes_tpu_torch.transport import convert
from artes_tpu_torch.transport import geometry as TG
from artes_tpu_torch.transport import tables as TT
from torch_threads import one_thread  # noqa: F401


ATMOSPHERES = {
    "flagship": flagship,
    "hydrostatic39": hydrostatic39,
    "hg_deck": lambda: presets.hg_cloud_deck(tau=40.0, nr=6),
}


def assert_same(ref, got, where):
    """Every dataclass field equal: tensors vs numpy exactly, scalars equal.
    The port's own ``jump`` tables (none on a radial grid) have no JAX field:
    tests/test_torch_jumps.py holds them against ``kernel._jump_env``."""
    for f in dataclasses.fields(got):
        if f.name == "jump":
            assert (got.jump is None) == (got.grid.ntheta == 1 and got.grid.nphi == 1), where
            continue
        r, g = getattr(ref, f.name), getattr(got, f.name)
        if dataclasses.is_dataclass(g):
            assert_same(r, g, f"{where}.{f.name}")
        elif isinstance(g, torch.Tensor):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=f"{where}.{f.name}")
        else:
            assert g == r, f"{where}.{f.name}: {g} != {r}"


def _cfg(oblateness=0.0):
    cfg = ArtesConfig()
    cfg.mode = "spectrum"
    cfg.oblateness = oblateness
    return cfg


@pytest.mark.parametrize("name", sorted(ATMOSPHERES))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("oblateness", [0.0, 0.06])
def test_build_tables_match(name, dtype, oblateness):
    atm = ATMOSPHERES[name]()
    cfg = _cfg(oblateness)
    det = detector_setup(cfg, float(atm.rfront[-1]))
    ref = JT.build_tables(atm, cfg, det, 0, dtype=getattr(jnp, dtype))
    got = TT.build_tables(atm, cfg, det, 0, dtype=getattr(torch, dtype))
    assert got.tables.opacity.dtype == getattr(torch, dtype)
    assert (got.r_scale, got.cell_depth, got.emissivity_total) == \
        (ref.r_scale, ref.cell_depth, ref.emissivity_total)
    assert_same(ref.tables, got.tables, name)
    grid_ref, scale_ref = JG.make_grid_geometry(atm, oblateness, dtype=getattr(jnp, dtype))
    grid_got, scale_got = TG.make_grid_geometry(atm, oblateness, dtype=getattr(torch, dtype))
    assert scale_got == scale_ref
    assert_same(grid_ref, grid_got, name + ".grid")


@pytest.mark.parametrize("thermal_weight", [True, False])
@pytest.mark.parametrize("oblateness", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_thermal_build_tables_match(thermal_weight, oblateness, dtype):
    """Thermal sources (emissivity CDF, cell weights, cell luminosity) with
    the biased-emission and off-axis-star fields set."""
    atm = presets.thermal_shell(tau_abs=0.8, nr=4)
    cfg = _cfg(oblateness)
    cfg.photon_source = "planet"
    cfg.thermal_weight = thermal_weight
    cfg.photon_bias = 0.6
    cfg.stellar_direction = True
    cfg.theta_star, cfg.phi_star = 1.2, 0.4
    det = detector_setup(cfg, float(atm.rfront[-1]))
    ref = JT.build_tables(atm, cfg, det, 0, dtype=getattr(jnp, dtype))
    got = TT.build_tables(atm, cfg, det, 0, dtype=getattr(torch, dtype))
    assert (got.r_scale, got.cell_depth, got.emissivity_total) == \
        (ref.r_scale, ref.cell_depth, ref.emissivity_total)
    assert got.emissivity_total > 0.0
    np.testing.assert_array_equal(got.cell_luminosity, ref.cell_luminosity)
    assert_same(ref.tables, got.tables, "thermal")
    assert_same(ref.tables, convert.tables_from_jax(ref.tables, dtype=getattr(torch, dtype)),
                "carried")


@pytest.mark.parametrize("name", sorted(ATMOSPHERES))
def test_cell_depth_match(name):
    atm = ATMOSPHERES[name]()
    for source in (1, 2):
        for ring in (False, True):
            assert TT.compute_cell_depth(atm, 0, source, ring) == \
                JT.compute_cell_depth(atm, 0, source, ring)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_tables_from_jax_round_trip(dtype):
    atm = hydrostatic39()
    cfg = _cfg(0.03)
    det = detector_setup(cfg, float(atm.rfront[-1]))
    ref = JT.build_tables(atm, cfg, det, 0, dtype=getattr(jnp, dtype))
    carried = convert.tables_from_jax(ref.tables, dtype=getattr(torch, dtype))
    assert_same(ref.tables, carried, "carried")
    assert_same(TT.build_tables(atm, cfg, det, 0, dtype=getattr(torch, dtype)).tables,
                carried, "built")
    static = _kernel_static(cfg, det, atm, False)
    assert dataclasses.asdict(convert.static_from_jax(static)) == dataclasses.asdict(static)
    assert TRUN._kernel_static(cfg, det, atm, False) == convert.static_from_jax(static)


def test_thermal_tables_not_ported():
    """Thermal and 3-D tables are ported (test_build_tables_match,
    test_torch_grid3d.py), and so are Lambert surfaces and flow: every
    configuration names the walks it takes (``kernel.walk_mode``, the JAX
    package's ``use_closed_form`` and ``_use_jumps``) and runs."""
    from artes_tpu.transport import kernel as JK
    from artes_tpu.transport import radial as JRAD
    from artes_tpu_torch.transport import kernel as TK

    for atm, keys, mode in ((presets.patchy_3d(), {}, "jumps"),
                            (flagship(), {"surface_albedo": 0.5}, "march"),
                            (presets.patchy_3d(), {"surface_albedo": 0.5}, "march"),
                            (flagship(), {"flow_global": True}, "closed"),
                            (presets.patchy_3d(), {"flow_theta": True}, "march"),
                            (flagship(), {"debug_stokes": True}, "closed")):
        cfg = _cfg()
        for k, v in keys.items():
            setattr(cfg, k, v)
        det = detector_setup(cfg, float(atm.rfront[-1]))
        tables = TT.build_tables(atm, cfg, det, 0).tables
        static = TRUN._kernel_static(cfg, det, atm, False)
        assert TK.walk_mode(tables, static) == mode
        assert (tables.jump is not None) == (mode == "jumps")     # built for the jump walks only
        jax_static = _kernel_static(cfg, det, atm, False)
        assert (mode == "closed") == JRAD.use_closed_form(tables.grid, jax_static)
        assert (mode == "jumps") == JK._use_jumps(tables.grid, jax_static)
        out = TK.run_stream(tables, static, 32, 3, 32)
        assert int(out["n_emitted"]) == 32 and bool(out["detector"].isfinite().all())
        assert (out["flow_global"] is not None) == static.track_flow


def test_flat_cell_and_closed_form_match():
    from artes_tpu.transport import kernel as JK
    from artes_tpu.transport import radial as JRAD
    from artes_tpu_torch.transport import kernel as TK
    from artes_tpu_torch.transport import radial as TRAD

    rs = np.random.default_rng(5)
    for atm in (presets.patchy_3d(), hydrostatic39()):
        jgrid, _ = JG.make_grid_geometry(atm, 0.0, dtype=jnp.float64)
        tgrid, _ = TG.make_grid_geometry(atm, 0.0)
        cells = np.stack([rs.integers(0, n, 200) for n in (atm.nr, atm.ntheta, atm.nphi)], -1)
        np.testing.assert_array_equal(TK.flat_cell(tgrid, torch.as_tensor(cells)).numpy(),
                                      np.asarray(JK.flat_cell(jgrid, jnp.asarray(cells))))
        for surface in (0.0, 0.4):
            cfg = _cfg()
            cfg.surface_albedo = surface
            det = detector_setup(cfg, float(atm.rfront[-1]))
            static = _kernel_static(cfg, det, atm, False)
            assert TRAD.use_closed_form(tgrid, convert.static_from_jax(static)) == \
                JRAD.use_closed_form(jgrid, static)
