"""The plain walks add their terms as the kernels do: one at a time, left
to right, in the walk's dtype (``radial.left_scan``).

The reference adds each jump term to a running sum
(artes_tpu/transport/jumps.py:196-205) and each shell segment to a running
optical depth (artes_tpu/transport/radial.py:110-124, :205-240), and so do
the closed-form walk and march on both sides (pool_common.cuh::tau_walk,
pool_radial.cu) and the jump walk's jump terms. The jump walk's kbar
baseline adds in the port's own order on both sides
(csrc/pool_grid3d.cu::walk_jumps, ``jumps.tau_walk_jumps``): its one pass
over the radial faces sums the inbound chords from shell 0 up, the outbound
ones likewise, then the two sums (tests/test_torch_jump_roots.py), where the
reference adds inbound shells from the top down, then outbound, in one sum.
The port's walks used ``torch.cumsum``, which is not that sum on either
device: on the CPU it carries float32 in float64 and rounds each prefix
once, and on a card its scan adds in another order. On the grid3d_2496 and
blended_5184 decks (the jump walk) and on hydrostatic39 (the closed-form
walk and march), with numpy-seeded rays:

* float64: the walk's optical depths equal the old form's bit for bit (on
  the CPU its float64 scan runs left to right), and stay within the rtol of
  tests/test_torch_jumps.py against the JAX package's walk;
* float32: they equal the walk with its terms added by an independent numpy
  loop in float32, and move from the old form by roundings only (1e-5);
* a row whose terms are ordered so that any other order or a wider
  accumulator gives other float32 bits shows the scan itself.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artes_tpu import atmosphere as j_atmosphere
from artes_tpu.config import ArtesConfig, detector_setup
from artes_tpu.transport import jumps as JJ
from artes_tpu.transport import kernel as JK
from artes_tpu.transport.tables import build_tables
from artes_tpu_torch import cells
from artes_tpu_torch.transport import jumps as TJ
from artes_tpu_torch.transport import radial as RAD
from test_torch_jumps import RTOL, rays
from torch_threads import one_thread  # noqa: F401

DECKS = {"grid3d_2496": cells.grid3d_2496, "blended_5184": cells.blended_5184}
N = 2048


def old_scan(terms):
    """The walks' running sums before."""
    return torch.cumsum(terms, dim=-1)


def numpy_scan(terms):
    """The terms added one at a time by numpy in their own dtype: every
    running sum."""
    t = terms.numpy()
    out = [t[..., 0].copy()]
    for k in range(1, t.shape[-1]):
        out.append(np.add(out[-1], t[..., k], dtype=t.dtype))
    return torch.from_numpy(np.stack(out, axis=-1))


@pytest.fixture(scope="module", params=sorted(DECKS))
def deck(request):
    """The port's float32 and float64 tables of a deck, its JAX float64
    tables, and rays between its photon floor and its top."""
    atm = DECKS[request.param]()
    tables = {dt: cells.spectrum_tables(atm, "cpu", dt)[0]
              for dt in (torch.float32, torch.float64)}
    cfg = ArtesConfig()
    cfg.mode = "spectrum"
    jax_atm = j_atmosphere.Atmosphere(**{f.name: getattr(atm, f.name)
                                         for f in dataclasses.fields(atm)})
    det = detector_setup(cfg, float(atm.rfront[-1]))
    jt = build_tables(jax_atm, cfg, det, 0, dtype=jnp.float64).tables
    pos, d, cell = rays(tables[torch.float64], N, seed=12)
    return request.param, tables, jt, (pos, d, cell)


def walk(tt, pos, d, cell, dtype):
    g = tt.grid
    return TJ.tau_walk_jumps(g, tt.jump, g.rfront[tt.cell_depth],
                             *torch.as_tensor(pos, dtype=dtype).unbind(-1),
                             *torch.as_tensor(d, dtype=dtype).unbind(-1),
                             *torch.as_tensor(cell).unbind(-1))["tau"]


def test_float64_walk_keeps_its_bits_and_the_reference(deck, monkeypatch):
    name, tables, jt, (pos, d, cell) = deck
    new = walk(tables[torch.float64], pos, d, cell, torch.float64)
    monkeypatch.setattr(RAD, "left_scan", old_scan)
    old = walk(tables[torch.float64], pos, d, cell, torch.float64)
    assert torch.equal(new, old), name
    ref = JJ.tau_walk_jumps(JK._jump_env(jt), *[jnp.asarray(pos[:, i]) for i in range(3)],
                            *[jnp.asarray(d[:, i]) for i in range(3)],
                            *[jnp.asarray(cell[:, i], jnp.int32) for i in range(3)])
    np.testing.assert_allclose(new.numpy(), np.asarray(ref["tau"]), rtol=RTOL, atol=0.0)
    assert (new > 0).float().mean() > 0.5


def test_float32_walk_adds_left_to_right(deck, monkeypatch):
    name, tables, _, (pos, d, cell) = deck
    new = walk(tables[torch.float32], pos, d, cell, torch.float32)
    assert new.dtype == torch.float32
    monkeypatch.setattr(RAD, "left_scan", numpy_scan)
    assert torch.equal(new, walk(tables[torch.float32], pos, d, cell, torch.float32)), name
    monkeypatch.setattr(RAD, "left_scan", old_scan)
    old = walk(tables[torch.float32], pos, d, cell, torch.float32)
    # the old form rounded float64 sums once: the two part by float32
    # roundings of terms that partly cancel
    assert not torch.equal(new, old)
    torch.testing.assert_close(new, old, rtol=1e-5, atol=0.0)


def radial_walks(name, dtype, n=N, seed=12):
    """The closed-form walk's optical depths and the march's stops on a
    radial cell, for numpy-seeded rays and budgets."""
    tt = cells.KERNEL_CELLS[name]("cpu")[0] if dtype == torch.float32 else \
        cells.spectrum_tables(getattr(cells, name)(), "cpu", dtype)[0]
    g = tt.grid
    pos, d, _ = rays(cells.spectrum_tables(getattr(cells, name)(), "cpu", torch.float64)[0],
                     n, seed)
    args = (g.ob_ax ** 2, g.ob_by ** 2, g.ob_cz ** 2, g.rfront, tt.opacity,
            g.rfront[tt.cell_depth], g.pos_eps,
            *torch.as_tensor(pos, dtype=dtype).unbind(-1),
            *torch.as_tensor(d, dtype=dtype).unbind(-1))
    budget = torch.as_tensor(np.random.default_rng(seed).exponential(size=n), dtype=dtype)
    m = RAD.march(*args, budget, torch.ones(n, dtype=torch.bool))
    return torch.stack([RAD.tau_walk(*args)["tau"], m["s_stop"], m["cr"].to(dtype)])


def test_closed_form_walk_and_march_scan_in_order(monkeypatch):
    new64, new32 = (radial_walks("hydrostatic39", dt) for dt in (torch.float64, torch.float32))
    monkeypatch.setattr(RAD, "left_scan", old_scan)
    assert torch.equal(new64, radial_walks("hydrostatic39", torch.float64))
    old32 = radial_walks("hydrostatic39", torch.float32)
    monkeypatch.setattr(RAD, "left_scan", numpy_scan)
    assert torch.equal(new32, radial_walks("hydrostatic39", torch.float32))
    assert not torch.equal(new32, old32)
    assert (new32[2] == old32[2]).float().mean() > 0.99       # interaction shells
    torch.testing.assert_close(new32[:2], old32[:2], rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_left_scan_adds_in_order(dtype):
    rng = np.random.default_rng(3)
    terms = torch.as_tensor(rng.normal(size=(64, 99)) * 10.0 ** rng.integers(-8, 8, (64, 99)),
                            dtype=dtype)
    assert torch.equal(RAD.left_scan(terms), numpy_scan(terms))
    # 1 + 1e8 rounds to 1e8 in float32, so the scan ends at 0; a float64
    # accumulator, the reverse order or a pairwise sum keep the 1
    row = torch.tensor([[1.0, 1.0e8, -1.0e8]], dtype=torch.float32)
    assert RAD.left_scan(row).tolist() == [[1.0, 1.0e8, 0.0]]
    assert old_scan(row)[0, -1].item() == 1.0
    assert RAD.left_scan(row.flip(-1))[0, -1].item() == 1.0
    assert (row[:, :1] + (row[:, 1] + row[:, 2])).item() == 1.0
    one = torch.tensor([[2.5]], dtype=dtype)
    assert RAD.left_scan(one).tolist() == [[2.5]]
