"""The jump walk's radial faces in one pass: each face's sphere solved once.

The 3-D kernel's jump walk (csrc/pool_grid3d.cu::walk_jumps) solves the floor
sphere and the outer face, then walks the radial faces up once: face j gives
the inbound chord of shell j-1 (cut at the floor), its outbound chord (where
the ray does not end on the floor) and the face's two jumps. So the kbar
baseline is two sums, each over shells 0 .. nr-1 in float32, the inbound
chords' and the outbound chords', then added; the closed form's path order
(``radial.tau_from_chords``: inbound shells nr-1 .. 0, then outbound, in one
sum) would need every face's roots kept. The plain walk,
``jumps.tau_walk_jumps``, adds in the kernel's order:

* float32: its optical depths equal, bit for bit, an independent numpy loop
  that solves each face once, as the kernel does, adds the chords ascending
  in two sums and then the walk's jump terms left to right;
* float64: they stay within the rtol of tests/test_torch_jumps.py against
  the JAX package's walk, which adds in the path order;
* a ray whose inbound chords are built so that the path order gives other
  float32 bits shows that the walk takes the new order.

On the grid3d_2496, blended_5184 and Mie patchy decks, with numpy-seeded rays.
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
from artes_tpu_torch.transport import geometry as TG
from artes_tpu_torch.transport import jumps as TJ
from artes_tpu_torch.transport import radial as RAD
from test_torch_jumps import RTOL, rays
from torch_threads import one_thread  # noqa: F401

DECKS = {"grid3d_2496": cells.grid3d_2496, "blended_5184": cells.blended_5184,
         "mie_patchy_deck": lambda: cells.mie_patchy_deck()[0]}
N = 1024
F32 = np.float32


@pytest.fixture(scope="module", params=sorted(DECKS))
def deck(request):
    """A deck's port tables in float32 and float64, and rays between its
    photon floor and its top."""
    atm = DECKS[request.param]()
    tables = {dt: cells.spectrum_tables(atm, "cpu", dt)[0]
              for dt in (torch.float32, torch.float64)}
    return request.param, atm, tables, rays(tables[torch.float64], N, seed=21)


def walk(tt, pos, d, cell, dtype, jt=None):
    g = tt.grid
    return TJ.tau_walk_jumps(g, tt.jump if jt is None else jt, g.rfront[tt.cell_depth],
                             *torch.as_tensor(pos, dtype=dtype).unbind(-1),
                             *torch.as_tensor(d, dtype=dtype).unbind(-1),
                             *torch.as_tensor(cell).unbind(-1))


def fma32(a, b, c):
    """``a * b + c`` of float32 arrays, rounded as ``geometry.fmadd`` rounds
    it: the exact product and the sum in float64, then to float32."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(F32)


def sqrt32(x):
    """PyTorch's float32 square root: on the CPU it is not always the
    correctly rounded one that numpy and the card's ``sqrtf`` give (one
    ulp off near a tie), and the loop checks the order, not the libm."""
    return torch.sqrt(torch.from_numpy(x)).numpy()


def face_roots(A, Bq, Cq, r_face):
    """``(ok, lo, hi)`` of one face sphere in float32, as ``roots_fma`` of
    the kernel solves them."""
    inv_a = F32(1.0) / A
    Cj = fma32(-np.full_like(Cq, r_face), np.full_like(Cq, r_face), Cq)
    disc = fma32(Bq, Bq, -(A * Cj))
    ok = disc > 0
    q = -(Bq + np.where(Bq >= 0, F32(1.0), F32(-1.0)) * sqrt32(np.where(ok, disc, F32(0.0))))
    r1 = q * inv_a
    r2 = Cj / np.where(q == 0, F32(1.0), q)
    mb = -Bq * inv_a
    lo = np.where(ok, np.minimum(r1, r2), mb)
    hi = np.where(ok, np.maximum(r1, r2), mb)
    return ok, lo, hi


def one_pass_kbar(tt, A, Bq, Cq):
    """The kbar baseline and the floor flag by the kernel's loop: the floor
    and the outer face, then faces 0 .. nr-1 once each, ascending."""
    g, kbar = tt.grid, tt.jump.kbar.numpy()
    rf = g.rfront.numpy()
    nr = g.nr
    ok_f, lo_f, _ = face_roots(A, Bq, Cq, F32(rf[int(tt.cell_depth)]))
    hit = ok_f & (lo_f > F32(g.pos_eps))
    s_surf = np.where(hit, lo_f, F32(TJ.BIG))
    _, lo, hi = face_roots(A, Bq, Cq, rf[nr])
    e_top, h_top = np.maximum(lo, F32(0.0)), np.maximum(hi, F32(0.0))
    _, lo, hi = face_roots(A, Bq, Cq, rf[0])
    e_lo, h_lo = np.maximum(lo, F32(0.0)), np.maximum(hi, F32(0.0))
    tau_in = np.zeros_like(A)
    tau_out = np.zeros_like(A)
    for j in range(1, nr + 1):
        if j < nr:
            _, lo, hi = face_roots(A, Bq, Cq, rf[j])
            e, h = np.maximum(lo, F32(0.0)), np.maximum(hi, F32(0.0))
        else:
            e, h = e_top, h_top
        seg_in = np.maximum(np.minimum(e_lo, s_surf) - np.minimum(e, s_surf), F32(0.0))
        tau_in = tau_in + kbar[j - 1] * seg_in
        tau_out = np.where(hit, tau_out, tau_out + kbar[j - 1] * np.maximum(h - h_lo, F32(0.0)))
        e_lo, h_lo = e, h
    return tau_in + tau_out, hit


def quad(tt, pos, d):
    """The ray's ``(A, Bq, Cq)`` in float32 numpy, as the walk forms them."""
    g = tt.grid
    p = torch.as_tensor(pos, dtype=torch.float32).unbind(-1)
    u = torch.as_tensor(d, dtype=torch.float32).unbind(-1)
    terms = TJ.quad_terms(g.ob_ax ** 2, g.ob_by ** 2, g.ob_cz ** 2, *p, *u)
    return [t.numpy() for t in terms]


def test_float32_walk_equals_the_one_pass_loop(deck, monkeypatch):
    name, _, tables, (pos, d, cell) = deck
    tt = tables[torch.float32]
    scans = []

    def recorded(terms):
        scans.append(terms)
        return left_scan(terms)

    left_scan = RAD.left_scan
    monkeypatch.setattr(RAD, "left_scan", recorded)
    got = walk(tt, pos, d, cell, torch.float32)
    # inbound chords, outbound chords, then the jump terms
    assert len(scans) == 3 and scans[2].shape[0] == N
    jumps = scans[2].numpy()
    dk_sum = jumps[:, 0].copy()
    for k in range(1, jumps.shape[1]):
        dk_sum = dk_sum + jumps[:, k]
    tau_bar, hit = one_pass_kbar(tt, *quad(tt, pos, d))
    np.testing.assert_array_equal(got["surface"].numpy(), hit, err_msg=name)
    np.testing.assert_array_equal(got["tau"].numpy(), np.maximum(tau_bar + dk_sum, F32(0.0)),
                                  err_msg=name)
    assert hit.any() and (~hit).any() and (got["tau"] > 0).float().mean() > 0.5


def test_float64_walk_stays_with_the_reference(deck):
    name, atm, tables, (pos, d, cell) = deck
    cfg = ArtesConfig()
    cfg.mode = "spectrum"
    jax_atm = j_atmosphere.Atmosphere(**{f.name: getattr(atm, f.name)
                                         for f in dataclasses.fields(atm)})
    det = detector_setup(cfg, float(atm.rfront[-1]))
    jt = build_tables(jax_atm, cfg, det, 0, dtype=jnp.float64).tables
    ref = JJ.tau_walk_jumps(JK._jump_env(jt), *[jnp.asarray(pos[:, i]) for i in range(3)],
                            *[jnp.asarray(d[:, i]) for i in range(3)],
                            *[jnp.asarray(cell[:, i], jnp.int32) for i in range(3)])
    got = walk(tables[torch.float64], pos, d, cell, torch.float64)
    np.testing.assert_array_equal(got["surface"].numpy(), np.asarray(ref["surface"]),
                                  err_msg=name)
    np.testing.assert_allclose(got["tau"].numpy(), np.asarray(ref["tau"]), rtol=RTOL, atol=0.0,
                               err_msg=name)


def test_inbound_chords_add_ascending():
    """A ray straight down from mid-top shell to the floor, every opacity
    jump zeroed so that the walk's depth is its kbar baseline: the top
    shell's chord is about 2^26 (a float32 step of 8), every other about 3.
    In the path order each 3 rounds away against the 2^26 already summed;
    ascending, they sum first and move the total. The walk takes the
    ascending order."""
    tt = cells.spectrum_tables(cells.grid3d_2496(), "cpu", torch.float32)[0]
    g = tt.grid
    nr = g.nr
    rf = g.rfront.double()
    r0 = float(0.5 * (rf[nr - 1] + rf[nr]))
    pos = np.array([[r0, 0.0, 0.0]])
    d = np.array([[-1.0, 0.0, 0.0]])
    cell = TG.locate_cell(g, torch.as_tensor(pos, dtype=torch.float32),
                          torch.tensor([nr - 1])).numpy()
    A, Bq, Cq = (torch.as_tensor(v) for v in quad(tt, pos, d))
    e, h, hit, s_surf = RAD.chords(A, Bq, Cq, g.rfront, g.rfront[tt.cell_depth], g.pos_eps,
                                   TJ.chord_disc)
    assert bool(hit[0])
    seg = (torch.minimum(e[0, :nr], s_surf[0]) - torch.minimum(e[0, 1:], s_surf[0])).double()
    assert (seg > 0).all()
    kbar = (3.0 / seg).float()
    kbar[nr - 1] = float(2.0 ** 26 / seg[nr - 1])
    zero = TJ.JumpTables(kbar=kbar, dk=torch.zeros_like(tt.jump.dk),
                         dr=torch.zeros_like(tt.jump.dr), dtt=torch.zeros_like(tt.jump.dtt),
                         dpp=torch.zeros_like(tt.jump.dpp), rf2=tt.jump.rf2)
    got = walk(tt, pos, d, cell, torch.float32, jt=zero)["tau"]

    chords = (kbar * torch.clamp_min(seg.float(), 0.0)).numpy()
    ascending = chords[0]
    for c in chords[1:]:
        ascending = ascending + c
    descending = chords[-1]
    for c in chords[-2::-1]:
        descending = descending + c
    path_order = RAD.tau_from_chords(e, h, hit, s_surf, kbar)
    assert path_order[0].item() == descending
    assert ascending != descending
    assert got.tolist() == [ascending]
    np.testing.assert_array_equal(one_pass_kbar(dataclasses.replace(tt, jump=zero), A.numpy(),
                                                Bq.numpy(), Cq.numpy())[0], [ascending])
