"""Float32 error rates of the plain PyTorch version against JAX's float32.

In float32 the marching walks fail on a few photons in a thousand: a peel or
a prewalk steps past a face that rounding hides. Which photons fail depends
on how each compiler rounds, so the two packages cannot agree photon for
photon; their rates must agree as Poisson counts do. On the nr=39 graded
grid over a surface of albedo 0.5 (``cells.hydrostatic39`` as the
``hydrostatic39_surface`` cell builds it, every scattering order up to the
default cap), with identical tables (``convert.tables_from_jax``) and the
same (seed, photon id) streams, JAX XLA ``run_stream`` and the port's plain
``run_stream`` each run 2^13 photons at seed 30. Every per-code tally
(codes 031, 032, 034, the failed peel walks), the abandoned photons and the
photons at the scattering cap agree within 3 sigma: ``|a - b| <= 3 sqrt(a +
b)``. The failed peels must number at least 30 on each side, so the test
cannot pass empty (about 1.3 failed peels a hundred photons here).

At 2^13 photons about 100 failed peels fall on each side, so 3 sigma is
about 44 of them: the test holds the rates to within about 40% and cannot see
a smaller excess. At 2^16 photons, seed 7, the plain version failed 12% more
peels than JAX on the CPU (1110 against 991) while it rounded its float32
geometry one operation at a time; XLA and nvcc compile that geometry into
fused multiply-add chains, and the plain version now rounds the same chains
(``geometry.fmadd``): 939 against 991.

Which peels fail is the rounding's, not a branch's: every failed scatter peel
of the plain version, walked again from its recorded position, cell and face
by JAX's own marching peel walk (``_peel_walk``) as XLA compiles it, fails
too; run op by op (``jax.disable_jit``), the same walk passes some of them.

Run as a script, it prints JAX's and the plain version's float32 tallies on
both uncut surface cells (``hydrostatic39_surface`` and
``grid3d_2496_surface``) at another size and seed, on the CPU, to stand beside
the card's kernel and plain tallies of ``python -m artes_tpu_torch.measure
rates`` (2^16 photons, seed 7), and the share of the plain version's failed
scatter peels that JAX's walk passes, compiled and op by op::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_f32_rates.py [photons] [seed]
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from artes_tpu.transport import kernel as JK
from artes_tpu_torch import cells
from artes_tpu_torch.transport import kernel as TK
from test_torch_pool import setup
from torch_threads import one_thread  # noqa: F401

N = 1 << 13
SEED = 30
MIN_FAILED_PEELS = 30
MAX_COMPILED_PASSES = 3


def rates(out):
    """``{tally: count}`` of a ``run_stream`` result."""
    codes = np.asarray(out["error_codes"]).astype(np.int64)
    return {"031": int(codes[0]), "032": int(codes[1]), "034": int(codes[2]),
            "peel": int(codes[3]), "n_error": int(out["n_error"]),
            "n_alive_at_cap": int(out["n_alive_at_cap"])}


def jax_walk_passes(jt, static, out, compiled):
    """For each failed scatter peel the plain run ``out`` recorded (code 50,
    site 3: the walk's input position, cell and face), whether JAX's marching
    peel walk from that state reaches the observer, compiled by XLA or op by
    op."""
    rec = out["error_records"]
    rows = rec[(rec[:, 0] == 50.0) & (rec[:, 15] == 3.0)].numpy()
    args = (jnp.asarray(rows[:, 2:5].astype(np.float32)), jnp.asarray(rows[:, 8:11].astype(np.int32)),
            jnp.asarray(rows[:, 11:13].astype(np.int32)), jnp.ones(len(rows), bool))
    if compiled:
        _, exited, _ = JK._peel_walk(jt, static, *args)
    else:
        with jax.disable_jit():
            _, exited, _ = JK._peel_walk(jt, static, *args)
    return np.asarray(exited)


@pytest.fixture(scope="module")
def runs():
    jt, static, tt, st = setup(cells.hydrostatic39(), "float32", surface_albedo=0.5)
    assert TK.walk_mode(tt, st) == "march" and st.max_scatter == static.max_scatter
    return (jt, static, JK.run_stream(jt, static, N, SEED, 1024),
            TK.run_stream(tt, st, N, SEED, N, err_k=N))


def test_surface_error_rates_match_jax_f32(runs):
    _, _, jax_out, plain_out = runs
    ref, got = rates(jax_out), rates(plain_out)
    print(f"JAX f32 {ref}; port f32 {got} ({N} photons, seed {SEED})")
    assert min(ref["peel"], got["peel"]) >= MIN_FAILED_PEELS, (ref, got)
    for key in ref:
        a, b = ref[key], got[key]
        assert abs(a - b) <= 3.0 * np.sqrt(a + b), (key, ref, got)


def test_failed_peels_fail_in_jax_compiled_walk(runs):
    """The plain version's failed scatter peels fail again in JAX's walk as
    XLA compiles it: the plain float32 geometry rounds the fused
    multiply-add chains XLA compiles (``geometry.fmadd``). At most
    ``MAX_COMPILED_PASSES`` pass (XLA's float32 square root on the CPU is not
    the correctly rounded one). While the plain walk rounded op by op, the
    compiled walk passed 26 of the 74 it recorded."""
    jt, static, _, plain_out = runs
    passes = jax_walk_passes(jt, static, plain_out, compiled=True)
    print(f"{len(passes)} failed scatter peels; JAX's compiled walk passes {int(passes.sum())}, "
          f"op by op {int(jax_walk_passes(jt, static, plain_out, compiled=False).sum())}")
    assert len(passes) >= MIN_FAILED_PEELS
    assert int(passes.sum()) <= MAX_COMPILED_PASSES


if __name__ == "__main__":
    import sys

    photons = int(sys.argv[1]) if len(sys.argv) > 1 else 1 << 16
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else 7
    for name, atm in (("hydrostatic39_surface", cells.hydrostatic39()),
                      ("grid3d_2496_surface", cells.grid3d_2496())):
        jt, static, tt, st = setup(atm, "float32", surface_albedo=0.5)
        print(f"{name} uncut (max_scatter {static.max_scatter}), {photons} photons, seed "
              f"{seed}: JAX f32 {rates(JK.run_stream(jt, static, photons, seed, 1024))}",
              flush=True)
        out = TK.run_stream(tt, st, photons, seed, photons, err_k=photons)
        print(f"{name} uncut (max_scatter {st.max_scatter}), {photons} photons, seed "
              f"{seed}: plain f32 {rates(out)}", flush=True)
        walks = {"compiled": jax_walk_passes(jt, static, out, compiled=True),
                 "op by op": jax_walk_passes(jt, static, out, compiled=False)}
        print(f"{name}: of the plain version's {len(walks['compiled'])} recorded failed "
              f"scatter peels, JAX's walk passes "
              + ", ".join(f"{int(v.sum())} {k}" for k, v in walks.items()), flush=True)
