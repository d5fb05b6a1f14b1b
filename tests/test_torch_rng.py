"""The port's threefry2x32 stream is bit-exact against the JAX package's.

Every other parity test of ``artes_tpu_torch`` rests on this one: the same
(seed, photon id, draw site) must give the same 32-bit words and the same
float32 / float64 uniforms in both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artes_tpu.transport import rng as JR
from artes_tpu_torch.transport import rng as TR
from torch_threads import one_thread  # noqa: F401

u32 = jnp.uint32


def _t(a):
    return torch.from_numpy(np.asarray(a, np.uint32).astype(np.int64))


@pytest.mark.parametrize("key,ctr,expect", [
    ((0x00000000, 0x00000000), (0x00000000, 0x00000000), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0)),
])
def test_threefry2x32_known_answer(key, ctr, expect):
    x0, x1 = TR.threefry2x32(*(torch.tensor(v) for v in (*key, *ctr)))
    assert (int(x0), int(x1)) == expect


def test_threefry2x32_random_words_bit_exact():
    rs = np.random.default_rng(11)
    k0, k1, c0, c1 = (rs.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
                      for _ in range(4))
    j0, j1 = JR.threefry2x32(*(jnp.asarray(v) for v in (k0, k1, c0, c1)))
    t0, t1 = TR.threefry2x32(*(_t(v) for v in (k0, k1, c0, c1)))
    np.testing.assert_array_equal(np.asarray(j0, np.int64), t0.numpy())
    np.testing.assert_array_equal(np.asarray(j1, np.int64), t1.numpy())


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("base", [0, 1, 2, 7, 0xFFFFFFF0])
def test_uniform_n_kk_bit_exact(dtype, base):
    """Words of every draw at even and odd base sites, random keys."""
    rs = np.random.default_rng(base + 3)
    k0 = rs.integers(0, 1 << 32, 2048, dtype=np.uint64).astype(np.uint32)
    k1 = rs.integers(0, 1 << 32, 2048, dtype=np.uint64).astype(np.uint32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = JR.uniform_n_kk(jnp.asarray(k0), jnp.asarray(k1), u32(base), 5, jd)
    got = TR.uniform_n_kk(_t(k0), _t(k1), base, 5, td)
    for r, g in zip(ref, got):
        assert g.dtype == td
        np.testing.assert_array_equal(np.asarray(r), g.numpy())


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_uniform_per_photon_sites_bit_exact(dtype):
    """Per-photon (mixed-parity) site counters, as the transport draws them."""
    rs = np.random.default_rng(5)
    pid = np.arange(1000, 1512, dtype=np.uint32)
    sites = rs.integers(0, 1500, pid.shape[0], dtype=np.uint64).astype(np.uint32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    keys_j = JR.photon_keys(77, jnp.asarray(pid))
    keys_t = TR.photon_keys(77, _t(pid))
    np.testing.assert_array_equal(np.asarray(keys_j, np.int64), keys_t.numpy())
    for i in range(3):
        ref = JR.uniform(keys_j, jnp.asarray(sites) + u32(i), jd)
        got = TR.uniform(keys_t, _t(sites) + i, td)
        np.testing.assert_array_equal(np.asarray(ref), got.numpy())


@pytest.mark.parametrize("id_hi", [1, 5, 0xFFFFFFFF])
def test_high_id_word_bit_exact(id_hi):
    """64-bit photon ids: the high word folds into k0 as seed + hi * GOLDEN."""
    pid = np.arange(64, dtype=np.uint32)
    keys_j = JR.photon_keys(9, jnp.asarray(pid), id_hi=id_hi)
    keys_t = TR.photon_keys(9, _t(pid), id_hi=id_hi)
    np.testing.assert_array_equal(np.asarray(keys_j, np.int64), keys_t.numpy())
    assert TR.key_hi(9, id_hi) == int(np.asarray(JR.key_hi(9, id_hi)))
    for dt in ("float32", "float64"):
        ref = JR.uniform_n(keys_j, u32(3), 4, getattr(jnp, dt))
        got = TR.uniform_n(keys_t, 3, 4, getattr(torch, dt))
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(np.asarray(r), g.numpy())


def test_golden_schedule_f32():
    """The pinned float32 schedule of tests/test_rng.py (seed 0, photon 0)."""
    golden = np.asarray([0.418457031, 0.600499034, 0.314681649, 0.753391147, 0.393160224,
                         0.984709024, 0.721370935, 0.020384431, 0.673549771, 0.654994130],
                        np.float32)
    keys = TR.photon_keys(0, torch.arange(1))
    got = np.asarray([TR.uniform(keys, s).item() for s in range(10)], np.float32)
    np.testing.assert_array_equal(got, golden)
