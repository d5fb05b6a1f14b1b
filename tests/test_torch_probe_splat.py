"""The splat micro-benchmark's plain version (``artes_tpu_torch.probe_splat``)
against a numpy re-implementation of ``tools/probe_splat.py``.

The TPU probe runs only on a TPU (no interpret mode), so its LCG, pixel
choice and features (tools/probe_splat.py:44-72) are re-implemented here in
numpy uint32/float32 arithmetic, binned into its (F * nrows_pad, 128)
detector layout and read back per pixel. The kernel against the plain
version runs on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from artes_tpu_torch import probe_splat as P
from torch_threads import one_thread  # noqa: F401

ROUNDS = 20


def tpu_probe_numpy(npix, n_rounds, seed, nvals, ncnt):
    """tools/probe_splat.py's features of 8192 lanes, summed in float64 into
    the TPU detector layout (row f * nrows_pad + (pix >> 7), column pix &
    127), then returned per pixel as (values (npix, nvals), counts (npix,
    ncnt))."""
    nrows = -(-npix // 128)
    nrows_pad = max(-(-nrows // 8) * 8, 8)
    x = (np.arange(64, dtype=np.uint32)[:, None] * np.uint32(128)
         + np.arange(128, dtype=np.uint32)[None, :] + np.uint32(seed)).reshape(-1)
    det = np.zeros(((ncnt + nvals) * nrows_pad, 128))
    for _ in range(n_rounds):
        x = x * np.uint32(1664525) + np.uint32(1013904223)
        pix = (x >> np.uint32(17)).astype(np.int32) % npix
        v0 = (x >> np.uint32(8)).astype(np.int32).astype(np.float32) * np.float32(2.0 ** -24)
        m, col = pix >> 7, pix & 127
        feats = [(v0 < 0.5 + 0.1 * f).astype(np.float64) for f in range(ncnt)]
        feats += [(v0 * np.float32(1.0 + 0.25 * f)).astype(np.float64) for f in range(nvals)]
        for f, val in enumerate(feats):
            np.add.at(det, (f * nrows_pad + m, col), val)
    per_pix = det.reshape(ncnt + nvals, nrows_pad * 128)[:, :npix].T
    return per_pix[:, ncnt:], per_pix[:, :ncnt]


@pytest.mark.parametrize("npix", [625, 2025, 10201])
def test_plain_splat_matches_tpu_probe(npix):
    vals, counts = P.splat(npix, ROUNDS, seed=1, device="cpu")
    ref_vals, ref_counts = tpu_probe_numpy(npix, ROUNDS, 1, P.NVALS, P.NCNT)
    assert vals.shape == (npix, P.NVALS) and counts.shape == (npix, P.NCNT)
    np.testing.assert_array_equal(counts.numpy(), ref_counts.astype(np.int64))
    np.testing.assert_allclose(vals.numpy(), ref_vals, rtol=P.VALUE_RTOL, atol=0.0)
    # every lane lands once a round; the first count feature fires for v0 < 0.5
    assert vals[:, 0].numel() == npix and int(counts[:, 0].sum()) < P.LANES * ROUNDS
    assert P.LAUNCHES == {"probe_splat": 0, "probe_splat_baseline": 0}


def test_plain_baseline_is_the_lcg():
    x = np.arange(P.LANES, dtype=np.uint32) + np.uint32(5)
    for _ in range(ROUNDS):
        x = x * np.uint32(1664525) + np.uint32(1013904223)
    np.testing.assert_array_equal(P.baseline(ROUNDS, seed=5, device="cpu").numpy(),
                                  (x >> np.uint32(8)).astype(np.float64))


def test_splat_on_cpu_tensors_launches_nothing():
    before = dict(P.LAUNCHES)
    vals, counts = P.splat(625, 2, device=torch.device("cpu"))
    assert vals.device.type == counts.device.type == "cpu"
    assert P.LAUNCHES == before


def test_chain_cycles_reads_the_card_only():
    """The latency of the loop's step is read from the card's cycle counter:
    on the CPU there is nothing to read, and nothing runs."""
    with pytest.raises(ValueError, match="cycle counter"):
        P.chain_cycles(device="cpu")
    assert P.LAUNCHES == {"probe_splat": 0, "probe_splat_baseline": 0}
