"""The CUDA kernels on the card, against their plain PyTorch versions.

Needs a CUDA device, nvcc and no JAX; without a card every test skips. On a
machine with a card (which has no JAX, so the JAX-pinning conftest is left
out):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import pytest
import torch

from artes_tpu_torch import probe_splat
from artes_tpu_torch.cells import CELLS, KERNEL_CELLS, spectrum_tables
from artes_tpu_torch.transport import kernel, pool_cuda

SEED = 7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def setup(name, device, dtype=torch.float32):
    return spectrum_tables(CELLS[name](), device, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CELLS))
def test_cuda_kernel_matches_plain(cuda, name):
    """The count, the capped photons and all eight sums within
    ``pool_cuda.AGREE`` at 2^20 photons, the size the limits were set at:
    the two compilers contract FMAs differently, so rare trajectories flip."""
    tables, static = setup(name, cuda)
    n = 1 << 20
    k = pool_cuda.run_stream_cuda(tables, static, n, SEED)
    p = kernel.run_stream(tables, static, n, SEED, n)
    assert k["detector"].isfinite().all()
    g = pool_cuda.gaps(k, p)
    assert pool_cuda.agrees(g), g
    assert int(k["n_emitted"]) == n


@pytest.mark.gpu
def test_cuda_wrapper_counts_launches_and_checks_inputs(cuda):
    tables, static = setup("flagship", cuda)
    before = dict(pool_cuda.LAUNCHES)
    after = dict(before, stellar=before["stellar"] + 1)
    pool_cuda.run_stream_cuda(tables, static, 4096, SEED)
    pool_cuda.run_stream_cuda(tables, static, 0, SEED)          # nothing to launch
    torch.cuda.synchronize()
    assert pool_cuda.LAUNCHES == after
    tables64, static64 = setup("flagship", cuda, torch.float64)
    with pytest.raises(ValueError, match="float32"):
        pool_cuda.run_stream_cuda(tables64, static64, 4096, SEED)
    with pytest.raises(ValueError, match="32-bit window"):
        pool_cuda.run_stream_cuda(tables, static, 16, SEED, id_lo=(1 << 32) - 8)
    assert pool_cuda.LAUNCHES == after


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(set(KERNEL_CELLS) - set(CELLS)))
def test_cuda_instantiations_match_plain(cuda, name):
    """Thermal, image and crescent/off-axis cells: every gap of
    ``pool_cuda.gaps`` (per pixel, per count column, fluxes) within
    ``pool_cuda.AGREE`` at 2^20 photons, each through its instantiation."""
    tables, static = KERNEL_CELLS[name](cuda)
    variant = pool_cuda.VARIANTS[pool_cuda.variant_of(static)]
    before = pool_cuda.LAUNCHES[variant]
    n = 1 << 20
    k = pool_cuda.run_stream_cuda(tables, static, n, SEED)
    p = kernel.run_stream(tables, static, n, SEED, n)
    assert pool_cuda.LAUNCHES[variant] == before + 1
    assert k["detector"].isfinite().all()
    assert k["detector"].shape == p["detector"].shape == (static.nx * static.ny, 4, 3)
    g = pool_cuda.gaps(k, p)
    assert pool_cuda.agrees(g), g


@pytest.mark.gpu
@pytest.mark.parametrize("npix", [625, 10201])
def test_probe_splat_kernels_match_plain(cuda, npix):
    before = dict(probe_splat.LAUNCHES)
    vals, counts = probe_splat.splat(npix, 50, device=cuda)
    sink = probe_splat.baseline(50, device=cuda)
    ref_vals, ref_counts = probe_splat.splat_plain(npix, 50, device=cuda)
    assert torch.equal(counts, ref_counts)
    torch.testing.assert_close(vals, ref_vals, rtol=probe_splat.VALUE_RTOL, atol=0.0)
    assert torch.equal(sink, probe_splat.baseline_plain(50, device=cuda))
    assert probe_splat.LAUNCHES == {k: v + 1 for k, v in before.items()}
