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


def held_against_plain(tables, static, n):
    """Kernel and plain version on the same photons: one more launch of the
    configuration's instantiation, every gap within the grid's limits."""
    grid3d = tables.jump is not None
    variant = (pool_cuda.VARIANTS_3D if grid3d else pool_cuda.VARIANTS)[
        pool_cuda.variant_of(static)]
    before = pool_cuda.LAUNCHES[variant]
    k = pool_cuda.run_stream_cuda(tables, static, n, SEED)
    p = kernel.run_stream(tables, static, n, SEED, n)
    assert pool_cuda.LAUNCHES[variant] == before + 1
    assert k["detector"].isfinite().all()
    assert k["detector"].shape == p["detector"].shape == (static.nx * static.ny, 4, 3)
    g = pool_cuda.gaps(k, p)
    assert pool_cuda.agrees(g, pool_cuda.limits_of(tables)), g
    return k, p


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(set(KERNEL_CELLS) - set(CELLS)))
def test_cuda_instantiations_match_plain(cuda, name):
    """Thermal, image, crescent/off-axis and 3-D cells: every gap of
    ``pool_cuda.gaps`` (per pixel, per count column, fluxes, abandoned
    photons) within ``pool_cuda.AGREE`` at 2^20 photons on radial grids and
    ``AGREE_3D`` at 2^18 on 3-D ones, the sizes the limits were set at, each
    through its instantiation."""
    tables, static = KERNEL_CELLS[name](cuda)
    k, p = held_against_plain(tables, static, 1 << (20 if tables.jump is None else 18))
    if tables.jump is not None:
        # one record per abandoned photon, in photon-id order, each also an
        # event of the plain version unless its trajectory flipped
        n_err = int(k["n_error"])
        assert k["n_error_records"] == n_err
        rec = k["error_records"]
        assert len(rec) == min(n_err, 2 * kernel.ERR_RECORD_K)
        assert torch.equal(rec[:, 1], torch.sort(rec[:, 1]).values)
        assert set(rec[:, 0].tolist()) <= {31.0, 32.0, 34.0} and (rec[:, 15] == 0).all()
        shared = set(rec[:, 1].tolist()) & set(p["error_records"][:, 1].tolist())
        assert len(shared) >= len(rec) // 2


@pytest.mark.gpu
def test_cuda_grid_of_5184_blended_cells(cuda):
    """More cells than the TPU kernel's tables held (4,096), every cell its
    own blend of two species: per-cell tables in global memory need no cell
    cap and no mixture dedup. (Held against the plain version as the
    ``blended_5184`` cell of ``test_cuda_instantiations_match_plain``.)"""
    tables, static = KERNEL_CELLS["blended_5184"](cuda)
    assert tables.opacity.shape[0] == 5184
    assert len(torch.unique(tables.scatter_rows.reshape(5184, -1), dim=0)) == 5184
    assert pool_cuda.supports(tables, static)
    k = pool_cuda.run_stream_cuda(tables, static, 1 << 16, SEED)
    assert int(k["n_emitted"]) == 1 << 16 and float(k["detector"][0, 0, 2]) > 1e4
    assert k["detector"].isfinite().all()


@pytest.mark.gpu
def test_cuda_refuses_what_only_the_plain_version_runs(cuda):
    import dataclasses
    tables, static = KERNEL_CELLS["patchy3d_small"](cuda)
    for keys in (dict(debug_stokes=True), dict(photon_scattering=False)):
        with pytest.raises(NotImplementedError, match="--device cpu"):
            pool_cuda.run_stream_cuda(tables, dataclasses.replace(static, **keys), 64, SEED)


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
