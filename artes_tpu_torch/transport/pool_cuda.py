"""The hand-written CUDA pool kernel (``csrc/pool_radial.cu``) and its wrapper.

Replaces ``artes_tpu.transport.pallas_stream.run_stream_pallas`` on this
package's slice: radial grids, stellar or thermal sources, any detector
size, no surface, no flow, float32 tables. :func:`run_stream_cuda` takes the
tables on a CUDA device and returns the tallies of
:func:`~artes_tpu_torch.transport.kernel.run_stream`, its plain PyTorch
version. It launches on PyTorch's current stream and does not synchronise.

The kernel has four compile-time instantiations (:data:`VARIANTS`): stellar
or thermal source, single pixel or image. ``LAUNCHES`` counts kernel
launches per instantiation, where the kernel is launched and nowhere else,
so a run can show that it went through the kernel.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from artes_tpu_torch import _build
from artes_tpu_torch.transport import rng as R
from artes_tpu_torch.transport import sampling as S
from artes_tpu_torch.transport.kernel import (ERR_RECORD_W, KernelStatic,
                                              TransportTables, check_slice,
                                              detector_from_tallies, emit_basis)

# instantiation names by variant (bit 0 thermal, bit 1 image)
VARIANTS = ("stellar", "thermal", "image", "thermal_image")
LAUNCHES = dict.fromkeys(VARIANTS, 0)

THREADS = 256
BLOCKS_PER_SM = 8
N_SCAL = 32
N_OUT_D = 10
N_OUT_I = 4
N_IMG_D = 8
N_IMG_I = 2
F_CRESCENT, F_BIASED = 1, 2

# How far the kernel may stray from its plain version on the same photon
# streams in float32 (the two compilers contract FMAs differently, so rare
# trajectories flip). "count" is the Stokes-I row's count (scatter plus
# birth peels) and "count_quv" the Q, U, V rows' count (scatter peels), each
# summed over the pixels and relative to the plain sum; "pixel_I" and
# "pixel_N" are sum_p |dI_p| / sum_p I_p and sum_p |dN_p| / sum_p N_p over
# the pixels (the Stokes-I row), which see a shifted or transposed image;
# "capped" is the photons stopped at max_scatter as a share of the photons
# emitted; "stokes" the sums of I, Q, U, V as |dS_k| <= lim_k * I;
# "squares" each sum of squares relative to its own plain value;
# "flux_emitted" and "flux_exit" relative to the plain value (0 when both
# are 0). Set from readings at 2^20 photons, seed 7, on the chip_smoke.py
# cells (NVIDIA H100 80GB HBM3, 700 W); PERF.md section 2 has the readings.
AGREE = {"count": 1.2e-4, "count_quv": 1.2e-4, "pixel_I": 8e-4, "pixel_N": 4.2e-4,
         "capped": 3e-6, "stokes": (3e-4, 5e-6, 1e-4, 1e-4),
         "squares": (4.2e-4, 3.2e-4, 7e-4, 7e-4), "flux_emitted": 6.5e-8, "flux_exit": 6e-6}

_vp = ctypes.c_void_p
_ARGTYPES = ([_vp] * 10 + [ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_uint]
             + [ctypes.c_int] * 5 + [_vp] * 4 + [ctypes.c_int, ctypes.c_int, _vp])


def supports(tables: TransportTables, static: KernelStatic) -> bool:
    """True when the kernel covers this configuration in float32."""
    try:
        check_slice(tables, static)
    except NotImplementedError:
        return False
    return tables.opacity.dtype == torch.float32


def variant_of(static: KernelStatic) -> int:
    """The instantiation a configuration runs (index into :data:`VARIANTS`)."""
    return int(static.photon_source == 2) | (int(static.nx * static.ny > 1) << 1)


def _rel(d, ref) -> float:
    d, ref = float(d), float(ref)
    if d == 0.0:
        return 0.0
    return abs(d) / abs(ref) if ref != 0.0 else math.inf


def gaps(kernel_out: dict, plain_out: dict) -> dict:
    """Gaps between two results of ``run_stream`` (or
    :func:`run_stream_cuda`) on the same configuration, keyed as
    :data:`AGREE`; "stokes" and "squares" hold the four components."""
    k, p = (o["detector"].double().cpu() for o in (kernel_out, plain_out))
    diff = k - p
    tot_k, tot_p = k.sum(0), p.sum(0)
    tot_d = (tot_k - tot_p).abs()
    capped = abs(int(kernel_out["n_alive_at_cap"]) - int(plain_out["n_alive_at_cap"]))
    return {"count": _rel(tot_d[0, 2], tot_p[0, 2]),
            "count_quv": max(_rel(tot_d[c, 2], tot_p[c, 2]) for c in (1, 2, 3)),
            "pixel_I": _rel(diff[:, 0, 0].abs().sum(), p[:, 0, 0].abs().sum()),
            "pixel_N": _rel(diff[:, 0, 2].abs().sum(), p[:, 0, 2].sum()),
            "capped": capped / int(plain_out["n_emitted"]),
            "stokes": (tot_d[:, 0] / tot_p[0, 0].abs()).tolist(),
            "squares": [_rel(d, s) for d, s in zip(tot_d[:, 1], tot_p[:, 1])],
            "flux_emitted": _rel(float(kernel_out["flux_emitted"]) - float(plain_out["flux_emitted"]),
                                 plain_out["flux_emitted"]),
            "flux_exit": _rel(float(kernel_out["flux_exit"]) - float(plain_out["flux_exit"]),
                              plain_out["flux_exit"])}


def agrees(g: dict) -> bool:
    """True when every gap of :func:`gaps` is within :data:`AGREE` (a NaN
    gap is not)."""
    return all(all(x <= lim for x, lim in zip(g[key], AGREE[key]))
               if isinstance(AGREE[key], tuple) else g[key] <= AGREE[key]
               for key in AGREE)


def _library():
    lib = _build.load("pool_radial")
    fn = lib.artes_pool_radial_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        layout = (ctypes.c_int * 5)()
        lib.artes_pool_radial_layout.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.artes_pool_radial_layout.restype = ctypes.c_int
        lib.artes_pool_radial_layout(layout)
        if tuple(layout) != (N_SCAL, N_OUT_D, N_OUT_I, N_IMG_D, N_IMG_I):
            raise RuntimeError(f"pool_radial layout {tuple(layout)} does not match the wrapper")
    return fn


def _scalars(t: TransportTables, static: KernelStatic) -> torch.Tensor:
    """The kernel's scalar table (layout of ``enum S_*`` in pool_radial.cu)."""
    g = t.grid
    dev = t.opacity.device
    host = torch.as_tensor(np.concatenate([
        [g.ob_ax, g.ob_by, g.ob_cz], *emit_basis(t, static), [g.pos_eps, g.sel1]]),
        dtype=torch.float32).to(dev)
    one = [v.reshape(1).to(torch.float32) for v in (t.fstop, t.photon_minimum,
                                                     t.x_max, t.y_max)]
    return torch.cat(one + [t.det_dir.to(torch.float32), t.det_trig.to(torch.float32),
                            g.rfront[t.cell_depth].reshape(1), host,
                            g.theta_cos[:2].to(torch.float32),
                            t.photon_bias.reshape(1).to(torch.float32)])


def _constants(device) -> torch.Tensor:
    return torch.as_tensor(np.concatenate([S.BETA_BASIS.reshape(-1), S.BETA_EDGE_SIN2,
                                           S.BETA_EDGE_COS2]),
                           dtype=torch.float32).to(device)


def _check_inputs(t: TransportTables) -> int:
    dev = t.opacity.device
    if dev.type != "cuda":
        raise ValueError(f"run_stream_cuda needs tables on a CUDA device, got {dev}")
    nr = t.grid.nr
    shapes = {"rfront": (t.grid.rfront, (nr + 1,)), "theta_cos": (t.grid.theta_cos, (2,)),
              "opacity": (t.opacity, (nr,)), "albedo": (t.albedo, (nr,)),
              "scatter_rows": (t.scatter_rows, (nr * 180, 16)),
              "alpha_prefix": (t.alpha_prefix, (nr, 4, 181)), "p_int": (t.p_int, (nr, 4)),
              "emis_cum": (t.emis_cum, (nr,)), "cell_weight": (t.cell_weight, (nr,))}
    for name, (x, shape) in shapes.items():
        if x.dtype != torch.float32:
            raise ValueError(f"run_stream_cuda runs float32 tables; {name} is {x.dtype}")
        if x.device != dev or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous {shape} tensor on {dev}, "
                             f"got {tuple(x.shape)} on {x.device}")
    return nr


def run_stream_cuda(tables: TransportTables, static: KernelStatic, n_photons: int,
                    seed: int, id_hi: int = 0, id_lo: int = 0):
    """Transport photons ``id_lo .. id_lo + n_photons - 1`` (high id word
    ``id_hi``) through the CUDA kernel; returns the tallies of
    :func:`~artes_tpu_torch.transport.kernel.run_stream` as device tensors.
    The id range must not cross a 2^32 boundary."""
    check_slice(tables, static)
    nr = _check_inputs(tables)
    n = int(n_photons)
    if n < 0 or n >= 1 << 32 or int(id_lo) < 0 or int(id_lo) + n > 1 << 32:
        raise ValueError(f"photon ids [{id_lo}, {id_lo} + {n}) leave the 32-bit window")
    npix = static.nx * static.ny
    if npix >= 1 << 31:
        raise ValueError(f"{npix} pixels overflow the kernel's 32-bit pixel index")
    t = tables
    dev = t.opacity.device
    variant = variant_of(static)
    image = npix > 1
    out_d = torch.zeros(N_OUT_D, dtype=torch.float64, device=dev)
    out_i = torch.zeros(N_OUT_I, dtype=torch.int64, device=dev)
    img_d = torch.zeros((npix if image else 1, N_IMG_D), dtype=torch.float64, device=dev)
    img_i = torch.zeros((npix if image else 1, N_IMG_I), dtype=torch.int64, device=dev)
    if n > 0:
        fn = _library()
        scal = _scalars(t, static)
        consts = _constants(dev)
        flags = (F_CRESCENT if static.crescent else 0) | \
            (F_BIASED if static.photon_emission == 2 else 0)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        blocks = min(-(-n // THREADS), sms * BLOCKS_PER_SM)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = fn(t.grid.rfront.data_ptr(), t.opacity.data_ptr(), t.albedo.data_ptr(),
                    t.scatter_rows.data_ptr(), t.alpha_prefix.data_ptr(), t.p_int.data_ptr(),
                    consts.data_ptr(), scal.data_ptr(), t.emis_cum.data_ptr(),
                    t.cell_weight.data_ptr(), nr, n, R.key_hi(seed, id_hi), int(id_lo),
                    int(static.max_scatter), variant, flags, static.nx, static.ny,
                    img_d.data_ptr(), img_i.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
                    blocks, THREADS, stream)
        if rc != 0:
            raise RuntimeError(f"pool_radial launch failed: cudaError {rc}")
        LAUNCHES[VARIANTS[variant]] += 1
    if image:
        sums, counts = img_d.reshape(npix, 2, 4).transpose(1, 2), img_i
    else:
        sums = out_d[:8].reshape(1, 2, 4).transpose(1, 2)
        counts = torch.stack([out_i[0] + out_i[3], out_i[0]]).reshape(1, 2)
    return {
        "detector": detector_from_tallies(sums, counts),
        "flux_emitted": out_d[8],
        "flux_exit": out_d[9],
        # zero by construction: the closed form has no failure modes
        "n_error": torch.zeros((), dtype=torch.int64, device=dev),
        "error_codes": torch.zeros(4, dtype=torch.int64, device=dev),
        "n_alive_at_cap": out_i[1],
        "n_emitted": out_i[2],
        "error_records": torch.zeros((0, ERR_RECORD_W), dtype=torch.float64),
        "n_error_records": 0,
    }
