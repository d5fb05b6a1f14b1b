"""The hand-written CUDA pool kernels and their wrapper.

Replaces ``artes_tpu.transport.pallas_stream.run_stream_pallas`` on this
package's slice: radial grids (``csrc/pool_radial.cu``, closed-form walks)
and 3-D grids (``csrc/pool_grid3d.cu``, jump walks and the marching
``cell_face`` walk, error tallies and records), stellar or thermal sources,
any detector size, no surface, no flow, float32 tables.
:func:`run_stream_cuda` takes the tables on a CUDA device, picks the kernel
by the grid and returns the tallies of
:func:`~artes_tpu_torch.transport.kernel.run_stream`, its plain PyTorch
version. It launches on PyTorch's current stream; the radial kernel does
not synchronise, the 3-D one waits for its error records.

Each kernel has four compile-time instantiations (:data:`VARIANTS`):
stellar or thermal source, single pixel or image. ``LAUNCHES`` counts kernel
launches per instantiation (the 3-D ones as ``grid3d_<variant>``), where the
kernel is launched and nowhere else, so a run can show that it went through
the kernel.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from artes_tpu_torch import _build
from artes_tpu_torch.transport import geometry as G
from artes_tpu_torch.transport import rng as R
from artes_tpu_torch.transport import sampling as S
from artes_tpu_torch.transport.kernel import (ERR_RECORD_K, ERR_RECORD_W, KernelStatic,
                                              TransportTables, check_slice,
                                              detector_from_tallies, emit_basis,
                                              select_error_records)

# instantiation names by variant (bit 0 thermal, bit 1 image)
VARIANTS = ("stellar", "thermal", "image", "thermal_image")
VARIANTS_3D = tuple("grid3d_" + v for v in VARIANTS)
LAUNCHES = dict.fromkeys(VARIANTS + VARIANTS_3D, 0)

THREADS = 256
BLOCKS_PER_SM = 8
N_SCAL = 32
N_OUT_D = 10
N_OUT_I = 4
N_IMG_D = 8
N_IMG_I = 2
N_OUT_I3 = 8            # pool_grid3d: N_OUT_I + photons abandoned, codes 031, 032, 034
F_CRESCENT, F_BIASED = 1, 2
# rows of the 3-D kernel's error-record buffer (64 bytes each); errors are
# about 1e-4 of the photons, so one launch of up to 2^30 photons may drop
# rows of the middle, never a count
REC_CAP = 1 << 16

# How far the kernel may stray from its plain version on the same photon
# streams in float32 (the two compilers contract FMAs differently, so rare
# trajectories flip). "count" is the Stokes-I row's count (scatter plus
# birth peels) and "count_quv" the Q, U, V rows' count (scatter peels), each
# summed over the pixels and relative to the plain sum; "pixel_I" and
# "pixel_N" are sum_p |dI_p| / sum_p I_p and sum_p |dN_p| / sum_p N_p over
# the pixels (the Stokes-I row), which see a shifted or transposed image;
# "capped" is the photons stopped at max_scatter, "n_error" the photons
# abandoned and "error_codes" the largest per-code difference, each as a
# share of the photons emitted; "stokes" the sums of I, Q, U, V as |dS_k| <=
# lim_k * I; "squares" each sum of squares relative to its own plain value;
# "flux_emitted" and "flux_exit" relative to the plain value (0 when both
# are 0). AGREE holds radial grids, set from readings at 2^20 photons, seed
# 7; AGREE_3D holds 3-D grids, whose cone and half-plane roots flip more
# trajectories, set from readings at 2^18 photons, seed 7. Both on the
# chip_smoke.py cells (NVIDIA H100 80GB HBM3, 700 W); PERF.md section 2 has
# the readings.
AGREE = {"count": 1.2e-4, "count_quv": 1.2e-4, "pixel_I": 8e-4, "pixel_N": 4.2e-4,
         "capped": 3e-6, "n_error": 0.0, "error_codes": 0.0,
         "stokes": (3e-4, 5e-6, 1e-4, 1e-4),
         "squares": (4.2e-4, 3.2e-4, 7e-4, 7e-4), "flux_emitted": 6.5e-8, "flux_exit": 6e-6}
AGREE_3D = {"count": 1.6e-3, "count_quv": 1.6e-3, "pixel_I": 1e-2, "pixel_N": 6.5e-3,
            "capped": 1.2e-5, "n_error": 2.3e-5, "error_codes": 2.3e-5,
            "stokes": (9e-4, 9.5e-4, 6.5e-4, 1e-4),
            "squares": (2.1e-3, 2.3e-3, 5.5e-3, 7e-4), "flux_emitted": 6.5e-8, "flux_exit": 7e-5}

_vp = ctypes.c_void_p
_ARGTYPES = ([_vp] * 10 + [ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_uint]
             + [ctypes.c_int] * 5 + [_vp] * 4 + [ctypes.c_int, ctypes.c_int, _vp])
_ARGTYPES_3D = ([_vp] * 3 + [ctypes.c_uint] * 3 + [ctypes.c_int] * 3 + [_vp] * 4
                + [ctypes.c_int, ctypes.c_int, _vp])


def check_kernel(static: KernelStatic) -> None:
    """Raise ``NotImplementedError`` for what only the plain version runs:
    the Stokes-anomaly check and scattering switched off (in the JAX package
    too the TPU kernel covers neither, ``pallas_stream.supports``)."""
    if static.debug_stokes or not static.photon_scattering:
        raise NotImplementedError("--debug-stokes and photon:scattering=off run the plain "
                                  "version only: use --device cpu")


def supports(tables: TransportTables, static: KernelStatic) -> bool:
    """True when a kernel covers this configuration in float32."""
    try:
        check_slice(tables, static)
        check_kernel(static)
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
    n = int(plain_out["n_emitted"])
    codes = (kernel_out["error_codes"].cpu() - plain_out["error_codes"].cpu()).abs().max()
    return {"count": _rel(tot_d[0, 2], tot_p[0, 2]),
            "count_quv": max(_rel(tot_d[c, 2], tot_p[c, 2]) for c in (1, 2, 3)),
            "pixel_I": _rel(diff[:, 0, 0].abs().sum(), p[:, 0, 0].abs().sum()),
            "pixel_N": _rel(diff[:, 0, 2].abs().sum(), p[:, 0, 2].sum()),
            "capped": capped / n,
            "n_error": abs(int(kernel_out["n_error"]) - int(plain_out["n_error"])) / n,
            "error_codes": int(codes) / n,
            "stokes": (tot_d[:, 0] / tot_p[0, 0].abs()).tolist(),
            "squares": [_rel(d, s) for d, s in zip(tot_d[:, 1], tot_p[:, 1])],
            "flux_emitted": _rel(float(kernel_out["flux_emitted"]) - float(plain_out["flux_emitted"]),
                                 plain_out["flux_emitted"]),
            "flux_exit": _rel(float(kernel_out["flux_exit"]) - float(plain_out["flux_exit"]),
                              plain_out["flux_exit"])}


def limits_of(tables: TransportTables) -> dict:
    """The limits that hold a configuration: :data:`AGREE` on a radial
    grid, :data:`AGREE_3D` on a 3-D one."""
    return AGREE if tables.jump is None else AGREE_3D


def agrees(g: dict, limits: dict = AGREE) -> bool:
    """True when every gap of :func:`gaps` is within ``limits`` (a NaN gap
    is not)."""
    return all(all(x <= lim for x, lim in zip(g[key], limits[key]))
               if isinstance(limits[key], tuple) else g[key] <= limits[key]
               for key in limits)


def _library(name: str, argtypes, layout: tuple):
    """The launch function of ``csrc/<name>.cu``, built at first use; its
    table sizes must be the wrapper's."""
    lib = _build.load(name)
    fn = getattr(lib, f"artes_{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        sizes = (ctypes.c_int * len(layout))()
        get = getattr(lib, f"artes_{name}_layout")
        get.argtypes = [ctypes.POINTER(ctypes.c_int)]
        get.restype = ctypes.c_int
        get(sizes)
        if tuple(sizes) != layout:
            raise RuntimeError(f"{name} layout {tuple(sizes)} does not match the wrapper")
    return fn


def _scalars(t: TransportTables, static: KernelStatic) -> torch.Tensor:
    """The kernels' scalar table (layout of ``enum S_*`` in pool_common.cuh)."""
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
    g = t.grid
    nr, nt, np_ = g.nr, g.ntheta, g.nphi
    nc = nr * nt * np_
    shapes = {"rfront": (g.rfront, (nr + 1,)), "theta_cos": (g.theta_cos, (nt + 1,)),
              "theta_tan": (g.theta_tan, (nt + 1,)), "phi_sin": (g.phi_sin, (np_,)),
              "phi_cos": (g.phi_cos, (np_,)),
              "opacity": (t.opacity, (nc,)), "albedo": (t.albedo, (nc,)),
              "scatter_rows": (t.scatter_rows, (nc * 180, 16)),
              "alpha_prefix": (t.alpha_prefix, (nc, 4, 181)), "p_int": (t.p_int, (nc, 4)),
              "emis_cum": (t.emis_cum, (nc,)), "cell_weight": (t.cell_weight, (nc,))}
    if t.jump is not None:
        j = t.jump
        shapes.update({"kbar": (j.kbar, (nr,)), "dk": (j.dk, (nc,)),
                       "dr": (j.dr, (nr - 1, nt * np_)), "dtt": (j.dtt, (nt - 1, nr * np_)),
                       "dpp": (j.dpp, (np_, nr * nt)), "rf2": (j.rf2, (nr - 1,))})
    elif nt != 1 or np_ != 1:
        raise ValueError("a 3-D grid needs its jump tables (tables.build_tables makes them)")
    for name, (x, shape) in shapes.items():
        if x.dtype != torch.float32:
            raise ValueError(f"run_stream_cuda runs float32 tables; {name} is {x.dtype}")
        if x.device != dev or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous {shape} tensor on {dev}, "
                             f"got {tuple(x.shape)} on {x.device}")
    if nc * 180 * 16 >= 1 << 31:
        raise ValueError(f"{nc} cells overflow the kernel's 32-bit table offsets")
    return nr


def _decode_records(rec: torch.Tensor) -> torch.Tensor:
    """The 3-D kernel's float32 record rows as float64 rows in photon-id
    order; column 1 holds the photon id's bit pattern."""
    out = rec.to(torch.float64)
    out[:, 1] = (rec[:, 1].contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
                 ).to(torch.float64)
    return out[torch.argsort(out[:, 1], stable=True)].cpu()


def _launch_3d(t: TransportTables, static: KernelStatic, scal, consts, n, key_hi, id_lo,
               variant, flags, img_d, img_i, out_d, out_i, blocks, stream):
    """Launch ``pool_grid3d``; returns ``(rc, rec, rec_count)``."""
    g, j = t.grid, t.jump
    dev = t.opacity.device
    fn = _library("pool_grid3d", _ARGTYPES_3D,
                  (N_SCAL, N_OUT_D, N_OUT_I3, N_IMG_D, N_IMG_I, ERR_RECORD_W))
    theta_flags = (g.thetaplane_cone.to(torch.int32) | (g.theta_above.to(torch.int32) << 1)
                   ).contiguous()
    rec = torch.zeros((REC_CAP, ERR_RECORD_W), dtype=torch.float32, device=dev)
    rec_count = torch.zeros(1, dtype=torch.int32, device=dev)
    # the order of the Tables and Grid3 fields in pool_grid3d.cu
    ptrs = [g.rfront, t.opacity, t.albedo, t.scatter_rows, t.alpha_prefix, t.p_int, consts,
            scal, t.emis_cum, t.cell_weight, g.theta_tan, g.theta_cos, theta_flags, g.phi_sin,
            g.phi_cos, G.phi_fronts(g).contiguous(), j.kbar, j.dk, j.dr, j.dtt, j.dpp, j.rf2,
            rec, rec_count]
    tables = (ctypes.c_void_p * len(ptrs))(*[x.data_ptr() for x in ptrs])
    sizes = (ctypes.c_int * 8)(g.nr, g.ntheta, g.nphi, int(t.cell_depth),
                               int(static.max_crossings), REC_CAP, static.nx, static.ny)
    eps = (ctypes.c_float * 3)(g.same_eps, g.sel2, g.boundary_tol)
    rc = fn(ctypes.addressof(tables), ctypes.addressof(sizes), ctypes.addressof(eps), n, key_hi,
            id_lo, int(static.max_scatter), variant, flags, img_d.data_ptr(), img_i.data_ptr(),
            out_d.data_ptr(), out_i.data_ptr(), blocks, THREADS, stream)
    return rc, rec, rec_count


def run_stream_cuda(tables: TransportTables, static: KernelStatic, n_photons: int,
                    seed: int, id_hi: int = 0, id_lo: int = 0, err_k: int = ERR_RECORD_K):
    """Transport photons ``id_lo .. id_lo + n_photons - 1`` (high id word
    ``id_hi``) through the CUDA kernel of the tables' grid; returns the
    tallies of :func:`~artes_tpu_torch.transport.kernel.run_stream` as device
    tensors (the error records on the CPU). The id range must not cross a
    2^32 boundary."""
    check_slice(tables, static)
    check_kernel(static)
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
    grid3d = t.jump is not None
    out_d = torch.zeros(N_OUT_D, dtype=torch.float64, device=dev)
    out_i = torch.zeros(N_OUT_I3 if grid3d else N_OUT_I, dtype=torch.int64, device=dev)
    img_d = torch.zeros((npix if image else 1, N_IMG_D), dtype=torch.float64, device=dev)
    img_i = torch.zeros((npix if image else 1, N_IMG_I), dtype=torch.int64, device=dev)
    records = torch.zeros((0, ERR_RECORD_W), dtype=torch.float64)
    if n > 0:
        scal = _scalars(t, static)
        consts = _constants(dev)
        flags = (F_CRESCENT if static.crescent else 0) | \
            (F_BIASED if static.photon_emission == 2 else 0)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        blocks = min(-(-n // THREADS), sms * BLOCKS_PER_SM)
        key_hi = R.key_hi(seed, id_hi)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            if grid3d:
                rc, rec, rec_count = _launch_3d(t, static, scal, consts, n, key_hi, int(id_lo),
                                                variant, flags, img_d, img_i, out_d, out_i,
                                                blocks, stream)
            else:
                fn = _library("pool_radial", _ARGTYPES,
                              (N_SCAL, N_OUT_D, N_OUT_I, N_IMG_D, N_IMG_I))
                rc = fn(t.grid.rfront.data_ptr(), t.opacity.data_ptr(), t.albedo.data_ptr(),
                        t.scatter_rows.data_ptr(), t.alpha_prefix.data_ptr(),
                        t.p_int.data_ptr(), consts.data_ptr(), scal.data_ptr(),
                        t.emis_cum.data_ptr(), t.cell_weight.data_ptr(), nr, n, key_hi,
                        int(id_lo), int(static.max_scatter), variant, flags, static.nx,
                        static.ny, img_d.data_ptr(), img_i.data_ptr(), out_d.data_ptr(),
                        out_i.data_ptr(), blocks, THREADS, stream)
        name = (VARIANTS_3D if grid3d else VARIANTS)[variant]
        if rc != 0:
            raise RuntimeError(f"{name} launch failed: cudaError {rc}")
        LAUNCHES[name] += 1
        if grid3d:
            kept = min(int(rec_count), REC_CAP)         # waits for the kernel
            records = _decode_records(rec[:kept])
    if image:
        sums, counts = img_d.reshape(npix, 2, 4).transpose(1, 2), img_i
    else:
        sums = out_d[:8].reshape(1, 2, 4).transpose(1, 2)
        counts = torch.stack([out_i[0] + out_i[3], out_i[0]]).reshape(1, 2)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    if grid3d:
        # a radial grid's closed form has no failure modes: zeros there
        n_error, codes = out_i[4], torch.cat([out_i[5:8], zero.reshape(1)])
    else:
        n_error, codes = zero, torch.zeros(4, dtype=torch.int64, device=dev)
    return {
        "detector": detector_from_tallies(sums, counts),
        "flux_emitted": out_d[8],
        "flux_exit": out_d[9],
        "n_error": n_error,
        "error_codes": codes,
        "n_stokes_anomaly": zero,
        "n_alive_at_cap": out_i[1],
        "n_emitted": out_i[2],
        "error_records": select_error_records([records], err_k),
        "n_error_records": int(n_error) if grid3d and n > 0 else 0,
    }
