"""The photon axis over every card: the mesh launch.

Counterpart of ``artes_tpu.transport.pallas_stream.run_stream_pallas_mesh``
and ``artes_tpu.parallel.mesh``. The reference's only parallelism is one
loop over photons with per-thread detectors reduced at the end
(ARTES.f90:534-546, :959-975). Here every rank of a ``torch.distributed``
group takes a contiguous sub-range of a chunk's photon ids
(:func:`split_ids`), runs it through the kernel of the configuration on its
own card (``pool_cuda.run_stream_cuda``; on the CPU the plain
``kernel.run_stream``), and the tallies are summed over the ranks, the
counterpart of the JAX mesh's one ``psum`` over the tally tiles. A kernel
launch keeps every tally in one float64 and one int64 allocation
(``pool_cuda.result_of``), and the mesh sums those two with one
``all_reduce`` each (NCCL on cards), then takes the result's tallies as
views of the sums: nothing waits on the host until a caller reads a value.
A plain result is packed into the same two vectors first (gloo on the
CPU). The photon id, not the rank, keys the random numbers, so the counts
do not depend on the number of ranks and the sums only on the order of
their double additions. Each rank's error records travel as a fixed block
of the first and last ``ERR_RECORD_K`` by photon id (built on the card for a
kernel launch, ``pool_cuda.record_block``), gathered in the integer
``all_reduce`` and cut to the records a one-device run keeps.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch
import torch.distributed as dist

from artes_tpu_torch import _build
from artes_tpu_torch.transport import pool_cuda
from artes_tpu_torch.transport import rng as R
from artes_tpu_torch.transport.kernel import (ERR_RECORD_K, ERR_RECORD_W, run_batch,
                                              run_stream, select_error_records)

# the tallies of a run_stream result that add over photons, by type; each is
# summed where a result has it and it is not None
FLOAT_KEYS = ("detector", "flux_emitted", "flux_exit", "flow_global", "flow_theta", "flow_path")
INT_KEYS = ("n_error", "error_codes", "n_stokes_anomaly", "n_alive_at_cap", "n_emitted",
            "n_error_records", "n_cell_face", "n_flow_booked")
# a split run against one launch of the same photons: every photon is run by
# one thread from its id alone, so counts and records are equal and the float
# tallies differ by the order of their double additions only
SPLIT_RTOL = 1e-12
# calls of run_stream_mesh on this rank, each one launch of the rank's kernel
# and one reduction over the mesh
LAUNCHES = {"mesh": 0}


@dataclasses.dataclass
class Mesh:
    """The ranks of a ``torch.distributed`` group and this rank's device
    (``cuda:LOCAL_RANK`` or ``cpu``)."""
    group: object
    rank: int
    size: int
    device: torch.device
    local_rank: int = 0
    built: set = dataclasses.field(default_factory=set)     # kernel sources built and loaded


def make_mesh(device="cuda") -> Mesh:
    """The mesh of the initialised default group (``multihost.initialize``).
    A CUDA mesh runs on ``cuda:LOCAL_RANK`` and needs the NCCL backend; a
    CPU mesh reduces with the group's own backend (gloo)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialised torch.distributed default group: "
                           "call parallel.multihost.initialize() under a launcher")
    rank, size = dist.get_rank(), dist.get_world_size()
    local = int(os.environ.get("LOCAL_RANK", rank))
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh: torch finds no CUDA device")
        if dist.get_backend() != "nccl":
            raise RuntimeError(f"a CUDA mesh reduces over NCCL, not {dist.get_backend()}")
        if device.index is None:
            device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return Mesh(group=dist.group.WORLD, rank=rank, size=size, device=device, local_rank=local)


def split_ids(n_photons: int, seed: int, id_hi: int, id_lo: int, n_dev: int) -> np.ndarray:
    """``(n_dev, 3)`` uint32 ``[count, key_hi, start]`` a device: contiguous
    sub-ranges of the ids ``id_lo .. id_lo + n_photons - 1``, the first
    ``n_photons % n_dev`` one photon longer (``pallas_stream._device_si``).
    A chunk never crosses a 2^32 id boundary, so every sub-range shares the
    high word and its key ``rng.key_hi(seed, id_hi)``."""
    base, rem = divmod(int(n_photons), int(n_dev))
    counts = np.array([base + (d < rem) for d in range(n_dev)], np.int64)
    starts = np.concatenate([[0], np.cumsum(counts[:-1])]) + int(id_lo)
    hi = np.full(n_dev, R.key_hi(seed, id_hi), np.int64)
    return (np.stack([counts, hi, starts], axis=1) & R.MASK32).astype(np.uint32)


def round_up_batch(n: int, n_dev: int) -> int:
    return ((n + n_dev - 1) // n_dev) * n_dev


def _ensure_built(mesh: Mesh, source: str) -> None:
    """Local rank 0 builds ``csrc/<source>.cu``, the others wait and load
    what it built (every rank meets the barrier once a source)."""
    if source in mesh.built:
        return
    if mesh.local_rank == 0:
        _build.build(source)
    _barrier(mesh)
    _build.load(source)
    mesh.built.add(source)


def _barrier(mesh: Mesh) -> None:
    if mesh.device.type == "cuda":
        dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
    else:
        dist.barrier(group=mesh.group)


def run_stream_mesh(tables, static, n_photons: int, seed: int, id_hi: int, id_lo: int,
                    mesh: Mesh, width: int | None = None) -> dict:
    """This rank's sub-range of the ids ``id_lo .. id_lo + n_photons - 1``
    through the kernel of the tables' device (CUDA: ``run_stream_cuda``; CPU:
    the plain ``run_stream`` emitting ``width`` photons together), then the
    tallies summed over the mesh: every rank returns the result of the whole
    range, as one device would."""
    if tables.opacity.device != mesh.device:
        raise ValueError(f"tables on {tables.opacity.device}, mesh rank on {mesh.device}")
    count, _, start = (int(x) for x in
                       split_ids(n_photons, seed, id_hi, id_lo, mesh.size)[mesh.rank])
    if mesh.device.type == "cuda" and pool_cuda.supports(tables, static):
        _ensure_built(mesh, pool_cuda.kernel_of(tables, static)[0])
    out = _launch(tables, static, count, seed, id_hi, start, width, host_records=False)
    LAUNCHES["mesh"] += 1
    return all_reduce_outputs(out, mesh)


def _launch(tables, static, n, seed, id_hi, id_lo, width=None, plain=False,
            host_records=True):
    """One sub-range through the CUDA kernel (float32 CUDA tables; its error
    records left on the card without ``host_records``) or the plain version
    on the tables' device (CPU or float64 tables, or ``plain``)."""
    plain = plain or not pool_cuda.supports(tables, static)
    if tables.opacity.device.type == "cuda" and not plain:
        return pool_cuda.run_stream_cuda(tables, static, n, seed, id_hi, id_lo,
                                         host_records=host_records)
    return run_stream(tables, static, n, seed, width or max(1, min(n, 1 << 17)), id_hi, id_lo)


def sharded_dispatch(mesh: Mesh):
    """A drop-in for ``kernel.run_batch`` over the ranks of ``mesh``
    (``artes_tpu.parallel.mesh.sharded_dispatch``): each rank runs
    ``run_batch`` on its contiguous ``n / size`` slice of the ``(n,)``
    photon ids on its own device, and every output is summed over the mesh
    (:func:`all_reduce_outputs`: NCCL on cards, gloo on the CPU); every rank
    returns the sums. A batch that the world size does not divide raises
    ``ValueError``, as in JAX (:func:`round_up_batch` sizes one that it
    does). ``n_alive_at_cap`` is summed, as the JAX ``psum`` sums it."""

    def dispatch(tables, static, photon_ids, seed):
        if tables.opacity.device != mesh.device:
            raise ValueError(f"tables on {tables.opacity.device}, mesh rank on {mesh.device}")
        n = len(photon_ids)
        if n % mesh.size:
            raise ValueError(f"batch of {n} photons not divisible by {mesh.size} devices")
        share = n // mesh.size
        ids = photon_ids[mesh.rank * share:(mesh.rank + 1) * share]
        return all_reduce_outputs(run_batch(tables, static, ids, seed), mesh)

    return dispatch


def run_split(tables, static, n_photons: int, seed: int, n_dev: int, id_hi: int = 0,
              id_lo: int = 0, plain: bool = False, width: int | None = None) -> dict:
    """The mesh's arithmetic on one device: the ``n_dev`` sub-ranges of
    :func:`split_ids` launched one after another on the tables' device (the
    plain version with ``plain``) and merged by :func:`merge_outputs`."""
    return merge_outputs(_launch(tables, static, int(c), seed, id_hi, int(s), width, plain)
                         for c, _, s in split_ids(n_photons, seed, id_hi, id_lo, n_dev))


def _pack(out: dict, keys, dtype, device) -> torch.Tensor:
    parts = [torch.as_tensor(out[k]).to(device=device, dtype=dtype).reshape(-1) for k in keys]
    return torch.cat(parts) if parts else torch.zeros(0, dtype=dtype, device=device)


def pack_tallies(out: dict, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The summed tallies of a result as one float64 and one int64 vector on
    ``device``: the payload of the mesh's two ``all_reduce`` calls; a kernel
    launch's own two allocations where the result has them."""
    if "packed" in out:
        return out["packed"][1], out["packed"][2]
    fkeys, ikeys = _summed_keys(out)
    return _pack(out, fkeys, torch.float64, device), _pack(out, ikeys, torch.int64, device)


def _unpack(out: dict, keys, flat: torch.Tensor) -> dict:
    """``out`` with ``keys`` taken from ``flat``, each in its old shape, type
    and device (a Python int stays an int)."""
    res, at = dict(out), 0
    for k in keys:
        old = out[k]
        if isinstance(old, torch.Tensor):
            res[k] = flat[at:at + old.numel()].reshape(old.shape).to(old.device, old.dtype)
            at += old.numel()
        else:
            res[k] = type(old)(flat[at].item())
            at += 1
    return res


def _summed_keys(out: dict):
    present = [k for k in FLOAT_KEYS + INT_KEYS if out.get(k) is not None]
    return [k for k in present if k in FLOAT_KEYS], [k for k in present if k in INT_KEYS]


def _record_block(out: dict, device) -> torch.Tensor:
    """A result's error records as the fixed block the mesh gathers: row 0
    holds the number of rows kept (``pool_cuda.record_block``)."""
    if "record_block" in out:
        return out["record_block"]
    rec = torch.as_tensor(out["error_records"], dtype=torch.float64).cpu()
    block = torch.zeros((2 * ERR_RECORD_K + 1, ERR_RECORD_W), dtype=torch.float64)
    block[0, 0] = rec.shape[0]
    block[1:1 + rec.shape[0]] = rec
    return block.to(device)


def all_reduce_outputs(out: dict, mesh: Mesh) -> dict:
    """One rank's result summed over the mesh (the ``psum`` of
    ``pallas_stream._get_mesh_fn``) on the rank's device: the float tallies
    in one ``all_reduce``, the integer tallies in another, a kernel launch's
    own two allocations (copied, so ``out`` keeps its values) or a plain
    result's packed tallies. The second also gathers the error records: each
    rank puts its fixed ``(2 ERR_RECORD_K + 1, ERR_RECORD_W)`` block, as int64
    bit patterns, in its own slot behind the integer tallies, zeros
    elsewhere. The blocks merge in rank order, which is photon-id order. A
    kernel launch's tallies are views of the sums, read on the host by
    nobody here; only the gathered records come to the host."""
    dev = mesh.device
    if "packed" in out:
        layout, flat_f, flat_i = out["packed"]
        flat_f = flat_f.clone()
    else:
        flat_f, flat_i = pack_tallies(out, dev)
    block = _record_block(out, dev)
    n_i, n_b = flat_i.numel(), block.numel()
    ints = torch.zeros(n_i + mesh.size * n_b, dtype=torch.int64, device=dev)
    ints[:n_i] = flat_i
    ints[n_i + mesh.rank * n_b:n_i + (mesh.rank + 1) * n_b] = block.reshape(-1).view(torch.int64)
    dist.all_reduce(flat_f, group=mesh.group)
    dist.all_reduce(ints, group=mesh.group)
    blocks = ints[n_i:].view(torch.float64).reshape(mesh.size, *block.shape).cpu()
    records = select_error_records([b[1:1 + int(b[0, 0])] for b in blocks], ERR_RECORD_K)
    if "packed" in out:
        return pool_cuda.result_of(layout, flat_f, ints[:n_i], records)
    fkeys, ikeys = _summed_keys(out)
    res = _unpack(_unpack(out, fkeys, flat_f), ikeys, ints[:n_i])
    res["error_records"] = records
    return res


def split_gaps(got: dict, ref: dict) -> dict:
    """How a split run ``got`` differs from the one-launch run ``ref`` of the
    same photons: "counts" the largest difference of a count (the detector's
    count column and every integer tally), "records" 0 when the error
    records are identical and 1 when not, "values" the largest difference of
    a float tally (sums, squares, fluxes, flow) over its tally's largest
    magnitude."""
    fkeys, ikeys = _summed_keys(ref)

    def pair(k, cols=None):
        ts = [torch.as_tensor(o[k]).cpu().double() for o in (got, ref)]
        return [(t if cols is None else t[..., cols]).reshape(-1) for t in ts]

    counts = [pair("detector", 2)] + [pair(k) for k in ikeys]
    values = [pair("detector", slice(0, 2))] + [pair(k) for k in fkeys if k != "detector"]
    worst_value = 0.0
    for a, b in values:
        d, scale = float((a - b).abs().max()), float(b.abs().max())
        worst_value = max(worst_value, d / scale if scale else (0.0 if d == 0 else math.inf))
    same = torch.equal(*(torch.as_tensor(o["error_records"]).cpu().double() for o in (got, ref)))
    return {"counts": max(float((a - b).abs().max()) for a, b in counts),
            "records": 0 if same else 1, "values": worst_value}


def split_agrees(got: dict, ref: dict, rtol: float = SPLIT_RTOL) -> bool:
    """True when the split run ``got`` has every count and error record of
    ``ref`` and its float tallies within ``rtol`` (:func:`split_gaps`)."""
    g = split_gaps(got, ref)
    return g["counts"] == 0 and g["records"] == 0 and g["values"] <= rtol


def merge_outputs(outs) -> dict:
    """The results of consecutive id sub-ranges, in id order, merged on the
    host as :func:`all_reduce_outputs` merges them over a mesh."""
    outs = list(outs)
    fkeys, ikeys = _summed_keys(outs[0])
    res = {k: v for k, v in outs[0].items() if k not in ("packed", "record_block")}
    for k in fkeys + ikeys:
        total = outs[0][k]
        for o in outs[1:]:
            total = total + o[k]
        res[k] = total
    res["error_records"] = select_error_records(
        [torch.as_tensor(o["error_records"], dtype=torch.float64).cpu() for o in outs],
        ERR_RECORD_K)
    return res
