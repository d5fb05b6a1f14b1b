"""Processes of a launcher: bring-up and wavelength ownership.

Counterpart of ``artes_tpu.parallel.multihost``. A launcher (``torchrun
--nproc-per-node N``, or the CLI's own spawn of one worker per card) sets
``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and
``LOCAL_RANK``; :func:`initialize` brings up ``torch.distributed`` from them
and is a no-op without them. The processes then share the photons of every
run (``parallel.mesh``), or own the wavelengths of a spectrum block-cyclically
(:func:`my_wavelength_indices`), which needs no communication but the final
gather of per-wavelength rows. Per-wavelength rows are idempotent, which is
the checkpoint story: a crashed run keeps every finished wavelength in
``spectrum.dat``, and the CLI's ``--resume`` runs the rest.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

LAUNCHER_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
# seconds a collective may wait for a peer before the group fails the run
TIMEOUT_S = 1800.0


def launched() -> bool:
    """True when the environment holds a launcher's rendezvous."""
    return all(k in os.environ for k in LAUNCHER_ENV)


def initialize(backend: str | None = None, timeout_s: float = TIMEOUT_S) -> bool:
    """Initialise the default process group from the launcher's environment
    (``backend``: ``nccl`` for cards, ``gloo`` for the CPU; by default
    ``nccl`` where torch sees a card). Returns False, and does nothing, when
    no launcher set the environment; True when the group is up."""
    if dist.is_initialized():
        return True
    if not launched():
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the nccl backend: torch finds no CUDA device")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", os.environ["RANK"])))
    dist.init_process_group(backend, init_method="env://",
                            world_size=int(os.environ["WORLD_SIZE"]),
                            rank=int(os.environ["RANK"]),
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def _rank_size():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def my_wavelength_indices(n_wavelength: int):
    """The wavelength indices this process owns, block-cyclic: long
    wavelengths, usually thinner and cheaper, spread over the processes."""
    rank, size = _rank_size()
    return list(range(rank, n_wavelength, size))


def is_coordinator() -> bool:
    return _rank_size()[0] == 0
