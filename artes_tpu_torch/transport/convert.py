"""Carry the JAX package's transport tables across to this package.

``tables_from_jax`` turns a JAX ``TransportTables`` (numpy or jax leaves)
into this package's tables on a given device and dtype, and
``static_from_jax`` does the same for ``KernelStatic``. With them the tests
feed both packages identical tables. Nothing here imports jax: the leaves
are read through ``numpy.asarray``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from artes_tpu_torch.transport import jumps as J
from artes_tpu_torch.transport.geometry import GridGeometry
from artes_tpu_torch.transport.kernel import KernelStatic, TransportTables


def _leaf(x, dtype, device):
    a = np.array(x, order="C")
    if a.dtype == np.bool_:
        return torch.as_tensor(a, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a.astype(np.int64), device=device)
    return torch.as_tensor(a.astype(np.float64), dtype=dtype, device=device)


def _convert(obj, cls, dtype, device, **extra):
    fields = {}
    for f in dataclasses.fields(cls):
        if f.name in extra:
            continue
        v = getattr(obj, f.name)
        fields[f.name] = v if isinstance(v, (int, float)) else _leaf(v, dtype, device)
    return cls(**fields, **extra)


def tables_from_jax(tables, device="cpu", dtype=torch.float64) -> TransportTables:
    """This package's :class:`TransportTables` from a JAX one."""
    grid = _convert(tables.grid, GridGeometry, dtype, device)
    out = _convert(tables, TransportTables, dtype, device, grid=grid, jump=None)
    out.jump = J.jump_tables_of(grid, out.opacity)
    return out


def static_from_jax(static) -> KernelStatic:
    """This package's :class:`KernelStatic` from a JAX one (same fields)."""
    return KernelStatic(**{f.name: getattr(static, f.name)
                           for f in dataclasses.fields(KernelStatic)})
