"""The kernel gate's limits and the rule that sets them, on the CPU.

``pool_cuda.limits_from`` sets each key of a table to min(old, max(3 x the
worst reading, floor)); ``python -m artes_tpu_torch.measure gate`` applies it
to readings on the card. Here: the rule on synthetic readings, every limit
at or below the one it replaced (the former tables, written out below), each
limit refusing a gap just above it and passing one at it, and the BASELINE
chains' configurations of ``cells.CHAIN_CELLS`` equal to the tables the
chains transport.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from artes_tpu_torch import baselines, cells, runner
from artes_tpu_torch.transport import pool_cuda
from torch_threads import one_thread  # noqa: F401

# the former limits, set from single readings while nvcc still contracted the
# kernels' multiply-adds, before limits_from's rule
FORMER_AGREE = {"count": 1.2e-4, "count_quv": 1.2e-4, "pixel_I": 8e-4, "pixel_N": 4.2e-4,
              "pixel_V": 0.0, "capped": 3e-6, "n_error": 0.0, "error_codes": 0.0,
              "stokes": (3e-4, 5e-6, 1e-4, 1e-4), "squares": (4.2e-4, 3.2e-4, 7e-4, 7e-4),
              "flux_emitted": 6.5e-8, "flux_exit": 6e-6, "flow_global": 1.7e-4,
              "flow_theta": 4e-4, "stokes_anomaly": 0.0}
FORMER_AGREE_3D = {"count": 1.6e-3, "count_quv": 1.6e-3, "pixel_I": 1e-2, "pixel_N": 6.5e-3,
                 "pixel_V": 2e-6, "capped": 1.2e-5, "n_error": 2.3e-5, "error_codes": 2.3e-5,
                 "stokes": (9e-4, 9.5e-4, 6.5e-4, 1e-4),
                 "squares": (2.1e-3, 2.3e-3, 5.5e-3, 7e-4), "flux_emitted": 6.5e-8,
                 "flux_exit": 7e-5, "flow_global": 0.0, "flow_theta": 0.0, "stokes_anomaly": 0.0}
FORMER_AGREE_MARCH = {"count": 1.1e-2, "count_quv": 1.2e-2, "pixel_I": 3e-3, "pixel_N": 1.1e-2,
                    "pixel_V": 0.0, "capped": 1.6e-3, "n_error": 9.2e-4, "error_codes": 1.7e-3,
                    "stokes": (2.8e-3, 3.2e-3, 2.2e-3, 1e-4),
                    "squares": (3.7e-3, 8.1e-3, 8.9e-3, 7e-4), "flux_emitted": 6.5e-8,
                    "flux_exit": 2.4e-4, "flow_global": 8.3e-2, "flow_theta": 5.5e-3,
                    "stokes_anomaly": 0.0}
FORMER_LIMITS = {"closed": FORMER_AGREE, "jumps": FORMER_AGREE_3D, "march": FORMER_AGREE_MARCH}


def zero_gaps() -> dict:
    return {key: (0.0,) * len(lim) if isinstance(lim, tuple) else 0.0
            for key, lim in pool_cuda.AGREE.items()}


def with_gap(key, i, value) -> dict:
    g = zero_gaps()
    if isinstance(g[key], tuple):
        g[key] = tuple(value if j == i else 0.0 for j in range(len(g[key])))
    else:
        g[key] = value
    return g


def components(table):
    """``(key, index or None, limit)`` of every limit of a table."""
    for key, lim in table.items():
        if isinstance(lim, tuple):
            yield from ((key, i, x) for i, x in enumerate(lim))
        else:
            yield key, None, lim


def test_rule_takes_three_times_the_worst_reading_within_its_floor_and_the_old_limit():
    old = dict(FORMER_AGREE_MARCH)
    floors = {key: 1e-9 for key in old} | {"count": 2e-6}
    readings = [with_gap("count", None, 1e-5), with_gap("count", None, 4e-5),
                with_gap("stokes", 1, 2e-4) | {"flux_exit": 3e-10},
                with_gap("squares", 2, 1.0)]
    new = pool_cuda.limits_from(readings, old, floors)
    assert new["count"] == 3 * 4e-5                        # 3 x the worst of two readings
    assert new["stokes"] == (1e-9, 3 * 2e-4, 1e-9, 1e-9)   # per component; unread: the floor
    assert new["flux_exit"] == 1e-9                        # 3 x 3e-10 below the sum floor
    assert new["squares"][2] == old["squares"][2]          # never above the old limit
    assert new["stokes_anomaly"] == new["pixel_V"] == 0.0  # 0 stays 0
    assert new["count_quv"] == 1e-9
    low = pool_cuda.limits_from([with_gap("count", None, 1e-7)], old, floors)
    assert low["count"] == 2e-6                            # the event floor
    assert pool_cuda.limits_from([with_gap("count", None, math.nan)], old, floors)["count"] \
        == old["count"]                                    # NaN reads as infinite


def test_floors_are_three_events_where_they_weigh_most():
    counts = [{"peels": 1e6, "peels_quv": 8e5, "emitted": 2.0 ** 20},
              {"peels": 3e5, "peels_quv": 0.0, "emitted": 2.0 ** 16}]
    floors = pool_cuda.floors_of(counts)
    assert floors["count"] == floors["pixel_N"] == 3 / 3e5
    assert floors["count_quv"] == 3 / 8e5                  # a denominator of 0 left out
    for key in ("capped", "n_error", "error_codes", "stokes_anomaly"):
        assert floors[key] == 3 / 2.0 ** 16
    for key in ("pixel_I", "pixel_V", "stokes", "squares", "flux_emitted", "flux_exit",
                "flow_global", "flow_theta"):
        assert floors[key] == pool_cuda.SUM_FLOOR == 1e-9
    assert pool_cuda.event_counts({"detector": torch.tensor([[[1.0, 1.0, 5.0], [0, 0, 4.0],
                                                               [0, 0, 4.0], [0, 0, 4.0]]]),
                                   "n_emitted": 7}) == {"peels": 5.0, "peels_quv": 4.0,
                                                        "emitted": 7.0}


@pytest.mark.parametrize("walk", sorted(FORMER_LIMITS))
def test_no_limit_above_its_former_value(walk):
    table, old = pool_cuda.LIMITS[walk], FORMER_LIMITS[walk]
    assert table.keys() == old.keys()
    for (key, i, lim), (_, _, was) in zip(components(table), components(old)):
        assert 0.0 <= lim <= was, (walk, key, i)
        assert was > 0.0 or lim == 0.0


@pytest.mark.parametrize("walk", sorted(FORMER_LIMITS))
def test_each_limit_refuses_a_gap_just_above_it(walk):
    table = pool_cuda.LIMITS[walk]
    assert pool_cuda.agrees(zero_gaps(), table)
    for key, i, lim in components(table):
        assert pool_cuda.agrees(with_gap(key, i, lim), table), (walk, key, i)
        above = with_gap(key, i, float(np.nextafter(lim, np.inf)))
        assert not pool_cuda.agrees(above, table), (walk, key, i)
        assert pool_cuda.worst_ratio(above, table) > 1.0
        assert not pool_cuda.agrees(with_gap(key, i, math.nan), table)


def _equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        return type(a) is type(b) and all(_equal(getattr(a, f.name), getattr(b, f.name))
                                          for f in dataclasses.fields(a))
    if isinstance(a, tuple):
        return isinstance(b, tuple) and len(a) == len(b) and all(map(_equal, a, b))
    return a == b


def test_chain_configurations_are_what_the_chains_transport(monkeypatch):
    """Run #1, #2 (at its two checked angles) and #5 on the CPU at a few
    photons and keep every ``(tables, static)`` their transport got: each
    configuration of ``cells.CHAIN_CELLS`` is one of them."""
    seen = []
    run_stream = runner.run_stream

    def spy(tables, static, *args, **kw):
        seen.append((tables, static))
        return run_stream(tables, static, *args, **kw)

    monkeypatch.setattr(runner, "run_stream", spy)
    monkeypatch.setattr(runner, "PHASE_ANGLES_DEG", (97.5, 177.5))
    monkeypatch.setattr(baselines, "say", lambda *a, **k: None)
    baselines.chain_1(photons=64, device="cpu")
    baselines.chain_2(photons=64, device="cpu")
    baselines.chain_5(photons=64, device="cpu", photons_b=64)
    assert set(cells.CHAIN_CELLS) == {"baseline1_0.50um", "baseline2_97.5deg",
                                      "baseline2_177.5deg", "baseline5_700K"}
    for name, make in cells.CHAIN_CELLS.items():
        tables, static = make("cpu")
        assert any(_equal(tables, t) and static == s for t, s in seen), name
    # 177.5 deg is the gate cell hg_crescent
    assert _equal(cells.CHAIN_CELLS["baseline2_177.5deg"]("cpu"),
                  cells.KERNEL_CELLS["hg_crescent"]("cpu"))
