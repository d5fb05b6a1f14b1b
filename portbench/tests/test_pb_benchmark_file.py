"""BENCHMARK.json: its keys and names, and every cell resolving to its files."""

import json
import pathlib
import re

import pytest

from portbench import inputs, run

ROOT = pathlib.Path(run.ROOT)
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        names.append(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_workload_resolves(workload):
    """Each cell finds its configuration, traffic, check limits and a reader
    for every metric it reports, and builds its atmosphere."""
    cell = run.Cell.load(workload)
    assert cell.chips == 1
    assert cell.traffic["photons_per_job"] > 0
    assert set(cell.check["limits"]) == {"tally_z", "peels_gap", "photometry_gap"}
    for m in cell.end_to_end + cell.per_layer:
        assert run.metric_reader(m["name"]).is_file()
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    assert cell.config["epsilon_pol"] > 0
    arrays = inputs.atmosphere_arrays(cell.config)
    assert arrays["k_sca"].shape[-1] == len(cell.config["wavelengths_um"])
    assert all(0 <= wl < len(cell.config["wavelengths_um"]) for wl, _ in cell.views())


def test_per_layer_metric_cells_report_what_it_moves():
    cells = {w["name"]: run.Cell.load(w["name"]) for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        for name in m.get("workloads", []):
            assert m["moves"] in {e["name"] for e in cells[name].end_to_end}
            assert m["name"] in {p["name"] for p in cells[name].per_layer}
