"""BENCHMARK.json against the benchmark's own files and the shape it must
have: every configuration, traffic mix, cell, metric and model family is a
file found by its name, the names, units and `moves` arrows agree, and each
family accepts its cells."""

import json
import re

import pytest

from portbench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
HERE = harness.HERE
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CONFIGS = {c["name"]: json.loads((harness.ROOT / c["file"]).read_text())
           for c in BENCH["configs"]}


def family(config):
    return config.get("family", harness.DEFAULT_FAMILY)


def cells_of(metric):
    return metric.get("workloads", CELLS)


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51 and isinstance(rs, int)
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"] == f"portbench/configs/{entry['name']}.json"
    data = CONFIGS[entry["name"]]
    assert data["source"] == entry["source"] and "assumed" in data
    assert entry["source"].startswith("https://")
    assert isinstance(entry["reduced"], list)
    assert set(entry["reduced"]) <= set(data)
    assert (HERE / "families" / f"{family(data)}.py").is_file()
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_agree(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    own = json.loads((HERE / "workloads" / f"{entry['name']}.json")
                     .read_text())
    for k in ("config", "traffic", "chips"):
        assert own[k] == entry[k]
    assert entry["chips"] == 1 and len(entry["why"]) <= 200
    cell = harness.load_cell(entry["name"])
    assert cell.family == family(CONFIGS[entry["config"]])
    harness.program_config(cell)
    harness.family_of(cell).check_cell(cell.config, cell.traffic["kind"],
                                       own["limits"])
    reported = [m for m in BENCH["end_to_end"]
                if entry["name"] in cells_of(m)]
    assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
    assert any(entry["name"] in cells_of(m) for m in BENCH["per_layer"])


def test_every_file_is_named():
    """No file in a data or reader folder that BENCHMARK.json does not
    name, and none missing."""
    want = {
        "configs": {c["name"] for c in BENCH["configs"]},
        "traffic": {w["traffic"] for w in BENCH["workloads"]},
        "workloads": set(CELLS),
        "end_to_end": set(E2E) - {"setup_s"},
        "metrics": {m["name"] for m in BENCH["per_layer"]},
        "families": {family(c) for c in CONFIGS.values()},
    }
    for folder, names in want.items():
        suffix = ".py" if folder in ("end_to_end", "metrics", "families") \
            else ".json"
        found = {p.name[:-len(suffix)] for p in (HERE / folder).iterdir()
                 if p.name.endswith(suffix)}
        assert found == names, folder


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert set(cells_of(metric)) <= set(CELLS)
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        moved = E2E[metric["moves"]]
        assert metric["moves"] != "setup_s"
        # every cell that reads the metric reports what it moves
        assert set(cells_of(metric)) <= set(cells_of(moved))
        assert "\n" not in metric["layer"] and len(metric["layer"]) <= 200
        if metric["unit"] == "%" and ("roofline" in metric["name"]
                                      or "mfu" in metric["name"]):
            assert metric["better"] == "higher"
        harness.load_reader("metrics", metric["name"])


def test_a_roofline_kernel_has_its_steps_mfu_beside_it():
    for m in BENCH["per_layer"]:
        if m["name"].endswith("roofline") or ".roofline." in m["name"]:
            assert any("mfu" in o["name"] and o["moves"] == m["moves"]
                       for o in BENCH["per_layer"])


def test_names_are_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [g["name"] for g in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_file_size():
    assert (harness.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
