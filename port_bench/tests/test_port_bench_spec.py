"""BENCHMARK.json against the shape its readers require, and every file a name
leads to."""

import json
import re

import pytest

from port_bench.spec import HERE, ROOT, load_cell, plugin

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["command"]) <= 32


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_names_units_and_lines():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    lines = ([x["why"] for x in BENCH["workloads"] + BENCH["configs"]]
             + [m["layer"] for m in BENCH["per_layer"]] + [c["source"] for c in BENCH["configs"]]
             + BENCH["command"])
    for s in lines:
        assert 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s, s
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = load_cell(cell)
    assert c.config["name"] == [w for w in BENCH["workloads"] if w["name"] == cell][0]["config"]
    assert set(c.limits) == {"frame_err_ratio", "flow_err_ratio"}
    assert {m["name"] for m in c.end_to_end} == {"frames_per_s", "pair_ms_p90", "peak_mib",
                                                 "setup_s"}
    assert c.per_layer
    for m in c.per_layer:
        assert callable(plugin("metrics", m["name"]).read)
    assert hasattr(plugin("drivers", c.traffic["driver"]), "Driver")


def test_each_config_file_is_its_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("port_bench/")
        assert data["source"] == c["source"] and data["reduced"] == c["reduced"] == []


def test_every_config_and_mix_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert (HERE / "traffic" / f"{w['traffic']}.json").exists()
        assert (HERE / "limits" / f"{w['name']}.json").exists()


def test_windowed_roofline_only_in_f720():
    (m,) = [m for m in BENCH["per_layer"] if m["name"] == "windowed_corr_roofline_pct"]
    assert m["workloads"] == ["f720_8x"]
    assert all(m["moves"] == "frames_per_s" for m in BENCH["per_layer"])
