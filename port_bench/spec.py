"""BENCHMARK.json and the files each of its names leads to.

A cell (`workloads` entry) names a configuration and a traffic mix. The
harness finds, by name and with no list of its own:
  * the configuration's file, as `configs[].file` gives it;
  * `traffic/<traffic>.json`, the mix;
  * `limits/<cell>.json`, the limits of the cell's correctness numbers;
  * `metrics/<metric>.py`, a reader of each per-layer metric;
  * `work/<kernel>.py`, each kernel's work formula (`work.py`);
  * `drivers/<driver>.py`, the window's driver that the mix names.
"""

from __future__ import annotations

import importlib
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str, end_to_end: list) -> bool:
    """Whether `cell` reports `metric`: the cells its `workloads` lists, or
    without the key every cell that reports the end-to-end metric it
    moves (end-to-end metrics without the key: every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return any(m["name"] == metric["moves"] and reports(m, cell, []) for m in end_to_end)
    return True


def load_cell(name: str, bench_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    bench = load_json(bench_path)
    (w,) = [w for w in bench["workloads"] if w["name"] == name] or [None]
    if w is None:
        raise KeyError(f"no workload {name!r} in {bench_path}")
    (c,) = [c for c in bench["configs"] if c["name"] == w["config"]]
    root = bench_path.parent
    return Cell(
        name=name,
        chips=w["chips"],
        config=load_json(root / c["file"]),
        traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(HERE / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if reports(m, name, [])],
        per_layer=[m for m in bench["per_layer"] if reports(m, name, bench["end_to_end"])],
    )


def plugin(kind: str, name: str):
    """The module `port_bench/<kind>/<name>.py`."""
    return importlib.import_module(f"port_bench.{kind}.{name}")
