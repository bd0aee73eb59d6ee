"""Find a cell of ``BENCHMARK.json`` and the files it names: the
configuration under ``configs/``, the traffic mix under ``traffic/`` and
the correctness limits under ``limits/``, each found by its name."""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List

HERE = Path(__file__).resolve().parents[1]          # valetbench/
ROOT = HERE.parent                                   # the checkout


@dataclass(frozen=True)
class Cell:
    name: str
    workload: Dict[str, Any]        # the BENCHMARK.json entry
    config: Dict[str, Any]          # configs/<config>.json
    traffic: Dict[str, Any]         # traffic/<traffic>.json
    limits: Dict[str, Any]          # limits/<cell>.json ({} when absent)
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def metrics_for(entries, cell_name):
    """The metrics of ``entries`` that this cell reports: those without a
    ``workloads`` key, and those that list the cell."""
    return [m for m in entries
            if "workloads" not in m or cell_name in m["workloads"]]


def load_cell(name: str, bench_path: Path = None) -> Cell:
    bench = load_json(bench_path or ROOT / "BENCHMARK.json")
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        names = ", ".join(w["name"] for w in bench["workloads"])
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {names}")
    w = found[0]
    cfg_entry = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    lim_path = HERE / "limits" / f"{name}.json"
    return Cell(
        name=name, workload=w,
        config=load_json(ROOT / cfg_entry["file"]),
        traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(lim_path) if lim_path.exists() else {},
        end_to_end=metrics_for(bench["end_to_end"], name),
        per_layer=metrics_for(bench["per_layer"], name))
