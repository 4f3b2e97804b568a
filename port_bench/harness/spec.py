"""What a run is asked to do, found by name: BENCHMARK.json at the root of the
checkout, the cell's file workloads/<name>.json, its configuration
configs/<config>.json, its traffic traffic/<traffic>.json and each metric's
reader metrics/<metric>.py. Adding a cell, a configuration, a traffic mix or
a metric is adding files and entries; no code here names one."""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT, "BENCHMARK.json")


@dataclass
class Cell:
    name: str
    cell: dict  # workloads/<name>.json
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    end_to_end: list  # BENCHMARK.json end_to_end entries this cell reports
    per_layer: list  # BENCHMARK.json per_layer entries this cell reports


def _reports(entry: dict, cell: str, e2e_names=None) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return e2e_names is None or entry["moves"] in e2e_names


def load_cell(name: str, bench: dict | None = None) -> Cell:
    bench = benchmark() if bench is None else bench
    cell = _json(BENCH_DIR, "workloads", name + ".json")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, cell, _json(BENCH_DIR, "configs", cell["config"] + ".json"),
                _json(BENCH_DIR, "traffic", cell["traffic"] + ".json"), e2e, per)


def reader(metric: str):
    """metrics/<metric>.py's read(record) -> a number, or None where the run
    gave it nothing to read. A metric split by the end-to-end metric it
    moves (`<name>.pt`, `<name>.sppm`) is read by metrics/<name>.py where it
    has no reader of its own. Its unit, layer and `moves` are
    BENCHMARK.json's alone."""
    path = os.path.join(BENCH_DIR, "metrics", metric + ".py")
    if not os.path.exists(path):
        path = os.path.join(BENCH_DIR, "metrics", metric.split(".")[0] + ".py")
    spec = importlib.util.spec_from_file_location("port_bench_metric_" + metric.replace(
        ".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
