"""The harness's files and arithmetic, on the CPU."""
import ast
import json
import os
import re
import subprocess
import sys
import types

import pytest

from harness import readers, run, spec, trace

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_cells_name_their_files():
    for w in BENCH["workloads"]:
        c = spec.load_cell(w["name"])
        assert c.cell["config"] == w["config"] and c.cell["traffic"] == w["traffic"]
        assert c.cell["chips"] == w["chips"] == 1 and c.cell["why"] == w["why"]
        assert c.config["name"] == w["config"]
        assert set(c.cell["limits"]) == {"z_max", "z2_mean", "noise"}
    for cfg in BENCH["configs"]:
        assert os.path.exists(os.path.join(spec.ROOT, cfg["file"]))
        with open(os.path.join(spec.ROOT, cfg["file"])) as f:
            data = json.load(f)
        assert data["source"] == cfg["source"] and data["reduced"] == cfg["reduced"]
        assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


def test_metrics_move_what_their_cells_report():
    for m in BENCH["per_layer"]:
        for w in m["workloads"]:
            assert m["moves"] in {e["name"] for e in spec.load_cell(w).end_to_end}, (m, w)
    for w in BENCH["workloads"]:
        c = spec.load_cell(w["name"])
        names = {e["name"] for e in c.end_to_end}
        assert "setup_s" in names and len(names) >= 2 and c.per_layer


def test_names_and_units():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for entry in metrics + BENCH["workloads"] + BENCH["configs"]:
        assert NAME.match(entry["name"]), entry["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
    assert len({m["name"] for m in metrics}) == len(metrics)


def test_every_metric_has_its_reader():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(spec.reader(m["name"]).read), m["name"]


def test_layers_are_named_alike():
    """Metrics of one layer give it letter for letter; each layer is one line."""
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(0 < len(x) <= 200 and "\n" not in x for x in layers)
    assert len({x.lower() for x in layers}) == len(layers)


def test_device_union_and_gaps():
    events = [(0, 10, "a"), (5, 20, "b"), (30, 40, "a"), (35, 38, "memcpy"), (50, 55, "c")]
    busy, by_name, kernels, union = trace.device_summary(events)
    assert busy == 35 and union == [[0, 20], [30, 40], [50, 55]]
    assert by_name["a"] == [2, 20] and kernels == 4
    gaps = trace.idle_gaps(union, -5, 60)
    assert gaps == [(-5, 0), (20, 30), (40, 50), (55, 60)]
    labels = trace.label_gaps(gaps, {"frame": [(-10, 100)], "pt.regen": [(15, 45)]}, 0)
    assert labels[0] == ["pt.regen", 10e-9] and labels[1] == ["pt.regen", 10e-9]
    assert ["frame", 5e-9] in labels


def test_walk_roofline_arithmetic():
    assert readers.walk_floor_bytes(10, 5, 2, 100) == 10 * 48 + 5 * 36 + 2 * 100 * 36
    rate = readers.data("peaks.json")["hbm_bytes_per_s"]
    walk = readers.data("walk_kernels.json")["kernels"][0]
    rec = types.SimpleNamespace(
        prof={"events": [(0, 1000, walk + "(float const*)"), (1000, 3000, "gemm")],
              "host_start_ns": 0, "host_end_ns": 4000},
        marks=(({}, {}, 0, (0, 0)), ({}, {}, 3, (1000, 500))), n_tris=80000)
    floor_s = (1000 * 48 + 500 * 36 + 3 * 80000 * 36) / rate
    assert readers.walk_roofline_pct(rec) == pytest.approx(100 * floor_s / 1e-6)
    assert readers.walk_device_pct(rec) == pytest.approx(100 / 3)
    assert readers.device_idle_pct(rec) == pytest.approx(25.0)


def test_frame_seeds():
    s = 2 ** 31 + 12345
    seeds = [run.frame_seed(s, k) for k in range(4)]
    assert seeds == [run.frame_seed(s, k) for k in range(4)] and len(set(seeds)) == 4
    assert all(0 <= x < 2 ** 32 for x in seeds) and run.frame_seed(s + 1, 0) != seeds[0]


def test_no_jax_import():
    """No module under port_bench imports jax, jaxlib, flax or the JAX package;
    top-level names compared whole (the port's name begins with the JAX
    package's)."""
    bad = set(run.FORBIDDEN)
    for root, _, files in os.walk(spec.BENCH_DIR):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            with open(path) as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module]
                for n in names:
                    assert n.split(".")[0] not in bad, (path, n)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    for name in run.FORBIDDEN:
        monkeypatch.delitem(sys.modules, name, raising=False)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "tungsten_tpu_torch_x", types.ModuleType("x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert run.forbidden_modules() == ["jax"]


def test_no_card_no_result():
    """Without a CUDA card the command exits non-zero and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, os.path.join(spec.BENCH_DIR, "run.py"), "--workload",
                        "materialtest-pt", "--seed", "3000000000", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, env=env,
                       cwd=spec.ROOT, timeout=300)
    assert p.returncode != 0 and "metrics" not in p.stdout and not p.stdout.strip()
