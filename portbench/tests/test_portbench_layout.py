"""BENCHMARK.json against the limits of its format (names, units, sizes,
bounds), and every name in it resolved to its files."""

import json
import re
import subprocess
import sys

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
REPO = harness.REPO
BENCH = harness.benchmark()
ENTRY_API = ("setup", "draw", "make", "call", "work", "keep", "reference", "check")


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and BENCH["command"] == ["python3", "portbench/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200 and 1 <= cells <= 24
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024


def test_names_units_and_text():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    texts = [w["why"] for w in BENCH["workloads"]] + [c["why"] for c in BENCH["configs"]] + [c["source"] for c in BENCH["configs"]]
    texts += [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t, t
    assert len({c["name"] for c in BENCH["configs"]}) == len(BENCH["configs"])
    assert len({w["name"] for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(BENCH["workloads"])


def test_metrics_and_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m["workloads"]) <= {w["name"] for w in BENCH["workloads"]}
    for w in BENCH["workloads"]:
        e, layer = harness.metrics_of(BENCH, w["name"])
        reported = {m["name"] for m in e}
        assert "setup_s" in reported and len(reported) >= 2 and layer, w["name"]
        assert all(m["moves"] in reported for m in layer), w["name"]


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_by_name(name):
    cell = harness.Cell(name, BENCH)
    assert all(callable(getattr(cell.entry, f, None)) for f in ENTRY_API)
    assert all(callable(getattr(r, "read", None)) for r in cell.readers.values())
    assert {"warm_calls", "check_calls", "trace_calls", "limits"} <= set(cell.wl)
    assert cell.wl["warm_calls"] > cell.wl["check_calls"]
    cfg_spec = next(c for c in BENCH["configs"] if c["name"] == cell.spec["config"])
    assert cell.cfg["name"] == cfg_spec["name"] and cell.cfg["reduced"] == cfg_spec["reduced"]
    assert cfg_spec["file"].startswith("portbench/")


def test_every_config_is_used_and_files_are_named_from_names():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for p in (REPO / "portbench").rglob("*"):
        if p.is_file() and "__pycache__" not in p.parts:
            assert re.match(r"^[A-Za-z0-9_./\-]+$", str(p.relative_to(REPO))), p


def test_a_cell_added_as_files_alone_is_found(tmp_path):
    """A copy of the benchmark with one more workload file, one more
    per-layer metric file that reads a counter around each call, and their
    entries in BENCHMARK.json: the harness finds and runs both without an
    edit."""
    import shutil

    shutil.copytree(REPO / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "sw573.narrow", "config": "sw573", "traffic": "narrow", "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "sw573.sweep" in m.get("workloads", []):
            m["workloads"].append("sw573.narrow")
    bench["per_layer"].append({"name": "counted_ms", "unit": "ms", "better": "lower", "source": "program_counter", "layer": "entry",
                               "moves": "points_per_s.kernel_bound", "workloads": ["sw573.narrow"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "portbench/metrics/counted_ms.py").write_text(
        "import time\n\n\ndef counters():\n    return {'ns': time.perf_counter_ns}\n\n\n"
        "def read(ctx):\n    return sum(c['counters']['ns'] for c in ctx.calls) / len(ctx.calls) / 1e6\n")
    wl = json.loads((REPO / "portbench/workloads/sw573.sweep.json").read_text())
    wl.update(points=128, jitter=0.001, trace_calls=2)
    (tmp_path / "portbench/workloads/sw573.narrow.json").write_text(json.dumps(wl))
    code = ("import sys, json, time; sys.path[:0] = [sys.argv[1], sys.argv[2]]; from portbench import harness; "
            "assert harness.REPO == __import__('pathlib').Path(sys.argv[1]); "
            "[print(json.dumps(harness.run('sw573.narrow', 7, 0.2, t, time.perf_counter(), device='cpu'))) for t in (False, True)]")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path), str(REPO)], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    untraced, traced = (json.loads(line) for line in out.stdout.strip().splitlines()[-2:])
    assert untraced["correct"] and set(untraced["metrics"]) == {"points_per_s.kernel_bound", "setup_s"}
    assert traced["correct"] and traced["metrics"]["counted_ms"]["value"] > 0
