"""On the card: each cell's command as the benchmark runs it, short."""

import json
import subprocess
import sys

import pytest

from portbench import harness

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(cuda, name, trace):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", name, "--seed", str(2**31 + 11), "--seconds", "2", "--trace", str(trace)],
                         capture_output=True, text=True, timeout=900, cwd=harness.REPO)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    e2e, layer = harness.metrics_of(harness.benchmark(), name)
    assert set(r["metrics"]) == {m["name"] for m in (layer if trace else e2e)}
    if trace:
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
        for k, v in r["metrics"].items():
            assert not k.endswith("_pct") or 0 < v["value"] <= 100, (k, v)
