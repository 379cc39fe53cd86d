"""On the card: one short run of each cell, traced and not, through the
command BENCHMARK.json names. Skips without a CUDA card."""

import json
import subprocess

import pytest

from avbench import spec
from conftest import ROOT

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(card, cell, trace):
    bench = spec.benchmark()
    r = subprocess.run(bench["command"] + [
        "--workload", cell, "--seed", str(2 ** 33 + 3), "--seconds", "2",
        "--trace", str(trace)], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in spec.metrics_of(bench, kind, cell)}
    assert set(out["metrics"]) == want
    for m in out["metrics"].values():
        assert m["value"] > 0
        if m["unit"] == "%":
            assert m["value"] <= 105
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
