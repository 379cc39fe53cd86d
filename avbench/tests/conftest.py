"""The benchmark's tests: CPU tests run anywhere; those marked `cuda`
find the card inside a fixture and skip without one."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the card (avbench/README.md)")
    return torch.device("cuda", 0)


@pytest.fixture
def test_bench():
    """BENCHMARK.json with the 64x64 test configuration and its cells
    added (CPU tests only; not a cell of the benchmark)."""
    from avbench import spec
    bench = spec.benchmark()
    bench = dict(bench, configs=bench["configs"] + [
        {"name": "h264_test_64x64", "source": "tests",
         "file": "avbench/tests/data/h264_test_64x64.json", "reduced": [],
         "why": "tests"}],
        workloads=bench["workloads"] + [
        {"name": "h264_test_64x64.chunked", "config": "h264_test_64x64",
         "traffic": "chunked", "chips": 1, "why": "tests"}])
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + ["h264_test_64x64.chunked"]
    return bench


TEST_CELLS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "cells")
