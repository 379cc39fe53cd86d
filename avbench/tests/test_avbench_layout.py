"""BENCHMARK.json against its contract, and every file it names found by
name."""

import hashlib
import os
import re

import pytest

from avbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "avbench/run.py"]
    assert BENCH["paths"] == ["avbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) \
        <= 64 << 10


def test_names_units_and_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("avbench/")
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert w["name"] == f"{w['config']}.{w['traffic']}"
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for n in names + CELLS:
        assert NAME.match(n), n
    assert len(set(names + CELLS)) == len(names + CELLS)


def test_end_to_end_bounds_and_sources():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for cell in CELLS:
        got = [m["name"] for m in spec.metrics_of(BENCH, "end_to_end", cell)]
        assert "setup_s" in got and len(got) >= 2
        assert spec.metrics_of(BENCH, "per_layer", cell)


def test_per_layer_moves_a_metric_its_cells_report():
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        for cell in m["workloads"]:
            reported = [e["name"] for e in
                        spec.metrics_of(BENCH, "end_to_end", cell)]
            assert m["moves"] in reported, (m["name"], cell)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_config_generator_and_streams_found_by_name(cell):
    w = spec.workload(BENCH, cell)
    c = spec.cell(cell)
    assert c["config"] == w["config"] and c["traffic"] == w["traffic"]
    assert c["chips"] == w["chips"]
    gen = spec.generator(c["generator"])
    assert callable(gen.warm) and callable(gen.window)
    cfg = spec.config(BENCH, w["config"])
    entry = spec.config_entry(BENCH, w["config"])
    assert cfg["source"] == entry["source"]
    assert sorted(cfg["reduced"]) == sorted(entry["reduced"])
    for s in cfg["streams"]:
        with open(os.path.join(spec.ROOT, s["file"]), "rb") as f:
            data = f.read()
        assert len(data) == s["bytes"]
        assert hashlib.md5(data).hexdigest() == s["md5"]
    for e2e in spec.metrics_of(BENCH, "end_to_end", cell):
        assert e2e["name"] == "setup_s" or e2e["name"] in c["metrics"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_reader_found_by_name(metric):
    mod = spec.reader(metric)
    assert callable(mod.install) and callable(mod.read)


def test_missing_names_raise():
    with pytest.raises(KeyError):
        spec.workload(BENCH, "no.such_cell")
    with pytest.raises(FileNotFoundError):
        spec.reader("no.such_metric")
