"""``BENCHMARK.json`` loads, every name resolves to its files, and the
file keeps to the benchmark's contract."""
import json
import re

import pytest

from gssbench.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_lookup_by_name(manifest):
    w = manifest.workload("mesh2d-1024.solve-b32")
    assert (w["config"], w["traffic"], w["chips"]) == ("mesh2d-1024",
                                                       "solve-b32", 1)
    assert manifest.config("ecology2")["graph"]["family"] == "grid2d"
    assert manifest.traffic("resparsify")["kind"] == "resparsify"
    with pytest.raises(KeyError):
        manifest.workload("no-such-cell")


def test_metrics_by_cell(manifest):
    e2e = [m["name"] for m in manifest.end_to_end("mesh2d-1024.solve-b32")]
    assert e2e == ["setup_s", "solve_cols_per_s"]
    e2e = [m["name"] for m in manifest.end_to_end("ecology2.resparsify")]
    assert e2e == ["setup_s", "graph_to_solution_s"]
    layer = [m["name"] for m in manifest.per_layer("ecology2.resparsify")]
    assert "pcg.iters.resparsify" in layer
    assert "pcg.iters.solve" not in layer


@pytest.mark.parametrize("table", ["end_to_end", "per_layer"])
def test_every_metric_has_a_reader(manifest, table):
    for m in manifest.data[table]:
        assert callable(manifest.reader(m["name"]))


def test_every_cell_resolves(manifest):
    from gssbench.manifest import generator

    for w in manifest.data["workloads"]:
        config = manifest.config(w["config"])
        assert manifest.traffic(w["traffic"])["kind"] in (
            "closed_batch", "resparsify")
        assert callable(generator(config["graph"]["family"]).generate)
        names = {m["name"] for m in manifest.end_to_end(w["name"])}
        assert "setup_s" in names and len(names) >= 2
        assert manifest.per_layer(w["name"])


def test_contract():
    from gssbench.manifest import Manifest

    d = Manifest.load(ROOT).data
    assert set(d) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(d)) < 64 * 1024
    assert 1 <= d["run_seconds"] <= 51
    assert all((ROOT / p).is_dir() for p in d["paths"])
    assert all(not w.startswith("/") and ".." not in w for w in d["command"])
    cells = 2 + 14 * 24
    assert cells * (d["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = set()
    for c in d["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(d["paths"][0] + "/")
        assert (ROOT / c["file"]).is_file() and NAME.match(c["name"])
        names.add(c["name"])
    pairs = set()
    for w in d["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and NAME.match(w["name"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    cells = {w["name"] for w in d["workloads"]}
    e2e = {m["name"] for m in d["end_to_end"]}
    assert "setup_s" in e2e
    for m in d["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert set(m.get("workloads", cells)) <= cells
    for m in d["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert m["better"] in ("lower", "higher") and NAME.match(m["name"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        moved = next(e for e in d["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
