"""The run loop of each traffic kind at a tiny size on the CPU: the
result line's shape, its metrics, and ``correct`` from the reference."""
import json

import pytest

from gssbench.tests.conftest import BIG_SEED, run_tiny

CELLS = {"mesh2d-1024.solve-b32": {}, "ecology2.resparsify": {}}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_untraced_run(manifest, cell):
    r = run_tiny(manifest, cell, **CELLS[cell])
    assert list(r) == ["correct", "attempted", "failed", "metrics",
                       "device", "checks"]
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    want = {m["name"] for m in manifest.end_to_end(cell)}
    assert set(r["metrics"]) == want
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert r["device"]["platform"] == "cpu"
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())
    json.loads(json.dumps(r))


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_traced_run(manifest, cell):
    r = run_tiny(manifest, cell, trace=True, seconds=0.6, **CELLS[cell])
    assert r["correct"] and list(r)[-1] == "checks"
    names = set(r["metrics"])
    allowed = {m["name"] for m in manifest.per_layer(cell)}
    assert names <= allowed
    # on the CPU nothing of the device is read
    assert not any(n.startswith("device.") or n.endswith("_roofline")
                   for n in names)
    assert names, "every cell reads some per-layer metric on the host"
    assert r["device"]["window_s"] > 0 and r["device"]["busy_s"] == 0
    assert len(r["breakdown"]["idle_gaps"]) <= 10


def test_same_seed_same_inputs(manifest):
    a = run_tiny(manifest, "ecology2.resparsify", seed=BIG_SEED)
    b = run_tiny(manifest, "ecology2.resparsify", seed=BIG_SEED)
    c = run_tiny(manifest, "ecology2.resparsify", seed=BIG_SEED + 1)
    assert a["checks"]["max_relres"] == b["checks"]["max_relres"]
    assert a["checks"]["max_relres"] != c["checks"]["max_relres"]


def test_window_is_whole_batches(manifest):
    from gssbench import harness
    from gssbench.tests.conftest import tiny

    config, tr = tiny(manifest, "mesh2d-1024.solve-b32", 16)
    r = harness.run_cell(manifest, "mesh2d-1024.solve-b32", 3, 1e-9, False,
                         device="cpu", config=config, traffic=tr)
    assert r["attempted"] == 32          # one flush, however short
