"""The harness on the card at a small size: each closed loop, traced, with
the device's numbers read.  Skips without a CUDA device (decided in the
fixture, not at import).  On the card:
``python3 -m pytest -q gssbench/tests/test_gssbench_gpu.py``."""
import pytest

from gssbench.tests.conftest import BIG_SEED, tiny

CELLS = {"mesh2d-1024.solve-b32": {}, "ecology2.resparsify": {}}


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_traced_cell_on_the_card(manifest, cuda, cell):
    from gssbench import harness

    config, traffic = tiny(manifest, cell, rows=64, **CELLS[cell])
    r = harness.run_cell(manifest, cell, BIG_SEED, 1.0, True, device=cuda,
                         config=config, traffic=traffic)
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    assert r["device"]["memory_peak_bytes"] > 0
    idle = [k for k in r["metrics"] if k.startswith("device.idle_pct")]
    assert len(idle) == 1
    assert 0 <= r["metrics"][idle[0]]["value"] < 100
    assert r["breakdown"]["device_ops"]
    share = r["metrics"].get("solve_kernels_roofline")
    assert share is None or 0 < share["value"] <= 100
