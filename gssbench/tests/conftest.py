"""Shared set-up of the benchmark's tests: the repository root and ``src``
on the path, few CPU threads, and the cells at a tiny size."""
import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

BIG_SEED = 2 ** 31 + 12345     # seeds beyond 32 signed bits must work


@pytest.fixture(scope="session")
def manifest():
    from gssbench.manifest import Manifest

    return Manifest.load(ROOT)


@pytest.fixture(autouse=True, scope="session")
def _few_threads():
    import torch

    torch.set_num_threads(2)


def tiny(manifest, cell: str, rows: int = 20, **traffic):
    """``(config, traffic)`` of ``cell`` with a ``rows x rows`` graph and
    the traffic's parameters updated by ``traffic``."""
    entry = manifest.workload(cell)
    config = copy.deepcopy(manifest.config(entry["config"]))
    config["graph"].update(rows=rows, cols=rows)
    return config, dict(manifest.traffic(entry["traffic"]), **traffic)


def run_tiny(manifest, cell: str, trace: bool = False, seconds: float = 0.3,
             seed: int = BIG_SEED, rows: int = 20, **traffic) -> dict:
    from gssbench import harness

    config, tr = tiny(manifest, cell, rows, **traffic)
    return harness.run_cell(manifest, cell, seed, seconds, trace,
                            device="cpu", config=config, traffic=tr)
