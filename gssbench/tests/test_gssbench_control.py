"""The control: the reference in the program's place with TF32 inner
solves inside the configuration's refinement (one precision below the
configuration's).  At sizes a CPU test holds it meets the tolerance (the
refinement closes a small graph's TF32 error; it first reads above tol at
256 x 256, 11 minutes on the CPU), so on the CPU the tests hold the
float64 reference and the program to the check and the script to its
exit codes; the card's test reads the control failing at 512 x 512, and
``control.py`` at the cells' own size (PERF.md)."""
import pytest

from gssbench import control
from gssbench.tests.conftest import BIG_SEED, run_tiny, tiny

CELLS = ["mesh2d-1024.solve-b32", "ecology2.resparsify"]


@pytest.mark.parametrize("cell", CELLS)
def test_float64_reference_and_program_pass(manifest, cell):
    config, traffic = tiny(manifest, cell, rows=32)
    got = control.readings(config, traffic, BIG_SEED)
    assert got["float64"] <= got["limit"] and got["tf32"] > 0
    assert run_tiny(manifest, cell, rows=32)["correct"]


@pytest.mark.parametrize("tf32, code", [(0.5, 0), (5e-4, 1)])
def test_control_script_exits_zero_when_the_control_fails(monkeypatch, tf32,
                                                          code):
    def readings(config, traffic, seed, device, maxiter):
        return {"limit": 1e-3, "float64": 9e-4, "tf32": tf32}

    monkeypatch.setattr(control, "readings", readings)
    assert control.main(["--workload", "mesh2d-1024.solve-b32", "--seeds",
                         "1", "2", "--device", "cpu"]) == code


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.gpu
def test_gpu_control_fails_at_512(manifest, cuda):
    config, traffic = tiny(manifest, "mesh2d-1024.solve-b32", rows=512)
    got = control.readings(config, traffic, BIG_SEED, device=cuda)
    assert got["float64"] <= got["limit"] < got["tf32"]
