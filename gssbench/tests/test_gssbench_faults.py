"""Every fault a cell can have, planted under the timed path
(:mod:`gssbench.faults`), makes ``correct`` come out false; the harness's
look for a card is skipped (``device="cpu"``), the rest of a run is
driven.  The solve faults in every cell; the build faults (a stale
hierarchy, a marking pass that marks nothing, a recovery without the
similarity filter, a contraction with wrong coarse weights) in the
resparsify cell, each caught by the number of the build it breaks.  The
cells run on one card: no exchange between cards to leave out."""
import pytest

from gssbench import faults
from gssbench.tests.conftest import run_tiny

CELLS = ["mesh2d-1024.solve-b32", "ecology2.resparsify"]
RESPARSIFY = ["ecology2.resparsify"]
# the build's number that each build fault breaks
CAUGHT_BY = {"stale_build": "weight_gap",
             "k4_marks_nothing": "recovered_marked",
             "no_similarity_filter": "recovered_marked",
             "coarse_weights_halved": "weight_gap"}


@pytest.mark.parametrize("fault", sorted(faults.SOLVE))
@pytest.mark.parametrize("cell", CELLS)
def test_solve_fault_fails_the_run(manifest, monkeypatch, cell, fault):
    faults.SOLVE[fault](monkeypatch.setattr)
    r = run_tiny(manifest, cell, rows=16)
    assert r["correct"] is False
    assert r["checks"]["max_relres"]["value"] > 1e-3


@pytest.mark.parametrize("fault", sorted(faults.BUILD))
@pytest.mark.parametrize("cell", RESPARSIFY)
def test_build_fault_fails_the_run(manifest, monkeypatch, cell, fault):
    faults.BUILD[fault](monkeypatch.setattr)
    # at 48 x 48 recovery takes several rounds, so the marking pass counts;
    # a stale hierarchy needs cycles after the first
    rows = 16 if fault == "stale_build" else 48
    r = run_tiny(manifest, cell, rows=rows, seconds=0.5)
    assert r["correct"] is False
    got = r["checks"][CAUGHT_BY[fault]]
    assert got["value"] > got["limit"]


def test_sound_builds_read_nothing(manifest):
    r = run_tiny(manifest, "ecology2.resparsify", rows=48, seconds=0.5)
    assert r["correct"]
    checks = r["checks"]
    assert all(checks[k]["value"] == 0 for k in
               ("foreign_entries", "edges_over_budget", "extra_components",
                "tree_missing", "recovered_marked", "skipped_unmarked",
                "bad_aggregates"))


def test_patch_undoes_a_fault():
    from repro_torch.core import recovery

    real = recovery.recover_rounds
    p = faults.Patch()
    faults.no_similarity_filter(p)
    assert recovery.recover_rounds is not real
    p.undo()
    assert recovery.recover_rounds is real


def test_k4_fault_takes_the_kernels_call():
    """The card's route passes ``tile_m``; the planted K4 takes it too."""
    import torch

    from repro_torch.kernels import ops

    p = faults.Patch()
    faults.k4_marks_nothing(p)
    try:
        z = torch.zeros((4, 9), dtype=torch.int32)
        one = torch.zeros(4, dtype=torch.int32)
        got = ops.similarity_mark(z, z, one, one, z, z, one, tile_m=512)
    finally:
        p.undo()
    assert not bool(got.any())
