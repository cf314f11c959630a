"""The port's roofline module (``repro_torch.launch.roofline``) against the
reference's (``repro.launch.roofline``), and its launch bounds against
the numbers ``chip_smoke.py`` printed before they moved there.

* Each reference byte/flop model gives the same integer in the port, on a
  few shapes.  (``hierarchy_level_triples`` and ``hierarchy_level_shapes``
  are held to the reference's in ``tests/test_torch_solver.py``, over the
  hierarchies that file builds in both packages, mesh2d(12, 12) among
  them.)
* The launch bounds reproduce, to the last digit, the bounds of the
  kernel records of a chip run of ``chip_smoke.py`` made while the
  formulas were still inline there (H100 80GB HBM3, 700 W): K1 at the
  top matvec and at a shard's shape, K2 and K3 at level 0, K5, K6 and its
  exponentials' term.  K4's counting is held to a hand count.
* The H100's peaks are the ones the bounds use.
"""
import numpy as np
import pytest
import torch

from repro.launch import roofline as jroof
from repro_torch.launch import roofline as roof

SHAPES = [(1, 1, 1), (31, 3, 1), (1000, 7, 8), (2 ** 20, 7, 8),
          (131_072, 12, 16), (2 ** 30, 17, 16)]


@pytest.mark.parametrize("n,L,k", SHAPES)
def test_work_models_equal_the_reference(n, L, k):
    assert roof.ell_spmv_bytes(n, L, k) == jroof.ell_spmv_bytes(n, L, k)
    assert roof.ell_spmv_bytes(n, L, k, 2, 8) == \
        jroof.ell_spmv_bytes(n, L, k, 2, 8)
    assert roof.ell_spmv_flops(n, L, k) == jroof.ell_spmv_flops(n, L, k)
    for guess in (False, True):
        assert roof.fused_smoother_bytes(n, L, k, 2, with_guess=guess) == \
            jroof.fused_smoother_bytes(n, L, k, 2, with_guess=guess)
    nc = max(1, n // 3)
    assert roof.fused_restrict_residual_bytes(n, L, k, nc) == \
        jroof.fused_restrict_residual_bytes(n, L, k, nc)
    shapes = [(n, L), (max(1, n // 2), L + 1)]
    triples = [(n, L, nc), (nc, L + 1, max(1, nc // 2))]
    for degree in (2, 3):
        assert roof.vcycle_bytes(shapes, k, degree) == \
            jroof.vcycle_bytes(shapes, k, degree)
        assert roof.vcycle_bytes_fused(triples, k, degree) == \
            jroof.vcycle_bytes_fused(triples, k, degree)
    # the fused V-cycle moves fewer bytes than the unfused one
    assert roof.vcycle_bytes_fused(triples, k) < \
        roof.vcycle_bytes([t[:2] for t in triples], k)


def test_achieved_bandwidth_uses_the_h100_rate():
    assert roof.HBM_BW == 3.35e12 and roof.F32_FLOPS == 67e12
    got = roof.achieved_bandwidth(3.35e9, 2e-3)
    assert got == {"bytes_per_s": 3.35e9 / 2e-3, "frac_of_hbm": 0.5}
    assert roof.achieved_bandwidth(1.0, 0.0) == \
        jroof.achieved_bandwidth(1.0, 0.0)


# (launch, arguments, bound_ms, bound_by): the kernel records of a chip
# run of chip_smoke.py on the main path (n = 2^20, L = 7, k = 8)
GOLDEN = [
    ("spmv_batched_launch", (2 ** 20, 7, 8), 0.03756093134328358),
    ("spmv_batched_launch", (131_072, 7, 8, 133_120), 0.004714679402985074),
    ("cheby_step_launch", (2 ** 20, 7, 8), 0.06886170746268656),
    ("cheby_smooth_zero_launch", (2 ** 20, 7, 8), 0.0388129623880597),
    ("cheby_prolong_step_launch", (2 ** 20, 7, 8, 397_553),
     0.06389501134328358),
    ("cheby_post_smooth_sweep", (2 ** 20, 7, 8, 397_553),
     0.05387876298507462),
    ("restrict_residual_launch", (2 ** 20, 7, 8, 397_553),
     0.043085174925373136),
    ("spmv_launch", (2 ** 20, 7), 0.020032496716417908),
    ("ssm_scan_launch", (4, 2048, 8192, 16, 2, 2), 0.16182501253731343),
]


@pytest.mark.parametrize("launch,args,want", GOLDEN,
                         ids=[f"{g[0]}{g[1]}" for g in GOLDEN])
def test_launch_bounds_are_the_printed_ones(launch, args, want):
    nbytes, ops = getattr(roof, launch)(*args)
    assert roof.bound_ms(nbytes, ops) == (want, "bytes")


def test_launch_bounds_count_x_once_where_the_model_counts_gathers():
    n, L, k = 2 ** 20, 7, 8
    nbytes, ops = roof.spmv_batched_launch(n, L, k)
    assert nbytes == n * L * 8 + 2 * n * k * 4
    assert ops == roof.ell_spmv_flops(n, L, k)
    # the reference's model gathers a k-wide row of x per stored entry
    assert roof.ell_spmv_bytes(n, L, k) - nbytes == (n * L * k - n * k) * 4


def test_k2_sweep_launches_count_by_hand():
    """K2's launches at level 0: the zero start reads the slabs, inv_d and
    r and writes z; the warm sweep's bound counts its inputs and z, and
    its two launches move more (p and z of step 1 through memory)."""
    n, L, k, nc = 2 ** 20, 7, 8, 397_553
    slab, vec = n * L * 8, n * k * 4
    zb, zo = roof.cheby_smooth_zero_launch(n, L, k)
    assert (zb, zo) == (slab + n * 4 + 2 * vec, n * k * (4 * L + 8))
    pb, po = roof.cheby_prolong_step_launch(n, L, k, nc)
    assert pb == slab + n * 8 + 4 * vec + nc * k * 4
    wb, wo = roof.cheby_post_smooth_sweep(n, L, k, nc)
    assert wb == slab + n * 8 + 3 * vec + nc * k * 4
    sb, so = roof.cheby_step_launch(n, L, k)
    assert wo == po + so
    assert wb < pb + sb
    # against the two step launches it replaces (the first reads r and
    # inv_d and writes p and z; the second is a step with its matvec):
    # six k-wide vectors and one inv_d fewer
    assert (n * 4 + 3 * vec) + sb - zb == n * 4 + 6 * vec


def test_ssm_scan_terms():
    nbytes, ops = roof.ssm_scan_launch(4, 2048, 8192, 16, 2, 2)
    assert nbytes == 542_113_792
    assert ops == 6 * 1_073_741_824 + 4 * 2048 * 8192
    assert round(roof.ssm_scan_expf_ms(4, 2048, 8192, 16, 1980.0), 4) == \
        0.2568
    # operations bound a launch whose bytes are few
    assert roof.bound_ms(1.0, 67e9) == (1.0, "operations")


def test_ssm_scan_bwd_design_closed_forms():
    """K6b at hymba-1.5b's training shape (B = 4, S = 4096, di = 3200,
    state 16, bf16): its checkpoints, one state a channel every run but
    the first; its partial sums, 100 blocks of 32 channels a row and step
    and one dA a row; its design bound, those written and read once each
    beside 28 operations a cell."""
    B, S, di, n = 4, 4096, 3200, 16
    assert roof.ssm_scan_bwd_checkpoint_bytes(B, S, di, n, 16) == \
        4 * B * 255 * di * n == 208_896_000
    assert roof.ssm_scan_bwd_checkpoint_bytes(B, S, di, n, 32) == \
        104_038_400
    # one run: no checkpoint; one step more: one
    assert roof.ssm_scan_bwd_checkpoint_bytes(2, 16, 37, 8, 16) == 0
    assert roof.ssm_scan_bwd_checkpoint_bytes(2, 17, 37, 8, 16) == \
        4 * 2 * 37 * 8
    assert roof.ssm_scan_bwd_partial_bytes(B, S, di, n) == \
        4 * (B * S * 100 * 2 * n + B * di * n) == 210_534_400
    assert roof.ssm_scan_bwd_partial_bytes(1, 5, 33, 4) == \
        4 * (5 * 2 * 2 * 4 + 33 * 4)
    fn_bytes, fn_ops = roof.ssm_scan_bwd_launch(B, S, di, n, 2, 2)
    assert (fn_bytes, fn_ops) == (844_873_728, 19_555_942_400)
    nbytes, ops = roof.ssm_scan_bwd_design(B, S, di, n, 2, 2, 16)
    assert nbytes == fn_bytes + 2 * (208_896_000 + 210_534_400)
    assert ops == 28 * B * S * di * n + 5 * B * S * di == 23_750_246_400
    assert roof.bound_ms(fn_bytes, fn_ops)[1] == "operations"
    ms, by = roof.bound_ms(nbytes, ops)
    assert by == "bytes" and round(ms, 4) == 0.5026


def test_similarity_mark_launch_counts_by_hand():
    """Two subtasks: 0 (rows 0-2) with one recovered candidate of beta 1,
    1 (rows 3-4) with one unrecovered candidate; c1 = 3."""
    c1 = 3
    csu = torch.zeros((2, c1), dtype=torch.int32)
    csv = torch.zeros((2, c1), dtype=torch.int32)
    cbeta = torch.tensor([1, -1], dtype=torch.int32)
    cseg = torch.tensor([0, 1], dtype=torch.int32)
    eseg = torch.tensor([0, 0, 0, 1, 1], dtype=torch.int32)
    esu = torch.zeros((5, c1), dtype=torch.int32)
    nbytes, ops, sig_rows, cells = roof.similarity_mark_launch(
        (csu, csv, cbeta, cseg, esu, esu, eseg))
    assert sig_rows == 3                 # subtask 0's rows only
    pairs = sum(1 for a in range(c1) for b in range(c1) if a + b <= 1)
    assert cells == 3 * pairs            # 3 rows x candidate 0's pairs
    assert nbytes == 5 * 5 + 3 * 2 * c1 * 4 + 2 * (2 * c1 * 4 + 8)
    assert ops == 4.0 * cells
    assert np.isfinite(roof.bound_ms(nbytes, ops)[0])
