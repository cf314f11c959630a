"""The frozen copies: generators against the stated sizes and the
program's own, the byte counts by hand."""
import numpy as np
import pytest

from gssbench import roofline
from gssbench.manifest import generator


@pytest.mark.parametrize("name", ["mesh2d-1024", "ecology2"])
def test_generators_give_the_stated_sizes(manifest, name):
    config = manifest.config(name)
    g = config["graph"]
    n, src, dst, w = generator(g["family"]).generate(g, g["seed"])
    assert n == config["n"] and len(src) == config["m"]
    assert config["m"] - (n - 1) == config["off_tree_edges"]
    assert (src < dst).all() and ((w >= 1.0) & (w <= 10.0)).all()
    key = src.astype(np.int64) * n + dst
    assert len(np.unique(key)) == len(key)
    deg = np.bincount(np.concatenate([src, dst]), minlength=n)
    assert int(deg.max()) + 1 == config["ell_width"]


@pytest.mark.parametrize("family", ["mesh2d", "grid2d"])
def test_generators_match_the_program(family):
    from repro_torch.core import graph as program

    g = getattr(program, family)(7, 9, seed=3)
    n, src, dst, w = generator(family).generate(
        {"rows": 7, "cols": 9, "weight_low": 1.0, "weight_high": 10.0}, 3)
    order = np.argsort(src.astype(np.int64) * n + dst, kind="stable")
    assert n == g.n
    np.testing.assert_array_equal(src[order], g.src)
    np.testing.assert_array_equal(dst[order], g.dst)
    np.testing.assert_array_equal(w[order], g.weight)


def test_byte_counts_by_hand():
    # K1 on n = 10, L = 3, k = 2: slabs 10*3*8, x 10*2*4, y 10*2*4
    assert roofline.spmv_batched_launch(10, 3, 2) == (400, 120)
    # one level (n 10, L 3, nc 4), k 2: pre 240+160+40, restrict
    # 240+160+40+32, prolong (8 + 40) * 4, post 240+240+40
    assert roofline.vcycle_bytes_fused([(10, 3, 4)], 2) == (
        440 + 472 + 192 + 520)
    assert roofline.pcg_trip_bytes(10, 3, 2, [(10, 3, 4)]) == (
        400 + 1624 + 8 * 10 * 2 * 4)
    assert roofline.HBM_BW == 3.35e12


def test_byte_counts_match_the_program():
    from repro_torch.launch import roofline as program

    triples = [(1 << 20, 7, 400_000), (400_000, 9, 150_000)]
    assert roofline.vcycle_bytes_fused(triples, 32) == \
        program.vcycle_bytes_fused(triples, 32)
    assert roofline.spmv_batched_launch(1 << 20, 7, 32) == \
        program.spmv_batched_launch(1 << 20, 7, 32)
    assert roofline.HBM_BW == program.HBM_BW
