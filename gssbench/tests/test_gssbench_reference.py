"""The plain reference on tiny graphs: the Laplacian, the residual, the
float64 solver, its refinement and the TF32 rounding."""
import numpy as np
import pytest

from gssbench import reference
from gssbench.graphs import mesh2d

PARAMS = {"rows": 6, "cols": 5, "weight_low": 1.0, "weight_high": 10.0}


@pytest.fixture
def graph():
    return mesh2d.generate(PARAMS, 1)


def test_laplacian(graph):
    n, src, dst, w = graph
    L = reference.laplacian(n, src, dst, w).toarray()
    dense = np.zeros((n, n))
    for a, b, x in zip(src, dst, w.astype(np.float64)):
        dense[a, b] -= x
        dense[b, a] -= x
        dense[a, a] += x
        dense[b, b] += x
    np.testing.assert_allclose(L, dense, rtol=0, atol=1e-12)


def test_relres_of_an_exact_solve_and_of_a_wrong_one(graph):
    n, src, dst, w = graph
    L = reference.laplacian(n, src, dst, w)
    B = np.random.default_rng(0).standard_normal((n, 3)).astype(np.float32)
    B64 = B.astype(np.float64)
    X = np.linalg.pinv(L.toarray()) @ (B64 - B64.mean(axis=0))
    assert reference.relres(L, B, X).max() < 1e-12
    X[:, 1] = 0
    rr = reference.relres(L, B, X)
    assert rr[1] == pytest.approx(1.0) and rr[0] < 1e-12
    # one column as a vector, in blocks of one
    assert reference.relres(L, B[:, 2], X[:, 2], block=1)[0] < 1e-12


def test_tf32_rounding():
    import torch

    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12,
                      -3.14159265, 0.0])
    y = reference._tf32(x)
    assert y[0] == 1.0 and y[4] == 0.0
    assert y[1] == 1.0                       # tie, to even
    assert y[2] == 1.0 + 2 ** -10            # below the half: down
    assert abs(y[3] / -3.14159265 - 1) <= 2 ** -11
    bits = y.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())


def test_float64_solver_meets_tol_and_tf32_does_not(graph):
    n, src, dst, w = mesh2d.generate(dict(PARAMS, rows=24, cols=24), 0)
    L = reference.laplacian(n, src, dst, w)
    B = np.random.default_rng(1).standard_normal((n, 4)).astype(np.float32)
    good = reference.relres(L, B, reference.pcg(L, B, 1e-3, 5000))
    bad = reference.relres(L, B, reference.pcg(L, B, 1e-3, 5000, "tf32"))
    assert good.max() <= 1e-3 < bad.max()


def test_refinement_meets_tol_from_a_loose_inner_solve(graph):
    n, src, dst, w = mesh2d.generate(dict(PARAMS, rows=24, cols=24), 0)
    L = reference.laplacian(n, src, dst, w)
    B = np.random.default_rng(2).standard_normal((n, 3)).astype(np.float32)
    once = reference.relres(L, B, reference.refined_pcg(L, B, 1e-3, 5000, 0))
    refined = reference.relres(L, B, reference.refined_pcg(L, B, 1e-3, 5000,
                                                           3))
    assert refined.max() <= once.max() <= 1e-3
