"""The CUDA kernels K1-K3 against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one (decided in a
fixture).  The file imports no JAX, so it runs on a machine with only
PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.graph import mesh2d  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels import vcycle_fused as tvf  # noqa: E402
from repro_torch.solver import (build_hierarchy, ell_laplacian,  # noqa: E402
                                make_solver)
from repro_torch.solver.hierarchy import aggregate_csr  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is false")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n", [31, 100, 257])
@pytest.mark.parametrize("k", [1, 3, 8, 16])
def test_gpu_kernels_match_plain(cuda, n, k):
    """K1 bitwise, K2 and K3 allclose (expected bitwise) on the card, and
    each wrapper counts its launch."""
    gen = torch.Generator(device=cuda).manual_seed(n + k)
    L, nx = 5, n + 7
    idx = torch.randint(0, nx, (n, L), generator=gen, device=cuda,
                        dtype=torch.int32)
    val = torch.randn((n, L), generator=gen, device=cuda)
    x = torch.randn((nx, k), generator=gen, device=cuda)
    before = dict(tvf.launches)
    assert torch.equal(tvf.spmv_ell_batched(idx, val, x),
                       kref.spmv_ell_batched_ref(idx, val, x))
    idx = idx % n
    inv_d = torch.rand((n,), generator=gen, device=cuda) + 0.5
    r, z, p = (torch.randn((n, k), generator=gen, device=cuda)
               for _ in range(3))
    kw = dict(first=False, theta=1.3, c1=0.7, c2=0.4)
    pk, zk = tvf.cheby_step(idx, val, inv_d, r, z, p.clone(),
                            torch.empty_like(r), **kw)
    pr, zr = kref.cheby_step_ref(idx, val, inv_d, r, z, p.clone(), **kw)
    torch.testing.assert_close(pk, pr, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(zk, zr, rtol=1e-5, atol=1e-5)
    agg = torch.arange(n, device=cuda, dtype=torch.int32) % max(1, n // 3)
    perm, ptr, amax = aggregate_csr(agg, max(1, n // 3))
    torch.testing.assert_close(
        tvf.restrict_residual(idx, val, perm, ptr, amax, r, z),
        kref.restrict_residual_ref(idx, val, perm, ptr, amax, r, z),
        rtol=1e-5, atol=1e-5)
    assert all(tvf.launches[name] == before[name] + 1 for name in before)


@pytest.mark.gpu
def test_gpu_wrapper_rejects_bad_operands(cuda):
    idx = torch.zeros((4, 2), dtype=torch.int64, device=cuda)
    val = torch.zeros((4, 2), device=cuda)
    x = torch.zeros((4, 1), device=cuda)
    with pytest.raises(TypeError):
        tvf.spmv_ell_batched(idx, val, x)
    with pytest.raises(ValueError):
        tvf.spmv_ell_batched(idx.int(), val, x.cpu())


@pytest.mark.gpu
def test_gpu_slice_matches_cpu_and_plain(cuda):
    """The whole slice on the card: the hierarchy built there equals the
    CPU build (agg and sizes), the default solve runs the kernels, and it
    matches the plain route in iterations and, bitwise, in x."""
    g = mesh2d(24, 24, seed=3)
    hier = build_hierarchy(g, alpha=0.05, device=cuda)
    host = build_hierarchy(g, alpha=0.05, device="cpu")
    assert hier.level_sizes == host.level_sizes
    for a, b in zip(hier.levels, host.levels):
        assert torch.equal(a.agg.cpu(), b.agg)
    idx, val = ell_laplacian(g, device=cuda)
    b = np.random.default_rng(0).standard_normal((g.n, 4)).astype(np.float32)
    before = dict(tvf.launches)
    fused = make_solver(idx, val, hier, device=cuda)(b)
    assert all(tvf.launches[k] > before[k] for k in before)
    plain = make_solver(idx, val, hier, matvec_impl="ref", device=cuda)(b)
    assert bool(fused.converged.all())
    assert torch.equal(fused.iters, plain.iters)
    assert torch.equal(fused.x, plain.x)
