"""The plain reference that decides ``correct``, and the control.

NumPy and SciPy in float64, plus a plain PCG in PyTorch for the control.
It builds its own Laplacian from the benchmark's edge arrays, imports
nothing of ``repro_torch`` and takes nothing the program made: it reads
the program's solutions and its level-0 sparsifier only to judge them.

* :func:`relres` — ``||b - L x|| / ||b||`` of each solved column, with
  ``b`` the right-hand side as handed to the program, its mean removed in
  float64 (the Laplacian's range).
* :func:`pcg` — a Jacobi-preconditioned CG over the same Laplacian, in
  float64, or in float32 with every matvec's operands rounded to TF32;
  :func:`refined_pcg` wraps it in the configuration's refinement (float64
  residuals on the host, up to ``max_refine`` correction solves): the
  control, the reference in the program's place one precision below the
  configuration's (float32 with TF32 off).

A build's hierarchy is judged by :mod:`gssbench.build_reference`.
"""
from __future__ import annotations

import warnings

import numpy as np
import scipy.sparse as sp


def laplacian(n: int, src, dst, w) -> sp.csr_matrix:
    """The float64 Laplacian ``D - W`` of an undirected weighted graph."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    w = np.asarray(w, np.float64)
    adj = sp.coo_matrix((np.concatenate([w, w]),
                         (np.concatenate([src, dst]),
                          np.concatenate([dst, src]))), shape=(n, n)).tocsr()
    deg = np.asarray(adj.sum(axis=1)).ravel()
    return (sp.diags(deg) - adj).tocsr()


def relres(L: sp.csr_matrix, B, X, block: int = 32) -> np.ndarray:
    """``[k]`` relative residuals of the solutions ``X [n, k]`` of
    ``L X = B`` (``B`` as handed to the program, centered here), in blocks
    of ``block`` columns."""
    B = np.asarray(B)
    X = np.asarray(X)
    if B.ndim == 1:
        B, X = B[:, None], X[:, None]
    out = np.empty(B.shape[1])
    for j in range(0, B.shape[1], block):
        b = B[:, j:j + block].astype(np.float64)
        b = b - b.mean(axis=0)
        r = b - L @ np.asarray(X[:, j:j + block], np.float64)
        bn = np.maximum(np.linalg.norm(b, axis=0), np.finfo(np.float64).tiny)
        out[j:j + block] = np.linalg.norm(r, axis=0) / bn
    return out


def _tf32(x):
    """Round float32 values to TF32 (10 mantissa bits, to nearest even),
    as the tensor cores round a product's inputs."""
    import torch

    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


def pcg(L: sp.csr_matrix, B, tol: float, maxiter: int,
        precision: str = "float64", device="cpu") -> np.ndarray:
    """Jacobi-preconditioned CG on ``L X = B`` (``B`` centered here), all
    columns together, each frozen once its recurrence residual reaches
    ``tol``.  ``precision``: ``"float64"``, or ``"tf32"`` (float32, every
    matvec's matrix and vector rounded to TF32).  Returns ``X`` centered,
    in float64 on the host."""
    import torch

    if precision not in ("float64", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    dt = torch.float64 if precision == "float64" else torch.float32
    dev = torch.device(device)
    vals = torch.as_tensor(L.data, dtype=dt, device=dev)
    if precision == "tf32":
        vals = _tf32(vals)
    with warnings.catch_warnings():   # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        A = torch.sparse_csr_tensor(
            torch.as_tensor(L.indptr, dtype=torch.int64, device=dev),
            torch.as_tensor(L.indices, dtype=torch.int64, device=dev),
            vals, size=L.shape, check_invariants=False)
    dinv = torch.as_tensor(1.0 / L.diagonal(), dtype=dt, device=dev)[:, None]

    def matvec(x):
        return A @ (_tf32(x) if precision == "tf32" else x)

    b = torch.as_tensor(np.asarray(B, np.float64), device=dev)
    if b.dim() == 1:
        b = b[:, None]
    b = (b - b.mean(dim=0)).to(dt)
    bn = torch.linalg.vector_norm(b, dim=0).clamp_min(1e-300)
    x = torch.zeros_like(b)
    r = b.clone()
    z = dinv * r
    z = z - z.mean(dim=0)
    p = z.clone()
    rz = (r * z).sum(dim=0)
    active = torch.ones(b.shape[1], dtype=torch.bool, device=dev)
    for _ in range(maxiter):
        Ap = matvec(p)
        pAp = (p * Ap).sum(dim=0)
        alpha = torch.where(active & (pAp != 0), rz / pAp, 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        active = active & (torch.linalg.vector_norm(r, dim=0) / bn > tol)
        if not bool(active.any()):
            break
        z = dinv * r
        z = z - z.mean(dim=0)
        rz_new = (r * z).sum(dim=0)
        beta = torch.where(rz != 0, rz_new / rz, 0.0)
        p = torch.where(active, z + beta * p, p)
        rz = torch.where(active, rz_new, rz)
    x = x.to(torch.float64)
    return (x - x.mean(dim=0)).cpu().numpy()


def refined_pcg(L: sp.csr_matrix, B, tol: float, maxiter: int,
                max_refine: int, precision: str = "float64",
                device="cpu") -> np.ndarray:
    """:func:`pcg` inside the configuration's refinement, as the program
    refines its device solve: the float64 residual of the centred
    right-hand sides on the host, then up to ``max_refine`` passes that
    solve for its correction (to ``tol`` of the residual, ``maxiter``
    each), each column taking a pass only where it lowers its residual,
    the passes stopping once none halves a column's residual."""
    B = np.asarray(B, np.float64)
    if B.ndim == 1:
        B = B[:, None]
    B = B - B.mean(axis=0)
    bn = np.maximum(np.linalg.norm(B, axis=0), np.finfo(np.float64).tiny)
    X = pcg(L, B, tol, maxiter, precision, device)
    R = B - L @ X
    rel = np.linalg.norm(R, axis=0) / bn
    for _ in range(max_refine):
        if not np.any(rel > tol):
            break
        Xn = X + pcg(L, R, tol, maxiter, precision, device)
        Rn = B - L @ Xn
        reln = np.linalg.norm(Rn, axis=0) / bn
        take = reln < rel
        X, R = np.where(take, Xn, X), np.where(take, Rn, R)
        halved = np.any(reln < 0.5 * rel)
        rel = np.where(take, reln, rel)
        if not halved:
            break
    return X
