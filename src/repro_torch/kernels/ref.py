"""Plain PyTorch versions of the hand-written CUDA kernels.

Each function computes exactly what its kernel computes, in the same
operation order: the CPU tests run them, the wrappers
(:mod:`~repro_torch.kernels.vcycle_fused`,
:mod:`~repro_torch.kernels.similarity`, :mod:`~repro_torch.kernels.spmv_ell`,
:mod:`~repro_torch.kernels.ssm_scan`) take them for CPU tensors, and
``chip_smoke.py`` holds each kernel against its plain version on the card.

The ELL sums run over ``l`` in order, one rounded multiply and one rounded
add per term; the kernels are built without FMA contraction, so K1, K2,
K3 and K5 agree bit for bit with their plain versions on the card.  K4's
output is boolean, so it is bit-identical whatever order the work runs in.
K6's scan rounds each product and sum on its own and sums over the state
in ascending order (:func:`ssm_readout`), as its kernel does; K6b, its
gradient, also sums over the channels in its kernel's order
(:func:`warp_partials`, then :func:`group_sum`), so every output of it is
bitwise too.

K7's plain version (:func:`laplacian_residual_ref`) is the exception: it is
the service's float64 residual on the host, in NumPy, with each column's
mean and norm through :func:`repro_torch.core.graph.col_mean` and
:func:`repro_torch.core.graph.col_norm`.  K7 sums a row's terms one at a
time in CSR order, where NumPy's ``reduceat`` groups them its own way, and
sums the columns in its own blocks, so the two agree within a float64
rounding bound, not bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch


def spmv_ell_batched_ref(idx, val, x):
    """``y[i, j] = sum_l val[i, l] * x[idx[i, l], j]``, summed in l order.

    ``x`` is ``[nx, k]`` with ``nx >= n``; the result is ``[n, k]``."""
    n, L = idx.shape
    idx_l = idx.long()
    acc = torch.zeros((n, x.shape[1]), dtype=x.dtype, device=x.device)
    for l in range(L):
        acc = acc + val[:, l, None] * x[idx_l[:, l]]
    return acc


def cheby_step_ref(idx, val, inv_d, r, z_prev, p, *, first: bool,
                   theta: float, c1: float = 0.0, c2: float = 0.0):
    """One step of the Chebyshev recurrence; returns ``(p, z)``.

    ``theta`` divides as a 0-dim f32 tensor on ``r``'s device: a true
    division, as the kernel does (a CUDA division by a Python scalar
    multiplies by its reciprocal instead)."""
    theta = torch.full((), theta, dtype=r.dtype, device=r.device)
    res = r if z_prev is None else r - spmv_ell_batched_ref(idx, val, z_prev)
    dres = inv_d[:, None] * res
    p = dres / theta if first else c1 * p + c2 * dres
    z = p if z_prev is None else z_prev + p
    return p, z


def cheby_smooth_zero_ref(idx, val, inv_d, r, *, theta: float, c1: float,
                          c2: float):
    """The first two recurrence steps from the zero iterate, as K2's
    zero-start launch runs them; returns ``(p, z)`` after step 2.

    The launch recomputes step 1's iterate ``(inv_d * r) / theta`` for
    every neighbour it reads; the same rounded operations over the whole
    vector give the same bits."""
    theta = torch.full((), theta, dtype=r.dtype, device=r.device)
    z1 = inv_d[:, None] * r / theta
    dres = inv_d[:, None] * (r - spmv_ell_batched_ref(idx, val, z1))
    p = c1 * z1 + c2 * dres
    return p, z1 + p


def cheby_prolong_step_ref(idx, val, inv_d, r, z, zc=None, agg=None, *,
                           theta: float):
    """Step 1 from the warm start ``z + zc[agg]`` (``z`` without ``zc``;
    the V-cycle's prolongation, one rounded add an element), as K2's
    post-smooth runs it first; returns ``(p, z)``."""
    z_in = z if zc is None else z + zc[agg.long()]
    return cheby_step_ref(idx, val, inv_d, r, z_in, None, first=True,
                          theta=theta)


def restrict_residual_ref(idx, val, perm, agg_ptr, agg_max: int, r, z):
    """``rc[c] = sum over the members i of aggregate c, ascending, of
    (r - A z)[i]`` — ``segment_sum(r - A z, agg)`` in its sequential order.

    ``perm``/``agg_ptr`` are the aggregate CSR; ``agg_max`` its largest
    aggregate (the loop bound, fixed at hierarchy build)."""
    resid = r - spmv_ell_batched_ref(idx, val, z)
    return aggregate_sum_ref(resid, perm, agg_ptr, agg_max)


def aggregate_sum_ref(resid, perm, agg_ptr, agg_max: int):
    """``out[c] = sum over the members i of aggregate c, ascending, of
    resid[i]``: the ordered segment sum that K3 runs on the fly."""
    start = agg_ptr[:-1].long()
    counts = agg_ptr[1:].long() - start
    perm_l = perm.long()
    out = torch.zeros((counts.shape[0], resid.shape[1]), dtype=resid.dtype,
                      device=resid.device)
    for t in range(agg_max):
        live = counts > t
        pos = torch.where(live, start + t, 0)
        out = torch.where(live[:, None], out + resid[perm_l[pos]], out)
    return out


def spmv_ell_ref(idx, val, x):
    """``y[i] = sum_l val[i, l] * x[idx[i, l]]`` for one column ``x [nx]``,
    ``nx >= n``, summed in l order: the loop of K5, and one column of
    :func:`spmv_ell_batched_ref` bit for bit (not ``torch.sum`` over the
    gathered ``[n, L]`` block, whose order CUDA does not fix)."""
    n, L = idx.shape
    idx_l = idx.long()
    acc = torch.zeros((n,), dtype=x.dtype, device=x.device)
    for l in range(L):
        acc = acc + val[:, l] * x[idx_l[:, l]]
    return acc


# cells of one chunk's [K, rows, c1] lookup (64 Mi)
_SIM_CHUNK_CELLS = 1 << 26


def similarity_mark_ref(csu, csv, cbeta, cseg, esu, esv, eseg):
    """``kill[j]``: some candidate ``k`` of edge ``j``'s subtask
    (``cseg[k] == eseg[j]``) strictly-similarity-marks it.

    Membership as in the reference's broadcast (``repro/kernels/ref.py``):
    ``exists (a, b): sig_x[k, a] == sig_y[j, b]`` with ``a + b <=
    cbeta[k]``, and, as in the kernel, the pairs with ``a + b > c1 - 1``
    are skipped (``beta*`` never exceeds ``c``, so the skip changes
    nothing on the engine's inputs).  Such a pair exists exactly when the
    least ``a`` at which ``sig_x[k]`` holds ``sig_y[j, b]`` satisfies it,
    so each candidate keeps a table of its values' least positions and a
    row looks each of its ``c1`` values up there: ``[K, rows, c1]`` cells
    where the broadcast has ``[K, rows, c1, c1]``.  The rows run in
    chunks so the temporaries stay bounded at any ``m``.  A candidate with
    ``cbeta < 0`` admits no pair and marks nothing, so only the others
    enter the tables."""
    m = esu.shape[0]
    live = cbeta >= 0
    if not bool(live.all()):
        csu, csv, cbeta, cseg = csu[live], csv[live], cbeta[live], cseg[live]
    K, c1 = csu.shape
    dev = esu.device
    out = torch.zeros((m,), dtype=torch.bool, device=dev)
    if K == 0:
        return out
    # the candidates' values (sorted), and per candidate and value the
    # least position in its signature; column U and absent values: c1
    vals = torch.unique(torch.cat([csu.flatten(), csv.flatten()]))
    U = vals.numel()
    pos = torch.arange(c1, dtype=torch.int32, device=dev).expand(K, c1)

    def least_pos(sa):                                  # [K, U + 1]
        t = torch.full((K, U + 1), c1, dtype=torch.int32, device=dev)
        return t.scatter_reduce_(1, torch.searchsorted(vals, sa), pos,
                                 reduce="amin")

    tu, tv = least_pos(csu), least_pos(csv)
    # a + b <= min(beta, c1 - 1)  <=>  a <= lim - b
    lim = torch.clamp(cbeta, max=c1 - 1).to(torch.int32)
    rows_per_chunk = max(1, _SIM_CHUNK_CELLS // (K * c1))

    def lookup(sb):                 # [R, c1] -> value index, U if absent
        j = torch.searchsorted(vals, sb).clamp_(max=U - 1)
        return torch.where(vals[j] == sb, j, U).flatten()

    for lo in range(0, m, rows_per_chunk):
        hi = min(m, lo + rows_per_chunk)
        ju, jv = lookup(esu[lo:hi]), lookup(esv[lo:hi])
        room = (lim[:, None, None] - torch.arange(
            c1, dtype=torch.int32, device=dev)).expand(K, hi - lo, c1)

        def match(t, j):                                # [K, R]
            return (t[:, j].view(K, hi - lo, c1) <= room).any(-1)

        sim = ((match(tu, ju) & match(tv, jv))
               | (match(tu, jv) & match(tv, ju)))
        sim &= cseg[:, None] == eseg[None, lo:hi]
        out[lo:hi] = sim.any(dim=0)
    return out


def ssm_readout(h, C):
    """``y[..., d] = sum_n h[..., d, n] * C[..., n]``, summed n = 0, 1, ...
    in order (one rounded multiply and one rounded add per term): the
    fixed order that K6 sums in, not ``torch.sum``'s.  ``h [B, di, state]``,
    ``C [B, state]`` -> ``[B, di]``."""
    acc = h[..., 0] * C[:, None, 0]
    for n in range(1, h.shape[-1]):
        acc = acc + h[..., n] * C[:, None, n]
    return acc


def ssm_scan_ref(x1, dt, Bm, Cm, A, h0):
    """The Mamba1 selective scan of K6 (``repro/kernels/ssm_scan.py``
    ``_scan_kernel``), every input cast to float32 first as the reference's
    wrapper does: per step ``da = exp(dt * A)``, ``dbx = (dt * x) * B``,
    ``h = da * h + dbx``, ``y = sum_n h * C`` (:func:`ssm_readout`).

    x1/dt ``[B, S, di]``; Bm/Cm ``[B, S, state]``; A ``[di, state]``;
    h0 ``[B, di, state]``.  Returns y ``[B, S, di]`` (before the D skip) and
    hT ``[B, di, state]``."""
    x1, dt, Bm, Cm, A, h = (t.float() for t in (x1, dt, Bm, Cm, A, h0))
    y = torch.empty_like(x1)
    for t in range(x1.shape[1]):
        dt_t = dt[:, t]
        da = torch.exp(dt_t[:, :, None] * A)
        dbx = (dt_t * x1[:, t])[:, :, None] * Bm[:, t, None, :]
        h = da * h + dbx
        y[:, t] = ssm_readout(h, Cm[:, t])
    return y, h


def warp_partials(p):
    """K6b's per-warp sums over the channels: ``p [..., di, n]`` ->
    ``[..., ceil(di / 32), n]``, each group of 32 channels (zero-padded
    past ``di``) summed by recursive halving (pairs ``i, i + 16``, then
    ``i, i + 8``, ...: the butterfly of ``__shfl_xor_sync``)."""
    di = p.shape[-2]
    pad = -di % 32
    if pad:
        p = torch.cat([p, p.new_zeros(p.shape[:-2] + (pad, p.shape[-1]))],
                      dim=-2)
    s = p.reshape(p.shape[:-2] + (p.shape[-2] // 32, 32, p.shape[-1]))
    for half in (16, 8, 4, 2, 1):
        s = s[..., :half, :] + s[..., half:, :]
    return s[..., 0, :]


def group_sum(s):
    """``[..., groups, n]`` -> ``[..., n]``: the groups added one after
    the other, the first group first (K6b's reduction kernel)."""
    acc = s[..., 0, :]
    for w in range(1, s.shape[-2]):
        acc = acc + s[..., w, :]
    return acc


def ssm_scan_bwd_ref(x1, dt, Bm, Cm, A, h0, dy, dhT=None):
    """The gradient of :func:`ssm_scan_ref` (K6b's plain version): given
    ``dy [B, S, di]`` and ``dhT [B, di, state]`` (None: zeros), returns
    ``(dx1, ddt, dBm, dCm, dA, dh0)``, float32, in the inputs' shapes.

    The states are recomputed from ``h0`` in K6's order (no saved states
    are read), then the reverse-time loop carries ``g``, the gradient of
    ``h_t``, from ``dhT``; for t = S-1 ... 0, with ``a = exp(dt_t A)``,
    ``u = dt_t x_t``::

        g    = g + dy_t C_t                  (outer product)
        dC_t = sum_d dy_t[d] h_t[d, :]       (warp_partials, group_sum)
        dB_t = sum_d g[d, :] u[d]            (warp_partials, group_sum)
        du   = sum_n g[:, n] B_t[n]          (n in order)
        ga   = (g h_{t-1}) a
        dA_b = dA_b + ga dt_t                (per batch row)
        ddt  = (sum_n ga[:, n] A[:, n]) + du x_t
        dx   = du dt_t
        g    = g a

    then ``dh0 = g`` and ``dA`` the rows' ``dA_b`` added in row order.
    Each operation rounds on its own, in the order of K6b
    (``csrc/ssm_scan_bwd.cu``), so on the card the two agree bit for bit."""
    x1, dt, Bm, Cm, A, h0, dy = (t.float() for t in
                                 (x1, dt, Bm, Cm, A, h0, dy))
    Bsz, S, di = x1.shape
    hs = []
    h = h0
    for t in range(S):
        da = torch.exp(dt[:, t, :, None] * A)
        h = da * h + (dt[:, t] * x1[:, t])[:, :, None] * Bm[:, t, None, :]
        hs.append(h)
    g = torch.zeros_like(h0) if dhT is None else dhT.float()
    dA_b = torch.zeros_like(h0)
    dx, ddt = torch.empty_like(x1), torch.empty_like(x1)
    # the warp partials of every step; their groups are summed at the end
    nw = -(-di // 32)
    dB, dC = (x1.new_empty((Bsz, S, nw, A.shape[1])) for _ in range(2))
    for t in reversed(range(S)):
        h_t = hs[t]
        h_prev = hs[t - 1] if t else h0
        dt_t, x_t = dt[:, t], x1[:, t]
        u = dt_t * x_t
        a = torch.exp(dt_t[:, :, None] * A)
        g = g + dy[:, t, :, None] * Cm[:, t, None, :]
        dC[:, t] = warp_partials(dy[:, t, :, None] * h_t)
        dB[:, t] = warp_partials(g * u[:, :, None])
        du = ssm_readout(g, Bm[:, t])
        ga = (g * h_prev) * a
        dA_b = dA_b + ga * dt_t[:, :, None]
        ga_a = ga * A
        sa = ga_a[..., 0]
        for n in range(1, A.shape[1]):
            sa = sa + ga_a[..., n]
        ddt[:, t] = sa + du * x_t
        dx[:, t] = du * dt_t
        g = g * a
    dA = dA_b[0]
    for b in range(1, Bsz):
        dA = dA + dA_b[b]
    return dx, ddt, group_sum(dB), group_sum(dC), dA, g


def laplacian_residual_ref(indptr, adj, adj_w, b, x, with_b_norm=False):
    """``(r, mean, norm, b_norm)``: ``r = b - L x`` in float64 for the
    float32 ``b [n, k]`` and the float64 ``x [n, k]`` over a graph's CSR
    (:meth:`repro_torch.core.graph.Graph.laplacian_matvec`), each column's
    mean and norm of ``r``, and the norms of ``b`` (``None`` unless
    ``with_b_norm``), as ``[k]`` float64 tensors."""
    from repro_torch.core.graph import (col_mean, col_norm,
                                        csr_laplacian_matvec)

    b64 = b.numpy().astype(np.float64)
    r = b64 - csr_laplacian_matvec(indptr.numpy(), adj.numpy(),
                                   adj_w.numpy(), x.numpy())
    b_norm = torch.from_numpy(col_norm(b64)) if with_b_norm else None
    return (torch.from_numpy(r), torch.from_numpy(col_mean(r)),
            torch.from_numpy(col_norm(r)), b_norm)
