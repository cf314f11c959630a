"""The gradient of the port's selective scan (``SsmScan``: K6 forward, K6b
backward; on the CPU their plain versions) against the JAX package, on
the CPU.

Inputs come from a seed with numpy and go through both packages.
Tolerances: ``SsmScan``'s gradients against ``jax.grad`` of the
reference's ``mamba_scan`` (its chunked, rematerialised ``lax.scan``),
and against autograd through the port's step loop, rtol = atol = 1e-5 in
float32 (the three differentiate the same recurrence in other orders of
rounding: XLA's, autograd's, K6b's); K6b's plain version is exact where
the test says "bitwise" (its own order, written out).  K6b itself is held
bitwise against its plain version on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels.ssm_scan import SsmScan  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402

F32 = dict(rtol=1e-5, atol=1e-5)
NAMES = ("x1", "dt", "Bm", "Cm", "A", "D", "h0")


def _inputs(seed, B, S, di, state):
    rng = np.random.default_rng(seed)
    x1 = rng.standard_normal((B, S, di)).astype(np.float32)
    dt = (0.1 * rng.random((B, S, di))).astype(np.float32)
    Bm = rng.standard_normal((B, S, state)).astype(np.float32)
    Cm = rng.standard_normal((B, S, state)).astype(np.float32)
    A = -np.abs(rng.standard_normal((di, state))).astype(np.float32)
    D = rng.standard_normal(di).astype(np.float32)
    h0 = rng.standard_normal((B, di, state)).astype(np.float32)
    gy = rng.standard_normal((B, S, di)).astype(np.float32)
    gh = rng.standard_normal((B, di, state)).astype(np.float32)
    return (x1, dt, Bm, Cm, A, D, h0), gy, gh


def _port_grads(fn, ins, gy, gh):
    t = [torch.tensor(a, requires_grad=True) for a in ins]
    y, h = fn(*t)
    (y * torch.as_tensor(gy)).sum().backward(retain_graph=True)
    (h * torch.as_tensor(gh)).sum().backward()
    return [a.grad for a in t]


def _step_loop_scan(x1, dt, Bm, Cm, A, D, h0):
    """The scan as the port's decode step runs it, step by step, under
    autograd (no Function, no kernel)."""
    ys, h = [], h0
    for t in range(x1.shape[1]):
        h, y = tlayers._ssm_step(h, x1[:, t], dt[:, t], Bm[:, t], Cm[:, t],
                                 A)
        ys.append(y)
    return torch.stack(ys, 1) + D * x1, h


@pytest.mark.parametrize("B,S,di,state,chunk", [
    (2, 16, 8, 4, 8), (1, 8, 37, 16, 4), (3, 4, 5, 8, 4)])
def test_ssm_scan_grad_matches_reference_and_step_loop(B, S, di, state,
                                                       chunk):
    ins, gy, gh = _inputs(B * S + di + state, B, S, di, state)
    before = kops.launch_counts()
    got = _port_grads(lambda *a: tlayers.mamba_scan(*a, chunk), ins, gy, gh)
    assert kops.launch_counts() == before        # the CPU runs no kernel

    def jloss(*a):
        y, h = jlayers.mamba_scan(*a, chunk)
        return jnp.sum(y * gy) + jnp.sum(h * gh)

    want = jax.grad(jloss, argnums=tuple(range(7)))(*map(jnp.asarray, ins))
    loop = _port_grads(_step_loop_scan, ins, gy, gh)
    for name, g, w, lp in zip(NAMES, got, want, loop):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **F32)
        np.testing.assert_allclose(g.numpy(), lp.numpy(), err_msg=name,
                                   **F32)


def test_bwd_ref_is_autograd_of_the_forward_ref():
    """K6b's plain version against autograd through K6's plain version (the
    same forward, differentiated by PyTorch), state 16, dhT nonzero."""
    (x1, dt, Bm, Cm, A, _, h0), gy, gh = _inputs(3, 2, 12, 40, 16)
    t = [torch.tensor(a, requires_grad=True) for a in (x1, dt, Bm, Cm, A,
                                                       h0)]
    y, h = kref.ssm_scan_ref(*t)
    ((y * torch.as_tensor(gy)).sum() + (h * torch.as_tensor(gh)).sum()
     ).backward()
    got = kref.ssm_scan_bwd_ref(*map(torch.as_tensor, (x1, dt, Bm, Cm, A,
                                                       h0)),
                                torch.as_tensor(gy), torch.as_tensor(gh))
    for name, g, a in zip(("x1", "dt", "Bm", "Cm", "A", "h0"), got, t):
        np.testing.assert_allclose(g.numpy(), a.grad.numpy(), err_msg=name,
                                   **F32)


@pytest.mark.parametrize("di", [1, 31, 32, 37, 100])
def test_channel_sum_order(di):
    """K6b's sum over the channels (``warp_partials``, ``group_sum``):
    groups of 32 channels (zero-padded) by recursive halving, then the
    groups in order; bitwise equal to that order written out one element
    at a time, and within float32 rounding of a plain sum."""
    rng = np.random.default_rng(di)
    p = torch.as_tensor(rng.standard_normal((2, di, 3)).astype(np.float32))
    got = kref.group_sum(kref.warp_partials(p))
    want = torch.empty(2, 3)
    for b in range(2):
        for n in range(3):
            vals = [float(p[b, d, n]) if d < di else 0.0
                    for d in range(-(-di // 32) * 32)]
            total = None
            for w in range(0, len(vals), 32):
                grp = [np.float32(v) for v in vals[w:w + 32]]
                while len(grp) > 1:
                    h = len(grp) // 2
                    grp = [np.float32(grp[i] + grp[i + h]) for i in range(h)]
                total = grp[0] if total is None else np.float32(total
                                                                + grp[0])
            want[b, n] = float(total)
    assert torch.equal(got, want)
    torch.testing.assert_close(got, p.sum(1), rtol=1e-5, atol=1e-5)


def test_ssm_scan_function_dtypes_views_and_route():
    """bf16 inputs give bf16 gradients (K6b's float32 result rounded once);
    B and C as strided views of one ``x_proj``-like output get gradients
    of their views' shapes, which autograd scatters back into the output;
    the forward equals K6's plain version bit for bit; the CPU launches no
    kernel."""
    rng = np.random.default_rng(9)
    B, S, di, rank, state = 2, 8, 12, 3, 4
    x1 = torch.tensor(rng.standard_normal((B, S, di)), dtype=torch.bfloat16,
                      requires_grad=True)
    dt = torch.tensor(0.1 * rng.random((B, S, di)), dtype=torch.bfloat16,
                      requires_grad=True)
    xdbc = torch.tensor(rng.standard_normal((B, S, rank + 2 * state)),
                        dtype=torch.bfloat16, requires_grad=True)
    Bm, Cm = xdbc[..., rank:rank + state], xdbc[..., rank + state:]
    A = torch.tensor(-np.abs(rng.standard_normal((di, state))),
                     dtype=torch.float32, requires_grad=True)
    h0 = torch.zeros((B, di, state), requires_grad=True)
    before = kops.launch_counts()
    y, hT = SsmScan.apply(x1, dt, Bm, Cm, A, h0)
    y_r, h_r = kref.ssm_scan_ref(x1.detach(), dt.detach(), Bm.detach(),
                                 Cm.detach(), A.detach(), h0.detach())
    assert torch.equal(y, y_r) and torch.equal(hT, h_r)
    gy = torch.as_tensor(rng.standard_normal((B, S, di)), dtype=torch.float32)
    (y * gy).sum().backward()
    assert kops.launch_counts() == before
    assert x1.grad.dtype == dt.grad.dtype == xdbc.grad.dtype == torch.bfloat16
    assert A.grad.dtype == h0.grad.dtype == torch.float32
    want = kref.ssm_scan_bwd_ref(x1.detach(), dt.detach(), Bm.detach(),
                                 Cm.detach(), A.detach(), h0.detach(), gy)
    assert torch.equal(x1.grad, want[0].to(torch.bfloat16))
    assert not xdbc.grad[..., :rank].any()
    assert torch.equal(xdbc.grad[..., rank:rank + state],
                       want[2].to(torch.bfloat16))
    assert torch.equal(xdbc.grad[..., rank + state:],
                       want[3].to(torch.bfloat16))
    assert torch.equal(A.grad, want[4]) and torch.equal(h0.grad, want[5])
