"""Binary lifting over the rooted spanning tree.

The port of ``repro.core.lifting``:

  * skip tables ``up[k][v]`` = 2^k-th ancestor (root saturates to itself),
  * resistive prefix sums ``rw[k][v]`` = sum of 1/w along those 2^k hops,
  * O(log V) vectorized LCA queries over edge tensors,
  * the resistance distance R_T(u, v) via root prefix sums,
  * c-hop *ancestor signatures* for the strict-similarity check: tree
    distance <= beta iff some a + b <= beta has anc_a(x) == anc_b(y).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Lifting(NamedTuple):
    up: torch.Tensor          # [L, n] int32 ancestors at power-of-two hops
    rw: torch.Tensor          # [L, n] float32 resistive length of those hops
    depth: torch.Tensor       # [n] int32
    rdist_root: torch.Tensor  # [n] float32 resistive distance to root


def num_levels(n: int) -> int:
    return max(int(np.ceil(np.log2(max(n, 2)))) + 1, 1)


def build_lifting(n: int, parent, parent_w, depth) -> Lifting:
    L = num_levels(n)
    dev = parent.device
    up_k = parent.to(torch.int32)
    is_root = parent == torch.arange(n, dtype=parent.dtype, device=dev)
    rw_k = torch.where(is_root, torch.zeros_like(parent_w),
                       1.0 / parent_w.clamp(min=1e-30))
    ups, rws = [up_k], [rw_k]
    for _ in range(L - 1):
        gather = up_k.long()
        up_k, rw_k = up_k[gather], rw_k + rw_k[gather]
        ups.append(up_k)
        rws.append(rw_k)
    up = torch.stack(ups)
    rw = torch.stack(rws)
    # rw saturates at the root (its self-loop adds 0), so the top level IS
    # the resistive root distance.
    return Lifting(up=up, rw=rw, depth=depth.to(torch.int32),
                   rdist_root=rw[-1])


def lca(lift: Lifting, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Vectorized LCA for equal-shaped index tensors ``u``/``v``."""
    up, depth = lift.up, lift.depth
    L = up.shape[0]
    u, v = u.long(), v.long()
    du, dv = depth[u], depth[v]
    a = torch.where(du >= dv, u, v)   # deeper
    b = torch.where(du >= dv, v, u)
    diff = torch.abs(du - dv)
    for k in range(L - 1, -1, -1):
        lift_it = ((diff >> k) & 1).bool()
        a = torch.where(lift_it, up[k][a].long(), a)
    eq = a == b
    for k in range(L - 1, -1, -1):
        ua, ub = up[k][a].long(), up[k][b].long()
        go = (~eq) & (ua != ub)
        a = torch.where(go, ua, a)
        b = torch.where(go, ub, b)
    return torch.where(eq, a, up[0][a].long()).to(torch.int32)


def resistance_distance(lift: Lifting, u, v, lca_uv) -> torch.Tensor:
    """R_T(u, v) = rdist(u, root) + rdist(v, root) - 2 * rdist(lca, root)."""
    r = lift.rdist_root
    return r[u.long()] + r[v.long()] - 2.0 * r[lca_uv.long()]


def ancestor_signatures(parent: torch.Tensor, c: int) -> torch.Tensor:
    """[n, c+1] int32: sig[v, j] = j-th ancestor of v (saturating at root)."""
    n = parent.shape[0]
    cur = torch.arange(n, dtype=torch.int32, device=parent.device)
    rows = [cur]
    for _ in range(c):
        cur = parent[cur.long()].to(torch.int32)
        rows.append(cur)
    return torch.stack(rows, dim=1)
