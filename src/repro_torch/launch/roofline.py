"""Byte and operation models of the solver's kernels, and the H100's peaks.

The GSS half of the port of ``repro.launch.roofline``.  Two families of
functions live here, and they count different things on purpose:

* **Work models** (the reference's names and formulas, unchanged):
  :func:`ell_spmv_bytes`, :func:`ell_spmv_flops`, :func:`vcycle_bytes`,
  :func:`fused_smoother_bytes`, :func:`fused_restrict_residual_bytes`,
  :func:`vcycle_bytes_fused`, :func:`hierarchy_level_shapes`,
  :func:`hierarchy_level_triples` and :func:`achieved_bandwidth`.  They
  model the stream traffic of the reference's kernels: the ELL spmv
  counts a k-wide gather of ``x`` for *every stored entry* (gathers do
  not coalesce across rows), and the fused sweeps count the whole level
  crossing memory once a sweep.  They compare the fused V-cycle with the
  unfused one and feed the launch-limit check
  (:mod:`repro_torch.analysis.cuda_check`).
* **Launch bounds** (``*_launch``): the least bytes and operations one
  launch of a CUDA kernel of the port needs on its inputs, each input
  read once and each output written once, whatever the kernel reads
  again.  So the K1 bound counts ``x`` *once*, where
  :func:`ell_spmv_bytes` counts it per gather.  :func:`bound_ms` turns a
  launch's ``(bytes, operations)`` into the least time the card could
  take.  ``chip_smoke.py`` prints these bounds beside every kernel's
  time.

Peaks are the H100 SXM's (NVIDIA's data sheet, dense rates, at the full
700 W power limit): HBM3 at 3.35 TB/s, 67 TFLOP/s of float32 outside
the tensor cores, 989 TFLOP/s of bf16 on them, and NVLink 4 at 450 GB/s
a direction (half the data
sheet's 900 GB/s, which counts both directions).  Data float32 and
indices int32 unless a function says otherwise.

The paper's production job (:mod:`repro_torch.launch.dryrun_pdgrass`)
reads three roofline terms a round of the inner recovery engine, as the
reference's ``analyze`` does: :func:`inner_round_work` (operations and
bytes of one shard's round) and :func:`collective_bytes` (the counted
collectives, :func:`repro_torch.core.collectives.count_collectives`),
turned into seconds by :func:`roofline_terms`.

The LM dry run (:mod:`repro_torch.launch.dryrun`) reads the reference's
:class:`Roofline` from :func:`analyze` over a step's count
(:mod:`repro_torch.launch.hlo_costs`), with products of bf16 operands at
the tensor cores' rate (:data:`BF16_TC_FLOPS`), and
:func:`model_flops_estimate`, the reference's 6ND / 2ND.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

HBM_BW = 3.35e12           # bytes/s, H100 SXM HBM3
F32_FLOPS = 67e12          # float32 FLOP/s outside the tensor cores
BF16_TC_FLOPS = 989e12     # bf16 FLOP/s of the tensor cores, dense
SMS = 132                  # streaming multiprocessors of an H100 SXM
EXP_PER_CLOCK_SM = 16      # expf results an SM issues a clock (its SFUs)
# NVLink 4 of an H100 SXM, one direction (900 GB/s both ways).  A least
# time: a mesh of 256 or 512 cards spans nodes, and across them the
# network is slower than NVLink.
NVLINK_BW = 450e9          # bytes/s

_F32 = 4
_I32 = 4


def bound_ms(nbytes: float, flops: float) -> Tuple[float, str]:
    """The least milliseconds the card could take for ``nbytes`` moved and
    ``flops`` float32 operations: the larger of the two terms, and which
    one it is (``"bytes"`` or ``"operations"``)."""
    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# Work models of the reference (same names, same formulas)
# ---------------------------------------------------------------------------

def ell_spmv_bytes(n: int, ell_width: int, k: int,
                   dtype_bytes: int = 4, idx_bytes: int = 4) -> int:
    """Stream traffic of one batched ELL spmv ``y[n,k] = A @ x[n,k]``: the
    idx/val slabs read once, a k-wide row of ``x`` gathered for *every*
    stored entry, ``y`` written once.  Perfect caching of ``x`` would cut
    the gather term to ``n*k`` (the launch bound,
    :func:`spmv_batched_launch`, counts that)."""
    slab = n * ell_width * (idx_bytes + dtype_bytes)
    gather = n * ell_width * k * dtype_bytes
    out = n * k * dtype_bytes
    return slab + gather + out


def ell_spmv_flops(n: int, ell_width: int, k: int) -> int:
    """2 flops (mul + add) per stored entry per right-hand-side column."""
    return 2 * n * ell_width * k


def vcycle_bytes(level_shapes, k: int, cheby_degree: int = 3,
                 dtype_bytes: int = 4) -> int:
    """Stream traffic of one unfused V-cycle over ``level_shapes = [(n,
    ell_width)]``: ``2*degree + 1`` spmvs a level (both smoothers and the
    residual), plus the restriction and prolongation (one k-wide read and
    write of the level each).  The coarsest dense solve is excluded."""
    total = 0
    for n, width in level_shapes:
        total += (2 * cheby_degree + 1) * ell_spmv_bytes(
            n, width, k, dtype_bytes=dtype_bytes)
        total += 2 * 2 * n * k * dtype_bytes   # restrict + prolong r/w
    return total


def hierarchy_level_shapes(hierarchy) -> list:
    """``[(n, ell_width)]`` of each fine level, for :func:`vcycle_bytes`."""
    return [(int(lev.n), int(lev.idx.shape[1]))
            for lev in hierarchy.levels]


def fused_smoother_bytes(n: int, ell_width: int, k: int,
                         cheby_degree: int = 3, with_guess: bool = False,
                         dtype_bytes: int = 4, idx_bytes: int = 4) -> int:
    """Traffic of one fused Chebyshev sweep with the level held on chip:
    slab, diagonal and ``r`` (and the initial iterate on post-smooth
    sweeps) read once, the smoothed ``z`` written once, whatever the
    degree."""
    del cheby_degree  # documents the degree independence
    slab = n * ell_width * (idx_bytes + dtype_bytes)
    vecs = (2 + (1 if with_guess else 0)) * n * k * dtype_bytes
    diag = n * dtype_bytes
    return slab + vecs + diag


def fused_restrict_residual_bytes(n: int, ell_width: int, k: int,
                                  n_coarse: int, dtype_bytes: int = 4,
                                  idx_bytes: int = 4) -> int:
    """Traffic of one fused restrict + residual pass, ``rc =
    segment_sum(r - L z, agg)``: slab, agg, ``r`` and ``z`` read, only the
    ``[n_coarse, k]`` coarse residual written."""
    slab = n * ell_width * (idx_bytes + dtype_bytes)
    vecs = 2 * n * k * dtype_bytes
    agg = n * idx_bytes
    out = n_coarse * k * dtype_bytes
    return slab + vecs + agg + out


def vcycle_bytes_fused(level_triples, k: int, cheby_degree: int = 3,
                       dtype_bytes: int = 4) -> int:
    """Traffic of one fused V-cycle over ``level_triples = [(n,
    ell_width, n_coarse)]``: a fused pre-smooth, a fused restrict +
    residual, the prolongation gather-add and a fused post-smooth a
    level."""
    total = 0
    for n, width, nc in level_triples:
        total += fused_smoother_bytes(n, width, k, cheby_degree,
                                      with_guess=False,
                                      dtype_bytes=dtype_bytes)
        total += fused_restrict_residual_bytes(n, width, k, nc,
                                               dtype_bytes=dtype_bytes)
        total += (nc * k + 2 * n * k) * dtype_bytes    # prolong gather-add
        total += fused_smoother_bytes(n, width, k, cheby_degree,
                                      with_guess=True,
                                      dtype_bytes=dtype_bytes)
    return total


def hierarchy_level_triples(hierarchy) -> list:
    """``[(n, ell_width, n_coarse)]`` of each fine level of a port
    :class:`~repro_torch.solver.hierarchy.Hierarchy`, for
    :func:`vcycle_bytes_fused` and the launch-limit check."""
    return [(int(lev.n), int(lev.idx.shape[1]), int(lev.n_coarse))
            for lev in hierarchy.levels]


def achieved_bandwidth(bytes_moved: float, seconds: float) -> dict:
    """Achieved bytes/s over a measured span and its share of the HBM
    rate."""
    if seconds <= 0:
        return {"bytes_per_s": 0.0, "frac_of_hbm": 0.0}
    bps = bytes_moved / seconds
    return {"bytes_per_s": bps, "frac_of_hbm": bps / HBM_BW}


# ---------------------------------------------------------------------------
# Launch bounds of the port's kernels: (bytes, operations) of one launch
# ---------------------------------------------------------------------------

def spmv_batched_launch(n: int, L: int, k: int, nx: int = None):
    """K1, ``y[n, k] = A x`` with ``x [nx, k]`` (``nx`` = ``n`` unless a
    halo extends it): the slabs, ``x`` and ``y`` once each; a multiply and
    an add a stored entry a column."""
    nx = n if nx is None else nx
    return n * L * (_I32 + _F32) + nx * k * _F32 + n * k * _F32, \
        2 * n * L * k


def cheby_step_launch(n: int, L: int, k: int):
    """K2, one recurrence step with its matvec: the slabs and ``inv_d``
    once, ``r``, ``z_prev`` and ``p`` read, ``p`` and ``z`` written; the
    matvec and six operations of the combines an element."""
    return n * L * (_I32 + _F32) + n * _F32 + n * k * _F32 * 5, \
        n * k * (2 * L + 6)


def cheby_smooth_zero_launch(n: int, L: int, k: int):
    """K2's zero-start launch at degree 2 (steps 1 and 2): the slabs,
    ``inv_d`` and ``r`` once, ``z`` written; each stored entry a column
    its neighbour's step-1 iterate (a multiply and a division) and the
    matvec's multiply and add, eight operations of the combines an
    element."""
    return n * L * (_I32 + _F32) + n * _F32 + n * k * _F32 * 2, \
        n * k * (4 * L + 8)


def cheby_prolong_step_launch(n: int, L: int, k: int, n_coarse: int):
    """K2's post-smooth, its first launch (step 1 from ``z + zc[agg]``):
    the slabs, ``inv_d``, ``agg``, ``r``, ``z`` and ``zc`` once, ``p`` and
    ``z1`` written; each stored entry a column the prolongation's add and
    the matvec's multiply and add, five operations an element."""
    return (n * L * (_I32 + _F32) + n * (_F32 + _I32) + n * k * _F32 * 4
            + n_coarse * k * _F32), n * k * (3 * L + 5)


def cheby_post_smooth_sweep(n: int, L: int, k: int, n_coarse: int):
    """K2's post-smooth as a whole (degree 2, the prolongation folded in),
    not one launch: the sweep's inputs (the slabs, ``inv_d``, ``agg``,
    ``r``, ``z`` and ``zc``) once and ``z`` written.  The step-1 ``p`` and
    ``z`` that its two launches pass through memory are their own traffic,
    not the sweep's: the second step's two-hop matvec needs every
    neighbour's step-1 iterate.  Operations: both steps'."""
    return (n * L * (_I32 + _F32) + n * (_F32 + _I32) + n * k * _F32 * 3
            + n_coarse * k * _F32), n * k * (5 * L + 11)


def restrict_residual_launch(n: int, L: int, k: int, n_coarse: int):
    """K3: the slabs, ``perm``, ``agg_ptr``, ``r`` and ``z`` once, the
    coarse residual written; the matvec, the subtraction and the member
    sum an element."""
    return (n * L * (_I32 + _F32) + n * _I32 + (n_coarse + 1) * _I32
            + n * k * _F32 * 2 + n_coarse * k * _F32), \
        n * k * (2 * L + 2)


def spmv_launch(n: int, L: int):
    """K5, one column: the slabs, ``x`` and ``y`` once."""
    return n * L * (_I32 + _F32) + n * _F32 * 2, 2 * n * L


def ssm_scan_launch(B: int, S: int, di: int, state: int, x_bytes: int,
                    bc_bytes: int):
    """K6 on ``x``/``dt`` of ``x_bytes`` a value and ``B``/``C`` of
    ``bc_bytes``: ``x`` and ``dt`` read, ``y`` written in float32, ``B``
    and ``C`` read, ``A`` read, ``h0`` read and ``hT`` written; six
    operations a (batch, step, channel, state) cell and one a (batch,
    step, channel)."""
    cells = B * S * di * state
    nbytes = (2 * B * S * di * x_bytes + 4 * B * S * di
              + 2 * B * S * state * bc_bytes + 4 * di * state
              + 8 * B * di * state)
    return nbytes, 6 * cells + B * S * di


def ssm_scan_expf_ms(B: int, S: int, di: int, state: int,
                     sm_clock_mhz: float) -> float:
    """K6's exponentials at the SFUs' issue rate: one ``expf`` a cell,
    :data:`EXP_PER_CLOCK_SM` a clock on each of :data:`SMS` SMs at
    ``sm_clock_mhz`` (the card's maximum SM clock as ``nvidia-smi``
    reports it)."""
    return B * S * di * state / (EXP_PER_CLOCK_SM * SMS
                                 * sm_clock_mhz * 1e6) * 1e3


def ssm_scan_bwd_launch(B: int, S: int, di: int, state: int, x_bytes: int,
                        bc_bytes: int):
    """K6b on ``x``/``dt`` of ``x_bytes`` a value and ``B``/``C`` of
    ``bc_bytes``: the inputs read once (``x``, ``dt``, ``B``, ``C``,
    ``A``, ``h0``, ``dy`` and ``dhT``, the last two float32) and the
    outputs written once (``dx``, ``ddt``, ``dB``, ``dC``, ``dA``,
    ``dh0``, float32); 23 operations a (batch, step, channel, state) cell
    (5 to recompute the state, 16 in the reverse step, 2 in the sums of
    ``dB`` and ``dC`` over the channels; an exponential counts one) and 5
    a (batch, step, channel)."""
    cells = B * S * di * state
    nbytes = (2 * B * S * di * x_bytes + 2 * B * S * state * bc_bytes
              + 4 * di * state + 8 * B * di * state + 4 * B * S * di
              + 8 * B * S * di + 8 * B * S * state + 4 * di * state
              + 4 * B * di * state)
    return nbytes, 23 * cells + 5 * B * S * di


def ssm_scan_bwd_checkpoint_bytes(B: int, S: int, di: int, state: int,
                                  run: int) -> int:
    """The size of K6b's float32 checkpoints: the state before each run of
    ``run`` steps but the first, ``[B, ceil(S / run) - 1, state, di]``.
    Its forward pass writes them once and its reverse pass reads them
    once."""
    return 4 * B * max(0, -(-S // run) - 1) * di * state


def ssm_scan_bwd_partial_bytes(B: int, S: int, di: int, state: int) -> int:
    """The size of K6b's float32 partial sums: ``dB`` and ``dC`` a block of
    32 channels and step, ``[B, S, ceil(di / 32), 2 state]``, and ``dA`` a
    row, ``[B, di, state]``.  Its scan writes them once and its reduction
    reads them once."""
    return 4 * (B * S * -(-di // 32) * 2 * state + B * di * state)


def ssm_scan_bwd_design(B: int, S: int, di: int, state: int, x_bytes: int,
                        bc_bytes: int, run: int):
    """K6b's own design on top of :func:`ssm_scan_bwd_launch`: its
    checkpoints and partial sums written and read once each, and 28
    operations a (batch, step, channel, state) cell, the function's 23
    and the 5 of its second pass of the forward recurrence."""
    nbytes, _ = ssm_scan_bwd_launch(B, S, di, state, x_bytes, bc_bytes)
    scratch = (ssm_scan_bwd_checkpoint_bytes(B, S, di, state, run)
               + ssm_scan_bwd_partial_bytes(B, S, di, state))
    return nbytes + 2 * scratch, 28 * B * S * di * state + 5 * B * S * di


def similarity_mark_launch(args):
    """K4 on these inputs, ``args = (csu, csv, cbeta, cseg, esu, esv,
    eseg)``: every row's subtask id read and its output byte written, the
    candidates read once, and the two signatures of only those rows that a
    recovered candidate (``cbeta >= 0``) of their own subtask could mark;
    operations, the 4 compares of each (c1)^2-grid pair with ``a + b <=
    min(beta, c1 - 1)`` of every (row, same-subtask candidate) pair.

    Returns ``(bytes, operations, sig_rows, cells)``: the rows in the
    recovered candidates' subtasks and the (row, candidate, pair) cells."""
    csu, csv, cbeta, cseg, esu, esv, eseg = args
    K, c1 = csu.shape
    m = esu.shape[0]
    live_segs = torch.unique(cseg[cbeta >= 0])
    sig_rows = int(torch.isin(eseg, live_segs).sum())
    nbytes = m * (4 + 1) + sig_rows * 2 * c1 * 4 + K * (2 * c1 * 4 + 8)
    a = torch.arange(c1, device=cseg.device)
    apb = a[:, None] + a[None, :]
    pairs = ((apb[None] <= torch.clamp(cbeta, max=c1 - 1)[:, None, None])
             .flatten(1).sum(1))                       # [K], 0 if beta < 0
    lo = int(torch.minimum(eseg.min(), cseg.min()))
    seg_rows = torch.bincount((eseg - lo).long(),
                              minlength=int(cseg.max()) - lo + 1)
    rows_k = seg_rows[(cseg - lo).long()]              # rows of k's subtask
    cells = float((rows_k * pairs).sum())
    return nbytes, 4.0 * cells, sig_rows, cells


# ---------------------------------------------------------------------------
# The production job: one round of the inner recovery engine
# ---------------------------------------------------------------------------

def collective_bytes(count) -> Tuple[int, Dict[str, int]]:
    """Per-shard result bytes of the collectives in ``count`` (a
    :class:`repro_torch.core.collectives.CollectiveCount`), in all and by
    kind: the reference's ``collective_bytes`` reads them from the
    compiled HLO, the port counts them as they run."""
    return count.total, dict(count.per_kind)


def inner_round_work(m_loc: int, n_sh: int, block_size: int, c1: int,
                     mark_beta):
    """Operations and bytes of one shard's round of the inner engine
    (``repro_torch.core.distributed.inner_round``) on ``m_loc`` rows, each
    input read once and each output written once.

    Bytes: the status read and written (int8), the rows' two signatures
    and subtask ids (K4 reads every row of the one subtask), the block's
    candidate pack read from the shard's rows, and the gathered packs of
    all ``n_sh`` shards with their open counts (int32) landing in memory.
    Operations: the 4 compares of each (c1)^2-grid pair ``a + b <=
    min(beta, c1 - 1)`` of every (row, recovered candidate) pair, as
    :func:`similarity_mark_launch` counts them, and of every (candidate,
    candidate) pair of the in-block resolution at the full grid (``c1 (c1
    + 1) / 2`` pairs, ``beta >= c1 - 1``).  ``mark_beta`` is the block's
    marking betas (``-1`` where a candidate was not recovered), the
    round's own data."""
    B = block_size
    full = c1 * (c1 + 1) // 2
    a = torch.arange(c1)
    apb = a[:, None] + a[None, :]
    mb = torch.as_tensor(mark_beta).cpu()
    pairs = int((apb[None] <= torch.clamp(mb, max=c1 - 1)[:, None, None])
                .flatten(1).sum())                     # 0 where beta < 0
    ops = 4 * m_loc * pairs + 4 * B * B * full
    pack = B * (2 * c1 + 2) * _I32
    nbytes = (2 * m_loc + m_loc * (2 * c1 + 1) * _I32 + pack
              + n_sh * (pack + _I32))
    return float(ops), float(nbytes)


def roofline_terms(flops: float, bytes_hbm: float, bytes_coll: float):
    """Seconds of the three terms, as the reference's ``analyze`` forms
    them with the H100's rates: ``flops`` over :data:`F32_FLOPS`,
    ``bytes_hbm`` over :data:`HBM_BW`, ``bytes_coll`` over
    :data:`NVLINK_BW`; and the largest term's name."""
    terms = {"compute": flops / F32_FLOPS, "memory": bytes_hbm / HBM_BW,
             "collective": bytes_coll / NVLINK_BW}
    return dict(t_compute=terms["compute"], t_memory=terms["memory"],
                t_collective=terms["collective"],
                bottleneck=max(terms, key=terms.get))


# ---------------------------------------------------------------------------
# The LM dry run: roofline terms of a counted step, and the useful work
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Roofline:
    """The reference's roofline of one step on one device of a mesh, with
    the tensor cores' share of the flops beside the total (``flops_tc``,
    the port's: the reference counts every flop at one rate)."""
    flops: float              # per device
    bytes_hbm: float          # per device
    bytes_coll: float         # per device
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float = 0.0  # global 6ND / 2ND
    useful_ratio: float = 0.0
    per_kind: Dict[str, float] = dataclasses.field(default_factory=dict)
    dynamic_whiles: int = 0
    flops_tc: float = 0.0     # per device, of ``flops``: bf16 products

    def as_dict(self):
        return dataclasses.asdict(self)


def analyze(costs, n_devices: int, model_flops: float = 0.0) -> Roofline:
    """Roofline terms of a step counted whole (``costs``, a
    :class:`repro_torch.launch.hlo_costs.Costs` of the global step: its
    ``flops`` and ``bytes`` the work of every device together, its
    ``coll`` already per device) on a mesh of ``n_devices``.

    The work is split evenly over the devices.  That is a floor: the
    reference's figure, read from the partitioned program, also counts
    the work each device repeats (replicated norms, softmaxes, the
    optimizer on replicated leaves).  Terms: the products of bf16
    operands (``costs.flops_tc``) over :data:`BF16_TC_FLOPS` plus the rest
    of the flops over :data:`F32_FLOPS`; the bytes over :data:`HBM_BW`;
    the collective bytes over :data:`NVLINK_BW`.  ``useful_ratio`` is
    ``model_flops`` over the counted flops of all devices."""
    n = max(int(n_devices), 1)
    flops = float(costs.flops) / n
    flops_tc = float(costs.flops_tc) / n
    bytes_hbm = float(costs.bytes) / n
    per_kind = {k: float(v) for k, v in costs.coll.items()}
    bc = sum(per_kind.values())
    t_c = flops_tc / BF16_TC_FLOPS + (flops - flops_tc) / F32_FLOPS
    t_m = bytes_hbm / HBM_BW
    t_l = bc / NVLINK_BW
    terms = {"compute": t_c, "memory": t_m, "collective": t_l}
    useful = model_flops / (flops * n) if flops else 0.0
    return Roofline(flops=flops, bytes_hbm=bytes_hbm, bytes_coll=float(bc),
                    t_compute=t_c, t_memory=t_m, t_collective=t_l,
                    bottleneck=max(terms, key=terms.get),
                    model_flops=model_flops, useful_ratio=useful,
                    per_kind=per_kind, dynamic_whiles=costs.dynamic_whiles,
                    flops_tc=flops_tc)


def model_flops_estimate(model, cfg, shape) -> float:
    """The reference's 6 N D (train) or 2 N D (prefill, decode), ``N`` the
    *active* parameters of ``model`` (any device, ``meta`` too): an MoE's
    expert leaves (``*.moe.w1/w2/w3``) count ``top_k / n_experts`` of
    theirs, and the embedding table (``d_model`` x the vocabulary padded
    to 512) is left out; ``D`` the step's tokens (batch x sequence, batch
    x 1 in decode)."""
    total = 0
    expert = 0
    for name, p in model.named_parameters():
        parts = name.split(".")
        total += p.numel()
        if "moe" in parts and parts[-1] in ("w1", "w2", "w3"):
            expert += p.numel()
    n_active = total
    if cfg.n_experts:
        n_active = total - expert + expert * cfg.top_k // cfg.n_experts
    n_active -= cfg.d_model * (-(-cfg.vocab // 512) * 512)
    tokens = shape.batch * (shape.seq if shape.kind in ("train", "prefill")
                            else 1)
    mult = 6 if shape.kind == "train" else 2
    return float(mult * n_active * tokens)
