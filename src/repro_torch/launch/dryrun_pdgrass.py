"""Dry run of the paper's own workload: the inner recovery engine on the
production mesh, at the config's size, on real signatures.

The port of ``repro.launch.dryrun_pdgrass``.  The reference lowers one
shard-mapped inner round engine on 256 or 512 forced host devices and
reads XLA's memory and cost analyses; it never runs a round.  The port has
no compiler to ask, and its mesh stacks every shard on one device, so it
runs rounds: one giant subtask of ``cfg.m_offtree`` off-tree rows (2^25)
split over ``make_production_mesh``'s 256 or 512 shards.

The rows are real.  The default graph is ``mesh2d(4096, 4096, seed=0)``
(n = 16,777,216, m = 50,315,265: 33,538,050 off-tree edges, padded to
2^25 rows); its signatures and betas come from the port's own
``Pipeline(pdgrass_config(c=cfg.c)).prepare``.  ``seg`` is 0 on every edge
row and -1 on padding: one subtask, which is what the config's inner
engine recovers.

A row holds the reference's fields, each meaning here:

  * ``arch``, ``shape``, ``mesh``, ``status``: as in the reference.
  * ``compile_s``: seconds from the start to the end of the first round
    (the lazy K4 build and the allocations; there is no compiler).
  * ``arg_gb``: a shard's argument bytes as XLA's per-device
    ``argument_size_in_bytes`` counts them, ``m/P * (2 (c+1) + 2) * 4``,
    in GiB rounded to 3 places as the reference rounds it (``arg_bytes``
    unrounded).
  * ``temp_gb``: the measured peak of allocated device memory over what
    was allocated before the rounds (the arguments), for the whole stacked
    mesh on the card; ``None`` on the CPU.
  * ``flops_per_dev``, ``hbm_bytes_per_dev``: one shard's first round,
    from :func:`repro_torch.launch.roofline.inner_round_work` on that
    round's recovered candidates.
  * ``coll_bytes_per_dev``, ``coll_by_kind``: the collectives counted
    over the first round and its loop test
    (:func:`repro_torch.core.collectives.count_collectives`), a shard's
    result bytes by kind.
  * ``t_compute``, ``t_memory``, ``t_collective``, ``bottleneck``: those
    three over the H100's float32, HBM and NVLink rates (seconds a round,
    :func:`repro_torch.launch.roofline.roofline_terms`).
  * ``dynamic_whiles``: 1, the engine's round loop.

and, beyond the reference's: ``rounds_run``; ``round_ms``, the median
device time of a round after the first (CUDA events around the loop test
and the round; the loop test syncs the host, so this includes the
device's idle gaps); ``round_wall_ms``, its host-clock median;
``busy_share``, the device's kernel time over the wall of the last
``PROFILE_ROUNDS`` rounds, run under ``torch.profiler`` and left out of
the medians, and ``top_kernels_ms``, the four device ops that took the
most of it, in ms a round; ``card_bound_ms``, the least time of a round
of the whole stacked mesh on the one card, ``P * max(t_compute,
t_memory)`` (the card does every shard's work; its collectives are
reshapes and move nothing between cards), to hold ``round_ms`` against;
``arg_bytes``; ``device``; and ``prep_s``, the preparation's seconds by
stage.  On the CPU the device fields are
``None``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_pdgrass --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun_pdgrass \
        --device cpu --small --rounds 0
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import threading
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.pdgrass_graph import CONFIG, PdGrassConfig
from repro_torch.core import distributed as dist
from repro_torch.core.collectives import count_collectives
from repro_torch.core.graph import mesh2d
from repro_torch.launch import roofline as roof
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.obs import get_tracer
from repro_torch.pipeline import Pipeline, pdgrass_config

ROUNDS = 16              # rounds a mesh runs on the card
PROFILE_ROUNDS = 3       # of them, the last ones under torch.profiler
GRAPH = (4096, 4096)     # mesh2d's side: 33,538,050 off-tree edges
# the small config the CPU runs: mesh2d(45, 45)'s 3,872 off-tree rows,
# padded to 2^12
SMALL = (dataclasses.replace(CONFIG, n_vertices=45 * 45, m_offtree=2 ** 12),
         (45, 45))


class Rows(NamedTuple):
    """One subtask's rows padded to ``m_offtree``: signatures ``[m, c+1]``,
    ``beta``, ``seg`` (0 on the ``m_edges`` edge rows, -1 after)."""

    sig_u: torch.Tensor
    sig_v: torch.Tensor
    beta: torch.Tensor
    seg: torch.Tensor
    m_edges: int
    prep_s: dict


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def production_rows(cfg: PdGrassConfig = CONFIG, graph=None, *,
                    device="cuda") -> Rows:
    """The off-tree rows of ``graph`` (default ``mesh2d(4096, 4096,
    seed=0)``) as one subtask of ``cfg.m_offtree`` rows, prepared on
    ``device``.  Prints the seconds of each preparation stage."""
    prep_s = {}
    t0 = time.perf_counter()
    if graph is None:
        graph = mesh2d(*GRAPH, seed=0)
        prep_s["graph"] = time.perf_counter() - t0
    tracer = get_tracer()
    was_on = tracer.enabled
    tracer.enable()
    # this thread's spans from here on; a caller's events stay as they are
    mark, tid = time.perf_counter_ns(), threading.get_ident()
    t0 = time.perf_counter()
    try:
        prep = Pipeline(pdgrass_config(c=cfg.c, chunk=cfg.chunk)).prepare(
            graph, device=device)
        _sync(device)
    finally:
        if not was_on:
            tracer.disable()
    prep_s["prepare"] = time.perf_counter() - t0
    for ev in tracer.events():
        if ev["ts_ns"] >= mark and ev["tid"] == tid and \
                ev["name"].startswith("pipeline.") and \
                ev["name"] != "pipeline.prepare":
            prep_s[ev["name"]] = prep_s.get(ev["name"], 0.0) + \
                ev["dur_ns"] / 1e9
    prob = prep.problem
    m_edges = int(prep.off_edge_id.shape[0])
    m = cfg.m_offtree
    if m_edges > m:
        raise ValueError(f"{m_edges} off-tree edges do not fit in the "
                         f"config's {m} rows")
    t0 = time.perf_counter()

    def pad(x):
        out = torch.full((m,) + tuple(x.shape[1:]), -1, dtype=torch.int32,
                         device=x.device)
        out[:m_edges] = x[:m_edges]
        return out

    seg = torch.full((m,), -1, dtype=torch.int32, device=prob.seg.device)
    seg[:m_edges] = 0
    rows = Rows(pad(prob.sig_u), pad(prob.sig_v), pad(prob.beta), seg,
                m_edges, prep_s)
    del prep, prob
    _sync(device)
    prep_s["pad"] = time.perf_counter() - t0
    print(f"pdgrass rows: graph n={graph.n} m={graph.m}, {m_edges} off-tree "
          f"edges padded to {m} rows; seconds "
          + ", ".join(f"{k} {v:.3f}" for k, v in prep_s.items()),
          flush=True)
    return rows


def _shards(rows: Rows, n_sh: int):
    return [x.reshape((n_sh, -1) + tuple(x.shape[1:]))
            for x in (rows.sig_u, rows.sig_v, rows.beta, rows.seg)]


def dry_run(rows: Rows, mesh, cfg: PdGrassConfig = CONFIG,
            rounds: Optional[int] = ROUNDS):
    """``rounds`` rounds (``None``: to the end) of the inner engine over
    every shard of ``mesh`` on ``rows``; on the card the last
    ``PROFILE_ROUNDS`` of at least ``PROFILE_ROUNDS + 2`` under
    ``torch.profiler``.  Returns (the row, the status ``[m]`` int8 after
    those rounds)."""
    n_sh = mesh.size
    m, c1 = rows.sig_u.shape
    if m % n_sh:
        raise ValueError(f"{m} rows do not split over {n_sh} shards")
    mesh.check_device(rows.seg.device, "the rows")
    m_loc = m // n_sh
    su, sv, be, sg = _shards(rows, n_sh)
    cuda = rows.seg.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    n_prof = PROFILE_ROUNDS if (cuda and rounds is not None
                                and rounds >= PROFILE_ROUNDS + 2) else 0

    t0 = time.perf_counter()
    status, r = dist.inner_init(sg, n_sh, cfg.block_size)
    walls, events, done = [], [], 0
    compile_s = first_mark = counted = busy_share = None
    while rounds is None or done < rounds - n_prof:
        w0 = time.perf_counter()
        ev = ((torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) if cuda else None)
        if ev:
            ev[0].record()
        with count_collectives() as count:
            if not dist.inner_open(status):
                break
            status, mark_beta = dist.inner_round(su, sv, be, status, r)
        if ev:
            ev[1].record()
        _sync(rows.seg.device)
        walls.append((time.perf_counter() - w0) * 1e3)
        events.append(ev)
        if done == 0:
            compile_s = time.perf_counter() - t0
            first_mark, counted = mark_beta, count
        done += 1
    top = None
    if n_prof and done == rounds - n_prof:
        from torch.profiler import ProfilerActivity, profile as tprofile

        activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        # a process's first profiled window misses device events
        with tprofile(activities=activities):
            dist.inner_open(status)
        w0 = time.perf_counter()
        with tprofile(activities=activities) as prof:
            for _ in range(n_prof):
                if not dist.inner_open(status):
                    break
                status, _ = dist.inner_round(su, sv, be, status, r)
                done += 1
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - w0) * 1e3
        by_name = {}
        for e in prof.events():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False)):
                by_name[e.name] = by_name.get(e.name, 0.0) + \
                    e.time_range.elapsed_us() / 1e3 / n_prof
        busy_share = sum(by_name.values()) * n_prof / wall_ms
        top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:4])
    if compile_s is None:        # nothing was open
        compile_s = time.perf_counter() - t0

    later = events[1:]
    round_ms = (float(np.median([a.elapsed_time(b) for a, b in later]))
                if cuda and later else None)
    arg_bytes = m_loc * (2 * c1 + 2) * 4
    if counted is not None:
        flops, nbytes = roof.inner_round_work(m_loc, n_sh, cfg.block_size,
                                              c1, first_mark)
        coll, by_kind = roof.collective_bytes(counted)
    else:
        flops = nbytes = 0.0
        coll, by_kind = 0, {}
    terms = roof.roofline_terms(flops, nbytes, coll)
    card_bound_ms = n_sh * max(terms["t_compute"], terms["t_memory"]) * 1e3
    mesh_name = "x".join(str(mesh.shape[a]) for a in mesh.axis_names)
    row = dict(
        arch="pdgrass-graph", shape=f"recover_m{m}", mesh=mesh_name,
        status="ok", compile_s=round(compile_s, 2),
        arg_gb=round(arg_bytes / 2 ** 30, 3),
        temp_gb=((torch.cuda.max_memory_allocated() - base) / 2 ** 30
                 if cuda else None),
        flops_per_dev=flops, hbm_bytes_per_dev=nbytes,
        coll_bytes_per_dev=coll, coll_by_kind=by_kind,
        **terms, dynamic_whiles=1,
        rounds_run=done, round_ms=round_ms,
        round_wall_ms=float(np.median(walls[1:])) if len(walls) > 1
        else None,
        busy_share=busy_share, top_kernels_ms=top,
        card_bound_ms=card_bound_ms, arg_bytes=arg_bytes,
        device=(torch.cuda.get_device_name(rows.seg.device) if cuda
                else "cpu"),
        prep_s=rows.prep_s)
    print(f"[{mesh_name}] pdgrass recover rounds: {done} rounds, first "
          f"{compile_s:.2f} s, round {round_ms} ms (device, median after "
          f"the first), wall {row['round_wall_ms']} ms, busy share "
          f"{busy_share}; args {row['arg_gb']} GB a shard, temp "
          f"{row['temp_gb']} GB; tc={terms['t_compute']:.3e} "
          f"tm={terms['t_memory']:.3e} tl={terms['t_collective']:.3e} "
          f"({terms['bottleneck']}) a shard's round; the stacked mesh's "
          f"bound on the card {card_bound_ms:.4f} ms a round", flush=True)
    return row, status.reshape(-1)


def run(multi_pod: bool, cfg: PdGrassConfig = CONFIG, *, graph=None,
        rows: Optional[Rows] = None, rounds: Optional[int] = ROUNDS,
        device="cuda") -> dict:
    """The reference's ``run``: the production mesh's row.  ``rows``
    (from :func:`production_rows`) are prepared from ``graph`` when not
    given."""
    if rows is None:
        rows = production_rows(cfg, graph, device=device)
    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    return dry_run(rows, mesh, cfg, rounds)[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments")
    ap.add_argument("--rounds", type=int, default=ROUNDS,
                    help="rounds a mesh runs; 0 runs to the end")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="mesh2d(45, 45) padded to 2^12 rows")
    args = ap.parse_args(argv)
    cfg, graph = CONFIG, None
    if args.small:
        cfg, side = SMALL
        graph = mesh2d(*side, seed=0)
    rows = production_rows(cfg, graph, device=args.device)
    out = []
    for multi in {"single": [False], "multi": [True],
                  "both": [False, True]}[args.mesh]:
        out.append(run(multi, cfg, rows=rows, rounds=args.rounds or None,
                       device=args.device))
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "dryrun_pdgrass.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}", flush=True)


if __name__ == "__main__":
    main()
