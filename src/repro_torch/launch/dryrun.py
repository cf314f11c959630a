"""The LM dry run: every (arch x shape x mesh) cell counted without the
mesh, and a cell run for real on one card.

The port of ``repro.launch.dryrun``.  The reference lowers and compiles
each cell for 256 or 512 forced host devices and reads the compiled
program's memory and costs.  The port has no compiler to ask: on the
``meta`` device (the default) :func:`run_cell` runs the cell's step once
at the global shape through the cost counter
(:func:`repro_torch.launch.hlo_costs.count_cell`, shapes only, no
memory), and reads the mesh from the placements
(:mod:`repro_torch.dist.sharding`).  One count serves both meshes.

A row keeps the reference's fields:

* ``n_devices``: the mesh's size.
* ``flops_per_dev``, ``hbm_bytes_per_dev``: the step's count over
  ``n_devices``, an even split.  That is a floor: the reference's figure,
  read from the partitioned program, also counts the work each device
  repeats.  The port's bytes are eager PyTorch's (every operator reads
  its operands and writes its results), above XLA's fused count.
* ``coll_bytes_per_dev``, ``coll_by_kind``: the closed form of
  :func:`~repro_torch.launch.hlo_costs.collectives_from_placements`.
* ``arg_gb``: exact, the step's arguments as the reference's step takes
  them, each leaf's bytes split over the mesh axes its placement names
  (a dimension that does not divide rounds up, as XLA pads a shard):
  the parameters; in a train step the AdamW ``m``, ``v`` and ``step``
  and the error feedback (a float32 scalar for each of the reference's
  stacked leaves, or a bf16 copy of the parameters with compression);
  the batch (:func:`batch_specs`) or the caches (:func:`cache_specs`), the
  token and the position.
* ``t_compute``, ``t_memory``, ``t_collective``, ``bottleneck``,
  ``model_flops``, ``useful_ratio``: :func:`repro_torch.launch.roofline.
  analyze` at the H100's rates and ``model_flops_estimate``.
* ``lower_s``: the count's seconds (the same on both meshes).
* ``compile_s``, ``temp_gb``, ``out_gb``: ``None``.  Nothing is compiled,
  and what a device holds beyond its arguments, or which placement XLA
  would give the outputs, is not counted.
* ``status``: ``ok``; ``skipped`` with the reference's reason; or, from
  :func:`main`, ``FAILED`` with the error and the trace.

With ``device="cuda"`` the row also carries ``card``, the cell run for
real on one card at full width: the batch cut to what one card holds
(:data:`CARD_BATCH`, listed in ``reduced``; the depth too where the
caller asks), random weights (seed 0) and tokens, zero caches.  ``device="cpu"`` runs the same on the CPU under
``cpu`` (tests, at a reduced config through ``cfg_overrides``).

Usage (``PYTHONPATH=src``)::

  python -m repro_torch.launch.dryrun --mesh both --out /tmp/dry
  python -m repro_torch.launch.dryrun --arch hymba-1.5b --shape train_4k \\
      --mesh single --device cuda
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import time
import traceback
from typing import Optional

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.dist.sharding import leaf_pspecs
from repro_torch.launch import hlo_costs
from repro_torch.launch import roofline as roof_mod
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.shapes import SHAPES, applicability, input_specs
from repro_torch.models import model as model_mod
from repro_torch.train.trainer import TrainConfig

#: a card run's batch for each shape: the 16x16 mesh's per-device share
#: (the shape's batch over the 16 of its ``data`` axis) at most, cut to
#: what one 80 GB card holds at hymba-1.5b's full width (train_4k at B = 4
#: peaks at 48.3 GB, PERF.md section 5)
CARD_BATCH = {"train_4k": 4, "prefill_32k": 1, "decode_32k": 8,
              "long_500k": 1}
_SINGLE_DATA = 16          # the data axis of the single-pod mesh


def _dp(mesh):
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def _dp_size(mesh):
    return math.prod(mesh.shape[a] for a in _dp(mesh))


def batch_specs(batch, mesh):
    """The reference's placement of each batch leaf, as axes per dim: the
    batch dim over the data axes when they divide it, else replicated."""
    dp = _dp(mesh)
    size = _dp_size(mesh)
    dp_spec = dp if len(dp) > 1 else dp[0]

    def rule(x):
        if x.dim() and x.shape[0] % size == 0 and x.shape[0] >= size:
            return (dp_spec,) + (None,) * (x.dim() - 1)
        return (None,) * x.dim()

    return {k: rule(v) for k, v in batch.items()}


def cache_specs(caches, mesh):
    """The reference's placement of the decode caches, as axes per dim:
    the batch over the data axes when they divide it, else the cache
    length (the 500k single-stream cell's sequence sharding); K/V heads
    and SSM channels over ``model`` when it divides them."""
    dp = _dp(mesh)
    size = _dp_size(mesh)
    dp_spec = dp if len(dp) > 1 else dp[0]
    tp = mesh.shape.get("model", 1)

    def leaf_rule(name, x):
        B = x.shape[0] if x.dim() else 1
        b_ok = B % size == 0 and B >= size
        if name in ("k", "v", "ek", "ev"):      # [B, C, KV, hd]
            kv = "model" if x.shape[2] % tp == 0 and x.shape[2] >= tp \
                else None
            if b_ok:
                return (dp_spec, None, kv, None)
            if x.shape[1] % size == 0:
                return (None, dp_spec, kv, None)
            return (None,) * 4
        if name == "pos":                        # [B, C]
            if b_ok:
                return (dp_spec, None)
            if x.shape[1] % size == 0:
                return (None, dp_spec)
            return (None, None)
        if name == "h":                          # [B, di, state]
            return (dp_spec if b_ok else None,
                    "model" if x.shape[1] % tp == 0 else None, None)
        if name == "conv":                       # [B, k-1, di]
            return (dp_spec if b_ok else None, None,
                    "model" if x.shape[2] % tp == 0 else None)
        return (None,) * x.dim()

    return [{k: leaf_rule(k, v) for k, v in c.items()} for c in caches]


def shard_bytes(shape, itemsize: int, spec, mesh) -> int:
    """One device's bytes of a leaf of ``shape`` placed by ``spec``: each
    dimension split over its axes, rounded up."""
    n = itemsize
    for d, ax in zip(shape, spec):
        n *= -(-d // hlo_costs.axis_size(ax, mesh.shape))
    return n


def arg_bytes(model, cfg, shape, mesh, specs, tcfg=None) -> int:
    """One device's bytes of the step's arguments (see the module's
    ``arg_gb``), ``specs`` the cell's :func:`~repro_torch.launch.shapes.
    input_specs`."""
    tcfg = tcfg or TrainConfig()
    leaves = leaf_pspecs(model, mesh.shape, expert_shard=cfg.expert_shard)
    itemsize = next(model.parameters()).element_size()
    params = sum(shard_bytes(shp, itemsize, spec, mesh)
                 for shp, spec in leaves.values())
    total = params
    if shape.kind == "train":
        state = 2 if tcfg.opt.state_dtype == "bfloat16" else 4
        total += 2 * sum(shard_bytes(shp, state, spec, mesh)
                         for shp, spec in leaves.values()) + 4
        total += (sum(shard_bytes(shp, 2, spec, mesh)
                      for shp, spec in leaves.values())
                  if tcfg.compress_grads else 4 * len(leaves))
    if shape.kind in ("train", "prefill"):
        bs = batch_specs(specs, mesh)
        return total + sum(shard_bytes(v.shape, v.element_size(), bs[k],
                                       mesh) for k, v in specs.items())
    cs = cache_specs(specs["caches"], mesh)
    for c, s in zip(specs["caches"], cs):
        total += sum(shard_bytes(v.shape, v.element_size(), s[k], mesh)
                     for k, v in c.items())
    tok = specs["token"]
    return total + shard_bytes(tok.shape, tok.element_size(),
                               batch_specs({"t": tok}, mesh)["t"], mesh) + 4


def run_cell(arch: str, shape_name: str, mesh, mesh_name: str,
             tcfg: Optional[TrainConfig] = None, verbose: bool = True,
             cfg_overrides: Optional[dict] = None, device="meta",
             cache: Optional[dict] = None, run_batch: Optional[int] = None,
             run_seq: Optional[int] = None, run_calls: int = 2,
             run_layers: Optional[int] = None):
    """One row of the dry run (the module says what it holds).

    ``cache``, a dict the caller keeps across calls, holds each (arch,
    shape, overrides, train config)'s count, so the two meshes share one.
    With ``device`` ``"cuda"`` (or ``"cpu"``) the cell also runs for real
    there at batch ``run_batch`` (default :data:`CARD_BATCH`), sequence
    ``run_seq`` (default the shape's) and depth ``run_layers`` (default
    the config's): one first call, then ``run_calls`` timed calls (none:
    the first call is the time).  The row itself is the whole config's."""
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name]
    row = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "kind": shape.kind, "n_devices": mesh.size}
    reason = applicability(cfg, shape)
    if reason:
        row.update(status="skipped", reason=reason)
        return row
    tcfg = tcfg or TrainConfig()
    key = (arch, shape_name, tuple(sorted((cfg_overrides or {}).items())),
           tcfg)
    if cache is not None and key in cache:
        costs, lower_s = cache[key]
    else:
        t0 = time.perf_counter()
        costs = hlo_costs.count_cell(cfg, shape, tcfg)
        lower_s = time.perf_counter() - t0
        if cache is not None:
            cache[key] = (costs, lower_s)
    model = model_mod.init_params(cfg, device="meta")
    specs = input_specs(cfg, shape)
    coll = hlo_costs.collectives_from_placements(model, cfg, shape,
                                                 mesh.shape, tcfg)
    mf = roof_mod.model_flops_estimate(model, cfg, shape)
    roof = roof_mod.analyze(dataclasses.replace(costs, coll=coll),
                            mesh.size, model_flops=mf)
    row.update(
        status="ok",
        lower_s=round(lower_s, 2),
        compile_s=None,
        arg_gb=round(arg_bytes(model, cfg, shape, mesh, specs, tcfg)
                     / 2**30, 3),
        temp_gb=None,
        out_gb=None,
        flops_per_dev=roof.flops,
        hbm_bytes_per_dev=roof.bytes_hbm,
        coll_bytes_per_dev=roof.bytes_coll,
        coll_by_kind=roof.per_kind,
        t_compute=roof.t_compute,
        t_memory=roof.t_memory,
        t_collective=roof.t_collective,
        bottleneck=roof.bottleneck,
        model_flops=mf,
        useful_ratio=round(roof.useful_ratio, 4),
    )
    if verbose:
        print(f"[{mesh_name}] {arch} x {shape_name}: OK "
              f"count={lower_s:.1f}s args={row['arg_gb']}GB "
              f"bottleneck={roof.bottleneck} "
              f"tc={roof.t_compute:.3e}s tm={roof.t_memory:.3e}s "
              f"tl={roof.t_collective:.3e}s useful={row['useful_ratio']}",
              flush=True)
    if torch.device(device).type != "meta":
        dev = torch.device(device).type
        row["card" if dev == "cuda" else dev] = run_on_device(
            cfg, shape, tcfg, device, run_batch, run_seq, run_calls,
            run_layers)
        if verbose:
            print(f"[{mesh_name}] {arch} x {shape_name} on {dev}: "
                  f"{json.dumps(row.get('card', row.get(dev)))}", flush=True)
    return row


def _fill(specs, cfg, gen):
    """Random tokens (the vocabulary) and float inputs (normals) in place
    of the stand-ins' zeros, from ``gen``; caches stay zero."""
    for k, v in specs.items():
        if k in ("tokens", "labels", "token"):
            v.copy_(torch.randint(0, cfg.vocab, v.shape, generator=gen,
                                  device=v.device, dtype=v.dtype))
        elif k in ("frontend", "src"):
            v.normal_(generator=gen)


def run_on_device(cfg, shape, tcfg, device, batch=None, seq=None,
                  calls: int = 2, layers=None) -> dict:
    """The cell ``(cfg, shape)`` run for real on ``device``: its record.

    ``batch`` (default :data:`CARD_BATCH`, at most the 16x16 mesh's
    per-device share) and ``seq`` (default the shape's) cut the shape,
    ``layers`` (default the config's) the depth, with the config's own
    layer kinds at that depth; each cut is listed in ``reduced``.
    Weights from seed 0, random tokens, zero caches.  ``compile_s`` is the first call's seconds (the
    kernels' build and first launches included), then
    ``calls`` calls timed one by one (CUDA events on the card, the host
    clock on the CPU) give ``step_ms``, their median; with ``calls`` 0,
    ``step_ms`` is the first call's.  ``bound_ms`` is ``max(t_compute,
    t_memory)`` of the cut cell's count on ``meta`` (one device);
    ``launches`` the K6 and K6b launches of the first call beside
    ``counted``, the counter's calls of the two at the cut shape.  On the
    card ``peak_bytes`` is the allocator's peak over the calls and
    ``arg_bytes`` what the cell allocated before the first (weights,
    optimizer state, inputs), both above what was allocated before the
    cell, and ``temp_gb`` their difference.  ``finite``: the
    loss, or the logits, are finite after every call."""
    from repro_torch.kernels import ops as kops

    dev = torch.device(device)
    share = max(shape.batch // _SINGLE_DATA, 1)
    B = batch or min(share, CARD_BATCH[shape.name])
    S = seq or shape.seq
    reduced = []
    if B != shape.batch:
        reduced.append(f"batch {shape.batch} -> {B} (the 16x16 mesh's "
                       f"per-device share is {share})")
    if S != shape.seq:
        reduced.append(f"seq {shape.seq} -> {S}")
    if layers and layers != cfg.n_layers:
        reduced.append(f"layers {cfg.n_layers} -> {layers}")
        cfg = dataclasses.replace(cfg, n_layers=layers,
                                  enc_layers=min(cfg.enc_layers, layers))
    cut = dataclasses.replace(shape, batch=B, seq=S)
    counted = hlo_costs.count_cell(cfg, cut, tcfg)
    bound = roof_mod.analyze(counted, 1)
    bound_ms = max(bound.t_compute, bound.t_memory) * 1e3
    bound_by = "operations" if bound.t_compute >= bound.t_memory \
        else "bytes"

    gen = torch.Generator(device=dev).manual_seed(0)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated() if on_card else 0
    step, args = hlo_costs.step_inputs(cfg, cut, tcfg, dev, gen)
    _fill(args[-1] if cut.kind != "decode" else {"token": args[2]}, cfg,
          gen)
    args_bytes = (torch.cuda.memory_allocated() - before) if on_card \
        else None
    args = list(args)

    def call():
        out = step(*args)
        if cut.kind == "train":
            args[1] = out[0]               # the new AdamW state
            return out[2]["loss"]
        return out[0]

    def sync():
        if on_card:
            torch.cuda.synchronize()

    finite = True
    kops.reset_launches()
    sync()
    t0 = time.perf_counter()
    out = call()
    sync()
    compile_s = time.perf_counter() - t0
    launches = {k: kops.launch_counts()[k] for k in hlo_costs.KERNEL_OPS}
    finite &= bool(torch.isfinite(out).all())
    times = []
    for _ in range(calls):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = call()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            out = call()
            times.append((time.perf_counter() - t0) * 1e3)
        finite &= bool(torch.isfinite(out).all())
    step_ms = statistics.median(times) if times else compile_s * 1e3
    rec = dict(device=str(dev), batch=B, seq=S, layers=cfg.n_layers,
               reduced=reduced,
               calls=calls, compile_s=compile_s, step_ms=step_ms,
               bound_ms=bound_ms, bound_by=bound_by,
               step_over_bound=step_ms / bound_ms if bound_ms else None,
               launches=launches, counted=counted.kernel_calls(),
               finite=finite, peak_bytes=None, arg_bytes=args_bytes,
               temp_gb=None)
    if on_card:
        peak = torch.cuda.max_memory_allocated() - before
        rec.update(peak_bytes=peak, temp_gb=(peak - args_bytes) / 2**30)
    del args, out
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments")
    ap.add_argument("--compress", action="store_true",
                    help="int8+EF gradient compression in train cells")
    ap.add_argument("--device", default="meta",
                    help="meta (count only); cuda or cpu also run each "
                         "cell there")
    args = ap.parse_args(argv)

    archs = ARCHS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    tcfg = TrainConfig(compress_grads=args.compress)
    cache: dict = {}
    all_rows = []
    t_all = time.perf_counter()
    for multi in meshes:
        mesh = make_production_mesh(multi_pod=multi, device="meta")
        mesh_name = "2x16x16" if multi else "16x16"
        for arch in archs:
            for shape in shapes:
                try:
                    row = run_cell(arch, shape, mesh, mesh_name, tcfg,
                                   cache=cache, device=(
                                       args.device if not multi else "meta"))
                except Exception as e:  # a failing cell is a bug: record it
                    row = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "status": "FAILED", "error": repr(e),
                           "trace": traceback.format_exc()[-2000:]}
                    print(f"[{mesh_name}] {arch} x {shape}: FAILED {e}",
                          flush=True)
                all_rows.append(row)
                tag = f"{args.arch}_{args.shape}_{args.mesh}".replace("/", "_")
                with open(os.path.join(args.out, f"dryrun_{tag}.json"),
                          "w") as f:
                    json.dump(all_rows, f, indent=1)
    n_ok = sum(r["status"] == "ok" for r in all_rows)
    n_skip = sum(r["status"] == "skipped" for r in all_rows)
    n_fail = sum(r["status"] == "FAILED" for r in all_rows)
    print(f"\ndone: {n_ok} ok, {n_skip} skipped, {n_fail} failed in "
          f"{time.perf_counter() - t_all:.1f} s")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
