#!/usr/bin/env python3
"""Probe the port's LM training step on one NVIDIA GPU.

    python3 tools/train_probe.py                     # hymba-1.5b, 32 layers
    python3 tools/train_probe.py --layers 2 --batch 4 --seq 4096 --steps 3

Needs a CUDA device; exits non-zero without one.  Builds ``--arch`` at
full width on its first ``--layers`` layers (``init_params``,
``torch.Generator("cuda")`` seed 0) and runs ``--steps`` steps of
``make_train_step`` (AdamW at ``--lr``, warmup 2, cosine over
``--total-steps``; ``remat=True``) on batches of ``make_batch``, printing
each step's ms and loss, the peak memory and the kernel launches a step.
Then, unless ``--no-kernel``: K6b at the first Mamba layer's inputs of
the last step (as ``SsmScan`` hands them over) timed beside its bound
and, with ``--plain``, beside its plain version, and checked bitwise
against it; unless ``--no-profile``, one more step under
``torch.profiler``: device busy share and the top kernels.
"""
import argparse
import dataclasses
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--layers", type=int, default=0, help="0: all")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--total-steps", type=int, default=8,
                    help="the schedule's total_steps (at least --steps)")
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--no-kernel", action="store_true")
    ap.add_argument("--no-profile", action="store_true")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as kssm
    from repro_torch.launch import roofline as rf
    from repro_torch.models import model as mm
    from repro_torch.train import (AdamWConfig, TrainConfig, init_opt_state,
                                   make_batch, make_train_step)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model = mm.init_params(cfg, generator=torch.Generator("cuda").manual_seed(
        0), device="cuda")
    print(f"{cfg.name}: {cfg.n_layers} layers, {mm.param_count(model)} "
          f"parameters; B={args.batch} S={args.seq}", flush=True)
    tc = TrainConfig(opt=AdamWConfig(
        lr=args.lr, warmup_steps=2,
        total_steps=max(args.steps, args.total_steps)), remat=True)
    step_fn = make_train_step(cfg, tc)
    opt = init_opt_state(model, tc.opt)
    first = []
    bwd = kssm.ssm_scan_bwd

    def recording(*a):
        if not first:
            first.append([None if t is None else torch.empty_strided(
                t.size(), t.stride(), dtype=t.dtype,
                device=t.device).copy_(t) for t in a])
        return bwd(*a)

    def batch(i):
        return {k: torch.as_tensor(v, device="cuda") for k, v in
                make_batch(cfg, args.batch, args.seq, step=i).items()}

    torch.cuda.reset_peak_memory_stats()
    for i in range(args.steps):
        b = batch(i)
        kops.reset_launches()
        if i == args.steps - 1:
            kssm.ssm_scan_bwd = recording
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt, _, m = step_fn(model, opt, {}, b)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        kssm.ssm_scan_bwd = bwd
        n = {k: v for k, v in kops.launch_counts().items() if v}
        print(f"step {i}: {ms:.1f} ms, loss {float(m['loss']):.4f}, "
              f"launches {n}", flush=True)
    print(f"peak memory {torch.cuda.max_memory_allocated()} bytes",
          flush=True)

    if not args.no_kernel and first:
        a = first[0]
        x1, dt, Bm, Cm, A, h0, dy, dhT = a
        B, S, di = x1.shape
        state = A.shape[1]
        nbytes, ops = rf.ssm_scan_bwd_launch(B, S, di, state,
                                             x1.element_size(),
                                             Bm.element_size())
        bms, by = rf.bound_ms(nbytes, ops)
        dms, dby = rf.bound_ms(*rf.ssm_scan_bwd_design(
            B, S, di, state, x1.element_size(), Bm.element_size(),
            kssm.run_length()))
        got = kops.ssm_scan_bwd(*a)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        start.record()
        for _ in range(3):
            kops.ssm_scan_bwd(*a)
        end.record()
        torch.cuda.synchronize()
        k_ms = start.elapsed_time(end) / 3
        line = (f"K6b at layer 0: B={B} S={S} di={di} state={state} "
                f"{x1.dtype}, B strides {tuple(Bm.stride())}: {k_ms:.3f} ms; "
                f"bound {bms:.4f} ms ({by}), the design's (its "
                f"checkpoints, partial sums and recompute) {dms:.4f} ms "
                f"({dby})")
        if args.plain:
            t0 = time.perf_counter()
            want = ref.ssm_scan_bwd_ref(*a)
            torch.cuda.synchronize()
            p_ms = (time.perf_counter() - t0) * 1e3
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            line += f"; plain {p_ms:.1f} ms, bitwise {same}, max abs {err}"
        print(line, flush=True)

    if not args.no_profile:
        from torch.profiler import ProfilerActivity, profile

        b = batch(args.steps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            opt, _, _ = step_fn(model, opt, {}, b)
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        evs = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
        names = {}
        for e in evs:
            names[e.name] = names.get(e.name, 0.0) + e.time_range.elapsed_us()
        busy = sum(names.values()) / 1e3
        top = sorted(names.items(), key=lambda kv: -kv[1])[:12]
        print(f"profiled step: wall {wall:.1f} ms, device busy {busy:.1f} ms "
              f"(share {busy / wall:.3f}), {len(evs)} device ops; top: "
              + "; ".join(f"{n[:60]} {us / 1e3:.1f} ms" for n, us in top),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
