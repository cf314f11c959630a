#!/usr/bin/env python3
"""Probe the port's LM serving path on one NVIDIA GPU.

    python3 tools/lm_probe.py                       # falcon-mamba-7b
    python3 tools/lm_probe.py --arch gemma2-2b --depths 2,8,26 \
        --sandwich-off --no-profile

Needs a CUDA device; exits non-zero without one.  Builds the full-width
model of ``--arch`` as ``chip_smoke.py`` does (``init_params``,
``torch.Generator("cuda")`` seed 0) and prints:

  1. prefill against step-by-step decode on one 64-token prompt, for the
     first ``--depths`` layers of those weights, in bf16 and in float32
     compute: the max abs error, the largest logit, and the worst ratio of
     the error to the bar ``atol + rtol * |decode logit|`` at the bf16 bar
     (2e-2) and at the float32 bar (1e-5); with ``--sandwich-off`` (a
     config with sandwich norms) the same weights again without the
     post-norms, and the RMS of the residual and of each branch's output
     before and after its post-norm at a few layers of a float32 prefill;
  2. unless ``--no-profile``, ``torch.profiler`` traces of one prefill of
     the engine's padded batch (4 prompts of 2048, 1536, 1024 and 512
     tokens) and of three decode steps: device time by kernel, device ops
     a step, and the device's busy share of the step's wall time.
"""
import argparse
import dataclasses
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def first_layers(mm, state, cfg):
    """The model of ``cfg`` over the leaves of ``state`` it names."""
    sub = mm.LM(cfg, device="meta")
    keep = set(sub.state_dict())
    sub.load_state_dict({k: v for k, v in state.items() if k in keep},
                        assign=True)
    return sub


def branch_rms(mm, model, cfg, toks, layers):
    """The RMS of the residual and of each branch's output before and after
    its post-norm, at ``layers`` of a float32 prefill of ``toks``."""
    import torch
    from repro_torch.models import layers as L

    c = dataclasses.replace(cfg, dtype="float32")
    view = mm.cast_for_compute(model, c)
    x = mm.embed_tokens(view, c, toks)
    pos = torch.arange(toks.shape[1], device=toks.device)

    def rms(t):
        return float(t.pow(2).mean().sqrt())

    for i, (layer, kind) in enumerate(zip(view.layers, c.layer_kinds())):
        p = layer.attn.weights()
        q, k, v = L._qkv(mm._norm(x, layer.ln1, c), p, c)
        q, k = L.rope(q, pos, c.rope_theta), L.rope(k, pos, c.rope_theta)
        o = L.blockwise_attention(q, k, v, pos, pos, c, kind) @ p["wo"]
        on = mm._norm(o, layer.ln1_post, c, post=True)
        m = layer.mlp(mm._norm(x + on, layer.ln2, c))
        mn = mm._norm(m, layer.ln2_post, c, post=True)
        if i in layers:
            print(f"layer {i}: residual RMS {rms(x):.3f}, attention out RMS "
                  f"{rms(o):.4f} -> post-normed {rms(on):.3f}, MLP out RMS "
                  f"{rms(m):.4f} -> post-normed {rms(mn):.3f}", flush=True)
        x = x + on + mn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="falcon-mamba-7b")
    ap.add_argument("--depths", default="2,16,64")
    ap.add_argument("--sandwich-off", action="store_true")
    ap.add_argument("--no-profile", action="store_true")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.models import model as mm
    from repro_torch.serve import Engine, Request

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"nvidia-smi: {card}", flush=True)
    cfg = get_config(args.arch)
    model = mm.init_params(
        cfg, generator=torch.Generator("cuda").manual_seed(0), device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (2048, 1536, 1024, 512)]
    toks = torch.as_tensor(prompts[3][:64][None], device="cuda")

    # ---- 1. prefill against decode, by depth and compute type ----------
    state = model.state_dict()
    variants = [cfg.sandwich_norm] + ([False] if args.sandwich_off else [])
    for sandwich in variants:
        for depth in (int(d) for d in args.depths.split(",")):
            for dtype in ("bfloat16", "float32"):
                c = dataclasses.replace(cfg, n_layers=depth, dtype=dtype,
                                        sandwich_norm=sandwich)
                view = mm.cast_for_compute(first_layers(mm, state, c), c)
                lp, _ = mm.prefill(view, c, toks, 64)
                caches = mm.init_cache(c, 1, 64, device="cuda")
                for t in range(64):
                    ld, caches = mm.decode_step(view, c, caches,
                                                toks[:, t:t + 1], t)
                err = (lp - ld).abs()
                ratios = {bar: float((err / (bar + bar * ld.abs())).max())
                          for bar in (2e-2, 1e-5)}
                print(f"prefill vs decode, {cfg.name}, {depth} layers, "
                      f"{dtype}, sandwich norms {sandwich}: max abs err "
                      f"{float(err.max()):.4e}, max |logit| "
                      f"{float(ld.abs().max()):.4f}, worst err/bar at 2e-2 "
                      f"{ratios[2e-2]:.4f}, at 1e-5 {ratios[1e-5]:.4f}",
                      flush=True)
                del view, caches
    if args.sandwich_off and cfg.sandwich_norm:
        branch_rms(mm, model, cfg, toks, {0, 1, cfg.n_layers // 2,
                                          cfg.n_layers - 1})
    del state
    torch.cuda.empty_cache()
    if args.no_profile:
        print(f"nvidia-smi: {card}")
        return 0

    # ---- 2. where the serving time goes -------------------------------
    from torch.profiler import ProfilerActivity, profile

    eng = Engine(cfg, model, batch=4, cache_len=2080, device="cuda")
    eng.generate([Request(prompt=p, max_new=4) for p in prompts])  # warm-up
    S = max(len(p) for p in prompts)
    padded = np.zeros((4, S), np.int32)
    for i, p in enumerate(prompts):
        padded[i, S - len(p):] = p
    padded = torch.as_tensor(padded, device="cuda")
    _, caches = mm.prefill(eng.params, cfg, padded, S + 4)
    tok = torch.zeros((4, 1), dtype=torch.int32, device="cuda")

    def session(label, fn, n):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6 / n
        evs = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if not evs:
            print(f"{label}: the profiler recorded no device time",
                  flush=True)
            return False
        busy_us = sum(e.time_range.elapsed_us() for e in evs) / n
        names = {}
        for e in evs:
            names[e.name] = names.get(e.name, 0.0) + e.time_range.elapsed_us()
        top = sorted(names.items(), key=lambda kv: -kv[1])[:6]
        print(f"{label}: wall {wall_us / 1e3:.3f} ms, {len(evs) / n:.0f} "
              f"device ops, device busy {busy_us / 1e3:.3f} ms (busy share "
              f"{busy_us / wall_us:.3f}); top by device time: " + "; ".join(
                  f"{name[:70]} {us / n / 1e3:.3f} ms" for name, us in top),
              flush=True)
        return True

    ok = session("prefill (B=4, S=2048)",
                 lambda: mm.prefill(eng.params, cfg, padded, S + 4), 1)
    ok &= session("decode step (B=4)",
                  lambda: mm.decode_step(eng.params, cfg, caches, tok, S), 3)
    if not ok:
        return 1
    print(f"nvidia-smi: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
