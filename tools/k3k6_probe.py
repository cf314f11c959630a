#!/usr/bin/env python3
"""K3 (restrict + residual) and K6 (selective scan): the shipped kernels
beside the previous ones and beside design variants, at real inputs.

K3 runs at level 0 of the main path's hierarchy (``build_hierarchy`` on
``mesh2d(1024, 1024, seed=0)``, alpha 0.05, chunk 512, device contraction;
r and z from ``torch.Generator("cuda").manual_seed(1)``, k = 8), then at
every level.  K6 runs at layer 0's prefill inputs of falcon-mamba-7b as the
LM path serves it (``Engine(batch=4)``, prompts of 2048, 1536, 1024 and 512
tokens from ``default_rng(0)``, weights from ``torch.Generator("cuda")``
seed 0; a one-layer model draws the same embedding and layer-0 weights),
bf16 with B and C as strided views of the x_proj output.

Prints, for each kernel and variant of ``tools/k3k6_probe.cu``, whether it
is bitwise equal to the plain version and its device time, and, per level,
the previous and the shipped K3 with their bounds.  Times are CUDA events
over ``--reps`` calls queued behind a device sleep (the device's work
alone), taken in turns: every kernel in order, then in reverse order, so
each is timed twice and neither end of the list always runs first.
Needs an H100 and ``nvcc``:

    python3 tools/k3k6_probe.py [--reps 20] [--skip-k3] [--skip-k6]
                                [--sass k6.sass]
"""
import argparse
import ctypes
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))

from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import vcycle_fused as vf  # noqa: E402

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3, NVIDIA data sheet
F32_FLOPS = 67e12             # H100 SXM float32 outside the tensor cores
K3_VARIANTS = (0, 1, 2, 3, 4, 5, 6)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def build_probe(tmp, sass_path=None):
    so = os.path.join(tmp, "k3k6_probe.so")
    flags = [f for f in _build.NVCC_FLAGS]
    out = subprocess.run([_build._nvcc(), *flags, "-shared",
                          os.path.join(HERE, "k3k6_probe.cu"), "-o", so],
                         capture_output=True, text=True)
    if out.returncode != 0:
        sys.exit(f"nvcc failed:\n{out.stdout}\n{out.stderr}")
    for line in (out.stdout + out.stderr).splitlines():
        if "registers" in line or "Compiling entry" in line \
                or "spill" in line and "0 bytes spill" not in line:
            print(f"  ptxas: {line.strip()}")
    lib = ctypes.CDLL(so)
    lib.k3_probe.argtypes = [_I] + [_P] * 9 + [_I, _I, _I, _P]
    lib.k6_old.argtypes = [_P] * 8 + [_I, _I, _I, _P]
    lib.k6_new.argtypes = ([_I] * 3 + [_P] * 4 + [_L] * 4 + [_P] * 4
                           + [_I, _I, _I, _P])
    lib.k6_mode.argtypes = [_I] + lib.k6_new.argtypes[3:]
    for fn in (lib.k3_probe, lib.k6_old, lib.k6_new, lib.k6_mode):
        fn.restype = ctypes.c_int
    sass_histogram(so, sass_path)
    return lib


def sass_histogram(so, sass_path=None):
    """Opcode counts of the shipped K6 instance at state 16, bf16 inputs,
    and of K3 variant 5 at L = 7; the former's SASS is written to
    ``sass_path`` when one is given."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", so], capture_output=True,
                         text=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            funcs[name] = []
        elif name and line.strip().startswith("/*") and "*/" in line:
            body = line.split("*/", 1)[1].strip()
            if body and not body.startswith("/*"):
                funcs[name].append(body.rstrip(" ;"))
    for pattern, label in (("ssm_scan_kernelILi16ELi2ELi32E13__nv_bfloat16Lb1E",
                            "K6 state 16, 2 lanes, runs of 32, bf16, cp.async"),
                           ("k32v5ILi7ELi8E", "K3 variant 5, L = 7")):
        for fname, lines in funcs.items():
            if pattern in fname:
                ops = {}
                for ins in lines:
                    op = ins.split()[0]
                    if op.startswith("@"):
                        op = ins.split()[1]
                    op = op.split(".")[0]
                    ops[op] = ops.get(op, 0) + 1
                top = sorted(ops.items(), key=lambda kv: -kv[1])
                print(f"SASS {label}: {len(lines)} instructions; "
                      + ", ".join(f"{k} {v}" for k, v in top), flush=True)
                if "ssm" in pattern and sass_path:
                    with open(sass_path, "w") as f:
                        f.write("\n".join(lines))
                break


def device_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(1e8))   # the host queues every call meanwhile
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(fns, reps):
    """``{name: [ms, ms]}``: every function timed in order, then in
    reverse order."""
    names = list(fns)
    out = {name: [] for name in names}
    for name in names + names[::-1]:
        out[name].append(device_ms(fns[name], reps))
    return out


def stream():
    return torch.cuda.current_stream().cuda_stream


def checked(status, what):
    if status != 0:
        raise RuntimeError(f"{what}: cudaError {status}")


def bound_ms(nbytes, flops):
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3


def k3_bound(n, L, nc, k):
    nbytes = n * L * 8 + n * 4 + (nc + 1) * 4 + n * k * 4 * 2 + nc * k * 4
    return bound_ms(nbytes, n * k * (2.0 * L + 2))


def aggregate_copy(lev):
    """The level's slabs in aggregate order, rows padded to a multiple of
    4 (variants 3-5 read them)."""
    n, L = lev.idx.shape
    LP = (L + 3) // 4 * 4
    perm = lev.perm.long()
    idx_p = torch.zeros((n, LP), dtype=torch.int32, device="cuda")
    val_p = torch.zeros((n, LP), dtype=torch.float32, device="cuda")
    idx_p[:, :L] = lev.idx[perm]
    val_p[:, :L] = lev.val[perm]
    return idx_p, val_p


def k3_section(lib, reps):
    from repro_torch.core.graph import mesh2d
    from repro_torch.solver import build_hierarchy

    g = mesh2d(1024, 1024, seed=0)
    hier = build_hierarchy(g, alpha=0.05, chunk=512, contraction="device",
                           device="cuda")
    torch.cuda.synchronize()
    k = 8
    for i, lev in enumerate(hier.levels):
        sizes = torch.diff(lev.agg_ptr.long())
        print(f"K3 level {i}: n={lev.n} L={lev.idx.shape[1]} "
              f"n_coarse={lev.n_coarse} agg_max={lev.agg_max} members "
              f"a row {lev.n / max(1, lev.n_coarse):.3f}, aggregates of "
              f">= 32 members {int((sizes >= 32).sum())}", flush=True)

    def inputs(lev):
        gen = torch.Generator(device="cuda").manual_seed(1)
        r = torch.randn((lev.n, k), generator=gen, device="cuda")
        z = torch.randn((lev.n, k), generator=gen, device="cuda")
        return r, z

    def variant(lev, v, r, z, copy):
        n, L = lev.idx.shape
        rc = torch.empty((lev.n_coarse, k), device="cuda")

        def run():
            checked(lib.k3_probe(v, lev.idx.data_ptr(), lev.val.data_ptr(),
                                 lev.perm.data_ptr(), lev.agg_ptr.data_ptr(),
                                 copy[0].data_ptr(), copy[1].data_ptr(),
                                 r.data_ptr(), z.data_ptr(), rc.data_ptr(),
                                 lev.n_coarse, L, k, stream()),
                    f"K3 variant {v}")
            return rc
        return run

    lev = hier.levels[0]
    r, z = inputs(lev)
    copy = aggregate_copy(lev)
    args = (lev.idx, lev.val, lev.perm, lev.agg_ptr, lev.agg_max, r, z)
    want = ref.restrict_residual_ref(*args)
    fns = {}
    for v in K3_VARIANTS:
        fn = variant(lev, v, r, z, copy)
        got = fn().clone()
        print(f"K3 variant {v} at level 0: bitwise "
              f"{torch.equal(got, want)}, max abs err "
              f"{float((got - want).abs().max()):.3e}", flush=True)
        fns[f"v{v}"] = fn
    restrict = vf.make_fused_restrict_residual(*args[:5])
    print(f"K3 shipped at level 0: bitwise {torch.equal(restrict(r, z), want)}",
          flush=True)
    fns["shipped"] = lambda: restrict(r, z)
    n, L = lev.idx.shape
    b0 = k3_bound(n, L, lev.n_coarse, k)
    times = in_turns(fns, reps)
    for name, ts in times.items():
        print(f"K3 level 0 {name}: {np.mean(ts):.4f} ms ({ts[0]:.4f}, "
              f"{ts[1]:.4f}); {np.mean(ts) / b0:.2f}x the bound {b0:.4f} ms",
              flush=True)
    print(f"K3 aggregate-order copy: {copy[0].numel() * 8} bytes at level "
          f"0, {sum(lev.n * ((lev.idx.shape[1] + 3) // 4 * 4) * 8 for lev in hier.levels)}"
          f" over all levels", flush=True)

    per_level = []
    for i, lev in enumerate(hier.levels):
        r, z = inputs(lev)
        args = (lev.idx, lev.val, lev.perm, lev.agg_ptr, lev.agg_max, r, z)
        want = ref.restrict_residual_ref(*args)
        old = variant(lev, 0, r, z, (lev.idx, lev.val))
        restrict = vf.make_fused_restrict_residual(*args[:5])
        ok = torch.equal(old(), want) and torch.equal(restrict(r, z), want)
        ts = in_turns({"old": old, "new": lambda: restrict(r, z)}, reps)
        n, L = lev.idx.shape
        row = dict(level=i, n=n, L=L, n_coarse=lev.n_coarse,
                   agg_max=lev.agg_max, bitwise=ok,
                   old_ms=float(np.mean(ts["old"])),
                   new_ms=float(np.mean(ts["new"])),
                   bound_ms=k3_bound(n, L, lev.n_coarse, k))
        per_level.append(row)
        print(f"K3 per level: {json.dumps(row)}", flush=True)
    return per_level


def strided_copy(a):
    """A copy of ``a`` with ``a``'s strides (a plain clone of a strided
    view is contiguous)."""
    out = torch.empty_strided(a.size(), a.stride(), dtype=a.dtype,
                              device=a.device)
    return out.copy_(a)


class _FirstLaunch(Exception):
    pass


def layer0_inputs():
    from repro_torch.configs import get_config
    from repro_torch.models import model as mm
    from repro_torch.serve import Engine, Request

    cfg = dataclasses.replace(get_config("falcon-mamba-7b"), n_layers=1)
    model = mm.init_params(cfg, generator=torch.Generator("cuda").manual_seed(0),
                           device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (2048, 1536, 1024, 512)]
    eng = Engine(cfg, model, batch=4, cache_len=2048 + 32, device="cuda")
    from repro_torch.kernels import ssm_scan as kssm

    # the scan's autograd function calls the module's ssm_scan
    seen, scan = [], kssm.ssm_scan

    def record(*args):
        seen.append([strided_copy(a) for a in args])
        raise _FirstLaunch

    kssm.ssm_scan = record
    try:
        eng.generate([Request(prompt=p, max_new=32) for p in prompts])
    except _FirstLaunch:
        pass
    finally:
        kssm.ssm_scan = scan
    del eng, model
    torch.cuda.empty_cache()
    return seen[0]


def k6_section(lib, reps):
    args = layer0_inputs()
    x1, dt, Bm, Cm, A, h0 = args
    B, S, di = x1.shape
    print(f"K6 layer-0 inputs: x1 {tuple(x1.shape)} {x1.dtype}, Bm "
          f"{tuple(Bm.shape)} strides {Bm.stride()}, Cm strides "
          f"{Cm.stride()}, A {A.dtype}, h0 {h0.dtype}", flush=True)
    y_r, h_r = ref.ssm_scan_ref(*args)
    f32 = [t.float().contiguous() for t in (x1, dt, Bm, Cm)]
    y = torch.empty((B, S, di), device="cuda")
    hT = torch.empty((B, di, 16), device="cuda")

    def old(ins):
        def run():
            if ins is None:   # the previous wrapper: cast, then the kernel
                xs = [t.float().contiguous() for t in (x1, dt, Bm, Cm)]
            else:
                xs = ins
            checked(lib.k6_old(*[t.data_ptr() for t in xs], A.data_ptr(),
                               h0.data_ptr(), y.data_ptr(), hT.data_ptr(), B,
                               S, di, stream()), "k6_old")
            return y, hT
        return run

    def new(lanes, steps, ins):
        xx, dd, bb, cc = ins
        bf = int(xx.dtype == torch.bfloat16)

        def run():
            checked(lib.k6_new(lanes, steps, bf, xx.data_ptr(),
                               dd.data_ptr(),
                               bb.data_ptr(), cc.data_ptr(), bb.stride(0),
                               bb.stride(1), cc.stride(0), cc.stride(1),
                               A.data_ptr(), h0.data_ptr(), y.data_ptr(),
                               hT.data_ptr(), B, S, di, stream()), "k6_new")
            return y, hT
        return run

    fns = {"old, bf16 cast to f32": old(None), "old, f32": old(f32)}
    for lanes, steps in ((2, 32), (2, 16), (4, 16)):
        fns[f"new {lanes} lanes, runs of {steps}, bf16"] = new(
            lanes, steps, (x1, dt, Bm, Cm))
    for lanes in (2, 4):
        fns[f"new {lanes} lanes, runs of 16, f32"] = new(lanes, 16, f32)

    def mode(m):
        def run():
            checked(lib.k6_mode(m, x1.data_ptr(), dt.data_ptr(),
                                Bm.data_ptr(), Cm.data_ptr(), Bm.stride(0),
                                Bm.stride(1), Cm.stride(0), Cm.stride(1),
                                A.data_ptr(), h0.data_ptr(), y.data_ptr(),
                                hT.data_ptr(), B, S, di, stream()),
                    f"k6_mode {m}")
            return y, hT
        return run

    for m in (0, 1, 2, 3, 5, 10, 11, 12, 13, 15):
        fns[f"mode {m}, bf16"] = mode(m)
    fns["shipped, bf16"] = lambda: kops.ssm_scan(*args)
    fns["shipped, f32"] = lambda: kops.ssm_scan(*f32, A, h0)
    for name, fn in fns.items():
        yy, hh = fn()
        ok = torch.equal(yy, y_r) and torch.equal(hh, h_r)
        err = max(float((yy - y_r).abs().max()), float((hh - h_r).abs().max()))
        if name.startswith("mode") and name.split()[1] not in ("0,", "10,"):
            continue   # stripped variants: not the scan
        print(f"K6 {name}: bitwise {ok}, max abs err {err:.3e}", flush=True)
    cells = B * S * di * 16
    nbytes = (2 * B * S * di * x1.element_size() + 4 * B * S * di
              + 2 * B * S * 16 * Bm.element_size() + 4 * di * 16
              + 8 * B * di * 16)
    bms = bound_ms(nbytes, 6.0 * cells + B * S * di)
    times = in_turns(fns, reps)
    for name, ts in times.items():
        print(f"K6 {name}: {np.mean(ts):.4f} ms ({ts[0]:.4f}, {ts[1]:.4f}); "
              f"{np.mean(ts) / bms:.2f}x the bf16 byte bound {bms:.4f} ms",
              flush=True)
    return {name: float(np.mean(ts)) for name, ts in times.items()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--skip-k6", action="store_true")
    ap.add_argument("--skip-k3", action="store_true")
    ap.add_argument("--sass", help="write the K6 instance's SASS here")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    _build.library()
    with tempfile.TemporaryDirectory() as tmp:
        lib = build_probe(tmp, opts.sass)
    if not opts.skip_k3:
        k3_section(lib, opts.reps)
    if not opts.skip_k6:
        k6_section(lib, opts.reps)


if __name__ == "__main__":
    main()
