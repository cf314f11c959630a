#!/usr/bin/env python3
"""K6b (the selective scan's gradient): the shipped kernel beside its
variants and the previous design, at hymba-1.5b's training shape.

Inputs: B = 4, S = 4096, di = 3200, state 16 (hymba-1.5b's layer as
``SsmScan`` hands it to K6b in training): bf16 x and dt, B and C strided
views of one bf16 x_proj-like output of width 100 + 2 x 16, float32 A, h0,
dy and dhT, from ``torch.Generator("cuda").manual_seed(0)``.

Builds ``tools/k6b_probe.cu`` once a variant (one nvcc each, in
parallel): its copy of the library's design at other lanes (states a
lane) and run lengths, stripped copies of it (no expf, no staging, no
channel sums, the stack in place of the checkpoints) and the previous
design (one thread a channel, every state in a 3.36 GB stack); the
library's kernel itself runs through its entry.  Each variant that computes the
gradient is checked bitwise against the plain version before it is
timed.  Times are CUDA events over ``--reps`` calls queued behind a device
sleep (the device's work alone), taken in turns: every variant in order,
then in reverse order.  Prints each variant's registers and spills
(ptxas), its scratch bytes, its time beside the function's bound
(``launch/roofline.py`` ``ssm_scan_bwd_launch``), its own design's bound
(``ssm_scan_bwd_design``) and the exponentials' issue term.  Needs an
H100 and ``nvcc``:

    python3 tools/k6b_probe.py [--reps 5] [--only NAME ...] [--no-prev]
"""
import argparse
import ctypes
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))

from repro_torch.analysis import cuda_check  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ssm_scan as kssm  # noqa: E402
from repro_torch.launch import roofline as rf  # noqa: E402

B, S, DI, NS, RANK = 4, 4096, 3200, 16, 100
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
ARGTYPES = [_P] * 4 + [_L] * 4 + [_P] * 13 + [_I] * 3 + [_P]
NO_EXP, NO_STAGE, NO_CHAN_SUM, STACK, NO_STATE_SUM, NO_REVERSE = \
    1, 2, 4, 8, 16, 32
EXP_IN_WALK = 64
COMPUTES = (0, STACK, EXP_IN_WALK)
# the states a lane of the library's design, which the copy's stripped
# variants start from (``kSpl`` in ``csrc/ssm_scan_bwd.cu``)
BASE_SPL = 2


def variants(run):
    """``{name: (spl, run, mode, defines)}``: the probe's copy of the
    library's design (``run``: the library's run length), other lanes and
    run lengths, two other launch settings (``defines``: ``K6B_MINB``, the
    blocks an SM the reverse kernel's launch bounds ask for; ``K6B_SPLF``,
    the checkpoint kernel's states a lane), and the stripped copies."""
    out = {"copy of the library's design": (BASE_SPL, run, 0, ())}
    for s, r in ((1, 32), (2, 8), (2, 12), (2, 16), (2, 32), (4, 8)):
        if (s, r) != (BASE_SPL, run):
            out[f"{s} states a lane, runs of {r}"] = (s, r, 0, ())
    out["copy, checkpoints at 1 state a lane"] = (
        BASE_SPL, run, 0, ("-DK6B_SPLF=1",))
    out["copy, one block an SM"] = (BASE_SPL, run, 0, ("-DK6B_MINB=1",))
    for mode, what in ((NO_EXP, "no expf"), (NO_STAGE, "no staging"),
                       (NO_CHAN_SUM, "no channel sums"),
                       (STACK, "the stack in place of the checkpoints"),
                       (NO_STATE_SUM, "no sums over the states"),
                       (NO_CHAN_SUM | NO_STATE_SUM, "no sums"),
                       (NO_REVERSE, "the checkpoint kernel alone"),
                       (EXP_IN_WALK, "da recomputed in the walk")):
        out[f"copy, {what}"] = (BASE_SPL, run, mode, ())
    return out


SASS_OPS = ("LDS", "STS", "SHFL", "BAR", "MUFU", "LDG", "STG", "LDL", "STL",
            "FADD", "FMUL")


def sass_counts(so, parts):
    """Opcode counts of the entry functions of a built library whose
    mangled names hold every string of ``parts``, from ``cuobjdump
    -sass``."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", so], capture_output=True,
                         text=True).stdout
    counts, inside = {}, False
    for line in out.splitlines():
        if "Function :" in line:
            inside = all(p in line for p in parts)
        elif inside and line.strip().startswith("/*") and "*/" in line:
            body = line.split("*/", 1)[1].strip()
            if not body or body.startswith("/*"):
                continue
            op = body.split()[1] if body.startswith("@") else body.split()[0]
            op = op.rstrip(" ;").split(".")[0]
            counts[op] = counts.get(op, 0) + 1
    return sum(counts.values()), {k: counts.get(k, 0) for k in SASS_OPS}


def build(tmp, specs, prev):
    """One nvcc a variant, all started together; returns ``{name: (lib,
    seconds, ptxas lines)}``."""
    def one(name, defines):
        so = os.path.join(tmp, re.sub(r"\W+", "_", name) + ".so")
        t0 = time.perf_counter()
        out = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, *defines, "-shared",
             os.path.join(HERE, "k6b_probe.cu"), "-o", so],
            capture_output=True, text=True)
        secs = time.perf_counter() - t0
        if out.returncode != 0:
            sys.exit(f"nvcc failed for {name}:\n{out.stdout}\n{out.stderr}")
        kernels = cuda_check.parse_ptxas_log(
            "== k6b_probe.cu\n" + out.stdout + out.stderr)
        res = [k for k in kernels if k.name in ("ssm_scan_bwd_kernel",
                                                 "ssm_scan_ckpt_kernel")]
        sass = sass_counts(so, ("ssm_scan_bwd_kernel",))
        return name, (ctypes.CDLL(so), secs, res, sass)

    jobs = [(name, [f"-DK6B_SPL={s}", f"-DK6B_RUN={r}", f"-DK6B_MODE={m}",
                    *defs]) for name, (s, r, m, defs) in specs.items()]
    if prev:
        jobs.append(("previous design", ["-DK6B_PREV"]))
    with ThreadPoolExecutor(max_workers=len(jobs)) as ex:
        built = dict(ex.map(lambda j: one(*j), jobs))
    for name, (lib, secs, res, (total, ops)) in built.items():
        fn = lib.k6b_prev if name == "previous design" else lib.k6b_variant
        fn.argtypes, fn.restype = ARGTYPES, ctypes.c_int
        print(f"build {name}: {secs:.1f} s; ptxas: " + "; ".join(
            f"{k.name}<{k.template_args}> {k.registers} registers, "
            f"{k.spill_stores}/{k.spill_loads} bytes spilled"
            for k in res) + f"; SASS (reverse kernel) {total} instructions, "
              + ", ".join(f"{k} {v}" for k, v in ops.items()), flush=True)
    return built


def inputs():
    gen = torch.Generator(device="cuda").manual_seed(0)
    x1 = torch.randn((B, S, DI), generator=gen, device="cuda").bfloat16()
    dt = (0.1 * torch.rand((B, S, DI), generator=gen, device="cuda")
          ).bfloat16()
    xdbc = torch.randn((B, S, RANK + 2 * NS), generator=gen,
                       device="cuda").bfloat16()
    Bm, Cm = xdbc[..., RANK:RANK + NS], xdbc[..., RANK + NS:]
    A = -torch.rand((DI, NS), generator=gen, device="cuda") - 0.1
    h0 = torch.randn((B, DI, NS), generator=gen, device="cuda")
    dy = torch.randn((B, S, DI), generator=gen, device="cuda")
    dhT = torch.randn((B, DI, NS), generator=gen, device="cuda")
    return [x1, dt, Bm, Cm, A, h0, dy, dhT]


def caller(fn, args, scratch_shape):
    """A closure that runs ``fn`` on ``args`` into its own outputs and a
    scratch of ``scratch_shape`` (checkpoints, a stack, or the previous
    design's stack); returns the outputs."""
    x1, dt, Bm, Cm, A, h0, dy, dhT = args
    f32 = lambda *s: torch.empty(s, dtype=torch.float32,  # noqa: E731
                                 device="cuda")
    nw = -(-DI // 32)
    scratch = f32(*scratch_shape)
    part_bc, part_a = f32(B, S, nw, 2 * NS), f32(B, DI, NS)
    outs = (f32(B, S, DI), f32(B, S, DI), f32(B, S, NS), f32(B, S, NS),
            f32(DI, NS), f32(B, DI, NS))
    dx, ddt, dB, dC, dA, dh0 = outs
    ptrs = ([t.data_ptr() for t in (x1, dt, Bm, Cm)]
            + [Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1)]
            + [t.data_ptr() for t in (A, h0, dy, dhT, scratch, dx, ddt,
                                      part_bc, part_a, dh0, dB, dC, dA)]
            + [B, S, DI])

    def run():
        st = fn(*ptrs, torch.cuda.current_stream().cuda_stream)
        if st != 0:
            raise RuntimeError(f"launch failed: cudaError {st}")
        return outs
    run.scratch = (scratch, part_bc, part_a)   # alive as long as ``run``
    return run, sum(t.numel() * 4 for t in run.scratch)


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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--only", nargs="*", help="variant names to keep")
    ap.add_argument("--no-prev", action="store_true")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    clock = float(re.search(r"(\d+) MHz\s*$", smi).group(1))
    t0 = time.perf_counter()
    _build.library()
    print(f"library: {time.perf_counter() - t0:.1f} s "
          f"({_build.build_info.get('seconds', 0.0):.1f} s nvcc)", flush=True)
    for line in _build.build_info["log"].splitlines():
        if "ssm_scan_bwd" in line or "== ssm_scan_bwd" in line:
            print(f"  ptxas: {line.strip()}")
    specs = variants(kssm.run_length())
    if opts.only:
        specs = {k: v for k, v in specs.items() if k in opts.only}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        built = build(tmp, specs, not opts.no_prev)
        print(f"probe builds: {time.perf_counter() - t0:.1f} s", flush=True)

    args = inputs()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = ref.ssm_scan_bwd_ref(*args)
    torch.cuda.synchronize()
    print(f"plain version: {(time.perf_counter() - t0) * 1e3:.1f} ms",
          flush=True)
    fn_bound = rf.bound_ms(*rf.ssm_scan_bwd_launch(B, S, DI, NS, 2, 2))
    expf = 2 * rf.ssm_scan_expf_ms(B, S, DI, NS, clock)
    print(f"shape B={B} S={S} di={DI} state={NS} bf16, B strides "
          f"{tuple(args[2].stride())}; function bound {fn_bound[0]:.4f} ms "
          f"({fn_bound[1]}); expf issue {expf:.4f} ms at {clock:.0f} MHz",
          flush=True)

    fns, info = {}, {}
    for name, (lib, _, _, _) in built.items():
        if name == "previous design":
            run, scratch = caller(lib.k6b_prev, args, (B, S, DI, NS))
            design = rf.bound_ms(rf.ssm_scan_bwd_launch(
                B, S, DI, NS, 2, 2)[0] + 2 * 4 * B * (S - 1) * DI * NS
                + 2 * rf.ssm_scan_bwd_partial_bytes(B, S, DI, NS),
                23 * B * S * DI * NS + 5 * B * S * DI)
            computes = True
        else:
            spl, r, mode, _ = specs[name]
            shape = ((B, S, NS, DI) if mode & STACK
                     else (B, max(1, -(-S // r) - 1), NS, DI))
            run, scratch = caller(lib.k6b_variant, args, shape)
            design = rf.bound_ms(*rf.ssm_scan_bwd_design(B, S, DI, NS, 2, 2,
                                                         r))
            computes = mode in COMPUTES
        fns[name], info[name] = run, (scratch, design, computes)
    fns["the library's kernel"] = lambda: kops.ssm_scan_bwd(*args)
    info["the library's kernel"] = (
        rf.ssm_scan_bwd_checkpoint_bytes(B, S, DI, NS, kssm.run_length())
        + rf.ssm_scan_bwd_partial_bytes(B, S, DI, NS),
        rf.bound_ms(*rf.ssm_scan_bwd_design(B, S, DI, NS, 2, 2,
                                            kssm.run_length())),
        True)
    names = list(fns)
    for name in names:
        try:
            got = [t.clone() for t in fns[name]()]
        except RuntimeError as exc:   # more shared memory than a block has
            print(f"{name}: {exc}; not timed", flush=True)
            fns.pop(name)
            continue
        torch.cuda.synchronize()
        if info[name][2]:
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            again = all(torch.equal(g, a) for g, a in zip(got, fns[name]()))
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            print(f"{name}: bitwise {same}, second launch equal {again}, "
                  f"max abs err {err:.3e}", flush=True)
            if not (same and again):
                fns.pop(name)
                print(f"  {name} not timed", flush=True)
    times = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        times[name].append(device_ms(fns[name], opts.reps))
    print(f"times (ms, {opts.reps} calls a turn, two turns):", flush=True)
    for name, ts in times.items():
        scratch, (dms, dby), _ = info[name]
        ms = float(np.mean(ts))
        print(f"  {name}: {ms:.4f} ({ts[0]:.4f}, {ts[1]:.4f}); "
              f"{ms / fn_bound[0]:.1f}x the function's bound, "
              f"{ms / dms:.1f}x its design's {dms:.4f} ms ({dby}); scratch "
              f"{scratch} bytes", flush=True)


if __name__ == "__main__":
    main()
