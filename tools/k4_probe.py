#!/usr/bin/env python3
"""Where a K4 launch's device time goes, on the K4 path's real first launch.

Builds the level-0 problem of ``mesh2d(1024, 1024, seed=0)`` as
``chip_smoke.py``'s K4 path does (``pdgrass_config(alpha=0.05,
chunk=512)``), records the inputs of every K4 launch of the round engine's
K4 route (stop at the target ceil(0.05 n)), and prints, for the first:

  * the launch's work: recovered candidates, the rows of their subtasks,
    the (row, same-subtask candidate) pairs, and how many of the shipped
    kernel's 4096-row blocks list a candidate;
  * the device time of the shipped kernel's row stream stripped after each
    step (``k4_probe_stream`` variants 0-3 of ``tools/k4_probe.cu``): the
    floor a block that lists no candidate cannot go below;
  * the shipped kernel (``repro_torch.kernels.ops.similarity_mark``) and the
    kernel it replaced (``k4_probe_previous``, kept verbatim in the probe)
    in turns, previous, shipped, shipped, previous, over all rows, each
    checked bitwise against the plain version; then each on one 4096-row
    slice alone (the slice of the candidates' own rows, the slice of the
    padding rows, a middle slice);
  * the timeline of the block that holds the candidates' rows: a copy of
    the shipped source with a ``clock64()`` stamp (thread 0 of block 0) at
    each of the kernel's ``// ---- phase ----`` headers and after its store,
    built here and run on that slice; cycles between stamps;

and over all the launches: the (row, candidate) pairs a launch holds,
the device time of each launch for the previous kernel and the shipped
one in turns, summed, and the heaviest launches' structure and times.

Times are CUDA events over 50 calls queued behind a device sleep, so they
are the device's work alone.  Needs an H100 and ``nvcc``:

    python3 tools/k4_probe.py
"""
import ctypes
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))

from repro_torch.core import recovery as rec  # noqa: E402
from repro_torch.core.graph import mesh2d  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.similarity import ROW_CAPACITY  # noqa: E402
from repro_torch.kernels._build import (ARCH, CSRC, NVCC_FLAGS,  # noqa: E402
                                        _nvcc)
from repro_torch.pipeline import Pipeline, pdgrass_config  # noqa: E402

ROWS = 4096  # rows a block of the shipped kernel covers


def launch_inputs():
    """Every K4 launch's inputs: the round's candidates copied, the rows
    the problem's own tensors."""
    g = mesh2d(1024, 1024, seed=0)
    prob = Pipeline(pdgrass_config(alpha=0.05, chunk=512)).prepare(
        g, device="cuda").problem
    seen = []
    mark = kops.similarity_mark

    def record(*args, **kw):
        seen.append([a.clone() for a in args[:4]] + list(args[4:]))
        return mark(*args, **kw)

    kops.similarity_mark = record
    try:
        rec.recover_rounds(prob, int(np.ceil(0.05 * g.n)),
                           stop_at_target=True, chunk=512, use_kernel=True)
    finally:
        kops.similarity_mark = mark
    return seen


def stamped_source(src=None):
    """The K4 source (by default the shipped one) with a clock64() stamp at
    each phase header and after the output store; returns (source, phase
    titles)."""
    if src is None:
        src = (CSRC / "similarity_mark.cu").read_text()
    titles = []

    def stamp(match):
        titles.append(match.group(2))
        return f"{match.group(1)}K4_STAMP({len(titles) - 1});"

    src = re.sub(r"^( *)// ---- (.+?) -+$", stamp, src, flags=re.M)
    store = "*reinterpret_cast<uint4*>(out + base) = w;"
    if not titles or store not in src:
        sys.exit("the K4 source lost its phase headers or its store")
    src = src.replace(store, f"{store}\n    K4_STAMP({len(titles)});")
    titles.append("(end: after the output store)")
    hooks = ("namespace {\n__device__ long long k4_stamps[32];\n"
             "#define K4_STAMP(i) do { if (blockIdx.x == 0 && "
             "threadIdx.x == 0) k4_stamps[i] = clock64(); } while (0)\n")
    src = src.replace("namespace {\n", hooks, 1)
    src += ("extern \"C\" int k4_probe_stamps(long long* host) {\n"
            "  return (int)cudaMemcpyFromSymbol(host, k4_stamps, "
            "sizeof(k4_stamps));\n}\n")
    return src, titles


def device_us(fn, reps=50, sleep_cycles=int(2e7)):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)  # the host queues every call meanwhile
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps * 1e3


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    src, titles = stamped_source()
    flags = [f for f in NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    with tempfile.TemporaryDirectory() as tmp:
        so = os.path.join(tmp, "k4_probe.so")
        cu = os.path.join(tmp, "k4_stamped.cu")
        stamped_so = os.path.join(tmp, "k4_stamped.so")
        with open(cu, "w") as f:
            f.write(src)
        builds = [subprocess.Popen(cmd) for cmd in (
            [_nvcc(), *ARCH, "-O3", "-Xcompiler", "-fPIC", "-shared",
             os.path.join(HERE, "k4_probe.cu"), "-o", so],
            [_nvcc(), *flags, "-shared", cu, "-o", stamped_so])]
        if any(b.wait() for b in builds):
            sys.exit("nvcc failed")
        lib = ctypes.CDLL(so)
        stamped = ctypes.CDLL(stamped_so)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.k4_probe_previous.argtypes = [P] * 8 + [I, I, P]
    lib.k4_probe_stream.argtypes = [I, P, P, P, P, I, I, P]
    stamped.repro_similarity_mark.argtypes = [P] * 8 + [I, I, I, P, I, I, P]
    stamped.k4_probe_stamps.argtypes = [P]
    runs = launch_inputs()
    args = runs[0]
    csu, csv, cbeta, cseg, esu, esv, eseg = args
    K, c1 = csu.shape
    m = esu.shape[0]
    if c1 != 9 or m % 512:
        sys.exit(f"the probe is built for c1 = 9 and m % 512 == 0, the "
                 f"launch has c1 = {c1}, m = {m}")
    e, cs, cb = (t.cpu().numpy() for t in (eseg, cseg, cbeta))
    live = cs[cb >= 0]
    rows = np.isin(e, live)
    pairs = int(sum((e == s).sum() for s in live))
    nb = (m + ROWS - 1) // ROWS

    def in_ranges(blk):  # the kernel's two ranges: ids >= 0 and < 0
        hit = np.zeros(live.shape, bool)
        for part in (blk[blk >= 0], blk[blk < 0]):
            if part.size:
                hit |= (live >= part.min()) & (live <= part.max())
        return int(hit.sum())

    listed = np.array([in_ranges(e[i * ROWS:(i + 1) * ROWS])
                       for i in range(nb)])
    print(f"K={K} m={m} c1={c1}; {live.size} recovered candidates in "
          f"{np.unique(live).size} subtasks {live.min()}..{live.max()}; "
          f"{int(rows.sum())} rows in those subtasks (rows "
          f"{np.flatnonzero(rows).min()}..{np.flatnonzero(rows).max()}), "
          f"{pairs} (row, candidate) pairs; {int((e < 0).sum())} padding "
          f"rows; {int((listed > 0).sum())} of {nb} {ROWS}-row blocks list "
          f"candidates (at most {listed.max()})", flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty(m, dtype=torch.bool, device="cuda")

    def previous(row0=0, n=m):
        return lambda: lib.k4_probe_previous(
            csu.data_ptr(), csv.data_ptr(), cbeta.data_ptr(),
            cseg.data_ptr(), esu[row0:].data_ptr(), esv[row0:].data_ptr(),
            eseg[row0:].data_ptr(), out[row0:].data_ptr(), K, n, stream)

    def shipped(row0=0, n=m):
        sl = [esu[row0:row0 + n], esv[row0:row0 + n], eseg[row0:row0 + n]]
        return lambda: kops.similarity_mark(csu, csv, cbeta, cseg, *sl)

    want = ref.similarity_mark_ref(*args)
    previous()()
    torch.cuda.synchronize()
    if not (torch.equal(out, want) and torch.equal(shipped()(), want)):
        sys.exit("the previous kernel or the shipped kernel is not bitwise "
                 "equal to the plain version")
    for v in range(4):
        us = device_us(lambda: lib.k4_probe_stream(
            v, cbeta.data_ptr(), cseg.data_ptr(), eseg.data_ptr(),
            out.data_ptr(), K, m, stream))
        print(f"stream variant {v}: {us:.2f} us over all rows", flush=True)
    turns = [("previous", previous), ("shipped", shipped),
             ("shipped", shipped), ("previous", previous)]
    for name, make in turns:
        print(f"{name} kernel: {device_us(make()):.2f} us over all rows",
              flush=True)
    hot = int(np.flatnonzero(rows).min()) // ROWS
    pad = int(np.flatnonzero(e < 0)[0]) // ROWS
    for name, make in turns[:2]:
        alone = [device_us(make(b * ROWS, min(ROWS, m - b * ROWS)))
                 for b in (hot, pad, nb // 2)]
        print(f"{name} kernel on one {ROWS}-row slice alone: candidates' "
              f"slice {hot} {alone[0]:.2f} us, padding slice {pad} "
              f"{alone[1]:.2f} us, slice {nb // 2} {alone[2]:.2f} us",
              flush=True)
    n_hot = min(ROWS, m - hot * ROWS)
    scratch = torch.zeros(2 + ROW_CAPACITY, dtype=torch.int32,
                          device="cuda")
    for epoch in range(3):   # the last of three runs, warm
        stamped.repro_similarity_mark(
            csu.data_ptr(), csv.data_ptr(), cbeta.data_ptr(),
            cseg.data_ptr(), esu[hot * ROWS:].data_ptr(),
            esv[hot * ROWS:].data_ptr(), eseg[hot * ROWS:].data_ptr(),
            out[hot * ROWS:].data_ptr(), K, n_hot, c1, scratch.data_ptr(),
            ROW_CAPACITY, epoch, stream)
        torch.cuda.synchronize()
    stamps = (ctypes.c_longlong * 32)()
    if stamped.k4_probe_stamps(stamps):
        sys.exit("could not read the stamps")
    print(f"timeline of the candidates' block (slice {hot} alone, thread 0, "
          f"cycles since the first stamp; phases it skipped left out):",
          flush=True)
    seen = [i for i in range(len(titles)) if stamps[i]]
    for i, nxt in zip(seen, seen[1:] + [None]):
        step = f"  (+{stamps[nxt] - stamps[i]})" if nxt is not None else ""
        print(f"  {stamps[i] - stamps[seen[0]]:7d}  {titles[i]}{step}",
              flush=True)
    # every launch of the run: its pairs, and all of them back to back
    ids, rows_of = np.unique(e, return_counts=True)
    rows_of = dict(zip(ids.tolist(), rows_of.tolist()))
    pairs_of = [sum(rows_of.get(sg, 0) for sg in
                    r[3][r[2] >= 0].cpu().tolist()) for r in runs]
    heavy = int(np.argmax(pairs_of))
    if not torch.equal(kops.similarity_mark(*runs[heavy]),
                       ref.similarity_mark_ref(*runs[heavy])):
        sys.exit(f"the shipped kernel is not bitwise equal to the plain "
                 f"version on launch {heavy}")

    def previous_run(r):
        return lambda: lib.k4_probe_previous(
            *[a.data_ptr() for a in r], out.data_ptr(), r[0].shape[0], m,
            stream)

    print(f"{len(runs)} launches: (row, candidate) pairs a launch min "
          f"{min(pairs_of)}, median {int(np.median(pairs_of))}, max "
          f"{max(pairs_of)} (launch {heavy}), {sum(pairs_of)} in all",
          flush=True)
    # each launch timed on its own, the two kernels in turns: thousands of
    # launches queued at once would fill the launch queue and time the host
    per = np.array([[device_us(previous_run(r), 5),
                     device_us(lambda: kops.similarity_mark(*r), 5)]
                    for r in runs])
    for col, name in enumerate(("previous", "shipped")):
        print(f"{name} kernel over all {len(runs)} launches: "
              f"{per[:, col].sum() / 1e3:.3f} ms of device time (median "
              f"{np.median(per[:, col]):.2f} us, max {per[:, col].max():.2f} "
              f"us a launch)", flush=True)
    for name, one in (("previous", previous_run(runs[heavy])),
                      ("shipped", lambda: kops.similarity_mark(
                          *runs[heavy]))):
        print(f"{name} kernel on launch {heavy} ({pairs_of[heavy]} pairs): "
              f"{device_us(one):.2f} us", flush=True)
    # the heaviest launches: where their pairs lie, and each kernel's time
    block_of = np.arange(m) // ROWS
    for i in np.argsort(pairs_of)[::-1][:6]:
        r = runs[int(i)]
        cs, cb = r[3].cpu().numpy(), r[2].cpu().numpy()
        live_i = cs[cb >= 0]
        ids_i, per_seg = np.unique(live_i, return_counts=True)
        cand_of = dict(zip(ids_i.tolist(), per_seg.tolist()))
        hot = np.isin(e, ids_i)
        row_pairs = np.zeros(m, np.int64)
        row_pairs[hot] = [cand_of[x] for x in e[hot].tolist()]
        blk = np.bincount(block_of, weights=row_pairs, minlength=nb)
        print(f"launch {int(i)}: {pairs_of[int(i)]} pairs, {int(hot.sum())} "
              f"rows in {ids_i.size} subtasks (candidates a subtask max "
              f"{per_seg.max()}), {int((blk > 0).sum())} blocks with pairs, "
              f"most in a block {int(blk.max())}; previous "
              f"{device_us(previous_run(r), 5):.2f} us, shipped "
              f"{device_us(lambda: kops.similarity_mark(*r), 5):.2f} us",
              flush=True)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            kops.similarity_mark(*runs[heavy])
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            print(f"  profiler, launch {heavy}: {ev.key[:60]} "
                  f"{ev.device_time_total / max(ev.count, 1):.2f} us "
                  f"x{ev.count}", flush=True)
    t0 = time.perf_counter()
    for _ in range(200):
        kops.similarity_mark(*args)
    torch.cuda.synchronize()
    print(f"shipped kernel through its wrapper, host loop: "
          f"{(time.perf_counter() - t0) / 200 * 1e6:.2f} us a call")


if __name__ == "__main__":
    main()
