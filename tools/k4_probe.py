#!/usr/bin/env python3
"""Where a K4 launch's device time goes, on the K4 path's real first launch.

Builds the level-0 problem of ``mesh2d(1024, 1024, seed=0)`` as
``chip_smoke.py``'s K4 path does (``pdgrass_config(alpha=0.05,
chunk=512)``), records the inputs of the round engine's first K4 launch,
and prints:

  * how many of the 256-row thread blocks list a candidate (the block's
    range of subtask ids holds a recovered candidate's subtask);
  * the device time of each variant of ``tools/k4_probe.cu`` over all
    rows, and of variants 3-6 on one block alone (block 0, which holds the
    candidates' own rows; the block of the padding rows; a middle block);
  * the shipped kernel's time through its wrapper
    (``repro_torch.kernels.ops.similarity_mark``).

Times are CUDA events over 50 calls queued behind a device sleep, so they
are the device's work alone.  Needs an H100 and ``nvcc``:

    python3 tools/k4_probe.py
"""
import ctypes
import os
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
from repro_torch.kernels._build import ARCH, _nvcc  # noqa: E402
from repro_torch.pipeline import Pipeline, pdgrass_config  # noqa: E402

ROWS = 256  # rows a thread block of the probe covers


class _FirstLaunch(Exception):
    pass


def first_launch_inputs():
    g = mesh2d(1024, 1024, seed=0)
    prob = Pipeline(pdgrass_config(alpha=0.05, chunk=512)).prepare(
        g, device="cuda").problem
    seen = []
    mark = kops.similarity_mark

    def record(*args, **kw):
        seen.append([a.clone() for a in args])
        raise _FirstLaunch

    kops.similarity_mark = record
    try:
        rec.recover_rounds(prob, int(np.ceil(0.05 * g.n)),
                           stop_at_target=True, chunk=512, use_kernel=True)
    except _FirstLaunch:
        pass
    finally:
        kops.similarity_mark = mark
    return seen[0]


def device_us(fn, reps=50):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e7))  # the host queues every call meanwhile
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps * 1e3


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    with tempfile.TemporaryDirectory() as tmp:
        so = os.path.join(tmp, "k4_probe.so")
        subprocess.run([_nvcc(), *ARCH, "-O3", "-Xcompiler", "-fPIC",
                        "-shared", os.path.join(HERE, "k4_probe.cu"), "-o",
                        so], check=True)
        lib = ctypes.CDLL(so)
    lib.k4_probe.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                             + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    args = first_launch_inputs()
    csu, csv, cbeta, cseg, esu, esv, eseg = args
    K, c1 = csu.shape
    m = esu.shape[0]
    if c1 != 9:
        sys.exit(f"the probe is built for c1 = 9, the launch has {c1}")
    e, cs, cb = (t.cpu().numpy() for t in (eseg, cseg, cbeta))
    live = cs[cb >= 0]
    nb = (m + ROWS - 1) // ROWS
    listed = np.array([((live >= e[i * ROWS:(i + 1) * ROWS].min())
                        & (live <= e[i * ROWS:(i + 1) * ROWS].max())).sum()
                       for i in range(nb)])
    print(f"K={K} m={m} c1={c1}; {live.size} recovered candidates in "
          f"subtasks {live.min()}..{live.max()}; {int((e < 0).sum())} "
          f"padding rows; {int((listed > 0).sum())} of {nb} blocks list "
          f"candidates (at most {listed.max()})", flush=True)
    out = torch.empty(m, dtype=torch.uint8, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run(v, row0=0, rows=m):
        return lambda: lib.k4_probe(
            v, csu.data_ptr(), csv.data_ptr(), cbeta.data_ptr(),
            cseg.data_ptr(), esu.data_ptr() + row0 * c1 * 4,
            esv.data_ptr() + row0 * c1 * 4, eseg.data_ptr() + row0 * 4,
            out.data_ptr() + row0, K, rows, stream)

    pad_block = int(np.flatnonzero(e < 0)[0]) // ROWS
    for v in range(7):
        print(f"variant {v}: {device_us(run(v)):.2f} us over all rows",
              flush=True)
    for v in (3, 4, 5, 6):
        alone = [device_us(run(v, b * ROWS, ROWS))
                 for b in (0, pad_block, nb // 2)]
        print(f"variant {v} on one block: block 0 {alone[0]:.2f} us, "
              f"padding block {pad_block} {alone[1]:.2f} us, block "
              f"{nb // 2} {alone[2]:.2f} us", flush=True)
    print(f"shipped kernel through its wrapper: "
          f"{device_us(lambda: kops.similarity_mark(*args)):.2f} us",
          flush=True)
    t0 = time.perf_counter()
    for _ in range(200):
        kops.similarity_mark(*args)
    torch.cuda.synchronize()
    print(f"wrapper, host loop: {(time.perf_counter() - t0) / 200 * 1e6:.2f}"
          f" us a call")


if __name__ == "__main__":
    main()
