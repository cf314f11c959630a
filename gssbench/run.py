"""Run one cell of the benchmark once and print its result line.

    python3 gssbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Needs the CUDA cards the cell asks for: without them it exits 2 and prints
no result.  With ``--trace 0`` the line holds the cell's end-to-end
metrics, with ``--trace 1`` its per-layer ones and the device's busy
share.  The numbers compared with the reference are printed last on
standard error and last in the line (``checks``).  The run fails, and
prints no result, when the JAX package or JAX itself was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
# every build and kernel cache of a run stays inside the checkout, at a
# fixed path (the kernel library builds into src/repro_torch/_build)
CACHE = ROOT / ".gssbench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from gssbench import harness
    from gssbench.manifest import Manifest

    manifest = Manifest.load(ROOT)
    chips = int(manifest.workload(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gssbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run_cell(manifest, args.workload, args.seed,
                              args.seconds, bool(args.trace), device="cuda",
                              t_start=T_START, chips=chips)
    bad = harness.forbidden_modules(list(sys.modules))
    if bad:
        print(f"gssbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
