"""Re-run one dry-run cell with a config variant and print the baseline
beside the variant.

The port of ``repro.launch.perf_iter``, over the port's
:func:`repro_torch.launch.dryrun.run_cell` (counted on ``meta``; the two
rows share nothing but the mesh).  Columns: ``tc``, ``tm``, ``tl`` (the
three roofline terms, seconds), the bottleneck, ``useful`` (model flops
over counted flops) and ``mem GB`` (``arg_gb`` plus ``temp_gb``, which
the count leaves at ``None``: read as 0).

  PYTHONPATH=src python -m repro_torch.launch.perf_iter \\
      --arch arctic-480b --shape prefill_32k --set moe_impl=gather
"""
from __future__ import annotations

import argparse
import json

from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.mesh import make_production_mesh


def parse_overrides(pairs):
    """``["key=value", ...]`` -> ``{key: value}``, each value an int, a
    float or a bool where it reads as one (the reference's rules)."""
    out = {}
    for kv in pairs or []:
        k, v = kv.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        if v in ("True", "true"):
            v = True
        if v in ("False", "false"):
            v = False
        out[k] = v
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--set", nargs="*", default=[])
    ap.add_argument("--skip-baseline", action="store_true")
    ap.add_argument("--multi", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    mesh = make_production_mesh(multi_pod=args.multi, device="meta")
    mesh_name = "2x16x16" if args.multi else "16x16"
    rows = []
    if not args.skip_baseline:
        rows.append(("baseline", run_cell(args.arch, args.shape, mesh,
                                          mesh_name)))
    ov = parse_overrides(args.set)
    rows.append((str(ov), run_cell(args.arch, args.shape, mesh, mesh_name,
                                   cfg_overrides=ov)))
    print(f"\n{'variant':40s} {'tc':>10s} {'tm':>10s} {'tl':>10s} "
          f"{'bottleneck':>11s} {'useful':>7s} {'mem GB':>7s}")
    for name, r in rows:
        print(f"{name:40s} {r['t_compute']:10.3e} {r['t_memory']:10.3e} "
              f"{r['t_collective']:10.3e} {r['bottleneck']:>11s} "
              f"{r['useful_ratio']:7.3f} "
              f"{r['arg_gb'] + (r['temp_gb'] or 0.0):7.1f}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump([dict(variant=n, **r) for n, r in rows], f, indent=1)


if __name__ == "__main__":
    main()
