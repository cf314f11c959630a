#!/usr/bin/env python3
"""Two witnesses of the LM serving path, on the CPU.

``window``: the rolling-window cache layout.  Reduced hymba-1.5b with 4
layers (kinds 0, 1, 0, 0: window 8 in layer 1), float32, 2 rows, the
reference's weights (seed 0) in both packages.  After a prompt of S
tokens, three decode steps are held against each package's own prefill of
the extended prompt.  The reference writes a windowed layer's last C
positions at slots 0..C-1 and decodes position p at slot p % C, so it
parts from itself unless C divides S; the port writes p at p % C in both.

``bf16-gap``: the gap between a 64-token prompt's prefill logits and 64
decode steps in bf16 on the first 2 layers of a config, by width: the
port alone at each ``--widths`` d_model (3 seeds), and with ``--reference``
both packages at the config's own width on the reference's weights.

    PYTHONPATH=src python tools/lm_witness.py window --prompts 8,12
    PYTHONPATH=src python tools/lm_witness.py bf16-gap --arch hymba-1.5b \
        --widths 100,400,1600 --reference
"""
import argparse
import dataclasses
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))


def _reference(cfg, seed=0):
    import jax
    from repro.models import model as jm
    from repro_torch.models.weights import params_from_reference
    jp = jm.init_params(cfg, jax.random.key(seed))
    return jp, params_from_reference(jax.tree.map(np.asarray, jp), cfg,
                                     device="cpu")


def _gap(lp, ld):
    lp, ld = np.asarray(lp, np.float32), np.asarray(ld, np.float32)
    return float(np.abs(lp - ld).max())


def window(prompts):
    import jax
    import jax.numpy as jnp
    import torch
    from repro import configs as jc
    from repro.models import model as jm
    from repro_torch.models import model as tm

    cfg = dataclasses.replace(jc.reduced(jc.get_config("hymba-1.5b")),
                              n_layers=4, dtype="float32")
    jp, model = _reference(cfg)
    jdec = jax.jit(lambda p, c, t, pos: jm.decode_step(p, cfg, c, t, pos))
    for S in prompts:
        toks = np.random.default_rng(9).integers(
            0, cfg.vocab, (2, S + 3)).astype(np.int32)
        tt, jt = torch.as_tensor(toks), jnp.asarray(toks)
        _, ct = tm.prefill(model, cfg, tt[:, :S], 32)
        _, cj = jm.prefill(jp, cfg, jt[:, :S], 32)
        errs = {"port": [], "reference": []}
        for t in range(3):
            lt, ct = tm.decode_step(model, cfg, ct, tt[:, S + t:S + t + 1],
                                    S + t)
            lj, cj = jdec(jp, cj, jt[:, S + t:S + t + 1], jnp.int32(S + t))
            own_t = tm.prefill(model, cfg, tt[:, :S + t + 1], 32)[0]
            own_j = jm.prefill(jp, cfg, jt[:, :S + t + 1], 32)[0]
            errs["port"].append(_gap(lt, own_t))
            errs["reference"].append(_gap(lj, own_j))
        for who, e in errs.items():
            print(f"window 8, S = {S}: {who} decode steps 1-3 against its "
                  f"own prefill of the extended prompt, max abs err "
                  + ", ".join(f"{x:.3e}" for x in e), flush=True)


def bf16_gap(arch, widths, reference, S=64):
    import jax
    import jax.numpy as jnp
    import torch
    from repro import configs as jc
    from repro.models import model as jm
    from repro_torch.models import model as tm

    def port_gap(model, cfg, toks):
        tt = torch.as_tensor(toks)
        lp, _ = tm.prefill(model, cfg, tt, S)
        c = tm.init_cache(cfg, 1, S, device="cpu")
        for t in range(S):
            ld, c = tm.decode_step(model, cfg, c, tt[:, t:t + 1], t)
        return _gap(lp, ld), float(ld.abs().max())

    base = dataclasses.replace(jc.get_config(arch), n_layers=2)
    for d in widths:
        gaps = []
        for seed in range(3):
            cfg = dataclasses.replace(base, d_model=d)
            model = tm.cast_for_compute(tm.init_params(
                cfg, generator=torch.Generator().manual_seed(seed),
                device="cpu"), cfg)
            toks = np.random.default_rng(seed).integers(
                0, cfg.vocab, (1, S)).astype(np.int32)
            gaps.append(port_gap(model, cfg, toks))
        mean = np.mean([g for g, _ in gaps])
        print(f"{arch}, 2 layers, d_model {d}, bf16: port gap "
              + ", ".join(f"{g:.3e} (|logits| max {m:.2f})"
                          for g, m in gaps)
              + f"; mean / sqrt(d/64) {mean / np.sqrt(d / 64):.3e}",
              flush=True)
    if reference:
        cfg = base
        jp, model = _reference(cfg)
        toks = np.random.default_rng(0).integers(
            0, cfg.vocab, (1, S)).astype(np.int32)
        lp, _ = jm.prefill(jp, cfg, jnp.asarray(toks), S)
        dec = jax.jit(lambda p, c, t, pos: jm.decode_step(p, cfg, c, t, pos))
        c = jm.init_cache(cfg, 1, S)
        for t in range(S):
            ld, c = dec(jp, c, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        g, _ = port_gap(tm.cast_for_compute(model, cfg), cfg, toks)
        print(f"{arch}, 2 layers, d_model {cfg.d_model}, bf16, the "
              f"reference's weights: reference gap {_gap(lp, ld):.3e}, port "
              f"gap {g:.3e}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    w = sub.add_parser("window")
    w.add_argument("--prompts", default="8,12")
    b = sub.add_parser("bf16-gap")
    b.add_argument("--arch", default="hymba-1.5b")
    b.add_argument("--widths", default="100,400,1600")
    b.add_argument("--reference", action="store_true")
    args = ap.parse_args()
    if args.cmd == "window":
        window([int(s) for s in args.prompts.split(",")])
    else:
        bf16_gap(args.arch, [int(d) for d in args.widths.split(",")],
                 args.reference)


if __name__ == "__main__":
    main()
