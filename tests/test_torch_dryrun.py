"""The port's LM launch tools held against the JAX package on the CPU.

  * The 40 cells, the skip set of ``applicability`` and ``input_specs``
    (leaf by leaf, the decode caches and their window-capped lengths too)
    equal the reference's.
  * ``model_flops_estimate`` equals the reference's float for every
    runnable cell at full size: the port's model on ``meta``, the
    reference's through ``jax.eval_shape``.
  * The cost counter: a product counts ``2 m n k`` (on the tensor cores
    in bf16), a 17-fold Python loop 17 times, K6 and K6b once each with
    their launch models; the layer fold equals the unfolded count for
    every reduced config and step kind (and both MoE dispatch forms), and
    a count on ``meta`` equals one on CPU tensors.
  * ``collectives_from_placements`` on a toy placement, worked by hand.
  * One subprocess lowers the reference's reduced hymba-1.5b (train_4k,
    prefill_32k, decode_32k) and mixtral-8x22b (decode_32k) on a (2, 4)
    mesh: the port's argument bytes equal ``argument_size_in_bytes`` to
    the byte; the reference's ``coll_by_kind`` is printed beside the
    port's closed form, with no bound; ``parse_overrides`` gives the
    reference's output.
  * ``run_cell`` rows on ``meta`` and a reduced cell run on the CPU.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro.launch import shapes as jshapes  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import ARCHS, get_config, reduced  # noqa: E402
from repro_torch.kernels.ssm_scan import SsmScan  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_bwd  # noqa: E402
from repro_torch.launch import dryrun as dry  # noqa: E402
from repro_torch.launch import hlo_costs as hc  # noqa: E402
from repro_torch.launch import perf_iter  # noqa: E402
from repro_torch.launch import roofline as roof  # noqa: E402
from repro_torch.launch import shapes  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

SMALL = {"train": shapes.ShapeSpec("t", "train", 16, 2),
         "prefill": shapes.ShapeSpec("p", "prefill", 16, 2),
         "decode": shapes.ShapeSpec("d", "decode", 16, 2)}


def _dtype(d) -> str:
    return str(d).replace("torch.", "")


def _overrides(arch):
    """The fields :func:`reduced` changes, as ``cfg_overrides``."""
    cfg, r = get_config(arch), reduced(get_config(arch))
    return {f.name: getattr(r, f.name) for f in dataclasses.fields(cfg)
            if getattr(r, f.name) != getattr(cfg, f.name)}


def _deep(arch, **kw):
    """A reduced config with four decoder layers (both kinds where the
    pattern has two: hymba's (0, 1, 0, 0)) and three encoder layers."""
    cfg = dataclasses.replace(reduced(get_config(arch)), n_layers=4, **kw)
    if cfg.enc_layers:
        cfg = dataclasses.replace(cfg, enc_layers=3)
    return cfg


# ---------------------------------------------------------------------------
# cells, skips, input stand-ins, model flops
# ---------------------------------------------------------------------------

def test_cells_and_skip_set_equal_reference():
    assert ARCHS == J_ARCHS
    assert {k: dataclasses.astuple(v) for k, v in shapes.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jshapes.SHAPES.items()}
    assert shapes.ENCDEC_DECODE_SRC == jshapes.ENCDEC_DECODE_SRC
    cells = [(a, s) for a in ARCHS for s in shapes.SHAPES]
    assert len(cells) == 40
    port = {c: shapes.applicability(get_config(c[0]), shapes.SHAPES[c[1]])
            for c in cells}
    ref = {c: jshapes.applicability(jget(c[0]), jshapes.SHAPES[c[1]])
           for c in cells}
    assert port == ref
    runs = {a for (a, s), why in port.items()
            if s == "long_500k" and why is None}
    assert runs == {"falcon-mamba-7b", "hymba-1.5b", "mixtral-8x22b"}
    assert sum(why is None for why in port.values()) == 33


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch):
    for name, shape in shapes.SHAPES.items():
        if shapes.applicability(get_config(arch), shape):
            continue
        got = shapes.input_specs(get_config(arch), shape)
        want = jshapes.input_specs(jget(arch), jshapes.SHAPES[name])
        assert sorted(got) == sorted(want)
        for k in ("tokens", "labels", "frontend", "src", "token", "pos"):
            if k in want:
                assert got[k].device.type == "meta"
                assert tuple(got[k].shape) == tuple(want[k].shape), (name, k)
                assert _dtype(got[k].dtype) == str(want[k].dtype), (name, k)
        if "caches" in want:
            assert len(got["caches"]) == len(want["caches"])
            for i, (c, w) in enumerate(zip(got["caches"], want["caches"])):
                assert sorted(c) == sorted(w), (name, i)
                for k in w:
                    assert tuple(c[k].shape) == tuple(w[k].shape), (name, i)
                    assert _dtype(c[k].dtype) == str(w[k].dtype), (name, i)


def test_decode_cache_lengths_respect_windows():
    cfg = get_config("mixtral-8x22b")            # SWA: rolling caches
    specs = shapes.input_specs(cfg, shapes.SHAPES["long_500k"])
    assert all(c["k"].shape[1] <= cfg.window for c in specs["caches"])
    cfg2 = get_config("hymba-1.5b")              # 3 global layers keep all
    specs2 = shapes.input_specs(cfg2, shapes.SHAPES["long_500k"])
    lens = [c["k"].shape[1] for c in specs2["caches"]]
    assert sorted(set(lens)) == [cfg2.window, 524288]
    assert lens.count(524288) == 3


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_estimate_equals_reference(arch):
    model = tmodel.init_params(get_config(arch), device="meta")
    jp = jax.eval_shape(lambda: jmodel.init_params(jget(arch),
                                                   jax.random.key(0)))
    for name, shape in shapes.SHAPES.items():
        if shapes.applicability(get_config(arch), shape):
            continue
        got = roof.model_flops_estimate(model, get_config(arch), shape)
        want = jroof.model_flops_estimate(jp, jget(arch),
                                          jshapes.SHAPES[name])
        assert isinstance(got, float) and got == want, (name, got, want)


# ---------------------------------------------------------------------------
# the cost counter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_counter_counts_a_product_exactly(dtype):
    m, k, n = 128, 256, 512
    a = torch.empty((m, k), dtype=dtype, device="meta")
    b = torch.empty((k, n), dtype=dtype, device="meta")
    c = hc.count(lambda x, y: x @ y, a, b)
    assert c.flops == 2 * m * n * k
    assert c.flops_tc == (c.flops if dtype == torch.bfloat16 else 0)
    assert c.bytes == (m * k + k * n + m * n) * a.element_size()
    assert c.calls == {"aten.mm.default": 1}
    assert c.coll == {} and c.dynamic_whiles == 0


def test_counter_counts_a_python_loop_17_times():
    x = torch.empty((64, 64), device="meta")
    w = torch.empty((64, 64), device="meta")

    def f(c, b):
        for _ in range(17):
            c = torch.tanh(c @ b)
        return c

    c = hc.count(f, x, w)
    assert c.flops == 17 * (2 * 64 ** 3 + 64 * 64)   # + the tanh's outputs
    assert c.calls == {"aten.mm.default": 17, "aten.tanh.default": 17}
    assert c.dynamic_whiles == 0


def _scan_inputs(device="meta", B=2, S=48, di=40, state=16, rank=8):
    g = torch.Generator().manual_seed(0)

    def t(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g).to(dtype).to(device)

    xp = t(B, S, rank + 2 * state)
    return (t(B, S, di), t(B, S, di), xp[..., rank:rank + state],
            xp[..., rank + state:], t(di, state, dtype=torch.float32),
            t(B, di, state, dtype=torch.float32))


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_k6_and_k6b_counted_once_with_launch_models(device):
    args = _scan_inputs(device)
    x1, _, Bm, _, A, _ = args
    B, S, di = x1.shape
    state = A.shape[1]
    fwd = hc.count(ssm_scan, *args)
    assert fwd.calls == {"repro_torch.ssm_scan.default": 1}
    assert (fwd.bytes, fwd.flops) == roof.ssm_scan_launch(B, S, di, state,
                                                          2, 2)
    dy = torch.zeros((B, S, di), device=device)
    bwd = hc.count(ssm_scan_bwd, *args, dy)
    assert bwd.calls == {"repro_torch.ssm_scan_bwd.default": 1}
    assert (bwd.bytes, bwd.flops) == roof.ssm_scan_bwd_launch(
        B, S, di, state, 2, 2)
    assert bwd.flops_tc == 0
    # through autograd: one of each, their shapes and types
    x = args[0].clone().requires_grad_(True)

    def step():
        y, h = SsmScan.apply(x, *args[1:])
        (y.sum() + h.sum()).backward()

    c = hc.count(step)
    assert c.kernel_calls() == {"ssm_scan": 1, "ssm_scan_bwd": 1}
    assert x.grad.shape == x.shape and x.grad.dtype == torch.bfloat16
    # FlopCounterMode reads the same formulas
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        ssm_scan(*args)
    assert fc.get_total_flops() == fwd.flops
    assert Bm.device.type == device


@pytest.mark.parametrize("kind", list(SMALL))
@pytest.mark.parametrize("arch", ARCHS + ["mixtral-8x22b/gather"])
def test_layer_fold_equals_unfolded_count(arch, kind):
    arch, _, impl = arch.partition("/")
    cfg = _deep(arch, moe_impl=impl or "onehot")
    counts = hc.layer_counts(cfg)
    if cfg.family in ("hybrid",) or cfg.layer_pattern == "local_global":
        assert counts["0"] and counts["1"]         # both kinds folded
    full = hc.count_step(cfg, SMALL[kind])
    fold = hc.count_cell(cfg, SMALL[kind])
    assert (fold.flops, fold.flops_tc, fold.bytes) == \
        (full.flops, full.flops_tc, full.bytes)
    assert {k: v for k, v in fold.calls.items() if v} == full.calls
    assert fold.kernel_calls() == full.kernel_calls()
    if cfg.family in ("ssm", "hybrid"):
        want = {"train": (8, 4), "prefill": (4, 0), "decode": (0, 0)}[kind]
        assert tuple(fold.kernel_calls().values()) == want


@pytest.mark.parametrize("arch", ["hymba-1.5b", "mixtral-8x22b",
                                  "seamless-m4t-medium"])
def test_meta_count_equals_cpu_count(arch):
    cfg = _deep(arch)
    for kind, shape in SMALL.items():
        meta = hc.count_step(cfg, shape)
        cpu = hc.count_step(cfg, shape, device="cpu")
        assert (meta.flops, meta.flops_tc, meta.bytes) == \
            (cpu.flops, cpu.flops_tc, cpu.bytes), kind
        assert meta.kernel_calls() == cpu.kernel_calls()


def test_collectives_from_placements_on_a_toy_placement():
    """Reduced falcon-mamba-7b (d 64, d_inner 128, dt_rank 8, state 4, 2
    layers, vocab 512) on a 2 x 2 mesh.  Every leaf but ``final_norm`` is
    split over ``data`` (FSDP); gathered, each keeps its ``model`` split:
    embed 256 x 64, ln1 2 x 64, in_proj 2 x 64 x 128, conv_w 2 x 128 x 4,
    conv_b, dt_bias and D 2 x 128 each, x_proj 2 x 128 x 8, dt_proj
    2 x 4 x 128, A_log 2 x 128 x 4, out_proj 2 x 64 x 64: 46,976 values.
    ``dt_proj`` (out 128) and ``out_proj`` (out 64) are split on their
    input dim: an all-reduce of their outputs a layer."""
    cfg = reduced(get_config("falcon-mamba-7b"))
    model = tmodel.init_params(cfg, device="meta")
    mesh = {"data": 2, "model": 2}
    gathered = 256 * 64 + 2 * 64 + 2 * 64 * 128 + 2 * 128 * 4 + 3 * 256 \
        + 2 * 128 * 8 + 2 * 4 * 128 + 2 * 128 * 4 + 2 * 64 * 64
    assert gathered == 46976
    decode = hc.collectives_from_placements(model, cfg, SMALL["decode"],
                                            mesh)
    # one token a device (B = 2 over data 2), bf16, 2 layers
    assert decode == {"all-gather": gathered * 2.0,
                      "all-reduce": 2 * (128 + 64) * 2.0}
    train = hc.collectives_from_placements(model, cfg, SMALL["train"], mesh)
    # remat: gathered twice; gradients reduced in float32; 16 tokens a
    # device, forward + recompute + backward
    assert train == {"all-gather": gathered * 2.0 * 2,
                     "reduce-scatter": gathered * 4.0,
                     "all-reduce": 3 * 2 * 16 * (128 + 64) * 2.0}


def test_analyze_terms_at_the_h100_rates():
    c = hc.Costs(flops=6e15, flops_tc=4e15, bytes=3.35e14,
                 coll={"all-gather": 4.5e9})
    r = roof.analyze(c, 4, model_flops=3e15)
    assert r.flops == 1.5e15 and r.flops_tc == 1e15 and r.bytes_hbm == 8.375e13
    assert r.t_compute == 1e15 / 989e12 + 0.5e15 / 67e12
    assert r.t_memory == 8.375e13 / 3.35e12
    assert r.t_collective == 4.5e9 / 450e9
    assert r.bottleneck == "memory"
    assert r.useful_ratio == 0.5 and r.per_kind == {"all-gather": 4.5e9}


# ---------------------------------------------------------------------------
# the reference lowered: argument bytes, collectives, parse_overrides
# ---------------------------------------------------------------------------

LOWERED = [("hymba-1.5b", "train_4k"), ("hymba-1.5b", "prefill_32k"),
           ("hymba-1.5b", "decode_32k"), ("mixtral-8x22b", "decode_32k")]
OVERRIDES = ["moe_impl=gather", "n_layers=4", "capacity_factor=1.5",
             "tie_embeddings=true", "qk_norm=False", "window=8", "name=x"]


@pytest.fixture(scope="module")
def lowered():
    """The reference's ``run_cell`` on reduced configs over a (2, 4) mesh of
    8 host devices, in a subprocess (the device count is fixed at JAX's
    first use): unrounded argument bytes and ``coll_by_kind`` a cell, and
    ``parse_overrides`` of :data:`OVERRIDES`."""
    script = textwrap.dedent(f"""
        import json, os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        import jax
        jax.devices()   # 8 devices, before repro.launch.dryrun asks 512
        import repro.launch.dryrun as rd
        from repro.configs import get_config, reduced
        from repro.launch.mesh import compat_make_mesh
        from repro.launch.perf_iter import parse_overrides
        rd.get_config = lambda a: reduced(get_config(a))
        rd.round = lambda x, n=None: x
        mesh = compat_make_mesh((2, 4), ("data", "model"))
        out = {{"cells": {{}}, "parse": parse_overrides({OVERRIDES!r})}}
        for arch, shape in {LOWERED!r}:
            r = rd.run_cell(arch, shape, mesh, "2x4", verbose=False)
            out["cells"][arch + "/" + shape] = {{
                "arg_bytes": r["arg_gb"] * 2 ** 30,
                "coll_by_kind": r["coll_by_kind"]}}
        print("RESULT " + json.dumps(out))
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src")]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    res = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


@pytest.mark.parametrize("cell", [f"{a}/{s}" for a, s in LOWERED])
def test_arg_bytes_equal_reference_lowering(lowered, cell):
    arch, shape_name = cell.split("/")
    cfg, shape = reduced(get_config(arch)), shapes.SHAPES[shape_name]
    mesh = make_mesh((2, 4), ("data", "model"), device="meta")
    model = tmodel.init_params(cfg, device="meta")
    got = dry.arg_bytes(model, cfg, shape, mesh,
                        shapes.input_specs(cfg, shape))
    want = lowered["cells"][cell]
    assert got == want["arg_bytes"]
    ours = hc.collectives_from_placements(model, cfg, shape, mesh.shape)
    kinds = sorted(set(ours) | set(want["coll_by_kind"]))
    print(f"{cell} collective bytes a device (reference's lowering / "
          f"port's closed form): " + ", ".join(
              f"{k} {want['coll_by_kind'].get(k, 0):.0f} / "
              f"{ours.get(k, 0):.0f}" for k in kinds))


def test_parse_overrides_matches_reference(lowered):
    got = perf_iter.parse_overrides(OVERRIDES)
    assert got == lowered["parse"]
    assert [type(v) for v in got.values()] == \
        [int if k in ("n_layers", "window") else
         float if k == "capacity_factor" else
         bool if k in ("tie_embeddings", "qk_norm") else str
         for k in got]


# ---------------------------------------------------------------------------
# rows
# ---------------------------------------------------------------------------

def test_run_cell_rows_share_one_count():
    cache = {}
    ov = _overrides("hymba-1.5b")
    rows = [dry.run_cell("hymba-1.5b", "train_4k", make_mesh(
        shp, axes, device="meta"), name, verbose=False, cfg_overrides=ov,
        cache=cache) for shp, axes, name in (
            ((16, 16), ("data", "model"), "16x16"),
            ((2, 16, 16), ("pod", "data", "model"), "2x16x16"))]
    assert len(cache) == 1
    a, b = rows
    assert a["status"] == b["status"] == "ok"
    assert (a["n_devices"], b["n_devices"]) == (256, 512)
    assert a["lower_s"] == b["lower_s"]
    assert a["flops_per_dev"] == 2 * b["flops_per_dev"]
    assert a["compile_s"] is a["temp_gb"] is a["out_gb"] is None
    for r in rows:
        for k in ("flops_per_dev", "hbm_bytes_per_dev", "arg_gb",
                  "t_compute", "t_memory", "t_collective", "useful_ratio",
                  "model_flops"):
            assert math.isfinite(r[k]) and r[k] >= 0, k
        assert set(r["coll_by_kind"]) == {"all-gather", "reduce-scatter",
                                          "all-reduce"}
    skipped = dry.run_cell("qwen3-4b", "long_500k", make_mesh(
        (16, 16), ("data", "model"), device="meta"), "16x16", verbose=False)
    assert skipped["status"] == "skipped"
    assert skipped["reason"] == jshapes.applicability(
        jget("qwen3-4b"), jshapes.SHAPES["long_500k"])


def test_run_cell_on_the_cpu_at_a_reduced_config():
    mesh = make_mesh((16, 16), ("data", "model"), device="meta")
    row = dry.run_cell("hymba-1.5b", "train_4k", mesh, "16x16",
                       verbose=False, cfg_overrides=_overrides("hymba-1.5b"),
                       device="cpu", run_batch=2, run_seq=16, run_calls=1)
    rec = row["cpu"]
    assert rec["finite"] and rec["calls"] == 1
    assert (rec["batch"], rec["seq"]) == (2, 16)
    assert rec["reduced"] == ["batch 256 -> 2 (the 16x16 mesh's "
                              "per-device share is 16)", "seq 4096 -> 16"]
    # 2 Mamba layers: K6 forward and in the recompute, K6b once each
    assert rec["counted"] == {"ssm_scan": 4, "ssm_scan_bwd": 2}
    assert rec["launches"] == {"ssm_scan": 0, "ssm_scan_bwd": 0}  # plain
    assert rec["bound_ms"] > 0 and rec["step_ms"] > 0


def test_run_cell_cuts_the_depth_of_the_run_alone():
    """``run_layers`` cuts the run (listed in ``reduced``, counted at that
    depth); the row stays the whole config's."""
    mesh = make_mesh((16, 16), ("data", "model"), device="meta")
    ov = dict(_overrides("hymba-1.5b"), n_layers=8)
    kw = dict(verbose=False, cfg_overrides=ov, run_batch=1, run_seq=16,
              run_calls=0, cache={})
    whole = dry.run_cell("hymba-1.5b", "train_4k", mesh, "16x16", **kw)
    row = dry.run_cell("hymba-1.5b", "train_4k", mesh, "16x16",
                       device="cpu", run_layers=4, **kw)
    rec = row["cpu"]
    assert rec["layers"] == 4 and rec["finite"]
    assert rec["reduced"][-1] == "layers 8 -> 4"
    # 4 Mamba layers: K6 forward and in the recompute, K6b once each
    assert rec["counted"] == {"ssm_scan": 8, "ssm_scan_bwd": 4}
    assert {k: v for k, v in row.items() if k != "cpu"} == whole


def test_dryrun_main_writes_every_row(tmp_path):
    rc = dry.main(["--arch", "qwen3-4b", "--shape", "long_500k", "--mesh",
                   "both", "--out", str(tmp_path)])
    assert rc == 0
    rows = json.load(open(tmp_path / "dryrun_qwen3-4b_long_500k_both.json"))
    assert [(r["mesh"], r["status"]) for r in rows] == \
        [("16x16", "skipped"), ("2x16x16", "skipped")]


def test_reduced_configs_equal_reference():
    """The lowering above runs the reference's ``reduced`` configs, the
    port's side its own: the two are equal."""
    for a in ARCHS:
        assert dataclasses.asdict(reduced(get_config(a))) == \
            dataclasses.asdict(jreduced(jget(a)))
