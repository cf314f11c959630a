"""The port's cost counter: the flops, bytes and calls of one step, counted
as it runs.

The port of ``repro.launch.hlo_costs``.  The reference compiles a step and
reads its costs from the HLO text, multiplying each ``while`` body by its
static trip count.  The port has no HLO: :class:`CostCounter` is a
``TorchDispatchMode`` that counts every aten operator the step dispatches,
on ``meta`` tensors (shapes only: a step of any size is counted without
its memory) as on CPU or CUDA tensors.  The result is a :class:`Costs`
with the reference's fields.

What is counted, per operator call:

* **flops.**  Products (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
  convolutions) take ``torch.utils.flop_counter``'s formulas: ``2 m n k``
  a product.  Of those, the ones whose floating operands are all bf16 (or
  fp16) run on the tensor cores and are kept apart in ``flops_tc``.
  Elementwise operators (the ``pointwise`` tag) count their output
  elements and reductions (sums, means, maxima, softmaxes, cumulative
  sums) their input elements, as the reference counts HLO's elementwise
  and ``reduce`` ops.  Copies, casts, gathers, scatters, sorts and
  concatenations count no flops.  The port's kernels K6 and K6b
  (``repro_torch::ssm_scan``, ``repro_torch::ssm_scan_bwd``) count the
  operations and bytes of their launch models (``launch/roofline.py``
  ``ssm_scan_launch``, ``ssm_scan_bwd_launch``).
* **bytes.**  Each operator reads its tensor operands and writes its
  results: eager PyTorch's traffic, where every operator is a fusion
  boundary.  So the port's bytes exceed the reference's, which counts
  XLA's fused program, by design.  Three refinements: a write-only
  operator (``copy_``, ``fill_``, ``zero_``) does not read its
  destination; a gather (``index``, ``gather``, ``index_select``,
  ``embedding``) reads its indices and the rows it takes, not the whole
  table; an in-place scatter (``index_put_``, ``scatter_``, ...) reads
  its indices and values and writes the values, not the whole tensor.
  An operand counts its distinct elements (a broadcast dimension once)
  and a single value counts nothing, so the same step counts the same
  bytes whichever path a device takes for ``t[i] = 3``.  Views (``view``, ``transpose``, ``slice``, ``expand`` ...) and
  allocations (``empty``) count nothing.
* **calls** of every operator, by name (``aten.mm.default``); the K6 and
  K6b calls are :meth:`Costs.kernel_calls`.
* **coll** stays empty: a step on one device has no collectives.
  :func:`collectives_from_placements` gives them in closed form from the
  parameters' placements (``dist/sharding.py``).
* **dynamic_whiles** stays 0: eager loops run, so no trip count is
  unknown.

**The layer fold** (:func:`count_cell`).  The reference's ``while x
trip`` rule becomes a fold over layers: a layer's work depends only on
its kind and the shapes, so the counter runs the step on models of one
and of two layers of each kind (the decoder's kinds 0 and 1 of
``repro_torch.models.model._kinds``, and an encoder layer as a kind of its
own) and scales each kind's marginal cost by its count: 2K + 1 runs of
one or two layers in place of ``n_layers``.  The counts are Python
integers, so the fold equals the unfolded count exactly.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.dist import compress as comp_mod
from repro_torch.dist.sharding import leaf_pspecs
from repro_torch.kernels import ssm_scan as _kssm
from repro_torch.launch.shapes import input_specs, make_step_fn
from repro_torch.models import model as model_mod
from repro_torch.train.optimizer import init_opt_state
from repro_torch.train.trainer import TrainConfig

_aten = torch.ops.aten

#: the port's kernels as the counter sees them: launch-count name ->
#: operator name (:data:`repro_torch.kernels._launch.launches` counts the
#: same calls on the card)
KERNEL_OPS = {"ssm_scan": "repro_torch.ssm_scan.default",
              "ssm_scan_bwd": "repro_torch.ssm_scan_bwd.default"}

_LAUNCH_MODELS = {
    torch.ops.repro_torch.ssm_scan.default: _kssm.scan_launch_cost,
    torch.ops.repro_torch.ssm_scan_bwd.default: _kssm.scan_bwd_launch_cost,
}
_REDUCTIONS = {getattr(_aten, n) for n in (
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin",
    "logsumexp", "prod", "norm", "linalg_vector_norm", "var", "std",
    "var_mean", "all", "any", "cumsum", "cumprod", "_softmax",
    "_log_softmax", "_softmax_backward_data", "_log_softmax_backward_data")}
# pointwise-tagged, but a copy: no arithmetic
_NO_FLOPS = {_aten.clone}
_FREE = {getattr(_aten, n) for n in (
    "_unsafe_view", "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "_local_scalar_dense")}
_WRITE_ONLY = {getattr(_aten, n) for n in (
    "copy_", "fill_", "zero_", "normal_", "uniform_", "random_")}
_GATHERS = {getattr(_aten, n) for n in (
    "index", "gather", "index_select", "embedding", "take")}
_SCATTERS = {getattr(_aten, n) for n in (
    "index_put_", "_index_put_impl_", "scatter_", "scatter_add_",
    "scatter_reduce_", "index_add_", "index_copy_", "index_fill_",
    "masked_scatter_")}
_TC_DTYPES = (torch.bfloat16, torch.float16)


@dataclasses.dataclass
class Costs:
    """Counted costs of a step (the reference's fields and two of the
    port's): ``flops``, ``bytes``, ``coll`` (collective bytes by kind),
    ``dynamic_whiles``; ``flops_tc``, the part of ``flops`` in products
    of bf16 operands (the tensor cores'); ``calls``, operator name ->
    calls.  Integer-valued while counted, so sums and folds are exact."""
    flops: float = 0
    bytes: float = 0
    coll: Dict[str, float] = dataclasses.field(default_factory=dict)
    dynamic_whiles: int = 0
    flops_tc: float = 0
    calls: Dict[str, int] = dataclasses.field(default_factory=dict)

    def __iadd__(self, o: "Costs"):
        self.flops += o.flops
        self.bytes += o.bytes
        for k, v in o.coll.items():
            self.coll[k] = self.coll.get(k, 0) + v
        self.dynamic_whiles += o.dynamic_whiles
        self.flops_tc += o.flops_tc
        for k, v in o.calls.items():
            self.calls[k] = self.calls.get(k, 0) + v
        return self

    def scaled(self, k) -> "Costs":
        return Costs(self.flops * k, self.bytes * k,
                     {a: b * k for a, b in self.coll.items()},
                     self.dynamic_whiles, self.flops_tc * k,
                     {a: b * k for a, b in self.calls.items()})

    def kernel_calls(self) -> Dict[str, int]:
        """Calls of the port's kernels, by launch-count name."""
        return {k: self.calls.get(op, 0) for k, op in KERNEL_OPS.items()}


def _nbytes(t) -> int:
    """The bytes ``t``'s distinct elements take: a broadcast dimension
    (stride 0) counts once, and a single value (a scalar, or one
    broadcast) counts nothing, as a kernel takes it as an argument."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return 0 if n == 1 else n * t.element_size()


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _op_costs(func, args, kwargs, out) -> Tuple[int, int, int]:
    """``(flops, flops on the tensor cores, bytes)`` of one call."""
    model = _LAUNCH_MODELS.get(func)
    if model is not None:
        nbytes, ops = model(*args, **kwargs)
        return ops, 0, nbytes
    packet = func.overloadpacket
    if func.is_view or packet in _FREE:
        return 0, 0, 0
    ins = _tensors((args, kwargs))
    outs = _tensors(out)
    flops = tc = 0
    if packet in flop_registry:
        flops = flop_registry[packet](*args, **kwargs, out_val=out)
        if all(t.dtype in _TC_DTYPES for t in ins if t.is_floating_point()):
            tc = flops
    elif packet in _REDUCTIONS:
        flops = ins[0].numel() if ins else 0
    elif torch.Tag.pointwise in func.tags and packet not in _NO_FLOPS:
        flops = sum(t.numel() for t in outs)
    if packet in _GATHERS:
        idx = sum(_nbytes(t) for t in ins[1:]
                  if not t.is_floating_point())
        nbytes = idx + 2 * sum(_nbytes(t) for t in outs)
    elif packet in _SCATTERS:
        rest = ins[1:]
        vals = [t for t in rest if t.is_floating_point()]
        written = (_nbytes(vals[-1]) if vals else
                   max((t.numel() for t in rest), default=0)
                   * ins[0].element_size())
        nbytes = sum(_nbytes(t) for t in rest) + written
    else:
        reads = ins[1:] if packet in _WRITE_ONLY else ins
        nbytes = (sum(_nbytes(t) for t in reads)
                  + sum(_nbytes(t) for t in outs))
    return flops, tc, nbytes


_PLAIN = (int, float, bool, str, type(None), torch.dtype, torch.device,
          torch.layout, torch.memory_format)


def _leaf_key(x):
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            raise TypeError("not on meta")
        return (x.shape, x.stride(), x.dtype)
    if isinstance(x, _PLAIN):
        return (type(x), x)
    raise TypeError(f"no key for {type(x)}")


def _arg_key(x):
    if isinstance(x, (list, tuple)):
        return tuple(_leaf_key(y) for y in x)
    return _leaf_key(x)


def _template(out):
    """What rebuilds ``out`` (a meta tensor, or a tuple or list of them)."""
    if isinstance(out, torch.Tensor):
        if out.device.type != "meta":
            raise TypeError("not on meta")
        return (out.shape, out.stride(), out.dtype)
    if isinstance(out, (tuple, list)):
        return (type(out), tuple(_template(o) for o in out))
    raise TypeError(f"no template for {type(out)}")


def _rebuild(tpl):
    if isinstance(tpl[0], type):
        return tpl[0](_rebuild(t) for t in tpl[1])
    shape, stride, dtype = tpl
    return torch.empty_strided(shape, stride, dtype=dtype, device="meta")


def _functional(func) -> bool:
    schema = func._schema
    return not (schema.is_mutable or func.is_view
                or any(r.alias_info is not None for r in schema.returns))


class CostCounter(TorchDispatchMode):
    """Counts every operator dispatched inside ``with CostCounter() as c:``
    into ``c.costs`` (a :class:`Costs`), the operators of an autograd
    backward and of a ``checkpoint``'s recompute too.

    On ``meta`` tensors a call of an operator that returns new tensors is
    looked up by its operator and its operands' shapes, strides and types
    (and its other arguments): a call seen before takes the outputs' shapes
    and the costs it gave then, without running the operator's shape
    function again (most of a long prefill's calls are its attention
    tiles, each like the last)."""

    def __init__(self):
        super().__init__()
        self.costs = Costs()
        self._calls: Counter = Counter()
        self._seen: Dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        try:
            key = (func, tuple(_arg_key(a) for a in args),
                   tuple((k, _arg_key(v)) for k, v in sorted(kwargs.items()))
                   if kwargs else ())
        except TypeError:    # not all on meta, or an argument of no key
            key = None
        hit = self._seen.get(key) if key is not None else None
        if hit is not None:
            tpl, costs = hit
            out = _rebuild(tpl)
        else:
            out = func(*args, **kwargs)
            costs = _op_costs(func, args, kwargs, out)
            if key is not None and _functional(func):
                try:
                    self._seen[key] = (_template(out), costs)
                except TypeError:
                    pass
        flops, tc, nbytes = costs
        c = self.costs
        c.flops += flops
        c.flops_tc += tc
        c.bytes += nbytes
        self._calls[func] += 1
        return out

    def __exit__(self, *exc):
        self.costs.calls = {str(f): n for f, n in self._calls.items()}
        return super().__exit__(*exc)


def count(fn, *args, **kwargs) -> Costs:
    """The :class:`Costs` of one call ``fn(*args, **kwargs)``."""
    with CostCounter() as c:
        fn(*args, **kwargs)
    return c.costs


# ---------------------------------------------------------------------------
# A cell's step, folded over its layers
# ---------------------------------------------------------------------------

def layer_counts(cfg) -> Dict[str, int]:
    """The layers of each kind: ``"0"`` (global attention, or any layer of
    an ``ssm`` model), ``"1"`` (windowed) and ``"enc"`` (encoder), the
    kinds present only."""
    counts = Counter(str(k) for k in model_mod._kinds(cfg))
    if cfg.enc_layers:
        counts["enc"] = cfg.enc_layers
    return dict(counts)


def cut_config(cfg, counts: Dict[str, int]):
    """``cfg`` with ``counts[kind]`` layers of each kind, one decoder kind
    at most (:func:`layer_counts` of the result equals ``counts``): the
    layer pattern ``global`` holds kind 0, ``swa`` kind 1; every other
    field stays."""
    dec = {k: v for k, v in counts.items() if k != "enc"}
    if len(dec) != 1:
        raise ValueError(f"one decoder kind a cut, got {counts}")
    (kind, n), = dec.items()
    layout = ({} if cfg.family == "ssm" else
              {"layer_pattern": "global" if kind == "0" else "swa"})
    cut = dataclasses.replace(cfg, n_layers=n,
                              enc_layers=counts.get("enc", 0), **layout)
    if layer_counts(cut) != counts:
        raise AssertionError(f"{layer_counts(cut)} != {counts}")
    return cut


def step_inputs(cfg, shape, tcfg, device, generator=None):
    """The model, the step and its arguments of a cell on ``device``:
    weights from ``generator`` (none on ``meta``), zero inputs."""
    tcfg = tcfg or TrainConfig()
    model = model_mod.init_params(cfg, generator=generator, device=device)
    step = make_step_fn(cfg, shape, tcfg)
    specs = input_specs(cfg, shape, device=device)
    if shape.kind == "train":
        model.requires_grad_(True)
        opt = init_opt_state(model, tcfg.opt)
        ef = comp_mod.init_error_feedback(model) if tcfg.compress_grads \
            else {}
        args = (model, opt, ef, specs)
    elif shape.kind == "prefill":
        args = (model, specs)
    else:
        args = (model, specs["caches"], specs["token"], shape.seq - 1)
    return step, args


def count_step(cfg, shape, tcfg=None, device="meta") -> Costs:
    """The :class:`Costs` of one step of the cell ``(cfg, shape)``, every
    layer run (no fold); on a real device the weights come from seed 0."""
    gen = (None if torch.device(device).type == "meta"
           else torch.Generator(device=device).manual_seed(0))
    step, args = step_inputs(cfg, shape, tcfg, device, gen)
    return count(step, *args)


def count_cell(cfg, shape, tcfg=None, device="meta") -> Costs:
    """:func:`count_step` of the whole model, by the layer fold.  For each
    decoder kind ``k`` the step runs on :func:`cut_config` with one and
    with two layers of kind ``k`` alone (and one encoder layer where the
    model has an encoder); an encoder's marginal comes from a run with
    two.  With ``T(k, n)`` the count of ``n`` layers of kind ``k`` and
    ``m_k = T(k, 2) - T(k, 1)``, the whole is ``T(k0, 1) + (n_k0 - 1)
    m_k0 + sum over the other kinds of n_k m_k + (n_enc - 1) m_enc``.
    Equal to the unfolded count: 2K + 1 runs of one or two layers."""
    counts = layer_counts(cfg)
    has_enc = "enc" in counts
    kinds = [k for k in counts if k != "enc"]

    def run(kind, n, n_enc=1):
        c = {kind: n, "enc": n_enc} if has_enc else {kind: n}
        return count_step(cut_config(cfg, c), shape, tcfg, device)

    def marginal(more, less):
        m = Costs()
        m += more
        m += less.scaled(-1)
        return m

    first = None
    total = Costs()
    for kind in kinds:
        one = run(kind, 1)
        m = marginal(run(kind, 2), one)
        if first is None:
            first = one
            total += one
            total += m.scaled(counts[kind] - 1)
        else:
            total += m.scaled(counts[kind])
    if has_enc:
        total += marginal(run(kinds[0], 1, 2), first).scaled(
            counts["enc"] - 1)
    return total


# ---------------------------------------------------------------------------
# Collectives in closed form from the parameters' placements
# ---------------------------------------------------------------------------

def axis_size(axis, mesh_shape) -> int:
    """The shards of one dimension's placement (None, an axis name or a
    tuple of them) on a mesh of ``mesh_shape``."""
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= mesh_shape[a]
        return n
    return mesh_shape[axis]


def _names(axis):
    if axis is None:
        return ()
    return axis if isinstance(axis, tuple) else (axis,)


def collectives_from_placements(model, cfg, shape, mesh_shape,
                                tcfg=None) -> Dict[str, float]:
    """Collective bytes a device moves in one step of the cell, by the
    reference's kinds, from the placements of
    :func:`repro_torch.dist.sharding.leaf_pspecs` on a mesh of
    ``mesh_shape`` (axis name -> size).  A closed form of what FSDP and
    tensor parallelism over those placements move (the mixed-precision
    policy of weights gathered in the compute dtype and gradients reduced
    in float32); the port applies no placement yet (ROADMAP, the mesh
    across cards).  Each collective counts its payload as the reference's
    counter does, the larger of its operand and its result:

    * ``all-gather``: each leaf split over a data axis (``pod``,
      ``data``: FSDP) is gathered once in the forward pass, and once more
      for the recompute of a train step with ``remat``: the leaf over its
      ``model`` split alone, in the compute dtype.
    * ``reduce-scatter``: in a train step each such leaf's gradient, the
      same size in float32.
    * ``all-reduce``: each product whose weight is split over ``model``
      on its input dimension (``wo``, ``w2``, ``out_proj``, ``dt_proj``:
      the reference's ``_TP_IN``) all-reduces its output, ``[tokens,
      out]`` in the compute dtype, once a layer in the forward pass, and
      in a train step once more for the recompute (``remat``) and once
      for the backward pass's all-reduce of the input gradient it
      pairs with.  Tokens are a device's share of the decoder's (or, for
      ``encoder.*``, the encoder's: none in decode) positions: the batch
      split over the data axes when it divides."""
    tcfg = tcfg or TrainConfig()
    cd = 2 if cfg.dtype == "bfloat16" else 4
    train = shape.kind == "train"
    remat = 1 if train and tcfg.remat else 0
    dp = tuple(a for a in ("pod", "data") if a in mesh_shape)
    dp_size = axis_size(dp, mesh_shape) if dp else 1
    B = shape.batch
    b_dev = B // dp_size if B % dp_size == 0 and B >= dp_size else B
    seq = shape.seq if shape.kind in ("train", "prefill") else 1
    tokens = {"layers": b_dev * seq,
              "encoder": b_dev * shape.seq if shape.kind != "decode"
              else 0}
    out = Counter()
    for leaf, (shp, spec) in leaf_pspecs(
            model, mesh_shape, expert_shard=cfg.expert_shard).items():
        axes = [a for ax in spec for a in _names(ax)]
        if any(a in dp for a in axes):
            whole = 1   # the leaf gathered over the data axes
            for d, ax in zip(shp, spec):
                tp = mesh_shape["model"] if "model" in _names(ax) else 1
                whole *= -(-d // tp)
            out["all-gather"] += whole * cd * (1 + remat)
            if train:
                out["reduce-scatter"] += whole * 4
        name = leaf.rsplit(".", 1)[-1]
        if (name in ("wo", "w2", "out_proj", "dt_proj") and len(shp) >= 2
                and "model" in _names(spec[-2])):
            stack = leaf.partition(".")[0]
            layers = shp[0] if stack in ("layers", "encoder") else 1
            per = tokens.get(stack, 0) * shp[-1] * cd * layers
            out["all-reduce"] += per * (1 + (remat + 1 if train else 0))
    return {k: float(v) for k, v in out.items() if v}
