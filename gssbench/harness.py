"""One run of one cell: set-up, the measured window, the checks, the line.

Two kinds of traffic (``gssbench/traffic/<name>.json``, key ``kind``):

* ``closed_batch`` — one client submits a request of ``columns``
  right-hand sides to ``SolverService`` on the hierarchy built in set-up,
  flushes, and submits the next.  The window is whole flushes: it ends with
  the first flush that ends after ``--seconds`` of flush time.
* ``resparsify`` — one client gives the service the configuration's
  topology with conductances redrawn from (seed, cycle), submits one
  request of ``columns`` right-hand sides and flushes: every cycle builds a
  hierarchy and solves.  The window is whole cycles, as above.

The client draws the next request (and the next graph) between flushes,
outside the window's time: that is not the system's work.  Right-hand sides and conductances are drawn on the device
from ``--seed`` with a ``torch.Generator``; the graph's topology and its
set-up weights come from the configuration's seed.

After the window the plain reference judges every answered column
(:mod:`gssbench.reference`) and, in ``resparsify``, the whole hierarchy of
:data:`BUILDS_JUDGED` cycles drawn from the seed
(:mod:`gssbench.build_reference`); each number compared is printed with
its limit.
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from gssbench import build_reference, reference
from gssbench.manifest import Manifest, generator
from gssbench.profiling import DeviceTrace, TracedWindow

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# The set-up's short solve: WARM_TRIPS trips of one column run the PCG
# loop's kernels once (the service's warmup runs the V-cycle at the cell's
# width) while the host's float64 residual stays one column wide.
WARM_TRIPS = 16
# independent random streams drawn from --seed
RHS, WEIGHTS, WARM, SAMPLE = 1, 2, 3, 4
# cycles of a resparsify run whose hierarchies the reference judges whole
BUILDS_JUDGED = 2
# the limits of the build's numbers (PERF.md gives the readings they were
# set from); a count's limit is 0
BUILD_LIMITS = {"weight_gap": 1e-3}


def forbidden_modules(modules) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is, whole,
    one of :data:`FORBIDDEN`.  ``repro_torch`` passes."""
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def stream_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed for one stream of ``seed``, e.g. ``(seed, RHS, i)``."""
    ss = np.random.SeedSequence([int(seed) % 2 ** 64, *keys])
    return int(ss.generate_state(1, np.uint64)[0]) % 2 ** 63


@dataclasses.dataclass
class Batch:
    """One flush (``closed_batch``) or one cycle (``resparsify``)."""

    t0: float                  # perf_counter, before the submit
    t1: float                  # perf_counter, after the flush returned
    cols: int
    iters: np.ndarray          # per column, the response's PCG iterations
    solved: int                # columns the program reports within tol
    profiled: bool = False


@dataclasses.dataclass
class Run:
    """What a run measured; the metric readers read it."""

    cell: str
    kind: str
    seconds: float
    trace: bool
    setup_s: float = 0.0
    window_s: float = 0.0
    batches: List[Batch] = dataclasses.field(default_factory=list)
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    spans: List[dict] = dataclasses.field(default_factory=list)
    device: Optional[DeviceTrace] = None
    profiled: Optional[tuple] = None     # (t0, t1) perf_counter
    shapes: dict = dataclasses.field(default_factory=dict)


class Inputs:
    """What a run hands the program, and the reference too: the
    configuration's graph as canonical edge arrays, and right-hand sides
    and conductances drawn on ``device`` from ``seed``."""

    def __init__(self, config: dict, seed: int, device):
        import torch

        self.torch = torch
        self.dev = torch.device(device)
        self.config = config
        self.seed = int(seed)
        g = config["graph"]
        n, src, dst, w = generator(g["family"]).generate(g, g["seed"])
        src, dst = np.minimum(src, dst), np.maximum(src, dst)
        order = np.argsort(src.astype(np.int64) * n + dst, kind="stable")
        self.n = int(n)
        self.src, self.dst = src[order], dst[order]
        self.w0 = np.asarray(w, np.float32)[order]

    def _generator(self, *keys: int):
        g = self.torch.Generator(device=self.dev)
        g.manual_seed(stream_seed(self.seed, *keys))
        return g

    def columns(self, k: int, *keys: int) -> np.ndarray:
        """``[n, k]`` float32 standard normals, column means removed."""
        b = self.torch.randn((self.n, k), generator=self._generator(*keys),
                             device=self.dev, dtype=self.torch.float32)
        return (b - b.mean(dim=0)).cpu().numpy()

    def weights(self, *keys: int) -> np.ndarray:
        """``[m]`` float32 conductances of the configuration's range."""
        g = self.config["graph"]
        lo, hi = float(g["weight_low"]), float(g["weight_high"])
        u = self.torch.rand(len(self.src), generator=self._generator(*keys),
                            device=self.dev, dtype=self.torch.float32)
        return (u * (hi - lo) + lo).cpu().numpy()


class _Cell(Inputs):
    """The program and the inputs of one run."""

    def __init__(self, manifest: Manifest, cell: str, seed: int,
                 seconds: float, trace: bool, device: str, t_start: float,
                 config: Optional[dict], traffic: Optional[dict]):
        from repro_torch.core.graph import build_graph

        if config is None or traffic is None:
            entry = manifest.workload(cell)
            config = config or manifest.config(entry["config"])
            traffic = traffic or manifest.traffic(entry["traffic"])
        super().__init__(config, seed, device)
        torch = self.torch
        self.cuda = self.dev.type == "cuda"
        self.traffic = traffic
        self.t_start = t_start
        self.run = Run(cell=cell, kind=self.traffic["kind"],
                       seconds=float(seconds), trace=bool(trace))
        s = self.config["solver"]
        self.tol, self.maxiter = float(s["tol"]), int(s["maxiter"])
        # the configuration's precision: float32 on the card, TF32 off
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.window = TracedWindow(self.cuda) if trace else None
        self.graph = build_graph(self.n, self.src, self.dst, self.w0)
        # the program keeps the canonical edge order, so a redrawn weight
        # array lines up with its CSR through adj_edge
        if not (np.array_equal(self.graph.src, self.src)
                and np.array_equal(self.graph.dst, self.dst)):
            raise RuntimeError("build_graph reordered the canonical edges")
        self._make_service()

    def reweighted(self, *keys: int):
        """The configuration's topology with weights drawn from ``keys``."""
        w = self.weights(*keys)
        return dataclasses.replace(self.graph, weight=w,
                                   adj_w=w[self.graph.adj_edge]), w

    # -- the program ----------------------------------------------------------

    def _make_service(self) -> None:
        from repro_torch.pipeline import pdgrass_config
        from repro_torch.solver import SolverService

        s = self.config["solver"]
        self.svc = SolverService(
            pipeline=pdgrass_config(alpha=float(s["alpha"]), c=int(s["c"]),
                                    chunk=int(s["chunk"])),
            coarse_n=int(s["coarse_n"]), max_refine=int(s["max_refine"]),
            device=self.dev)

    def request(self, graph, b, maxiter: Optional[int] = None):
        from repro_torch.solver.requests import SolveRequest

        return SolveRequest(graph=graph, b=b, tol=self.tol,
                            maxiter=self.maxiter if maxiter is None
                            else maxiter)

    def flush_one(self, graph, b, maxiter: Optional[int] = None):
        ticket = self.svc.submit(self.request(graph, b, maxiter))
        self.svc.flush()
        return ticket.result()

    def hierarchy(self, graph):
        _, (_, _, hier), source = self.svc.artifacts(self.svc.register(graph))
        if source != "mem":
            raise RuntimeError(f"the hierarchy just built was not cached "
                               f"({source})")
        return hier

    def note_shapes(self, hier, k: int) -> None:
        """Shapes of the solve's work: the graph's ELL width (the PCG's
        level-0 matvec) and the hierarchy's levels (the V-cycle)."""
        self.run.shapes = {
            "n": self.n, "ell_width": int(self.graph.degrees.max()) + 1,
            "k": k, "level_triples": [(int(lev.n), int(lev.idx.shape[1]),
                                       int(lev.n_coarse))
                                      for lev in hier.levels]}

    # -- the window -----------------------------------------------------------

    def _counters(self) -> Dict[str, float]:
        from repro_torch.obs import get_metrics

        snap = {**get_metrics().snapshot(), **self.svc.metrics.snapshot()}
        return {k: v for k, v in snap.items() if isinstance(v, (int, float))}

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize(self.dev)

    def open_window(self) -> None:
        """End of set-up: the next statement is the first timed one."""
        from repro_torch.obs import get_tracer

        self.sync()
        self._c0 = self._counters()
        tracer = get_tracer()
        tracer.clear()
        if self.run.trace:
            tracer.enable()
        self.run.setup_s = time.perf_counter() - self.t_start

    def close_window(self) -> None:
        from repro_torch.obs import get_tracer

        tracer = get_tracer()
        c1 = self._counters()
        self.run.counters = {k: v - self._c0.get(k, 0) for k, v in c1.items()}
        self.run.spans = [e for e in tracer.events() if "dur_ns" in e]
        tracer.disable()
        self.memory_peak = (int(self.torch.cuda.max_memory_allocated(self.dev))
                            if self.cuda else 0)

    def stop_trace(self, t0: float, t1: float) -> None:
        self.window.stop()
        self.run.profiled = (t0, t1)

    def reduce_trace(self) -> None:
        if self.window is not None and self.run.profiled is not None:
            spans = [(e["ts_ns"], e["ts_ns"] + e["dur_ns"], e["name"])
                     for e in self.run.spans]
            self.run.device = self.window.reduce(spans)


def _more(c: _Cell, i: int) -> bool:
    """Another batch?  Whole batches until ``--seconds`` of their time; a
    traced run also holds its traced batch (the second) and one more."""
    return c.run.window_s < c.run.seconds or (c.window is not None
                                              and i < 2)


def _solved(resp, tol: float) -> int:
    return int((np.atleast_1d(resp.relres) <= tol).sum())


def _batch_loop(c: _Cell, prepare, keep) -> list:
    """The closed loops' window: ``prepare(i) -> (graph, b)`` draws batch
    ``i`` untimed, its submit and flush are timed, ``keep(graph, b,
    response)`` takes what the reference needs, untimed.  Returns what
    ``keep`` returned, batch by batch."""
    run, i, kept = c.run, 0, []
    c.open_window()
    while _more(c, i):
        graph, b = prepare(i)
        profiled = c.window is not None and i == 1
        if profiled:                 # the profiler's start is not the batch's
            c.window.start()
        t0 = time.perf_counter()
        resp = c.flush_one(graph, b)
        t1 = time.perf_counter()
        if profiled:
            c.stop_trace(t0, t1)
        run.window_s += t1 - t0
        batch = Batch(t0, t1, b.shape[1], np.asarray(resp.iters),
                      _solved(resp, c.tol), profiled)
        run.batches.append(batch)
        print(f"gssbench: batch {i}: {t1 - t0:.3f} s, {batch.cols} columns, "
              f"{int(batch.iters.max())} trips, {resp.refinements} "
              f"refinements, {batch.solved} solved"
              + (", traced" if profiled else ""), file=sys.stderr)
        kept.append(keep(graph, b, resp))
        i += 1
    c.close_window()
    return kept


def _closed_batch(c: _Cell) -> dict:
    k = int(c.traffic["columns"])
    h = c.svc.register(c.graph)
    c.svc.warmup(h, widths=[k])
    c.flush_one(h, c.columns(1, WARM, 0), maxiter=WARM_TRIPS)
    c.note_shapes(c.hierarchy(c.graph), k)
    kept = _batch_loop(c, lambda i: (h, c.columns(k, RHS, i)),
                       lambda g, b, resp: (b, resp.x))
    return {"solutions": [(c.w0, kept)]}


def _resparsify(c: _Cell) -> dict:
    k = int(c.traffic["columns"])
    g, _ = c.reweighted(WARM, 0)
    c.flush_one(g, c.columns(1, WARM, 0), maxiter=WARM_TRIPS)
    c.note_shapes(c.hierarchy(g), k)

    def keep(g, b, resp):
        return g.weight, [(b, resp.x)], host_hierarchy(c.hierarchy(g))

    kept = _batch_loop(c, lambda i: (c.reweighted(WEIGHTS, i)[0],
                                     c.columns(k, RHS, i)), keep)
    return {"solutions": [s[:2] for s in kept],
            "builds": [(s[0], s[2]) for s in kept]}


def host_hierarchy(hier) -> dict:
    """What the reference judges of a hierarchy, copied to the host:
    each level's sparsifier slabs, aggregation map and coarse size, and
    the coarsest level's factor."""
    levels = [{"n": lev.n, "idx": lev.idx.cpu().numpy(),
               "val": lev.val.cpu().numpy(), "agg": lev.agg.cpu().numpy(),
               "n_coarse": lev.n_coarse} for lev in hier.levels]
    chol = (None if hier.coarse_chol is None
            else hier.coarse_chol.cpu().numpy())
    return {"levels": levels, "chol": chol}


KINDS = {"closed_batch": _closed_batch, "resparsify": _resparsify}


def worst_relres(n: int, src, dst, solutions) -> float:
    """The largest ``||b - L x|| / ||b||`` of every column in
    ``solutions``, a list of ``(weights, [(b, x), ...])``, judged in blocks
    of 32 columns."""
    worst = 0.0
    for w, pairs in solutions:
        L = reference.laplacian(n, src, dst, w)
        for j in range(0, len(pairs), 32):
            block = pairs[j:j + 32]
            B = np.column_stack([np.reshape(b, (n, -1)) for b, _ in block])
            X = np.column_stack([np.reshape(x, (n, -1)) for _, x in block])
            worst = max(worst, float(reference.relres(L, B, X).max()))
    return worst


def judge_builds(c: _Cell, builds: list) -> Dict[str, dict]:
    """The numbers of :data:`BUILDS_JUDGED` of ``builds`` (``(weights,
    host_hierarchy)`` a cycle), drawn from the seed, each the worst over
    them, with their limits."""
    rng = np.random.default_rng(stream_seed(c.seed, SAMPLE))
    pick = sorted(rng.choice(len(builds), min(BUILDS_JUDGED, len(builds)),
                             replace=False))
    s = c.config["solver"]
    readings = [build_reference.judge_hierarchy(
        c.n, c.src, c.dst, builds[i][0], builds[i][1]["levels"],
        builds[i][1]["chol"], float(s["alpha"]), int(s["c"]), c.dev)
        for i in pick]
    got = build_reference.worst(readings)
    return {k: {"value": v, "limit": BUILD_LIMITS.get(k, 0)}
            for k, v in got.items()}


def judge(c: _Cell, out: dict) -> Dict[str, dict]:
    """The numbers compared with the reference, each with its limit."""
    checks = {"max_relres": {"value": worst_relres(c.n, c.src, c.dst,
                                                   out["solutions"]),
                             "limit": c.tol}}
    if "builds" in out:
        checks.update(judge_builds(c, out["builds"]))
    return checks


def run_cell(manifest: Manifest, cell: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda",
             t_start: Optional[float] = None, config: Optional[dict] = None,
             traffic: Optional[dict] = None, chips: int = 1) -> dict:
    """Run ``cell`` once and return its result line as a dict (keys in the
    printed order, ``checks`` last).  ``config``/``traffic`` replace the
    files the manifest names (the tests' tiny sizes)."""
    t_start = time.perf_counter() if t_start is None else t_start
    c = _Cell(manifest, cell, seed, seconds, trace, device, t_start,
              config, traffic)
    if c.run.kind not in KINDS:
        raise ValueError(f"unknown traffic kind {c.run.kind!r}")
    out = KINDS[c.run.kind](c)
    c.reduce_trace()
    run = c.run
    # the program's state goes before the reference runs
    del c.svc
    gc.collect()
    checks = judge(c, out)
    attempted = sum(b.cols for b in run.batches)
    solved = sum(b.solved for b in run.batches)
    table = (manifest.per_layer(cell) if run.trace
             else manifest.end_to_end(cell))
    metrics = {}
    for m in table:
        value = manifest.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        elif not run.trace:
            raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
    dev = {"platform": "gpu" if c.cuda else "cpu",
           "kind": (c.torch.cuda.get_device_name(c.dev) if c.cuda
                    else "cpu"),
           "count": int(chips), "memory_peak_bytes": c.memory_peak}
    result = {"correct": all(v["value"] <= v["limit"]
                             for v in checks.values()),
              "attempted": int(attempted), "failed": int(attempted - solved),
              "metrics": metrics, "device": dev}
    if run.trace and run.device is not None:
        dev.update(busy_s=run.device.busy_s, window_s=run.device.window_s)
        result["breakdown"] = {
            "device_ops": run.device.top(run.device.op_s),
            "idle_gaps": run.device.top(run.device.gap_s)}
    result["checks"] = checks
    return result
