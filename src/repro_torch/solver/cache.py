"""Content-hash-keyed cache for hierarchies and ELL slabs.

The port of ``repro.solver.cache``.  Building a preconditioner is the
expensive part of a Laplacian solve (pipeline steps 1-4, then the
multilevel contraction).  Serving traffic hits the same graphs over and
over with new right-hand sides, so the solver service keys every built
artifact by a SHA-256 fingerprint of the graph content plus the build
parameters and reuses it.

The graph-content digest hashes the same bytes in the same order as the
reference, so one graph has the same :func:`content_fingerprint` string in
both packages; it is O(m) and memoized on the ``Graph`` instance.

Two tiers:
  * in-memory LRU (capacity-bounded, per-process), holding the artifacts
    on the service's device;
  * optional on-disk pickle directory (shared across processes/restarts),
    bounded by ``disk_max_entries`` / ``disk_max_bytes`` with
    least-recently-used eviction (a disk hit refreshes the mtime).
    Artifacts are written with every tensor on the CPU (a pickled CUDA
    tensor would not load on a machine without CUDA) and moved onto the
    cache's ``device`` when read back.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import os
import pickle
import tempfile
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.core.graph import Graph
from repro_torch.obs import Metrics, get_metrics, get_tracer

# Count of O(m) content hashes actually computed (memo misses).  Tests and
# ``SolverService.stats()`` read it to show that registered graphs are never
# re-fingerprinted on the request path.  Mirrored into the process-wide
# metrics registry as ``store.hash_events``.
HASH_EVENTS = 0


def content_fingerprint(graph: Graph) -> str:
    """SHA-256 over the canonical edge arrays, memoized per Graph instance.

    ``build_graph`` canonicalizes (src < dst, sorted, deduped), so two
    logically identical graphs hash identically.  The hashed arrays are
    frozen (``writeable = False``) beside the memo, so an in-place edit that
    would desync the digest from the content raises instead.
    """
    memo = graph.__dict__.get("_content_fp")
    if memo is not None:
        return memo
    global HASH_EVENTS
    HASH_EVENTS += 1
    get_metrics().inc("store.hash_events")
    with get_tracer().span("store.hash", n=graph.n, m=graph.m):
        h = hashlib.sha256()
        h.update(b"pdgrass-graph-v1")
        h.update(int(graph.n).to_bytes(8, "little"))
        h.update(graph.src.tobytes())
        h.update(graph.dst.tobytes())
        h.update(graph.weight.tobytes())
        fp = h.hexdigest()
    for arr in (graph.src, graph.dst, graph.weight):
        arr.flags.writeable = False
    object.__setattr__(graph, "_content_fp", fp)
    return fp


def graph_fingerprint(graph: Graph, extra: tuple = ()) -> str:
    """Fingerprint of (graph content, build parameters); only the memoized
    content digest is rehashed, never the edge arrays."""
    h = hashlib.sha256()
    h.update(content_fingerprint(graph).encode())
    for item in extra:
        h.update(repr(item).encode())
    return h.hexdigest()


def mesh_descriptor(mesh, shard_axis: str):
    """Stable description of a solve mesh for artifact keying: ``None`` on
    one device, else ``("mesh", axis, size)``."""
    if mesh is None:
        return None
    return ("mesh", str(shard_axis), int(mesh.shape[shard_axis]))


def artifact_key(content_fp: str, config, extra: tuple = ()) -> str:
    """Cache key from an already-computed content digest + PipelineConfig
    (its canonical JSON fingerprint) + extras: pure string hashing."""
    h = hashlib.sha256()
    h.update(content_fp.encode())
    h.update(config.fingerprint().encode())
    for item in extra:
        h.update(repr(item).encode())
    return h.hexdigest()


def pipeline_fingerprint(graph: Graph, config, extra: tuple = ()) -> str:
    """Fingerprint of (graph, PipelineConfig, extras) — raw-Graph shim over
    :func:`artifact_key`."""
    return artifact_key(content_fingerprint(graph), config, extra)


def move_tensors(obj, device):
    """``obj`` with every tensor inside it moved to ``device``, through
    tuples and dataclasses (the service's ``(idx, val, Hierarchy)``
    artifacts); other values as they are."""
    if torch.is_tensor(obj):
        return obj.to(device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: move_tensors(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple):
        return tuple(move_tensors(x, device) for x in obj)
    return obj


class LRUCache:
    """In-memory LRU with an optional bounded on-disk second tier.

    ``get_or_build(key, build)`` returns ``(value, source)`` where source is
    "mem", "disk", or "miss" (built now).  The builder runs at most once per
    key per process; disk entries survive restarts.

    The disk tier is capped by ``disk_max_entries`` and/or ``disk_max_bytes``
    (``None`` = unbounded): after every write the directory is pruned,
    least-recently-used pickles first.  The entry just written is never the
    victim, so a single artifact larger than ``disk_max_bytes`` still
    round-trips.  ``device`` (``None`` = leave tensors where they are) is
    where tensors read from disk are placed.
    """

    def __init__(self, capacity: int = 16, disk_dir: Optional[str] = None,
                 disk_max_entries: Optional[int] = None,
                 disk_max_bytes: Optional[int] = None,
                 metrics: Optional[Metrics] = None, device=None):
        self.capacity = int(capacity)
        self.disk_dir = disk_dir
        self.disk_max_entries = disk_max_entries
        self.disk_max_bytes = disk_max_bytes
        self.device = None if device is None else torch.device(device)
        self._mem: "collections.OrderedDict[str, Any]" = collections.OrderedDict()
        self.hits = 0
        self.disk_hits = 0
        self.misses = 0
        self.evictions = 0
        self.disk_evictions = 0
        # every counter bump is mirrored into this registry under
        # ``cache.*`` (the service passes its own registry)
        self.metrics = metrics if metrics is not None else get_metrics()
        if disk_dir:
            os.makedirs(disk_dir, exist_ok=True)

    def __len__(self) -> int:
        return len(self._mem)

    def _disk_path(self, key: str) -> Optional[str]:
        return os.path.join(self.disk_dir, f"{key}.pkl") if self.disk_dir \
            else None

    def _disk_entries(self):
        """[(path, mtime, bytes)] for every pickle in the disk tier."""
        if not self.disk_dir:
            return []
        out = []
        for name in os.listdir(self.disk_dir):
            if not name.endswith(".pkl"):
                continue
            path = os.path.join(self.disk_dir, name)
            try:
                st = os.stat(path)
            except OSError:
                continue  # concurrently evicted by another process
            out.append((path, st.st_mtime, st.st_size))
        return out

    def _prune_disk(self, keep: str) -> None:
        """Evict least-recently-used pickles until under both caps; never
        evicts ``keep`` (the path just written)."""
        if self.disk_max_entries is None and self.disk_max_bytes is None:
            return
        entries = sorted(self._disk_entries(), key=lambda e: e[1])
        total = sum(size for _, _, size in entries)
        count = len(entries)
        for path, _, size in entries:
            over = ((self.disk_max_entries is not None
                     and count > self.disk_max_entries)
                    or (self.disk_max_bytes is not None
                        and total > self.disk_max_bytes))
            if not over:
                break
            if path == keep:
                continue
            try:
                os.remove(path)
            except OSError:
                continue
            self.disk_evictions += 1
            self.metrics.inc("cache.disk_evictions")
            count -= 1
            total -= size

    def _put_mem(self, key: str, value: Any) -> None:
        self._mem[key] = value
        self._mem.move_to_end(key)
        while len(self._mem) > self.capacity:
            self._mem.popitem(last=False)
            self.evictions += 1
            self.metrics.inc("cache.evictions")

    def get(self, key: str) -> Tuple[Any, str]:
        """(value, "mem"|"disk") or (None, "miss") without building."""
        with get_tracer().span("cache.get", key=key[:12]) as sp:
            if key in self._mem:
                self._mem.move_to_end(key)
                self.hits += 1
                self.metrics.inc("cache.mem_hits")
                sp.set(tier="mem")
                return self._mem[key], "mem"
            path = self._disk_path(key)
            if path:
                try:
                    with open(path, "rb") as f:
                        value = pickle.load(f)
                except (OSError, pickle.PickleError, EOFError, ValueError,
                        AttributeError, ImportError, RuntimeError):
                    # not on disk, evicted or torn by a concurrent process,
                    # pickled against a schema this process lacks, or a
                    # tensor storage torch cannot restore: a miss, rebuild
                    sp.set(tier="miss")
                    return None, "miss"
                try:
                    os.utime(path)  # refresh recency for mtime eviction
                except OSError:
                    pass
                if self.device is not None:
                    value = move_tensors(value, self.device)
                self.disk_hits += 1
                self.metrics.inc("cache.disk_hits")
                self._put_mem(key, value)
                sp.set(tier="disk")
                return value, "disk"
            sp.set(tier="miss")
            return None, "miss"

    def put(self, key: str, value: Any) -> None:
        self._put_mem(key, value)
        path = self._disk_path(key)
        if path:
            # atomic write: never leave a torn pickle for a reader to load
            with get_tracer().span("cache.put_disk", key=key[:12]):
                fd, tmp = tempfile.mkstemp(dir=self.disk_dir, suffix=".tmp")
                with os.fdopen(fd, "wb") as f:
                    pickle.dump(move_tensors(value, "cpu"), f)
                os.replace(tmp, path)
                self._prune_disk(keep=path)

    def get_or_build(self, key: str,
                     build: Callable[[], Any]) -> Tuple[Any, str]:
        value, source = self.get(key)
        if source != "miss":
            return value, source
        self.misses += 1
        self.metrics.inc("cache.misses")
        with get_tracer().span("cache.build", key=key[:12]):
            value = build()
        self.put(key, value)
        return value, "miss"

    @property
    def stats(self) -> dict:
        out = {"hits": self.hits, "disk_hits": self.disk_hits,
               "misses": self.misses, "evictions": self.evictions,
               "size": len(self._mem), "capacity": self.capacity}
        if self.disk_dir:
            entries = self._disk_entries()
            out.update({
                "disk_entries": len(entries),
                "disk_bytes": sum(size for _, _, size in entries),
                "disk_evictions": self.disk_evictions,
                "disk_max_entries": self.disk_max_entries,
                "disk_max_bytes": self.disk_max_bytes,
            })
        return out
