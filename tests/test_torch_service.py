"""The port's serving layer (repro_torch.solver: cache, requests, service)
held to the reference's contracts and against the reference's service.

The contracts are the reference's own tests, ported one for one:
``tests/test_requests.py`` (fingerprint memoization, tickets, validation,
the mixed-config scheduler, inert padding columns, the bounded disk tier),
``tests/test_store_persist.py`` (npz persistence, rehydration, caps) and
the service tests of ``tests/test_solver.py``.  Every service runs on the
CPU (``device="cpu"``), where the kernels' plain versions run.

Parity with the JAX ``SolverService`` on the same graph and right-hand
sides: +-2 iterations, re-based x rtol 1e-3, relres <= tol, the same
sequence of cache sources and the same content fingerprint string; the
port's artifact keys never equal the reference's.
"""
import inspect
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import graph as jgraph  # noqa: E402
from repro.pipeline import fegrass_config as jfegrass_config  # noqa: E402
from repro.pipeline import pdgrass_config as jpdgrass_config  # noqa: E402
from repro.solver import SolveRequest as JSolveRequest  # noqa: E402
from repro.solver import SolverService as JSolverService  # noqa: E402
from repro.solver import cache as jcache  # noqa: E402
from repro_torch.core import build_graph, grid2d, mesh2d  # noqa: E402
from repro_torch.core.pcg import pcg_host  # noqa: E402
from repro_torch.launch import make_mesh  # noqa: E402
from repro_torch.pipeline import (PipelineConfig, TreeConfig,  # noqa: E402
                                  fegrass_config, pdgrass_config)
from repro_torch.solver import (GraphStore, LRUCache,  # noqa: E402
                                SolveRequest, SolverService,
                                batched_pcg, ell_laplacian,
                                graph_fingerprint, make_matvec)
from repro_torch.solver import cache as cache_mod  # noqa: E402


def _rhs(g, k=1, seed=0):
    rng = np.random.default_rng(seed)
    b = rng.standard_normal((g.n, k)).astype(np.float32)
    return b - b.mean(axis=0)


def _rebase(x):
    """Laplacian solutions are defined up to a constant; pin x[0] = 0."""
    x = np.asarray(x, dtype=np.float64)
    return x - x[0]


def _copy_graph(g):
    """A structurally identical but distinct Graph object."""
    return build_graph(g.n, g.src.copy(), g.dst.copy(), g.weight.copy())


def _store_dir(tmp_path):
    return str(tmp_path / "graphstore")


def _graphs(k, seed0=10):
    return [grid2d(4 + i, 4, seed=seed0 + i) for i in range(k)]


# -- the reference's request-plane, store and service contracts ---------------

def test_content_hash_computed_once_per_graph_object():
    g = mesh2d(9, 9, seed=1)
    before = cache_mod.HASH_EVENTS
    fp1 = graph_fingerprint(g)
    fp2 = graph_fingerprint(g, extra=("alpha", 0.05))
    fp3 = graph_fingerprint(g, extra=("alpha", 0.1))
    assert cache_mod.HASH_EVENTS == before + 1  # one O(m) pass, three keys
    assert len({fp1, fp2, fp3}) == 3


def test_store_dedupes_by_content_and_handles_key_dicts():
    g = mesh2d(8, 8, seed=2)
    store = GraphStore()
    h1 = store.register(g)
    h2 = store.register(g)                  # same object: memo lookup
    h3 = store.register(_copy_graph(g))     # equal content: same handle
    assert h1 is h2 and h1 is h3
    assert len(store) == 1
    assert g in store and h1 in store and h1.fingerprint in store
    assert store.get(h1.fingerprint) is h1
    other = store.register(mesh2d(8, 8, seed=3))
    assert other != h1 and len(store) == 2
    assert len({h1, h3, other}) == 2        # handles hash by fingerprint
    with pytest.raises(TypeError, match="Graph or GraphHandle"):
        store.register("not a graph")


def test_registered_traffic_never_rehashes():
    g = mesh2d(10, 10, seed=4)
    svc = SolverService(device="cpu", alpha=0.05, precond="none")
    h = svc.register(g)
    b = _rhs(g, seed=5)[:, 0]
    svc.solve(h, b)
    before = cache_mod.HASH_EVENTS
    svc.submit(SolveRequest(graph=h, b=b))
    svc.submit(SolveRequest(graph=h, b=b))
    svc.flush()
    svc.solve(h, b)
    assert cache_mod.HASH_EVENTS == before
    assert svc.stats()["store"]["graphs"] == 1


def test_fingerprinted_arrays_are_frozen_against_silent_mutation():
    g = mesh2d(8, 8, seed=22)
    GraphStore().register(g)
    # the memoized digest must never desync from the content: the hashed
    # arrays become read-only, so an in-place edit raises instead of
    # silently cache-hitting the wrong hierarchy
    with pytest.raises(ValueError, match="read-only"):
        g.weight[0] = 99.0
    assert g.weight.flags.writeable is False


def test_store_counts_only_its_own_hash_events():
    g = mesh2d(8, 8, seed=23)
    store = GraphStore()
    store.register(g)
    store.register(g)
    store.register(_copy_graph(g))
    assert store.stats == {"graphs": 1, "hash_events": 2}  # g + its copy
    other = GraphStore()
    other.register(store.get(content_fingerprint_of(g)))
    assert other.hash_events == 0          # handle path: no hashing


def content_fingerprint_of(g):
    return g.__dict__["_content_fp"]


def test_tickets_are_stable_across_flushes_and_resolve_out_of_order():
    g = mesh2d(9, 9, seed=6)
    svc = SolverService(device="cpu", alpha=0.05, precond="none")
    h = svc.register(g)
    b = _rhs(g, k=3, seed=7)
    t0 = svc.submit(SolveRequest(graph=h, b=b[:, 0]))
    out0 = svc.flush()
    t1 = svc.submit(SolveRequest(graph=h, b=b[:, 1]))
    t2 = svc.submit(SolveRequest(graph=h, b=b[:, 2]))
    out1 = svc.flush()
    # v1 handed out per-flush list indices (t1 would collide with t0);
    # v2 ids are service-wide monotonic
    assert (int(t0), int(t1), int(t2)) == (0, 1, 2)
    assert t0 in out0 and t1 in out1 and t2 in out1
    # futures resolve in any order, long after their flush
    assert t2.done() and t1.done()
    r2, r1 = t2.result(), t1.result()
    assert r1.converged and r2.converged
    np.testing.assert_array_equal(r1.x, out1[t1].x)


def test_ticket_result_triggers_flush_lazily():
    g = mesh2d(9, 9, seed=8)
    svc = SolverService(device="cpu", alpha=0.05, precond="none")
    t = svc.submit(SolveRequest(graph=g, b=_rhs(g, seed=9)[:, 0]))
    assert not t.done()
    res = t.result()                        # flushes the owning service
    assert t.done() and res.converged
    assert svc.stats()["scheduler"]["pending"] == 0


def test_v1_int_indexing_still_works():
    g = mesh2d(9, 9, seed=10)
    svc = SolverService(device="cpu", alpha=0.05, precond="none")
    t = svc.submit(SolveRequest(graph=g, b=_rhs(g, seed=11)[:, 0]))
    out = svc.flush()
    assert out[t].converged                 # ticket object as key
    assert out[int(t)].converged            # bare int (v1 callers)


def test_non_finite_rhs_is_rejected_with_clear_error():
    g = mesh2d(8, 8, seed=12)
    svc = SolverService(device="cpu", alpha=0.05)
    b = _rhs(g, seed=13)[:, 0]
    for bad in (np.nan, np.inf, -np.inf):
        poisoned = b.copy()
        poisoned[3] = bad
        with pytest.raises(ValueError, match="non-finite"):
            svc.submit(SolveRequest(graph=g, b=poisoned))
        with pytest.raises(ValueError, match="non-finite"):
            svc.solve(g, poisoned)


def test_bad_pipeline_override_is_rejected():
    g = mesh2d(8, 8, seed=14)
    svc = SolverService(device="cpu", alpha=0.05)
    b = _rhs(g, seed=15)[:, 0]
    with pytest.raises(TypeError, match="PipelineConfig"):
        svc.submit(SolveRequest(graph=g, b=b, pipeline="pdgrass"))
    bogus = PipelineConfig(tree=TreeConfig(kind="no_such_stage"))
    with pytest.raises(ValueError, match="unknown tree stage"):
        svc.submit(SolveRequest(graph=g, b=b, pipeline=bogus))


def test_f64_rhs_overflowing_f32_is_rejected():
    g = mesh2d(8, 8, seed=33)
    svc = SolverService(device="cpu", alpha=0.05)
    b = np.zeros(g.n, np.float64)
    b[0], b[1] = 1e300, -1e300      # finite in f64, inf after the f32 cast
    with pytest.raises(ValueError, match="f32"):
        svc.solve(g, b)


def test_group_failure_is_isolated_to_its_config_group(monkeypatch):
    g = mesh2d(10, 10, seed=30)
    pd = pdgrass_config(alpha=0.05, chunk=128)
    fe = fegrass_config(alpha=0.05, chunk=128)
    svc = SolverService(device="cpu", pipeline=pd)
    h = svc.register(g)
    boom = RuntimeError("hierarchy build exploded")
    real_artifacts = svc.artifacts

    def flaky(graph, key=None, pipeline=None):
        if pipeline is not None and pipeline.recovery.kind == "multipass":
            raise boom
        return real_artifacts(graph, key=key, pipeline=pipeline)

    monkeypatch.setattr(svc, "artifacts", flaky)
    b = _rhs(g, k=2, seed=31)
    t_ok = svc.submit(SolveRequest(graph=h, b=b[:, 0]))
    t_bad = svc.submit(SolveRequest(graph=h, b=b[:, 1], pipeline=fe))
    out = svc.flush()
    # the pd group solved and resolved despite the fe group's failure
    assert t_ok in out and out[t_ok].converged and t_ok.result().converged
    # the fe group's ticket settled with the failure, resolvable any time
    assert t_bad not in out and t_bad.done()
    assert t_bad.error() is boom
    with pytest.raises(RuntimeError, match="exploded"):
        t_bad.result()
    sched = svc.stats()["scheduler"]
    assert sched["group_failures"] == 1 and sched["requests_solved"] == 1


def test_solve_surfaces_its_groups_failure(monkeypatch):
    g = mesh2d(9, 9, seed=32)
    svc = SolverService(device="cpu", alpha=0.05)

    def explode(graph, key=None, pipeline=None):
        raise RuntimeError("no artifacts for you")

    monkeypatch.setattr(svc, "artifacts", explode)
    with pytest.raises(RuntimeError, match="no artifacts"):
        svc.solve(g, _rhs(g, seed=33)[:, 0])


def test_mixed_config_flush_groups_and_matches_single_config_services():
    g = mesh2d(12, 12, seed=16)
    pd = pdgrass_config(alpha=0.05, chunk=128)
    fe = fegrass_config(alpha=0.05, chunk=128)
    b = _rhs(g, k=2, seed=17)
    svc = SolverService(device="cpu", pipeline=pd)
    h = svc.register(g)
    assert svc._key(h, pd) != svc._key(h, fe)   # distinct cache keys

    t_pd = svc.submit(SolveRequest(graph=h, b=b[:, 0]))
    t_fe = svc.submit(SolveRequest(graph=h, b=b[:, 1], pipeline=fe))
    out = svc.flush()
    # two (graph, config) groups: both built this flush, separately
    assert svc.cache.stats["misses"] == 2
    assert svc.stats()["scheduler"]["groups"] == 2
    assert out[t_pd].config != out[t_fe].config
    assert out[t_pd].converged and out[t_fe].converged

    # equivalence: each request got the same answer a dedicated
    # single-config service produces
    r_pd = SolverService(device="cpu", pipeline=pd).solve(g, b[:, 0])
    r_fe = SolverService(device="cpu", pipeline=fe).solve(g, b[:, 1])
    np.testing.assert_allclose(_rebase(out[t_pd].x), _rebase(r_pd.x),
                               atol=1e-8)
    np.testing.assert_allclose(_rebase(out[t_fe].x), _rebase(r_fe.x),
                               atol=1e-8)
    np.testing.assert_array_equal(out[t_pd].iters, r_pd.iters)
    np.testing.assert_array_equal(out[t_fe].iters, r_fe.iters)

    # repeat flush: 100% artifact cache hit, zero re-fingerprinting
    before = cache_mod.HASH_EVENTS
    t3 = svc.submit(SolveRequest(graph=h, b=b[:, 0]))
    t4 = svc.submit(SolveRequest(graph=h, b=b[:, 1], pipeline=fe))
    out2 = svc.flush()
    assert out2[t3].cache == "mem" and out2[t4].cache == "mem"
    assert svc.cache.stats["misses"] == 2       # nothing rebuilt
    assert cache_mod.HASH_EVENTS == before
    counts = svc.stats()["solves_by_config"]
    assert counts == {pd.digest(): 2, fe.digest(): 2}


def test_warmup_prefetches_artifacts_for_each_config():
    g = mesh2d(10, 10, seed=18)
    pd = pdgrass_config(alpha=0.05, chunk=128)
    fe = fegrass_config(alpha=0.05, chunk=128)
    svc = SolverService(device="cpu", pipeline=pd)
    h = svc.register(g)
    sources = svc.warmup(h, configs=[pd, fe])
    assert sources == {pd.digest(): "miss", fe.digest(): "miss"}
    # traffic after warmup only ever hits memory
    b = _rhs(g, k=2, seed=19)
    t1 = svc.submit(SolveRequest(graph=h, b=b[:, 0]))
    t2 = svc.submit(SolveRequest(graph=h, b=b[:, 1], pipeline=fe))
    out = svc.flush()
    assert out[t1].cache == "mem" and out[t2].cache == "mem"
    assert svc.warmup(h, configs=[fe]) == {fe.digest(): "mem"}


def test_config_digest_is_stable_and_discriminating():
    pd, fe = pdgrass_config(alpha=0.05), fegrass_config(alpha=0.05)
    assert pd.digest() == pdgrass_config(alpha=0.05).digest()
    assert pd.digest() != fe.digest()
    assert pd.digest() != pdgrass_config(alpha=0.06).digest()
    assert len(pd.digest()) == 12


def test_padded_batch_columns_are_inert_by_construction():
    """Padding columns carry tol=inf / maxiter=0, so they can never drive
    the batched PCG loop (0 iterations from the start) nor the refinement
    pass — independent of the zero-RHS short-circuit.  Previously pads
    inherited the group's *strictest* tol and *largest* maxiter, which was
    only benign by accident."""
    g = mesh2d(9, 9, seed=40)
    svc = SolverService(device="cpu", alpha=0.05, precond="none")
    h = svc.register(g)
    inner = {}
    real_solver_for = svc._solver_for

    def spying(key, artifacts):
        fn = real_solver_for(key, artifacts)

        def spy(b, tol=1e-5, maxiter=2000):
            res = fn(b, tol=tol, maxiter=maxiter)
            # capture the FIRST (main) solve call; refinement passes reuse
            # the closure with per-column remaining budgets
            inner.setdefault("tol", np.asarray(tol))
            inner.setdefault("maxiter", np.asarray(maxiter))
            inner.setdefault("iters", np.asarray(res.iters))
            return res

        return spy

    svc._solver_for = spying
    b = _rhs(g, k=3, seed=41)
    # three 1-column requests with distinct contracts -> k=3, k_pad=4
    tickets = [svc.submit(SolveRequest(graph=h, b=b[:, j], tol=t, maxiter=m))
               for j, (t, m) in enumerate([(1e-5, 2000), (1e-3, 50),
                                           (1e-6, 3000)])]
    out = svc.flush()
    assert all(out[t].converged for t in tickets)
    # the real columns kept their own contracts ...
    assert np.allclose(inner["tol"][:3],
                       np.maximum([1e-5, 1e-3, 1e-6], 1e-5))
    assert list(inner["maxiter"][:3]) == [2000, 50, 3000]
    # ... and the padding column is inert: tol=inf, maxiter=0, 0 iterations
    assert np.isinf(inner["tol"][3])
    assert inner["maxiter"][3] == 0
    assert inner["iters"][3] == 0


def _disk_keys(path):
    return sorted(f[:-len(".pkl")] for f in os.listdir(path)
                  if f.endswith(".pkl"))


def test_mem_lru_eviction_order_is_recency_not_insertion():
    cache = LRUCache(capacity=2)
    cache.put("a", 1)
    cache.put("b", 2)
    assert cache.get("a") == (1, "mem")     # refresh a's recency
    cache.put("c", 3)                       # evicts b, the LRU entry
    assert cache.get("b") == (None, "miss")
    assert cache.get("a") == (1, "mem") and cache.get("c") == (3, "mem")
    assert cache.evictions == 1


def test_disk_round_trip_and_atomic_writes(tmp_path):
    cache = LRUCache(capacity=1, disk_dir=str(tmp_path))
    payload = {"idx": np.arange(5), "val": np.ones(3)}
    cache.put("k0", payload)
    cache.put("k1", 1)                      # k0 falls out of memory
    got, src = cache.get("k0")
    assert src == "disk"
    np.testing.assert_array_equal(got["idx"], payload["idx"])
    # atomic-write path: only whole pickles in the dir, never .tmp litter
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    # a torn concurrent write (leftover tmp) is invisible to the cache
    (tmp_path / "torn.tmp").write_bytes(b"\x80garbage")
    fresh = LRUCache(capacity=1, disk_dir=str(tmp_path))
    assert fresh.get("k1") == (1, "disk")
    assert "disk_entries" in fresh.stats and fresh.stats["disk_entries"] == 2
    # a torn/concurrently-evicted pickle reads as a miss, never a crash
    (tmp_path / "torn2.pkl").write_bytes(b"\x80garbage")
    assert fresh.get("torn2") == (None, "miss")


def test_disk_tier_caps_entries_with_oldest_mtime_eviction(tmp_path):
    cache = LRUCache(capacity=8, disk_dir=str(tmp_path), disk_max_entries=2)
    cache.put("k0", 0)
    cache.put("k1", 1)
    # deterministic ages regardless of filesystem timestamp resolution
    os.utime(tmp_path / "k0.pkl", (100, 100))
    os.utime(tmp_path / "k1.pkl", (200, 200))
    cache.put("k2", 2)                      # over cap: k0 (oldest) evicted
    assert _disk_keys(tmp_path) == ["k1", "k2"]
    assert cache.disk_evictions == 1
    stats = cache.stats
    assert stats["disk_entries"] == 2 and stats["disk_max_entries"] == 2


def test_disk_hit_refreshes_recency_for_eviction(tmp_path):
    cache = LRUCache(capacity=1, disk_dir=str(tmp_path), disk_max_entries=2)
    cache.put("k0", 0)
    cache.put("k1", 1)
    os.utime(tmp_path / "k0.pkl", (100, 100))
    os.utime(tmp_path / "k1.pkl", (200, 200))
    assert cache.get("k0")[1] == "disk"     # refreshes k0's mtime to now
    cache.put("k2", 2)                      # k1 is now the oldest: evicted
    assert _disk_keys(tmp_path) == ["k0", "k2"]


def test_disk_tier_caps_bytes_but_never_evicts_fresh_write(tmp_path):
    cache = LRUCache(capacity=8, disk_dir=str(tmp_path), disk_max_bytes=1)
    big = np.zeros(1024)
    cache.put("k0", big)                    # alone over the cap: kept
    assert _disk_keys(tmp_path) == ["k0"]
    os.utime(tmp_path / "k0.pkl", (100, 100))
    cache.put("k1", big)                    # k0 evicted, k1 (fresh) kept
    assert _disk_keys(tmp_path) == ["k1"]
    assert cache.stats["disk_bytes"] > 0


def test_service_surfaces_disk_caps_in_stats(tmp_path):
    g = mesh2d(8, 8, seed=20)
    svc = SolverService(device="cpu",
                        alpha=0.05, precond="none", disk_dir=str(tmp_path),
                        disk_max_entries=4)
    svc.solve(g, _rhs(g, seed=21)[:, 0])
    stats = svc.stats()
    assert stats["cache"]["disk_max_entries"] == 4
    assert stats["cache"]["disk_entries"] == 1


def test_stale_ticket_result_raises_clear_error_without_flushing_others():
    """Regression: ``result()`` on an unresolved ticket that is NOT in its
    service's pending queue used to flush anyway — pointlessly solving
    unrelated pending work and then failing with a baffling "was it
    submitted to this service?" message.  It must diagnose the stale
    ticket immediately and leave other queued work untouched."""
    g = mesh2d(9, 9, seed=20)
    svc = SolverService(device="cpu", alpha=0.05, precond="none")
    h = svc.register(g)
    b = _rhs(g, k=2, seed=21)
    stale = svc.submit(SolveRequest(graph=h, b=b[:, 0]))
    # Simulate the race the bug shipped under: the queue drained without
    # this ticket ever resolving (a consumer dropped its entry).
    with svc._lock:
        svc._pending.clear()
        svc._pending_columns = 0
    live = svc.submit(SolveRequest(graph=h, b=b[:, 1]))
    flushes = svc.stats()["scheduler"]["flushes"]
    with pytest.raises(RuntimeError, match="stale .*or belongs to another"):
        stale.result()
    assert not stale.done()
    # the diagnosis came WITHOUT flushing the unrelated live ticket
    assert svc.stats()["scheduler"]["flushes"] == flushes
    assert not live.done()
    assert live.result().converged          # the live path is unharmed


def test_register_persists_npz_atomically(tmp_path):
    d = _store_dir(tmp_path)
    store = GraphStore(persist_dir=d)
    g = grid2d(5, 5, seed=0)
    h = store.register(g)
    files = os.listdir(d)
    assert files == [f"{h.fingerprint}.npz"]
    assert not [f for f in files if f.endswith(".tmp")]
    # idempotent: re-registering (object or structural copy) writes nothing
    store.register(g)
    store.register(build_graph(g.n, g.src.copy(), g.dst.copy(),
                               g.weight.copy()))
    assert store.stats["persisted"] == 1
    assert len(os.listdir(d)) == 1


def test_rehydration_restores_handles_without_rehashing(tmp_path):
    d = _store_dir(tmp_path)
    g = grid2d(6, 6, seed=1)
    h = GraphStore(persist_dir=d).register(g)

    before = cache_mod.HASH_EVENTS
    store2 = GraphStore(persist_dir=d)
    assert cache_mod.HASH_EVENTS == before    # adopted digest, no O(m) hash
    assert store2.stats["rehydrated"] == 1
    h2 = store2.get(h.fingerprint)
    assert h2 is not None and h2.fingerprint == h.fingerprint
    g2 = h2.graph
    assert g2.n == g.n
    np.testing.assert_array_equal(g2.src, g.src)
    np.testing.assert_array_equal(g2.dst, g.dst)
    np.testing.assert_array_equal(g2.weight, g.weight)
    # rehydrated arrays are frozen exactly like fingerprinted ones
    for arr in (g2.src, g2.dst, g2.weight):
        assert not arr.flags.writeable
    assert [hh.fingerprint for hh in store2.handles()] == [h.fingerprint]
    # and the handle is live: registering the same content dedups onto it
    assert store2.register(g) is h2


def test_corrupt_and_foreign_files_skipped(tmp_path):
    d = _store_dir(tmp_path)
    store = GraphStore(persist_dir=d)
    h = store.register(grid2d(4, 4, seed=2))
    # torn write
    with open(os.path.join(d, "deadbeef" * 8 + ".npz"), "wb") as f:
        f.write(b"not an npz")
    # digest/filename mismatch (e.g. a renamed file)
    real = os.path.join(d, f"{h.fingerprint}.npz")
    with open(real, "rb") as f:
        blob = f.read()
    with open(os.path.join(d, "0" * len(h.fingerprint) + ".npz"), "wb") as f:
        f.write(blob)
    store2 = GraphStore(persist_dir=d)
    assert store2.stats["rehydrated"] == 1    # only the genuine artifact
    assert store2.get(h.fingerprint) is not None


def test_service_restart_round_trip(tmp_path):
    """register -> kill -> restart -> solve hits the disk artifact cache
    with zero new content hashes: the persisted store + persisted artifact
    tier together make restarts warm."""
    disk = str(tmp_path / "cache")
    g = grid2d(6, 6, seed=3)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(g.n).astype(np.float32)

    svc1 = SolverService(device="cpu", alpha=0.1, disk_dir=disk)
    h1 = svc1.register(g)
    assert svc1.solve(h1, b).converged        # builds + persists artifacts
    assert svc1.store.stats["persisted"] == 1
    del svc1

    svc2 = SolverService(device="cpu",
                         alpha=0.1, disk_dir=disk)   # the "restart"
    assert svc2.store.stats["rehydrated"] == 1
    h2 = svc2.store.get(h1.fingerprint)
    assert h2 is not None
    before = cache_mod.HASH_EVENTS
    sources = svc2.warmup(h2)
    assert list(sources.values()) == ["disk"]  # artifacts straight from disk
    res = svc2.solve(h2, b)
    assert res.converged
    assert cache_mod.HASH_EVENTS == before     # no re-fingerprinting anywhere
    assert svc2.stats()["store"]["rehydrated"] == 1


def test_store_without_persist_dir_unchanged(tmp_path):
    store = GraphStore()
    h = store.register(grid2d(4, 4, seed=4))
    assert "persisted" not in store.stats
    assert store.get(h.fingerprint) is h
    # a service without disk_dir gets an in-memory store
    svc = SolverService(device="cpu", alpha=0.1)
    assert svc.store.persist_dir is None


def test_persist_failure_leaves_no_tmp(tmp_path, monkeypatch):
    d = _store_dir(tmp_path)
    store = GraphStore(persist_dir=d)

    def boom(*a, **k):
        raise OSError("disk full")

    import repro_torch.solver.requests as req_mod
    monkeypatch.setattr(req_mod.np, "savez", boom)
    with pytest.raises(OSError, match="disk full"):
        store.register(grid2d(4, 4, seed=5))
    assert [f for f in os.listdir(d) if f.endswith(".tmp")] == []


def test_gc_max_entries_evicts_oldest(tmp_path):
    d = _store_dir(tmp_path)
    store = GraphStore(persist_dir=d, max_entries=2)
    handles = []
    for i, g in enumerate(_graphs(5)):
        os.utime(d, None)
        handles.append(store.register(g))
        # deterministic mtime ordering without sleeping
        os.utime(os.path.join(d, f"{handles[-1].fingerprint}.npz"),
                 (i, i))
    store.register(grid2d(12, 4, seed=99))          # triggers final prune
    files = {f for f in os.listdir(d) if f.endswith(".npz")}
    assert len(files) == 2
    # newest mtimes survive; the file just written is among them
    st = store.stats
    assert st["persist_entries"] == 2
    assert st["persist_evictions"] == 4             # 6 persisted, 2 kept
    assert st["max_entries"] == 2 and st["max_bytes"] is None
    # live handles are untouched by disk eviction
    for h in handles:
        assert store.get(h.fingerprint) is h


def test_gc_max_bytes_and_oversized_single_graph(tmp_path):
    d = _store_dir(tmp_path)
    store = GraphStore(persist_dir=d, max_bytes=1)   # everything is over
    h = store.register(grid2d(6, 6, seed=20))
    # the just-written file is never the victim: it stays despite the cap
    assert os.path.exists(os.path.join(d, f"{h.fingerprint}.npz"))
    assert store.stats["persist_evictions"] == 0
    # the next register evicts the old one but keeps the new one
    h2 = store.register(grid2d(7, 7, seed=21))
    files = {f for f in os.listdir(d) if f.endswith(".npz")}
    assert files == {f"{h2.fingerprint}.npz"}
    assert store.stats["persist_evictions"] == 1


def test_gc_reregister_refreshes_recency(tmp_path):
    d = _store_dir(tmp_path)
    store = GraphStore(persist_dir=d, max_entries=2)
    g_old, g_mid = grid2d(5, 5, seed=30), grid2d(6, 5, seed=31)
    h_old = store.register(g_old)
    h_mid = store.register(g_mid)
    os.utime(os.path.join(d, f"{h_old.fingerprint}.npz"), (1, 1))
    os.utime(os.path.join(d, f"{h_mid.fingerprint}.npz"), (2, 2))
    store.register(g_old)                            # touch -> now newest
    h_new = store.register(grid2d(7, 5, seed=32))    # prune runs
    files = {f for f in os.listdir(d) if f.endswith(".npz")}
    assert files == {f"{h_old.fingerprint}.npz", f"{h_new.fingerprint}.npz"}


def test_gc_service_caps_and_store_conflict(tmp_path):
    disk = str(tmp_path / "cache")
    svc = SolverService(device="cpu",
                        alpha=0.1, disk_dir=disk, store_max_entries=1)
    svc.register(grid2d(4, 4, seed=40))
    svc.register(grid2d(5, 4, seed=41))
    st = svc.stats()["store"]
    assert st["persist_entries"] == 1
    assert st["persist_evictions"] == 1
    with pytest.raises(ValueError, match="set the caps on it"):
        SolverService(device="cpu",
                      alpha=0.1, store=GraphStore(), store_max_entries=3)


def test_cache_hit_returns_identical_object_without_recompute():
    g = mesh2d(10, 10, seed=13)
    calls = []

    def build():
        calls.append(1)
        return ell_laplacian(g, device="cpu")

    cache = LRUCache(capacity=4)
    key = graph_fingerprint(g, extra=("alpha", 0.05))
    v1, s1 = cache.get_or_build(key, build)
    v2, s2 = cache.get_or_build(key, build)
    assert (s1, s2) == ("miss", "mem")
    assert len(calls) == 1
    assert v1 is v2  # the very same object, no rebuild


def test_fingerprint_distinguishes_graphs_and_params():
    g1 = mesh2d(10, 10, seed=13)
    g2 = mesh2d(10, 10, seed=14)
    assert graph_fingerprint(g1) == graph_fingerprint(g1)
    assert graph_fingerprint(g1) != graph_fingerprint(g2)
    assert graph_fingerprint(g1, ("a", 0.05)) != graph_fingerprint(g1, ("a", 0.1))


def test_cache_lru_eviction_and_disk_tier(tmp_path):
    cache = LRUCache(capacity=2, disk_dir=str(tmp_path))
    for i in range(3):
        cache.put(f"k{i}", i)
    assert len(cache) == 2 and cache.evictions == 1
    # k0 fell out of memory but survives on disk
    v, src = cache.get("k0")
    assert (v, src) == (0, "disk")
    # a fresh cache (new process) hits the disk tier
    v, src = LRUCache(capacity=2, disk_dir=str(tmp_path)).get("k2")
    assert (v, src) == (2, "disk")


def test_service_cache_hit_skips_pipeline(tmp_path):
    g = mesh2d(12, 12, seed=15)
    svc = SolverService(device="cpu", alpha=0.05, disk_dir=str(tmp_path))
    b = _rhs(g, k=1, seed=16)[:, 0]
    r1 = svc.solve(g, b)
    r2 = svc.solve(g, b)
    assert (r1.cache, r2.cache) == ("miss", "mem")
    assert svc.cache.stats["misses"] == 1 and svc.cache.stats["hits"] == 1
    np.testing.assert_array_equal(r1.x, r2.x)  # same artifacts, same answer
    # a new service instance warm-starts from disk
    r3 = SolverService(device="cpu",
                       alpha=0.05, disk_dir=str(tmp_path)).solve(g, b)
    assert r3.cache == "disk"
    np.testing.assert_allclose(_rebase(r3.x), _rebase(r1.x), atol=1e-4)


def test_service_solution_matches_host_pcg():
    g = mesh2d(14, 14, seed=17)
    b = _rhs(g, k=1, seed=18)[:, 0]
    svc = SolverService(device="cpu", alpha=0.05)
    res = svc.solve(g, b, tol=1e-5)
    assert res.converged
    assert float(res.relres.max()) <= 1e-5
    host = pcg_host(g.laplacian(), b.astype(np.float64), tol=1e-5,
                    maxiter=5000)
    scale = max(np.abs(host.x).max(), 1.0)
    np.testing.assert_allclose(_rebase(res.x), _rebase(host.x),
                               atol=2e-3 * scale)


def test_service_flush_groups_requests_into_one_batch():
    g = mesh2d(12, 12, seed=19)
    svc = SolverService(device="cpu", alpha=0.05)
    b1 = _rhs(g, k=1, seed=20)[:, 0]
    b2 = _rhs(g, k=3, seed=21)
    t1 = svc.submit(SolveRequest(graph=g, b=b1))
    t2 = svc.submit(SolveRequest(graph=g, b=b2))
    out = svc.flush()
    assert out[t1].x.shape == (g.n,)
    assert out[t2].x.shape == (g.n, 3)
    assert out[t1].converged and out[t2].converged
    # both tickets were served by the same artifact build (one group)
    assert svc.cache.stats["misses"] == 1
    single = svc.solve(g, b2[:, 1])
    np.testing.assert_allclose(_rebase(out[t2].x[:, 1]), _rebase(single.x),
                               atol=1e-3)


def test_request_batched_with_others_solves_as_it_does_alone():
    """A request's x, iterations and f64 relres do not depend on the width
    of the batch it rides in (the service centres and measures each column
    on its own), so the daemon's batches answer as the sync path does."""
    g = mesh2d(16, 16, seed=4)
    svc = SolverService(device="cpu", alpha=0.05)
    rng = np.random.default_rng(8)
    bs = [rng.standard_normal(g.n).astype(np.float32) + 3.0
          for _ in range(6)]
    tickets = [svc.submit(SolveRequest(graph=g, b=b, tol=1e-4)) for b in bs]
    svc.flush()
    for t, b in zip(tickets, bs):
        alone = svc.solve(g, b, tol=1e-4)
        batched = t.result()
        np.testing.assert_array_equal(batched.x, alone.x)
        np.testing.assert_array_equal(batched.iters, alone.iters)
        np.testing.assert_array_equal(batched.relres, alone.relres)


def test_solve_does_not_drain_submitted_tickets():
    g = mesh2d(10, 10, seed=24)
    svc = SolverService(device="cpu", alpha=0.05)
    b = _rhs(g, k=2, seed=25)
    ticket = svc.submit(SolveRequest(graph=g, b=b[:, 0]))
    direct = svc.solve(g, b[:, 1])       # must not consume the queue
    assert direct.converged
    out = svc.flush()
    assert ticket in out and out[ticket].converged
    np.testing.assert_allclose(
        _rebase(out[ticket].x),
        _rebase(svc.solve(g, b[:, 0]).x), atol=1e-3)


def test_mixed_tolerances_keep_their_own_contracts():
    g = mesh2d(10, 10, seed=26)
    svc = SolverService(device="cpu", alpha=0.05)
    b = _rhs(g, k=2, seed=27)
    loose = svc.submit(SolveRequest(graph=g, b=b[:, 0], tol=1e-2))
    strict = svc.submit(SolveRequest(graph=g, b=b[:, 1], tol=1e-5))
    out = svc.flush()
    assert out[loose].converged and float(out[loose].relres.max()) <= 1e-2
    assert out[strict].converged and float(out[strict].relres.max()) <= 1e-5


def test_mixed_maxiter_budgets_are_honored_per_request():
    g = mesh2d(10, 10, seed=31)
    svc = SolverService(device="cpu", alpha=0.05, precond="none")
    b = _rhs(g, k=2, seed=32)
    small = svc.submit(SolveRequest(graph=g, b=b[:, 0], maxiter=5))
    large = svc.submit(SolveRequest(graph=g, b=b[:, 1], maxiter=5000))
    out = svc.flush()
    assert int(out[small].iters.max()) <= 5 and not out[small].converged
    assert out[large].converged


def test_service_rejects_mismatched_rhs():
    g = grid2d(6, 6, seed=28)
    svc = SolverService(device="cpu", alpha=0.05)
    with pytest.raises(ValueError, match="does not match graph"):
        svc.solve(g, np.ones(g.n + 1, np.float32))


def test_solver_closures_bounded_by_cache_capacity():
    svc = SolverService(device="cpu",
                        alpha=0.05, precond="none", cache_capacity=2)
    rng = np.random.default_rng(29)
    for s in range(4):
        g = grid2d(6, 6, seed=s)
        b = rng.standard_normal(g.n).astype(np.float32)
        assert svc.solve(g, b - b.mean()).converged
    assert len(svc._solvers) <= 2


def test_residual_csr_is_kept_per_graph_and_bounded():
    """The refinement's CSR operands are made once a graph, whatever the
    config, and held to the closures' capacity."""
    svc = SolverService(device="cpu",
                        alpha=0.05, precond="none", cache_capacity=2)
    rng = np.random.default_rng(30)
    g = grid2d(6, 6, seed=0)
    b = rng.standard_normal(g.n).astype(np.float32)
    for config in (None, fegrass_config(alpha=0.05)):
        assert svc.solve(g, b, pipeline=config).converged
    assert len(svc._solvers) == 2 and len(svc._csrs) == 1
    indptr, adj, adj_w = next(iter(svc._csrs.values()))
    assert (indptr.dtype, adj.dtype, adj_w.dtype) == (
        torch.int32, torch.int32, torch.float32)
    assert np.array_equal(adj_w.numpy(), g.adj_w)
    for s in range(1, 4):
        g = grid2d(6, 6, seed=s)
        assert svc.solve(g, rng.standard_normal(g.n).astype(
            np.float32)).converged
    assert len(svc._csrs) == 2


def test_batched_pcg_handles_zero_columns():
    g = grid2d(8, 8, seed=22)
    idx, val = ell_laplacian(g, device="cpu")
    B = np.zeros((g.n, 2), np.float32)
    B[:, 0] = _rhs(g, k=1, seed=23)[:, 0]
    mv = make_matvec(idx, val, "ref")
    res = batched_pcg(mv, torch.as_tensor(B), tol=1e-5, maxiter=2000)
    assert bool(np.asarray(res.converged).all())
    assert int(np.asarray(res.iters)[1]) == 0  # zero RHS converges instantly


# -- parity with the reference's service -------------------------------------

def _flush_mixed(svc, req_cls, fe, g, b):
    """One flush of a pdGRASS request (1 column) and a feGRASS request (2
    columns) on ``g``: returns ``[(cache, x, iters, relres)]`` per ticket."""
    h = svc.register(g)
    t_pd = svc.submit(req_cls(graph=h, b=b[:, 0], tol=1e-5))
    t_fe = svc.submit(req_cls(graph=h, b=b[:, 1:], tol=1e-5, pipeline=fe))
    out = svc.flush()
    return [(out[t].cache, np.asarray(out[t].x), np.asarray(out[t].iters),
             np.asarray(out[t].relres)) for t in (t_pd, t_fe)]


@pytest.mark.parametrize("rows,seed", [(12, 16), (10, 3)])
def test_service_parity_with_reference(rows, seed):
    """The same graph and right-hand sides through both services, twice:
    +-2 iterations, re-based x rtol 1e-3, relres <= tol, the same cache
    sources (miss, then mem) and the same content fingerprint."""
    jg, tg = jgraph.mesh2d(rows, rows, seed=seed), mesh2d(rows, rows,
                                                          seed=seed)
    b = _rhs(tg, k=3, seed=seed + 1)
    jsvc = JSolverService(pipeline=jpdgrass_config(alpha=0.05, chunk=128))
    tsvc = SolverService(device="cpu",
                         pipeline=pdgrass_config(alpha=0.05, chunk=128))
    assert tsvc.register(tg).fingerprint == jsvc.register(jg).fingerprint
    for expect in ("miss", "mem"):
        want = _flush_mixed(jsvc, JSolveRequest,
                            jfegrass_config(alpha=0.05, chunk=128), jg, b)
        got = _flush_mixed(tsvc, SolveRequest,
                           fegrass_config(alpha=0.05, chunk=128), tg, b)
        for (tc, tx, ti, tr), (jc, jx, ji, jr) in zip(got, want):
            assert tc == jc == expect
            assert np.all(np.abs(ti.astype(int) - ji.astype(int)) <= 2)
            assert np.all(tr <= 1e-5)
            np.testing.assert_allclose(_rebase(tx), _rebase(jx), rtol=1e-3,
                                       atol=1e-3 * np.abs(_rebase(jx)).max())


def test_content_fingerprint_is_the_reference_string():
    for rows, seed in ((8, 1), (9, 4)):
        tg, jg = grid2d(rows, rows, seed=seed), jgraph.grid2d(rows, rows,
                                                              seed=seed)
        assert (cache_mod.content_fingerprint(tg)
                == jcache.content_fingerprint(jg))
        assert (cache_mod.graph_fingerprint(tg, ("a", 1))
                == jcache.graph_fingerprint(jg, ("a", 1)))


def test_artifact_keys_never_alias_the_reference():
    """One graph, one config: the key function hashes alike in both
    packages, but the services' keys differ (the port's schema tag)."""
    tg, jg = mesh2d(8, 8, seed=2), jgraph.mesh2d(8, 8, seed=2)
    tcfg, jcfg = pdgrass_config(alpha=0.05), jpdgrass_config(alpha=0.05)
    fp = cache_mod.content_fingerprint(tg)
    assert (cache_mod.artifact_key(fp, tcfg, ("x",))
            == jcache.artifact_key(fp, jcfg, ("x",)))
    for impl in ("ref", "fused", "kernel"):
        tsvc = SolverService(device="cpu", pipeline=tcfg, matvec_impl=impl)
        jsvc = JSolverService(pipeline=jcfg, matvec_impl=impl)
        assert tsvc._key(tsvc.register(tg), tcfg) != jsvc._key(
            jsvc.register(jg), jcfg)


def test_shared_disk_dir_never_aliases_the_reference(tmp_path):
    """A disk tier written by the reference: the port misses its
    artifacts (another schema) but adopts its persisted graph store (the
    same npz layout and digest), and then hits its own artifacts."""
    disk = str(tmp_path / "cache")
    jg, tg = jgraph.grid2d(6, 6, seed=3), grid2d(6, 6, seed=3)
    b = _rhs(tg, seed=4)[:, 0]
    assert JSolverService(alpha=0.1, disk_dir=disk).solve(jg, b).converged
    svc = SolverService(device="cpu", alpha=0.1, disk_dir=disk)
    assert svc.store.stats["rehydrated"] == 1
    h = svc.store.get(cache_mod.content_fingerprint(tg))
    assert h is not None
    assert svc.solve(h, b).cache == "miss"
    again = SolverService(device="cpu", alpha=0.1, disk_dir=disk)
    assert again.solve(h, b).cache == "disk"


def _tensors(obj):
    if torch.is_tensor(obj):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            yield from _tensors(x)
    elif isinstance(obj, dict):
        for x in obj.values():
            yield from _tensors(x)
    elif hasattr(obj, "__dataclass_fields__"):
        for name in obj.__dataclass_fields__:
            yield from _tensors(getattr(obj, name))


def test_disk_artifacts_hold_cpu_tensors_and_load_onto_the_device(tmp_path):
    g = mesh2d(9, 9, seed=5)
    svc = SolverService(device="cpu", alpha=0.05, disk_dir=str(tmp_path))
    svc.solve(g, _rhs(g, seed=6)[:, 0])
    (pkl,) = [f for f in os.listdir(tmp_path) if f.endswith(".pkl")]
    with open(tmp_path / pkl, "rb") as f:
        stored = pickle.load(f)
    tensors = list(_tensors(stored))
    assert len(tensors) > 8 and all(t.device.type == "cpu" for t in tensors)
    value, source = LRUCache(disk_dir=str(tmp_path), device="cpu").get(
        pkl[:-4])
    assert source == "disk"
    assert all(torch.equal(a, b) for a, b in zip(_tensors(value), tensors))


def _raise_on_load():
    raise RuntimeError("a storage this process cannot restore")


class _Unloadable:
    def __reduce__(self):
        return (_raise_on_load, ())


def test_artifact_that_cannot_be_loaded_is_a_miss(tmp_path):
    """torch raises RuntimeError for a storage it cannot restore (a CUDA
    tensor unpickled without CUDA): a miss, as a torn file is."""
    (tmp_path / "k0.pkl").write_bytes(pickle.dumps(_Unloadable()))
    cache = LRUCache(disk_dir=str(tmp_path))
    assert cache.get("k0") == (None, "miss")
    value, source = cache.get_or_build("k0", lambda: 7)
    assert (value, source) == (7, "miss")
    assert LRUCache(disk_dir=str(tmp_path)).get("k0") == (7, "disk")


def test_every_matvec_route_gives_the_same_bits():
    """On the CPU every route runs the plain versions: the fused, kernel
    and ref services return the same x and iterations, bitwise."""
    g = mesh2d(11, 11, seed=7)
    b = _rhs(g, k=2, seed=8)
    outs = [SolverService(device="cpu", alpha=0.05, matvec_impl=impl)
            .solve(g, b) for impl in ("fused", "kernel", "ref")]
    for r in outs[1:]:
        np.testing.assert_array_equal(r.x, outs[0].x)
        np.testing.assert_array_equal(r.iters, outs[0].iters)
    assert outs[0].converged


def test_service_defaults_to_cuda_and_rejects_the_sharded_plane():
    params = inspect.signature(SolverService).parameters
    assert params["device"].default == "cuda"
    assert "interpret" not in params and "tile_n" not in params
    svc = SolverService(device="cpu", alpha=0.05)
    assert svc.matvec_impl == "ref"
    assert svc.stats()["hierarchy"]["device"] == "cpu"
    # the sharded plane is ported; what is rejected is what the reference
    # rejects (end-to-end tests in tests/test_torch_sharded.py)
    mesh = make_mesh((8,), ("data",), device="cpu")
    assert SolverService(device="cpu", alpha=0.05,
                         mesh=mesh).contraction == "sharded"
    assert svc.stats()["mesh"]["descriptor"] is None
    with pytest.raises(ValueError, match="needs a mesh"):
        SolverService(device="cpu", alpha=0.05, contraction="sharded")
    with pytest.raises(NotImplementedError, match="jacobi"):
        SolverService(device="cpu", alpha=0.05, precond="jacobi", mesh=mesh)


def test_warmup_widths_books_each_bucket_once():
    g = mesh2d(9, 9, seed=9)
    svc = SolverService(device="cpu", alpha=0.05)
    h = svc.register(g)
    with pytest.raises(ValueError, match="widths"):
        svc.warmup(h, widths=[0])
    svc.warmup(h, widths=[1, 3])               # buckets 1 and 4
    metrics = svc.stats()["metrics"]
    booked = metrics["solver.warmup.compile_ms"]
    assert booked["count"] == 2 and booked["sum"] > 0
    assert metrics["solver.warmup.compiles"] == 2
    svc.warmup(h, widths=[4, 1])               # the same buckets again
    metrics = svc.stats()["metrics"]
    assert metrics["solver.warmup.compile_ms"] == booked
    assert metrics["solver.warmup.compiles"] == 2
    assert "timing" not in svc.stats()
