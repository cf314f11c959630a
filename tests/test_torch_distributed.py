"""The port's distributed recovery (repro_torch.core.distributed), its
sharded graph primitives and its mesh, held against the JAX package.

  * ``pad_fill_value``, ``partition_subtasks`` and ``build_outer_shards``
    equal to the reference's.
  * ``sharded_segment_argmax`` (with weight ties), ``sharded_matching``
    and ``sharded_coalesce_edges`` equal to their single-device
    counterparts, the port's and the reference's, at 1, 3 and 8 shards.
  * ``recover_mixed`` on an 8-shard CPU mesh bitwise equal to the
    reference's ``recover_serial`` on grid2d(15, 15), barabasi_albert(400,
    3) and star_hub(300, extra=250) with cutoff 50 (a giant subtask
    through the inner engine), and on integer scores.
  * The ``distributed`` pipeline engine's mask equal to the ``rounds``
    engine's without a target, and to the reference's engine.
Everything runs in one process on the CPU; inputs cross as numpy arrays.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import graph as jgraph  # noqa: E402
from repro.core import graph_ops as jops  # noqa: E402
from repro.core import distributed as jdist  # noqa: E402
from repro.core.recovery import recover_serial as jserial  # noqa: E402
from repro.pipeline import Pipeline as JPipeline  # noqa: E402
from repro.pipeline import pdgrass_config as jconfig  # noqa: E402
from repro_torch.core import collectives  # noqa: E402
from repro_torch.core import distributed as tdist  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.core import graph_ops as tops  # noqa: E402
from repro_torch.launch import make_mesh  # noqa: E402
from repro_torch.pipeline import Pipeline as TPipeline  # noqa: E402
from repro_torch.pipeline import pdgrass_config as tconfig  # noqa: E402

CHUNK = 256
CASES = {   # name -> (generator args, cutoff)
    "grid": (("grid2d", 15, 15), {"seed": 1}, None),
    "ba": (("barabasi_albert", 400, 3), {"seed": 3}, None),
    "star-giant": (("star_hub", 300), {"extra": 250, "seed": 5}, 50),
}
MESH8 = make_mesh((8,), ("data",), device="cpu")


def _graph(mod, name):
    (fn, *args), kw, _ = CASES[name]
    return getattr(mod, fn)(*args, **kw)


@pytest.fixture(scope="module")
def prepared():
    """name -> (reference Prepared, port Prepared) at chunk 256."""
    out = {}
    for name in CASES:
        jp = JPipeline(jconfig(chunk=CHUNK)).prepare(_graph(jgraph, name))
        tp = TPipeline(tconfig(chunk=CHUNK)).prepare(_graph(tgraph, name),
                                                     device="cpu")
        out[name] = (jp, tp)
    return out


def _int_scores(score):
    """Integer ranks of the scores: the order is kept, so the pre-sorted
    recovery order is unchanged."""
    return np.argsort(np.argsort(np.asarray(score))).astype(np.int32)


# -- mesh and collectives ------------------------------------------------------

def test_mesh_reads_like_the_reference():
    mesh = make_mesh((2, 4), ("pod", "data"), device="cpu")
    assert mesh.axis_names == ("pod", "data")
    assert mesh.shape["data"] == 4 and mesh.shape["pod"] == 2
    assert mesh.size == 8 and mesh.device == torch.device("cpu")
    with pytest.raises(TypeError):
        mesh.shape["data"] = 3
    with pytest.raises(ValueError, match="mesh across cards"):
        make_mesh((8,), ("data",), device=["cuda:0", "cuda:1"])
    assert make_mesh((8,), ("data",), device=["cpu", "cpu"]).size == 8
    with pytest.raises(ValueError, match="differ in length"):
        make_mesh((8,), ("data", "model"), device="cpu")


def test_collectives_reduce_in_shard_order():
    v = torch.tensor([[1e8, 1.0], [1.0, 2.0], [-1e8, 3.0]])
    # (1e8 + 1) rounds back to 1e8 in float32, so the order shows
    assert collectives.psum(v).tolist() == [0.0, 6.0]
    assert collectives.pmax(v).tolist() == [1e8, 3.0]
    assert collectives.pmin(v).tolist() == [-1e8, 1.0]
    assert collectives.all_gather(v, tiled=True).shape == (6,)
    assert collectives.all_gather(v).shape == (3, 2)


# -- host-side partitioning ----------------------------------------------------

@pytest.mark.parametrize("dtype", [
    "float16", "float32", "float64", "int8", "int16", "int32", "int64",
    "uint8", "uint16", "uint32", "bool"])
def test_pad_fill_value_matches_reference(dtype):
    for lowest in (False, True):
        try:
            want = jdist.pad_fill_value(np.dtype(dtype), lowest=lowest)
        except TypeError as exc:
            word = "unsigned" if "unsigned" in str(exc) else "no pad sentinel"
            with pytest.raises(TypeError, match=word):
                tdist.pad_fill_value(getattr(torch, dtype), lowest=lowest)
            continue
        got = tdist.pad_fill_value(getattr(torch, dtype), lowest=lowest)
        want = np.asarray(want).item()
        assert got == want and type(got) is type(want), (got, want)


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_partition_subtasks_matches_reference(prepared, n_shards):
    for name, (jp, tp) in prepared.items():
        np.testing.assert_array_equal(tp.subtask_sizes, jp.subtask_sizes)
        for cutoff in (None, CASES[name][2], 1, 10**9):
            got = tdist.partition_subtasks(tp.subtask_sizes, n_shards,
                                           cutoff=cutoff)
            want = jdist.partition_subtasks(jp.subtask_sizes, n_shards,
                                            cutoff=cutoff)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1] == want[1]
            np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("name", list(CASES) + ["int-scores"])
def test_build_outer_shards_matches_reference(prepared, name):
    jp, tp = prepared["grid" if name == "int-scores" else name]
    jprob, tprob = jp.problem, tp.problem
    if name == "int-scores":
        ranks = _int_scores(jprob.score)
        jprob = jprob._replace(score=ranks)
        tprob = tprob._replace(score=torch.as_tensor(ranks))
    for n_shards in (2, 8):
        shard_of, _, _ = jdist.partition_subtasks(jp.subtask_sizes, n_shards)
        want = jdist.build_outer_shards(jprob, jp.subtask_sizes, shard_of,
                                        n_shards, chunk=CHUNK)
        got = tdist.build_outer_shards(tprob, tp.subtask_sizes, shard_of,
                                       n_shards, chunk=CHUNK)
        for field in tdist.ShardedProblem._fields:
            w = np.asarray(getattr(want, field))
            g = getattr(got, field).numpy()
            # the reference's int64 src_row becomes int32 in JAX without x64
            assert g.dtype == w.dtype or field == "src_row", field
            np.testing.assert_array_equal(g, w, err_msg=field)


# -- sharded primitives against their single-device counterparts --------------

def _shard(x, n_sh, fill):
    """``[N]`` -> ``[n_sh, ceil(N / n_sh)]``, padded with ``fill``."""
    m_loc = max(1, -(-x.shape[0] // n_sh))
    pad = torch.full((m_loc * n_sh - x.shape[0],), fill, dtype=x.dtype)
    return torch.cat([x, pad]).view(n_sh, m_loc)


@pytest.mark.parametrize("n_sh", [1, 3, 8])
def test_sharded_segment_argmax_matches_single_device(n_sh):
    rng = np.random.default_rng(n_sh)
    N, S = 203, 37
    values = rng.integers(0, 4, N).astype(np.float32)    # many ties
    values[rng.random(N) < 0.1] = -np.inf
    segs = rng.integers(-1, S + 1, N).astype(np.int32)   # some out of range
    pick, best = tops.sharded_segment_argmax(
        _shard(torch.as_tensor(values), n_sh, -float("inf")),
        _shard(torch.as_tensor(segs), n_sh, -1), S,
        element_ids=_shard(torch.arange(N, dtype=torch.int32), n_sh, -1),
        sentinel=N)
    t_pick, t_best = tops.segment_argmax(torch.as_tensor(values),
                                         torch.as_tensor(segs), S)
    j_pick, j_best = jops.segment_argmax(values, segs, S)
    for want_pick, want_best in ((t_pick, t_best), (j_pick, j_best)):
        np.testing.assert_array_equal(pick.numpy(), np.asarray(want_pick))
        np.testing.assert_array_equal(best.numpy(), np.asarray(want_best))


def _edges(seed, n=120, m=400):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    keep = src != dst
    lo = np.minimum(src, dst)[keep].astype(np.int32)
    hi = np.maximum(src, dst)[keep].astype(np.int32)
    w = rng.integers(1, 5, lo.shape[0]).astype(np.float32)  # many ties
    return n, lo, hi, w


@pytest.mark.parametrize("n_sh", [1, 3, 8])
def test_sharded_matching_matches_single_device(n_sh):
    n, src, dst, w = _edges(n_sh)
    m = src.shape[0]
    mate = tops.sharded_matching(
        n, _shard(torch.as_tensor(src), n_sh, 0),
        _shard(torch.as_tensor(dst), n_sh, 0),
        _shard(torch.as_tensor(w), n_sh, 0.0),
        _shard(torch.arange(m, dtype=torch.int32), n_sh, -1))
    want = tops.propose_accept_matching(n, torch.as_tensor(src),
                                        torch.as_tensor(dst),
                                        torch.as_tensor(w))
    np.testing.assert_array_equal(mate.numpy(), want.numpy())
    np.testing.assert_array_equal(
        mate.numpy(), np.asarray(jops.propose_accept_matching(n, src, dst, w)))


@pytest.mark.parametrize("n_sh", [1, 3, 8])
def test_sharded_coalesce_matches_single_device(n_sh):
    n, src, dst, w = _edges(10 + n_sh)
    labels = np.random.default_rng(n_sh).integers(0, 30, n).astype(np.int32)
    got = tops.sharded_coalesce_edges(
        _shard(torch.as_tensor(src), n_sh, 0),
        _shard(torch.as_tensor(dst), n_sh, 0),
        _shard(torch.as_tensor(w), n_sh, 0.0), torch.as_tensor(labels), 30)
    mc = int(got[3])
    for want in (tops.coalesce_edges(torch.as_tensor(src),
                                     torch.as_tensor(dst), torch.as_tensor(w),
                                     torch.as_tensor(labels), 30),
                 jops.coalesce_edges(src, dst, w, labels, 30)):
        assert mc == int(want[3])
        for i in range(3):
            # integer weights: every order of summation gives the same bits
            np.testing.assert_array_equal(got[i][:mc].numpy(),
                                          np.asarray(want[i])[:mc])


# -- recovery ------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_recover_mixed_equals_reference_serial(prepared, name):
    jp, tp = prepared[name]
    cutoff = CASES[name][2]
    st = tdist.recover_mixed(tp, MESH8, chunk=CHUNK, cutoff=cutoff)
    assert st.dtype == torch.int8 and st.device.type == "cpu"
    np.testing.assert_array_equal(st.numpy(), jserial(jp.problem))
    _, giants, _ = tdist.partition_subtasks(tp.subtask_sizes, 8,
                                            cutoff=cutoff)
    if name == "star-giant":
        assert len(giants) >= 1     # the hub subtask took the inner engine


@pytest.mark.parametrize("n_shards", [1, 8])
def test_recover_mixed_on_integer_scores(prepared, n_shards):
    jp, tp = prepared["grid"]
    ranks = _int_scores(jp.problem.score)
    jprep = dataclasses.replace(jp, problem=jp.problem._replace(score=ranks))
    tprep = dataclasses.replace(
        tp, problem=tp.problem._replace(score=torch.as_tensor(ranks)))
    mesh = make_mesh((n_shards,), ("data",), device="cpu")
    st = tdist.recover_mixed(tprep, mesh, chunk=CHUNK)
    np.testing.assert_array_equal(st.numpy(), jserial(jprep.problem))


def test_inner_engine_alone_equals_serial(prepared):
    """cutoff=1 sends every subtask through the inner engine."""
    jp, tp = prepared["ba"]
    st = tdist.recover_mixed(tp, MESH8, chunk=CHUNK, cutoff=1)
    np.testing.assert_array_equal(st.numpy(), jserial(jp.problem))


def test_recover_mixed_needs_the_mesh_on_the_problems_device(prepared):
    _, tp = prepared["grid"]
    with pytest.raises(ValueError, match="mesh"):
        tdist.recover_mixed(tp, make_mesh((2,), ("data",), device="cuda"),
                            chunk=CHUNK)


def test_distributed_engine_matches_rounds_without_target():
    tg, jg = _graph(tgraph, "ba"), _graph(jgraph, "ba")
    kw = dict(alpha=0.05, chunk=CHUNK, stop_at_target=False)
    rounds = TPipeline(tconfig(**kw)).run(tg, device="cpu")
    dist = TPipeline(tconfig(engine="distributed", **kw)).run(
        tg, device="cpu", mesh=MESH8)
    assert dist.stats["n_shards"] == 8
    np.testing.assert_array_equal(dist.recovered_mask, rounds.recovered_mask)
    want = JPipeline(jconfig(engine="distributed", **kw)).run(jg)
    np.testing.assert_array_equal(dist.recovered_mask,
                                  np.asarray(want.recovered_mask))
