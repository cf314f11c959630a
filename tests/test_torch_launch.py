"""The port's launch tools for the paper's production job, held against the
JAX package on the CPU.

  * ``PdGrassConfig`` equal to the reference's, field by field.
  * ``make_production_mesh`` and ``make_mesh_for`` give the reference's
    shapes and axes (its ``compat_make_mesh`` call captured, so the
    reference needs no 256 host devices), ``n_devices`` 1-64 at several
    ``model_par``.
  * The collective counter counts one inner round's closed-form bytes and
    leaves every status bit as it was.
  * The dry run at a small config (mesh2d(45, 45)'s 3,872 off-tree rows
    padded to 2^12) to the end on 8 and 256 shards: status equal to the
    reference's ``recover_inner`` on a one-device JAX mesh and to
    ``recover_serial``; two rounds give one status at 1, 8 and 256
    shards; ``arg_gb`` by its formula and against XLA's
    ``argument_size_in_bytes`` of the reference's engine lowered at that
    shape.
  * The reference's dry run builds its engine without ``n_sh`` (ROADMAP
    queue 3): the partial it builds raises ``TypeError``.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import pdgrass_graph as jpdg  # noqa: E402
from repro.core import distributed as jdist  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro_torch.configs import pdgrass_graph as tpdg  # noqa: E402
from repro_torch.core import distributed as tdist  # noqa: E402
from repro_torch.core.collectives import (count_collectives,  # noqa: E402
                                          psum)
from repro_torch.core.graph import mesh2d  # noqa: E402
from repro_torch.core.recovery import RecoveryProblem  # noqa: E402
from repro_torch.core.recovery import recover_serial  # noqa: E402
from repro_torch.launch import dryrun_pdgrass as dry  # noqa: E402
from repro_torch.launch import make_mesh_for  # noqa: E402
from repro_torch.launch import make_production_mesh  # noqa: E402
from repro_torch.launch import roofline as roof  # noqa: E402

CFG, SIDE = dry.SMALL


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The dry runs issue tens of thousands of small ops, one set a shard
    and round: one intra-op thread keeps them from spinning against the
    other test workers' threads.  Restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def rows():
    return dry.production_rows(CFG, mesh2d(*SIDE, seed=0), device="cpu")


def _serial(rows):
    return recover_serial(RecoveryProblem(
        rows.sig_u, rows.sig_v, rows.beta, rows.seg,
        torch.zeros(rows.seg.shape)))


@pytest.fixture(scope="module")
def wanted(rows):
    """The serial oracle's status of the small rows, and the reference's
    ``recover_inner`` on a one-device JAX mesh."""
    mesh = jmesh.compat_make_mesh((1,), ("data",))
    st, _ = jdist.recover_inner(
        *(jnp.asarray(x.numpy()) for x in rows[:4]), mesh, axis="data",
        block_size=CFG.block_size, chunk=CFG.chunk)
    return _serial(rows), np.asarray(st)


# -- config and meshes ---------------------------------------------------------

def test_pdgrass_config_equals_reference():
    assert [f.name for f in dataclasses.fields(tpdg.PdGrassConfig)] == \
        [f.name for f in dataclasses.fields(jpdg.PdGrassConfig)]
    assert dataclasses.asdict(tpdg.CONFIG) == dataclasses.asdict(jpdg.CONFIG)
    assert (tpdg.CONFIG.n_vertices, tpdg.CONFIG.m_offtree, tpdg.CONFIG.c,
            tpdg.CONFIG.block_size, tpdg.CONFIG.chunk) == \
        (16_000_000, 2 ** 25, 8, 64, 4096)


def _captured(monkeypatch):
    calls = []
    monkeypatch.setattr(jmesh, "compat_make_mesh",
                        lambda shape, axes: calls.append((shape, axes)))
    return calls


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_matches_reference(monkeypatch, multi_pod):
    calls = _captured(monkeypatch)
    jmesh.make_production_mesh(multi_pod=multi_pod)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    (shape, axes), = calls
    assert mesh.axis_names == tuple(axes)
    assert tuple(mesh.shape[a] for a in axes) == tuple(shape)
    assert mesh.size == (512 if multi_pod else 256)


@pytest.mark.parametrize("n_devices", range(1, 65))
def test_mesh_for_matches_reference(monkeypatch, n_devices):
    calls = _captured(monkeypatch)
    for model_par in (None, 1, 2, 3, 4, 8, 16, 32):
        calls.clear()
        jmesh.make_mesh_for(n_devices, model_par)
        mesh = make_mesh_for(n_devices, model_par, device="cpu")
        (shape, axes), = calls
        assert mesh.axis_names == tuple(axes) == ("data", "model")
        assert tuple(mesh.shape.values()) == tuple(shape)
        assert mesh.size == n_devices


# -- collectives ---------------------------------------------------------------

def test_counter_counts_one_round_and_keeps_the_bits(rows):
    mesh = make_production_mesh(device="cpu")
    P, B, c = mesh.size, CFG.block_size, CFG.c
    su, sv, be, sg = dry._shards(rows, P)
    status, r = tdist.inner_init(sg, P, B)
    plain, _ = tdist.inner_round(su, sv, be, status, r)
    with count_collectives() as count:
        assert tdist.inner_open(status)
        counted, _ = tdist.inner_round(su, sv, be, status, r)
    assert torch.equal(plain, counted)
    # a shard gathers min(B, m_loc) candidates (16 rows a shard here)
    Bs = min(B, CFG.m_offtree // P)
    gather = P * (Bs * (2 * (c + 1) + 2) + 1) * 4
    assert count.per_kind == {"all-gather": gather, "all-reduce": 4}
    assert count.calls == {"all-gather": 5, "all-reduce": 1}
    assert roof.collective_bytes(count) == (gather + 4, count.per_kind)
    # one block at a time, and nothing counted outside it
    with count_collectives() as count:
        psum(torch.ones((3, 5), dtype=torch.float64))
        with pytest.raises(RuntimeError, match="already active"):
            with count_collectives():
                pass
    psum(torch.ones((3, 2), dtype=torch.int32))
    assert count.per_kind == {"all-reduce": 40}


# -- dry run -------------------------------------------------------------------

@pytest.mark.parametrize("where", ["mesh_for_8", "production"])
def test_dryrun_to_the_end_equals_reference_and_serial(rows, wanted,
                                                       where):
    mesh = (make_mesh_for(8, device="cpu") if where == "mesh_for_8"
            else make_production_mesh(device="cpu"))
    row, status = dry.dry_run(rows, mesh, CFG, rounds=None)
    serial, reference = wanted
    np.testing.assert_array_equal(status.numpy(), serial)
    np.testing.assert_array_equal(status.numpy(), reference)
    assert row["rounds_run"] > 2 and row["round_ms"] is None
    assert row["device"] == "cpu" and row["temp_gb"] is None
    ref_keys = {"arch", "shape", "mesh", "status", "compile_s", "arg_gb",
                "temp_gb", "flops_per_dev", "hbm_bytes_per_dev",
                "coll_bytes_per_dev", "coll_by_kind", "t_compute",
                "t_memory", "t_collective", "bottleneck", "dynamic_whiles"}
    assert ref_keys <= set(row)
    assert row["mesh"] == ("1x8" if where == "mesh_for_8" else "16x16")
    assert row["shape"] == f"recover_m{2 ** 12}"


def test_two_rounds_give_one_status_at_every_shard_count(rows):
    got = [dry.dry_run(rows, make_mesh_for(n, device="cpu"), CFG,
                       rounds=2)[1] for n in (1, 8)]
    row, st = dry.dry_run(rows, make_production_mesh(device="cpu"), CFG,
                          rounds=2)
    assert row["rounds_run"] == 2
    assert all(torch.equal(st, g) for g in got)


def test_recover_inner_over_all_axes_equals_serial():
    """The tuple of axes flattens as ``P(axes)``: 2 x 4 shards."""
    g = mesh2d(12, 12, seed=3)
    rows = dry.production_rows(dataclasses.replace(CFG, m_offtree=256), g,
                               device="cpu")
    mesh = make_mesh_for(8, 4, device="cpu")
    st, done = tdist.recover_inner(*rows[:4], mesh, axis=("data", "model"),
                                   block_size=16)
    np.testing.assert_array_equal(st.numpy(), _serial(rows))
    with pytest.raises(KeyError):
        tdist.recover_inner(*rows[:4], mesh, axis=("pod",), block_size=16)


def test_arg_gb_matches_formula_and_reference_lowering(rows):
    mesh = make_production_mesh(device="cpu")
    row, _ = dry.dry_run(rows, mesh, CFG, rounds=1)
    m, P, c = CFG.m_offtree, mesh.size, CFG.c
    assert row["arg_bytes"] == m // P * (2 * (c + 1) + 2) * 4
    assert row["arg_gb"] == round(m / P * (2 * (c + 1) + 2) * 4 / 2 ** 30, 3)
    at_full = dry.dry_run(rows, make_mesh_for(1, device="cpu"), CFG,
                          rounds=1)[0]
    # the reference's engine, its n_sh supplied, lowered on one device
    jm = jmesh.compat_make_mesh((1, 1), ("data", "model"))
    axes = ("data", "model")
    P_ = jax.sharding.PartitionSpec
    fn = jax.shard_map(
        functools.partial(jdist._inner_round_engine, axis=axes, n_sh=1,
                          block_size=CFG.block_size, chunk=CFG.chunk),
        mesh=jm, in_specs=(P_(axes, None), P_(axes, None), P_(axes),
                           P_(axes)),
        out_specs=(P_(axes), P_()))
    sds = jax.ShapeDtypeStruct
    c1 = CFG.c + 1
    compiled = jax.jit(fn).lower(
        sds((m, c1), jnp.int32), sds((m, c1), jnp.int32),
        sds((m,), jnp.int32), sds((m,), jnp.int32)).compile()
    assert at_full["arg_bytes"] == \
        compiled.memory_analysis().argument_size_in_bytes


def test_round_work_and_roofline_terms():
    # every candidate recovered at the full grid (beta >= c1 - 1)
    ops, nbytes = roof.inner_round_work(131072, 256, 64, 9, [8] * 64)
    assert ops == 4 * 131072 * 64 * 45 + 4 * 64 * 64 * 45
    none, _ = roof.inner_round_work(131072, 256, 64, 9, [-1] * 64)
    assert none == 4 * 64 * 64 * 45
    t = roof.roofline_terms(ops, nbytes, 1_311_748)
    assert t["t_collective"] == 1_311_748 / 450e9 == \
        1_311_748 / roof.NVLINK_BW
    assert t["bottleneck"] == "compute"


def test_reference_dryrun_engine_misses_n_sh():
    """``src/repro/launch/dryrun_pdgrass.py:52-55`` builds its engine so;
    the port's dry run reads the shard count from the mesh instead."""
    fn = functools.partial(jdist._inner_round_engine, axis=("data", "model"),
                           block_size=64, chunk=4096)
    z = np.zeros((4, 9), np.int32)
    with pytest.raises(TypeError, match="n_sh"):
        fn(z, z, z[:, 0], z[:, 0])
