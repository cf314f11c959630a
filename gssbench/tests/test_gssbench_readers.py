"""The metric readers on a hand-made run: spans per batch with the traced
batch left out, trips, the roofline share from shapes, nothing read where
there is nothing to read."""
import numpy as np
import pytest

from gssbench import roofline
from gssbench.harness import Batch, Run
from gssbench.profiling import DeviceTrace


def _span(name, t0_s, dur_s):
    return {"name": name, "ts_ns": int(t0_s * 1e9),
            "dur_ns": int(dur_s * 1e9)}


@pytest.fixture
def run():
    r = Run(cell="c", kind="closed_batch", seconds=10.0, trace=True)
    r.batches = [Batch(0.0, 4.0, 32, np.array([90, 100]), 2),
                 Batch(5.0, 11.0, 32, np.array([120, 110]), 2, True),
                 Batch(12.0, 15.0, 32, np.array([80, 60]), 2)]
    r.window_s = 13.0
    r.spans = [_span("solver.flush", 0.1, 3.8),
               _span("solver.solve", 0.2, 1.0),
               _span("solver.refine", 1.5, 0.5),
               _span("solver.flush", 5.1, 5.8),
               _span("solver.solve", 5.2, 4.0),
               _span("solver.flush", 12.1, 2.8),
               _span("solver.solve", 12.2, 1.2)]
    r.shapes = {"n": 100, "ell_width": 7, "k": 32,
                "level_triples": [(100, 9, 40), (40, 9, 10)]}
    r.profiled = (5.0, 11.0)
    r.device = DeviceTrace(window_s=6.0, busy_s=1.5, op_s={}, gap_s={},
                           annotated_s={"solver.solve": 0.5})
    return r


def test_host_ms_leaves_out_the_traced_flush(manifest, run):
    read = manifest.reader("service.host_ms.solve")
    # flushes 0 and 2: (3.8 - 1.5) and (2.8 - 1.2) s
    assert read(run) == pytest.approx((2.3 + 1.6) / 2 * 1e3)


def test_trip_ms(manifest, run):
    # (1.0 + 0.5 + 1.2) s over 100 + 80 trips
    assert manifest.reader("pcg.trip_ms.solve")(run) == pytest.approx(
        2.7 / 180 * 1e3)


def test_iters_and_rate(manifest, run):
    assert manifest.reader("pcg.iters.solve")(run) == pytest.approx(560 / 6)
    assert manifest.reader("pcg.iters.resparsify")(run) is None
    assert manifest.reader("solve_cols_per_s")(run) == pytest.approx(6 / 13)
    assert manifest.reader("graph_to_solution_s")(run) is None


def test_roofline_from_shapes(manifest, run):
    nbytes = roofline.pcg_trip_bytes(100, 7, 32, [(100, 9, 40), (40, 9, 10)])
    want = 100 * nbytes * 120 / roofline.HBM_BW / 0.5
    assert manifest.reader("solve_kernels_roofline")(run) == pytest.approx(
        want)


def test_idle_share(manifest, run):
    assert manifest.reader("device.idle_pct.solve")(run) == pytest.approx(75)
    assert manifest.reader("device.idle_pct.resparsify")(run) is None
    run.device = None
    assert manifest.reader("device.idle_pct.solve")(run) is None
    assert manifest.reader("solve_kernels_roofline")(run) is None


def test_nothing_to_read(manifest):
    empty = Run(cell="c", kind="resparsify", seconds=1.0, trace=True)
    for m in manifest.data["per_layer"] + manifest.data["end_to_end"]:
        if m["name"] != "setup_s":
            assert manifest.reader(m["name"])(empty) is None, m["name"]
