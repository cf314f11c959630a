"""The reduction of a traced window to device numbers, on hand-made
events: busy time, idle gaps by what the host was doing, the device time
inside named ranges, work outside the window cut off."""
import pytest

from gssbench import profiling

CUDA, CPU = "DeviceType.CUDA", "DeviceType.CPU"


class _Event:
    def __init__(self, name, start, end, device=CUDA, annotation=False):
        self._v = (name, start, end - start, device, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]


def _range(name, start, end, device=CPU):
    return _Event(name, start, end, device, annotation=True)


def test_classify():
    assert profiling.classify(_Event("k", 0, 1)) == "device"
    assert profiling.classify(_Event("aten::add", 0, 1, CPU)) == "op"
    assert profiling.classify(_range("r", 0, 1)) == "range"
    assert profiling.classify(_range("r", 0, 1, CUDA)) == "gpu_range"


def test_reduce_events():
    events = [_range(profiling.WINDOW, 100, 300),
              _range("solver.solve", 102, 178),
              _range("solver.solve", 110, 170, CUDA),
              _Event("k1", 110, 130), _Event("k2", 120, 140),
              _Event("k1", 160, 170), _Event("k1", 290, 320),
              _Event("cudaStreamSynchronize", 140, 160, CPU)]
    # the tracer's span, on perf_counter: 1000 ns before the profiler's
    spans = [(-820, -700, "solver.group")]
    d = profiling.reduce_events(events, spans, offset_ns=1000)
    assert d.window_s == pytest.approx(200e-9)
    assert d.busy_s == pytest.approx(50e-9)      # 110-140, 160-170, 290-300
    assert d.op_s == pytest.approx({"k1": 40e-9, "k2": 20e-9})
    assert d.gap_s == pytest.approx({
        "solver.solve": 10e-9,                    # 100-110
        "solver.solve / cudaStreamSynchronize": 20e-9,
        "solver.group": 120e-9})                  # 170-290
    assert d.annotated_s == pytest.approx({"solver.solve": 40e-9})
    assert d.top(d.op_s, 1) == [["k1", pytest.approx(40e-9)]]


def test_nothing_named_around_a_gap():
    events = [_range(profiling.WINDOW, 0, 100), _Event("k", 40, 60)]
    d = profiling.reduce_events(events)
    assert d.gap_s == pytest.approx({"no named range": 80e-9})
    assert d.annotated_s == {}


def test_no_window_no_trace():
    assert profiling.reduce_events([_Event("k", 0, 1)]) is None
