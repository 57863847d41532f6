"""The traced window read from device records: bounded by the spin
kernels around it, whichever of them the profiler kept, with records
from before the opening spins left out."""

import pytest
from torch.autograd import DeviceType

from portbench.harness.profile import PAD_SYMBOL, DeviceWindow


class _Event:
    def __init__(self, name, start, dur):
        self._n, self._s, self._d = name, start, dur

    def device_type(self):
        return DeviceType.CUDA

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d


def _read(events):
    class _NS:
        pass
    dw = DeviceWindow()
    dw._prof = _NS()
    dw._prof.profiler = _NS()
    dw._prof.profiler.kineto_results = _NS()
    dw._prof.profiler.kineto_results.events = lambda: events
    dw.t0 = 100.0
    dw._read()
    return dw


def _spins(t0, n=3):
    return [_Event(PAD_SYMBOL, t0 + 10 * i, 5) for i in range(n)]


@pytest.mark.parametrize("opening", [3, 1])
def test_window_between_the_spins(opening):
    events = (_spins(0) + [_Event("memcpy", 1000, 5)] + _spins(2000, opening)
              + [_Event("k", 3000, 100), _Event("k", 3050, 100),
                 _Event("k", 4000, 10)] + _spins(5000))
    dw = _read(events)
    d0 = 2000 + 10 * (opening - 1) + 5
    assert dw.window_s == pytest.approx((5000 - d0) * 1e-9)
    assert dw.busy_s == pytest.approx(160e-9)
    assert len(dw.records) == 3
    # tied to the host clock at the opening spins' end
    assert dw.records[0][1] == pytest.approx(100.0 + (3000 - d0) * 1e-9)
    assert dw.kernel_seconds(("k",)) == pytest.approx(210e-9)
    assert dw.top_ops() == [["k", pytest.approx(210e-9)]]


def test_no_spins_reads_nothing():
    dw = _read([_Event("k", 3000, 100)])
    assert dw.window_s is None and dw.busy_s is None
