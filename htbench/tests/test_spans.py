"""The third traced pass's reduction (`htbench.spans.reduce`) on a made-up
profile: gaps put down to the innermost span open as they opened, step
against trainer, the blend kernels' spans, the clock's offset, and the six
metrics."""

import pytest
from torch.autograd import DeviceType

from htbench import spans as S


class Ev:
    """A kineto event: name, device, start, end, correlation id."""

    def __init__(self, name, dev, s, e, corr=0):
        self._n, self._d, self._s, self._e, self._c = name, dev, s, e, corr

    def name(self):
        return self._n

    def device_type(self):
        return DeviceType.CUDA if self._d else DeviceType.CPU

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def correlation_id(self):
        return self._c

    def is_user_annotation(self):
        return False


def span(i, name, parent, s, e):
    return {"name": name, "id": i, "parent": parent, "step": 1,
            "start_ns": s, "end_ns": e}


def profile(shift):
    """Spans of one iteration on the host clock, and a profile whose
    clock reads `shift` ns behind it: a launch made before the marks,
    three marks, a kernel launched in the window outside every span, K1
    launched in the blend span, K2 in the backward span, a copy in the
    tune span. The marks' brackets fix the offset to the ns once the
    launch before them is skipped; taking it as the first mark's call
    fits no offset."""
    sp = [span(0, "iteration", None, 100, 900),
          span(1, "frame", 0, 110, 150),
          span(2, "step", 0, 150, 700),
          span(3, "blend", 2, 200, 300),
          span(4, "backward", 2, 300, 600),
          span(5, "tune", 0, 700, 880)]
    marks = [(0, 20), (35, 40), (50, 58)]
    ev = [("cudaLaunchKernel", 0, -30, -25, 9), ("fill", 1, -20, -18, 9),
          ("cudaLaunchKernel", 0, 5, 10, 1), ("fill", 1, 12, 14, 1),
          ("cudaLaunchKernel", 0, 35, 40, 2), ("fill", 1, 42, 44, 2),
          ("cudaLaunchKernel", 0, 52, 56, 3), ("fill", 1, 57, 59, 3),
          ("cudaLaunchKernel", 0, 92, 95, 10), ("scale", 1, 95, 98, 10),
          ("cudaLaunchKernel", 0, 210, 220, 4),
          ("blend_fwd_kernel", 1, 230, 400, 4),
          ("cudaLaunchKernel", 0, 310, 320, 5),
          ("blend_bwd_kernel", 1, 450, 650, 5),
          ("cudaMemcpyAsync", 0, 710, 720, 6),
          ("Memcpy DtoH", 1, 720, 730, 6)]
    return sp, marks, [Ev(n, d, s - shift, e - shift, c)
                       for n, d, s, e, c in ev]


@pytest.mark.parametrize("shift", [0, 100])
def test_reduce_puts_each_gap_down_to_its_span(shift):
    sp, marks, ev = profile(shift)
    r = S.reduce(ev, sp, {"entries": 90, "slots": 100, "dropped_m": 0,
                          "dropped_k": 9, "dropped_compact": 0,
                          "live_rows": 3, "capacity_rows": 4},
                 marks, (90, 1000))
    assert r["clock"]["offset_ns"] == shift
    assert r["clock"]["skipped"] == 1
    # busy 95-98, 230-400, 450-650, 720-730 in the window 90-1000
    assert r["busy_s"] == pytest.approx(383e-9)
    assert r["idle_by_span_ms"] == pytest.approx(
        {"none": 137e-6, "backward": 50e-6, "step": 70e-6,
         "tune": 270e-6})
    assert r["idle_ms"]["step"] == pytest.approx(120e-6)
    assert r["idle_ms"]["trainer"] == pytest.approx(407e-6)
    assert sum(r["idle_ms"].values()) == pytest.approx(
        (910 - 383) * 1e-6)
    assert r["blend"] == {"K1": [1, 1], "K2": [1, 1]}
    # the window's kernels: the marks' and the one before them are not
    assert (r["launches"], r["launches_in_spans"]) == (3, 2)
    assert r["steps"] == 1 and r["host_step_ms"] == pytest.approx(550e-6)
    got = {k: S.read(k + ".mss", r) for k in S.METRICS}
    assert got == pytest.approx({
        "host_step_ms": 550e-6, "step_idle_ms": 120e-6,
        "trainer_idle_ms": 407e-6, "binning_fill_pct": 90.0,
        "binning_drop_pct": 10.0, "live_rows_pct": 75.0})
    assert S.read("live_rows_pct", None) is None


def test_clock_offset_takes_no_run_that_fits_nothing():
    """Marks whose calls fit no offset at any alignment: the first calls
    are taken, and the median bracket's middle is applied."""
    marks = [(0, 10), (20, 22), (40, 42)]
    calls = [(1, 2), (30, 31), (41, 42)]
    c = S.clock_offset(marks, calls)
    assert c["skipped"] is None and c["lo_ns"] > c["hi_ns"]
    assert c["offset_ns"] == -5
