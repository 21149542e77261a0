"""A third traced pass: the cell's rounds once more with the port's own
tracer on (`ht3dgs_torch.utils.profiling.tracing`), under a profiler of
the device and its runtime calls alone, as the first traced pass runs.
The port's spans and counters are matched to the pass's runtime calls and
device busy intervals on one clock (`reduce`), and six per-layer metrics
read the result (METRICS, `read`).

`traced_rounds(job, device, rounds)` is the pass. It belongs after the
profiled step (`run.reckon`) and before the port's state is released: the
peak memory, the window and the profiled step have all been read by then,
so nothing the pass does (a leaf's densify may fire in it) moves another
metric. It prints one line on standard error, `htbench: idle by span
...`: the device-idle ms a step put down to the innermost span open on the
host when each gap opened, the share of the window's kernel launches made
inside a span, where the blend kernels were launched, and the clock's
offset.

The clock: a span is stamped with `time.time_ns()`; the profiler converts
CUPTI's timestamps to the same epoch. The pass opens with a few launches
bracketed by `time.time_ns()` (the marks); the offset that puts every
mark's runtime call inside its bracket is 0 when the two clocks agree, and
is applied to the profiler's events when they do not.
"""

from __future__ import annotations

import re
import statistics
import sys
import time
from collections import defaultdict
from typing import Dict, List, Optional

PREFIX = "htbench: "
MARKS = 16
def _per_step(key):
    def read(s):
        return s["idle_ms"][key] / s["steps"] if s["steps"] else None
    return read


def _share(num, den):
    def read(s):
        c = s["counters"]
        d = sum(c.get(k, 0) for k in den)
        if not d:
            return None
        return 100.0 * sum(sign * c.get(k, 0) for sign, k in num) / d
    return read


# each metric of a pass's reduction (`reduce`); None where it has nothing
METRICS = {
    # mean host duration of the outermost `step` spans
    "host_step_ms": lambda s: s["host_step_ms"],
    # device-idle ms a step in gaps that open inside a `step` span
    "step_idle_ms": _per_step("step"),
    # ... and in gaps that open outside every `step` span
    "trainer_idle_ms": _per_step("trainer"),
    # entries in slots (an entry past M is dropped) over the slots
    "binning_fill_pct": _share(((1, "entries"), (-1, "dropped_m")),
                               ("slots",)),
    # entries dropped at M, at a tile's K and by compact_n over entries
    "binning_drop_pct": _share(((1, "dropped_m"), (1, "dropped_k"),
                                (1, "dropped_compact")), ("entries",)),
    # live rows projected over the capacity rows projected
    "live_rows_pct": _share(((1, "live_rows"),), ("capacity_rows",)),
}


def read(name: str, spans: Optional[dict]):
    """Metric `name` (or its twin `<name>.<part>`) of a reduction."""
    if not spans:
        return None
    v = METRICS[name.split(".")[0]](spans)
    return None if v is None else float(v)


def clock_marks(x, n: int = MARKS) -> List[tuple]:
    """n launches (fills of the device tensor x, made before the profile
    starts so that these are its first launches), each bracketed by
    time.time_ns() before and after."""
    marks = []
    for i in range(n):
        a = time.time_ns()
        x.fill_(float(i))
        b = time.time_ns()
        marks.append((a, b))
    return marks


def _fit(pairs) -> tuple:
    """The offsets [lo, hi] (ns) that put each call inside its bracket."""
    lo = max(a - s for (a, _), (s, _) in pairs)
    hi = min(b - e for (_, b), (_, e) in pairs)
    return lo, hi


def clock_offset(marks: List[tuple], calls: List[tuple]) -> Dict[str, int]:
    """The offset d (ns) that maps the profiler's clock onto the spans'
    (t + d) from the marks' brackets and the profile's launch calls
    (start, end) in order. The marks' calls are len(marks) calls in a
    row: the first such run, after `skipped` calls (launches made before
    the marks), for which some d puts each call inside its bracket. Every d
    in [lo, hi] does that; d is 0 when 0 lies in it, else its middle.
    Where no run fits, the first calls are taken and d is the median
    bracket's middle (`skipped` None). The first mark is left out: its
    launch may load the kernel."""
    n = len(marks)
    if n < 2 or len(calls) < n:
        return {"offset_ns": 0, "lo_ns": None, "hi_ns": None,
                "skipped": None}
    for k in range(min(len(calls) - n, n) + 1):
        pairs = list(zip(marks, calls[k:k + n]))[1:]
        lo, hi = _fit(pairs)
        if lo <= hi:
            d = 0 if lo <= 0 <= hi else (lo + hi) // 2
            return {"offset_ns": d, "lo_ns": lo, "hi_ns": hi, "skipped": k}
    pairs = list(zip(marks, calls))[1:]
    lo, hi = _fit(pairs)
    d = int(statistics.median((a - s + b - e) / 2
                              for (a, b), (s, e) in pairs))
    return {"offset_ns": d, "lo_ns": lo, "hi_ns": hi, "skipped": None}


def innermost(spans: List[dict], times: List[int]) -> List[Optional[int]]:
    """For each time, the id of the innermost span open on the host then
    (start <= t < end), or None. The spans nest (one host thread)."""
    def end(i):
        e = spans[i]["end_ns"]
        return sys.maxsize if e is None else e

    order = sorted(range(len(spans)), key=lambda i: spans[i]["start_ns"])
    out: List[Optional[int]] = [None] * len(times)
    stack: List[int] = []
    j = 0
    for q in sorted(range(len(times)), key=times.__getitem__):
        t = times[q]
        while j < len(order) and spans[order[j]]["start_ns"] <= t:
            # a span that ended before this one opened is not around it
            while stack and end(stack[-1]) <= spans[order[j]]["start_ns"]:
                stack.pop()
            stack.append(order[j])
            j += 1
        while stack and end(stack[-1]) <= t:
            stack.pop()
        out[q] = stack[-1] if stack else None
    return out


def _ancestor(spans, i, name) -> Optional[int]:
    while i is not None:
        if spans[i]["name"] == name:
            return i
        i = spans[i]["parent"]
    return None


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def reduce(events, spans: List[dict], counters: Dict[str, int],
           marks: List[tuple], window: tuple) -> dict:
    """Of a CUDA-only profile's raw events (kineto's: runtime calls on the
    host, operations on the device), the tracer's spans and counters, the
    clock marks and the pass's window (time.time_ns() at its start and end,
    each after a synchronise): steps (outermost `step` spans), host ms in
    them, device busy time, every idle gap of the window put down to the
    innermost span open when it opened ("none" outside every span) and to
    the step or the trainer by whether that span lies in a `step` span,
    the counters, the window's kernel launches made inside spans and the
    blend kernels' spans."""
    from torch.autograd import DeviceType

    host = [e for e in events if e.device_type() == DeviceType.CPU]
    dev = [e for e in events if e.device_type() == DeviceType.CUDA
           and not e.is_user_annotation() and not e.name().startswith(PREFIX)]
    launch_calls = sorted((e.start_ns(), e.end_ns()) for e in host
                          if "LaunchKernel" in e.name())
    clock = clock_offset(marks, launch_calls)
    d = clock["offset_ns"]
    t0, t1 = window

    busy = _union([(max(e.start_ns() + d, t0), min(e.end_ns() + d, t1))
                   for e in dev if e.end_ns() + d > t0
                   and e.start_ns() + d < t1])
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = [(edges[k], edges[k + 1] - edges[k])
            for k in range(0, len(edges), 2) if edges[k + 1] > edges[k]]
    at = innermost(spans, [g for g, _ in gaps])
    by_span: Dict[str, float] = defaultdict(float)
    idle = {"step": 0.0, "trainer": 0.0}
    for (_, w), i in zip(gaps, at):
        by_span["none" if i is None else spans[i]["name"]] += w / 1e6
        idle["step" if _ancestor(spans, i, "step") is not None
             else "trainer"] += w / 1e6

    steps = [s for s in spans if s["name"] == "step"
             and _ancestor(spans, s["parent"], "step") is None]

    # the window's kernels, each with its runtime call (by correlation id;
    # a kernel whose call the profile lacks counts as launched outside)
    calls = {e.correlation_id(): e for e in host if e.correlation_id()}
    kernels = []
    for e in dev:
        if re.search(r"[Mm]emcpy|[Mm]emset", e.name()):
            continue
        c = calls.get(e.correlation_id())
        if t0 <= (c or e).start_ns() + d < t1:
            kernels.append((e.name(), c))
    where = iter(innermost(spans, [c.start_ns() + d for _, c in kernels
                                   if c is not None]))
    blend = {"K1": [0, 0], "K2": [0, 0]}
    inside = 0
    for name, c in kernels:
        i = next(where) if c is not None else None
        inside += i is not None
        for part, key, span_name in (("blend_fwd", "K1", "blend"),
                                     ("blend_bwd", "K2", "backward")):
            if part in name:
                blend[key][1] += 1
                a = _ancestor(spans, i, span_name)
                blend[key][0] += (a is not None and c is not None and
                                  c.end_ns() + d <= spans[a]["end_ns"])
    return {"steps": len(steps), "window_s": (t1 - t0) / 1e9,
            "busy_s": sum(e - s for s, e in busy) / 1e9,
            "host_step_ms": (statistics.fmean(
                (s["end_ns"] - s["start_ns"]) / 1e6 for s in steps)
                if steps else None),
            "idle_ms": idle, "idle_by_span_ms": dict(by_span),
            "counters": dict(counters), "launches": len(kernels),
            "launches_in_spans": inside, "blend": blend, "clock": clock}


def line(s: dict) -> str:
    """The `idle by span` line of a reduction."""
    n = max(s["steps"], 1)
    parts = "; ".join(f"{k} {v / n:.3f}" for k, v in sorted(
        s["idle_by_span_ms"].items(), key=lambda kv: -kv[1]))
    c = s["clock"]
    return (f"{PREFIX}idle by span (device-idle ms a step, by the innermost "
            f"span open on the host as each gap opened; {s['steps']} steps, "
            f"{s['window_s'] / n * 1e3:.3f} ms a step traced): {parts}; in "
            f"step spans {s['idle_ms']['step'] / n:.3f}, outside "
            f"{s['idle_ms']['trainer'] / n:.3f}; launches inside spans "
            f"{100 * s['launches_in_spans'] / max(s['launches'], 1):.2f}% of "
            f"{s['launches']}; K1 in blend {s['blend']['K1'][0]}/"
            f"{s['blend']['K1'][1]}, K2 in backward {s['blend']['K2'][0]}/"
            f"{s['blend']['K2'][1]}; clock offset {c['offset_ns']} ns "
            f"(fits {c['lo_ns']}..{c['hi_ns']}, marks after "
            f"{c['skipped']} launches)")


def traced_rounds(job, device, rounds: int) -> Optional[dict]:
    """`rounds` rounds of the job under a CUDA-only profiler with the
    port's tracing on, reduced (`reduce`); None without rounds."""
    import torch

    from ht3dgs_torch.utils.profiling import tracing

    from . import run

    if not rounds:
        return None
    steps = 0
    x = torch.zeros(1, device=device)
    run.sync(device)
    with run._profile(cpu=False) as prof:
        with tracing() as tr:
            marks = clock_marks(x)
            run.sync(device)
            t0 = time.time_ns()
            for _ in range(rounds):
                steps += job.round()[0]
            run.sync(device)
            t1 = time.time_ns()
    out = reduce(list(prof.profiler.kineto_results.events()), tr.spans,
                 tr.counters, marks, (t0, t1))
    out["round_steps"] = steps
    print(line(out), file=sys.stderr)
    return out
