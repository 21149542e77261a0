"""The traced window: profiler ranges around the port's layers, put there
from the benchmark's own files, and the reduction of the profiler's events
to what the per-layer readers read. A traced window is two runs of the same
rounds: one traced on the device alone (busy time, launches, idle gaps: the
host runs nearly as untraced), one with the host's operations under the
layer ranges (device time by layer: recording every host operation slows
the host several times over, which leaves the kernels' times as they are
but not the gaps between them).

Each function in LAYERS is wrapped, while the window is traced, in a
`record_function` range named for its layer; a device operation counts in
the innermost range around the host operation that launched it. A backward
operation counts in the layer of the forward operation whose autograd node
it runs (linked by sequence number, as torch records no Python stacks for
operations), with the blend's backward under its kernel K2.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import re
from collections import Counter, defaultdict
from typing import Dict, List, Optional

import torch

PREFIX = "htbench: "
LAYERS = (
    ("ht3dgs_torch.raster", "_render", "projection"),
    ("ht3dgs_torch.raster.tiled", "_pack_attr_rows", "binning"),
    ("ht3dgs_torch.raster.tiled", "build_tile_lists_from_rows", "binning"),
    ("ht3dgs_torch.raster.tiled", "blend", "blend"),
    ("ht3dgs_torch.raster.tiled", "_assemble", "assemble"),
    ("ht3dgs_torch.train.step", "compute_loss", "loss"),
    ("ht3dgs_torch.train.step", "psnr", "loss"),
    ("ht3dgs_torch.train.phase_a", "compute_loss", "loss"),
    ("ht3dgs_torch.train.phase_a", "psnr", "loss"),
    ("ht3dgs_torch.core.adam", "apply", "optimizer"),
    ("ht3dgs_torch.train.densify", "accumulate_stats", "densify"),
    ("ht3dgs_torch.train.step", "densify_and_prune", "densify"),
    ("ht3dgs_torch.train.step", "reset_opacity", "densify"),
)
# the kernels that are layers of their own, by a part of their name
KERNELS = (("blend_fwd", "K1"), ("blend_bwd", "K2"))


@contextlib.contextmanager
def layer_ranges():
    """Wrap each function of LAYERS in a range named for its layer; the
    originals go back on exit."""
    def ranged(fn, name):
        def call(*a, **kw):
            with torch.profiler.record_function(name):
                return fn(*a, **kw)
        return call

    originals = []
    try:
        for mod, attr, layer in LAYERS:
            m = importlib.import_module(mod)
            fn = getattr(m, attr)
            originals.append((m, attr, fn))
            setattr(m, attr, ranged(fn, PREFIX + layer))
        yield
    finally:
        for m, attr, fn in reversed(originals):
            setattr(m, attr, fn)


def _range_of(evt) -> Optional[str]:
    while evt is not None:
        if evt.name.startswith(PREFIX):
            return evt.name[len(PREFIX):]
        evt = evt.cpu_parent
    return None


def _node_op(name: str) -> str:
    return re.sub(r"Backward\d*$", "", name.split("::")[-1]).replace(
        "_", "").lower()


def _backward_node(e):
    while e is not None:
        if e.scope == 1:      # RecordScope BACKWARD_FUNCTION
            return e
        e = e.cpu_parent
    return None


def _union(intervals: List[tuple]) -> List[tuple]:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _is_annotation(name: str) -> bool:
    return name.startswith(PREFIX)


def device_time(prof) -> Dict:
    """Of a trace of the device and its runtime calls (no host operations,
    so the host runs nearly as untraced): the device operations' busy time
    (the union of their intervals), kernel launches, the operations that
    took most time, and the longest idle gaps labelled by the runtime call
    the host was in when the gap began (none: the host was in Python).
    Times in seconds."""
    from torch.autograd import DeviceType

    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not _is_annotation(e.name)]
    calls = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in events if e.device_type == DeviceType.CPU)
    kernels: Counter = Counter()
    launches = 0
    spans = []
    for d in dev:
        s, e = d.time_range.start, d.time_range.end
        spans.append((s, e))
        kernels[d.name] += (e - s) / 1e6
        launches += not re.search(r"[Mm]emcpy|[Mm]emset", d.name)
    busy = _union(spans)
    gaps = sorted(((s1 - e0, e0) for (_, e0), (s1, _) in zip(busy,
                                                            busy[1:])),
                  reverse=True)
    starts = [c[0] for c in calls]
    idle = []
    for width, at in gaps[:10]:
        i = bisect.bisect_right(starts, at)
        inside = [n for s, e, n in calls[max(0, i - 50):i] if e >= at]
        idle.append([inside[-1] if inside else "host Python", width / 1e6])
    return {"launches": launches,
            "busy_s": sum(e - s for s, e in busy) / 1e6,
            "device_ops": [[k, v] for k, v in kernels.most_common(10)],
            "idle_gaps": idle}


def layer_time(prof) -> Dict[str, float]:
    """Of a trace of host operations and the device under the layer
    ranges: the device seconds of each layer's kernels (each host
    operation's kernels, the profiler links a kernel to the operation that
    launched it)."""
    from torch.autograd import DeviceType

    cpu = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    fwd = defaultdict(list)
    for e in cpu:
        if e.sequence_nr >= 0 and _backward_node(e) is None \
                and not _is_annotation(e.name):
            fwd[(e.sequence_nr, e.thread)].append(e)

    def layer_of(op) -> str:
        node = _backward_node(op)
        if node is None:
            return _range_of(op) or "other"
        cands = fwd.get((node.sequence_nr, node.fwd_thread), [])
        named = [c for c in cands if _node_op(c.name) == _node_op(node.name)]
        pick = (named or cands)[-1:]
        layer = _range_of(pick[0]) if pick else None
        return layer or "other"

    # each kernel once, by the host operation it is linked to (the raw
    # events carry the link; a host operation's list of kernels can hold
    # a kernel more than once)
    by_id = {e.id: e for e in cpu if not _is_annotation(e.name)}
    layers: Dict[str, float] = defaultdict(float)
    for k in prof.profiler.kineto_results.events():
        if k.device_type() != DeviceType.CUDA or _is_annotation(k.name()):
            continue
        name = next((lay for part, lay in KERNELS if part in k.name()),
                    None)
        if name is None:
            op = by_id.get(k.linked_correlation_id())
            name = layer_of(op) if op is not None else "other"
        layers[name] += (k.end_ns() - k.start_ns()) / 1e9
    return dict(layers)
