"""Tracing and phase timing. Counterpart of `ht3dgs.utils.profiling`.

The port's tracer: `span(name)` marks a stretch of host work (a trainer
phase, an iteration, a step, a layer of the step) and `count(name, value)`
adds to a counter where the work is done (the binning's entries, slots and
drops; the rows a render projects; MSS phase 1's pseudo-views, the child's
live rows and drops at K in `pseudo_*`). Both do nothing unless a `tracing()`
block is open: off, a span is one flag check that returns a shared no-op
object and a count returns before it touches its value, so the off path
adds no device operation, synchronise or host copy. On, a span records
its name, its parent (the span open around it), the id of its training
step and its start and end in ns on `time.time_ns()`, the clock the
profiler's events are stamped on, and opens a `record_function` range of
its name (a torch.profiler trace shows it); a counter adds into one device
tensor per name, read once when the block exits. `tracing()` hands both
back as a `Trace`.

`torch_trace` captures a torch.profiler trace around any block (the
counterpart of `jax_trace`), and `PhaseTimer` keeps the named-phase wall
time and counts that the trainer logs at the end of a run (each phase is a
span too). `host_share` splits a step's wall time on the card into device
and host. `StepCounter` adds, per trainer phase, the steps, the blend
kernels' launches, the farthest-first drops, the tile arguments of the
last step and the size of every bundle the trainer finishes
(`real_image_bench`, `chip_smoke.py`). `root_step_figures` times a trained
root's step at the tile arguments the training used and at the eval
sweep's, and `profile_step` splits one step's device time by kernel and by
the spans of the step's layers; `blend_work` counts what the blend
kernels' bound and instruction floor divide by."""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import re
import statistics
import time
from collections import Counter, defaultdict
from typing import Dict, List, Optional

_trace: Optional["Trace"] = None    # the open tracing() block: tracing on


class _NoSpan:
    """What `span` returns with tracing off: one shared object."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "attrs", "parent", "step", "start_ns", "end_ns",
                 "_trace", "_range")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        import torch

        t = self._trace = _trace
        self.parent = t._open[-1] if t._open else None
        step = self.attrs.pop("step", None)
        if step is None and self.parent is not None:
            step = self.parent.step
        if step is None and self.name == "iteration":
            # a step without a trainer iteration (Phase A's batched loops)
            t._drawn -= 1
            step = t._drawn
        self.step, self.end_ns = step, None
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self.start_ns = time.time_ns()
        t._open.append(self)
        t._spans.append(self)
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        self._trace._open.pop()
        self._range.__exit__(*exc)
        return False


def span(name: str, **attrs):
    """A context manager marking a stretch of host work as `name`. An
    `iteration` span opens a training step: its `step` attribute (the
    trainer's global iteration) is the id of every span inside it, and
    without one the tracer draws a negative id. Other attributes are kept
    with the span."""
    if _trace is None:
        return _NO_SPAN
    return _Span(name, attrs)


def traced(name: str):
    """Decorator: each call of the function is a span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*a, **kw):
            if _trace is None:
                return fn(*a, **kw)
            with _Span(name, {}):
                return fn(*a, **kw)
        return call
    return wrap


def count(name: str, value) -> None:
    """Add value (an int, or a tensor's sum) to the counter `name`."""
    if _trace is None or not _trace.counting:
        return
    _trace._add(name, value)


class Trace:
    """What a tracing() block recorded, filled when the block exits:
    `spans`, a list of dicts in the order the spans opened (name, id =
    the index in the list, parent = its parent's id or None, step,
    start_ns, end_ns, and the span's attributes), and `counters`, the sum
    of each counter (none where the block counts nothing)."""

    def __init__(self, counting: bool = True):
        self.counting = counting
        self._spans: List[_Span] = []
        self._open: List[_Span] = []   # innermost last
        self._drawn = 0
        self._dev: Dict[str, object] = {}
        self._host: Dict[str, int] = defaultdict(int)
        self.spans: List[dict] = []
        self.counters: Dict[str, int] = {}

    def _add(self, name: str, value) -> None:
        if isinstance(value, int):
            self._host[name] += value
            return
        import torch

        v = value.detach().sum(dtype=torch.int64)
        acc = self._dev.get(name)
        self._dev[name] = v if acc is None else acc + v

    def _close(self) -> None:
        import torch

        index = {id(s): i for i, s in enumerate(self._spans)}
        self.spans = [
            dict(s.attrs, name=s.name, id=i,
                 parent=index.get(id(s.parent)), step=s.step,
                 start_ns=s.start_ns, end_ns=s.end_ns)
            for i, s in enumerate(self._spans)]
        self.counters = dict(self._host)
        if self._dev:
            # one read of every counter
            vals = torch.stack(list(self._dev.values())).tolist()
            for k, v in zip(self._dev, vals):
                self.counters[k] = self.counters.get(k, 0) + int(v)


@contextlib.contextmanager
def tracing(counters: bool = True):
    """Turn spans and (unless counters is False) counters on for the
    block; yields the Trace that is filled when the block exits. One block
    at a time."""
    global _trace
    if _trace is not None:
        raise RuntimeError("tracing() is already on")
    t = _trace = Trace(counters)
    try:
        yield t
    finally:
        _trace = None
        t._close()


class PhaseTimer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        """Time the block as phase `name` (host clock, no synchronise), a
        span of that name."""
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, dict]:
        return {
            k: {"total_s": round(v, 3), "count": self.counts[k],
                "mean_ms": round(1000 * v / max(self.counts[k], 1), 2)}
            for k, v in sorted(self.totals.items(), key=lambda kv: -kv[1])
        }

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)


def host_share(fn, reps: int = 20, profiled: int = 5):
    """(median wall ms of fn() with a synchronise, device busy ms per call
    under torch.profiler: the sum of its kernel times). On the card only."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(profiled):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    return statistics.median(times), busy_us / 1e3 / profiled


@contextlib.contextmanager
def torch_trace(log_dir: Optional[str]):
    """Capture a torch.profiler trace of the block (host and, where there
    is a card, CUDA activity) into log_dir as a Chrome/TensorBoard trace
    when log_dir is set; nothing otherwise."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


class StepCounter:
    """Counts, per trainer phase (a PhaseTimer phase; None outside one),
    the training steps (a batched step once), the model-steps in them, the
    launches of the blend kernels K1 and K2 and, over the single steps
    (`gaussian_train_step`), the entries the binning dropped farthest-first
    at M and at a tile's K; and the tile arguments of the phase's last step
    of any kind (`tile_args`; the last of the run: `train_tile_args`). The
    trainer's eval sweep grows `trainer._tile_args` past the training's
    after the last step, so a root step timed as the training ran it takes
    `train_tile_args`. With `watch_trainer` it also records each bundle
    the hierarchical trainer finishes (a crumb's tag) or merges: its live
    rows, capacity and M = capacity x dup_factor.

    It also records each change of the tile arguments from one step to the
    next (`growths`: the trainer's auto-grow), the opacity resets per phase
    and, with `track_peaks`, each phase's peak of allocated device memory
    (it resets the device's peak statistics as each phase starts).

    It works by wrapping module functions, so it counts one run at a time;
    `restore` puts the originals back. Drops are summed on the device and
    read once, by `drop_counts`."""

    def __init__(self, timer: Optional[PhaseTimer] = None,
                 track_peaks: bool = False):
        self.track_peaks = track_peaks
        self.growths: List[dict] = []
        self.resets: Counter = Counter()
        self.peaks: Dict[str, int] = {}
        self._stepped = False
        self.current = None
        self.steps: Counter = Counter()
        self.model_steps: Counter = Counter()
        self.launches: Dict[Optional[str], Counter] = defaultdict(Counter)
        self.bundles: List[dict] = []
        self.tile_args: Dict[Optional[str], Optional[dict]] = {}
        self.train_tile_args: Optional[dict] = None
        self._drops: Dict[Optional[str], object] = {}
        if timer is not None:
            self.attach(timer)

    @staticmethod
    def _counts() -> Dict[str, int]:
        from ..raster import blend

        return {"blend_fwd": blend.blend_fwd.launches,
                "blend_bwd": blend.blend_bwd.launches}

    def attach(self, timer: PhaseTimer) -> None:
        """Count under each of timer's phases."""
        phase = timer.phase

        @contextlib.contextmanager
        def counted(name):
            import torch

            peaks = self.track_peaks and torch.cuda.is_available()
            if peaks:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            k0 = self._counts()
            outer, self.current = self.current, name
            try:
                with phase(name):
                    yield
            finally:
                self.current = outer
                for k, v in self._counts().items():
                    self.launches[name][k] += v - k0[k]
                if peaks:
                    self.peaks[name] = max(self.peaks.get(name, 0),
                                           torch.cuda.max_memory_allocated())

        timer.phase = counted

    def wrap(self, module, name: str, models=lambda a: 1, on_call=None):
        """module.name counted as one step of models(args) models, and
        on_call(args, kwargs, result) after each call; returns the
        original."""
        fn = getattr(module, name)

        def counted(*a, **kw):
            self.steps[self.current] += 1
            self.model_steps[self.current] += models(a)
            out = fn(*a, **kw)
            if on_call is not None:
                on_call(a, kw, out)
            return out

        setattr(module, name, counted)
        return fn

    def _step_tile_args(self, a, kw, out) -> None:
        """A step's tile arguments (keyword-only in every step function)."""
        ta = kw.get("tile_args")
        ta = None if ta is None else dict(ta)
        if self._stepped and ta != self.train_tile_args:
            self.growths.append({"phase": self.current,
                                 "step": self.steps[self.current],
                                 "tile_args": ta})
        self._stepped = True
        self.tile_args[self.current] = self.train_tile_args = ta

    def _single_step(self, a, kw, out) -> None:
        """A gaussian_train_step: its tile arguments and the drops it
        reports."""
        import torch

        self._step_tile_args(a, kw, out)
        m = out[2]
        d = torch.stack([m["n_dropped_m"], m["n_dropped_tile"]]).long()
        acc = self._drops.get(self.current)
        self._drops[self.current] = d if acc is None else acc + d

    def wrap_steps(self) -> list:
        """Wrap the step functions the trainer calls: Phase A's batched
        steps (models: the targets' or tangents' leading axis) and
        gaussian_train_step, and count the trainer's opacity resets.
        Returns [(module, name, original)]."""
        from ..train import phase_a
        from ..train import step as step_lib

        reset = step_lib.reset_opacity

        def counted_reset(*a, **kw):
            self.resets[self.current] += 1
            return reset(*a, **kw)

        step_lib.reset_opacity = counted_reset
        return [(m, n, self.wrap(m, n, size, on)) for m, n, size, on in (
            (phase_a, "fit_step", lambda a: a[3].shape[0],
             self._step_tile_args),
            (phase_a, "pose_step", lambda a: a[1].shape[0],
             self._step_tile_args),
            (step_lib, "gaussian_train_step", lambda a: 1,
             self._single_step))] + [(step_lib, "reset_opacity", reset)]

    def _record(self, trainer, bundle, tag: str, frames) -> None:
        st = bundle.state
        dup = dict(trainer._tile_args or ()).get("dup_factor", 16)
        self.bundles.append({
            "tag": tag, "frames": [min(frames), max(frames)],
            "live": int(st.n_live()), "capacity": st.capacity,
            "M": max(int(round(st.capacity * dup)), 1)})

    def watch_trainer(self, cls) -> list:
        """On every `cls` (an HTGaussianTrainer class): count under its
        timer's phases from `hierarchical_training` on (the trainer is
        kept as self.trainer), and record each bundle it saves as a crumb
        (its tag, "lv{level}_seg{i}") or merges ("merge").
        Returns [(cls, name, original)]."""
        train = cls.hierarchical_training
        save = cls._save_bundle_breadcrumb
        merge = cls.merge_two
        counter = self

        def hierarchical_training(tr, *a, **kw):
            counter.trainer = tr
            counter.attach(tr.timer)
            return train(tr, *a, **kw)

        def save_crumb(tr, bundle, tag):
            save(tr, bundle, tag)
            counter._record(tr, bundle, tag, bundle.to_visit_frames)

        def merge_two(tr, dst, src, transform):
            merge(tr, dst, src, transform)
            counter._record(tr, dst, "merge",
                            dst.to_visit_frames + src.to_visit_frames)

        for name, fn in (("hierarchical_training", hierarchical_training),
                         ("_save_bundle_breadcrumb", save_crumb),
                         ("merge_two", merge_two)):
            setattr(cls, name, fn)
        return [(cls, "hierarchical_training", train),
                (cls, "_save_bundle_breadcrumb", save),
                (cls, "merge_two", merge)]

    @staticmethod
    def restore(originals: list) -> None:
        for owner, name, fn in originals:
            setattr(owner, name, fn)

    def drop_counts(self) -> Dict[Optional[str], Dict[str, int]]:
        """Entries dropped per phase: at M ("m") and at a tile's K
        ("tile"), summed over the phase's single steps."""
        return {k: {"m": int(v[0]), "tile": int(v[1])}
                for k, v in self._drops.items()}

    def table(self, timer: PhaseTimer) -> Dict[str, dict]:
        """Per phase of timer: seconds, entries into the phase, steps,
        model-steps, ms per step, launches, drops, the tile arguments of
        its last step, the opacity resets and, when tracked, the peak of
        allocated device memory."""
        summary, drops = timer.summary(), self.drop_counts()
        out = {}
        for name, ph in summary.items():
            n = self.steps[name]
            out[name] = {
                "s": ph["total_s"], "count": ph["count"], "steps": n,
                "model_steps": self.model_steps[name],
                "ms_per_step": (round(1e3 * ph["total_s"] / n, 3)
                                if n else None),
                "launches": dict(self.launches[name]),
                "drops": drops.get(name, {"m": 0, "tile": 0}),
                "tile_args": self.tile_args.get(name),
                "opacity_resets": self.resets[name],
                **({"peak_gib": self.peaks[name] / 2**30}
                   if name in self.peaks else {})}
        return out


def blend_work(ent, meta, ncon, P: int) -> dict:
    """What the blend kernels' bound and instruction floor divide by, for
    entry lists ent [T, K, 16] / meta [T, 4] and the forward's kept-entry
    counts ncon [T, P] (P pixels a tile): K1's entry-pixel evaluations (a
    pixel evaluates its kept entries and the one that stops it, within its
    tile's count) and the bytes it must move; K2's kept entry-pixels (its
    replay), its entry-pixel slots (its moment pass runs every pixel of a
    tile over the entries up to the tile's last kept one) and its bytes."""
    import torch

    T, K, _ = ent.shape
    cnt = meta[:, 0].long().clamp(max=K)
    last = torch.minimum(ncon.amax(dim=1), cnt.float()).sum().item()
    return dict(
        n_eval=torch.minimum(cnt[:, None].float(), ncon + 1).sum().item(),
        fwd_bytes=cnt.sum().item() * 64 + T * 16 + T * P * 6 * 4,
        n_kept=ncon.sum().item(), n_slot=last * P,
        bwd_bytes=last * 64 + T * 16 + T * P * 7 * 4 + T * K * 64)


def tile_lists(state, camera, tile_args):
    """The binning of one render of state through camera at tile_args, as
    a train step's render bins it: (ent, meta, total, n_dropped_m,
    n_dropped_tile, n_dropped_compact)."""
    import torch

    from ..raster.projection import project
    from ..raster.tiled import build_tile_lists

    with torch.no_grad():
        proj = project(state.means, state.log_scales, state.quats,
                       state.opacity_logit, state.sh_dc, state.sh_rest,
                       state.live, camera,
                       state.active_sh_degree.reshape(-1)[0],
                       state.max_sh_degree)
        return build_tile_lists(proj, camera.height, camera.width,
                                **dict(tile_args or {}))


def binning_fill(state, camera, tile_args):
    """How full the binning of one render is at tile_args: the entries the
    Gaussians emit (the render's n_entries) against its M slots, the
    entries the tiles keep (the sum of meta[:, 0]) and the drops at K and
    at M. Returns (record, ent, meta)."""
    ent, meta, total, nd_m, nd_tile, _ = tile_lists(state, camera,
                                                    tile_args)
    ta = dict(tile_args or {})
    # build_tile_lists' default dup_factor
    M = max(int(round(state.capacity * ta.get("dup_factor", 16))), 1)
    rec = {"T": ent.shape[0], "K": ent.shape[1], "M": M,
           "n_entries": int(total), "filled": min(int(total), M),
           "kept": int(meta[:, 0].long().sum()),
           "dropped_tile": int(nd_tile), "dropped_m": int(nd_m)}
    return rec, ent, meta


def _copied(obj):
    """A dataclass with every tensor in it (in dicts too) cloned."""
    import torch

    def c(v):
        if isinstance(v, torch.Tensor):
            return v.clone()
        return {k: c(u) for k, u in v.items()} if isinstance(v, dict) else v

    return dataclasses.replace(obj, **{f.name: c(getattr(obj, f.name))
                                       for f in dataclasses.fields(obj)
                                       if f.init})


def root_step(trainer, bundle, frame: int = 0) -> dict:
    """gaussian_train_step's arguments, tile_args aside, for one step of a
    trained bundle on `frame` as the trainer's MSS steps take it (its
    learning rates at iteration 1, its render mode), on copies of the
    bundle's state and optimizer: a timed or profiled step leaves the
    bundle as it was."""
    return dict(state=_copied(bundle.state), opt=_copied(bundle.opt),
                camera=trainer.camera_for(frame, pose=bundle.get_RT(frame)),
                gt_image=trainer.device_frame("rgb", frame),
                lrs=trainer._lrs(1, bundle), mode=trainer._mode)


def root_tile_args(trainer, counter: StepCounter) -> dict:
    """The two sets of tile arguments a trained root is timed at: "train",
    those of the last training step (counter.train_tile_args), and "eval",
    the eval sweep's (`settle_eval_tile_args` grows trainer._tile_args
    after training, up to K = 16,384)."""
    return {"train": counter.train_tile_args,
            "eval": dict(trainer._tile_args) if trainer._tile_args
            else None}


# The port's layers, by the span of the step that runs an op: an op counts
# in the layer of the innermost layer span around it. A backward op counts
# in the layer of the forward op whose autograd node it runs, with the
# blend's backward as K2. (torch 2.11's profiler records no Python stacks
# for the ops.)
LAYERS = ("projection + SH", "binning", "K1", "K2", "assemble", "loss",
          "Adam", "densify stats", "other")
_SPAN_LAYER = {"projection": "projection + SH", "binning": "binning",
               "blend": "K1", "assemble": "assemble", "loss": "loss",
               "adam": "Adam", "stats": "densify stats"}
# every span a step opens: their ranges are not ops
_STEP_SPANS = frozenset(_SPAN_LAYER) | {"step", "backward"}


def _span_layer(evt) -> Optional[str]:
    """The layer of the innermost layer span around a forward op."""
    while evt is not None:
        if evt.name in _SPAN_LAYER:
            return _SPAN_LAYER[evt.name]
        evt = evt.cpu_parent
    return None


def _node_op(name: str) -> str:
    """'MulBackward0' and 'aten::mul' -> 'mul'; '_BlendBackward' and
    '_Blend' -> 'blend'."""
    return re.sub(r"Backward\d*$", "", name.split("::")[-1]).replace(
        "_", "").lower()


def layer_times(events) -> Dict[str, dict]:
    """Device ms of a profile's kernels by the port's layer (forward and
    backward; the profile taken under `tracing()`) and, in the
    binning, by the op that launched them. K1 and K2 go by kernel name;
    what no range claims is "other"."""

    def backward_node(e):
        while e is not None:
            if e.scope == 1:   # RecordScope BACKWARD_FUNCTION
                return e
            e = e.cpu_parent
        return None

    fwd = defaultdict(list)
    for e in events:
        if e.sequence_nr >= 0 and backward_node(e) is None \
                and e.name not in _STEP_SPANS:
            fwd[(e.sequence_nr, e.thread)].append(e)

    def layer_of(e):
        node = backward_node(e)
        if node is None:
            return _span_layer(e), "fwd"
        cands = fwd.get((node.sequence_nr, node.fwd_thread), [])
        named = [c for c in cands if _node_op(c.name) == _node_op(node.name)]
        pick = (named or cands)[-1:]
        layer = _span_layer(pick[0]) if pick else None
        return ("K2" if layer == "K1" else layer), "bwd"

    out = {k: {"ms": 0.0, "fwd_ms": 0.0, "bwd_ms": 0.0} for k in LAYERS}
    binning_ops: Counter = Counter()
    for e in events:
        if not e.kernels:
            continue
        layer, way = layer_of(e)
        for k in e.kernels:
            name = ("K1" if "blend_fwd" in k.name else
                    "K2" if "blend_bwd" in k.name else layer or "other")
            ms = k.duration / 1e3
            out[name]["ms"] += ms
            out[name][f"{way}_ms"] += ms
            if name == "binning":
                binning_ops[f"{e.name} ({way})"] += ms
    return {"layers": out, "binning_ops": dict(binning_ops.most_common(8))}


def profile_step(step: dict, tile_args, label: str,
                 path: Optional[str] = None,
                 step_ms: Optional[float] = None) -> dict:
    """One gaussian_train_step of `step` (root_step's arguments, or any
    state's) at tile_args under torch.profiler and `tracing()`, its
    spans without counters (a count launches kernels of its own). Prints
    and returns the device busy time (as a share of the profiled step and
    of the unprofiled step_ms), the 12 kernels that take the most device
    time and the device time by layer (`layer_times`); writes the
    profiler's table by device time to `path` when given. On the card
    only."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..train import step as step_lib

    def one():
        step_lib.gaussian_train_step(**step, tile_args=tile_args)
        torch.cuda.synchronize()

    one()
    with tracing(counters=False), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one()
        wall_ms = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    # device-side rows only (kernels, copies): the operator rows repeat
    # their kernels' time, and so do the spans' device rows
    kernels = [e for e in avgs if e.device_type == DeviceType.CUDA
               and e.key not in _STEP_SPANS]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not busy_ms:
        raise RuntimeError(f"profile [{label}]: no device time recorded")
    if path:
        with open(path, "w") as f:
            f.write(avgs.table(sort_by="self_device_time_total",
                               row_limit=60))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    rec = {"label": label, "tile_args": tile_args,
           "profiled_ms": wall_ms, "busy_ms": busy_ms,
           "busy_share_profiled": busy_ms / wall_ms,
           "busy_share": busy_ms / step_ms if step_ms else None,
           "top": [{"kernel": e.key, "ms": e.self_device_time_total / 1e3,
                    "calls": e.count} for e in top],
           **layer_times(prof.events())}
    # kernels that no op on the host claims (the profiler links none)
    rec["layers"]["other"]["ms"] += busy_ms - sum(
        v["ms"] for v in rec["layers"].values())
    share = (f", {100 * busy_ms / step_ms:.1f}% of the unprofiled step "
             f"({step_ms:.2f} ms)" if step_ms else "")
    print(f"profile [{label}]: device busy {busy_ms:.3f} ms = "
          f"{100 * busy_ms / wall_ms:.1f}% of the profiled step "
          f"({wall_ms:.2f} ms){share}" + (f"; table in {path}" if path
                                          else ""))
    for t in rec["top"]:
        print(f"profile [{label}]: {t['ms']:8.3f} ms x{t['calls']:<4d} "
              f"{t['kernel'][:90]}")
    print(f"profile [{label}] by layer, device ms (fwd + bwd): " + "; ".join(
        f"{k} {v['ms']:.3f} ({v['fwd_ms']:.3f} + {v['bwd_ms']:.3f})"
        for k, v in sorted(rec["layers"].items(), key=lambda kv: -kv[1]["ms"])))
    print(f"profile [{label}] binning by op, device ms: " + "; ".join(
        f"{k} {v:.3f}" for k, v in rec["binning_ops"].items()))
    return rec


def root_step_figures(trainer, bundle, counter: StepCounter, label: str,
                      profile: bool = False,
                      path: Optional[str] = None) -> dict:
    """A trained root's step timed (`host_share`) at the training's tile
    arguments and at the eval sweep's (`root_tile_args`), each printed with
    its K; with `profile`, the step at the training's arguments also under
    `profile_step`, with the binning's fill at those arguments
    (`binning_fill`, frame 0). On the card only."""
    from ..train import step as step_lib

    step = root_step(trainer, bundle)
    args = root_tile_args(trainer, counter)
    rec = {"train_tile_args": args["train"], "eval_tile_args": args["eval"]}
    for key in ("train", "eval"):
        ms, device_ms = host_share(lambda: step_lib.gaussian_train_step(
            **step, tile_args=args[key]))
        k = dict(args[key] or {}).get("max_per_tile")
        rec[f"root_step_{key}"] = {"K": k, "ms": ms, "device_ms": device_ms}
        print(f"{label}: root gaussian_train_step at the "
              f"{'training' if key == 'train' else 'eval sweep'}'s tile "
              f"args {args[key]} (K = {k}): median {ms:.3f} ms, device "
              f"busy {device_ms:.3f} ms ({100 * device_ms / ms:.1f}%), host "
              f"share {100 * (1 - device_ms / ms):.1f}%")
    if profile:
        fill, _, _ = binning_fill(step["state"], step["camera"],
                                  args["train"])
        print(f"{label}: binning at the training's tile args, frame 0: "
              f"{fill['n_entries']} entries emitted into M = {fill['M']} "
              f"slots ({fill['filled']} filled, "
              f"{100 * fill['filled'] / fill['M']:.2f}%), {fill['kept']} "
              f"kept in T = {fill['T']} tiles of K = {fill['K']}, dropped "
              f"{fill['dropped_tile']} at K and {fill['dropped_m']} at M")
        rec["binning"] = fill
        rec["profile"] = profile_step(step, args["train"], label, path,
                                      rec["root_step_train"]["ms"])
    return rec
