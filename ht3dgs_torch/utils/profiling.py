"""Tracing and phase timing. Counterpart of `ht3dgs.utils.profiling`:
`torch_trace` captures a torch.profiler trace around any block (the
counterpart of `jax_trace`), and `PhaseTimer` keeps the named-phase wall
time and counts that the trainer logs at the end of a run. `host_share`
splits a step's wall time on the card into device and host. `StepCounter`
adds, per trainer phase, the steps, the blend kernels' launches, the
farthest-first drops and the size of every bundle the trainer finishes
(`real_image_bench`, `chip_smoke.py`)."""

from __future__ import annotations

import contextlib
import json
import statistics
import time
from collections import Counter, defaultdict
from typing import Dict, List, Optional


class PhaseTimer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
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
    at M and at a tile's K. With `watch_trainer` it also records each
    bundle the hierarchical trainer finishes (a crumb's tag) or merges: its
    live rows, capacity and M = capacity x dup_factor.

    It works by wrapping module functions, so it counts one run at a time;
    `restore` puts the originals back. Drops are summed on the device and
    read once, by `drop_counts`."""

    def __init__(self, timer: Optional[PhaseTimer] = None):
        self.current = None
        self.steps: Counter = Counter()
        self.model_steps: Counter = Counter()
        self.launches: Dict[Optional[str], Counter] = defaultdict(Counter)
        self.bundles: List[dict] = []
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
            k0 = self._counts()
            outer, self.current = self.current, name
            try:
                with phase(name):
                    yield
            finally:
                self.current = outer
                for k, v in self._counts().items():
                    self.launches[name][k] += v - k0[k]

        timer.phase = counted

    def wrap(self, module, name: str, models=lambda a: 1, on_result=None):
        """module.name counted as one step of models(args) models; returns
        the original."""
        fn = getattr(module, name)

        def counted(*a, **kw):
            self.steps[self.current] += 1
            self.model_steps[self.current] += models(a)
            out = fn(*a, **kw)
            if on_result is not None:
                on_result(out)
            return out

        setattr(module, name, counted)
        return fn

    def _add_drops(self, out) -> None:
        import torch

        m = out[2]
        d = torch.stack([m["n_dropped_m"], m["n_dropped_tile"]]).long()
        acc = self._drops.get(self.current)
        self._drops[self.current] = d if acc is None else acc + d

    def wrap_steps(self) -> list:
        """Wrap the step functions the trainer calls: Phase A's batched
        steps (models: the targets' or tangents' leading axis) and
        gaussian_train_step. Returns [(module, name, original)]."""
        from ..train import phase_a
        from ..train import step as step_lib

        return [(m, n, self.wrap(m, n, size, on)) for m, n, size, on in (
            (phase_a, "fit_step", lambda a: a[3].shape[0], None),
            (phase_a, "pose_step", lambda a: a[1].shape[0], None),
            (step_lib, "gaussian_train_step", lambda a: 1,
             self._add_drops))]

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
        model-steps, ms per step, launches and drops."""
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
                "drops": drops.get(name, {"m": 0, "tile": 0})}
        return out
