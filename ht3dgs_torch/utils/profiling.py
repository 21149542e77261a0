"""Tracing and phase timing. Counterpart of `ht3dgs.utils.profiling`:
`torch_trace` captures a torch.profiler trace around any block (the
counterpart of `jax_trace`), and `PhaseTimer` keeps the named-phase wall
time and counts that the trainer logs at the end of a run."""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Dict, Optional


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
