"""Tiny cells for the CPU: each cell of BENCHMARK.json with its scene cut
to 64x48 and its job to a few steps a round, rendering through the port's
tiled path (its plain blend on the CPU)."""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os

import torch

from htbench import run

from .conftest import ROOT


def cell(name: str, root: str = ROOT) -> dict:
    c = run.cell(root, name)
    c["config"]["scene"].update(height=48, width=64, n_frames=12)
    c["config"]["PipelineParams"].update(phase_a_batch=2,
                                         render_mode="tiled")
    t = c["traffic"]
    for k, v in (("fit_iters", 2), ("pose_iters", 1), ("rows", 3000),
                 ("steps_per_call", 2)):
        if k in t:
            t[k] = v
    return c


def ctx(name: str, seed: int = 7):
    c = cell(name)
    return run.Ctx(c["workload"], c["config"], c["traffic"], seed,
                   torch.device("cpu"))


def result(c: dict, seed: int = 2 ** 31 + 11, trace: int = 0,
           seconds: float = 0.5, tmp: str = "."):
    """Run a tiny cell through the harness (its look for a chip skipped):
    (exit code, stdout, stderr); the trainer's files go under tmp."""
    args = argparse.Namespace(seed=seed, seconds=seconds, trace=trace)
    out, err = io.StringIO(), io.StringIO()
    here = os.getcwd()
    os.chdir(tmp)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = run._run(args, c, torch.device("cpu"))
    finally:
        os.chdir(here)
    return rc, out.getvalue(), err.getvalue()


def last_line(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])
