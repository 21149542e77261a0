"""The readings a cell's limits are set from, on the card:

    python3 -m htbench.calibrate --workload <cell> --seeds 1,2,... \
        [--control 1,2,3] [--faults 1,2,3] [--out FILE]

For each seed of --seeds, the port's compared steps against the reference
(the lower readings). For each seed of --control, the reference computed
in TF32 (`reference/precision.py`) put in the port's place (the control).
For each seed of --faults, the port with each fault its cell's job can
show (`faults.of`) planted. One JSON line a reading, to stdout and to
--out. No window runs: the compared steps are the set-up's."""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import tempfile
import time

import torch

from . import compare, faults
from .reference import precision as ref_precision
from .run import Ctx, cell


def _seeds(s):
    return [int(x) for x in s.split(",") if x] if s else []


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = os.getcwd()
    c = cell(root, args.workload)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    mod = __import__(f"htbench.jobs.{c['traffic']['job']}",
                     fromlist=["Job"])
    out = open(args.out, "a") if args.out else None
    os.chdir(tempfile.mkdtemp(prefix="htbench-", dir=os.environ.get("TMPDIR")))

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def program(seed, fault=None):
        ctx = Ctx(c["workload"], c["config"], c["traffic"], seed, device)
        t0 = time.perf_counter()
        if fault:
            with faults.planted(fault):
                job = mod.Job(ctx)
        else:
            job = mod.Job(ctx)
        t1 = time.perf_counter()
        readings = job.readings
        job.release()
        gc.collect()
        torch.cuda.empty_cache()
        return job, readings, t1 - t0

    refs = {}
    for seed in _seeds(args.seeds):
        job, port, setup = program(seed)
        t0 = time.perf_counter()
        ref = job.reference()
        refs[seed] = (job, ref)
        emit({"kind": "port", "seed": seed, "gaps": compare.gaps(port, ref),
              "setup_s": setup, "reference_s": time.perf_counter() - t0,
              "port": port, "ref": ref})
    for seed in _seeds(args.control):
        job, ref = refs.get(seed) or (None, None)
        if job is None:
            job, _, _ = program(seed)
            ref = job.reference()
        with ref_precision.tf32():
            ctl = job.reference()
        emit({"kind": "control", "seed": seed,
              "gaps": compare.gaps(ctl, ref), "control": ctl})
    for seed in _seeds(args.faults):
        job, ref = refs.get(seed) or (None, None)
        if job is None:
            job, _, _ = program(seed)
            ref = job.reference()
        for f in faults.of(mod):
            _, port, _ = program(seed, f)
            emit({"kind": "fault", "fault": f, "seed": seed,
                  "gaps": compare.gaps(port, ref), "port": port})
    return 0


if __name__ == "__main__":
    sys.exit(main())
