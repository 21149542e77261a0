"""Run one cell of the port's benchmark once.

    python3 -m htbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Everything a cell is made of is found by name
from BENCHMARK.json: its configuration file (`configs/<config>.json`), its
traffic (`traffic/<traffic>.json`, which names a job of `jobs/` and its
parameters), its limits (`limits/<cell>.json`) and a reader of
`metrics/<metric>.py` for each metric. The run:
1. refuses without a CUDA device (or with fewer than the cell asks for);
2. sets up: the scene from the seed, the port's trainer and models, and the
   compared first steps, which are also the warm-up (`setup_s` ends here);
3. measures for --seconds: whole rounds of the job, each ending in a
   synchronise, until the time is up; with --trace 1 the window opens with
   `trace_rounds` rounds (a parameter of the traffic) traced on the device
   alone (the traced window) and as many traced by layer;
4. with --trace 1, profiles one more step and counts its work;
5. frees the port's state and runs the plain reference over the compared
   steps; each compared number is printed beside its limit;
6. prints the result as the last line of standard output.
The trainer's files go to a directory under TMPDIR, removed at the end.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "ht3dgs")


class Ctx:
    def __init__(self, workload, config, traffic, seed, device):
        self.workload, self.config, self.traffic = workload, config, traffic
        self.seed, self.device = seed, device


def _json(path):
    with open(path) as f:
        return json.load(f)


def cell(root: str, name: str) -> dict:
    """The cell `name` of BENCHMARK.json with every piece it names: its
    workload entry, configuration, traffic, limits and metric lists."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return {"workload": wl,
            "config": _json(os.path.join(root, conf["file"])),
            "traffic": _json(os.path.join(root, "htbench", "traffic",
                                          wl["traffic"] + ".json")),
            "limits": _json(os.path.join(root, "htbench", "limits",
                                         name + ".json")),
            "end_to_end": mine(bench["end_to_end"]),
            "per_layer": mine(bench["per_layer"])}


def reader(metric: str):
    """The read function of htbench/metrics/<metric>.py, loaded by its
    path (a name may hold dots). A metric `<name>.<part>` without a file of
    its own is read by the reader of `<name>`: the same quantity in cells
    that report another end-to-end metric."""
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "metrics")
    name = metric
    while not os.path.isfile(os.path.join(here, name + ".py")):
        if "." not in name:
            raise FileNotFoundError(f"no reader for metric {metric!r}")
        name = name.rsplit(".", 1)[0]
    spec = importlib.util.spec_from_file_location(
        "htbench.metrics." + name.replace(".", "_"),
        os.path.join(here, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def checks(port: dict, ref: dict, limits: dict):
    from . import compare

    got = compare.gaps(port, ref)
    missing = set(limits) - set(got)
    if missing:
        raise KeyError(f"limits without a reading: {sorted(missing)}")
    return [(k, got[k], limits[k]) for k in sorted(limits)]


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _profile(cpu: bool):
    import torch

    acts = []
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    if cpu or not acts:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    return torch.profiler.profile(activities=acts)


def measure(job, seconds: float, device, traced_rounds: int = 0):
    """Whole rounds until `seconds` have passed: (steps, megapixels,
    seconds, trace, plain). With traced_rounds, the window opens with that
    many rounds traced on the device alone and as many traced with the
    host's operations under the layer ranges (`htbench.trace`), and `trace`
    is their reduction with the first's steps and seconds (None without);
    at least one untraced round follows them. The traced windows are timed
    inside the profiler, whose start and stop take seconds of their own;
    the window's seconds count their rounds, not that. `plain` is the
    (steps, seconds) of the untraced rounds."""
    from . import trace

    steps, mpix, traced = 0, 0.0, None
    sync(device)
    t0 = time.perf_counter()
    if traced_rounds:
        with _profile(cpu=False) as prof:
            sync(device)
            ta = time.perf_counter()
            for _ in range(traced_rounds):
                n, mp = job.round()
                steps += n
                mpix += mp
            sync(device)
            t_dev = time.perf_counter() - ta
        traced = dict(trace.device_time(prof), steps=steps, window_s=t_dev)
        del prof
        n_layer = 0
        with trace.layer_ranges(), _profile(cpu=True) as prof:
            sync(device)
            ta = time.perf_counter()
            for _ in range(traced_rounds):
                n, mp = job.round()
                n_layer += n
                mpix += mp
            sync(device)
            t_layer = time.perf_counter() - ta
        steps += n_layer
        traced.update(layers_s=trace.layer_time(prof), layer_steps=n_layer)
        del prof
        t0 = time.perf_counter() - t_dev - t_layer
    t_plain, n_plain = time.perf_counter(), 0
    while time.perf_counter() - t0 < seconds or not n_plain:
        n, mp = job.round()
        sync(device)
        n_plain += n
        mpix += mp
    t1 = time.perf_counter()
    return (steps + n_plain, mpix, t1 - t0, traced,
            (n_plain, t1 - t_plain))


def reckon(job, device):
    """One more step profiled, with the work its views need."""
    from . import reckon as rk
    from . import trace

    run, views = job.reckon_step()
    with trace.layer_ranges(), _profile(cpu=True) as prof:
        run()
        sync(device)
    return {"profiled_work": rk.work(views),
            "profiled_layers_s": trace.layer_time(prof)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = os.getcwd()
    if root not in sys.path:
        sys.path.insert(0, root)
    c = cell(root, args.workload)
    cache = os.path.join(root, "htbench_cache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                          os.path.join(cache, "inductor"))
    os.environ["USE_FLAX"] = "0"

    import torch

    chips = int(c["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"htbench: cell {args.workload} needs {chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    # the port computes in float32 with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    work = tempfile.mkdtemp(prefix="htbench-", dir=os.environ.get("TMPDIR"))
    here = os.getcwd()
    os.chdir(work)
    try:
        return _run(args, c, device)
    finally:
        os.chdir(here)
        shutil.rmtree(work, ignore_errors=True)


def _run(args, c, device) -> int:
    """Steps 2 to 6 of a run of cell `c` on `device`. On the CPU (the
    tests' tiny cells, with the port's plain paths) memory reads 0."""
    import torch

    from . import reckon as rk

    cuda = device.type == "cuda"
    job_mod = importlib.import_module(f"htbench.jobs.{c['traffic']['job']}")
    ctx = Ctx(c["workload"], c["config"], c["traffic"], args.seed, device)
    job = job_mod.Job(ctx)
    sync(device)
    setup_s = time.perf_counter() - T0

    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    rounds = int(c["traffic"]["trace_rounds"]) if args.trace else 0
    steps, mpix, window_s, traced, plain = measure(job, args.seconds,
                                                   device, rounds)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    run = {"setup_s": setup_s, "steps": steps, "mpix": mpix,
           "window_s": window_s, "peak_bytes": peak,
           "plain_steps": plain[0], "plain_s": plain[1]}
    device_rec = {"platform": "gpu" if cuda else "cpu",
                  "kind": torch.cuda.get_device_name(device) if cuda
                  else "cpu",
                  "count": int(c["workload"]["chips"]),
                  "memory_peak_bytes": peak}
    breakdown = None
    if args.trace:
        run["trace"] = traced
        run["reckon"] = reckon(job, device)
        device_rec["busy_s"] = traced["busy_s"]
        device_rec["window_s"] = traced["window_s"]
        breakdown = {"device_ops": traced["device_ops"],
                     "idle_gaps": traced["idle_gaps"]}
        work_k = run["reckon"]["profiled_work"]
        print(f"htbench: card {rk.power_limit()}; peaks "
              f"{rk.PEAK_FLOPS / 1e12:g} TFLOP/s f32, "
              f"{rk.PEAK_BYTES / 1e12:g} TB/s ({rk.PEAKS_SOURCE}); "
              f"K1 bound by {rk.bound_by(work_k['K1'])}, K2 by "
              f"{rk.bound_by(work_k['K2'])}")
    if forbidden_modules():
        print(f"htbench: modules loaded that the run may not load: "
              f"{forbidden_modules()}", file=sys.stderr)
        return 3

    port_readings = job.readings
    job.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref_readings = job.reference()
    compared = checks(port_readings, ref_readings, c["limits"])
    correct = all(v <= lim for _, v, lim in compared)

    metrics = {}
    for m in (c["per_layer"] if args.trace else c["end_to_end"]):
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if forbidden_modules():
        print(f"htbench: modules loaded that the run may not load: "
              f"{forbidden_modules()}", file=sys.stderr)
        return 3
    for k, v, lim in compared:
        print(f"htbench check {k}: {v!r} limit {lim!r}", file=sys.stderr)
    result = {"correct": correct, "attempted": steps,
              "failed": sum(v > lim for _, v, lim in compared),
              "metrics": metrics, "device": device_rec}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, v, lim in compared}
    sys.stdout.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
