"""Each cell's window at a tiny size on the CPU, through the port's plain
paths: the reference agrees with the port, and the result line has the
contract's keys, in order, with the compared numbers last."""

import json

import pytest

from htbench import compare

from . import tiny

CELLS = [w["name"] for w in json.load(open(tiny.ROOT + "/BENCHMARK.json"))[
    "workloads"]]
# at 64x48 a pixel whose transmittance stop flips by rounding moves a
# loss by ~1e-4 (at the cells' sizes it moves it by ~1e-7)
TINY = {"loss": 1e-3, "pose_loss": 1e-3, "grad": 1e-3, "pose_grad": 1e-2,
        "change": 1e-3, "pose_change": 1e-2, "stats_accum": 1e-3,
        "stats_denom": 1e-3, "densify_rows": 1e-3}


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_port(name, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    ctx = tiny.ctx(name)
    job = __import__(f"htbench.jobs.{ctx.traffic['job']}",
                     fromlist=["Job"]).Job(ctx)
    steps, mpix = job.round()
    assert steps > 0 and mpix > 0
    port = job.readings
    job.release()
    got = compare.gaps(port, job.reference())
    for k, v in got.items():
        assert v <= TINY.get(k, 0.0), (k, v)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(name, trace, tmp_path):
    c = tiny.cell(name)
    rc, out, err = tiny.result(c, trace=trace, tmp=str(tmp_path))
    assert rc == 0, err
    r = tiny.last_line(out)
    want = ["correct", "attempted", "failed", "metrics", "device"] + (
        ["breakdown"] if trace else []) + ["checks"]
    assert list(r) == want
    assert r["correct"] is True and r["failed"] == 0
    names = {m["name"] for m in (c["per_layer"] if trace
                                 else c["end_to_end"])}
    assert set(r["metrics"]) <= names
    if not trace:
        assert set(r["metrics"]) == names
    assert set(r["checks"]) == set(c["limits"])
    # the compared numbers are the last lines of standard error too
    tail = err.strip().splitlines()[-len(c["limits"]):]
    assert all(line.startswith("htbench check ") for line in tail)
