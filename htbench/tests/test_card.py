"""On the card: the control (the reference in TF32,
`reference/precision.py`, put in the port's place) is caught by the cells'
limits at a size a test run holds, on three seeds; and a small traced run
of each cell through the harness on the device. Run with
`python -m pytest htbench/tests -q -m card`."""

import json

import pytest

from htbench import compare, run
from htbench.reference import precision

from . import tiny
from .test_cells import CELLS


def _small(name, device):
    c = run.cell(tiny.ROOT, name)
    c["config"]["scene"].update(height=288, width=512)
    c["config"]["PipelineParams"].update(phase_a_batch=2)
    if "rows" in c["traffic"]:
        c["traffic"]["rows"] = 40000
    return c


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_is_caught(name, card, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    c = _small(name, card)
    fails = 0
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        ctx = run.Ctx(c["workload"], c["config"], c["traffic"], seed, card)
        job = __import__(f"htbench.jobs.{c['traffic']['job']}",
                         fromlist=["Job"]).Job(ctx)
        job.release()
        ref = job.reference()
        with precision.tf32():
            ctl = job.reference()
        got = compare.gaps(ctl, ref)
        fails += any(got[k] > lim for k, lim in c["limits"].items())
    assert fails == 3


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_small_run_on_the_card(name, card, tmp_path):
    c = _small(name, card)
    args = __import__("argparse").Namespace(seed=2 ** 31 + 9, seconds=2.0,
                                            trace=1)
    import contextlib
    import io
    import os
    out = io.StringIO()
    here = os.getcwd()
    os.chdir(tmp_path)
    try:
        with contextlib.redirect_stdout(out):
            rc = run._run(args, c, card)
    finally:
        os.chdir(here)
    assert rc == 0
    r = json.loads(out.getvalue().strip().splitlines()[-1])
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
