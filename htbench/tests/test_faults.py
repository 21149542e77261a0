"""Each fault a cell can have, planted under a tiny run of it: `correct`
comes out false."""

import importlib

import pytest

from htbench import faults

from . import tiny
from .test_cells import CELLS


def _pairs():
    for name in CELLS:
        job = importlib.import_module(
            "htbench.jobs." + tiny.cell(name)["traffic"]["job"])
        for fault in faults.of(job):
            yield name, fault


@pytest.mark.parametrize("name,fault", list(_pairs()))
def test_fault_is_caught(name, fault, tmp_path):
    c = tiny.cell(name)
    with faults.planted(fault):
        rc, out, err = tiny.result(c, tmp=str(tmp_path))
    assert rc == 0, err
    r = tiny.last_line(out)
    assert r["correct"] is False and r["failed"] >= 1, r["checks"]
