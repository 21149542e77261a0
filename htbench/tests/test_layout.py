"""BENCHMARK.json and the files it names: every piece found by name, the
contract's shape, and a new cell added with new files and one entry."""

import importlib
import json
import os
import re
import shutil

from htbench import run

from . import tiny
from .conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_piece_is_found_by_name():
    b = bench()
    for w in b["workloads"]:
        c = run.cell(ROOT, w["name"])
        importlib.import_module(f"htbench.jobs.{c['traffic']['job']}").Job
        assert set(c["limits"]), w["name"]
        names = [m["name"] for m in c["end_to_end"] + c["per_layer"]]
        assert "setup_s" in names and len(c["per_layer"]) >= 1
        for m in names:
            assert callable(run.reader(m))
    for conf in b["configs"]:
        path = os.path.join(ROOT, conf["file"])
        assert os.path.isfile(path)
        assert any(w["config"] == conf["name"] for w in b["workloads"])


def test_contract_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"}}
    for sec, want in keys.items():
        for e in b[sec]:
            assert set(e) == want, e
            assert NAME.match(e["name"])
            assert 1 <= len(e["why"]) <= 200
    for sec in ("end_to_end", "per_layer"):
        for m in b[sec]:
            assert NAME.match(m["name"]) and m["better"] in ("lower",
                                                             "higher")
            assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {m["layer"] for m in b["per_layer"]}
    assert {"trainer", "device", "step", "projection + SH", "binning",
            "blend", "loss", "optimizer", "densify"} == layers
    e2e = {m["name"] for m in b["end_to_end"]}
    assert all(m["moves"] in e2e for m in b["per_layer"])
    for p in b["paths"]:
        for dirpath, _, files in os.walk(os.path.join(ROOT, p)):
            for f in files:
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
                if "__pycache__" not in rel:
                    assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_a_new_cell_is_new_files_and_one_entry(tmp_path):
    """A cell of its own traffic (a copy of an existing mix with another
    parameter) needs a traffic file, a limits file and a BENCHMARK.json
    entry, and runs."""
    root = tmp_path / "checkout"
    os.makedirs(root / "htbench")
    for d in ("configs", "traffic", "limits"):
        shutil.copytree(os.path.join(ROOT, "htbench", d), root / "htbench" / d)
    b = bench()
    w = dict(b["workloads"][0], name="family.phase_a_b4", traffic="phase_a_b4")
    b["workloads"].append(w)
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    t = json.loads((root / "htbench/traffic/phase_a.json").read_text())
    t["fit_iters"] = 4
    (root / "htbench/traffic/phase_a_b4.json").write_text(json.dumps(t))
    shutil.copy(root / "htbench/limits/family.phase_a.json",
                root / "htbench/limits/family.phase_a_b4.json")
    c = tiny.cell("family.phase_a_b4", root=str(root))
    assert c["traffic"]["job"] == "phase_a"
    rc, out, _ = tiny.result(c, tmp=str(tmp_path))
    assert rc == 0 and tiny.last_line(out)["correct"] is True
