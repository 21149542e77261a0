"""What a run may load: no `jax`, `jaxlib`, `flax` or JAX package in the
process (top-level names compared whole, so `ht3dgs_torch` passes), and a
reference that imports nothing of the port."""

import ast
import os
import subprocess
import sys

from htbench import run

from .conftest import ROOT

CHECK = """
import sys, tempfile, os
sys.path.insert(0, {root!r})
from htbench.tests import tiny
for name in {cells!r}:
    rc, out, err = tiny.result(tiny.cell(name), tmp=tempfile.mkdtemp())
    assert rc == 0, err
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ht3dgs_torch_extra", sys)
    assert "ht3dgs_torch_extra" not in str(run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in run.forbidden_modules()


def test_a_run_loads_no_jax(tmp_path):
    from .test_cells import CELLS

    code = CHECK.format(root=ROOT, cells=CELLS)
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=tmp_path, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "ht3dgs_torch" in loaded
    assert not loaded & set(run.FORBIDDEN), loaded & set(run.FORBIDDEN)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_yardstick_imports_nothing_of_the_port():
    """The reference, the comparison, the reckoning and the scene."""
    files = [os.path.join(ROOT, "htbench", "reference", f)
             for f in os.listdir(os.path.join(ROOT, "htbench", "reference"))
             if f.endswith(".py")]
    files += [os.path.join(ROOT, "htbench", f)
              for f in ("compare.py", "reckon.py", "scene.py")]
    for f in files:
        for name in _imports(f):
            assert name.split(".")[0] not in ("ht3dgs_torch", "jax",
                                              "ht3dgs", "flax"), (f, name)
    code = ("import sys; sys.path.insert(0, %r); import htbench.reference."
            "splat, htbench.reference.train, htbench.reference.loss, "
            "htbench.compare, htbench.reckon, htbench.scene; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "ht3dgs_torch" not in eval(out.stdout.strip().splitlines()[-1])


def test_the_command_refuses_without_a_card(tmp_path):
    """On a machine without CUDA (this one) the command exits non-zero and
    prints no result."""
    import torch

    if torch.cuda.is_available():
        import pytest
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run(
        [sys.executable, "-m", "htbench.run", "--workload",
         "family.phase_a", "--seed", str(2 ** 31 + 5), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
