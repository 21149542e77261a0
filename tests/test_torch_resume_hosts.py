"""ht3dgs_torch's multi-rank trainer as on hosts that share no disk, on 2
gloo CPU ranks (port only):

- resume: each rank trains in a directory of its own, and only rank 0's
  keeps the crumbs and Phase A's partial poses of a stopped run; rank 0
  reads them and broadcasts what it found, so the resumed run ends with
  the uninterrupted run's root, poses and generator on both ranks. The
  2 x 2 configuration on 2 ranks runs the leaves and level 1 on rank 0
  alone and the root on a 1 x 2 mesh (the 4-rank resume of
  tests/test_torch_parallel_train.py covers the mesh's leaf chunks);
- a rank-0-only section that outlasts the process-group timeout: rank 1
  waits on the section group and ends with rank 0's state, and the same
  wait on the main group raises.

Each case starts its ranks through ht3dgs_torch's spawn, one torch thread
per rank."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ht3dgs_torch.parallel import checks  # noqa: E402
from ht3dgs_torch.parallel import mesh as t_mesh  # noqa: E402
from test_torch_parallel_train import (assert_resumed,  # noqa: E402
                                       train_and_resume)

from port_utils import torch_threads_per_worker  # noqa: E402,F401

# a rank-0-only section longer than the process-group timeout
SECTION_S, PG_TIMEOUT_S = 5.0, 2.0


def test_resume_from_rank0_files_two_ranks(tmp_path_factory):
    """The leaves and level 1 run on rank 0 alone, and their crumbs lie in
    its directory only; the resumed run takes them from rank 0."""
    a, c = train_and_resume(tmp_path_factory, 2, n_frames=10)
    assert {"leaf", "nonleaf_phase1", "nonleaf_parallel"} <= set(
        a[0]["phases"])
    assert "leaf" not in c[0]["phases"]
    assert_resumed(a, c)


def _section(section_group):
    return t_mesh.spawn(checks.rank0_section, 2, device="cpu",
                        args=(SECTION_S, section_group), timeout=60.0,
                        pg_timeout=PG_TIMEOUT_S)


def test_rank0_section_outlasts_process_group_timeout():
    """Rank 0 works 5 s alone under a 2 s process-group timeout: rank 1
    waits on the section group, and both end with rank 0's state."""
    r0, r1 = _section(True)
    assert r0["out"] == "rank 0's result" and r1["out"] is None
    assert r0["global_iteration"] == r1["global_iteration"] == 123
    assert r0["rng"] == r1["rng"]
    np.testing.assert_array_equal(r0["gen"], r1["gen"])
    np.testing.assert_array_equal(r1["pose_dict"]["rel_pose_0_to_1"],
                                  np.full((4, 4), 7.0, np.float32))


def test_rank0_section_on_main_group_times_out():
    """Without the section group, rank 1 waits in the main group's
    broadcast and its 2 s timeout ends the run."""
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        _section(False)
