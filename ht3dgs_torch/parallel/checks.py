"""Rank functions for `mesh.spawn` that run one piece of the multi-device
path on given inputs and return what it computed as numpy arrays, so a
caller can hold the pieces against a single-device run (the parity tests
and the card check drive them). They live in the port, so the processes
that run them import nothing but torch and this package.

Inputs are numpy: state arrays as `interop.state_from_numpy` takes them,
camera arrays as `interop.camera_from_numpy` takes them, images [H, W, 3].
"""

from __future__ import annotations

import numpy as np
import torch

from .. import interop
from ..core import adam as adam_lib
from ..core.gaussians import PARAM_FIELDS
from ..train.losses import (scale_shift_invariant_depth_loss_sharded,
                            ssim_sharded)
from . import gauss_shard, mesh as mesh_lib

_STATS = ("max_radii2d", "grad_accum", "grad_denom")


def _np(x):
    return x.detach().cpu().numpy()


def sequence(rank, jobs):
    """Several rank functions in one process group: jobs is a list of
    (function, args); returns their results in order."""
    return [fn(rank, *args) for fn, args in jobs]


def step_result(state, opt, metrics) -> dict:
    """Parameters, statistics, Adam moments and step, and metrics."""
    out = {f: _np(getattr(state, f)) for f in PARAM_FIELDS + _STATS}
    out.update({f"m_{k}": _np(v) for k, v in opt.m.items()})
    out.update({f"v_{k}": _np(v) for k, v in opt.v.items()})
    out["step"] = int(opt.step)
    out["metrics"] = {k: float(v) for k, v in metrics.items()}
    return out


def loss_shares(rank, img1, img2, pred, gt, device="cpu"):
    """Sharded SSIM and depth loss over a (1, world) mesh: each rank takes
    its row block; returns the summed value and this block's gradient of
    this rank's share (img1 and pred)."""
    mesh = mesh_lib.make_mesh(1, mesh_lib.world_size())
    axis = mesh.tile_axis
    bh = img1.shape[0] // axis.size
    rows = slice(rank * bh, (rank + 1) * bh)

    def t(x, grad=False):
        return torch.tensor(x[rows], device=device, requires_grad=grad)

    a = t(img1, True)
    s = ssim_sharded(a, t(img2), axis, img1.size)
    (ga,) = torch.autograd.grad(s, [a])
    p = t(pred, True)
    d = scale_shift_invariant_depth_loss_sharded(p, t(gt), axis)
    (gp,) = torch.autograd.grad(d, [p])
    vals = axis.all_reduce_(torch.stack([s, d]).detach())
    return {"ssim": float(vals[0]), "ssim_grad": _np(ga),
            "depth": float(vals[1]), "depth_grad": _np(gp)}


def hierarchy_steps(rank, n_segments, n_tiles, segments, calls, height,
                    width, step_kw, device="cpu"):
    """build_hierarchy_step on an S x T mesh. segments[s]: dict(state,
    camera, gt, lrs[, depth]); calls: dicts of step keywords (apply_code,
    track_stats, active as a list over the segments), each call from the
    segment's given state with fresh Adam moments. Returns step_result of
    every call from each segment's first rank, None elsewhere."""
    mesh = mesh_lib.make_mesh(n_segments, n_tiles)
    seg = segments[mesh.segment]
    state = interop.state_from_numpy(seg["state"], device)
    cam = interop.camera_from_numpy(seg["camera"], device)
    gt = torch.tensor(seg["gt"], device=device)
    depth = (torch.tensor(seg["depth"], device=device)
             if seg.get("depth") is not None else None)
    step = mesh_lib.build_hierarchy_step(mesh, height, width, **step_kw)
    out = []
    for c in calls:
        kw = dict(c)
        if "active" in kw:
            kw["active"] = bool(kw["active"][mesh.segment])
        out.append(step_result(*step(
            state, adam_lib.init(state.params()), cam, gt, seg["lrs"],
            depth_gt=depth, **kw)))
    return out if mesh.tile == 0 else None


def gauss_steps(rank, state_arrays, camera, gt, lrs, height, width,
                configs, device="cpu"):
    """build_gauss_sharded_step on a (1, world) mesh, one step per config
    (dict(cull_cap, tile_args)) from the same state with fresh moments.
    Returns this rank's shard of every result, and whether shard_state /
    unshard_state and shard_opt / unshard_opt give back what they took."""
    mesh = mesh_lib.make_mesh(1, mesh_lib.world_size())
    n = mesh.n_tiles
    state = interop.state_from_numpy(state_arrays, device)
    opt = adam_lib.init(state.params())
    shards, opts = (gauss_shard.shard_state(state, n),
                    gauss_shard.shard_opt(opt, n))
    back, back_opt = (gauss_shard.unshard_state(shards),
                      gauss_shard.unshard_opt(opts))
    round_trip = all(torch.equal(getattr(back, f), getattr(state, f))
                     for f in PARAM_FIELDS + _STATS + ("live",)) and all(
        torch.equal(back_opt.m[k], opt.m[k]) for k in opt.m)
    cam = interop.camera_from_numpy(camera, device)
    gt = torch.tensor(gt, device=device)
    out = []
    for c in configs:
        step = gauss_shard.build_gauss_sharded_step(
            mesh, height, width, cull_cap=c["cull_cap"],
            tile_args=c["tile_args"])
        out.append(step_result(*step(shards[mesh.tile], opts[mesh.tile],
                                     cam, gt, lrs)))
    return {"results": out, "round_trip": round_trip}


def gauss_densify(rank, state_arrays, seed, device="cpu"):
    """build_sharded_densify on a (1, world) mesh from hot statistics;
    returns this rank's shard's live mask and means and the summed drop
    count."""
    mesh = mesh_lib.make_mesh(1, mesh_lib.world_size())
    state = interop.state_from_numpy(state_arrays, device)
    sh = gauss_shard.shard_state(state, mesh.n_tiles)[mesh.tile]
    opt = adam_lib.init(sh.params())
    gen = torch.Generator(device=device).manual_seed(seed)
    sh, opt, dropped = gauss_shard.build_sharded_densify(mesh)(
        sh, opt, gen, 0.0002, 0.005, 3.0, 0.01, 20.0, False)
    return {"live": _np(sh.live), "means": _np(sh.means),
            "dropped": int(dropped)}


def state_digest(state) -> str:
    """SHA-256 of a state's tensors, in field order."""
    import hashlib

    h = hashlib.sha256()
    for f in PARAM_FIELDS + _STATS + ("live", "active_sh_degree"):
        h.update(np.ascontiguousarray(_np(getattr(state, f))).tobytes())
    return h.hexdigest()


class _Stop(Exception):
    pass


def hierarchical_training(rank, data_dir, workdir, cfgs, seed=0,
                          device="cpu", stop_before=None):
    """HTGaussianTrainer.hierarchical_training in `workdir` with the
    configs (model, pipe, optim). stop_before: "nonleaf" ends the run where
    the first parallel non-leaf chunk would start (as a crash would, after
    the leaf crumbs). Returns the root state's digest and arrays, its poses,
    frames and iteration count, Phase A's poses, the phase names, this
    rank's train-view PSNR and generator state."""
    import os

    from ..train import hierarchy, parallel_nonleaf

    os.chdir(workdir)
    tr = hierarchy.HTGaussianTrainer(data_dir, *cfgs, seed=seed,
                                     device=mesh_lib.rank_device(device))
    tr.result_path = os.path.abspath(tr.result_path)
    nonleaf = parallel_nonleaf.train_nonleaf_segments_parallel
    if stop_before == "nonleaf":
        def stop(*a, **k):
            raise _Stop

        parallel_nonleaf.train_nonleaf_segments_parallel = stop
    try:
        b = tr.hierarchical_training()
    except _Stop:
        return None
    finally:
        parallel_nonleaf.train_nonleaf_segments_parallel = nonleaf
    return {"digest": state_digest(b.state),
            "state": {f: _np(getattr(b.state, f))
                      for f in PARAM_FIELDS + ("live",)},
            "poses": b.poses, "frames": b.to_visit_frames,
            "global_iteration": tr.global_iteration,
            "pose_dict": dict(tr.pose_dict),
            "phases": sorted(tr.timer.summary()),
            "psnr": tr.evaluate_on_training_images(save_images=False),
            "gen": tr.gen.get_state().numpy(),
            "result_path": tr.result_path}


def run_main(rank, argv, workdir):
    """ht3dgs_torch.run.main(argv, device="cpu") in `workdir`."""
    import os

    from .. import run

    os.chdir(workdir)
    run.main(argv, device="cpu")


def resume_files(result_path) -> list:
    """The crumbs and Phase A's partial poses under a result_path."""
    import glob
    import os

    return sorted(os.path.relpath(f, result_path) for f in
                  glob.glob(os.path.join(result_path, "chkpnt", "crumb_*"))
                  + glob.glob(os.path.join(result_path, "pose",
                                           "pose_partial.npz")))


def train_and_resume(rank, data_dir, workdir, cfgs, device="cpu"):
    """hierarchical_training three times, each rank in a working
    directory of its own (as on hosts that share no disk): A uninterrupted
    in workdir/a/r<rank>; B in workdir/b/r<rank>, from A's Phase A poses
    copied to rank 0's directory alone, ended where the first parallel
    non-leaf chunk would start; C resuming B from rank 0's crumbs. Returns
    A's and C's results, C's with the resume files that B left in this
    rank's directory."""
    import os
    import shutil

    dirs = [os.path.join(workdir, k, f"r{rank}") for k in "ab"]
    for d in dirs:
        os.makedirs(d)
    a = hierarchical_training(rank, data_dir, dirs[0], cfgs, device=device)
    rel = os.path.relpath(a["result_path"], dirs[0])
    if rank == 0:
        os.makedirs(os.path.join(dirs[1], rel, "pose"))
        shutil.copy(os.path.join(dirs[0], rel, "pose", "pose_partial.npz"),
                    os.path.join(dirs[1], rel, "pose"))
    hierarchical_training(rank, data_dir, dirs[1], cfgs, device=device,
                          stop_before="nonleaf")
    left = resume_files(os.path.join(dirs[1], rel))
    c = hierarchical_training(rank, data_dir, dirs[1], cfgs, device=device)
    c["resume_files"] = left
    return a, c


def rank0_section(rank, seconds, section_group=True):
    """HTGaussianTrainer._on_rank0 of a section in which rank 0 sleeps
    `seconds`, then changes the trainer's poses, streams and iteration
    count; returns the section's result and the state this rank holds
    after it. section_group=False drops the wait on the section group, so
    the other ranks wait in the main group's broadcast instead."""
    import random
    import time

    from ..train import hierarchy

    if not section_group:
        mesh_lib.wait_for_rank = lambda src=0: None
    tr = hierarchy.HTGaussianTrainer.__new__(hierarchy.HTGaussianTrainer)
    tr.rank, tr.world = mesh_lib.rank(), mesh_lib.world_size()
    tr.device = torch.device("cpu")
    tr.pose_dict, tr.rng = {}, random.Random(0)
    tr.gen = torch.Generator().manual_seed(0)
    tr.global_iteration = tr.n_capacity_grows = tr._steps_since_tune = 0
    tr.just_reset, tr._tile_args = False, None

    def section():
        time.sleep(seconds)
        tr.pose_dict["rel_pose_0_to_1"] = np.full((4, 4), 7.0, np.float32)
        tr.global_iteration = 123
        tr.rng.random()
        torch.randn(3, generator=tr.gen)
        return "rank 0's result"

    out = tr._on_rank0(section)
    return {"out": out, "pose_dict": tr.pose_dict,
            "global_iteration": tr.global_iteration,
            "rng": tr.rng.getstate(), "gen": tr.gen.get_state().numpy()}
