"""Evaluation and rendering modes: eval_nvs, eval_pose, render_nvs.

Counterpart of `ht3dgs.train.evals`:
- eval_nvs: restore a checkpoint, initialize the test-frame poses from the
  trained pose chain, fit each frame's pose against the frozen Gaussians
  (camera Adam) for `eval_nvs_epochs` steps, then write per-frame and mean
  PSNR/SSIM/LPIPS into test/test.txt;
- eval_pose: align the predicted w2c chain with the dataset's ground truth
  (Procrustes scale + Umeyama sim3) and write RPE_trans(x100)/RPE_rot(deg)/
  ATE into pose_eval.txt, with a trajectory plot where matplotlib is;
- render_nvs: a B-spline/slerp trajectory through the trained poses,
  rendered to PNGs and, where imageio can encode it, an mp4.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..core import se3
from ..eval import metrics as metrics_lib
from ..eval import pose_eval as pe
from ..eval import traj as traj_lib
from ..utils.image import colorize, save_image
from . import phase_a as pa
from . import step as step_lib
from .losses import psnr as psnr_fn
from .losses import ssim as ssim_fn


def settle_eval_tile_args(trainer, state, camera, max_k: int = 16384):
    """Grow the tile capacities until an eval render of `state` drops
    nothing (max_per_tile x2 up to max_k, dup_factor x2 up to 64): a
    trainer's preset capacities may silently truncate a big merged model.
    Returns the settled tile_args tuple and sets trainer._tile_args."""
    ta = dict(trainer._tile_args) if trainer._tile_args else {}
    ta.setdefault("max_per_tile", 1024)
    ta.setdefault("dup_factor", 16)
    for _ in range(6):
        out = step_lib.render_eval(state, camera, mode=trainer._mode,
                                   tile_args=dict(ta))
        nd_t = int(out.get("n_dropped_tile", 0))
        nd_m = int(out.get("n_dropped_m", 0))
        if nd_t == 0 and nd_m == 0:
            break
        if nd_t:
            if ta["max_per_tile"] >= max_k:
                break
            ta["max_per_tile"] = min(2 * ta["max_per_tile"], max_k)
        if nd_m:
            ta["dup_factor"] = min(2 * ta["dup_factor"], 64)
        trainer.logger.info(f"[eval] tile capacity grown for eval: {ta} "
                            f"(nd_tile={nd_t}, nd_m={nd_m})")
    trainer._tile_args = tuple(sorted(ta.items()))
    return trainer._tile_args


def _checkpoint_path(trainer, checkpoint: Optional[str]) -> str:
    return checkpoint or trainer.model_cfg.model_path or \
        f"{trainer.result_path}/chkpnt/model.npz"


def _test_init_poses(trainer, poses_pred: np.ndarray,
                     result_path: str) -> np.ndarray:
    """[seq_len, 4, 4] w2c poses that start the test-time fits."""
    seq_len = trainer.seq_len
    if not trainer.model_cfg.eval:
        # no test split (every frame is a train frame): each frame starts
        # from its own trained pose
        return poses_pred[:seq_len]
    # the reference's test split: train frames are every sample_rate-th
    # video frame, test frames sit between them, and each test pose starts
    # from the bracketing train pose
    sample_rate = (trainer.model_cfg.test_sample_rate
                   or (2 if "Family" in result_path + trainer.data_path
                       else 8))
    if sample_rate == 2:
        init = poses_pred[0::sample_rate - 1][:seq_len]
    else:
        init = poses_pred[int(sample_rate / 2)::sample_rate - 1][:seq_len]
    if len(init) < seq_len:  # pad with the last pose
        pad = np.tile(init[-1][None], (seq_len - len(init), 1, 1))
        init = np.concatenate([init, pad], axis=0)
    return init


def eval_nvs(trainer, checkpoint: Optional[str] = None,
             pose_file: Optional[str] = None) -> dict:
    ckpt = _checkpoint_path(trainer, checkpoint)
    bundle = trainer.load_checkpoint(ckpt)
    pose_file = pose_file or f"{trainer.result_path}/pose/pose.npz"
    with np.load(pose_file) as z:
        poses_pred = z["poses_pred"]

    result_path = os.path.join(os.path.dirname(os.path.dirname(ckpt)), "test")
    os.makedirs(result_path, exist_ok=True)
    seq_len = trainer.seq_len
    init = _test_init_poses(trainer, poses_pred, result_path)

    # Per-frame pose tangents optimized against the frozen Gaussians, by
    # plain Adam at a CONSTANT rotation_lr: the reference defines a camera
    # LR scheduler but never calls it, so its test-time pose optimization
    # runs at the fixed camera_rotation_lr too.
    dev = trainer.device
    bases = se3.se3_from_matrix(torch.as_tensor(
        np.asarray(init, np.float32), device=dev))            # [F, 7]
    lr = trainer.sched.rotation_lr
    epochs = trainer.sched.eval_nvs_epochs
    settle_eval_tile_args(trainer, bundle.state,
                          trainer.camera_for(0, pose=init[0]))

    # Test frames are independent: chunks of eval_nvs_batch frames go
    # through one batched pose fit that shares the frozen model, one
    # batched render of the B poses per step.
    B = max(1, int(getattr(trainer.pipe_cfg, "eval_nvs_batch", 16)))
    deltas = []
    for c0 in range(0, seq_len, B):
        frames = list(range(c0, min(c0 + B, seq_len)))
        cams = [trainer.camera_for(f) for f in frames]   # identity extrinsics
        gts = torch.stack([trainer.device_frame("rgb", f) for f in frames])
        deltas.append(pa.batched_pose_fit(
            bundle.state, bases[c0:c0 + len(frames)], cams, gts, lr,
            mode=trainer._mode, tile_args=trainer._tile_args,
            lambda_dssim=trainer.sched.lambda_dssim, n_iters=epochs,
            shared_state=True))
        trainer.logger.info(
            f"[eval_nvs] pose-fit frames {frames[0]}..{frames[-1]} "
            f"({epochs} epochs)")
    poses = se3.se3_to_matrix(se3.se3_retr(torch.cat(deltas), bases))
    poses = poses.cpu().numpy()

    rows = []
    for f in range(seq_len):
        cam = trainer.camera_for(f, pose=poses[f])
        out = step_lib.render_eval(bundle.state, cam, mode=trainer._mode,
                                   tile_args=trainer._tile_args)
        gt = trainer.device_frame("rgb", f)
        p = float(psnr_fn(out["image"], gt))
        s = float(ssim_fn(out["image"], gt))
        l = metrics_lib.try_lpips(out["image"], gt)
        rows.append((f, p, s, l))
        trainer.logger.info(f"[eval_nvs] frame {f}: psnr {p:.3f} "
                            f"ssim {s:.3f} lpips {l:.3f}")

    mean_p = float(np.mean([r[1] for r in rows]))
    mean_s = float(np.mean([r[2] for r in rows]))
    lp = [r[3] for r in rows if np.isfinite(r[3])]
    mean_l = float(np.mean(lp)) if lp else float("nan")
    with open(os.path.join(result_path, "test.txt"), "w") as f:
        for r in rows:
            f.write(f"{r[0]} {r[1]:.03f} {r[2]:.03f} {r[3]:.03f}\n")
        f.write(f"PSNR : {mean_p:.03f}, SSIM : {mean_s:.03f}, "
                f"LPIPS : {mean_l:.03f}")
    print(f"PSNR : {mean_p:.03f}, SSIM : {mean_s:.03f}, LPIPS : {mean_l:.03f}")
    return {"psnr": mean_p, "ssim": mean_s, "lpips": mean_l, "rows": rows,
            "poses": poses}


def eval_pose(trainer, pose_file: Optional[str] = None) -> dict:
    pose_file = pose_file or (
        trainer.model_cfg.pose_path or f"{trainer.result_path}/pose/pose.npz")
    with np.load(pose_file) as z:
        poses_pred = z["poses_pred"]
    gt = trainer.gt_poses_w2c()
    if gt is None:
        raise ValueError("dataset has no ground-truth poses for eval_pose")

    res = pe.evaluate_poses(gt, poses_pred)
    out_dir = os.path.dirname(pose_file)
    os.makedirs(out_dir, exist_ok=True)
    line = ("RPE_trans: {:.03f}, RPE_rot: {:.03f}, ATE: {:.03f}".format(
        res["RPE_trans_x100"], res["RPE_rot_deg"], res["ATE"]))
    print(line)
    with open(os.path.join(out_dir, "pose_eval.txt"), "w") as f:
        f.write(line)
    _plot_trajectories(res["aligned_gt_c2w"], res["aligned_pred_c2w"],
                       os.path.join(out_dir, "pose_plot.png"))
    return res


def _plot_trajectories(gt_c2w, pred_c2w, path):
    """The optional trajectory plot: skipped where matplotlib (or its 3D
    axes) cannot draw it."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=(6, 6))
        ax = fig.add_subplot(projection="3d")
        ax.plot(*gt_c2w[:, :3, 3].T, label="GT", c="k")
        ax.plot(*pred_c2w[:, :3, 3].T, label="ours", c="r")
        ax.legend()
        fig.savefig(path, dpi=120)
        plt.close(fig)
    except Exception:
        pass


def render_nvs(trainer, checkpoint: Optional[str] = None,
               pose_file: Optional[str] = None, n_novel: int = 120,
               traj_opt: str = "bspline") -> str:
    """Render n_novel frames along the trajectory into nvs/<traj_opt>/
    img_out/ and return the mp4's path, or the PNG directory where imageio
    cannot encode one."""
    ckpt = _checkpoint_path(trainer, checkpoint)
    bundle = trainer.load_checkpoint(ckpt)
    pose_file = pose_file or f"{trainer.result_path}/pose/pose.npz"
    with np.load(pose_file) as z:
        poses_pred = z["poses_pred"]

    c2ws = np.linalg.inv(poses_pred)
    novel_w2c = np.linalg.inv(traj_lib.interp_poses_bspline(c2ws, n_novel))
    settle_eval_tile_args(trainer, bundle.state,
                          trainer.camera_for(0, pose=poses_pred[0]))

    out_dir = os.path.join(os.path.dirname(os.path.dirname(ckpt)),
                           "nvs", traj_opt)
    os.makedirs(os.path.join(out_dir, "img_out"), exist_ok=True)
    frames = []
    ref = min(10, trainer.seq_len - 1)
    for i, pose in enumerate(novel_w2c):
        out = step_lib.render_eval(
            bundle.state, trainer.camera_for(ref, pose=pose),
            mode=trainer._mode, tile_args=trainer._tile_args)
        img = out["image"].cpu().numpy()
        save_image(os.path.join(out_dir, "img_out", f"{i:04d}.png"), img)
        frames.append(np.concatenate(
            [(np.clip(img, 0, 1) * 255).astype(np.uint8),
             colorize(out["depth"].cpu().numpy())], axis=1))

    video = os.path.join(out_dir, "video_out")
    os.makedirs(video, exist_ok=True)
    mp4 = os.path.join(
        video, f"{trainer.model_cfg.category}_{trainer.model_cfg.seq_name}"
        "_ours.mp4")
    try:
        import imageio

        imageio.mimwrite(mp4, frames, fps=30, quality=9)
    except (ImportError, ValueError, RuntimeError, OSError):
        # no imageio, or no mp4 backend (a ValueError from imageio): the
        # PNG sequence is the result
        mp4 = out_dir
    return mp4
