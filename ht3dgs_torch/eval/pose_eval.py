"""Pose-accuracy evaluation: trajectory alignment + ATE/RPE (numpy).

Counterpart of `ht3dgs.eval.pose_eval`: scale-only orthogonal-Procrustes
alignment of the translations, then Umeyama sim(3) alignment of the
camera-to-world trajectory, then ATE RMSE and mean relative-pose errors
(RPE_trans reported x100, RPE_rot in degrees), as the reference reports
them.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def align_umeyama(model: np.ndarray, data: np.ndarray,
                  known_scale: bool = False):
    """Least-squares similarity: model ≈ s·R·data + t (Umeyama 1991)."""
    mu_M = model.mean(0)
    mu_D = data.mean(0)
    model_zc = model - mu_M
    data_zc = data - mu_D
    n = model.shape[0]

    C = (model_zc.T @ data_zc) / n
    sigma2 = (data_zc * data_zc).sum() / n
    U, D, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt.T) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = 1.0 if known_scale else np.trace(np.diag(D) @ S) / sigma2
    t = mu_M - s * R @ mu_D
    return s, R, t


def align_ate_c2b_use_a2b(traj_a: np.ndarray, traj_b: np.ndarray,
                          traj_c: np.ndarray = None) -> np.ndarray:
    """Align c2w trajectory a to b with the sim(3) estimated from their
    camera centers, apply to c (default c=a). Input [N,4,4] c2w."""
    if traj_c is None:
        traj_c = traj_a.copy()
    t_a = traj_a[:, :3, 3]
    t_b = traj_b[:, :3, 3]
    s, R, t = align_umeyama(t_b, t_a)  # t_b ≈ s R t_a + t

    out = []
    for T in traj_c:
        Rc = T[:3, :3]
        tc = T[:3, 3]
        T2 = np.eye(4)
        T2[:3, :3] = R @ Rc
        T2[:3, 3] = s * (R @ tc) + t
        out.append(T2)
    return np.stack(out)


def align_scale_procrustes(trans_gt: np.ndarray, trans_est: np.ndarray):
    """The reference's `align_pose` pre-step
    (trainer/ht3dgs_trainer.py:1195-1222): center + normalize both
    translation sets, then orthogonal-Procrustes scale on the estimate."""
    import scipy.linalg

    m1 = np.array(trans_gt, dtype=np.double, copy=True)
    m2 = np.array(trans_est, dtype=np.double, copy=True)
    m1 -= m1.mean(0)
    m2 -= m2.mean(0)
    n1 = np.linalg.norm(m1)
    n2 = np.linalg.norm(m2)
    if n1 == 0 or n2 == 0:
        raise ValueError("degenerate trajectories")
    m1 /= n1
    m2 /= n2
    R, s = scipy.linalg.orthogonal_procrustes(m1, m2)
    return m1, m2 * s, R


def rotation_error(pose_error: np.ndarray) -> float:
    d = 0.5 * (np.trace(pose_error[:3, :3]) - 1.0)
    return float(np.arccos(np.clip(d, -1.0, 1.0)))


def translation_error(pose_error: np.ndarray) -> float:
    return float(np.linalg.norm(pose_error[:3, 3]))


def compute_rpe(gt: np.ndarray, pred: np.ndarray) -> Tuple[float, float]:
    """Mean relative-pose errors between consecutive frames ([N,4,4] c2w)."""
    trans_errors, rot_errors = [], []
    for i in range(len(gt) - 1):
        gt_rel = np.linalg.inv(gt[i]) @ gt[i + 1]
        pred_rel = np.linalg.inv(pred[i]) @ pred[i + 1]
        rel_err = np.linalg.inv(gt_rel) @ pred_rel
        trans_errors.append(translation_error(rel_err))
        rot_errors.append(rotation_error(rel_err))
    return float(np.mean(trans_errors)), float(np.mean(rot_errors))


def compute_ate(gt: np.ndarray, pred: np.ndarray) -> float:
    """RMSE of camera-center distances ([N,4,4] c2w)."""
    err = gt[: len(pred), :3, 3] - pred[:, :3, 3]
    return float(np.sqrt((np.linalg.norm(err, axis=1) ** 2).mean()))


def evaluate_poses(poses_gt_w2c: np.ndarray,
                   poses_pred_w2c: np.ndarray) -> dict:
    """Full eval_pose pipeline: invert to c2w, scale-align translations,
    Umeyama-align, compute ATE/RPE. Returns the reference's reported
    quantities."""
    gt_c2w = np.linalg.inv(poses_gt_w2c)[: len(poses_pred_w2c)]
    pred_c2w = np.linalg.inv(poses_pred_w2c)

    gt = gt_c2w.copy()
    pred = pred_c2w.copy()
    tg, te, _ = align_scale_procrustes(gt[:, :3, 3], pred[:, :3, 3])
    gt[:, :3, 3] = tg
    pred[:, :3, 3] = te

    pred_aligned = align_ate_c2b_use_a2b(pred, gt)
    ate = compute_ate(gt, pred_aligned)
    rpe_trans, rpe_rot = compute_rpe(gt, pred_aligned)
    return {
        "ATE": ate,
        "RPE_trans_x100": rpe_trans * 100.0,
        "RPE_rot_deg": rpe_rot * 180.0 / np.pi,
        "aligned_pred_c2w": pred_aligned,
        "aligned_gt_c2w": gt,
    }
