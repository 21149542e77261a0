"""Real-image end-to-end benchmark on the photo scene.

Counterpart of the JAX package's `tools/real_image_bench.py`. It writes the
real-photograph multi-plane scene (`utils.photo_scene`: real texture, exact
poses and depths), sets a tier's recipe (`utils.tiers`), trains the whole
SfM-free hierarchical pipeline with `HTGaussianTrainer`, and scores the
train-view PSNR and the poses' ATE/RPE against the exact truth.

    python -m ht3dgs_torch.real_image_bench OUT [--quick|--medium|--full|--scale]
                                                [--device cpu]

It runs on the card unless `--device cpu` is given, and raises if there is
no card. The trainer works under OUT (the scene in OUT/data, the model,
poses, logs and crash-resume crumbs in OUT/output/...); rerunning the same
command with the same OUT resumes Phase A from its partial poses and each
finished segment from its crumb. It prints the JAX tool's table row, then
one JSON line: per trainer phase the seconds, steps, model-steps, ms per
step, K1/K2 launches, farthest-first drops and the tile arguments of its
last step; every bundle's live rows, capacity and M at every level; the
capacity growths; the tile arguments of the last training step
(`train_tile_args`) and of the eval sweep, which grows K after training
(`eval_tile_args`); on the card, the wall and device ms of one root step
at each, and at the training's a torch.profiler split of its device time
by kernel and by layer with the binning's filled slots (written also to
OUT/root_step_profile.txt), and the peak device memory; PSNR, ATE, RPE
and the largest relative-pose rotation error.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from .utils.tiers import TIERS


def rotation_errors(pose_dict: dict, gt_w2c: np.ndarray) -> list:
    """Degrees between each relative pose of Phase A and the truth."""
    errs = []
    for f in range(1, len(gt_w2c)):
        rel = pose_dict[f"rel_pose_{f - 1}_to_{f}"]
        dR = rel[:3, :3] @ (gt_w2c[f] @ np.linalg.inv(gt_w2c[f - 1]))[:3, :3].T
        errs.append(float(np.degrees(np.arccos(np.clip(
            (np.trace(dR) - 1) / 2, -1.0, 1.0)))))
    return errs


def run(out_dir: str, tier: str, device: str = "cuda") -> dict:
    """Train the tier's photo scene under out_dir; returns the JSON
    record."""
    import torch

    from .eval.pose_eval import evaluate_poses
    from .train.hierarchy import HTGaussianTrainer
    from .utils import photo_scene
    from .utils.config import load_configs
    from .utils.profiling import (StepCounter, root_step_figures,
                                  root_tile_args)
    from .utils.tiers import apply_tier, tier_dims

    on_card = device != "cpu"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("real_image_bench: no CUDA device (pass "
                           "--device cpu to run on the CPU)")
    out_dir = os.path.abspath(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    data_dir = os.path.join(out_dir, "data")
    h, w, n_frames = tier_dims(tier)
    gt_w2c, _ = photo_scene.write_dataset(data_dir, n_frames=n_frames,
                                          height=h, width=w)
    model, pipe, optim = load_configs()
    apply_tier(tier, model, pipe, optim, data_dir)

    counter = StepCounter()
    originals = counter.wrap_steps() + counter.watch_trainer(
        HTGaussianTrainer)
    cwd = os.getcwd()
    os.chdir(out_dir)
    try:
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        tr = HTGaussianTrainer(data_dir, model, pipe, optim, seed=0,
                               device=device)
        t0 = time.perf_counter()
        bundle = tr.hierarchical_training()
        wall = time.perf_counter() - t0
        psnr = tr.evaluate_on_training_images(save_images=False)
    finally:
        os.chdir(cwd)
        StepCounter.restore(originals)
    peak = (torch.cuda.max_memory_allocated() / 2**30 if on_card
            else None)
    # the root step at the training's tile arguments and at the sweep's
    root = (root_step_figures(tr, bundle, counter, "root", profile=True,
                              path=os.path.join(out_dir,
                                                "root_step_profile.txt"))
            if on_card else
            {f"{k}_tile_args": v
             for k, v in root_tile_args(tr, counter).items()})
    pred = bundle.poses[:tr.seq_len]
    stats = evaluate_poses(gt_w2c, pred)
    rot = rotation_errors(tr.pose_dict, gt_w2c)
    return {
        "tier": tier, "frames": n_frames, "width": w, "height": h,
        "train_level": pipe.train_level,
        "device": (torch.cuda.get_device_name(0) if on_card else "cpu"),
        "hierarchical_training_s": round(wall, 3),
        "phases": counter.table(tr.timer),
        "bundles": counter.bundles,
        "capacity_growths": tr.n_capacity_grows, **root,
        "peak_memory_gib": None if peak is None else round(peak, 3),
        "psnr": psnr, "ATE": stats["ATE"],
        "ATE_x100": stats["ATE"] * 100,
        "RPE_trans_x100": stats["RPE_trans_x100"],
        "RPE_rot_deg": stats["RPE_rot_deg"],
        "max_rot_err_deg": max(rot), "mean_rot_err_deg": float(np.mean(rot)),
    }


def table_row(rec: dict) -> str:
    """The JAX tool's RESULTS.md row."""
    return (f"| {rec['tier']} {rec['width']}x{rec['height']}, "
            f"{rec['frames']}f ({rec['device']}) | {rec['psnr']:.2f} dB | "
            f"{rec['ATE_x100']:.3f} | {rec['RPE_trans_x100']:.3f} | "
            f"{rec['RPE_rot_deg']:.3f} | |")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out_dir")
    group = ap.add_mutually_exclusive_group()
    for t in TIERS:
        group.add_argument(f"--{t}", dest="tier", action="store_const",
                           const=t)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    rec = run(args.out_dir, args.tier or "quick", args.device)
    print(table_row(rec))
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
