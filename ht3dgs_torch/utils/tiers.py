"""The photo-scene benchmark tiers: frame sizes and training recipes.

The port's own copy of the JAX package's tier settings (`tools/_tiers.py`:
`tier_dims`, `apply_tier`), with the same four tiers and the same numbers.

- quick: 10 frames at 128x96, short budgets (a CPU run);
- medium: 12 frames at 208x160, about a third of the reference's per-stage
  budgets;
- full: 16 frames at 256x192, a video-sized run for one device;
- scale: the reference-shaped run, 48 frames at 208x160 at `train_level`
  2: 4 leaves, 2 merged level-1 non-leaves and the root, whose MSS phase 1
  draws pseudo-views from children that were merged and trained
  themselves. The medium tier's budgets, the full tier's preset tile
  capacities.

Every tier turns the derived opacity resets off: the reference's schedule
(opacity_reset_interval = num_iterations // 10) is calibrated for ~300
frames x 300 steps, and at 10-48 frames it would fire a reset every ~one
frame's steps, which keeps every model in the reset and recovery cycle.
Phase A fits each pair directly (no VFI midpoint: the `blend` VFI stand-in
ghosts the midpoints) at pose_lr 3e-3.
"""

from __future__ import annotations

import os

TIERS = ("quick", "medium", "full", "scale")


def tier_dims(tier: str):
    """(height, width, frames) of a tier's photo scene."""
    if tier == "scale":
        return 160, 208, 48
    if tier == "full":
        return 192, 256, 16
    if tier == "medium":
        return 160, 208, 12
    return 96, 128, 10


def apply_tier(tier: str, model, pipe, optim, data_dir: str) -> None:
    """Set a tier's recipe on the three config groups, in place, for the
    photo scene written under data_dir."""
    model.eval = False
    model.source_path = data_dir
    model.data_type = "blender"
    model.expname = "real_bench"
    model.category = "photo"
    model.seq_name = "hopper"
    pipe.train_level = 1
    pipe.render_mode = "tiled"
    pipe.depth_provider = "precomputed"
    pipe.depth_dir = os.path.join(data_dir, "depth")
    optim.opacity_reset_interval_override = 100_000
    pipe.train_pose_mode = None
    optim.pose_lr = 3e-3

    if tier == "scale":
        pipe.train_level = 2
        pipe.init_max_points = 8_000
        pipe.phase_a_batch = 4
        pipe.tile_max_per_tile = 2048
        pipe.tile_dup_factor = 32
        optim.single_step = 80
        optim.phase_a_fit_iters = 300
        optim.phase_a_pose_iters = 120
        optim.leaf_init_iters = 300
        optim.mss_phase1_iteration_per_frame = 10
        optim.densification_interval = 100
        optim.densification_interval_leaf = 100
        optim.densify_from_iter = 50
    elif tier == "full":
        pipe.init_max_points = 20_000
        pipe.phase_a_batch = 4
        pipe.tile_max_per_tile = 2048
        pipe.tile_dup_factor = 32
        optim.single_step = 100
        optim.phase_a_fit_iters = 400
        optim.phase_a_pose_iters = 150
        optim.leaf_init_iters = 400
    elif tier == "medium":
        pipe.init_max_points = 4_000
        pipe.phase_a_batch = 4
        optim.single_step = 80
        optim.phase_a_fit_iters = 300
        optim.phase_a_pose_iters = 120
        optim.leaf_init_iters = 300
        optim.mss_phase1_iteration_per_frame = 10
        optim.densification_interval = 100
        optim.densification_interval_leaf = 100
        optim.densify_from_iter = 50
    else:
        pipe.init_max_points = 400
        optim.single_step = 25
        optim.phase_a_fit_iters = 80
        optim.phase_a_pose_iters = 60
        optim.leaf_init_iters = 80
        optim.reset_recovery_iters = 5
        optim.mss_phase1_iteration_per_frame = 4
        optim.densification_interval = 60
        optim.densification_interval_leaf = 60
        optim.densify_from_iter = 30
