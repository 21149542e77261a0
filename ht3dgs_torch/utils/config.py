"""Configuration system.

Counterpart of `ht3dgs.utils.config`, field for field: the three parameter
groups `ModelParams` / `PipelineParams` / `OptimizationParams` with YAML
overrides, CLI flags over YAML, the same defaults. Equal configurations
give equal field reprs, so a breadcrumb's config fingerprint is the same in
both packages. `yaml` is imported only when a YAML file is read.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class ModelConfig:
    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    pose_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    eval: bool = True
    view_dependent: bool = True
    depth_model_type: str = "dpt"
    mode: str = "train"
    traj_opt: str = "bspline"
    # FoV for images_only data (arguments/full/Tanks/*.yml)
    FovX: Optional[float] = None
    FovY: Optional[float] = None
    data_path_train: str = ""
    data_type_train: str = "images_only"
    data_path_eval: str = ""
    data_type_eval: str = "colmap"
    expname: str = "default"
    category: str = ""
    seq_name: str = ""
    data_type: str = "images_only"   # resolved from mode at load time
    test_sample_rate: Optional[int] = None
    #   train/test split stride. None = reference quirk: 2 if "Family"
    #   appears in the data path else 8 (dataset_readers.py:424-427) —
    #   set explicitly for any directory that happens to contain "Family"


@dataclass
class PipelineConfig:
    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False
    init_mode: str = "rand"
    use_mono: bool = True
    use_mask: bool = False
    load_pose: Optional[str] = None
    train_mode: str = "hierarchical_training"
    train_level: int = 2
    partition_strategy: str = "v1"
    train_pose_mode: Optional[str] = "vfi"
    multi_source_supervision: str = "base+vfi"
    prune_ratio: float = 0.5
    # --- framework knobs (no reference counterpart) ---
    render_mode: str = "auto"          # oracle | tiled | pallas | auto
    depth_provider: str = "constant"   # constant | precomputed | dpt | zoe
    depth_dir: Optional[str] = None
    vfi_provider: str = "blend"        # none | blend | precomputed | ifrnet
    vfi_dir: Optional[str] = None
    vfi_checkpoint: Optional[str] = None
    mesh_segments: int = 1             # data-parallel segment axis size
    mesh_tiles: int = 1                # tile-sharding axis size
    tile_compact_frac: Optional[float] = None
    #   when tile-sharded (mesh_tiles > 1): per-chip block cull-compaction
    #   capacity as a fraction of state capacity per tile shard, e.g. 2.0
    #   -> compact_n = 2*cap/n_tiles (raster.tiled compact_n; makes the
    #   per-chip binning cost divide; auto-grows on drops)
    distributed: bool = False          # torch.distributed init (run.py)
    capacity_presize: float = 4.0      # parallel leaves: init-pcd capacity
    #                                    headroom (avoids mid-run recompiles)
    trace_dir: Optional[str] = None    # profiler trace capture dir
    init_max_points: int = 0           # cap per-frame init pcd size (0 = off)
    phase_a_batch: int = 8             # >0: vmap-batch relative-pose pairs
    pose_c2f: bool = False             # coarse-to-fine Phase A pose fits
                                       # (ht3dgs improvement; off =
                                       # reference parity)
    tile_max_per_tile: int = 0         # preset binning K (0 = renderer
    tile_dup_factor: int = 0           # default); avoids auto-grow
    #                                    recompiles on known-dense scenes
    eval_nvs_exec_chunk: int = 0       # iters per device execution in the
    #   eval_nvs test-time pose fit (0 = phase_a.EXEC_CHUNK); lower it for
    #   big models on the remote service (execution-length kill threshold)
    eval_nvs_batch: int = 16           # frames per batched test-time
    #                                    pose-fit chunk (device-memory bound)


@dataclass
class OptimizationConfig:
    iterations: int = 30_000
    single_step: int = 300
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    # Phase A pose-fit LR; None = rotation_lr (reference parity,
    # gaussian_model_ht.py:321-342 uses rotation_lr for the SE3 tangent)
    pose_lr: Optional[float] = None
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    lambda_depth: float = 0.0
    depth_loss_type: str = "invariant"
    densification_interval: int = 100
    densification_interval_leaf: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    reset_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    num_iterations_per_frame_each_level: List[int] = field(
        default_factory=lambda: [300, 300, 300])
    mss_phase1_iteration_per_frame: int = 50
    mss_phase1_densification_interval: Optional[int] = 100
    mss_phase1_densify_until_iter_ratio: Optional[float] = None
    mss_phase1_ratio: float = 0.5
    mss_phase2_densification_interval: int = 100
    mss_phase2_densify_until_iter_ratio: Optional[float] = None
    mss_phase2_ratio: float = 0.5
    # iteration budgets the reference hardcodes (1000/300/1000/500 at
    # ht3dgs_trainer.py:359,369,203,529) — exposed so tests and fast runs
    # can scale them down
    phase_a_fit_iters: int = 1000
    phase_a_pose_iters: int = 300
    leaf_init_iters: int = 1000
    reset_recovery_iters: int = 500
    eval_nvs_epochs: int = 200
    # Toy-scale schedule correction (None = reference parity). The reference
    # derives opacity_reset_interval = num_iterations//10
    # (ht3dgs_trainer.py:678), which at T&T scale (seq_len ~300,
    # single_step 300 -> interval 9000) means a leaf (~6000 iters) never
    # resets and a merged model resets ~once per phase-2 budget with
    # thousands of recovery iters. At benchmark scale (seq_len 10-16) the
    # same formula fires resets every ~single_step iters — every model
    # spends its whole life inside the reset/recovery thrash, a regime no
    # reference configuration ever enters. Setting this override restores
    # the reference's reset-to-budget *structure* on small runs.
    opacity_reset_interval_override: Optional[int] = None


_SECTION_TO_CLS = {
    "ModelParams": ModelConfig,
    "PipelineParams": PipelineConfig,
    "OptimizationParams": OptimizationConfig,
}


def load_configs(yaml_path: Optional[str] = None, overrides=None):
    """Returns (model_cfg, pipe_cfg, optim_cfg)."""
    model, pipe, optim = ModelConfig(), PipelineConfig(), OptimizationConfig()
    groups = {"ModelParams": model, "PipelineParams": pipe,
              "OptimizationParams": optim}
    if yaml_path:
        import yaml

        with open(yaml_path) as f:
            doc = yaml.safe_load(f) or {}
        for section, values in doc.items():
            tgt = groups.get(section)
            if tgt is None or not isinstance(values, dict):
                continue
            for k, v in values.items():
                if hasattr(tgt, k):
                    setattr(tgt, k, v)
                # unknown keys ignored (reference setattr's everything; we
                # stay strict to catch typos in *our* configs but tolerate
                # reference-era vestigial knobs)
    for k, v in (overrides or {}).items():
        for tgt in groups.values():
            if hasattr(tgt, k):
                setattr(tgt, k, v)
    return model, pipe, optim


def resolve_mode_paths(model: ModelConfig, mode: str) -> str:
    """Train vs eval data selection (run.py:35-41)."""
    model.mode = mode
    if mode == "train" or not model.data_path_eval:
        model.source_path = model.data_path_train or model.source_path
        model.data_type = model.data_type_train
    else:
        model.source_path = model.data_path_eval or model.source_path
        model.data_type = model.data_type_eval
    return model.source_path


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ht3dgs_torch — SfM-free "
                                "hierarchical 3DGS on one NVIDIA GPU")
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--mode", type=str, default="train",
                   choices=["train", "eval_pose", "eval_nvs", "render",
                            "pose_only"])
    for cls in (ModelConfig, PipelineConfig, OptimizationConfig):
        for f in dataclasses.fields(cls):
            name = "--" + f.name
            if any(a.dest == f.name for a in p._actions):
                continue
            if f.type == bool or isinstance(f.default, bool):
                # BooleanOptionalAction gives --flag / --no-flag pairs so
                # default-True fields (eval, view_dependent, ...) can be
                # disabled from the CLI
                p.add_argument(name, default=None,
                               action=argparse.BooleanOptionalAction)
            else:
                p.add_argument(name, default=None, type=str)
    return p


def configs_from_cli(argv=None):
    p = build_argparser()
    args = p.parse_args(argv)
    overrides = {}
    for k, v in vars(args).items():
        if k in ("config", "mode") or v is None:
            continue
        overrides[k] = _coerce(k, v)
    model, pipe, optim = load_configs(args.config, overrides)
    resolve_mode_paths(model, args.mode)
    return model, pipe, optim, args


def _coerce(key: str, value):
    for cls in (ModelConfig, PipelineConfig, OptimizationConfig):
        for f in dataclasses.fields(cls):
            if f.name == key and isinstance(value, str):
                # `from __future__ import annotations` makes f.type a
                # string; match Optional[...] variants too (e.g. FovX)
                t = str(f.type)
                if t.startswith("List"):
                    return value
                if "float" in t or isinstance(f.default, float):
                    return float(value)
                if "int" in t or (isinstance(f.default, int)
                                  and not isinstance(f.default, bool)):
                    return int(value)
    return value
