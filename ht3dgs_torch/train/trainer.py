"""Base trainer: dataset wiring, per-frame caches, depth/VFI providers.

Counterpart of `ht3dgs.train.trainer.GaussianTrainer`: it owns the frame
list, caches decoded RGB frames, mono depth and VFI midway frames (numpy,
host), builds `Camera`s with a pose baked into world_view (or identity for
pose fitting) and prepares per-frame point clouds (depth unprojection +
voxel downsampling) for model initialization. `device` places the cameras
and the frames the steps read; the host caches stay numpy.
"""

from __future__ import annotations

import logging
import os
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.camera import Camera, make_camera
from ..data import depth as depth_lib
from ..data import readers
from ..data import vfi as vfi_lib
from ..data.pointcloud import PointCloud, pcd_from_depth_image
from ..parallel.mesh import rank as mesh_rank
from ..utils.config import ModelConfig, OptimizationConfig, PipelineConfig

NEAR = 0.01
# cameras and device frames kept before the caches are emptied
_DEVICE_CACHE = 4096


class GaussianTrainer:
    def __init__(self, data_path: str, model_cfg: ModelConfig,
                 pipe_cfg: PipelineConfig, optim_cfg: OptimizationConfig,
                 device="cuda"):
        self.data_path = data_path
        self.model_cfg = model_cfg
        self.pipe_cfg = pipe_cfg
        self.optim_cfg = optim_cfg
        self.device = torch.device(device)

        self.result_path = os.path.join(
            "output", model_cfg.expname,
            f"{model_cfg.category}_{model_cfg.seq_name}")
        os.makedirs(self.result_path, exist_ok=True)
        self.logger = self._setup_logger()
        self.logger.info(f"model_cfg: {model_cfg}")
        self.logger.info(f"pipe_cfg: {pipe_cfg}")
        self.logger.info(f"optim_cfg: {optim_cfg}")

        self.rgb_images: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self.mono_depth: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self.vfi: "OrderedDict[str, np.ndarray]" = OrderedDict()
        # device copies of frames and cameras: a copy from host memory
        # synchronises the stream, so each is made once
        self._device_frames: Dict[Tuple, torch.Tensor] = {}
        self._cameras: Dict[Tuple, Camera] = {}

        self.setup_dataset()
        self.depth_provider = depth_lib.make_depth_provider(
            pipe_cfg.depth_provider,
            **({"directory": pipe_cfg.depth_dir}
               if pipe_cfg.depth_provider == "precomputed" else {}))
        vfi_kw = {}
        if pipe_cfg.vfi_provider == "precomputed":
            vfi_kw["directory"] = pipe_cfg.vfi_dir
        elif pipe_cfg.vfi_provider == "ifrnet":
            vfi_kw.update(checkpoint=pipe_cfg.vfi_checkpoint,
                          device=self.device)
        self.vfi_provider = vfi_lib.make_vfi_provider(
            pipe_cfg.vfi_provider, **vfi_kw)

    # ------------------------------------------------------------------ #
    def _setup_logger(self) -> logging.Logger:
        m = self.model_cfg
        logger = logging.getLogger(f"ht3dgs_torch.{m.category}_{m.seq_name}")
        logger.setLevel(logging.INFO)
        if not logger.handlers and mesh_rank() != 0:
            # one log per run: rank 0 writes it
            logger.addHandler(logging.NullHandler())
        if not logger.handlers:
            fh = logging.FileHandler(
                os.path.join(self.result_path, "output.log"))
            fh.setFormatter(logging.Formatter(
                "%(asctime)s %(levelname)s %(message)s"))
            logger.addHandler(fh)
        return logger

    def setup_dataset(self):
        m = self.model_cfg
        dtype = m.data_type
        do_split = m.eval
        if dtype == "co3d":
            info = readers.read_co3d(self.data_path, m.category, m.seq_name,
                                     resolution=m.resolution,
                                     do_split=do_split)
        elif dtype in ("images_only",):
            if m.FovX is None:
                raise ValueError("images_only needs ModelParams.FovX")
            info = readers.read_images_only(
                self.data_path, m.FovX, m.FovY, resolution=m.resolution,
                do_split=do_split,
                sample_rate=getattr(m, "test_sample_rate", None))
        elif dtype in ("colmap", "tanks"):
            info = readers.read_colmap(
                self.data_path, images_dir=m.images,
                resolution=m.resolution, do_split=do_split,
                sample_rate=getattr(m, "test_sample_rate", None))
        elif dtype == "blender":
            info = readers.read_blender(self.data_path,
                                        resolution=m.resolution)
        else:
            raise ValueError(f"unknown data_type {dtype}")
        self.set_scene(info)

    def set_scene(self, info: readers.SceneInfo):
        """Take the frames of a SceneInfo (setup_dataset's reader, or one a
        caller built, e.g. with frames in memory)."""
        m = self.model_cfg
        self.scene_info = info
        self.i_train = info.i_train
        self.i_test = info.i_test
        use_test = "eval" in m.mode
        self.data = info.test_frames if (use_test and info.test_frames) \
            else info.train_frames
        self.train_cam_infos = info.train_frames
        self.test_cam_infos = info.test_frames
        self.seq_len = len(self.data)
        self.logger.info(
            f"dataset {m.data_type}: {self.seq_len} frames "
            f"(train {len(info.train_frames)}, test {len(info.test_frames)})")

    # ------------------------------------------------------------------ #
    # frame-level caches
    def load_image(self, idx: int) -> np.ndarray:
        if idx not in self.rgb_images:
            self.rgb_images[idx] = self.data[idx].load_image()
        return self.rgb_images[idx]

    def get_depth(self, idx: int) -> np.ndarray:
        if idx not in self.mono_depth:
            img = self.load_image(idx)
            d = self.depth_provider(img, self.data[idx].image_name)
            self.mono_depth[idx] = np.maximum(d, NEAR)
        return self.mono_depth[idx]

    def get_vfi(self, idx: int) -> np.ndarray:
        """Midway frame between idx and idx+1 (cached)."""
        key = f"{idx}_to_{idx + 1}"
        if key not in self.vfi:
            if idx + 1 >= self.seq_len:
                self.vfi[key] = np.ones_like(self.load_image(idx))
            else:
                self.vfi[key] = np.clip(self.vfi_provider(
                    self.load_image(idx), self.load_image(idx + 1), key),
                    0.0, 1.0).astype(np.float32)
        return self.vfi[key]

    def device_frame(self, kind: str, idx: int) -> torch.Tensor:
        """The frame `load_image(idx)` (kind "rgb"), `get_vfi(idx)` ("vfi")
        or `get_depth(idx)` ("depth") on the trainer's device, cached."""
        key = (kind, idx)
        if key not in self._device_frames:
            host = {"rgb": self.load_image, "vfi": self.get_vfi,
                    "depth": self.get_depth}[kind](idx)
            if len(self._device_frames) >= _DEVICE_CACHE:
                self._device_frames.clear()
            self._device_frames[key] = torch.as_tensor(
                np.asarray(host, np.float32), device=self.device)
        return self._device_frames[key]

    # ------------------------------------------------------------------ #
    def camera_for(self, idx: int,
                   pose: Optional[np.ndarray] = None) -> Camera:
        """Camera with `pose` (4x4 w2c) baked into world_view; identity when
        pose is None. Cached by frame and pose."""
        key = (idx, None if pose is None
               else np.asarray(pose, np.float32).tobytes())
        cam = self._cameras.get(key)
        if cam is None:
            f = self.data[idx]
            cam = make_camera(f.height, f.width, f.intrinsics,
                              world_view=pose, device=self.device)
            if len(self._cameras) >= _DEVICE_CACHE:
                self._cameras.clear()
            self._cameras[key] = cam
        return cam

    def prepare_pcd(self, idx: int, down_sample: bool = True,
                    use_vfi_frame: bool = False) -> PointCloud:
        """Per-frame init point cloud: mono depth unprojected through K,
        colored by the frame, voxel-downsampled."""
        f = self.data[idx]
        if use_vfi_frame:
            img = self.get_vfi(idx)
            try:
                d = self.depth_provider(img, f.image_name + "_vfi")
            except FileNotFoundError:
                # precomputed depth dirs rarely ship VFI-frame depth; the
                # midway frame's geometry is close to the base frame's
                d = self.get_depth(idx)
        else:
            img = self.load_image(idx)
            d = self.get_depth(idx)
        pcd = pcd_from_depth_image(img, d, f.intrinsics,
                                   down_sample=down_sample)
        cap = getattr(self.pipe_cfg, "init_max_points", 0)
        if cap and len(pcd.points) > cap:
            sel = np.random.default_rng(0).choice(
                len(pcd.points), cap, replace=False)
            pcd = PointCloud(pcd.points[sel], pcd.colors[sel],
                             pcd.normals[sel])
        return pcd

    def gt_poses_w2c(self) -> Optional[np.ndarray]:
        """[F, 4, 4] ground-truth w2c poses when the dataset has them."""
        poses = []
        for f in self.data:
            p = f.gt_pose()
            if p is None:
                return None
            poses.append(p)
        return np.stack(poses)
