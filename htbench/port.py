"""What the jobs take from the port: its configurations, its trainer on the
benchmark's scene (frames, depths and midpoint frames handed in memory, in
place of the files its readers would read), and a way to watch a function
of it without changing what it does."""

from __future__ import annotations

import contextlib
import importlib
from typing import Callable

import numpy as np
import torch

from .scene import Scene


def configs(cfg: dict):
    """The port's (model, pipe, optim) configurations with every value of
    the configuration file set."""
    from ht3dgs_torch.utils.config import load_configs, resolve_mode_paths

    model, pipe, optim = load_configs()
    for sec, tgt in (("ModelParams", model), ("PipelineParams", pipe),
                     ("OptimizationParams", optim)):
        for k, v in cfg[sec].items():
            if not hasattr(tgt, k):
                raise KeyError(f"{sec}.{k} is not a setting of the port")
            setattr(tgt, k, v)
    resolve_mode_paths(model, "train")
    return model, pipe, optim


def host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy().astype(np.float32)


def trainer(cfg: dict, scene: Scene, seed: int, device):
    """HTGaussianTrainer on the scene's train frames. Its depth provider
    returns the scene's depth of frame k (image name "{k:06d}") and of the
    midpoint frame ("{k:06d}_vfi"); its VFI provider the midpoint frame of
    each pair "{k}_to_{k+1}"."""
    from ht3dgs_torch.data.readers import FrameInfo, SceneInfo
    from ht3dgs_torch.train.hierarchy import HTGaussianTrainer

    model, pipe, optim = configs(cfg)
    H, W, K = scene.height, scene.width, scene.K
    fovx = 2.0 * float(np.arctan(W / (2.0 * K[0, 0])))
    fovy = 2.0 * float(np.arctan(H / (2.0 * K[1, 1])))
    frames = [FrameInfo(uid=k, image_path=None, image_name=f"{k:06d}",
                        width=W, height=H, intrinsics=K, fovx=fovx,
                        fovy=fovy, _image=host(scene.rgb[k])
                        if k in scene.rgb else None)
              for k in range(scene.n_frames)]
    info = SceneInfo(train_frames=frames, test_frames=[],
                     i_train=np.arange(scene.n_frames),
                     i_test=np.array([], np.int64), nerf_radius=1.0)
    depths = {f"{k:06d}": host(d) for k, d in scene.depth.items()}
    depths.update({f"{k:06d}_vfi": host(d)
                   for k, d in scene.vfi_depth.items()})
    mids = {f"{k}_to_{k + 1}": host(v) for k, v in scene.vfi.items()}

    class InMemoryTrainer(HTGaussianTrainer):
        def setup_dataset(self):
            self.set_scene(info)

    tr = InMemoryTrainer("", model, pipe, optim, seed=seed, device=device)
    tr.depth_provider = lambda image, name: depths[name]
    tr.vfi_provider = lambda a, b, pair: mids[pair]
    return tr


@contextlib.contextmanager
def watch(module: str, name: str, hook: Callable):
    """Call hook(args, kwargs, result) after every call of module.name;
    the function is put back on exit."""
    m = importlib.import_module(module)
    fn = getattr(m, name)

    def watched(*a, **kw):
        out = fn(*a, **kw)
        hook(a, kw, out)
        return out

    setattr(m, name, watched)
    try:
        yield
    finally:
        setattr(m, name, fn)
