"""Carry numpy arrays (from the JAX package, or its npz checkpoints) into
the port's objects, so both packages can compute on the same weights."""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .core.adam import AdamState
from .core.camera import Camera
from .core.gaussians import PARAM_FIELDS, GaussianState

_STATS = ("max_radii2d", "grad_accum", "grad_denom")


def _t(x, device, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def state_from_numpy(arrays: Mapping[str, np.ndarray],
                     device="cuda") -> GaussianState:
    """Arrays named as the GaussianState fields: PARAM_FIELDS, live, the
    densification stats, active_sh_degree and max_sh_degree."""
    return GaussianState(
        **{f: _t(arrays[f], device, torch.float32)
           for f in PARAM_FIELDS + _STATS},
        live=_t(arrays["live"], device, torch.bool),
        active_sh_degree=_t(arrays["active_sh_degree"], device, torch.int32),
        max_sh_degree=int(arrays["max_sh_degree"]))


def adam_from_numpy(m: Mapping[str, np.ndarray], v: Mapping[str, np.ndarray],
                    step, device="cuda") -> AdamState:
    return AdamState(m={k: _t(x, device, torch.float32) for k, x in m.items()},
                     v={k: _t(x, device, torch.float32) for k, x in v.items()},
                     step=_t(step, device, torch.int32))


def camera_from_numpy(arrays: Mapping[str, object], device="cuda") -> Camera:
    """Arrays named as the Camera fields: world_view, fx, fy, cx, cy,
    height, width, and optionally clip_tan_x / clip_tan_y."""
    clip = {k: None if arrays.get(k) is None
            else _t(arrays[k], device, torch.float32)
            for k in ("clip_tan_x", "clip_tan_y")}
    return Camera(
        **{k: _t(arrays[k], device, torch.float32)
           for k in ("world_view", "fx", "fy", "cx", "cy")},
        height=int(arrays["height"]), width=int(arrays["width"]), **clip)


def load_checkpoint_npz(path: str, device="cuda"):
    """Load the npz checkpoint layout of ht3dgs.train.hierarchy
    (`save_checkpoint`). Returns (state, opt, extras) with extras holding
    poses, radius and spatial_scale."""
    with np.load(path) as z:
        state = state_from_numpy(z, device)
        opt = adam_from_numpy({f: z[f"adam_m_{f}"] for f in PARAM_FIELDS},
                              {f: z[f"adam_v_{f}"] for f in PARAM_FIELDS},
                              z["adam_step"], device)
        extras: Dict[str, object] = {
            "poses": z["poses"] if z["poses"].size else None,
            "radius": float(z["radius"]),
            "spatial_scale": float(z["spatial_scale"]),
        }
    return state, opt, extras
