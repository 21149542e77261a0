"""Novel-view trajectory synthesis for render_nvs.

Counterpart of `ht3dgs.eval.traj` (numpy/scipy only): fit a smooth
B-spline through the training camera centers and slerp the rotations,
giving N novel c2w poses for a video.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation, Slerp


def scipy_bspline(cv: np.ndarray, n: int = 100, degree: int = 3,
                  periodic: bool = False) -> np.ndarray:
    """Sample an (optionally periodic) B-spline through control points.

    Knot-vector construction follows the widely circulated public scipy
    B-spline sampling snippet (stackoverflow.com/a/35007804)."""
    from scipy import interpolate

    cv = np.asarray(cv)
    count = len(cv)
    degree = np.clip(degree, 1, count - 1)
    if periodic:
        kv = np.arange(-degree, count + degree + 1)
        factor, fraction = divmod(count + degree + 1, count)
        cv = np.roll(np.concatenate((cv,) * factor + (cv[:fraction],)),
                     -1, axis=0)
    else:
        kv = np.clip(np.arange(count + degree + 1) - degree, 0,
                     count - degree)
    max_param = count - (degree * (1 - periodic))
    spl = interpolate.BSpline(kv, cv, degree)
    return spl(np.linspace(0, max_param, n))


def interp_poses_bspline(c2ws: np.ndarray, n_novel: int = 120,
                         degree: int = 3) -> np.ndarray:
    """[F,4,4] c2w training poses -> [n_novel,4,4] smooth trajectory."""
    centers = c2ws[:, :3, 3]
    smooth_centers = scipy_bspline(centers, n=n_novel,
                                   degree=min(degree, len(c2ws) - 1))

    rots = Rotation.from_matrix(c2ws[:, :3, :3])
    key_times = np.linspace(0.0, 1.0, len(c2ws))
    slerp = Slerp(key_times, rots)
    t = np.linspace(0.0, 1.0, n_novel)
    interp_R = slerp(t).as_matrix()

    out = np.tile(np.eye(4, dtype=np.float64), (n_novel, 1, 1))
    out[:, :3, :3] = interp_R
    out[:, :3, 3] = smooth_centers
    return out.astype(np.float32)
