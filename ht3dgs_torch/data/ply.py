"""PLY import/export of Gaussian models.

Counterpart of `ht3dgs.data.ply`, byte for byte: binary-little-endian PLY
with properties x,y,z, nx,ny,nz (zeros), f_dc_0..2, f_rest_0..3(K-1)-1,
opacity, scale_0..2, rot_0..3, the 3DGS interchange format that standard
viewers read. f_rest is stored channel-major (all R coefficients, then G,
then B) and rot as [w, x, y, z]; the state keeps quats [x, y, z, w].
"""

from __future__ import annotations

import io

import numpy as np
import torch

from ..core import gaussians as G


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def save_ply(state: "G.GaussianState", path: str):
    live = _np(state.live)
    xyz = _np(state.means)[live]
    n = len(xyz)
    K_rest = state.sh_rest.shape[1]
    f_dc = _np(state.sh_dc)[live][:, 0, :]                        # [n,3]
    f_rest = _np(state.sh_rest)[live]                             # [n,K-1,3]
    f_rest = f_rest.transpose(0, 2, 1).reshape(n, -1)             # ch-major
    opacity = _np(state.opacity_logit)[live]
    scales = _np(state.log_scales)[live]
    q = _np(state.quats)[live]
    rot = np.stack([q[:, 3], q[:, 0], q[:, 1], q[:, 2]], axis=1)  # wxyz

    props = (["x", "y", "z", "nx", "ny", "nz"]
             + [f"f_dc_{i}" for i in range(3)]
             + [f"f_rest_{i}" for i in range(3 * K_rest)]
             + ["opacity"]
             + [f"scale_{i}" for i in range(3)]
             + [f"rot_{i}" for i in range(4)])
    data = np.concatenate(
        [xyz, np.zeros_like(xyz), f_dc, f_rest, opacity, scales, rot],
        axis=1).astype("<f4")

    header = io.StringIO()
    header.write("ply\nformat binary_little_endian 1.0\n")
    header.write(f"element vertex {n}\n")
    for p in props:
        header.write(f"property float {p}\n")
    header.write("end_header\n")
    with open(path, "wb") as f:
        f.write(header.getvalue().encode("ascii"))
        f.write(data.tobytes())


def load_ply(path: str, max_sh_degree: int = 3, capacity: int = 0,
             device="cuda") -> "G.GaussianState":
    """A state of max(capacity, n) rows on `device`, every SH degree
    active (the reference's load_ply)."""
    with open(path, "rb") as f:
        props = []
        n = 0
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property float"):
                props.append(line.split()[-1])
            elif line == "end_header":
                break
            elif line.startswith("format") and "binary_little" not in line:
                raise ValueError("only binary_little_endian PLY supported")
        data = np.frombuffer(f.read(4 * n * len(props)),
                             dtype="<f4").reshape(n, len(props))
    col = {p: i for i, p in enumerate(props)}

    xyz = data[:, [col["x"], col["y"], col["z"]]]
    f_dc = data[:, [col["f_dc_0"], col["f_dc_1"], col["f_dc_2"]]]
    rest_names = sorted((p for p in props if p.startswith("f_rest_")),
                        key=lambda s: int(s.split("_")[-1]))
    K_rest = len(rest_names) // 3
    f_rest = data[:, [col[p] for p in rest_names]].reshape(n, 3, K_rest)
    f_rest = f_rest.transpose(0, 2, 1)                            # [n,K-1,3]
    opacity = data[:, col["opacity"]][:, None]
    scales = data[:, [col["scale_0"], col["scale_1"], col["scale_2"]]]
    rot = data[:, [col["rot_0"], col["rot_1"], col["rot_2"], col["rot_3"]]]
    quats = np.stack([rot[:, 1], rot[:, 2], rot[:, 3], rot[:, 0]], axis=1)

    cap = max(capacity, n)

    def pad(x, fill=0.0):
        out = np.full((cap,) + x.shape[1:], fill, np.float32)
        out[:n] = x
        return torch.as_tensor(out, device=device)

    live = np.zeros(cap, bool)
    live[:n] = True
    quats_pad = np.zeros((cap, 4), np.float32)
    quats_pad[:, 3] = 1.0
    quats_pad[:n] = quats

    def zeros():
        return torch.zeros(cap, device=device)

    return G.GaussianState(
        means=pad(xyz),
        quats=torch.as_tensor(quats_pad, device=device),
        log_scales=pad(scales, fill=-10.0),
        sh_dc=pad(f_dc[:, None, :]),
        sh_rest=pad(f_rest),
        opacity_logit=pad(opacity),
        live=torch.as_tensor(live, device=device),
        max_radii2d=zeros(), grad_accum=zeros(), grad_denom=zeros(),
        active_sh_degree=torch.tensor(max_sh_degree, dtype=torch.int32,
                                      device=device),
        max_sh_degree=max_sh_degree,
    )
