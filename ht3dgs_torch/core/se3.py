"""SE(3) / SO(3) operations, differentiable by torch autograd.

Counterpart of `ht3dgs.core.se3`, with its conventions:
- poses are 7-vectors `[tx, ty, tz, qx, qy, qz, qw]`;
- quaternions are `[x, y, z, w]`;
- tangents are `[rho(3), phi(3)]` (translation first);
- `se3_retr(delta, base) = exp(delta) ∘ base` (left update);
- `se3_act(pose, p) = R(q) p + t`.

`torch.where` passes a NaN gradient from the branch it does not select just
as `jnp.where` does, so every denominator is made safe BEFORE the `where`.
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-8


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True),
                           min=_EPS)


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product: the rotation R(q1) R(q2)."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=-1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v [..., 3] by unit quaternions q [..., 4]."""
    qvec = q[..., :3]
    w = q[..., 3:4]
    qvec, v = torch.broadcast_tensors(qvec, v)
    uv = torch.linalg.cross(qvec, v, dim=-1)
    uuv = torch.linalg.cross(qvec, uv, dim=-1)
    return v + 2.0 * (w * uv + uuv)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [..., 4] -> rotation matrix [..., 3, 3]."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
        2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
        2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> unit quaternion [x, y, z, w] with
    w >= 0: the Shepperd row of the largest diagonal score, chosen without
    data-dependent control flow."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    # one candidate per dominant component, each [w, x, y, z]
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10,
                      m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22,
                      m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21,
                      1.0 - m00 - m11 + m22], dim=-1)
    cand = torch.stack([qw, qx, qy, qz], dim=-2)
    scores = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22,
                          m22 - m00 - m11], dim=-1)
    best = torch.argmax(scores, dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q_wxyz = quat_normalize(torch.gather(cand, -2, idx)[..., 0, :])
    q = torch.cat([q_wxyz[..., 1:4], q_wxyz[..., 0:1]], dim=-1)
    return q * torch.where(q[..., 3:4] < 0, -1.0, 1.0)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rotation vector [..., 3] -> unit quaternion, Taylor-safe at 0."""
    theta_sq = (phi * phi).sum(-1, keepdim=True)
    small = theta_sq < 1e-8
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta_sq),
                                   theta_sq))
    half = 0.5 * theta
    k = torch.where(small, 0.5 - theta_sq / 48.0, torch.sin(half) / theta)
    w = torch.where(small, 1.0 - theta_sq / 8.0, torch.cos(half))
    return torch.cat([k * phi, w], dim=-1)


def so3_log(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> rotation vector, Taylor-safe near identity."""
    qv = q[..., :3]
    w = q[..., 3:4]
    sign = torch.where(w < 0, -1.0, 1.0)
    qv = qv * sign
    w = w * sign
    nv_sq = (qv * qv).sum(-1, keepdim=True)
    small = nv_sq < 1e-12
    nv = torch.sqrt(torch.where(small, torch.ones_like(nv_sq), nv_sq))
    theta = 2.0 * torch.atan2(nv, w)
    scale = torch.where(small, 2.0 / torch.clamp(w, min=1e-8), theta / nv)
    return scale * qv


def _hat(phi: torch.Tensor) -> torch.Tensor:
    x, y, z = phi.unbind(-1)
    zeros = torch.zeros_like(x)
    return torch.stack([zeros, -z, y, z, zeros, -x, -y, x, zeros],
                       dim=-1).reshape(phi.shape[:-1] + (3, 3))


def _so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """V such that exp_SE3([v, w]).t = V @ v."""
    theta_sq = (phi * phi).sum(-1)[..., None, None]
    small = theta_sq < 1e-8
    theta_sq_safe = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(theta_sq_safe)
    Phi = _hat(phi)
    a = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(theta)) / theta_sq_safe)
    b = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                    (theta - torch.sin(theta)) / (theta_sq_safe * theta))
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye + a * Phi + b * (Phi @ Phi)


def _so3_left_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    theta_sq = (phi * phi).sum(-1)[..., None, None]
    small = theta_sq < 1e-8
    theta_sq_safe = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(theta_sq_safe)
    Phi = _hat(phi)
    half_theta = 0.5 * theta
    sin_half = torch.where(small, torch.ones_like(theta),
                           torch.sin(half_theta))
    cot_term = torch.where(
        small, 1.0 / 12.0 + theta_sq / 720.0,
        (1.0 - half_theta * torch.cos(half_theta) / sin_half) / theta_sq_safe)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye - 0.5 * Phi + cot_term * (Phi @ Phi)


def se3_act(pose: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply pose [..., 7] to points [..., 3]."""
    return quat_rotate(quat_normalize(pose[..., 3:7]), pts) + pose[..., :3]


def se3_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compose: (a ∘ b)(p) = a(b(p))."""
    qa = quat_normalize(a[..., 3:7])
    qb = quat_normalize(b[..., 3:7])
    q = quat_mul(qa, qb)
    t = quat_rotate(qa, b[..., :3]) + a[..., :3]
    return torch.cat([t, q], dim=-1)


def se3_inv(pose: torch.Tensor) -> torch.Tensor:
    qi = quat_conj(quat_normalize(pose[..., 3:7]))
    ti = -quat_rotate(qi, pose[..., :3])
    return torch.cat([ti, qi], dim=-1)


def se3_exp(tau: torch.Tensor) -> torch.Tensor:
    """Tangent [..., 6] = [v, w] -> SE(3) 7-vector."""
    v = tau[..., :3]
    w = tau[..., 3:6]
    t = (_so3_left_jacobian(w) @ v[..., None])[..., 0]
    return torch.cat([t, so3_exp(w)], dim=-1)


def se3_log(pose: torch.Tensor) -> torch.Tensor:
    """SE(3) 7-vector -> tangent [..., 6] = [v, w]."""
    w = so3_log(quat_normalize(pose[..., 3:7]))
    v = (_so3_left_jacobian_inv(w) @ pose[..., :3, None])[..., 0]
    return torch.cat([v, w], dim=-1)


def se3_retr(delta: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """Left retraction exp(delta) ∘ base."""
    return se3_mul(se3_exp(delta), base)


def se3_identity(batch_shape=(), dtype=torch.float32,
                 device="cuda") -> torch.Tensor:
    ident = torch.tensor([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0], dtype=dtype,
                         device=device)
    return ident.expand(tuple(batch_shape) + (7,))


def se3_to_matrix(pose: torch.Tensor) -> torch.Tensor:
    """SE(3) 7-vector -> homogeneous [..., 4, 4]."""
    R = quat_to_matrix(quat_normalize(pose[..., 3:7]))
    top = torch.cat([R, pose[..., :3, None]], dim=-1)
    bottom = pose.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(
        pose.shape[:-1] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def se3_from_matrix(T: torch.Tensor) -> torch.Tensor:
    return torch.cat([T[..., :3, 3], matrix_to_quat(T[..., :3, :3])], dim=-1)


def se3_interp(pose0: torch.Tensor, pose1: torch.Tensor,
               alpha) -> torch.Tensor:
    """Geodesic interpolation pose0 ∘ exp(alpha * log(pose0⁻¹ ∘ pose1))."""
    rel = se3_mul(se3_inv(pose0), pose1)
    return se3_mul(pose0, se3_exp(se3_log(rel) * alpha))


def se3_from_Rt(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Numpy convenience: world2cam R (3,3), t (3,) -> 7-vector."""
    T = np.eye(4, dtype=np.float64)
    T[:3, :3] = R
    T[:3, 3] = t
    pose = se3_from_matrix(torch.from_numpy(T.astype(np.float32)))
    return pose.numpy().astype(np.float32)
