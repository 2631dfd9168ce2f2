"""Rotation parameterizations: quaternion / matrix / euler.

Port of ``deepim_tpu/geometry/rotations.py`` (``quat_normalize``,
``quat_conjugate``, ``quat_mul``, ``quat2mat``, ``mat2quat``,
``euler2mat``, ``mat2euler``, ``euler2quat``, ``quat2euler``,
``axangle2quat``, ``axangle2mat``, ``random_quat``, ``quat_slerp``,
``rotation_angle``).

Conventions: quaternions are ``(w, x, y, z)``, scalar-first; euler angles are
static ``sxyz`` (``R = Rz(az) @ Ry(ay) @ Rx(ax)``).  Every function maps
over leading dims and computes in the inputs' dtype and device.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    """Normalize quaternion(s) to unit norm; (..., 4) -> (..., 4)."""
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(_EPS)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    """Conjugate (= inverse for unit quats); (..., 4) -> (..., 4)."""
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 (x) q2: the rotation R(q1) @ R(q2)."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat2mat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion(s) (..., 4) -> rotation matrix (..., 3, 3)."""
    q = quat_normalize(q)
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def mat2quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4), w >= 0.

    Branch-free Shepperd's method: all four candidates, selected by the
    largest diagonal combination (``argmax`` takes the first maximum, as
    ``jnp.argmax`` does).
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    scores = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22,
         1.0 - m00 - m11 + m22],
        dim=-1,
    )
    idx = torch.argmax(scores, dim=-1)
    cand = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4 candidates, 4)
    q = torch.take_along_dim(cand, idx[..., None, None], dim=-2).squeeze(-2)
    q = quat_normalize(q)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def euler2mat(ax: torch.Tensor, ay: torch.Tensor, az: torch.Tensor) -> torch.Tensor:
    """Static-sxyz euler angles (radians) -> (..., 3, 3): Rz @ Ry @ Rx."""
    cx, sx = torch.cos(ax), torch.sin(ax)
    cy, sy = torch.cos(ay), torch.sin(ay)
    cz, sz = torch.cos(az), torch.sin(az)
    m = torch.stack(
        [
            cy * cz, sx * sy * cz - cx * sz, cx * sy * cz + sx * sz,
            cy * sz, sx * sy * sz + cx * cz, cx * sy * sz - sx * cz,
            -sy, sx * cy, cx * cy,
        ],
        dim=-1,
    )
    return m.reshape(ax.shape + (3, 3))


def mat2euler(m: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(..., 3, 3) -> (ax, ay, az) static-sxyz euler angles (radians); at
    gimbal lock (``cy <= 1e-6``) the ax-carrying solution, az = 0."""
    cy = torch.sqrt(m[..., 0, 0] ** 2 + m[..., 1, 0] ** 2)
    safe = cy > 1e-6
    ax = torch.where(safe, torch.atan2(m[..., 2, 1], m[..., 2, 2]),
                     torch.atan2(-m[..., 1, 2], m[..., 1, 1]))
    ay = torch.atan2(-m[..., 2, 0], cy)
    az = torch.where(safe, torch.atan2(m[..., 1, 0], m[..., 0, 0]), 0.0)
    return ax, ay, az


def euler2quat(ax: torch.Tensor, ay: torch.Tensor, az: torch.Tensor) -> torch.Tensor:
    """Static-sxyz euler -> quaternion (w, x, y, z)."""
    return mat2quat(euler2mat(ax, ay, az))


def quat2euler(q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quaternion -> static-sxyz euler angles."""
    return mat2euler(quat2mat(q))


def axangle2quat(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Axis (..., 3) (need not be unit) and angle (...,) -> quaternion."""
    axis = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True).clamp_min(_EPS)
    half = angle[..., None] * 0.5
    return torch.cat([torch.cos(half), axis * torch.sin(half)], dim=-1)


def axangle2mat(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Axis-angle -> rotation matrix."""
    return quat2mat(axangle2quat(axis, angle))


def random_quat(generator: torch.Generator, shape: tuple = ()) -> torch.Tensor:
    """Uniform random unit quaternion(s) with w >= 0 (shape + (4,)), drawn
    from ``generator`` on its own device."""
    q = torch.randn(shape + (4,), generator=generator, device=generator.device)
    q = quat_normalize(q)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def rotation_angle(m: torch.Tensor) -> torch.Tensor:
    """Geodesic rotation angle (radians) of rotation matrix(es) (..., 3, 3)."""
    tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    return torch.arccos(((tr - 1.0) * 0.5).clamp(-1.0, 1.0))


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Spherical interpolation between unit quaternions (..., 4) at
    ``t`` in [0, 1] (...,).

    Shortest path (``q1`` flips sign when the two point apart); where
    ``sin θ <= 1e-5`` the quaternions are nearly parallel and it lerps
    instead, branch-free through ``torch.where``.  ``gen_video`` draws its
    trajectories with it.
    """
    q0 = quat_normalize(q0)
    q1 = quat_normalize(q1)
    dot = (q0 * q1).sum(-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = dot.abs().clamp(-1.0, 1.0)
    theta = torch.arccos(dot)
    sin_theta = torch.sin(theta)
    safe = sin_theta > 1e-5
    t = t[..., None] if t.dim() < dot.dim() else t
    w0 = torch.where(safe, torch.sin((1 - t) * theta) / sin_theta.clamp_min(1e-9), 1 - t)
    w1 = torch.where(safe, torch.sin(t * theta) / sin_theta.clamp_min(1e-9), t)
    return quat_normalize(w0 * q0 + w1 * q1)
