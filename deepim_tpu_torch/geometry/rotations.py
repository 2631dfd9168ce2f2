"""Rotation parameterizations: quaternion / matrix / euler.

Port of ``deepim_tpu/geometry/rotations.py`` (``quat_normalize``,
``quat2mat``, ``mat2quat``, ``euler2mat``, ``euler2quat``, ``random_quat``).

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


def euler2quat(ax: torch.Tensor, ay: torch.Tensor, az: torch.Tensor) -> torch.Tensor:
    """Static-sxyz euler -> quaternion (w, x, y, z)."""
    return mat2quat(euler2mat(ax, ay, az))


def random_quat(generator: torch.Generator, shape: tuple = (),
                device: torch.device | str = "cpu") -> torch.Tensor:
    """Uniform random unit quaternion(s) with w >= 0 (shape + (4,)).

    Draws from ``generator``, which must live on ``device``.
    """
    q = torch.randn(shape + (4,), generator=generator, device=device)
    q = quat_normalize(q)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)
