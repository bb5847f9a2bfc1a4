"""Rotation conversions used by the EMAGE decode path (counterpart of
``pantomatrix_tpu/core/rotations.py``): axis-angle <-> quaternion <-> matrix <-> 6D.

Same formulas, small-angle Taylor guards and sign conventions as the JAX module;
quaternions are (w, x, y, z). Shape-polymorphic over leading dims.
"""
from __future__ import annotations

import torch


def _copysign(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Magnitude of ``a`` with the sign of ``b`` (sign mismatch flips ``a``)."""
    return torch.where((a < 0) != (b < 0), -a, a)


def _sqrt_positive_part(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(x, 0))."""
    return torch.where(x > 0, torch.sqrt(torch.where(x > 0, x, torch.ones_like(x))),
                       torch.zeros_like(x))


def quaternion_to_matrix(quaternions: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz -> (..., 3, 3)."""
    r, i, j, k = quaternions.unbind(-1)
    two_s = 2.0 / (quaternions * quaternions).sum(-1)
    o = torch.stack(
        (
            1 - two_s * (j * j + k * k),
            two_s * (i * j - k * r),
            two_s * (i * k + j * r),
            two_s * (i * j + k * r),
            1 - two_s * (i * i + k * k),
            two_s * (j * k - i * r),
            two_s * (i * k - j * r),
            two_s * (j * k + i * r),
            1 - two_s * (i * i + j * j),
        ),
        dim=-1,
    )
    return o.reshape(quaternions.shape[:-1] + (3, 3))


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) wxyz, by the reference's copysign construction."""
    if matrix.shape[-1] != 3 or matrix.shape[-2] != 3:
        raise ValueError(f"Invalid rotation matrix shape {tuple(matrix.shape)}.")
    m00 = matrix[..., 0, 0]
    m11 = matrix[..., 1, 1]
    m22 = matrix[..., 2, 2]
    o0 = 0.5 * _sqrt_positive_part(1 + m00 + m11 + m22)
    x = 0.5 * _sqrt_positive_part(1 + m00 - m11 - m22)
    y = 0.5 * _sqrt_positive_part(1 - m00 + m11 - m22)
    z = 0.5 * _sqrt_positive_part(1 - m00 - m11 + m22)
    o1 = _copysign(x, matrix[..., 2, 1] - matrix[..., 1, 2])
    o2 = _copysign(y, matrix[..., 0, 2] - matrix[..., 2, 0])
    o3 = _copysign(z, matrix[..., 1, 0] - matrix[..., 0, 1])
    return torch.stack((o0, o1, o2, o3), dim=-1)


def _sin_half_over(angles: torch.Tensor) -> torch.Tensor:
    """sin(angle / 2) / angle, with the Taylor form 0.5 - angle^2 / 48 below 1e-6."""
    small = angles.abs() < 1e-6
    safe = torch.where(small, torch.ones_like(angles), angles)
    return torch.where(small, 0.5 - (angles * angles) / 48.0, torch.sin(0.5 * angles) / safe)


def axis_angle_to_quaternion(axis_angle: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle -> (..., 4) wxyz."""
    angles = torch.linalg.vector_norm(axis_angle, dim=-1, keepdim=True)
    return torch.cat([torch.cos(0.5 * angles), axis_angle * _sin_half_over(angles)], dim=-1)


def quaternion_to_axis_angle(quaternions: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz -> (..., 3) axis-angle."""
    norms = torch.linalg.vector_norm(quaternions[..., 1:], dim=-1, keepdim=True)
    angles = 2.0 * torch.atan2(norms, quaternions[..., :1])
    return quaternions[..., 1:] / _sin_half_over(angles)


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    return quaternion_to_matrix(axis_angle_to_quaternion(axis_angle))


def matrix_to_axis_angle(matrix: torch.Tensor) -> torch.Tensor:
    return quaternion_to_axis_angle(matrix_to_quaternion(matrix))


def _normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=eps)


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 3, 3) by Gram-Schmidt."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = _normalize(a1)
    b2 = _normalize(a2 - (b1 * a2).sum(-1, keepdim=True) * b1)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack((b1, b2, b3), dim=-2)


def matrix_to_rotation_6d(matrix: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 6): the first two rows."""
    return matrix[..., :2, :].reshape(matrix.shape[:-2] + (6,))


def axis_angle_to_rotation_6d(axis_angle: torch.Tensor) -> torch.Tensor:
    return matrix_to_rotation_6d(axis_angle_to_matrix(axis_angle))


def rotation_6d_to_axis_angle(rot6d: torch.Tensor) -> torch.Tensor:
    return matrix_to_axis_angle(rotation_6d_to_matrix(rot6d))


__all__ = [
    "axis_angle_to_matrix",
    "axis_angle_to_quaternion",
    "axis_angle_to_rotation_6d",
    "matrix_to_axis_angle",
    "matrix_to_quaternion",
    "matrix_to_rotation_6d",
    "quaternion_to_axis_angle",
    "quaternion_to_matrix",
    "rotation_6d_to_axis_angle",
    "rotation_6d_to_matrix",
]
