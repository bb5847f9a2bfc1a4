"""Rotation conversions (counterpart of ``pantomatrix_tpu/core/rotations.py``):
axis-angle <-> quaternion <-> matrix <-> 6D, used by the EMAGE decode path, and
Euler angles, quaternion algebra and random rotations.

Same formulas, small-angle Taylor guards and sign conventions as the JAX module;
quaternions are (w, x, y, z). Shape-polymorphic over leading dims. The random rotations
take a ``torch.Generator`` where the JAX functions take a key: they draw normals and
normalise as the JAX functions do, but not ``jax.random``'s stream.
"""
from __future__ import annotations

from typing import Optional

import torch


def _copysign(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Magnitude of ``a`` with the sign of ``b`` (sign mismatch flips ``a``)."""
    return torch.where((a < 0) != (b < 0), -a, a)


def _sqrt_positive_part(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(x, 0))."""
    return torch.where(x > 0, torch.sqrt(torch.where(x > 0, x, torch.ones_like(x))),
                       torch.zeros_like(x))


def standardize_quaternion(quaternions: torch.Tensor) -> torch.Tensor:
    """Canonicalize to the hemisphere with non-negative real part."""
    return torch.where(quaternions[..., 0:1] < 0, -quaternions, quaternions)


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


# ---------------------------------------------------------------------------
# Euler angles (intrinsic conventions such as "XYZ")
# ---------------------------------------------------------------------------

def _axis_angle_rotation(axis: str, angle: torch.Tensor) -> torch.Tensor:
    """(...) angles -> (..., 3, 3) rotations about one of the axes X, Y, Z."""
    cos, sin = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(angle), torch.zeros_like(angle)
    if axis == "X":
        flat = (one, zero, zero, zero, cos, -sin, zero, sin, cos)
    elif axis == "Y":
        flat = (cos, zero, sin, zero, one, zero, -sin, zero, cos)
    elif axis == "Z":
        flat = (cos, -sin, zero, sin, cos, zero, zero, zero, one)
    else:
        raise ValueError("letter must be either X, Y or Z.")
    return torch.stack(flat, dim=-1).reshape(angle.shape + (3, 3))


def _check_convention(convention: str) -> None:
    if len(convention) != 3:
        raise ValueError("Convention must have 3 letters.")
    if convention[1] in (convention[0], convention[2]):
        raise ValueError(f"Invalid convention {convention}.")
    for letter in convention:
        if letter not in ("X", "Y", "Z"):
            raise ValueError(f"Invalid letter {letter} in convention string.")


def euler_angles_to_matrix(euler_angles: torch.Tensor, convention: str) -> torch.Tensor:
    """(..., 3) Euler angles -> (..., 3, 3) under an intrinsic convention like "XYZ"."""
    if euler_angles.shape[-1] != 3:
        raise ValueError("Invalid input euler angles.")
    _check_convention(convention)
    m0, m1, m2 = (_axis_angle_rotation(c, e)
                  for c, e in zip(convention, euler_angles.unbind(-1)))
    return m0 @ m1 @ m2


def _index_from_letter(letter: str) -> int:
    return {"X": 0, "Y": 1, "Z": 2}[letter]


def _angle_from_tan(axis: str, other_axis: str, data: torch.Tensor, horizontal: bool,
                    tait_bryan: bool) -> torch.Tensor:
    """The first or third angle of a convention from a row or column of the matrix."""
    i1, i2 = {"X": (2, 1), "Y": (0, 2), "Z": (1, 0)}[axis]
    if horizontal:
        i2, i1 = i1, i2
    even = (axis + other_axis) in ("XY", "YZ", "ZX")
    if horizontal == even:
        return torch.atan2(data[..., i1], data[..., i2])
    if tait_bryan:
        return torch.atan2(-data[..., i2], data[..., i1])
    return torch.atan2(data[..., i2], -data[..., i1])


def matrix_to_euler_angles(matrix: torch.Tensor, convention: str) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3) Euler angles under an intrinsic convention."""
    _check_convention(convention)
    if matrix.shape[-1] != 3 or matrix.shape[-2] != 3:
        raise ValueError(f"Invalid rotation matrix shape {tuple(matrix.shape)}.")
    i0 = _index_from_letter(convention[0])
    i2 = _index_from_letter(convention[2])
    tait_bryan = i0 != i2
    if tait_bryan:
        central = torch.asin(matrix[..., i0, i2] * (-1.0 if i0 - i2 in (-1, 2) else 1.0))
    else:
        central = torch.acos(matrix[..., i0, i0])
    return torch.stack((
        _angle_from_tan(convention[0], convention[1], matrix[..., i2], False, tait_bryan),
        central,
        _angle_from_tan(convention[2], convention[1], matrix[..., i0, :], True, tait_bryan),
    ), dim=-1)


# ---------------------------------------------------------------------------
# quaternion algebra
# ---------------------------------------------------------------------------

def quaternion_raw_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of wxyz quaternions (not normalized)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    ow = aw * bw - ax * bx - ay * by - az * bz
    ox = aw * bx + ax * bw + ay * bz - az * by
    oy = aw * by - ax * bz + ay * bw + az * bx
    oz = aw * bz + ax * by - ay * bx + az * bw
    return torch.stack((ow, ox, oy, oz), dim=-1)


def quaternion_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product, standardized to a non-negative real part."""
    return standardize_quaternion(quaternion_raw_multiply(a, b))


def quaternion_invert(quaternion: torch.Tensor) -> torch.Tensor:
    """Inverse of a unit quaternion (its conjugate)."""
    return quaternion * quaternion.new_tensor([1, -1, -1, -1])


def quaternion_apply(quaternion: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    """Rotate (..., 3) points by (..., 4) wxyz quaternions."""
    if point.shape[-1] != 3:
        raise ValueError(f"Points are not in 3D, {tuple(point.shape)}.")
    real = point.new_zeros(point.shape[:-1] + (1,))
    out = quaternion_raw_multiply(
        quaternion_raw_multiply(quaternion, torch.cat((real, point), dim=-1)),
        quaternion_invert(quaternion))
    return out[..., 1:]


# ---------------------------------------------------------------------------
# random rotations
# ---------------------------------------------------------------------------

def random_quaternions(n: int, generator: Optional[torch.Generator] = None,
                       dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """n uniform random unit wxyz quaternions (double cover; not standardized): normals
    drawn from ``generator`` and normalised (not ``jax.random``'s stream)."""
    o = torch.randn((n, 4), generator=generator, dtype=dtype, device=device)
    return o / torch.linalg.vector_norm(o, dim=-1, keepdim=True)


def random_rotations(n: int, generator: Optional[torch.Generator] = None,
                     dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """n uniform random rotation matrices, (n, 3, 3)."""
    return quaternion_to_matrix(random_quaternions(n, generator, dtype, device))


def random_rotation(generator: Optional[torch.Generator] = None,
                    dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """One uniform random rotation matrix, (3, 3)."""
    return random_rotations(1, generator, dtype, device)[0]


__all__ = [
    "axis_angle_to_matrix",
    "axis_angle_to_quaternion",
    "axis_angle_to_rotation_6d",
    "euler_angles_to_matrix",
    "matrix_to_axis_angle",
    "matrix_to_euler_angles",
    "matrix_to_quaternion",
    "matrix_to_rotation_6d",
    "quaternion_apply",
    "quaternion_invert",
    "quaternion_multiply",
    "quaternion_raw_multiply",
    "quaternion_to_axis_angle",
    "quaternion_to_matrix",
    "random_quaternions",
    "random_rotation",
    "random_rotations",
    "rotation_6d_to_axis_angle",
    "rotation_6d_to_matrix",
    "standardize_quaternion",
]
