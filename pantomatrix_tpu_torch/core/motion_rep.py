"""Motion representations from axis-angle poses through SMPL-X FK (counterpart of
``pantomatrix_tpu/core/motion_rep.py``): joint positions, velocities, rot6d, angular
velocities and rep15d, or the face vertices of the expression-only pass.

The body FK zeroes the global orient, translation, expression, jaw and eyes; velocities
are central differences (forward at the first frame, backward at the last); rep15d =
[position | velocity | rot6d | angular velocity] over 55 joints. It runs on the device
of the model's tensors and returns numpy, as the JAX version does.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..nn.layers import strict_fp32
from .rotations import axis_angle_to_matrix, matrix_to_rotation_6d
from .smplx import NUM_BETAS, SmplxModel, body_joints, face_vertices


def _central_diff(x: torch.Tensor, dt: float) -> torch.Tensor:
    """(t, ...) -> per-frame derivative: forward at 0, central inside, backward at -1."""
    return torch.cat([(x[1:2] - x[0:1]) / dt, (x[2:] - x[:-2]) / (2 * dt),
                      (x[-1:] - x[-2:-1]) / dt], dim=0)


@torch.no_grad()
@strict_fp32()
def get_motion_rep(model: SmplxModel, poses, pose_fps: int = 30, betas=None,
                   expressions=None, expression_only: bool = False) -> Dict[str, np.ndarray]:
    """poses (t, 165) axis-angle -> ``position``, ``velocity``, ``rotation`` (rot6d),
    ``angular_velocity`` (each (t, 55, c)), ``rep15d`` (t, 825) and the input
    ``axis_angle``. With ``expression_only``, only the face ``vertices`` (t, V*3) from
    the jaw and ``expressions``."""
    dev = model.device
    poses_t = torch.as_tensor(np.asarray(poses, np.float32), device=dev)
    betas_t = (None if betas is None
               else torch.as_tensor(np.asarray(betas, np.float32), device=dev)[:NUM_BETAS])
    if expression_only:
        if expressions is None:
            raise ValueError("expression_only needs expressions")
        verts = face_vertices(model, poses_t,
                              torch.as_tensor(np.asarray(expressions, np.float32), device=dev),
                              betas_t)
        return {"vertices": verts.reshape(verts.shape[0], -1).cpu().numpy()}
    t = poses_t.shape[0]
    dt = 1.0 / pose_fps
    joints = body_joints(model, poses_t, betas_t)
    vel = _central_diff(joints, dt)
    rot6d = matrix_to_rotation_6d(axis_angle_to_matrix(poses_t.reshape(t, 55, 3)))
    ang_vel = _central_diff(poses_t, dt).reshape(t, 55, 3)
    rep15d = torch.cat([joints, vel, rot6d, ang_vel], dim=2).reshape(t, 55 * 15)
    out = {"position": joints, "velocity": vel, "rotation": rot6d,
           "angular_velocity": ang_vel, "rep15d": rep15d}
    out = {k: v.cpu().numpy() for k, v in out.items()}
    out["axis_angle"] = np.asarray(poses)
    return out


__all__ = ["get_motion_rep"]
