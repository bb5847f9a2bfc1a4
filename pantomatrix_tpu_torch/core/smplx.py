"""The SMPL-X rest pose (a minimal counterpart of ``pantomatrix_tpu/core/smplx.py``): the
archive lookup, the fields that the rest pose needs, and its joints, which give the
ground-offset translation of ``io/beat_format.py``. Full forward kinematics is not
ported yet.

The archive is the standard ``SMPLX_NEUTRAL_2020.npz`` (not shipped here; path via the
``SMPLX_MODEL_PATH`` environment variable or ``default_model_path()``).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

NUM_JOINTS = 55
NUM_BETAS = 300


@dataclass(frozen=True, eq=False)
class SmplxRestModel:
    """What the rest pose needs of an SMPL-X archive, as float32 tensors."""

    v_template: torch.Tensor   # (V, 3)
    shapedirs: torch.Tensor    # (V, 3, NUM_BETAS) shape blendshapes
    j_regressor: torch.Tensor  # (NUM_JOINTS, V)


def default_model_path() -> Optional[str]:
    """Locate SMPLX_NEUTRAL_2020.npz: $SMPLX_MODEL_PATH, then the JAX package's
    candidate locations."""
    env = os.environ.get("SMPLX_MODEL_PATH")
    if env:
        return env
    for cand in (
        "./emage_evaltools/smplx_models/smplx/SMPLX_NEUTRAL_2020.npz",
        os.path.expanduser("~/.cache/pantomatrix_tpu/SMPLX_NEUTRAL_2020.npz"),
    ):
        if os.path.exists(cand):
            return cand
    return None


def load_smplx_rest(path: str, num_betas: int = NUM_BETAS) -> SmplxRestModel:
    """The template, the first ``num_betas`` shape blendshapes (the 2020 archive stores
    300 shape then 100 expression components) and the 55-joint regressor."""
    with np.load(path, allow_pickle=True) as data:
        shapedirs = np.asarray(data["shapedirs"], np.float32)
        if shapedirs.shape[-1] < num_betas:
            raise ValueError(f"model has {shapedirs.shape[-1]} blendshapes < {num_betas}")
        return SmplxRestModel(
            v_template=torch.from_numpy(np.asarray(data["v_template"], np.float32)),
            shapedirs=torch.from_numpy(np.ascontiguousarray(shapedirs[:, :, :num_betas])),
            j_regressor=torch.from_numpy(
                np.asarray(data["J_regressor"], np.float32)[:NUM_JOINTS]),
        )


def rest_pose_joints(model: SmplxRestModel, betas) -> torch.Tensor:
    """(55, 3) joints of the zero pose for ``betas`` (300,).

    At the zero pose every rotation is the identity, so the JAX package's linear blend
    skinning (``lbs``: kinematic chain, pose blendshapes) leaves the regressed joints
    where they are: J_regressor . (v_template + shapedirs . betas). Pose blendshapes
    move vertices, never the regressed joints."""
    b = torch.as_tensor(np.asarray(betas, np.float32))[: model.shapedirs.shape[-1]]
    v_shaped = model.v_template + torch.einsum("vcs,s->vc", model.shapedirs, b)
    return model.j_regressor @ v_shaped


__all__ = ["SmplxRestModel", "default_model_path", "load_smplx_rest", "rest_pose_joints"]
