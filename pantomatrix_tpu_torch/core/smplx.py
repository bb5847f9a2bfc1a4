"""SMPL-X forward kinematics (counterpart of ``pantomatrix_tpu/core/smplx.py``): the
archive loader, linear blend skinning, and the joint and vertex views that evaluation
(``core/motion_rep.py``), the ground-offset translation of ``io/beat_format.py`` and
rendering use.

Numerics follow the JAX package's LBS, which follows the ``smplx`` package: the
``flat_hand_mean=False`` default adds the hand mean poses to the 90 hand inputs, and the
pose-blendshape feature is ``R - I`` over the 54 non-root joints. Every product runs in
float32 under ``strict_fp32()`` (TF32 would move vertices by ~1e-3 relative).

The archive is the standard ``SMPLX_NEUTRAL_2020.npz`` (not shipped here; path via the
``SMPLX_MODEL_PATH`` environment variable or ``default_model_path()``). ``read_smplx``
reads it into numpy on the host; ``SmplxModel.from_numpy`` puts those arrays on a
device; ``load_smplx`` does both.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..nn.layers import strict_fp32
from .rotations import axis_angle_to_matrix

NUM_JOINTS = 55
NUM_BETAS = 300
NUM_EXPRESSIONS = 100

# 165-d BEAT pose vector layout (axis-angle, 55 joints):
#   [0:3] global_orient, [3:66] body (21), [66:69] jaw, [69:72] leye, [72:75] reye,
#   [75:120] left hand (15), [120:165] right hand (15).
JAW_IDX = 22

# The smplx package's auxiliary joints after the 55 LBS joints: 5 face keypoints,
# 6 foot points, 10 finger tips (vertex picks); face landmarks follow from the
# barycentric landmark embedding.
VERTEX_IDS = {
    "nose": 9120, "reye": 9929, "leye": 9448, "rear": 616, "lear": 6,
    "LBigToe": 5770, "LSmallToe": 5780, "LHeel": 8846,
    "RBigToe": 8463, "RSmallToe": 8474, "RHeel": 8635,
    "lthumb": 5361, "lindex": 4933, "lmiddle": 5058, "lring": 5169, "lpinky": 5286,
    "rthumb": 8079, "rindex": 7669, "rmiddle": 7794, "rring": 7905, "rpinky": 8022,
}
EXTRA_JOINT_NAMES = [
    "nose", "reye", "leye", "rear", "lear",
    "LBigToe", "LSmallToe", "LHeel", "RBigToe", "RSmallToe", "RHeel",
    "lthumb", "lindex", "lmiddle", "lring", "lpinky",
    "rthumb", "rindex", "rmiddle", "rring", "rpinky",
]


@dataclass(frozen=True, eq=False)
class SmplxModel:
    """An SMPL-X body as float32 tensors (float64 for a reference) on one device; the
    topology stays on the host."""

    v_template: torch.Tensor   # (V, 3)
    shapedirs: torch.Tensor    # (V, 3, NUM_BETAS) shape blendshapes
    exprdirs: torch.Tensor     # (V, 3, NUM_EXPRESSIONS) expression blendshapes
    posedirs: torch.Tensor     # (486, V*3) pose blendshapes (row-major over (V, 3))
    j_regressor: torch.Tensor  # (J, V)
    lbs_weights: torch.Tensor  # (V, J)
    hands_mean: torch.Tensor   # (90,) left + right hand mean pose (axis-angle)
    parents: np.ndarray        # (J,) int; parents[0] == -1
    faces: np.ndarray          # (F, 3) triangle vertex ids
    lmk_faces_idx: Optional[np.ndarray] = None    # (51,) triangle per landmark
    lmk_bary_coords: Optional[np.ndarray] = None  # (51, 3) barycentric weights

    @property
    def num_vertices(self) -> int:
        return self.v_template.shape[0]

    @property
    def device(self) -> torch.device:
        return self.v_template.device

    @classmethod
    def from_numpy(cls, arrays: Dict[str, np.ndarray], device,
                   dtype: torch.dtype = torch.float32) -> "SmplxModel":
        """``read_smplx``'s arrays as a model on ``device``, in ``dtype``."""
        dev = torch.device(device)
        tensor = lambda k: torch.as_tensor(np.ascontiguousarray(arrays[k]), dtype=dtype,
                                           device=dev)
        return cls(
            v_template=tensor("v_template"), shapedirs=tensor("shapedirs"),
            exprdirs=tensor("exprdirs"), posedirs=tensor("posedirs"),
            j_regressor=tensor("j_regressor"), lbs_weights=tensor("lbs_weights"),
            hands_mean=tensor("hands_mean"), parents=arrays["parents"],
            faces=arrays["faces"], lmk_faces_idx=arrays.get("lmk_faces_idx"),
            lmk_bary_coords=arrays.get("lmk_bary_coords"),
        )


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


def read_smplx(path: str) -> Dict[str, np.ndarray]:
    """Read SMPLX_NEUTRAL_2020.npz into host arrays, in ``SmplxModel``'s layout.

    The 2020 archive stores shapedirs as (V, 3, 400), 300 shape then 100 expression
    components, and posedirs as (V, 3, 486)."""
    with np.load(path, allow_pickle=True) as data:
        shapedirs = np.asarray(data["shapedirs"], np.float32)
        if shapedirs.shape[-1] < NUM_BETAS + NUM_EXPRESSIONS:
            raise ValueError(f"model has {shapedirs.shape[-1]} blendshapes < "
                             f"{NUM_BETAS}+{NUM_EXPRESSIONS}")
        v = shapedirs.shape[0]
        parents = np.asarray(data["kintree_table"], np.int64)[0][:NUM_JOINTS].copy()
        parents[0] = -1
        return {
            "v_template": np.asarray(data["v_template"], np.float32),
            "shapedirs": shapedirs[:, :, :NUM_BETAS],
            "exprdirs": shapedirs[:, :, NUM_BETAS:NUM_BETAS + NUM_EXPRESSIONS],
            "posedirs": np.asarray(data["posedirs"], np.float32).reshape(v * 3, -1).T,
            "j_regressor": np.asarray(data["J_regressor"], np.float32)[:NUM_JOINTS],
            "lbs_weights": np.asarray(data["weights"], np.float32)[:, :NUM_JOINTS],
            "hands_mean": np.concatenate([
                np.asarray(data["hands_meanl"], np.float32).reshape(-1),
                np.asarray(data["hands_meanr"], np.float32).reshape(-1)]),
            "parents": parents,
            "faces": np.asarray(data["f"], np.int32),
            "lmk_faces_idx": (np.asarray(data["lmk_faces_idx"], np.int64)
                              if "lmk_faces_idx" in data else None),
            "lmk_bary_coords": (np.asarray(data["lmk_bary_coords"], np.float32)
                                if "lmk_bary_coords" in data else None),
        }


def load_smplx(path: str, device) -> SmplxModel:
    """Load SMPLX_NEUTRAL_2020.npz onto ``device``."""
    return SmplxModel.from_numpy(read_smplx(path), device)


def full_pose_with_hand_mean(model: SmplxModel, poses: torch.Tensor,
                             flat_hand_mean: bool = False) -> torch.Tensor:
    """The smplx ``flat_hand_mean=False`` convention: add the hand means to [75:165]."""
    if flat_hand_mean:
        return poses
    return torch.cat([poses[..., :75], poses[..., 75:165] + model.hands_mean], dim=-1)


def _compose_chain(parents: np.ndarray, rot_mats: torch.Tensor, joints: torch.Tensor):
    """The kinematic chain per frame: rot_mats (T, J, 3, 3), joints (T, J, 3) ->
    (posed joints (T, J, 3), skinning transforms relative to the rest pose (T, J, 4, 4),
    the smplx "A" matrices)."""
    t, j = rot_mats.shape[:2]
    rel_joints = torch.cat([joints[:, :1], joints[:, 1:] - joints[:, parents[1:].tolist()]],
                           dim=1)
    bottom = rot_mats.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(t, j, 1, 4)
    local = torch.cat([torch.cat([rot_mats, rel_joints[..., None]], dim=3), bottom], dim=2)
    transforms = [local[:, 0]]
    for i in range(1, j):
        transforms.append(transforms[parents[i]] @ local[:, i])
    world = torch.stack(transforms, dim=1)  # (T, J, 4, 4)
    posed_joints = world[:, :, :3, 3]
    # A = world - pad(world @ [j; 0]): removes the rest-pose joint location, so the
    # transform maps rest-pose vertices directly
    correction = torch.einsum("tjab,tjb->tja", world[:, :, :3, :3], joints)
    rel = torch.cat([world[:, :, :3, :3], (world[:, :, :3, 3] - correction)[..., None]],
                    dim=3)
    return posed_joints, torch.cat([rel, world[:, :, 3:]], dim=2)


@torch.no_grad()
@strict_fp32()
def lbs(model: SmplxModel, betas, poses, expressions=None, trans=None,
        flat_hand_mean: bool = False, return_vertices: bool = True
        ) -> Dict[str, torch.Tensor]:
    """SMPL-X linear blend skinning over T frames on the model's device.

    betas (300,) or (T, 300); poses (T, 165) axis-angle in the BEAT layout; expressions
    (T, 100) or None; trans (T, 3) or None. Returns ``joints`` (T, 55, 3) and, with
    ``return_vertices``, ``vertices`` (T, V, 3)."""
    dev, dtype = model.device, model.v_template.dtype
    as_t = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)
    poses = full_pose_with_hand_mean(model, as_t(poses), flat_hand_mean)
    t, v, j = poses.shape[0], model.num_vertices, len(model.parents)
    betas = as_t(betas)
    trans = None if trans is None else as_t(trans)
    if betas.dim() == 1:
        betas = betas[None].expand(t, betas.shape[0])

    v_shaped = model.v_template[None] + torch.einsum("vcs,ts->tvc", model.shapedirs, betas)
    if expressions is not None:
        v_shaped = v_shaped + torch.einsum("vcs,ts->tvc", model.exprdirs, as_t(expressions))
    joints = torch.einsum("jv,tvc->tjc", model.j_regressor, v_shaped)

    rot_mats = axis_angle_to_matrix(poses.reshape(t, j, 3))
    posed_joints, rel_tf = _compose_chain(model.parents, rot_mats, joints)

    out = {}
    if return_vertices:
        ident = torch.eye(3, dtype=dtype, device=dev)
        pose_feature = (rot_mats[:, 1:] - ident).reshape(t, (j - 1) * 9)
        v_posed = v_shaped + (pose_feature @ model.posedirs).reshape(t, v, 3)
        # blend the 4x4 transforms per vertex, then apply them
        tf = torch.einsum("vj,tjab->tvab", model.lbs_weights, rel_tf)
        verts = torch.einsum("tvab,tvb->tva", tf[:, :, :3, :3], v_posed) + tf[:, :, :3, 3]
        if trans is not None:
            verts = verts + trans[:, None, :]
        out["vertices"] = verts
    if trans is not None:
        posed_joints = posed_joints + trans[:, None, :]
    out["joints"] = posed_joints
    return out


def body_joints(model: SmplxModel, poses, betas=None) -> torch.Tensor:
    """Joints-only FK of the metrics path: global orient, jaw, eyes, translation and
    expression zeroed; body and hands from the 165-d pose vector. (T, 55, 3)."""
    poses = torch.as_tensor(poses, dtype=model.v_template.dtype, device=model.device)
    zeroed = torch.zeros_like(poses)
    zeroed[:, 3:66] = poses[:, 3:66]
    zeroed[:, 75:165] = poses[:, 75:165]
    b = torch.zeros(NUM_BETAS) if betas is None else betas
    return lbs(model, b, zeroed, return_vertices=False)["joints"]


def face_vertices(model: SmplxModel, poses, expressions, betas=None) -> torch.Tensor:
    """Expression-only FK (jaw pose and expressions, all else zero): vertices (T, V, 3)."""
    poses = torch.as_tensor(poses, dtype=model.v_template.dtype, device=model.device)
    zeroed = torch.zeros_like(poses)
    zeroed[:, 66:69] = poses[:, 66:69]
    b = torch.zeros(NUM_BETAS) if betas is None else betas
    return lbs(model, b, zeroed, expressions=expressions)["vertices"]


def rest_pose_joints(model: SmplxModel, betas) -> torch.Tensor:
    """(55, 3) joints of the zero pose for ``betas``: the ground-offset translation
    on save (``io/beat_format.py``)."""
    poses = torch.zeros(1, NUM_JOINTS * 3)
    return lbs(model, betas, poses, flat_hand_mean=True, return_vertices=False)["joints"][0]


def extended_joints(model: SmplxModel, vertices: torch.Tensor,
                    joints: torch.Tensor) -> torch.Tensor:
    """The smplx package's joints after the 55 LBS joints: 5 face keypoints, 6 foot
    points and 10 finger tips (vertex picks), and 51 barycentric face landmarks when the
    model has a landmark embedding. vertices (T, V, 3), joints (T, 55, 3) ->
    (T, 76[+51], 3)."""
    v = model.num_vertices
    ids = [min(VERTEX_IDS[name], v - 1) for name in EXTRA_JOINT_NAMES]  # small models
    out = torch.cat([joints, vertices[:, ids]], dim=1)
    if model.lmk_faces_idx is not None and model.lmk_bary_coords is not None:
        tri = torch.as_tensor(model.faces[model.lmk_faces_idx].astype(np.int64),
                              device=vertices.device)
        bary = torch.as_tensor(model.lmk_bary_coords, dtype=vertices.dtype,
                               device=vertices.device)
        with strict_fp32():
            lmks = torch.einsum("tlvc,lv->tlc", vertices[:, tri], bary)
        out = torch.cat([out, lmks], dim=1)
    return out


def make_synthetic_model(generator: torch.Generator, device, num_vertices: int = 64,
                         num_joints: int = NUM_JOINTS) -> SmplxModel:
    """A small random model with a valid structure (a simple chain of joints), for tests
    and measurements without the SMPL-X archive. Drawn on the CPU from ``generator``."""
    g, v, j = generator, num_vertices, num_joints
    randn = lambda *shape: torch.randn(*shape, generator=g)
    parents = np.concatenate([[-1], np.arange(j - 1)]).astype(np.int64)
    arrays = {
        "v_template": randn(v, 3) * 0.3,
        "shapedirs": randn(v, 3, NUM_BETAS) * 0.01,
        "exprdirs": randn(v, 3, NUM_EXPRESSIONS) * 0.01,
        "posedirs": randn((j - 1) * 9, v * 3) * 0.01,
        "j_regressor": torch.softmax(randn(j, v), dim=1),
        "lbs_weights": torch.softmax(randn(v, j), dim=1),
        "hands_mean": torch.zeros(90),
    }
    arrays = {k: x.numpy() for k, x in arrays.items()}
    return SmplxModel.from_numpy(dict(arrays, parents=parents,
                                      faces=np.zeros((1, 3), np.int32)), device)


__all__ = [
    "EXTRA_JOINT_NAMES",
    "NUM_BETAS",
    "NUM_EXPRESSIONS",
    "NUM_JOINTS",
    "SmplxModel",
    "VERTEX_IDS",
    "body_joints",
    "default_model_path",
    "extended_joints",
    "face_vertices",
    "full_pose_with_hand_mean",
    "lbs",
    "load_smplx",
    "make_synthetic_model",
    "read_smplx",
    "rest_pose_joints",
]
