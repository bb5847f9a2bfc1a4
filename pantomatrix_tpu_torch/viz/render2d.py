"""2D and 3D skeleton videos: SMPL-X joints -> perspective projection -> OpenPose-style
drawing -> MJPG AVI (counterpart of ``pantomatrix_tpu/viz/render2d.py``).

The joint, edge and colour tables are the JAX package's (the reference's OpenPose
palette over the extended SMPL-X joint layout: 55 LBS joints, 21 vertex picks, then 51
face landmarks). The FK, the projection, the drawing (``viz/draw.py``, cv2's
rasterization in PyTorch) and the JPEG transform run on the device, a chunk of frames at
a time; the JPEG Huffman coding runs on the host. No cv2: the output is always MJPG AVI,
the branch the JAX ``write_video`` takes when its cv2 has no mp4v encoder.
"""
from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..core.smplx import SmplxModel, extended_joints, lbs
from . import draw

# (i, j, colour) tables of the reference's palette (BGR order as drawn)
BODY_EDGES = [
    (12, 17, (255, 0, 0)), (12, 16, (255, 85, 0)), (17, 19, (255, 170, 0)),
    (19, 21, (255, 255, 0)), (16, 18, (170, 255, 0)), (18, 20, (85, 255, 0)),
    (2, 12, (0, 255, 0)), (2, 5, (0, 255, 85)), (5, 8, (0, 255, 170)),
    (1, 12, (0, 255, 255)), (1, 4, (0, 170, 255)), (4, 7, (0, 85, 255)),
    (12, 55, (0, 0, 255)), (55, 56, (85, 0, 255)), (56, 58, (170, 0, 255)),
    (55, 57, (255, 0, 255)), (57, 59, (255, 0, 170)),
]
BODY_JOINTS = [
    (55, (255, 0, 0)), (12, (255, 85, 0)), (17, (255, 170, 0)), (19, (255, 255, 0)),
    (21, (170, 255, 0)), (16, (85, 255, 0)), (18, (0, 255, 0)), (20, (0, 255, 85)),
    (2, (0, 255, 170)), (5, (0, 255, 255)), (8, (0, 170, 255)), (1, (0, 85, 255)),
    (4, (0, 0, 255)), (7, (85, 0, 255)), (56, (170, 0, 255)), (57, (255, 0, 255)),
    (58, (255, 0, 170)), (59, (255, 0, 85)),
]
_L_FINGER_CHAINS = [(21, 52, 53, 54, 71), (21, 40, 41, 42, 72), (21, 43, 44, 45, 73),
                    (21, 49, 50, 51, 74), (21, 46, 47, 48, 75)]
_R_FINGER_CHAINS = [(20, 37, 38, 39, 66), (20, 25, 26, 27, 67), (20, 28, 29, 30, 68),
                    (20, 34, 35, 36, 69), (20, 31, 32, 33, 70)]
_FINGER_COLORS = [
    (255, 0, 0), (255, 76, 0), (255, 153, 0), (255, 229, 0),
    (204, 255, 0), (128, 255, 0), (51, 255, 0), (0, 255, 26),
    (0, 255, 102), (0, 255, 179), (0, 255, 255), (0, 179, 255),
    (0, 102, 255), (0, 26, 255), (51, 0, 255), (128, 0, 255),
    (204, 0, 255), (255, 0, 230), (255, 0, 153), (255, 0, 77),
]
# each hand's 20 bones, coloured in order along its five chains
HAND_EDGES = [(a, b, _FINGER_COLORS[k]) for chains in (_L_FINGER_CHAINS, _R_FINGER_CHAINS)
              for k, (a, b) in enumerate((a, b) for chain in chains
                                         for a, b in zip(chain[:-1], chain[1:]))]
HAND_JOINTS = [20, 21] + list(range(25, 55)) + list(range(66, 76))
FACE_LANDMARKS_START = 76
WHITE, RED = (255, 255, 255), (0, 0, 255)
BODY_SHADE = 0.6  # the body layer is darkened before the joints are drawn over it
FRAMES_PER_CHUNK = 64  # frames drawn and encoded together


def project_perspective(points, focal_length: float, height: int, width: int,
                        camera_transl: Tuple[float, float, float]) -> torch.Tensor:
    """pytorch3d ``PerspectiveCameras(in_ndc=False).transform_points_screen`` with
    R = diag(-1, 1, 1) and T = ``camera_transl``: (..., 3) world points (tensor or array)
    -> (..., 3) float32 screen x, y and depth, computed in float64 on their device."""
    p = torch.as_tensor(points).to(torch.float64)
    transl = torch.as_tensor(camera_transl, dtype=torch.float64, device=p.device)
    cam = torch.cat([-p[..., :1], p[..., 1:]], dim=-1) + transl
    z = cam[..., 2:3].clamp(min=1e-6)
    x = width / 2.0 - focal_length * cam[..., 0:1] / z
    y = height / 2.0 - focal_length * cam[..., 1:2] / z
    return torch.cat([x, y, z], dim=-1).to(torch.float32)


def _palette(face_only: bool) -> np.ndarray:
    if face_only:
        return np.array([WHITE], np.uint8)
    bones = (np.array([c for _, _, c in BODY_EDGES], np.uint8) * BODY_SHADE).astype(np.uint8)
    return np.concatenate([bones, [WHITE], [c for _, _, c in HAND_EDGES], [RED], [WHITE]]
                          ).astype(np.uint8)


def _tagged(parts, layer):
    """(index, ...) tensors of primitives laid out (frame, k) -> (frame, ..., layer)."""
    idx, *rest = parts
    return (idx // layer.shape[0], *rest, layer[idx % layer.shape[0]])


def draw_frames(j2d: torch.Tensor, height: int, width: int,
                face_only: bool = False) -> torch.Tensor:
    """(n, J, >= 2) float32 screen joints -> (n, height, width, 3) uint8 BGR frames on
    their device, equal to the JAX ``draw_frame`` (cv2) of each frame."""
    dev = j2d.device
    n, j = j2d.shape[:2]
    xy = j2d[..., :2].to(torch.float32)
    xyi = xy.to(torch.int64)  # astype(int): toward zero
    lid = lambda *ids: torch.as_tensor(ids, device=dev)
    runs, pixels = [], []
    face = torch.arange(FACE_LANDMARKS_START, j, device=dev)
    face_layer = 0 if face_only else len(BODY_EDGES) + len(HAND_EDGES) + 2
    if not face_only:
        pa = xy[:, [a for a, _, _ in BODY_EDGES]]
        pb = xy[:, [b for _, b, _ in BODY_EDGES]]
        centre = ((pa + pb) / 2).to(torch.int64).reshape(-1, 2)
        d = pa - pb
        length = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
        half = (length / 2).to(torch.int64).reshape(-1)
        d64 = d.to(torch.float64)
        angle = (torch.atan2(d64[..., 1], d64[..., 0]) * (180.0 / np.pi)).to(torch.int64)
        vx, vy = draw.ellipse_poly(centre[:, 0], centre[:, 1], half, 4, angle.reshape(-1))
        bone_runs, bone_outline = draw.convex_fill(vx, vy, 0, width, height)
        bones = lid(*range(len(BODY_EDGES)))
        runs.append(_tagged(bone_runs, bones))
        pixels.append(_tagged(bone_outline, bones))

        joints = xyi[:, [i for i, _ in BODY_JOINTS]].reshape(-1, 2)
        runs.append(_tagged(draw.circle_runs(joints[:, 0], joints[:, 1], 4),
                            lid(*[len(BODY_EDGES)] * len(BODY_JOINTS))))

        ends = torch.stack([xyi[:, [a for a, _, _ in HAND_EDGES]],
                            xyi[:, [b for _, b, _ in HAND_EDGES]]], 2)  # (n, E, 2, 2)
        shown = torch.nonzero((ends.reshape(n, -1, 4).min(-1).values > 0).reshape(-1)).squeeze(1)
        e = ends.reshape(-1, 4)[shown]
        line_runs, line_pix = draw.thick_line(e[:, 0], e[:, 1], e[:, 2], e[:, 3], width, height)
        edge_layers = torch.arange(len(HAND_EDGES), device=dev) + len(BODY_EDGES) + 1
        runs.append(_tagged((shown[line_runs[0]], *line_runs[1:]), edge_layers))
        pixels.append(_tagged((shown[line_pix[0]], *line_pix[1:]), edge_layers))

        hand = xyi[:, HAND_JOINTS]
        shown = torch.nonzero((hand.min(-1).values > 0).reshape(-1)).squeeze(1)
        c = hand.reshape(-1, 2)[shown]
        i, y, x1, x2 = draw.circle_runs(c[:, 0], c[:, 1], 4)
        runs.append(_tagged((shown[i], y, x1, x2),
                            lid(*[face_layer - 1] * len(HAND_JOINTS))))
    pts = xyi[:, face]
    shown = torch.nonzero((pts.min(-1).values > 0).reshape(-1)).squeeze(1)
    c = pts.reshape(-1, 2)[shown]
    i, y, x1, x2 = draw.circle_runs(c[:, 0], c[:, 1], 3)
    runs.append(_tagged((shown[i], y, x1, x2),
                        torch.full((max(len(face), 1),), face_layer, device=dev)))
    return draw.paint(n, height, width, runs, pixels, _palette(face_only), dev)


def draw_frame(j2d, height: int, width: int, face_only: bool = False) -> np.ndarray:
    """One frame: (J, >= 2) screen joints -> (height, width, 3) uint8 BGR (numpy)."""
    return draw_frames(torch.as_tensor(j2d)[None], height, width, face_only)[0].cpu().numpy()


def joints_from_motion(model: SmplxModel, motion_dict: dict, remove_global: bool = False,
                       face_only: bool = False) -> torch.Tensor:
    """npz motion dict -> extended joints (t, 76+, 3) by the FK on the model's device."""
    poses = np.asarray(motion_dict["poses"], np.float32)
    t = poses.shape[0]
    trans = np.asarray(motion_dict["trans"], np.float32)
    if remove_global:
        trans = np.repeat(trans[0:1], t, axis=0)
    if face_only:
        zeroed = np.zeros_like(poses)
        zeroed[:, 66:69] = poses[:, 66:69]
        poses = zeroed
    out = lbs(model, np.asarray(motion_dict["betas"], np.float32)[:300], poses,
              expressions=np.asarray(motion_dict["expressions"], np.float32), trans=trans)
    return extended_joints(model, out["vertices"], out["joints"])


def load_render_model(device) -> SmplxModel:
    """The SMPL-X archive at ``default_model_path()`` on ``device``; raises the JAX
    package's FileNotFoundError without one."""
    from ..core.smplx import default_model_path, load_smplx

    path = default_model_path()
    if path is None:
        raise FileNotFoundError("SMPL-X model npz not found (set SMPLX_MODEL_PATH)")
    return load_smplx(path, device)


def _normalize_3d(j3d: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """The JAX ``render3d``'s per-frame min-max normalisation, in float32: xy onto the
    image, z onto [0, 1] (carried, not drawn)."""
    def unit(v):
        lo, hi = v.min(dim=1, keepdim=True).values, v.max(dim=1, keepdim=True).values
        return (v - lo) / (hi - lo + 1e-8)

    return torch.stack([unit(j3d[..., 0]) * (width - 1), unit(j3d[..., 1]) * (height - 1),
                        unit(j3d[..., 2])], dim=-1)


def _jpeg_chunks(joints: torch.Tensor, to_screen, height: int, width: int,
                 face_only: bool) -> Iterator[bytes]:
    from .jpeg import encode_frames

    for s in range(0, joints.shape[0], FRAMES_PER_CHUNK):
        j2d = to_screen(joints[s:s + FRAMES_PER_CHUNK])
        yield from encode_frames(draw_frames(j2d, height, width, face_only))


def _render(motion_dict, output_path, model, device, height, width, fps, remove_global,
            face_only, to_screen) -> str:
    from .avi import write_avi_jpegs

    model = model if model is not None else load_render_model(device)
    joints = joints_from_motion(model, motion_dict, remove_global, face_only)
    path = os.path.splitext(output_path)[0] + ".avi"
    return write_avi_jpegs(path, _jpeg_chunks(joints, to_screen, height, width, face_only),
                           joints.shape[0], width, height, fps)


def render2d(motion_dict: dict, output_path: str, model: Optional[SmplxModel] = None,
             height: int = 720, width: int = 480, focal_length: float = 1000.0,
             camera_transl: Tuple[float, float, float] = (0.0, -1.0, 3.0), fps: int = 30,
             remove_global: bool = True, face_only: bool = False, device="cuda") -> str:
    """npz motion dict -> skeleton video; returns the written ``.avi`` path. Without a
    ``model`` the SMPL-X archive is loaded onto ``device``."""
    to_screen = lambda j: project_perspective(j, focal_length, height, width, camera_transl)
    return _render(motion_dict, output_path, model, device, height, width, fps,
                   remove_global, face_only, to_screen)


def render3d(motion_dict: dict, output_path: str, model: Optional[SmplxModel] = None,
             height: int = 720, width: int = 480, fps: int = 30, remove_global: bool = True,
             face_only: bool = False, device="cuda") -> str:
    """3D-normalised skeleton video: each frame's joints min-max normalised onto the
    image (z kept in the third channel); returns the written ``.avi`` path."""
    to_screen = lambda j: _normalize_3d(j, height, width)
    return _render(motion_dict, output_path, model, device, height, width, fps,
                   remove_global, face_only, to_screen)


def write_video(frames, output_path: str, fps: int = 30) -> str:
    """BGR frames ((n, h, w, 3) uint8 tensor, or a sequence of (h, w, 3) arrays) -> MJPG
    ``.avi`` beside ``output_path``; returns its path."""
    from .avi import write_avi

    return write_avi(os.path.splitext(output_path)[0] + ".avi", frames, fps)


__all__ = [
    "BODY_EDGES",
    "BODY_JOINTS",
    "HAND_EDGES",
    "HAND_JOINTS",
    "draw_frame",
    "draw_frames",
    "joints_from_motion",
    "load_render_model",
    "project_perspective",
    "render2d",
    "render3d",
    "write_video",
]
