"""Mesh videos: npz -> SMPL-X vertices (FK on the model's device) -> the host rasterizer
(``native/rasterizer.cpp``) -> JPEG -> AVI with audio (counterpart of
``pantomatrix_tpu/viz/mesh_video.py``).

``render_one_sequence`` (prediction | ground truth side by side),
``render_one_sequence_no_gt``, ``render_one_sequence_with_face`` (7x-scaled zero-body
head | body) and ``render_one_sequence_face_only``, with the JAX package's camera, light
and material (orthographic xmag = ymag = 1, camera pose rot_x(-2 deg) with t = (0, 1, 5),
a directional light rot_x(-30 deg) of intensity 4, colour (220, 220, 220), 480 x 720 at
30 fps). The FK copies its vertices to the host once; frames are then rasterized, put
side by side, JPEG-transformed on the model's device and Huffman-coded on the host a
chunk at a time, so that a long take never holds all of its raw frames.
"""
from __future__ import annotations

import math
import os
from typing import Iterator, Optional

import numpy as np
import torch

RENDER_ARGS = {
    "render_video_fps": 30,
    "render_video_width": 480,
    "render_video_height": 720,
    "debug": False,
}
FRAMES_PER_CHUNK = 32  # frames rasterized and encoded together


def _rot_x(deg: float) -> np.ndarray:
    r = math.radians(deg)
    return np.array(
        [[1, 0, 0], [0, math.cos(r), -math.sin(r)], [0, math.sin(r), math.cos(r)]],
        np.float32,
    )


CAMERA_R = _rot_x(-2.0)
CAMERA_T = np.array([0.0, 1.0, 5.0], np.float32)
# the light node is rotated -30 deg about x; the direction toward the light in world
# space is the node's +z column
LIGHT_DIR_WORLD = _rot_x(-30.0)[:, 2]


def world_to_camera(vertices: np.ndarray) -> np.ndarray:
    """(n, V, 3) world -> camera coordinates (camera pose = [CAMERA_R | CAMERA_T])."""
    return (vertices - CAMERA_T) @ CAMERA_R  # R^T applied on the right


def _light_dir_camera() -> np.ndarray:
    return (CAMERA_R.T @ LIGHT_DIR_WORLD).astype(np.float32)


def _fk_vertices(model, data, remove_transl=True, zero_body=False, scale: float = 1.0,
                 y_shift: float = 0.0) -> np.ndarray:
    """npz dict -> (n, V, 3) float32 world-space vertices: the FK on the model's device,
    then one copy to the host."""
    from ..core.smplx import lbs

    poses = np.asarray(data["poses"], np.float32)
    n = poses.shape[0]
    trans = np.asarray(data["trans"], np.float32)[:n]
    if remove_transl:
        trans = np.repeat(trans[0:1], n, axis=0)
    if zero_body:
        zeroed = np.zeros_like(poses)
        zeroed[:, 66:69] = poses[:, 66:69]  # keep the jaw (and the expressions)
        poses = zeroed
    out = lbs(model, np.asarray(data["betas"], np.float32).reshape(-1)[:300], poses,
              expressions=np.asarray(data["expressions"], np.float32)[:n], trans=trans)
    verts = out["vertices"]
    if scale != 1.0 or y_shift != 0.0:
        verts = verts * scale
        verts[:, :, 1] -= y_shift
    return verts.cpu().numpy()


def _load_model(model_folder: Optional[str], device="cuda"):
    from ..core.smplx import default_model_path, load_smplx

    if model_folder is not None:
        cand = os.path.join(model_folder, "smplx", "SMPLX_NEUTRAL_2020.npz")
        if os.path.exists(cand):
            return load_smplx(cand, device)
    path = default_model_path()
    if path is None:
        raise FileNotFoundError("SMPLX_NEUTRAL_2020.npz not found (set SMPLX_MODEL_PATH)")
    return load_smplx(path, device)


def render_frames(vertices_world: np.ndarray, faces: np.ndarray, width: Optional[int] = None,
                  height: Optional[int] = None) -> np.ndarray:
    """(n, V, 3) world vertices -> (n, h, w, 3) uint8 RGB frames (host rasterizer)."""
    from ..native import render_mesh_frames

    width = width or RENDER_ARGS["render_video_width"]
    height = height or RENDER_ARGS["render_video_height"]
    cam = world_to_camera(np.asarray(vertices_world, np.float32))
    return render_mesh_frames(cam, faces, width, height, light_dir=_light_dir_camera(),
                              light_intensity=4.0, color=(220, 220, 220))


def _jpeg_chunks(vertices_a, vertices_b, faces, device) -> Iterator[bytes]:
    from .jpeg import encode_frames

    for s in range(0, vertices_a.shape[0], FRAMES_PER_CHUNK):
        frames = render_frames(vertices_a[s:s + FRAMES_PER_CHUNK], faces)
        if vertices_b is not None:
            frames = np.concatenate(
                [frames, render_frames(vertices_b[s:s + FRAMES_PER_CHUNK], faces)], axis=2)
        # the rasterizer writes RGB; JPEG takes BGR
        bgr = torch.as_tensor(frames, device=device).flip(-1)
        yield from encode_frames(bgr)


def generate_silent_video(vertices_a, vertices_b, faces, output_path: str,
                          fps: Optional[int] = None, device="cuda") -> str:
    """Two vertex streams side by side (one when ``vertices_b`` is None) -> silent AVI;
    the JPEG transform runs on ``device``."""
    from .avi import write_avi_jpegs

    fps = fps or RENDER_ARGS["render_video_fps"]
    width = RENDER_ARGS["render_video_width"] * (1 if vertices_b is None else 2)
    return write_avi_jpegs(output_path, _jpeg_chunks(vertices_a, vertices_b, faces, device),
                           vertices_a.shape[0], width, RENDER_ARGS["render_video_height"],
                           fps)


def _finalize(output_dir, res_npz_path, silent, audio_path):
    from .avi import add_audio_to_video

    base = os.path.splitext(os.path.basename(res_npz_path))[0]
    final_clip = os.path.join(output_dir, f"{base}.avi")
    if audio_path is not None and os.path.exists(audio_path):
        add_audio_to_video(silent, audio_path, final_clip)
        os.remove(silent)
    else:
        os.replace(silent, final_clip)
    return final_clip


def _seconds_to_frames(n_verts_frames: int) -> int:
    if RENDER_ARGS["debug"]:
        return RENDER_ARGS["render_video_fps"]
    seconds = n_verts_frames // 30
    return int(seconds * RENDER_ARGS["render_video_fps"])


def _render(res_npz_path, output_dir, audio_path, model_folder, model, device, streams):
    """``streams(model, pred)`` -> (vertices_a, vertices_b or None)."""
    os.makedirs(output_dir, exist_ok=True)
    model = model if model is not None else _load_model(model_folder, device)
    pred = dict(np.load(res_npz_path, allow_pickle=True))
    va, vb = streams(model, pred)
    n = _seconds_to_frames(va.shape[0])
    silent = generate_silent_video(va[:n], None if vb is None else vb[:n], model.faces,
                                   os.path.join(output_dir, "silence_video.avi"),
                                   device=model.device)
    return _finalize(output_dir, res_npz_path, silent, audio_path)


def _head(model, pred, remove_transl):
    return _fk_vertices(model, pred, remove_transl, zero_body=True, scale=7.0, y_shift=10.0)


def render_one_sequence(res_npz_path, gt_npz_path, output_dir, audio_path,
                        model_folder=None, remove_transl=True, model=None,
                        device="cuda") -> str:
    """Prediction | ground truth side by side."""
    gt = dict(np.load(gt_npz_path, allow_pickle=True))
    return _render(res_npz_path, output_dir, audio_path, model_folder, model, device,
                   lambda m, pred: (_fk_vertices(m, pred, remove_transl),
                                    _fk_vertices(m, gt, remove_transl)))


def render_one_sequence_no_gt(res_npz_path, output_dir, audio_path, model_folder=None,
                              remove_transl=True, model=None, device="cuda") -> str:
    return _render(res_npz_path, output_dir, audio_path, model_folder, model, device,
                   lambda m, pred: (_fk_vertices(m, pred, remove_transl), None))


def render_one_sequence_with_face(res_npz_path, output_dir, audio_path, model_folder=None,
                                  remove_transl=True, model=None, device="cuda") -> str:
    """7x-scaled zero-body head | full body."""
    return _render(res_npz_path, output_dir, audio_path, model_folder, model, device,
                   lambda m, pred: (_head(m, pred, remove_transl),
                                    _fk_vertices(m, pred, remove_transl)))


def render_one_sequence_face_only(res_npz_path, output_dir, audio_path, model_folder=None,
                                  remove_transl=True, model=None, device="cuda") -> str:
    return _render(res_npz_path, output_dir, audio_path, model_folder, model, device,
                   lambda m, pred: (_head(m, pred, remove_transl), None))


__all__ = [
    "RENDER_ARGS",
    "generate_silent_video",
    "render_frames",
    "render_one_sequence",
    "render_one_sequence_face_only",
    "render_one_sequence_no_gt",
    "render_one_sequence_with_face",
    "world_to_camera",
]
