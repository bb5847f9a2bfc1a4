"""BEAT-format motion npz save and load, and linear time upsampling (counterpart of
``pantomatrix_tpu/io/beat_format.py``), with the ground-offset translation from the
SMPL-X rest pose when no translation is given."""
from __future__ import annotations

import functools
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.masking import recover_from_mask, select_with_mask


def time_upsample(data: np.ndarray, k: int) -> np.ndarray:
    """Linearly interpolate (..., t, c) to (..., k*t, c) at new_t = linspace(0, t-1, k*t)."""
    if k == 1:
        return data.copy()
    shape = data.shape
    t, c = shape[-2], shape[-1]
    original_t = np.arange(t)
    new_t = np.linspace(0, t - 1, k * t)
    idx = np.clip(np.searchsorted(original_t, new_t, side="right") - 1, 0, t - 2)
    w = (new_t - original_t[idx]) / (original_t[idx + 1] - original_t[idx])
    flat = data.reshape(-1, t, c)
    out = flat[:, idx, :] + (flat[:, idx + 1, :] - flat[:, idx, :]) * w[None, :, None]
    return out.reshape(shape[:-2] + (k * t, c))


@functools.lru_cache(maxsize=1)
def _rest_model(path: str, mtime_ns: int):
    """The SMPL-X archive on the CPU, read once per process (and again if the file
    changes): every save without a translation needs it."""
    from ..core.smplx import load_smplx

    return load_smplx(path, "cpu")


def _ground_offset_trans(n_frames: int, betas: np.ndarray, dtype) -> Optional[np.ndarray]:
    """The translation that puts the rest-pose feet on the ground, -(ankle_L +
    ankle_R) / 2 (joints 10 and 11), for every frame; None without an SMPL-X archive."""
    from ..core.smplx import default_model_path, rest_pose_joints

    model_path = default_model_path()
    if model_path is None or not os.path.exists(model_path):
        return None
    model = _rest_model(os.path.abspath(model_path), os.stat(model_path).st_mtime_ns)
    joints = rest_pose_joints(model, betas[:300]).numpy()
    trans = -(joints[10] + joints[11]) / 2.0
    return np.repeat(trans[None, :], n_frames, axis=0).astype(dtype)


def beat_format_save(
    save_path: str,
    motion_data: np.ndarray,
    mask: Optional[Sequence[bool]] = None,
    betas: Optional[np.ndarray] = None,
    expressions: Optional[np.ndarray] = None,
    trans: Optional[np.ndarray] = None,
    upsample: Optional[int] = None,
) -> None:
    """Save (t, j*3) axis-angle motion as a BEAT-format npz: betas (300,), poses,
    expressions (t, 100) and trans (t, 3), scattered to the full joint layout by
    ``mask`` and upsampled ``upsample`` times in time when given. Betas and
    expressions not given are zeros; a translation not given is the ground offset of
    the SMPL-X rest pose when the archive is found (``core/smplx.py``), else zeros."""
    motion_data = np.asarray(motion_data)
    n = motion_data.shape[0]
    betas = np.zeros((n, 300), motion_data.dtype) if betas is None else np.asarray(betas)
    if expressions is None:
        expressions = np.zeros((n, 100), motion_data.dtype)
    expressions = np.asarray(expressions)
    if trans is None:
        trans = _ground_offset_trans(n, betas[0], motion_data.dtype)
        if trans is None:
            trans = np.zeros((n, 3), motion_data.dtype)
    trans = np.asarray(trans)

    if mask is not None:
        motion_data = recover_from_mask(torch.from_numpy(motion_data), mask).numpy()
    if upsample is not None and upsample > 1:
        motion_data = time_upsample(motion_data, upsample)
        betas = time_upsample(betas, upsample)
        expressions = time_upsample(expressions, upsample)
        trans = time_upsample(trans, upsample)

    np.savez(
        save_path,
        betas=betas[0],
        poses=motion_data,
        expressions=expressions,
        trans=trans,
        model="smplx2020",
        gender="neutral",
        mocap_frame_rate=30,
    )


def beat_format_load(load_path: str, mask: Optional[Sequence[bool]] = None) -> dict:
    """A BEAT-format npz's poses (the joints ``mask`` selects, when given), betas,
    expressions and trans, as numpy arrays."""
    with np.load(load_path, allow_pickle=True) as data:
        poses = data["poses"]
        if mask is not None:
            poses = select_with_mask(torch.from_numpy(poses), mask).numpy()
        return {"poses": poses, "betas": data["betas"], "expressions": data["expressions"],
                "trans": data["trans"]}


__all__ = ["beat_format_load", "beat_format_save", "time_upsample"]
