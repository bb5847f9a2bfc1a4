"""BEAT-format motion npz save and linear time upsampling (counterpart of
``pantomatrix_tpu/io/beat_format.py``)."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..core.masking import recover_from_mask


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
    expressions (t, 100) and trans (t, 3), zeros where not given, scattered to the full
    joint layout by ``mask`` and upsampled ``upsample`` times in time when given."""
    motion_data = np.asarray(motion_data)
    n = motion_data.shape[0]
    betas = np.zeros((n, 300), motion_data.dtype) if betas is None else np.asarray(betas)
    if expressions is None:
        expressions = np.zeros((n, 100), motion_data.dtype)
    expressions = np.asarray(expressions)
    # Without a translation the JAX package puts the rest-pose feet on the ground with
    # an SMPL-X forward pass, and falls back to zeros when the SMPL-X model file is
    # absent. The port has no SMPL-X forward pass yet, so it always writes zeros here.
    trans = np.zeros((n, 3), motion_data.dtype) if trans is None else np.asarray(trans)

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


__all__ = ["beat_format_save", "time_upsample"]
