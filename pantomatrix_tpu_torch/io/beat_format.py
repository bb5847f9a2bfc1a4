"""BEAT-format motion npz save (counterpart of ``beat_format_save`` in
``pantomatrix_tpu/io/beat_format.py``), for EMAGE output at its native 30 fps with the
generated translation, so neither time upsampling nor the SMPL-X ground offset applies.
"""
from __future__ import annotations

import numpy as np


def beat_format_save(save_path: str, poses: np.ndarray, expressions: np.ndarray,
                     trans: np.ndarray) -> None:
    """Save poses (t, 165) axis-angle, expressions (t, 100) and trans (t, 3) with zero
    betas, as the keys the BEAT tools read."""
    poses = np.asarray(poses)
    np.savez(
        save_path,
        betas=np.zeros(300, dtype=poses.dtype),
        poses=poses,
        expressions=np.asarray(expressions),
        trans=np.asarray(trans),
        model="smplx2020",
        gender="neutral",
        mocap_frame_rate=30,
    )


__all__ = ["beat_format_save"]
