"""The evaluation pass over generated clips (counterpart of
``pantomatrix_tpu/eval/pipeline.py``, the reference's ``evaluation_fn``).

Per test clip: load the ground truth and the prediction npz, FK positions (BC with the
first and last 2 s trimmed, L1div), face vertices (LVD, MSE; EMAGE only) and rot6d (FGD).
The FK runs on the SMPL-X model's device and the FGD encoder on ``device``; the metrics
themselves are numpy on the host. Without the SMPL-X model only FGD is computed.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..core.rotations import axis_angle_to_rotation_6d
from ..io.beat_format import beat_format_load
from ..nn.layers import strict_fp32
from .metrics import BC, FGD, L1div, LVDFace, MSEFace


def _rot6d(motion: np.ndarray, device) -> np.ndarray:
    """(t, 165) axis-angle -> (1, t, 330) rot6d, computed on ``device``."""
    t = motion.shape[0]
    with torch.no_grad(), strict_fp32():
        x = torch.as_tensor(np.asarray(motion, np.float32), device=device)
        return axis_angle_to_rotation_6d(x.reshape(1, t, 55, 3)).reshape(1, t, 330).cpu().numpy()


def evaluate_clips(
    gt_list: List[dict],
    pred_list: List[dict],
    smplx_model=None,
    joint_mask=None,
    pose_fps: int = 30,
    audio_sr: int = 16000,
    with_face: bool = True,
    download_path: str = "./emage_evaltools/",
    fgd_strict: bool = False,
    device="cuda",
) -> Dict[str, object]:
    """gt_list / pred_list: dicts with video_id and motion_path (and audio_path in gt).

    The result carries ``fgd_embedder`` ("aeskconv" | "stats"), which records the feature
    net behind its FGD value: statistics-embedder values are not comparable to the
    reference's published numbers or to aeskconv runs. ``fgd_strict=True`` raises where
    the AESKConv_240_100.bin file is missing or corrupt instead of falling back."""
    fgd = FGD(download_path, strict=fgd_strict, device=device)
    bc = BC(download_path, sigma=0.3, order=7)
    l1 = L1div()
    lvd = LVDFace()
    mse = MSEFace()

    pred_by_id = {p["video_id"]: p for p in pred_list}
    for test_file in gt_list:
        pred_file = pred_by_id.get(test_file["video_id"])
        if pred_file is None:
            print(f"Missing prediction for {test_file['video_id']}")
            continue
        gt_dict = beat_format_load(test_file["motion_path"], joint_mask)
        pred_dict = beat_format_load(pred_file["motion_path"], joint_mask)
        t = min(gt_dict["poses"].shape[0], pred_dict["poses"].shape[0])
        motion_gt, motion_pred = gt_dict["poses"][:t], pred_dict["poses"][:t]

        if smplx_model is not None:
            from ..core.motion_rep import get_motion_rep

            pos = get_motion_rep(smplx_model, motion_pred, pose_fps,
                                 betas=gt_dict["betas"])["position"].reshape(t, -1)
            # BC protocol: trim the first and last 2 s
            if t > 120:
                audio_beat = bc.load_audio(
                    test_file["audio_path"], t_start=2 * audio_sr,
                    t_end=int((t - 60) / pose_fps * audio_sr))
                motion_beat = bc.load_motion(pos, t_start=60, t_end=t - 60,
                                             pose_fps=pose_fps)
                bc.compute(audio_beat, motion_beat, length=t - 120, pose_fps=pose_fps)
            l1.compute(pos)
            if with_face:
                fv_pred = get_motion_rep(
                    smplx_model, motion_pred, pose_fps, betas=gt_dict["betas"],
                    expressions=pred_dict["expressions"][:t], expression_only=True,
                )["vertices"]
                fv_gt = get_motion_rep(
                    smplx_model, motion_gt, pose_fps, betas=gt_dict["betas"],
                    expressions=gt_dict["expressions"][:t], expression_only=True,
                )["vertices"]
                lvd.compute(fv_pred, fv_gt)
                mse.compute(fv_pred, fv_gt)

        fgd.update(_rot6d(motion_pred, device), _rot6d(motion_gt, device))

    metrics = {"fgd": fgd.compute(), "fgd_embedder": fgd.embedder_kind}
    if smplx_model is not None:
        metrics["bc"] = bc.avg()
        metrics["l1"] = l1.avg()
        if with_face:
            metrics["lvd"] = lvd.avg()
            metrics["mse"] = mse.avg()
    return metrics


__all__ = ["evaluate_clips"]
