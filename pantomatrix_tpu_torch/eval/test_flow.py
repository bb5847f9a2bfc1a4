"""Test-set generation and evaluation as one pass (counterpart of
``pantomatrix_tpu/eval/test_flow.py``): the reference's ``inference_fn`` (generate
motion for every unique test video, save BEAT npz, print the throughput line) feeding
its ``evaluation_fn`` (FGD, BC, L1div, LVD, MSE over the saved npz). ``cli/evaluate.py``
runs it once from a checkpoint.

Each generate function runs on the device of the model it was made from and returns
numpy; ``run_test_pass`` runs the FK and the FGD encoder on ``device``.
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List

import numpy as np
import torch


def unique_test_clips(meta_paths) -> List[dict]:
    """mode == "test" clips, deduplicated by video_id (the reference iterates whole
    videos, not windows)."""
    test_list = []
    for p in meta_paths:
        with open(p) as f:
            test_list.extend(json.load(f))
    seen = set()
    out = []
    for m in test_list:
        if m.get("mode") == "test" and m["video_id"] not in seen:
            seen.add(m["video_id"])
            out.append(m)
    return out


def _device_of(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


def _make_seq_generate(model) -> Callable:
    """generate_fn for the whole-sequence families (CaMN and DisCo share the call)."""
    device, cfg = _device_of(model), model.config

    def generate(audio, speaker_id):
        out = model(audio.to(device), speaker_id.to(device), cfg.seed_frames)
        return {"motion": out["motion_axis_angle"][0].cpu().numpy()}

    return generate


def make_camn_generate(model) -> Callable:
    return _make_seq_generate(model)


def make_disco_generate(model) -> Callable:
    return _make_seq_generate(model)


def _decoded(pred, t: int) -> Dict[str, np.ndarray]:
    return {
        "motion": pred["motion_axis_angle"].reshape(t, -1).cpu().numpy(),
        "expressions": pred["expression"].reshape(t, -1).cpu().numpy(),
        "trans": pred["trans"].reshape(t, -1).cpu().numpy(),
    }


def make_emage_generate(model, vq) -> Callable:
    """generate_fn for EMAGE: windowed AR inference, head routing and the VQ decode
    with global translation. On the card the window step replays a CUDA graph, captured
    on the first take of each length."""
    from ..models.emage import _select_decode_inputs

    device, cfg = _device_of(model), model.config

    def generate(audio, speaker_id):
        latent = model.inference(audio.to(device), speaker_id.to(device), vq)
        pred = vq.decode(**_select_decode_inputs(cfg, latent), get_global_motion=True,
                         ref_trans=torch.zeros(audio.shape[0], 3, device=device))
        return _decoded(pred, pred["motion_axis_angle"].shape[1])

    return generate


def make_emage_vq_roundtrip_generate(vq) -> Callable:
    """Reconstruction-bound generator: decode each clip's ground-truth motion through
    the frozen VQ tokenizers (encode, nearest code, decode), ignoring the audio. The
    metrics bound what any EMAGE checkpoint can reach with this tokenizer suite (the
    reference kept this as commented-out code in its inference_fn). The function reads
    each clip's ground-truth npz, so it carries ``needs_meta``."""
    from ..core.rotations import axis_angle_to_rotation_6d
    from ..nn.layers import strict_fp32

    device = _device_of(vq)

    def generate(audio, speaker_id, meta):
        with np.load(meta["motion_path"], allow_pickle=True) as data:
            poses = np.asarray(data["poses"], np.float32).reshape(-1, 165)
            t = poses.shape[0]
            expr = (np.asarray(data["expressions"], np.float32) if "expressions" in data
                    else np.zeros((t, 100), np.float32))
            trans = (np.asarray(data["trans"], np.float32) if "trans" in data
                     else np.zeros((t, 3), np.float32))
        fc_path = meta["motion_path"].replace("smplxflame_30", "footcontact"
                                              ).replace(".npz", ".npy")
        contact = (np.load(fc_path).astype(np.float32) if os.path.exists(fc_path)
                   else np.zeros((t, 4), np.float32))
        on = lambda x: torch.from_numpy(x)[None].to(device)
        with torch.no_grad(), strict_fp32():
            rot6d = axis_angle_to_rotation_6d(on(poses).reshape(1, t, 55, 3)).reshape(1, t, 330)
        lat = vq.map2latent(rot6d, on(expr), on(contact), on(trans))
        pred = vq.decode(face_latent=lat["face"], upper_latent=lat["upper"],
                         hands_latent=lat["hands"], lower_latent=lat["lower"],
                         get_global_motion=True, ref_trans=on(trans[:1]))
        return _decoded(pred, t)

    generate.needs_meta = True
    generate.needs_audio = False  # the round trip never reads the waveform
    return generate


def generate_test_npz(generate_fn: Callable, test_list: List[dict], save_folder: str,
                      pose_fps: int, audio_sr: int = 16000) -> List[dict]:
    """Generate motion for every test clip and save BEAT npz; prints the reference's
    throughput line, with the first take's seconds (which include any graph capture)
    beside the mean of the later ones."""
    from ..data.audio import load_audio
    from ..io.beat_format import beat_format_save

    os.makedirs(save_folder, exist_ok=True)
    save_list = []
    total_frames = 0
    walls = []
    t0 = time.time()
    for meta in test_list:
        t_clip = time.time()
        audio = (torch.from_numpy(load_audio(meta["audio_path"], audio_sr))[None]
                 if getattr(generate_fn, "needs_audio", True) else None)
        speaker_id = torch.zeros((1, 1), dtype=torch.long)
        out = (generate_fn(audio, speaker_id, meta=meta)
               if getattr(generate_fn, "needs_meta", False)
               else generate_fn(audio, speaker_id))
        walls.append(time.time() - t_clip)
        out_path = os.path.join(save_folder, f"{meta['video_id']}_output.npz")
        beat_format_save(out_path, out["motion"], upsample=30 // pose_fps,
                         expressions=out.get("expressions"), trans=out.get("trans"))
        total_frames += out["motion"].shape[0]
        save_list.append({"video_id": meta["video_id"], "motion_path": out_path})
    warm = f", later takes {np.mean(walls[1:]):.2f}s each" if len(walls) > 1 else ""
    first = f" (first take {walls[0]:.2f}s{warm})" if walls else ""
    print(f"cost {time.time() - t0:.2f}s to generate "
          f"{total_frames / pose_fps:.2f}s of motion{first}")
    return save_list


def run_test_pass(generate_fn: Callable, test_list: List[dict], save_folder: str,
                  pose_fps: int, with_face: bool, audio_sr: int = 16000,
                  download_path: str = "./emage_evaltools/", visualize: int = 0,
                  fgd_strict: bool = False, device="cuda") -> Dict[str, object]:
    """Generate, save npz, then the metrics; returns the metric dict, also written to
    ``<save_folder>/metrics.json``. The FK metrics need the SMPL-X archive: when it is
    missing or unreadable, only FGD is computed. ``visualize``: render the first N
    clips as 2D skeleton videos (``<clip>_output_2dbody.avi``); without the archive this
    is skipped with a message. The FK, the rendering and the FGD encoder run on
    ``device``."""
    from ..core.smplx import SmplxModel, default_model_path, read_smplx
    from ..viz.render2d import render2d
    from .pipeline import evaluate_clips

    save_list = generate_test_npz(generate_fn, test_list, save_folder, pose_fps, audio_sr)
    for pred in save_list[:visualize]:
        try:
            motion_dict = dict(np.load(pred["motion_path"], allow_pickle=True))
            render2d(motion_dict, pred["motion_path"].replace(".npz", "_2dbody.avi"),
                     face_only=False, remove_global=True, device=device)
        except FileNotFoundError as e:
            print(f"visualization skipped ({e})")
            break

    arrays = None
    model_path = default_model_path()
    if model_path:
        try:
            arrays = read_smplx(model_path)
        except Exception as e:  # FK metrics are SMPL-X-gated; FGD still runs
            print(f"SMPL-X unavailable ({e}); computing FGD only")
    smplx_model = None if arrays is None else SmplxModel.from_numpy(arrays, device)

    metrics = evaluate_clips(test_list, save_list, smplx_model=smplx_model,
                             pose_fps=pose_fps, audio_sr=audio_sr, with_face=with_face,
                             download_path=download_path, fgd_strict=fgd_strict,
                             device=device)
    with open(os.path.join(save_folder, "metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    return metrics


__all__ = [
    "generate_test_npz",
    "make_camn_generate",
    "make_disco_generate",
    "make_emage_generate",
    "make_emage_vq_roundtrip_generate",
    "run_test_pass",
    "unique_test_clips",
]
