"""EMAGE inference CLI on the GPU (counterpart of ``pantomatrix_tpu/cli/test_emage.py``).

Loads the audio model and the five tokenizers (checkpoint layout ``<root>/`` for the
audio model and ``<root>/emage_vq/{face,upper,hands,lower,global}``), runs windowed
AR inference on every ``.wav`` in ``--audio_folder``, decodes with global translation,
and saves BEAT-format npz (poses, expressions, trans) per clip.

    python -m pantomatrix_tpu_torch.cli.test_emage --audio_folder in/ --save_folder out/ \
        --model_path <checkpoint root>      # or --random_init for a smoke run

``--compute_dtype bfloat16`` and ``--batched_wav`` select the serving modes of
``EmageAudioModel.inference``; the default is the float32 parity path.
``--visualization`` renders each clip as a face-only (512 x 512) and a full-body 2D
skeleton video, ``<clip>_output_2dface.avi`` and ``<clip>_output_2dbody.avi``, on
``--device`` (the SMPL-X archive comes from ``SMPLX_MODEL_PATH``).
"""
from __future__ import annotations

import argparse
import os
import time

import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--audio_folder", type=str, default="./examples/audio")
    p.add_argument("--save_folder", type=str, default="./examples/motion")
    p.add_argument("--model_path", type=str, default=None,
                   help="local checkpoint root (audio model + emage_vq/* subdirs)")
    p.add_argument("--random_init", action="store_true",
                   help="random full-width weights instead of a checkpoint")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; the default needs a CUDA card")
    p.add_argument("--compute_dtype", type=str, default=None,
                   choices=["bfloat16", "float32"],
                   help="opt-in low-precision AR serving; default float32 reference parity")
    p.add_argument("--batched_wav", action="store_true",
                   help="opt-in: encode all full windows' audio in one WavEncoder call "
                        "before the AR loop")
    p.add_argument("--visualization", action="store_true",
                   help="render 2D skeleton videos of every clip (MJPG AVI)")
    return p


def load_models(model_path, random_init: bool, device):
    from ..models.api import EmageAudioModel, EmageVQModel
    from ..models.configs import EmageAudioConfig

    if model_path:
        vq = EmageVQModel.from_pretrained(model_path, device=device)
        return EmageAudioModel.from_pretrained(model_path, device=device), vq
    if random_init:
        vq = EmageVQModel.random(seed=0, device=device)
        return EmageAudioModel(EmageAudioConfig(), seed=5, device=device), vq
    raise SystemExit("--model_path <dir> required (or --random_init for a smoke run)")


def audio_files_in(folder: str):
    return sorted(os.path.join(folder, f) for f in os.listdir(folder) if f.endswith(".wav"))


def inference_one(model, vq, audio_path: str, save_folder: str, compute_dtype=None,
                  batched_wav: bool = False) -> int:
    """Generate and save one clip; returns its frame count."""
    from ..data.audio import load_audio
    from ..io.beat_format import beat_format_save
    from ..models.emage import _select_decode_inputs

    cfg = model.config
    device = model.mask_embedding.device
    audio = torch.from_numpy(load_audio(audio_path, cfg.audio_sr))[None].to(device)
    speaker_id = torch.zeros((1, 1), dtype=torch.long, device=device)
    trans = torch.zeros((1, 1, 3), device=device)

    latent_dict = model.inference(audio, speaker_id, vq, compute_dtype=compute_dtype,
                                  batched_wav=batched_wav)
    all_pred = vq.decode(**_select_decode_inputs(cfg, latent_dict), get_global_motion=True,
                         ref_trans=trans[:, 0])
    motion = all_pred["motion_axis_angle"].cpu().numpy()
    t = motion.shape[1]
    base = os.path.splitext(os.path.basename(audio_path))[0]
    beat_format_save(
        os.path.join(save_folder, f"{base}_output.npz"),
        motion.reshape(t, -1),
        expressions=all_pred["expression"].cpu().numpy().reshape(t, -1),
        trans=all_pred["trans"].cpu().numpy().reshape(t, -1),
    )
    return t


def visualize_one(save_folder: str, audio_path: str, smplx_model) -> None:
    """The clip's face-only and full-body 2D skeleton videos beside its npz."""
    import numpy as np

    from ..viz.render2d import render2d

    base = os.path.splitext(os.path.basename(audio_path))[0]
    npz_path = os.path.join(save_folder, f"{base}_output.npz")
    motion_dict = dict(np.load(npz_path, allow_pickle=True))
    render2d(motion_dict, npz_path.replace(".npz", "_2dface.avi"), model=smplx_model,
             height=512, width=512, face_only=True, remove_global=True)
    render2d(motion_dict, npz_path.replace(".npz", "_2dbody.avi"), model=smplx_model,
             face_only=False, remove_global=True)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    os.makedirs(args.save_folder, exist_ok=True)
    model, vq = load_models(args.model_path, args.random_init, args.device)
    files = audio_files_in(args.audio_folder)
    all_t = 0
    t0 = time.time()
    for audio_path in files:
        all_t += inference_one(model, vq, audio_path, args.save_folder,
                               args.compute_dtype, args.batched_wav)
    print(f"generate total {all_t / model.config.pose_fps:.2f} seconds motion in "
          f"{time.time() - t0:.2f} seconds on {args.device}")
    if args.visualization:
        from ..viz.render2d import load_render_model

        t0 = time.time()
        smplx_model = load_render_model(args.device)
        for audio_path in files:
            visualize_one(args.save_folder, audio_path, smplx_model)
        print(f"render in {time.time() - t0:.2f} seconds")


if __name__ == "__main__":
    main()
