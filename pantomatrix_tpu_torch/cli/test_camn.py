"""CaMN inference CLI on the GPU (counterpart of ``pantomatrix_tpu/cli/test_camn.py``).

Runs the model on every ``.wav`` in ``--audio_folder`` and saves 15 fps motion,
upsampled x2 to 30 fps, as a BEAT-format npz per clip.

    python -m pantomatrix_tpu_torch.cli.test_camn --audio_folder in/ --save_folder out/ \
        --model_path <checkpoint dir>      # or --random_init for a smoke run

``--compute_dtype bfloat16`` selects the low-precision serving mode; the default is the
float32 parity path. ``--visualization`` renders each clip as a 2D skeleton video,
``<clip>_output_2dbody.avi``, on ``--device`` (the SMPL-X archive comes from
``SMPLX_MODEL_PATH``).
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
                   help="local checkpoint dir (config.json + weights)")
    p.add_argument("--random_init", action="store_true",
                   help="random full-width weights instead of a checkpoint")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; the default needs a CUDA card")
    p.add_argument("--compute_dtype", type=str, default=None,
                   choices=["bfloat16", "float32"],
                   help="opt-in low-precision serving; default float32 reference parity")
    p.add_argument("--visualization", action="store_true",
                   help="render a 2D skeleton video of every clip (MJPG AVI)")
    return p


def load_model(args, model_cls, config_cls):
    if args.model_path:
        return model_cls.from_pretrained(args.model_path, device=args.device)
    if args.random_init:
        return model_cls(config_cls(), device=args.device)
    raise SystemExit("--model_path <dir> required (or --random_init for a smoke run)")


def audio_files_in(folder: str):
    return sorted(os.path.join(folder, f) for f in os.listdir(folder) if f.endswith(".wav"))


def visualize_one(save_folder: str, audio_path: str, smplx_model) -> str:
    """The clip's full-body 2D skeleton video beside its npz; returns its path."""
    import numpy as np

    from ..viz.render2d import render2d

    base = os.path.splitext(os.path.basename(audio_path))[0]
    npz_path = os.path.join(save_folder, f"{base}_output.npz")
    motion_dict = dict(np.load(npz_path, allow_pickle=True))
    return render2d(motion_dict, npz_path.replace(".npz", "_2dbody.avi"), model=smplx_model,
                    face_only=False, remove_global=True)


def run(args, model_cls, config_cls) -> None:
    """Generate and save every clip of ``--audio_folder`` with ``model_cls``."""
    from ..data.audio import load_audio
    from ..io.beat_format import beat_format_save

    os.makedirs(args.save_folder, exist_ok=True)
    model = load_model(args, model_cls, config_cls)
    cfg = model.config
    device = torch.device(args.device)
    files = audio_files_in(args.audio_folder)
    all_t = 0
    t0 = time.time()
    for audio_path in files:
        audio = torch.from_numpy(load_audio(audio_path, cfg.audio_sr))[None].to(device)
        speaker_id = torch.zeros((1, 1), dtype=torch.long, device=device)
        motion = model(audio, speaker_id, seed_frames=cfg.seed_frames,
                       compute_dtype=args.compute_dtype)["motion_axis_angle"]
        motion = motion.cpu().numpy()
        t = motion.shape[1]
        all_t += t
        base = os.path.splitext(os.path.basename(audio_path))[0]
        beat_format_save(os.path.join(args.save_folder, f"{base}_output.npz"),
                         motion.reshape(t, -1), upsample=30 // cfg.pose_fps)
    print(f"generate total {all_t / cfg.pose_fps:.2f} seconds motion in "
          f"{time.time() - t0:.2f} seconds, saved in {args.save_folder}")
    if args.visualization:
        from ..viz.render2d import load_render_model

        t0 = time.time()
        smplx_model = load_render_model(args.device)
        for audio_path in files:
            visualize_one(args.save_folder, audio_path, smplx_model)
        print(f"render in {time.time() - t0:.2f} seconds")


def main(argv=None) -> None:
    from ..models.api import CamnAudioModel
    from ..models.configs import CamnAudioConfig

    run(build_parser().parse_args(argv), CamnAudioModel, CamnAudioConfig)


if __name__ == "__main__":
    main()
