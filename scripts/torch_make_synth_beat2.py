"""Write a synthetic BEAT2-format dataset at training scale and preprocess it with the
PyTorch/CUDA port (pantomatrix_tpu_torch); imports nothing of JAX.

The layout is BEAT2's (``train_test_split.csv``, ``smplxflame_30/*.npz``,
``wave16k/*.wav``) with the synthetic takes of ``scripts/make_synth_beat2.py``:
band-limited sinusoidal motion (so velocity minima exist for DisCo's rhythm labels) and
amplitude-modulated "speech", one frequency band per synthetic speaker style. Each
take's numpy seed is ``seed * 9973 + <mode index> + i * 131`` (the JAX script's
``hash(mode) % 1000`` changes between Python processes). Then the port's
preprocessing runs over it:

  - foot contact (``data/preprocess.extract_foot_contact``, SMPL-X FK on ``--device``
    over a synthetic SMPL-X model, V = 64, from a torch seed),
  - the clip indexes for 64-frame (EMAGE, the VQ trainer) and 128-frame (CaMN, DisCo)
    windows,
  - DisCo's content and rhythm labels on the 128-frame index (the port's k-means).

Run from the repository root:
  python scripts/torch_make_synth_beat2.py --root ./datasets/synth_beat2 [--device cpu]
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import sys
import time
import wave

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MODES = ("train", "val", "test")


def write_wav(path: str, x: np.ndarray, sr: int) -> None:
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())


def synth_motion(rng: np.random.RandomState, n_frames: int, n_ch: int, amp: float,
                 fps: float = 30.0, f_lo: float = 0.3, f_hi: float = 2.5) -> np.ndarray:
    """Sum of 3 random sinusoids per channel plus 2% jitter: smooth, bounded, with real
    velocity minima."""
    t = np.arange(n_frames, dtype=np.float64)[:, None] / fps
    out = np.zeros((n_frames, n_ch), np.float64)
    for _ in range(3):
        a = rng.uniform(0.1, 1.0, n_ch) * amp / 3
        f = rng.uniform(f_lo, f_hi, n_ch)
        ph = rng.uniform(0, 2 * np.pi, n_ch)
        out += a * np.sin(2 * np.pi * f * t + ph)
    out += rng.normal(scale=amp * 0.02, size=out.shape)
    return out.astype(np.float32)


def synth_speech(rng: np.random.RandomState, n_samples: int, sr: int,
                 syl_lo: float = 3.0, syl_hi: float = 4.5) -> np.ndarray:
    """Lowpassed noise and voiced sinusoids under a syllable-rate envelope, gated into
    phrases on a 0.5 s grid."""
    t = np.arange(n_samples, dtype=np.float64) / sr
    carrier = rng.normal(scale=1.0, size=n_samples)
    alpha = 0.15
    y = np.convolve(carrier, alpha * (1 - alpha) ** np.arange(64), mode="same")
    f0 = rng.uniform(100, 220)
    voiced = 0.6 * np.sin(2 * np.pi * f0 * t) + 0.3 * np.sin(2 * np.pi * 2 * f0 * t)
    syllable = np.clip(np.sin(2 * np.pi * rng.uniform(syl_lo, syl_hi) * t
                              + rng.uniform(0, 2 * np.pi)), 0, None) ** 2
    grid = (rng.uniform(size=n_samples // (sr // 2) + 1) < 0.8).astype(np.float64)
    gate = np.repeat(grid, sr // 2)[:n_samples]
    return ((0.5 * y + 0.5 * voiced) * syllable * gate * 0.45).astype(np.float32)


def write_layout(root: str, train_takes: int, val_takes: int, test_takes: int, styles: int,
                 frames: int, test_frames: int, seed: int) -> None:
    os.makedirs(os.path.join(root, "smplxflame_30"), exist_ok=True)
    os.makedirs(os.path.join(root, "wave16k"), exist_ok=True)
    sr = 16000
    counts = {"train": train_takes, "val": val_takes, "test": test_takes}
    rows = []
    for m, mode in enumerate(MODES):
        for i in range(counts[mode]):
            vid = f"2_synth_0_{mode}_{i}"
            rng = np.random.RandomState(seed * 9973 + m + i * 131)
            n = test_frames if mode == "test" else frames
            s = i % max(styles, 1)
            poses = synth_motion(rng, n, 165, amp=0.45, f_lo=0.3 + 0.15 * s,
                                 f_hi=1.6 + 0.35 * s)
            np.savez(os.path.join(root, "smplxflame_30", vid + ".npz"),
                     betas=np.zeros(300, np.float32), poses=poses,
                     expressions=synth_motion(rng, n, 100, amp=0.8),
                     trans=synth_motion(rng, n, 3, amp=0.08),
                     model="smplx2020", gender="neutral", mocap_frame_rate=30)
            write_wav(os.path.join(root, "wave16k", vid + ".wav"),
                      synth_speech(rng, n * sr // 30, sr, syl_lo=2.5 + 0.3 * s,
                                   syl_hi=3.5 + 0.3 * s), sr)
            rows.append((vid, mode))
    with open(os.path.join(root, "train_test_split.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["id", "type"])
        w.writerows(rows)
    print(f"wrote {len(rows)} takes under {root}")


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--root", default="./datasets/synth_beat2")
    # 102 train takes x 2000 frames at stride 20: 9,894 64-frame / 9,588 128-frame train
    # clips, about the reference's BEAT2 speaker-2 clip counts (9,842 / 9,485)
    p.add_argument("--train_takes", type=int, default=102)
    p.add_argument("--val_takes", type=int, default=2)
    p.add_argument("--test_takes", type=int, default=2)
    p.add_argument("--styles", type=int, default=8,
                   help="synthetic speaker styles (motion band and speech rate) cycled "
                        "over the takes")
    p.add_argument("--frames", type=int, default=2000, help="frames per train/val take")
    p.add_argument("--test_frames", type=int, default=900, help="frames per test take")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="the foot-contact FK's device: cuda (default; raises without a "
                        "card) or cpu")
    p.add_argument("--skip_footcontact", action="store_true")
    args = p.parse_args()

    import torch

    from pantomatrix_tpu_torch.core.smplx import make_synthetic_model
    from pantomatrix_tpu_torch.data.preprocess import (
        build_clip_index,
        build_disco_labels,
        extract_foot_contact,
    )
    from pantomatrix_tpu_torch.models.api import resolve_device

    device = resolve_device(args.device)
    root = args.root
    write_layout(root, args.train_takes, args.val_takes, args.test_takes, args.styles,
                 args.frames, args.test_frames, args.seed)
    if not args.skip_footcontact:
        t0 = time.time()
        model = make_synthetic_model(torch.Generator().manual_seed(0), device, num_vertices=64)
        written = extract_foot_contact(os.path.join(root, "smplxflame_30"),
                                       os.path.join(root, "footcontact"), model=model)
        print(f"foot contact of {len(written)} takes on {device}: {time.time() - t0:.1f} s")
    out_dir = os.path.join(root, "data_json")
    for length in (64, 128):
        idx = build_clip_index(root, out_dir, stride=20, motion_length=length)
        with open(idx) as f:
            print(f"clip index {idx}: {len(json.load(f))} clips")
        if length == 128:
            t0 = time.time()
            print(f"disco labels: {build_disco_labels(idx)} ({time.time() - t0:.1f} s)")


if __name__ == "__main__":
    main()
