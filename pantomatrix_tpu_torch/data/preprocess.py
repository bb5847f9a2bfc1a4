"""BEAT2 preprocessing (counterpart of ``pantomatrix_tpu/data/preprocess.py``): the
clip index that evaluation builds from a bare BEAT2 layout. Foot-contact extraction and
the DisCo labels come with training.
"""
from __future__ import annotations

import csv
import json
import os
from typing import List

import numpy as np


def build_clip_index(
    root_dir: str,
    output_dir: str,
    stride: int = 20,
    motion_length: int = 64,
    speaker_target: int = 2,
    use_additional: bool = False,
) -> str:
    """Scan train_test_split.csv, window each take -> clip-metadata JSON
    (process_testdata.py parity; same filename scheme)."""
    os.makedirs(output_dir, exist_ok=True)
    split_path = os.path.join(root_dir, "train_test_split.csv")
    clips: List[dict] = []
    with open(split_path) as f:
        for row in csv.DictReader(f):
            video_id, mode = row["id"], row["type"]
            if int(video_id.split("_")[0]) != speaker_target:
                continue
            if not use_additional and mode == "additional":
                continue
            npz_path = os.path.join(root_dir, "smplxflame_30", video_id + ".npz")
            wav_path = os.path.join(root_dir, "wave16k", video_id + ".wav")
            try:
                motion = np.load(npz_path, allow_pickle=True)["poses"]
            except Exception:
                print(f"cant open {npz_path}")
                continue
            total_len = motion.shape[0]
            for i in range(0, total_len - motion_length, stride):
                clips.append({
                    "video_id": video_id,
                    "motion_path": npz_path,
                    "audio_path": wav_path,
                    "mode": mode,
                    "start_idx": i,
                    "end_idx": i + motion_length,
                })
    out = os.path.join(
        output_dir, f"beat2_s{stride}_l{motion_length}_speaker{speaker_target}.json"
    )
    with open(out, "w") as f:
        json.dump(clips, f, indent=4)
    return out


__all__ = ["build_clip_index"]
