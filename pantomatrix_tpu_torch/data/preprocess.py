"""BEAT2 preprocessing (counterpart of ``pantomatrix_tpu/data/preprocess.py``): the clip
index, per-take foot contact from SMPL-X forward kinematics on a device, and DisCo's
content and rhythm labels from a k-means of the port's own.

The k-means (``kmeans``: k-means++ seeding from ``np.random.RandomState(seed)``, then
Lloyd iterations until the labels stop changing) stands in for scikit-learn's
``KMeans``, which the JAX package uses and the GPU machine does not have. Its labels
equal scikit-learn's only up to a permutation of the label values, and only where the
clusters are well separated: elsewhere the two can settle in different local optima.
"""
from __future__ import annotations

import csv
import json
import os
from typing import List, Optional

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


FOOT_JOINTS = (7, 8, 10, 11)  # left/right ankle, left/right foot
FOOT_CHUNK = 128  # frames per FK call


def foot_velocities(model, poses, betas, trans, expressions) -> np.ndarray:
    """(T, 4) per-frame displacement norms of the ankle and foot joints, frame t to
    t + 1 (the last frame 0), from ``core/smplx.lbs`` on the model's device in chunks
    of ``FOOT_CHUNK`` frames, in the model's float type."""
    from ..core.smplx import lbs

    n = poses.shape[0]
    chunks = []
    for i in range(0, n, FOOT_CHUNK):
        sl = slice(i, min(i + FOOT_CHUNK, n))
        joints = lbs(model, betas, poses[sl], expressions=expressions[sl], trans=trans[sl],
                     return_vertices=False)["joints"][:, FOOT_JOINTS]
        chunks.append(joints.cpu().numpy())
    jt = np.concatenate(chunks, axis=0).transpose(1, 0, 2)  # (4, T, 3)
    feetv = np.zeros((4, n), jt.dtype)
    feetv[:, :-1] = np.linalg.norm(jt[:, 1:] - jt[:, :-1], axis=-1)
    return feetv.T


def read_take(path: str):
    """poses (T, 165), betas (300,), trans (T, 3) and expressions (T, 100) (zeros when
    absent) of a BEAT2 ``smplxflame_30`` npz, as float32: ``foot_velocities``'s
    arguments after the model."""
    with np.load(path, allow_pickle=True) as data:
        poses = np.asarray(data["poses"], np.float32)
        trans = np.asarray(data["trans"], np.float32)
        betas = np.asarray(data["betas"], np.float32).reshape(-1)[:300]
        exps = (np.asarray(data["expressions"], np.float32) if "expressions" in data
                else np.zeros((poses.shape[0], 100), np.float32))
    return poses, betas, trans, exps


def extract_foot_contact(root_dir: str, output_dir: str, model=None, threshold: float = 0.01,
                         device="cuda") -> List[str]:
    """Per-take binary foot contact (T, 4), float64, saved as ``<output_dir>/<take>.npy``:
    1 where the joint moves less than ``threshold`` to the next frame (the last frame
    counts as still), as the reference's foot_contact.py and the JAX package compute it.
    The FK runs on ``model``'s device, or on ``device`` with the SMPL-X archive of
    ``SMPLX_MODEL_PATH`` when no model is given. Returns the written paths."""
    from ..core.smplx import default_model_path, load_smplx
    from ..models.api import resolve_device

    if model is None:
        path = default_model_path()
        if path is None:
            raise FileNotFoundError("SMPL-X model npz required (SMPLX_MODEL_PATH)")
        model = load_smplx(path, resolve_device(device))
    os.makedirs(output_dir, exist_ok=True)
    written = []
    for data_file in sorted(os.listdir(root_dir)):
        if not data_file.endswith(".npz"):
            continue
        feetv = foot_velocities(model, *read_take(os.path.join(root_dir, data_file)))
        out = os.path.join(output_dir, data_file.replace(".npz", ".npy"))
        np.save(out, (feetv < threshold).astype(float))
        written.append(out)
    return written


KMEANS_MAX_ITER = 300  # scikit-learn's default


def kmeans(x: np.ndarray, n_clusters: int, seed: int = 0) -> np.ndarray:
    """Labels (N,) of a k-means of the rows of ``x``, in float64: k-means++ seeding (each
    next center drawn with probability proportional to the squared distance to the
    nearest chosen one) from ``np.random.RandomState(seed)``, then Lloyd iterations
    until no label changes (at most ``KMEANS_MAX_ITER``); a cluster left empty takes the
    point farthest from its center."""
    x = np.asarray(x, np.float64).reshape(len(x), -1)
    n = len(x)
    rng = np.random.RandomState(seed)
    x_sq = (x * x).sum(1)

    def sq_dist(centers):
        return np.maximum(x_sq[:, None] - 2.0 * x @ centers.T + (centers * centers).sum(1), 0)

    centers = np.empty((n_clusters, x.shape[1]))
    centers[0] = x[rng.randint(n)]
    d2 = sq_dist(centers[:1])[:, 0]
    for c in range(1, n_clusters):
        total = d2.sum()
        centers[c] = x[rng.choice(n, p=d2 / total) if total > 0 else rng.randint(n)]
        d2 = np.minimum(d2, sq_dist(centers[c:c + 1])[:, 0])
    labels = None
    for _ in range(KMEANS_MAX_ITER):
        dist = sq_dist(centers)
        new = dist.argmin(1)
        if labels is not None and np.array_equal(new, labels):
            break
        labels = new
        for c in range(n_clusters):
            members = labels == c
            if members.any():
                centers[c] = x[members].mean(0)
            else:
                far = int(dist[np.arange(n), labels].argmax())
                centers[c], labels[far] = x[far], c
    return labels


def build_disco_labels(json_path: str, output_path: Optional[str] = None,
                       n_clusters: int = 10, window: int = 5, seed: int = 0) -> str:
    """DisCo's labels, as the reference's clustering.py and the JAX package compute
    them: ``content_label``, a k-means of each clip's flattened first 21 joints;
    ``rhythm_label``, a k-means of its beat pattern (the frames where a joint's speed is
    the minimum of the ``2 window + 1`` frames around it). Writes the index with both to
    ``output_path`` (default ``<json>_disco.json``) and returns it."""
    from numpy.lib.stride_tricks import sliding_window_view

    with open(json_path) as f:
        data = json.load(f)
    arr = []
    for d in data:
        with np.load(d["motion_path"], allow_pickle=True) as m:
            arr.append(m["poses"][d["start_idx"]:d["end_idx"]])
    arr = np.asarray(arr)
    n, t = arr.shape[0], arr.shape[1]
    arr = arr.reshape(n, t, 55, 3)[:, :, :21]
    content_labels = kmeans(arr.reshape(n, -1), n_clusters, seed)

    mag = np.linalg.norm(np.diff(arr, axis=1), axis=-1)  # (n, t-1, 21)
    beat = np.zeros_like(mag)
    w = window
    padded = np.pad(mag, ((0, 0), (w, w), (0, 0)), constant_values=np.inf)
    local_min = mag == sliding_window_view(padded, 2 * w + 1, axis=1).min(-1)
    beat[:, w:mag.shape[1] - w] = local_min[:, w:mag.shape[1] - w]
    rhythm_labels = kmeans(beat.reshape(n, -1), n_clusters, seed)

    for i, d in enumerate(data):
        d["content_label"] = int(content_labels[i])
        d["rhythm_label"] = int(rhythm_labels[i])
    output_path = output_path or json_path.replace(".json", "_disco.json")
    with open(output_path, "w") as f:
        json.dump(data, f)
    return output_path


__all__ = ["FOOT_JOINTS", "build_clip_index", "build_disco_labels", "extract_foot_contact",
           "foot_velocities", "kmeans", "read_take"]
