"""BEAT2 clip datasets over JSON clip metadata (counterpart of
``pantomatrix_tpu/data/beat2.py``): numpy items and batches on the host, over the port's
own audio reader and ``beat_format_load``.

Each clip is [start_idx, end_idx) of a take at 30 fps, downsampled by ``::k`` for 15 fps
models, with the aligned 16 kHz audio window and identity normalization (mean 0, std 1).
Decoded audio and motion files are cached per path (overlapping clips share a take).
"""
from __future__ import annotations

import json
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..core.masking import MASK_DICT, select_with_mask
from ..io.beat_format import beat_format_load
from .audio import load_audio

SMPLX_FPS = 30
CACHE_SIZE = 64  # decoded files kept per kind (audio, motion, foot contact)


def select_joints(poses: np.ndarray, mask) -> np.ndarray:
    """``core.masking.select_with_mask`` on a numpy array."""
    return select_with_mask(torch.from_numpy(np.ascontiguousarray(poses)), mask).numpy()


def foot_contact_path(motion_path: str) -> str:
    return motion_path.replace("smplxflame_30", "footcontact").replace(".npz", ".npy")


class _Cache:
    """A small LRU of decoded files."""

    def __init__(self, load_fn):
        self.load = load_fn
        self._store: Dict[str, object] = {}

    def __call__(self, path: str):
        if path in self._store:
            self._store[path] = self._store.pop(path)  # most recent last
        else:
            if len(self._store) >= CACHE_SIZE:
                self._store.pop(next(iter(self._store)))
            self._store[path] = self.load(path)
        return self._store[path]


class BEAT2Dataset:
    """variant="base"  -> {motion, audio}
       variant="emage" -> + expressions, trans
       variant="emage_footcontact" -> + foot_contact
       variant="disco" -> + content_label, rhythm_label
    ``base`` and ``disco`` apply the joint mask to the poses; the EMAGE variants keep all
    55 joints."""

    def __init__(self, meta_paths: Sequence[str], split: str = "train", pose_fps: int = 30,
                 audio_sr: int = 16000, joint_mask: Optional[str] = None,
                 variant: str = "base"):
        vid_meta: List[dict] = []
        for p in meta_paths:
            with open(p) as f:
                vid_meta.extend(json.load(f))
        self.data_list = [m for m in vid_meta if m.get("mode") == split]
        self.pose_fps = pose_fps
        self.audio_sr = audio_sr
        self.joint_mask = MASK_DICT[joint_mask] if joint_mask else None
        self.variant = variant
        self.mean, self.std = 0.0, 1.0  # identity normalization
        self._audio = _Cache(lambda p: load_audio(p, audio_sr))
        self._motion = _Cache(beat_format_load)
        self._footcontact = _Cache(np.load)

    def __len__(self) -> int:
        return len(self.data_list)

    def normalize(self, motion):
        return (motion - self.mean) / (self.std + 1e-7)

    @property
    def masks_joints(self) -> bool:
        return self.joint_mask is not None and self.variant in ("base", "disco")

    def __getitem__(self, item: int) -> Dict[str, np.ndarray]:
        meta = self.data_list[item]
        sdx, edx = meta["start_idx"], meta["end_idx"]
        smplx_data = self._motion(meta["motion_path"])
        motion = smplx_data["poses"][sdx:edx]  # slice, then select the joints
        if self.masks_joints:
            motion = select_joints(motion, self.joint_mask)
        k = SMPLX_FPS // self.pose_fps
        motion = self.normalize(motion[::k]).astype(np.float32)

        audio = self._audio(meta["audio_path"])
        spf = int((1 / SMPLX_FPS) * self.audio_sr)
        out = {"motion": motion, "audio": audio[sdx * spf: edx * spf].astype(np.float32)}
        if self.variant in ("emage", "emage_footcontact"):
            out["expressions"] = smplx_data["expressions"][sdx:edx].astype(np.float32)
            out["trans"] = smplx_data["trans"][sdx:edx].astype(np.float32)
        if self.variant == "emage_footcontact":
            fc = self._footcontact(foot_contact_path(meta["motion_path"]))
            out["foot_contact"] = fc[sdx:edx].astype(np.float32)
        if self.variant == "disco":
            out["content_label"] = np.asarray(meta["content_label"], np.int64)
            out["rhythm_label"] = np.asarray(meta["rhythm_label"], np.int64)
        return out


def collate(items: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


class DataLoader:
    """Shuffling batch iterator over a dataset, with the JAX package's sharding.

    ``batch_size`` is the global batch: with ``process_count`` processes each yields
    ``batch_size // process_count`` rows a step, and the process-local batches, in
    process order, make up the batch one process would yield for the same epoch seed.
    ``set_epoch`` reseeds the shuffle; resume skips batches inside the epoch
    (``train/loop.py``)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 42,
                 process_index: int = 0, process_count: int = 1, drop_last: bool = True):
        if batch_size % process_count:
            raise ValueError(f"global batch_size={batch_size} must divide evenly over "
                             f"process_count={process_count} processes")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.drop_last = drop_last
        self.epoch = 0

    @property
    def local_batch_size(self) -> int:
        return self.batch_size // self.process_count

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        """This process's index stream for the current epoch."""
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        if self.process_count == 1:
            return idx
        gb, lb = self.batch_size, self.local_batch_size
        nb = n // gb
        if not self.drop_last and n % gb:
            # pad the tail batch by wrapping around, as DistributedSampler does
            nb += 1
            idx = np.concatenate([idx, np.resize(idx, nb * gb - n)])
        return idx[: nb * gb].reshape(nb, self.process_count, lb)[:, self.process_index].reshape(-1)

    def __len__(self) -> int:
        per = len(self._indices())
        lb = self.local_batch_size
        return per // lb if self.drop_last else int(np.ceil(per / lb))

    def index_batches(self) -> Iterator[np.ndarray]:
        """Per-batch dataset indices for the current epoch, in ``__iter__``'s order."""
        idx = self._indices()
        lb = self.local_batch_size
        for b in range(len(self)):
            yield idx[b * lb: (b + 1) * lb]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for chunk in self.index_batches():
            yield collate([self.dataset[int(i)] for i in chunk])


def weighted_indices(labels: np.ndarray, n: int, seed: int = 0) -> np.ndarray:
    """Class-balanced sampling with replacement (DisCo's WeightedRandomSampler): the
    weight of a clip is 1 / count(its label)."""
    counts = np.bincount(labels)
    weights = 1.0 / counts[labels]
    return np.random.RandomState(seed).choice(len(labels), size=n, replace=True,
                                              p=weights / weights.sum())


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A host batch as tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()}


__all__ = ["BEAT2Dataset", "DataLoader", "collate", "to_device", "weighted_indices"]
