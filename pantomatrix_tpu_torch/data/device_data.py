"""Takes staged in the card's memory, clip windows gathered there (counterpart of
``pantomatrix_tpu/data/device_data.py``).

Clip windows are dense slices of a few takes. ``stage_dataset`` flattens every take the
clips reference into contiguous buffers, once: audio as int16 where that reproduces the
decoded float32 samples exactly (PCM16 WAV decodes as ``i16 / 32768``), motion,
expressions, translation and foot contact as float32, with the joint mask and the
identity normalization applied per take. ``DeviceResidentLoader`` then sends only the
(take, start) pairs of a batch to the device and gathers the windows there with one
indexed read per buffer.

Contract: for every dataset variant the gathered batch equals the host loader's batch
bit for bit (tests/test_torch_train_loop.py on the CPU, ``chip_smoke.py`` phase 18 on the
card). ``StagingUnsupported`` is raised where a dataset breaks the static-shape contract
(windows of different lengths, audio shorter than a window, a dataset above the memory
budget); the train CLIs then print why and use the host loader, as the JAX CLIs do.
"""
from __future__ import annotations

import os
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from .beat2 import SMPLX_FPS, foot_contact_path, select_joints

_I16 = 32768.0


class StagingUnsupported(ValueError):
    """The dataset cannot be staged on the device; use the host loader."""


def _audio_as_int16(a: np.ndarray) -> Optional[np.ndarray]:
    """The int16 array whose ``astype(float32) / 32768`` reproduces ``a`` bit for bit, or
    None where there is none (audio that was not 16-bit PCM)."""
    if not a.size:
        return np.zeros(0, np.int16)
    q = a * _I16
    r = np.round(q)
    if np.all(q == r) and -_I16 <= r.min() and r.max() <= _I16 - 1:
        return r.astype(np.int16)
    return None


def stage_dataset(dataset) -> Dict[str, object]:
    """Every take the dataset's clips reference, flattened into contiguous host buffers
    with per-take offsets: {"audio", "audio_off", "motion", "frame_off", ["expressions",
    "trans", "foot_contact"], "_meta": the gather's constants}. The budget is
    ``PANTO_DEVICE_DATA_MAX_GB`` GiB (default 8)."""
    clips = dataset.data_list
    if not clips:
        raise StagingUnsupported("dataset has no clips")
    lengths = {m["end_idx"] - m["start_idx"] for m in clips}
    if len(lengths) != 1:
        raise StagingUnsupported(f"variable window lengths {sorted(lengths)}")
    window = lengths.pop()
    spf = int((1 / SMPLX_FPS) * dataset.audio_sr)
    variant = dataset.variant
    with_extras = variant in ("emage", "emage_footcontact")
    with_fc = variant == "emage_footcontact"

    audio_of = {}
    for m in clips:
        audio_of.setdefault(m["motion_path"], m["audio_path"])
    take_of = {p: i for i, p in enumerate(audio_of)}

    parts = {k: [] for k in ("audio", "motion", "expressions", "trans", "foot_contact")}
    audio_off, frame_off = [0], [0]
    for path, audio_path in audio_of.items():
        smplx_data = dataset._motion(path)
        poses = smplx_data["poses"]
        if dataset.masks_joints:
            poses = select_joints(poses, dataset.joint_mask)
        parts["motion"].append(np.ascontiguousarray(dataset.normalize(poses).astype(np.float32)))
        nframes = len(parts["motion"][-1])

        def aligned(arr, name):
            # every per-frame buffer shares frame_off (built from the poses): a longer one
            # is cut to the take's frames, a shorter one fails as the host loader would
            if len(arr) < nframes:
                raise StagingUnsupported(f"{path}: {name} shorter than the take "
                                         f"({len(arr)} < {nframes})")
            return np.ascontiguousarray(arr[:nframes])

        if with_extras:
            parts["expressions"].append(aligned(
                smplx_data["expressions"].astype(np.float32), "expressions"))
            parts["trans"].append(aligned(smplx_data["trans"].astype(np.float32), "trans"))
        if with_fc:
            parts["foot_contact"].append(aligned(
                dataset._footcontact(foot_contact_path(path)).astype(np.float32),
                "foot contact"))
        parts["audio"].append(np.asarray(dataset._audio(audio_path), np.float32))
        audio_off.append(audio_off[-1] + len(parts["audio"][-1]))
        frame_off.append(frame_off[-1] + nframes)

    for m in clips:  # every window inside its own take
        t, edx = take_of[m["motion_path"]], m["end_idx"]
        if frame_off[t] + edx > frame_off[t + 1]:
            raise StagingUnsupported(f"{m['motion_path']}: window past the take's end")
        if audio_off[t] + edx * spf > audio_off[t + 1]:
            raise StagingUnsupported(f"{m['motion_path']}: audio shorter than the window")

    as_i16 = [_audio_as_int16(a) for a in parts["audio"]]
    audio = (np.concatenate(as_i16) if all(a is not None for a in as_i16)
             else np.concatenate(parts["audio"]))
    out = {"audio": audio, "audio_off": np.asarray(audio_off[:-1], np.int64),
           "motion": np.concatenate(parts["motion"]),
           "frame_off": np.asarray(frame_off[:-1], np.int64)}
    for key in ("expressions", "trans", "foot_contact"):
        if parts[key]:
            out[key] = np.concatenate(parts[key])
    total = sum(v.nbytes for v in out.values())
    budget = int(float(os.environ.get("PANTO_DEVICE_DATA_MAX_GB", 8)) * 2**30)
    if total > budget:
        raise StagingUnsupported(f"staged dataset is {total / 2**30:.2f} GiB > budget "
                                 f"{budget / 2**30:.2f} GiB (PANTO_DEVICE_DATA_MAX_GB)")
    out["_meta"] = {"window": window, "spf": spf, "k": SMPLX_FPS // dataset.pose_fps,
                    "take_of": take_of, "variant": variant, "bytes": total}
    return out


class DeviceResidentLoader:
    """A host loader (``DataLoader`` or DisCo's weighted loader) with its takes staged on
    ``device``: the same epochs, shuffle, sharding and resume (it reuses the host
    loader's ``index_batches()``), but ``__iter__`` yields (take, start) index batches
    and ``place_batch`` gathers the windows on the device."""

    def __init__(self, host_loader, device):
        self.host = host_loader
        self.device = torch.device(device)
        ds = host_loader.dataset
        buffers = stage_dataset(ds)
        meta = buffers.pop("_meta")
        self.staged_bytes = meta["bytes"]
        self.window, self.spf, self.k = meta["window"], meta["spf"], meta["k"]
        self._take = np.asarray([meta["take_of"][m["motion_path"]] for m in ds.data_list],
                                np.int64)
        self._start = np.asarray([m["start_idx"] for m in ds.data_list], np.int64)
        self._labels = {}
        if meta["variant"] == "disco":
            self._labels = {key: np.asarray([m[key] for m in ds.data_list], np.int64)
                            for key in ("content_label", "rhythm_label")}
        self.buffers = {k: torch.from_numpy(v).to(self.device) for k, v in buffers.items()}
        self._frames = torch.arange(self.window, device=self.device)
        self._samples = torch.arange(self.window * self.spf, device=self.device)

    def set_epoch(self, epoch: int) -> None:
        self.host.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.host)

    @property
    def dataset(self):
        return self.host.dataset

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for chunk in self.host.index_batches():
            idx = {"take": self._take[chunk], "start": self._start[chunk]}
            idx.update({key: arr[chunk] for key, arr in self._labels.items()})
            yield idx

    def place_batch(self, idx: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """The batch of an index batch, gathered on the device."""
        bufs = self.buffers
        on = lambda a: torch.from_numpy(np.asarray(a)).to(self.device)
        take, start = on(idx["take"]), on(idx["start"])
        frames = (bufs["frame_off"][take] + start)[:, None] + self._frames  # (b, window)
        samples = (bufs["audio_off"][take] + start * self.spf)[:, None] + self._samples
        out = {"motion": bufs["motion"][frames[:, ::self.k]], "audio": bufs["audio"][samples]}
        if out["audio"].dtype == torch.int16:
            out["audio"] = out["audio"].float() / _I16  # the host decode's expression
        for key in ("expressions", "trans", "foot_contact"):
            if key in bufs:
                out[key] = bufs[key][frames]
        out.update({k: on(v) for k, v in idx.items() if k not in ("take", "start")})
        return out


__all__ = ["DeviceResidentLoader", "StagingUnsupported", "stage_dataset"]
