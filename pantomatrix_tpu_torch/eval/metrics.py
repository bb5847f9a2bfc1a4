"""Evaluation metrics: FGD, BC, L1div, LVDFace, MSEFace (counterpart of
``pantomatrix_tpu/eval/metrics.py``; numpy on the host, with the FGD feature net on a
device).

The reference imports these from its external ``emage_evaltools.mertic`` package. The
interface:

    FGD(download_path).update(pred_rot6d[1,t,330], gt_rot6d).compute() / .reset()
    BC(download_path, sigma=0.3, order=7).load_audio/.load_motion/.compute/.avg
    L1div().compute(position[t,165*?]) / .avg()
    LVDFace().compute(face_v_pred, face_v_gt) / .avg()
    MSEFace().compute(face_v_pred, face_v_gt) / .avg()

FGD feature space: the reference uses a pretrained skeleton autoencoder
(``AESKConv_240_100.bin``). When that weight file is present under ``download_path`` it
is imported and its encoder built on ``device``; otherwise FGD falls back to a
deterministic statistics embedding (per-window mean | std of rot6d channels). The
fallback is a valid Frechet metric for tracking relative progress, but its values are
not comparable to the published FGD numbers. Only reading the file is guarded: a fault
on the device raises.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from .dsp import onset_detect


# ---------------------------------------------------------------------------
# Fréchet distance
# ---------------------------------------------------------------------------

def frechet_distance(feat_a: np.ndarray, feat_b: np.ndarray, eps: float = 1e-6) -> float:
    """Classic FID/FGD formula: |mu_a-mu_b|^2 + tr(Sa + Sb - 2 sqrtm(Sa Sb))."""
    mu1, mu2 = feat_a.mean(0), feat_b.mean(0)
    s1 = np.cov(feat_a, rowvar=False)
    s2 = np.cov(feat_b, rowvar=False)
    diff = mu1 - mu2
    # sqrtm via scipy when available; eigen fallback
    try:
        from scipy import linalg

        def _sqrtm(m):
            out = linalg.sqrtm(m)
            return out[0] if isinstance(out, tuple) else out

        covmean = _sqrtm(s1 @ s2)
        if not np.isfinite(covmean).all():
            offset = np.eye(s1.shape[0]) * eps
            covmean = _sqrtm((s1 + offset) @ (s2 + offset))
        if np.iscomplexobj(covmean):
            covmean = covmean.real
        tr_covmean = np.trace(covmean)
    except ImportError:  # pragma: no cover
        w, v = np.linalg.eigh(s1)
        sqrt_s1 = (v * np.sqrt(np.maximum(w, 0))) @ v.T
        w2, v2 = np.linalg.eigh(sqrt_s1 @ s2 @ sqrt_s1)
        tr_covmean = np.sum(np.sqrt(np.maximum(w2, 0)))
    return float(diff @ diff + np.trace(s1) + np.trace(s2) - 2 * tr_covmean)


FGD_WINDOW = FGD_STRIDE = 64  # frames per FGD window, and between window starts


class _StatsEmbedder:
    """Fallback FGD embedder: window -> [mean ‖ std] over time of the 330 rot6d
    channels (660-d). Deterministic, train-free."""

    def __call__(self, windows: np.ndarray) -> np.ndarray:  # (n, w, 330)
        return np.concatenate([windows.mean(1), windows.std(1)], axis=1)


class FGD:
    """Fréchet Gesture Distance over windowed rot6d sequences.

    ``embedder_kind`` records which feature net produced the features
    ("aeskconv" | "stats") so downstream metrics.json can mark FGD
    values that are NOT comparable to the reference's published numbers.
    ``strict=True`` raises instead of silently degrading to the statistics
    embedding (missing weight file OR unreadable/mismatched file).

    NOTE on fallback windowing: FGD_WINDOW/FGD_STRIDE = 64/64 (non-overlapping) is an
    internal choice for the stats embedder. The reference protocol's windowing
    lives in the external emage_evaltools source shipped next to
    ``AESKConv_240_100.bin`` — when that file arrives, re-check stride against
    that source before comparing values (tests/test_eval_metrics.py pins this
    reminder).
    """

    def __init__(self, download_path: str = "./emage_evaltools/", strict: bool = False,
                 device="cuda"):
        weight_file = os.path.join(download_path or ".", "AESKConv_240_100.bin")
        if os.path.exists(weight_file):
            self.embedder = self._load_aeskconv(weight_file, strict, device)
        elif strict:
            raise FileNotFoundError(
                f"FGD strict mode: AESKConv weight file not found at "
                f"{weight_file} (README.md:92 protocol)"
            )
        else:
            self.embedder = _StatsEmbedder()
        self.embedder_kind = (
            "stats" if isinstance(self.embedder, _StatsEmbedder) else "aeskconv"
        )
        self.reset()

    @staticmethod
    def _load_aeskconv(path: str, strict: bool = False, device="cuda"):
        """Import the pretrained skeleton-autoencoder feature net onto ``device``
        (``eval/fgd_encoder.py``). Falls back to the statistics embedding only when the
        file is unreadable or mismatched, and only if ``strict`` is off: a corrupt file
        must never silently produce FGD values incomparable with previous runs. The
        guard covers reading the file on the host; building the encoder on the device
        is outside it."""
        from .fgd_encoder import AESKConvEmbedder, read_aeskconv

        try:
            params = read_aeskconv(path)
        except Exception as e:
            if strict:
                raise RuntimeError(
                    f"FGD strict mode: failed to import AESKConv weights from "
                    f"{path}: {e}"
                ) from e
            print(
                f"FGD: failed to import AESKConv weights from {path} ({e}); "
                "falling back to the statistics embedding (values not comparable "
                "to the reference's published FGD numbers)"
            )
            return _StatsEmbedder()
        return AESKConvEmbedder(params, device)

    def reset(self) -> None:
        self._pred: List[np.ndarray] = []
        self._gt: List[np.ndarray] = []

    def _windows(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x)
        if x.ndim == 3:  # (1, t, c)
            x = x[0]
        t = x.shape[0]
        if t < FGD_WINDOW:
            return np.zeros((0, FGD_WINDOW, x.shape[-1]), x.dtype)
        starts = range(0, t - FGD_WINDOW + 1, FGD_STRIDE)
        return np.stack([x[s : s + FGD_WINDOW] for s in starts])

    def update(self, pred_rot6d, gt_rot6d) -> None:
        wp = self._windows(np.asarray(pred_rot6d, np.float32))
        wg = self._windows(np.asarray(gt_rot6d, np.float32))
        if len(wp):
            self._pred.append(self.embedder(wp))
        if len(wg):
            self._gt.append(self.embedder(wg))

    def compute(self) -> float:
        if not self._pred or not self._gt:
            return float("nan")
        return frechet_distance(np.concatenate(self._pred), np.concatenate(self._gt))


class BC:
    """Beat Constancy: alignment of motion beats (velocity minima) to audio onsets.

    score per clip = mean over motion beats of exp(-(d_nearest_onset)^2 / (2 sigma^2)),
    BEAT protocol sigma=0.3, local-extrema order=7; first/last 2 s trimmed by callers.
    """

    def __init__(self, download_path: str = "", sigma: float = 0.3, order: int = 7):
        self.sigma = sigma
        self.order = order
        self.reset()

    def reset(self) -> None:
        self.scores: List[float] = []

    def load_audio(self, path_or_wave, t_start: int = 0, t_end: Optional[int] = None,
                   without_file: bool = False, sr: int = 16000) -> np.ndarray:
        """Audio beat times (s, relative to t_start). t_start/t_end in SAMPLES."""
        if without_file:
            y = np.asarray(path_or_wave, np.float32)
        else:
            from ..data.audio import load_audio

            y = load_audio(path_or_wave, sr)
        y = y[t_start:t_end]
        return onset_detect(y, sr)

    def load_motion(self, position, t_start: int = 0, t_end: Optional[int] = None,
                    pose_fps: int = 30, without_file: bool = True) -> np.ndarray:
        """Motion beat times (s, relative to t_start) from joint-velocity local minima.

        position: (t, j*3) joint positions.
        """
        pos = np.asarray(position, np.float32)[t_start:t_end]
        t = pos.shape[0]
        vel = np.linalg.norm(np.diff(pos.reshape(t, -1, 3), axis=0), axis=2).sum(1)
        from scipy.signal import argrelextrema

        idx = argrelextrema(vel, np.less, order=self.order)[0]
        return idx / pose_fps

    def compute(self, audio_beat: np.ndarray, motion_beat: np.ndarray,
                length: int, pose_fps: int = 30) -> float:
        if len(motion_beat) == 0 or len(audio_beat) == 0:
            score = 0.0
        else:
            d = np.abs(motion_beat[:, None] - audio_beat[None, :]).min(1)
            score = float(np.mean(np.exp(-(d**2) / (2 * self.sigma**2))))
        self.scores.append(score)
        return score

    def avg(self) -> float:
        return float(np.mean(self.scores)) if self.scores else float("nan")


class L1div:
    """L1 diversity of joint positions, accumulated across clips.

    DEFINITIONAL CHOICES (the reference's implementation lives in the external
    ``emage_evaltools`` package; these are the JAX package's reconstruction, which
    tests/test_eval_metrics.py pins against an independent torch oracle and
    tests/test_torch_eval.py holds this copy to):

    per clip = mean over FRAMES of the L1 NORM (sum over all position channels)
    of the frame's deviation from the clip's temporal mean pose:
    ``mean_t( sum_c |pos[t,c] - mean_t'(pos[t',c])| )`` — the BEAT protocol's
    "average L1 distance from the mean pose". ``avg()`` = unweighted mean of the
    per-clip values (clips are NOT length-weighted). Flat (t, c) input uses the
    norm-then-mean form; anything else falls back to a plain element mean.
    """

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.values: List[float] = []

    def compute(self, position) -> float:
        pos = np.asarray(position, np.float32)
        dev = np.abs(pos - pos.mean(0, keepdims=True))
        v = float(dev.sum(-1).mean()) if pos.ndim == 2 else float(dev.mean())
        self.values.append(v)
        return v

    def avg(self) -> float:
        return float(np.mean(self.values)) if self.values else float("nan")


class LVDFace:
    """Lip/landmark Velocity Difference (call site train_emage_audio.py:417).

    DEFINITIONAL CHOICES (see L1div for why these are recorded here; oracle in
    tests/test_eval_metrics.py): velocity = forward frame difference of vertex
    positions; per clip = mean over (frames-1, vertices) of the PER-VERTEX
    EUCLIDEAN NORM (over xyz) of the velocity difference:
    ``mean_{t,v}( ||vel_pred[t,v,:] - vel_gt[t,v,:]||_2 )``. Pred/gt truncated
    to the common length first; ``avg()`` = unweighted per-clip mean.
    """

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.values: List[float] = []

    def compute(self, pred_vertices, gt_vertices) -> float:
        p = np.asarray(pred_vertices, np.float32)
        g = np.asarray(gt_vertices, np.float32)
        t = min(p.shape[0], g.shape[0])
        vp = np.diff(p[:t].reshape(t, -1, 3), axis=0)
        vg = np.diff(g[:t].reshape(t, -1, 3), axis=0)
        v = float(np.linalg.norm(vp - vg, axis=2).mean())
        self.values.append(v)
        return v

    def avg(self) -> float:
        return float(np.mean(self.values)) if self.values else float("nan")


class MSEFace:
    """Facial vertex mean squared error (call site train_emage_audio.py:418).

    DEFINITIONAL CHOICES (see L1div; oracle in tests/test_eval_metrics.py):
    per clip = plain element mean of squared position error over every
    (frame, vertex, xyz) entry, after truncating pred/gt to the common length;
    ``avg()`` = unweighted per-clip mean."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.values: List[float] = []

    def compute(self, pred_vertices, gt_vertices) -> float:
        p = np.asarray(pred_vertices, np.float32)
        g = np.asarray(gt_vertices, np.float32)
        t = min(p.shape[0], g.shape[0])
        v = float(np.mean((p[:t] - g[:t]) ** 2))
        self.values.append(v)
        return v

    def avg(self) -> float:
        return float(np.mean(self.values)) if self.values else float("nan")


__all__ = ["BC", "FGD", "L1div", "LVDFace", "MSEFace", "frechet_distance"]
