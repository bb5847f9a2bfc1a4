"""Host-side DSP for the Beat Constancy metric: STFT, mel spectrogram, onset detection
(a copy of ``pantomatrix_tpu/eval/dsp.py``, which the port keeps as its own).

It matches librosa 0.10's ``onset_detect`` pipeline, which the reference's metric
package calls:

- STFT: centered hann, reflect padding, n_fft=2048, hop=512;
- mel: 128 Slaney filters, fmax = sr/2 (the 0.10 onset_strength default);
- onset_strength: positive first-difference spectral flux on power_to_db(mel),
  mean over bands, then the centering compensation pad of
  ``lag + n_fft // (2*hop)`` zero frames at the front, truncated to the frame
  count (librosa onset_strength_multi center=True);
- onset_detect: envelope normalized to [0,1] by (x - min) / (max + tiny), then
  librosa.util.peak_pick with onset_detect's time-derived windows
  (pre_max = 0.03*sr//hop, post_max = 1, pre_avg = 0.10*sr//hop,
  post_avg = 0.10*sr//hop + 1, wait = 0.03*sr//hop, delta = 0.07) using the same
  sliding max (constant mode, cval = x.min()) / boundary-corrected sliding mean /
  greedy wait semantics.
"""
from __future__ import annotations

import numpy as np


def stft_mag(y: np.ndarray, n_fft: int = 2048, hop: int = 512) -> np.ndarray:
    """Magnitude STFT with centered hann window and reflect padding -> (1+n_fft/2, T)."""
    pad = n_fft // 2
    y = np.pad(y, (pad, pad), mode="reflect")
    n_frames = 1 + (len(y) - n_fft) // hop
    window = np.hanning(n_fft + 1)[:-1].astype(np.float64)
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = y[idx] * window
    return np.abs(np.fft.rfft(frames, axis=1)).T.astype(np.float64)


def hz_to_mel(f):
    """Slaney mel scale (librosa default htk=False)."""
    f = np.asarray(f, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mels)


def mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def mel_filterbank(sr: int, n_fft: int, n_mels: int = 128, fmax=None) -> np.ndarray:
    fmax = fmax or sr / 2
    fft_freqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(fmax), n_mels + 2))
    weights = np.zeros((n_mels, len(fft_freqs)))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
    return weights * enorm[:, None]


def melspectrogram(y: np.ndarray, sr: int, n_fft: int = 2048, hop: int = 512,
                   n_mels: int = 128) -> np.ndarray:
    S = stft_mag(y, n_fft, hop) ** 2
    return mel_filterbank(sr, n_fft, n_mels) @ S


def onset_strength(y: np.ndarray, sr: int, hop: int = 512,
                   n_fft: int = 2048, lag: int = 1) -> np.ndarray:
    """librosa.onset.onset_strength (0.10, center=True): positive spectral flux on
    power_to_db(mel), mean over bands, front-padded by ``lag + n_fft // (2*hop)``
    zeros (lag + centering compensation) and truncated to the frame count."""
    S = melspectrogram(y, sr, n_fft=n_fft, hop=hop)
    S_db = 10.0 * np.log10(np.maximum(S, 1e-10))
    S_db = np.maximum(S_db, S_db.max() - 80.0)
    diff = np.maximum(0.0, S_db[:, lag:] - S_db[:, :-lag])
    env = np.mean(diff, axis=0)
    pad = lag + n_fft // (2 * hop)
    return np.concatenate([np.zeros(pad), env])[: S.shape[1]]


def pick_peaks(env: np.ndarray, pre_max: int, post_max: int, pre_avg: int,
               post_avg: int, delta: float, wait: int) -> np.ndarray:
    """librosa.util.peak_pick, exact semantics: sliding max over
    [i-pre_max, i+post_max) with constant cval = env.min(); sliding mean over
    [i-pre_avg, i+post_avg) truncated at the boundaries; a peak is a sample that
    equals the sliding max, clears mean + delta, and is > wait frames after the
    previously accepted peak (greedy)."""
    from scipy import ndimage

    x = np.asarray(env, np.float64)
    n = x.shape[0]
    max_length = int(pre_max + post_max)
    max_origin = int(np.ceil(0.5 * (pre_max - post_max)))
    mov_max = ndimage.maximum_filter1d(x, max_length, mode="constant",
                                       origin=max_origin, cval=x.min())
    avg_length = int(pre_avg + post_avg)
    avg_origin = int(np.ceil(0.5 * (pre_avg - post_avg)))
    mov_avg = ndimage.uniform_filter1d(x, avg_length, mode="nearest",
                                       origin=avg_origin)
    # boundary correction: true truncated-window means where the window falls off
    # either end (librosa does the same explicit fix-up)
    i = 0
    while i - pre_avg < 0 and i < n:
        mov_avg[i] = np.mean(x[max(0, i - pre_avg) : min(n, i + post_avg)])
        i += 1
    i = max(0, n - post_avg)
    while i < n:
        mov_avg[i] = np.mean(x[max(0, i - pre_avg) : min(n, i + post_avg)])
        i += 1

    candidates = np.flatnonzero((x == mov_max) & (x >= mov_avg + delta) & (x != 0))
    peaks = []
    last = -np.inf
    for i in candidates:
        if i > last + wait:
            peaks.append(i)
            last = i
    return np.asarray(peaks, dtype=np.int64)


def onset_detect(y: np.ndarray, sr: int, hop: int = 512) -> np.ndarray:
    """librosa.onset.onset_detect(units='time', backtrack=False): onset times in
    seconds, with the envelope normalized to [0, 1] and the time-derived peak-pick
    windows (0.10 defaults)."""
    env = onset_strength(y, sr, hop)
    env = env - env.min()
    env = env / (env.max() + np.finfo(np.float64).tiny)
    frames = pick_peaks(
        env,
        pre_max=int(0.03 * sr // hop),
        post_max=int(0.00 * sr // hop + 1),
        pre_avg=int(0.10 * sr // hop),
        post_avg=int(0.10 * sr // hop + 1),
        delta=0.07,
        wait=int(0.03 * sr // hop),
    )
    return frames * hop / sr


__all__ = [
    "mel_filterbank",
    "melspectrogram",
    "onset_detect",
    "onset_strength",
    "pick_peaks",
    "stft_mag",
]
