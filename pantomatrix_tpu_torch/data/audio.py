"""Audio decode and resampling to 16 kHz mono (the port's own copy of
``pantomatrix_tpu/data/audio.py``). Host-side numpy.

Formats: RIFF/WAVE PCM (u8/i16/i24/i32) and IEEE float32/64, and MP3 (an ID3 or MPEG
frame-sync header, whatever the file's extension) through the system libmpg123
(``native/mp3.py``). Resampling is windowed-sinc polyphase (scipy's ``resample_poly``
with a Kaiser window).
"""
from __future__ import annotations

import os
import struct
from fractions import Fraction
from typing import Tuple

import numpy as np


def _decode_pcm(raw: bytes, sampwidth: int, n_channels: int) -> np.ndarray:
    if sampwidth == 1:  # unsigned 8-bit
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif sampwidth == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sampwidth == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3).astype(np.int32)
        x = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
        x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32) / float(1 << 23)
    elif sampwidth == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / float(1 << 31)
    else:
        raise ValueError(f"unsupported PCM sample width {sampwidth}")
    if n_channels > 1:
        x = x.reshape(-1, n_channels).mean(axis=1)
    return x


def _is_mp3(header: bytes) -> bool:
    """An ID3 tag, or an MPEG audio frame sync (11 set bits)."""
    return header[:3] == b"ID3" or (len(header) >= 2 and header[0] == 0xFF
                                    and (header[1] & 0xE0) == 0xE0)


def _read_mp3(path: str) -> Tuple[np.ndarray, int]:
    try:
        from ..native import mp3  # libmpg123 ctypes binding

        return mp3.decode(path)
    except (ImportError, OSError) as e:  # OSError: libmpg123 shared object missing
        raise ValueError(
            f"{path}: MP3-encoded audio needs the system libmpg123 "
            "(pantomatrix_tpu_torch/native/mp3.py); install it or provide PCM WAV"
        ) from e


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a RIFF/WAVE or MP3 file -> (float32 mono in [-1, 1], sample_rate)."""
    fmt = data = None
    with open(path, "rb") as f:
        header = f.read(12)
        if header[:4] != b"RIFF" or header[8:12] != b"WAVE":
            if _is_mp3(header):
                return _read_mp3(path)
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        # walk the chunks by hand so float WAVs work too (the wave module rejects them)
        while True:
            head = f.read(8)
            if len(head) < 8:
                break
            cid, size = head[:4], struct.unpack("<I", head[4:])[0]
            if cid == b"fmt ":
                fmt = f.read(size)
            elif cid == b"data":
                data = f.read(size)
            else:
                f.seek(size, os.SEEK_CUR)
            if size & 1:
                f.seek(1, os.SEEK_CUR)
    if fmt is None or data is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, n_channels, sample_rate, _, _, bits = struct.unpack("<HHIIHH", fmt[:16])
    if audio_format == 0xFFFE and len(fmt) >= 40:  # WAVE_FORMAT_EXTENSIBLE
        audio_format = struct.unpack("<H", fmt[24:26])[0]
    if audio_format == 1:
        x = _decode_pcm(data, bits // 8, n_channels)
    elif audio_format == 3:
        x = np.frombuffer(data, dtype="<f4" if bits == 32 else "<f8").astype(np.float32)
        if n_channels > 1:
            x = x.reshape(-1, n_channels).mean(axis=1)
    else:
        raise ValueError(f"{path}: unsupported WAV format tag {audio_format}")
    return x, sample_rate


def resample(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase windowed-sinc resampling (Kaiser beta=14.77, like soxr's HQ preset)."""
    if orig_sr == target_sr:
        return x.astype(np.float32)
    from scipy.signal import resample_poly

    frac = Fraction(target_sr, orig_sr)
    y = resample_poly(x.astype(np.float64), frac.numerator, frac.denominator,
                      window=("kaiser", 14.769656459379492))
    return y.astype(np.float32)


def load_audio(path: str, sr: int = 16000) -> np.ndarray:
    """float32 mono samples of a WAV or MP3 file at ``sr``."""
    x, orig_sr = read_wav(path)
    return resample(x, orig_sr, sr)


__all__ = ["load_audio", "read_wav", "resample"]
