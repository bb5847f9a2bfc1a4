"""AVI (RIFF) files of MJPG video and PCM16 audio, without cv2 or ffmpeg (counterpart of
``pantomatrix_tpu/viz/avi.py``).

``write_avi`` writes the JAX package's layout byte for byte around the JPEG payloads: the
same headers, one ``01wb`` audio chunk after each ``00dc`` frame (sample_rate // fps
samples, the remainder with the last frame) and the same ``idx1``. Frames are encoded
by ``viz/jpeg.py``; ``write_avi_jpegs`` takes payloads already encoded and streams them
to the file, so a long take never holds its raw frames. ``read_avi`` parses such a file
back (payloads, fps, size, audio) and checks its index. ``add_audio_to_video`` copies
the silent file's JPEG payloads unchanged beside the new audio track; the JAX version
decodes them with cv2 and encodes them again.
"""
from __future__ import annotations

import struct
from typing import Iterable, Optional

import numpy as np

_AVIF_HASINDEX = 0x10
_AVIIF_KEYFRAME = 0x10


def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    pad = b"\x00" if len(payload) % 2 else b""
    return fourcc + struct.pack("<I", len(payload)) + payload + pad


def _list(fourcc: bytes, payload: bytes) -> bytes:
    return _chunk(b"LIST", fourcc + payload)


def _pcm16(audio) -> np.ndarray:
    audio = np.asarray(audio)
    if audio.dtype != np.int16:
        audio = (np.clip(audio, -1, 1) * 32767).astype(np.int16)
    return audio


def _headers(n_frames: int, width: int, height: int, fps: int,
             audio: Optional[np.ndarray], sample_rate: int) -> bytes:
    n_streams = 2 if audio is not None else 1
    avih = struct.pack("<IIIIIIIIIIIIII", int(1e6 / fps), 0, 0, _AVIF_HASINDEX, n_frames, 0,
                       n_streams, 0, width, height, 0, 0, 0, 0)
    strh_v = struct.pack("<4s4sIHHIIIIIIIhhhh", b"vids", b"MJPG", 0, 0, 0, 0, 1, fps, 0,
                         n_frames, 0, 10000, 0, 0, 0, 0)
    strf_v = struct.pack("<IiiHH4sIiiII", 40, width, height, 1, 24, b"MJPG",
                         width * height * 3, 0, 0, 0, 0)
    streams = _list(b"strl", _chunk(b"strh", strh_v) + _chunk(b"strf", strf_v))
    if audio is not None:
        block_align = 2
        strh_a = struct.pack("<4s4sIHHIIIIIIIhhhh", b"auds", b"\x00\x00\x00\x00", 0, 0, 0, 0,
                             1, sample_rate, 0, len(audio), 0, 0, block_align, 0, 0, 0)
        strf_a = struct.pack("<HHIIHH", 1, 1, sample_rate, sample_rate * 2, block_align, 16)
        streams += _list(b"strl", _chunk(b"strh", strh_a) + _chunk(b"strf", strf_a))
    return _list(b"hdrl", _chunk(b"avih", avih) + streams)


def write_avi_jpegs(path: str, jpegs: Iterable[bytes], n_frames: int, width: int,
                    height: int, fps: int = 30, audio: Optional[np.ndarray] = None,
                    sample_rate: int = 16000) -> str:
    """Write ``n_frames`` JPEG payloads (any iterable, consumed once) and optional mono
    audio (float in [-1, 1] or int16) as an AVI; the RIFF and ``movi`` sizes are patched
    in once the payloads are written."""
    if n_frames < 1:
        raise ValueError("no frames")
    audio = None if audio is None else _pcm16(audio)
    samples_per_frame = sample_rate // fps if audio is not None else 0
    index = []  # (fourcc, flags, offset from the 'movi' fourcc, size)
    with open(path, "wb") as f:
        f.write(b"RIFF\x00\x00\x00\x00AVI ")
        f.write(_headers(n_frames, width, height, fps, audio, sample_rate))
        movi_at = f.tell()
        f.write(b"LIST\x00\x00\x00\x00movi")
        offset = 4
        a_pos = 0
        i = -1
        for i, jpg in enumerate(jpegs):
            if i >= n_frames:
                raise ValueError(f"more than the {n_frames} frames announced")
            index.append((b"00dc", _AVIIF_KEYFRAME, offset, len(jpg)))
            c = _chunk(b"00dc", jpg)
            f.write(c)
            offset += len(c)
            if audio is not None:
                sl = audio[a_pos:a_pos + samples_per_frame]
                a_pos += samples_per_frame
                if i == n_frames - 1:  # the remainder rides with the last frame
                    sl = np.concatenate([sl, audio[a_pos:]])
                ab = sl.astype("<i2").tobytes()
                if ab:
                    index.append((b"01wb", _AVIIF_KEYFRAME, offset, len(ab)))
                    c = _chunk(b"01wb", ab)
                    f.write(c)
                    offset += len(c)
        if i + 1 != n_frames:
            raise ValueError(f"{i + 1} frames written, {n_frames} announced")
        f.write(_chunk(b"idx1", b"".join(struct.pack("<4sIII", *e) for e in index)))
        end = f.tell()
        f.seek(movi_at + 4)
        f.write(struct.pack("<I", offset))
        f.seek(4)
        f.write(struct.pack("<I", end - 8))
    return path


def write_avi(path: str, frames, fps: int = 30, audio: Optional[np.ndarray] = None,
              sample_rate: int = 16000, jpeg_quality: int = 90) -> str:
    """frames: (n, h, w, 3) uint8 BGR, a tensor (encoded on its device) or a sequence of
    (h, w, 3) arrays (encoded on the CPU); audio: float32 or int16 mono."""
    import torch

    from .jpeg import encode_frames

    if not isinstance(frames, torch.Tensor):
        frames = list(frames)
        if not frames:
            raise ValueError("no frames")
        frames = np.stack(frames)
    n, h, w = frames.shape[:3]
    return write_avi_jpegs(path, encode_frames(frames, jpeg_quality), n, w, h, fps, audio,
                           sample_rate)


def _walk(buf: bytes, start: int, end: int):
    """(fourcc, payload start, size) of each chunk in buf[start:end]."""
    pos = start
    while pos + 8 <= end:
        fourcc, size = buf[pos:pos + 4], struct.unpack_from("<I", buf, pos + 4)[0]
        if pos + 8 + size > end:
            raise ValueError(f"chunk {fourcc!r} at {pos} runs past its list")
        yield fourcc, pos + 8, size
        pos += 8 + size + (size & 1)


def read_avi(path: str) -> dict:
    """Parse an AVI written by :func:`write_avi_jpegs`: ``jpegs`` (the ``00dc``
    payloads), ``fps``, ``width``, ``height``, ``n_frames`` (the header's count) and
    ``audio`` (int16, empty without an audio stream), ``sample_rate``. Raises if
    ``idx1`` does not point at the chunks as they lie in ``movi``."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:4] != b"RIFF" or buf[8:12] != b"AVI ":
        raise ValueError(f"{path}: not an AVI file")
    riff_end = 8 + struct.unpack_from("<I", buf, 4)[0]
    out = {"sample_rate": None}
    movi = idx1 = None
    for fourcc, at, size in _walk(buf, 12, riff_end):
        if fourcc == b"LIST" and buf[at:at + 4] == b"hdrl":
            for ck, cat, csize in _walk(buf, at + 4, at + size):
                if ck == b"avih":
                    v = struct.unpack_from("<IIIIIIIIII", buf, cat)
                    out.update(n_frames=v[4], width=v[8], height=v[9])
                elif ck == b"LIST" and buf[cat:cat + 4] == b"strl":
                    strh = next(_walk(buf, cat + 4, cat + csize))
                    kind = buf[strh[1]:strh[1] + 4]
                    rate = struct.unpack_from("<II", buf, strh[1] + 20)
                    if kind == b"vids":
                        out["fps"] = rate[1] // rate[0]
                    elif kind == b"auds":
                        out["sample_rate"] = rate[1] // rate[0]
        elif fourcc == b"LIST" and buf[at:at + 4] == b"movi":
            movi = (at, size)
        elif fourcc == b"idx1":
            idx1 = (at, size)
    if movi is None or idx1 is None:
        raise ValueError(f"{path}: no movi list or no idx1")
    chunks = [(ck, cat, csize) for ck, cat, csize in _walk(buf, movi[0] + 4, movi[0] + movi[1])]
    entries = [struct.unpack_from("<4sIII", buf, idx1[0] + 16 * k) for k in range(idx1[1] // 16)]
    if len(entries) != len(chunks):
        raise ValueError(f"{path}: idx1 has {len(entries)} entries, movi {len(chunks)} chunks")
    for (ck, cat, csize), (fourcc, _, offset, size) in zip(chunks, entries):
        if (fourcc, movi[0] + offset + 8, size) != (ck, cat, csize):
            raise ValueError(f"{path}: idx1 entry {fourcc!r} at {offset} does not match movi")
    out["jpegs"] = [buf[cat:cat + csize] for ck, cat, csize in chunks if ck == b"00dc"]
    out["audio"] = np.frombuffer(b"".join(buf[cat:cat + csize] for ck, cat, csize in chunks
                                          if ck == b"01wb"), "<i2").copy()
    return out


def add_audio_to_video(silent_video_path: str, audio_path: str, output_video_path: str,
                       fps: Optional[int] = None) -> str:
    """The silent AVI's JPEG payloads, unchanged, with a 16 kHz track read from
    ``audio_path`` (WAV or MP3); the output is ``.avi``."""
    from ..data.audio import load_audio

    video = read_avi(silent_video_path)
    audio = load_audio(audio_path, 16000)
    if not output_video_path.endswith(".avi"):
        output_video_path = output_video_path.rsplit(".", 1)[0] + ".avi"
    return write_avi_jpegs(output_video_path, video["jpegs"], len(video["jpegs"]),
                           video["width"], video["height"], fps or video["fps"], audio, 16000)


__all__ = ["add_audio_to_video", "read_avi", "write_avi", "write_avi_jpegs"]
