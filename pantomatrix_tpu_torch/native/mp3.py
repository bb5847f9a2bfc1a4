"""MP3 decode through the system libmpg123, by ctypes (the port's own copy of
``pantomatrix_tpu/native/mp3.py``).

The reference's example "wav" files are MP3 streams with ID3 headers. Decodes to
float32 and downmixes to mono. Host-side only.
"""
from __future__ import annotations

import ctypes
import ctypes.util
from typing import Tuple

import numpy as np

MPG123_OK = 0
MPG123_DONE = -12
MPG123_ENC_FLOAT_32 = 0x200


class _Lib:
    handle = None


def _load() -> ctypes.CDLL:
    if _Lib.handle is not None:
        return _Lib.handle
    name = ctypes.util.find_library("mpg123") or "libmpg123.so.0"
    lib = ctypes.CDLL(name)
    lib.mpg123_new.restype = ctypes.c_void_p
    lib.mpg123_new.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
    lib.mpg123_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.mpg123_getformat.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.mpg123_format_none.argtypes = [ctypes.c_void_p]
    lib.mpg123_format.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_int,
                                  ctypes.c_int]
    lib.mpg123_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                                ctypes.POINTER(ctypes.c_size_t)]
    lib.mpg123_close.argtypes = [ctypes.c_void_p]
    lib.mpg123_delete.argtypes = [ctypes.c_void_p]
    lib.mpg123_init()
    _Lib.handle = lib
    return lib


def decode(path: str) -> Tuple[np.ndarray, int]:
    """Decode an MP3 file -> (float32 mono waveform, sample_rate)."""
    lib = _load()
    err = ctypes.c_int(0)
    h = lib.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise RuntimeError(f"mpg123_new failed ({err.value})")
    try:
        if lib.mpg123_open(h, path.encode()) != MPG123_OK:
            raise RuntimeError(f"mpg123_open failed for {path}")
        rate = ctypes.c_long(0)
        channels = ctypes.c_int(0)
        encoding = ctypes.c_int(0)
        if lib.mpg123_getformat(h, ctypes.byref(rate), ctypes.byref(channels),
                                ctypes.byref(encoding)) != MPG123_OK:
            raise RuntimeError("mpg123_getformat failed")
        # mpg123's default negotiated output is signed 16-bit at the stream's
        # rate/channels; decode that and convert (changing the format after open is
        # unreliable across libmpg123 versions)
        buf = ctypes.create_string_buffer(1 << 18)
        done = ctypes.c_size_t(0)
        chunks = []
        MPG123_NEW_FORMAT = -11
        while True:
            ret = lib.mpg123_read(h, buf, len(buf), ctypes.byref(done))
            if done.value:
                chunks.append(np.frombuffer(buf.raw[: done.value], "<i2").copy())
            if ret == MPG123_DONE:
                break
            if ret not in (MPG123_OK, MPG123_NEW_FORMAT) and not done.value:
                break
        xi = np.concatenate(chunks) if chunks else np.zeros(0, np.int16)
        x = xi.astype(np.float32) / 32768.0
        if channels.value > 1:
            x = x.reshape(-1, channels.value).mean(axis=1)
        return x, int(rate.value)
    finally:
        lib.mpg123_close(h)
        lib.mpg123_delete(h)


__all__ = ["decode"]
