"""Host C++ of the port, built with g++ at first use and loaded through ctypes: the mesh
rasterizer (``rasterizer.cpp``, the port's own copy of the JAX package's) and the JPEG
entropy coder of ``viz/jpeg.py`` (``jpeg.cpp``). ``mp3.py`` binds the system libmpg123.

Each source builds into ``build/torch_native/<name>-<hash>.so`` beside the package; the
hash is over the source and the compiler flags, so an edit to either builds anew. A
failed build raises with g++'s log. Nothing is built or loaded at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Optional

import numpy as np

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_loaded: Dict[str, ctypes.CDLL] = {}


def library_path(name: str) -> Path:
    """Where ``<name>.cpp``'s library lives: named by a hash of the source and the flags."""
    src = SRC_DIR / f"{name}.cpp"
    digest = hashlib.sha256(src.read_bytes() + "\0".join(GXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile ``<name>.cpp`` with g++ unless its library exists; return the library's
    path. Raises RuntimeError with the compiler's log on failure."""
    lib = library_path(name)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(SRC_DIR / f"{name}.cpp"), "-o", str(tmp)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"g++ not found: {name}.cpp is built from source at first use") from e
    if r.returncode != 0:
        raise RuntimeError(f"g++ build of {name}.cpp failed (exit {r.returncode}):\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return lib


def _load(name: str, signatures: dict) -> ctypes.CDLL:
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        for fn, (restype, argtypes) in signatures.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _loaded[name] = lib
    return lib


_f32p, _i32p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
_u8p, _i16p = ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_int16)
_u16p, _i64p = ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_int64)


def rasterizer() -> ctypes.CDLL:
    """The mesh rasterizer, built first if needed."""
    return _load("rasterizer", {"render_mesh_frames": (None, [
        _f32p, ctypes.c_int, ctypes.c_int, _i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, _f32p, ctypes.c_float, _u8p, ctypes.c_float, _u8p,
        ctypes.c_int])})


def jpeg_coder() -> ctypes.CDLL:
    """The JPEG entropy coder, built first if needed."""
    return _load("jpeg", {
        "jpeg_encode_scans": (ctypes.c_void_p, [
            _i16p, ctypes.c_int, ctypes.c_int, ctypes.c_int, _i32p, _i32p, _i32p, _u16p, _u8p,
            ctypes.c_int]),
        "jpeg_scans_sizes": (None, [ctypes.c_void_p, _i64p]),
        "jpeg_scans_copy": (None, [ctypes.c_void_p, _u8p]),
        "jpeg_scans_free": (None, [ctypes.c_void_p]),
    })


def host_threads() -> int:
    """Worker threads of the host coders: one core left for the caller."""
    return max(1, (os.cpu_count() or 2) - 1)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctype)


def render_mesh_frames(vertices, faces, width: int, height: int, *,
                       xmag: float = 1.0, ymag: float = 1.0,
                       light_dir=(0.0, 0.5, 0.866), light_intensity: float = 4.0,
                       color=(220, 220, 220), ambient: float = 0.25,
                       n_threads: Optional[int] = None) -> np.ndarray:
    """vertices (n, V, 3) float32 camera-space -> (n, h, w, 3) uint8 RGB frames."""
    lib = rasterizer()
    vertices = np.ascontiguousarray(vertices, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    n, v, _ = vertices.shape
    if faces.size and (faces.min() < 0 or faces.max() >= v):
        raise ValueError(f"face indices outside [0, {v})")
    out = np.empty((n, height, width, 3), np.uint8)
    ld = np.ascontiguousarray(light_dir, np.float32)
    col = np.ascontiguousarray(color, np.uint8)
    lib.render_mesh_frames(
        _ptr(vertices, _f32p), n, v, _ptr(faces, _i32p), faces.shape[0], width, height,
        ctypes.c_float(xmag), ctypes.c_float(ymag), _ptr(ld, _f32p),
        ctypes.c_float(light_intensity), _ptr(col, _u8p), ctypes.c_float(ambient),
        _ptr(out, _u8p), n_threads or host_threads())
    return out


def encode_scans(coefs: np.ndarray, block_comp, block_dc, block_ac, codes: np.ndarray,
                 sizes: np.ndarray, n_threads: Optional[int] = None) -> list:
    """Huffman-code quantized blocks into one scan per frame.

    coefs (n, n_mcus, blocks_per_mcu, 64) int16 in zigzag order; block_comp / block_dc /
    block_ac: each MCU position's component, DC table and AC table; codes / sizes (4, 256):
    the Huffman code and length of every symbol of each table. Returns n ``bytes``."""
    lib = jpeg_coder()
    coefs = np.ascontiguousarray(coefs, np.int16)
    n, n_mcus, per_mcu, _ = coefs.shape
    meta = [np.ascontiguousarray(x, np.int32) for x in (block_comp, block_dc, block_ac)]
    if any(m.shape != (per_mcu,) for m in meta):
        raise ValueError("one component and table per block of an MCU")
    codes = np.ascontiguousarray(codes, np.uint16)
    sizes = np.ascontiguousarray(sizes, np.uint8)
    handle = lib.jpeg_encode_scans(_ptr(coefs, _i16p), n, n_mcus, per_mcu,
                                   *(_ptr(m, _i32p) for m in meta), _ptr(codes, _u16p),
                                   _ptr(sizes, _u8p), n_threads or host_threads())
    try:
        lengths = np.empty(n, np.int64)
        lib.jpeg_scans_sizes(handle, _ptr(lengths, _i64p))
        flat = np.empty(int(lengths.sum()), np.uint8)
        lib.jpeg_scans_copy(handle, _ptr(flat, _u8p))
    finally:
        lib.jpeg_scans_free(handle)
    ends = np.cumsum(lengths)
    return [flat[e - k:e].tobytes() for e, k in zip(ends, lengths)]


__all__ = ["BUILD_DIR", "GXX_FLAGS", "build", "encode_scans", "host_threads", "jpeg_coder",
           "library_path", "rasterizer", "render_mesh_frames"]
