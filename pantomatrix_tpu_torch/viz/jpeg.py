"""Baseline JPEG encoder: the port's counterpart of ``cv2.imencode(".jpg", frame,
[cv2.IMWRITE_JPEG_QUALITY, q])`` for BGR uint8 frames, without cv2.

The layout is libjpeg's default for a colour image: JFIF YCbCr with 4:2:0 chroma
(libjpeg's fixed-point colour conversion and its 2x2 box downsampling with alternating
rounding bias), the ITU-T T.81 Annex K quantization tables scaled by libjpeg's quality
formula, and the Annex K Huffman tables. Colour conversion, the 8x8 DCT (one matrix
product per block) and the quantization run in PyTorch on the frames' device, batched
over frames and blocks (:func:`quantized_blocks`). The Huffman coding runs on the host
in ``native/jpeg.cpp``, one thread per frame.
"""
from __future__ import annotations

import math
import struct
from functools import lru_cache
from typing import List

import numpy as np
import torch

from ..nn.layers import strict_fp32

# Annex K.1, natural (row-major) order
LUMA_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64)
CHROMA_QUANT = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32, np.int64)

# Annex K.3: (code counts for lengths 1..16, symbols)
DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52,
    0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3,
    0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8,
    0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])
AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33,
    0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18,
    0x19, 0x1A, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7A,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA,
    0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7,
    0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])
HUFFMAN_TABLES = (DC_LUMA, AC_LUMA, DC_CHROMA, AC_CHROMA)

# an MCU of 4:2:0: four Y blocks, then Cb and Cr; their component, DC and AC tables
MCU_COMPONENT = (0, 0, 0, 0, 1, 2)
MCU_DC_TABLE = (0, 0, 0, 0, 2, 2)
MCU_AC_TABLE = (1, 1, 1, 1, 3, 3)


def zigzag_order() -> np.ndarray:
    """Natural index of each zigzag position."""
    order = sorted(((u, v) for u in range(8) for v in range(8)),
                   key=lambda p: (p[0] + p[1], p[0] if (p[0] + p[1]) % 2 else p[1]))
    return np.array([u * 8 + v for u, v in order], np.int64)


ZIGZAG = zigzag_order()


def quant_tables(quality: int = 90):
    """libjpeg's ``jpeg_set_quality``: the Annex K tables scaled by its quality factor,
    clamped to [1, 255] (baseline). Natural order, (luma, chroma)."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    return tuple(np.clip((t * scale + 50) // 100, 1, 255) for t in (LUMA_QUANT, CHROMA_QUANT))


def huffman_codes(bits, vals):
    """Annex C: the canonical code and length of every symbol of one table."""
    codes = np.zeros(256, np.uint16)
    sizes = np.zeros(256, np.uint8)
    code, k = 0, 0
    for length, count in enumerate(bits, start=1):
        for _ in range(count):
            codes[vals[k]], sizes[vals[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return codes, sizes


@lru_cache(maxsize=None)
def _code_tables():
    pairs = [huffman_codes(*t) for t in HUFFMAN_TABLES]
    return np.stack([c for c, _ in pairs]), np.stack([s for _, s in pairs])


@lru_cache(maxsize=8)
def _dct_matrix(device: torch.device) -> torch.Tensor:
    """(64, 64) float32: a block's 64 samples (natural order) times it gives its 2-D DCT-II
    (orthonormal, as T.81 A.3.3) in zigzag order."""
    c = np.array([[(math.sqrt(0.5) if u == 0 else 1.0) * 0.5
                   * math.cos((2 * x + 1) * u * math.pi / 16) for x in range(8)]
                  for u in range(8)])
    return torch.as_tensor(np.kron(c, c)[ZIGZAG].T.copy(), dtype=torch.float32, device=device)


def _fix(x: float) -> int:
    return int(x * 65536 + 0.5)


def bgr_to_ycc(frames: torch.Tensor) -> torch.Tensor:
    """(n, h, w, 3) uint8 BGR -> (n, 3, h, w) int32 Y, Cb, Cr: libjpeg's fixed-point
    conversion (jccolor.c, 16 fraction bits)."""
    b, g, r = (frames[..., i].to(torch.int32) for i in range(3))
    half, off = 1 << 15, 128 << 16
    y = (_fix(0.299) * r + _fix(0.587) * g + _fix(0.114) * b + half) >> 16
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b + off + half - 1) >> 16
    cr = (_fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b + off + half - 1) >> 16
    return torch.stack([y, cb, cr], dim=1)


def downsample_2x2(plane: torch.Tensor) -> torch.Tensor:
    """(n, h, w) int32, h and w even -> (n, h/2, w/2): libjpeg's h2v2 box average with
    the rounding bias alternating 1, 2 along each output row."""
    n, h, w = plane.shape
    s = plane.reshape(n, h // 2, 2, w // 2, 2).sum(dim=(2, 4))
    bias = (torch.arange(w // 2, device=plane.device, dtype=torch.int32) % 2) + 1
    return (s + bias) >> 2


def _pad_to(frames: torch.Tensor, mult: int) -> torch.Tensor:
    """Replicate the last row and column up to a multiple of ``mult`` (an MCU)."""
    n, h, w, _ = frames.shape
    hp, wp = -(-h // mult) * mult, -(-w // mult) * mult
    if (hp, wp) == (h, w):
        return frames
    rows = torch.arange(hp, device=frames.device).clamp(max=h - 1)
    cols = torch.arange(wp, device=frames.device).clamp(max=w - 1)
    return frames[:, rows][:, :, cols]


def _blocks(plane: torch.Tensor, per: int) -> torch.Tensor:
    """(n, h, w) -> (n, mcus, per * per, 64): the plane's 8x8 blocks grouped by MCU
    (``per`` x ``per`` blocks an MCU, row-major inside it), MCUs in raster order."""
    n, h, w = plane.shape
    mr, mc = h // (8 * per), w // (8 * per)
    x = plane.reshape(n, mr, per, 8, mc, per, 8).permute(0, 1, 4, 2, 5, 3, 6)
    return x.reshape(n, mr * mc, per * per, 64)


def quantized_blocks(frames: torch.Tensor, quality: int = 90) -> torch.Tensor:
    """(n, h, w, 3) uint8 BGR on any device -> (n, mcus, 6, 64) int16 quantized DCT
    coefficients in zigzag order, blocks in interleaved 4:2:0 MCU order. The DCT runs in
    float32 without TF32; quantization rounds half away from zero."""
    frames = _pad_to(frames, 16)
    ycc = bgr_to_ycc(frames)
    y = _blocks(ycc[:, 0], 2)
    cb = _blocks(downsample_2x2(ycc[:, 1]), 1)
    cr = _blocks(downsample_2x2(ycc[:, 2]), 1)
    x = torch.cat([y, cb, cr], dim=2).to(torch.float32) - 128.0
    luma, chroma = quant_tables(quality)
    q = torch.as_tensor(np.stack([luma[ZIGZAG]] * 4 + [chroma[ZIGZAG]] * 2),
                        dtype=torch.float32, device=frames.device)
    with strict_fp32():
        coef = (x.reshape(-1, 64) @ _dct_matrix(frames.device)).reshape(x.shape) / q
    return (torch.sign(coef) * torch.floor(coef.abs() + 0.5)).to(torch.int16)


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">HH", marker, len(payload) + 2) + payload


@lru_cache(maxsize=16)
def jpeg_header(height: int, width: int, quality: int = 90) -> bytes:
    """Everything of a frame's file before its scan data: SOI, the JFIF APP0, one DQT per
    table (zigzag order), SOF0, one DHT per table and the SOS, in libjpeg's order."""
    out = [b"\xff\xd8", _segment(0xFFE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for tq, table in enumerate(quant_tables(quality)):
        out.append(_segment(0xFFDB, bytes([tq]) + bytes(table[ZIGZAG].astype(np.uint8))))
    out.append(_segment(0xFFC0, struct.pack(">BHHB", 8, height, width, 3)
                        + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for tc_th, (bits, vals) in zip((0x00, 0x10, 0x01, 0x11), HUFFMAN_TABLES):
        out.append(_segment(0xFFC4, bytes([tc_th]) + bytes(bits) + bytes(vals)))
    out.append(_segment(0xFFDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])))
    return b"".join(out)


def encode_frames(frames, quality: int = 90) -> List[bytes]:
    """(n, h, w, 3) uint8 BGR frames (a tensor, transformed on its device, or a numpy
    array, on the CPU) -> one JPEG file (bytes) per frame."""
    from ..native import encode_scans

    frames = torch.as_tensor(frames)
    if frames.dtype != torch.uint8 or frames.dim() != 4 or frames.shape[-1] != 3:
        raise ValueError(f"want (n, h, w, 3) uint8 BGR, got {tuple(frames.shape)} {frames.dtype}")
    _, h, w, _ = frames.shape
    codes, sizes = _code_tables()
    scans = encode_scans(quantized_blocks(frames, quality).cpu().numpy(), MCU_COMPONENT,
                         MCU_DC_TABLE, MCU_AC_TABLE, codes, sizes)
    head = jpeg_header(h, w, quality)
    return [head + scan + b"\xff\xd9" for scan in scans]


__all__ = ["ZIGZAG", "bgr_to_ycc", "downsample_2x2", "encode_frames", "huffman_codes",
           "jpeg_header", "quant_tables", "quantized_blocks"]
