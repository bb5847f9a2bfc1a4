"""VQ nearest-code search: the CUDA kernel ``csrc/vq_nearest_code.cu``, its plain
PyTorch version, and the wrapper that picks between them by device.

Counterpart of ``pantomatrix_tpu/ops/vq_pallas.py`` (kernel ``_vq_argmin_kernel``).
Both compute, per row of z, ``argmin_k(||e_k||^2 - 2 z.e_k)`` as int32 with ties to
the lowest k; ``||z||^2`` is dropped because it cannot change a row's argmin.

:func:`nearest_code` sends a CPU tensor to :func:`nearest_code_plain` and a CUDA
tensor to the kernel; on a CUDA tensor it launches the kernel or raises. ``launches``
counts kernel launches, so a run can show that it went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

launches = 0

_fn = None


def nearest_code_plain(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """The kernel's formula in plain PyTorch: z (..., D), codebook (K, D) -> (...,) int32."""
    flat = z.reshape(-1, z.shape[-1])
    dist = (codebook * codebook).sum(dim=1) - 2.0 * (flat @ codebook.T)
    return dist.argmin(dim=1).to(torch.int32).reshape(z.shape[:-1])


def _kernel():
    global _fn
    if _fn is None:
        lib = build.load("vq_nearest_code")
        fn = lib.vq_nearest_code
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.vq_error_string.argtypes = [ctypes.c_int]
        lib.vq_error_string.restype = ctypes.c_char_p
        _fn = fn
    return _fn


def nearest_code(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """z (..., D) float32, codebook (K, D) float32 -> (...,) int32 nearest indices.

    CPU tensors take the plain version; CUDA tensors launch the kernel on the current
    stream. Leading dims of z are flattened for the kernel."""
    global launches
    if z.dtype != torch.float32 or codebook.dtype != torch.float32:
        raise TypeError(f"nearest_code takes float32, got {z.dtype} and {codebook.dtype}")
    if codebook.dim() != 2 or z.dim() < 1 or z.shape[-1] != codebook.shape[1]:
        raise ValueError(f"shapes do not match: z {tuple(z.shape)}, "
                         f"codebook {tuple(codebook.shape)} (want (..., D) and (K, D))")
    if codebook.shape[0] == 0 or codebook.shape[1] == 0:
        raise ValueError(f"empty codebook {tuple(codebook.shape)}")
    if z.device.type == "cpu" and codebook.device.type == "cpu":
        return nearest_code_plain(z, codebook)
    if z.device.type != "cuda" or codebook.device != z.device:
        raise ValueError(f"z and codebook must share one CUDA device or both be on the "
                         f"CPU, got {z.device} and {codebook.device}")
    if not (z.is_contiguous() and codebook.is_contiguous()):
        raise ValueError("nearest_code's kernel takes contiguous tensors")
    k, d = codebook.shape
    n = z.numel() // d
    if n >= 2**31:
        raise ValueError(f"{n} rows exceed the kernel's int32 row count")
    out = torch.empty(z.shape[:-1], dtype=torch.int32, device=z.device)
    fn = _kernel()
    with torch.cuda.device(z.device):  # the launch goes to the current device
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(z.data_ptr(), codebook.data_ptr(), out.data_ptr(), n, d, k, stream)
    if err != 0:
        msg = build.load("vq_nearest_code").vq_error_string(err).decode()
        raise RuntimeError(f"vq_nearest_code launch failed: CUDA error {err} ({msg})")
    launches += 1
    return out


__all__ = ["launches", "nearest_code", "nearest_code_plain"]
