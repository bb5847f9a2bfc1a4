"""One LSTM direction over a whole sequence: the CUDA kernel ``csrc/lstm_sequence.cu``,
its plain PyTorch version, and the wrapper that picks between them by device.

Counterpart of ``pantomatrix_tpu/ops/lstm_pallas.py`` (kernel ``_lstm_seq_kernel``).
Both take ``x_proj`` (T, B, 4H) = ``x @ W_ih^T + (b_ih + b_hh)`` and ``w_hh`` (4H, H)
in torch layout, start from h = c = 0, use torch's gate order i, f, g, o, and return
every hidden state (T, B, H).

:func:`lstm_direction` sends a CPU tensor to :func:`lstm_direction_plain` and a CUDA
tensor to the kernel; on a CUDA tensor it launches the kernel or raises. ``launches``
counts wrapper calls that launched the kernel, one per direction, so a run can show
that it went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

launches = 0

_fn = None


def lstm_direction_plain(x_proj: torch.Tensor, w_hh: torch.Tensor, hidden: int) -> torch.Tensor:
    """The recurrence in plain PyTorch, one step at a time: (T, B, 4H) -> (T, B, H)."""
    h = x_proj.new_zeros(x_proj.shape[1], hidden)
    c = torch.zeros_like(h)
    w_hh_t = w_hh.T
    hs = []
    for xp in x_proj:
        i, f, g, o = (xp + h @ w_hh_t).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs)


def _kernel():
    global _fn
    if _fn is None:
        lib = build.load("lstm_sequence")
        fn = lib.lstm_sequence
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.lstm_error_string.argtypes = [ctypes.c_int]
        lib.lstm_error_string.restype = ctypes.c_char_p
        _fn = fn
    return _fn


def lstm_direction(x_proj: torch.Tensor, w_hh: torch.Tensor, hidden: int) -> torch.Tensor:
    """x_proj (T, B, 4H) float32, w_hh (4H, H) float32 -> (T, B, H) hidden states.

    CPU tensors take the plain version; CUDA tensors launch the kernel on the current
    stream (x_proj must be contiguous; W_hh^T is made contiguous here)."""
    global launches
    if x_proj.dtype != torch.float32 or w_hh.dtype != torch.float32:
        raise TypeError(f"lstm_direction takes float32, got {x_proj.dtype} and {w_hh.dtype}")
    if (x_proj.dim() != 3 or x_proj.shape[2] != 4 * hidden
            or tuple(w_hh.shape) != (4 * hidden, hidden)):
        raise ValueError(f"shapes do not match hidden={hidden}: x_proj {tuple(x_proj.shape)}, "
                         f"w_hh {tuple(w_hh.shape)} (want (T, B, 4H) and (4H, H))")
    if x_proj.device.type == "cpu" and w_hh.device.type == "cpu":
        return lstm_direction_plain(x_proj, w_hh, hidden)
    if x_proj.device.type != "cuda" or w_hh.device != x_proj.device:
        raise ValueError(f"x_proj and w_hh must share one CUDA device or both be on the "
                         f"CPU, got {x_proj.device} and {w_hh.device}")
    if not x_proj.is_contiguous():
        raise ValueError("lstm_direction's kernel takes a contiguous x_proj")
    t, b, _ = x_proj.shape
    w_t = w_hh.T.contiguous()  # (H, 4H): neighbouring threads read neighbouring columns
    out = torch.empty((t, b, hidden), dtype=torch.float32, device=x_proj.device)
    c_ws = torch.empty((b, hidden), dtype=torch.float32, device=x_proj.device)
    fn = _kernel()
    with torch.cuda.device(x_proj.device):  # the launches go to the current device
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x_proj.data_ptr(), w_t.data_ptr(), out.data_ptr(), c_ws.data_ptr(),
                 t, b, hidden, stream)
    if err != 0:
        msg = build.load("lstm_sequence").lstm_error_string(err).decode()
        raise RuntimeError(f"lstm_sequence launch failed: CUDA error {err} ({msg})")
    launches += 1
    return out


__all__ = ["launches", "lstm_direction", "lstm_direction_plain"]
