"""The yardstick's peaks and the work formulas that rooflines divide by.

Peak rule: every roofline share and MFU divides by the dense peak of the cell's
precision on one NVIDIA H100 SXM (the data sheet, 700 W): bfloat16 989.4 TFLOP/s;
float32 cells TF32 494.7 TFLOP/s, the highest rate at which a float32-accurate
implementation could run (split-TF32 products reach float32 accuracy on the TF32 tensor
cores); HBM 3.35 TB/s. Operations and bytes are counted from the cell's shapes here,
never from what the program launches.
"""
from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989.4e12, "float32": 494.7e12}
PEAK_BYTES_PER_S = 3.35e12
ELEMENT_BYTES = {"bfloat16": 2, "float32": 4}


def peak_flops(precision: str) -> float:
    return PEAK_FLOPS[precision]


def lstm_layer_flops(t: int, b: int, h: int, directions: int = 2) -> float:
    """Multiply-adds of one bidirectional LSTM layer's recurrence, counted as 2 FLOPs:
    each step and direction multiplies (B, H) states by the (H, 4H) recurrent weights."""
    return 2.0 * t * b * 4 * h * h * directions


def lstm_layer_bytes(t: int, b: int, h: int, element_bytes: int, directions: int = 2) -> float:
    """Bytes a layer's recurrence must move at least once: the input projections
    (T, B, 4H a direction) and the recurrent weights in, the states (T, B, H a direction)
    out."""
    x_proj = t * b * 4 * h * directions
    w_hh = 4 * h * h * directions
    out = t * b * h * directions
    return float(x_proj + w_hh + out) * element_bytes


def roofline_seconds(flops: float, nbytes: float, precision: str) -> float:
    """The least time the card could take: the larger of the compute and memory bounds."""
    return max(flops / peak_flops(precision), nbytes / PEAK_BYTES_PER_S)
