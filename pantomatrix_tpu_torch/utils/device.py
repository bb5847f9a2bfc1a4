"""What a measurement records about the card it ran on."""
from __future__ import annotations

import subprocess

# dense bf16 tensor-core peak, TFLOP/s, by a substring of torch.cuda.get_device_name
# (NVIDIA's H100 SXM data sheet; the SXM part names itself "H100 80GB HBM3")
PEAK_BF16_TFLOPS = {"H100 80GB HBM3": 989.4, "H100 SXM": 989.4}


def card_line() -> str:
    """The first card's name and power limit, as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints them (e.g. "NVIDIA H100 80GB HBM3, 700.00 W"). A card
    may be set below its maximum power and then runs slower under load, so every time
    kept beside it says which limit it ran under."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def peak_bf16_tflops(device_name: str) -> float:
    """The dense bf16 peak of the card named ``device_name``; raises for a card not in
    ``PEAK_BF16_TFLOPS``."""
    for key, peak in PEAK_BF16_TFLOPS.items():
        if key in device_name:
            return peak
    raise ValueError(f"no dense bf16 peak known for {device_name!r}; add it to "
                     "PEAK_BF16_TFLOPS")


__all__ = ["PEAK_BF16_TFLOPS", "card_line", "peak_bf16_tflops"]
