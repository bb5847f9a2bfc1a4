"""What a measurement records about the card it ran on."""
from __future__ import annotations

import subprocess


def card_line() -> str:
    """The first card's name and power limit, as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints them (e.g. "NVIDIA H100 80GB HBM3, 700.00 W"). A card
    may be set below its maximum power and then runs slower under load, so every time
    kept beside it says which limit it ran under."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


__all__ = ["card_line"]
