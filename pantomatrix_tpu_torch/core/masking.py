"""Joint masks over the 55 SMPL-X joints, the selection by a mask and the scatter
back to the full layout (counterpart of ``pantomatrix_tpu/core/masking.py``)."""
from __future__ import annotations

from typing import Sequence

import torch

# local_upper: 43 joints (upper body and both hands), the CaMN/DisCo output joints;
# local_full: every joint but the root
MASK_DICT = {
    "local_upper": [
        False, False, False, True, False, False, True, False, False, True,
        False, False, True, True, True, True, True, True, True, True,
        True, True, False, False, False, True, True, True, True, True,
        True, True, True, True, True, True, True, True, True, True,
        True, True, True, True, True, True, True, True, True, True,
        True, True, True, True, True,
    ],
    "local_full": [False] + [True] * 54,
}

# EMAGE body-part masks
JOINT_MASK_UPPER = [
    False, False, False, True, False, False, True, False, False, True,
    False, False, True, True, True, True, True, True, True, True,
    True, True, False, False, False, False, False, False, False, False,
    False, False, False, False, False, False, False, False, False, False,
    False, False, False, False, False, False, False, False, False, False,
    False, False, False, False, False,
]
JOINT_MASK_LOWER = [
    True, True, True, False, True, True, False, True, True, False,
    True, True, False, False, False, False, False, False, False, False,
    False, False, False, False, False, False, False, False, False, False,
    False, False, False, False, False, False, False, False, False, False,
    False, False, False, False, False, False, False, False, False, False,
    False, False, False, False, False,
]
JOINT_MASK_HANDS = [False] * 25 + [True] * 30


def select_with_mask(motion: torch.Tensor, mask: Sequence[bool]) -> torch.Tensor:
    """Keep the per-joint channel groups the mask selects: (..., len(mask)*c) ->
    (..., sum(mask)*c)."""
    idx = [i for i, keep in enumerate(mask) if keep]
    c = motion.shape[-1] // len(mask)
    lead = motion.shape[:-1]
    return motion.reshape(lead + (len(mask), c))[..., idx, :].reshape(lead + (len(idx) * c,))


def recover_from_mask(selected_motion: torch.Tensor, mask: Sequence[bool]) -> torch.Tensor:
    """Scatter per-joint channels (..., sum(mask)*c) back into the full (..., len(mask)*c)
    layout, zeros at the joints the mask leaves out."""
    idx = [i for i, keep in enumerate(mask) if keep]
    c = selected_motion.shape[-1] // len(idx)
    lead = selected_motion.shape[:-1]
    out = selected_motion.new_zeros(lead + (len(mask), c))
    out[..., idx, :] = selected_motion.reshape(lead + (len(idx), c))
    return out.reshape(lead + (len(mask) * c,))


# the reference's tensor-variant name
recover_from_mask_ts = recover_from_mask

__all__ = [
    "MASK_DICT",
    "JOINT_MASK_HANDS",
    "JOINT_MASK_LOWER",
    "JOINT_MASK_UPPER",
    "recover_from_mask",
    "recover_from_mask_ts",
    "select_with_mask",
]
