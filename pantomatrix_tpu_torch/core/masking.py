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


def _runs(mask: Sequence[bool]):
    """The mask's runs of kept joints, as (first, end) pairs."""
    runs, start = [], None
    for i, keep in enumerate(list(mask) + [False]):
        if keep and start is None:
            start = i
        elif not keep and start is not None:
            runs.append((start, i))
            start = None
    return runs


def recover_from_mask(selected_motion: torch.Tensor, mask: Sequence[bool]) -> torch.Tensor:
    """Scatter per-joint channels (..., sum(mask)*c) back into the full (..., len(mask)*c)
    layout, zeros at the joints the mask leaves out. Writes one slice per run of kept
    joints: an index list would be copied from the host on every call, which a CUDA
    graph capture (``models/emage_graph.py``) does not allow."""
    n_kept = sum(1 for keep in mask if keep)
    c = selected_motion.shape[-1] // n_kept
    lead = selected_motion.shape[:-1]
    out = selected_motion.new_zeros(lead + (len(mask) * c,))
    src = 0
    for first, end in _runs(mask):
        width = (end - first) * c
        out[..., first * c:end * c] = selected_motion[..., src:src + width]
        src += width
    return out


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
