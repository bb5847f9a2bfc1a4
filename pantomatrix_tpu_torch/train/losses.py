"""Training losses of the three families (counterpart of ``pantomatrix_tpu/train/losses.py``).

- EMAGE: latent MSE and code classification (NLL on log-softmax) per part;
- CaMN and DisCo: the geodesic rotation loss;
- DisCo: the all-pairs contrastive disentanglement loss.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b).square().mean()


def rec_loss(pred: Dict, target: Dict, lu: float, ll: float, lh: float, lf: float) -> torch.Tensor:
    """Weighted latent MSE over the four parts."""
    return (lu * mse(pred["rec_upper"], target["upper"])
            + ll * mse(pred["rec_lower"], target["lower"])
            + lh * mse(pred["rec_hands"], target["hands"])
            + lf * mse(pred["rec_face"], target["face"]))


def nll_loss(log_probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """torch nn.NLLLoss over (bs, t, K) log-probabilities and (bs, t) integer targets."""
    return -log_probs.gather(-1, targets[..., None].long()).mean()


def cls_loss(pred: Dict, target_idx: Dict, cu: float, cl: float, ch: float,
             cf: float) -> torch.Tensor:
    """Weighted NLL of the codebook indices of the four parts."""
    lp = lambda x: F.log_softmax(x, dim=2)
    return (cu * nll_loss(lp(pred["cls_upper"]), target_idx["upper"])
            + cl * nll_loss(lp(pred["cls_lower"]), target_idx["lower"])
            + ch * nll_loss(lp(pred["cls_hands"]), target_idx["hands"])
            + cf * nll_loss(lp(pred["cls_face"]), target_idx["face"]))


def geodesic_loss(m1: torch.Tensor, m2: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Mean geodesic distance between rotation matrices (..., 3, 3):
    arccos((tr(R1 R2^T) - 1) / 2), the cosine clamped to [-1 + eps, 1 - eps]."""
    m = m1 @ m2.transpose(-1, -2)
    cos = (m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2] - 1.0) / 2.0
    return torch.arccos(cos.clamp(-1.0 + eps, 1.0 - eps)).mean()


def contrastive_loss(features: torch.Tensor, labels: torch.Tensor,
                     margin: float = 1.0) -> torch.Tensor:
    """All-pairs contrastive loss over time-mean features (bs, t, c) and (bs, 1) or (bs,)
    integer labels: same-label pairs pull (their distance), other pairs push to
    ``margin``; each term is a mean over the full bs x bs matrix."""
    feats = features.mean(dim=1)
    lbs = labels.reshape(-1)
    sq = (feats[:, None] - feats[None, :]).square().sum(-1)
    dist = torch.sqrt(sq.clamp_min(1e-24))
    pos = (lbs[None, :] == lbs[:, None]).to(feats.dtype)
    return (pos * dist).mean() + ((1.0 - pos) * F.relu(margin - dist)).mean()


def huber_loss(pred: torch.Tensor, target: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    abs_err = (pred - target).abs()
    quad = abs_err.clamp_max(delta)
    return (0.5 * quad ** 2 + delta * (abs_err - quad)).mean()


__all__ = ["cls_loss", "contrastive_loss", "geodesic_loss", "huber_loss", "mse", "nll_loss",
           "rec_loss"]
