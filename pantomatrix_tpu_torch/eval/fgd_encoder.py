"""AESKConv, the FGD feature extractor: a skeleton-aware convolutional encoder
(counterpart of ``pantomatrix_tpu/eval/fgd_encoder.py``).

The reference computes FGD through a pretrained skeleton autoencoder shipped as
``AESKConv_240_100.bin`` with its external evaluation tools: the BEAT codebase's
``VAESKConv``, whose ``LocalEncoder`` is built from skeleton-aware convolutions and
pools (Aberman et al. 2020, "Skeleton-Aware Networks for Deep Motion Retargeting") over
the SMPL-X kinematic tree. FGD needs only the encoder.

Architecture: 55-joint SMPL-X kintree -> 54 edges + 1 "global part" = 55 parts x 6 rot6d
channels = 330 input channels; 4 layers of [SkeletonConv(k=3, stride=2, zero-pad 1,
neighbor distance 2) -> SkeletonPool (mean over degree-2 edge chains) -> LeakyReLU(0.2)]
with channel growth [1, 1, 2, 1] from a base of 6 -> 20 parts x 12 channels = the
240-wide latent; time is halved per layer (64 frames -> 4 latent frames).

The topology (edge lists, neighbor masks, pooling matrices) is numpy, computed on the
host (``make_plan``, a copy of the JAX package's). The encoder is an ``nn.Module`` whose
``state_dict`` keys are the weight file's ``encoder.``-less paths
(``layers.{i}.0.{weight,bias}``); its masked conv and pooling product run in float32
under ``strict_fp32()`` on the module's device. ``read_aeskconv`` reads and checks a
weight file on the host; ``AESKConvEmbedder`` builds the encoder on a device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import strict_fp32

# SMPL-X 2020 kinematic-tree parents (55 joints; kintree_table[0] of
# SMPLX_NEUTRAL_2020.npz). Embedded so FGD works without the model archive.
SMPLX_PARENTS: Tuple[int, ...] = (
    -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17,
    18, 19, 15, 15, 15, 20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35,
    20, 37, 38, 21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52, 53,
)


def build_edge_topology(parents: Sequence[int]) -> List[Tuple[int, int]]:
    """(parent, child) bone list — one edge per non-root joint."""
    return [(int(parents[i]), i) for i in range(1, len(parents))]


def calc_edge_mat(edges: Sequence[Tuple[int, int]]) -> np.ndarray:
    """All-pairs edge distance (edges sharing a joint are at distance 1; Floyd)."""
    n = len(edges)
    mat = np.full((n, n), 1_000_000, np.int64)
    np.fill_diagonal(mat, 0)
    for i, a in enumerate(edges):
        for j, b in enumerate(edges):
            if a[0] in b or a[1] in b:
                mat[i, j] = min(mat[i, j], 1)
    for k in range(n):
        mat = np.minimum(mat, mat[:, k : k + 1] + mat[k : k + 1, :])
    return mat


def find_neighbor(edges: Sequence[Tuple[int, int]], d: int) -> List[List[int]]:
    """Per-part neighbor lists within edge distance d, plus the appended "global
    part" (index len(edges)) that is mutually connected with edge 0's neighbors."""
    mat = calc_edge_mat(edges)
    n = len(edges)
    neighbors = [list(np.flatnonzero(mat[i] <= d)) for i in range(n)]
    global_neighbors = list(neighbors[0])
    for i in global_neighbors:
        neighbors[i].append(n)
    global_neighbors.append(n)
    neighbors.append(global_neighbors)
    return neighbors


def pool_edges(edges: Sequence[Tuple[int, int]], last_pool: bool
               ) -> Tuple[List[List[int]], List[Tuple[int, int]]]:
    """SkeletonPool's merge plan: walk degree-2 chains from the root, merge edge
    pairs (mean), keep the global part as its own pool; last_pool collapses each
    chain entirely."""
    edge_num = len(edges) + 1
    degree = np.zeros(max(max(max(e) for e in edges) + 2, 1), np.int64)
    for e in edges:
        degree[e[0]] += 1
        degree[e[1]] += 1

    seq_list: List[List[int]] = []

    def find_seq(j: int, seq: List[int]) -> None:
        if degree[j] > 2 and j != 0:
            seq_list.append(seq)
            seq = []
        if degree[j] == 1:
            seq_list.append(seq)
            return
        for idx, e in enumerate(edges):
            if e[0] == j:
                find_seq(e[1], seq + [idx])

    find_seq(0, [])
    pooling_list: List[List[int]] = []
    new_edges: List[Tuple[int, int]] = []
    for seq in seq_list:
        if last_pool:
            pooling_list.append(seq)
            continue
        if len(seq) % 2 == 1:
            pooling_list.append([seq[0]])
            new_edges.append(edges[seq[0]])
            seq = seq[1:]
        for i in range(0, len(seq), 2):
            pooling_list.append([seq[i], seq[i + 1]])
            new_edges.append((edges[seq[i]][0], edges[seq[i + 1]][1]))
    pooling_list.append([edge_num - 1])  # global part pools to itself
    return pooling_list, new_edges


@dataclass(eq=False)
class _LayerPlan:
    joint_num: int          # parts entering the conv
    in_per_joint: int
    out_per_joint: int
    mask: np.ndarray        # (out_ch, in_ch, k) skeleton-locality weight mask
    pool_weight: np.ndarray  # (pooled_ch, out_ch) mean-pool matrix


@dataclass(eq=False)
class AESKConvPlan:
    layers: List[_LayerPlan]
    in_channels: int
    out_channels: int
    kernel_size: int = 3
    stride: int = 2
    padding: int = 1


# AESKConv_240_100's LocalEncoder: 4 layers over the SMPL-X skeleton, 6 channels per
# part, growing by these factors, convolving over parts 2 edges apart
N_LAYERS, GROW, CHANNEL_BASE, SKELETON_DIST = 4, (1, 1, 2, 1), 6, 2


def make_plan() -> AESKConvPlan:
    """Precompute every topological constant of the LocalEncoder."""
    bases = [CHANNEL_BASE]
    for g in GROW:
        bases.append(bases[-1] * g)
    edges = build_edge_topology(SMPLX_PARENTS)
    layers: List[_LayerPlan] = []
    in_channels = bases[0] * (len(edges) + 1)
    for i in range(N_LAYERS):
        neighbors = find_neighbor(edges, SKELETON_DIST)
        joint_num = len(neighbors)
        cin, cout = bases[i], bases[i + 1]
        mask = np.zeros((cout * joint_num, cin * joint_num, 3), np.float32)
        for p, nb in enumerate(neighbors):
            cols = np.asarray([k * cin + c for k in nb for c in range(cin)])
            mask[p * cout : (p + 1) * cout, cols, :] = 1.0
        pooling_list, new_edges = pool_edges(edges, last_pool=(i == N_LAYERS - 1))
        cpe = cout  # channels per part after the conv
        pool_w = np.zeros((len(pooling_list) * cpe, joint_num * cpe), np.float32)
        for r, pool in enumerate(pooling_list):
            for j in pool:
                for c in range(cpe):
                    pool_w[r * cpe + c, j * cpe + c] = 1.0 / len(pool)
        layers.append(_LayerPlan(joint_num, cin, cout, mask, pool_w))
        edges = new_edges
    return AESKConvPlan(layers, in_channels, layers[-1].pool_weight.shape[0])


class SkeletonConv(nn.Module):
    """A conv1d whose weight is masked to each part's skeleton neighbourhood."""

    def __init__(self, mask: np.ndarray, *, generator: torch.Generator):
        super().__init__()
        out_ch, in_ch, k = mask.shape
        # torch's conv default, U(+-1/sqrt(fan_in)), over the unmasked inputs of a row
        fan_in = max(len(np.flatnonzero(mask[0, :, 0])), 1) * k
        bound = float(1.0 / np.sqrt(fan_in))
        u = lambda *shape: (torch.rand(*shape, generator=generator) * 2 - 1) * bound
        self.register_buffer("mask", torch.from_numpy(mask), persistent=False)
        self.weight = nn.Parameter(u(out_ch, in_ch, k) * self.mask)
        self.bias = nn.Parameter(u(out_ch))


class AESKConv(nn.Module):
    """The LocalEncoder: (bs, t, 330) rot6d -> (bs, t // 2^L, 240) latent frames.
    Keys ``layers.{i}.0.{weight,bias}`` (each SkeletonConv is element 0 of its layer;
    the pool and the activation carry no parameters)."""

    def __init__(self, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.plan = make_plan()
        g = generator or torch.Generator().manual_seed(0)
        self.layers = nn.ModuleList(
            nn.ModuleList([SkeletonConv(layer.mask, generator=g)]) for layer in self.plan.layers)
        for i, layer in enumerate(self.plan.layers):
            self.register_buffer(f"pool_{i}", torch.from_numpy(layer.pool_weight),
                                 persistent=False)

    @torch.no_grad()
    @strict_fp32()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.transpose(1, 2)
        for i, (conv,) in enumerate(self.layers):
            h = F.conv1d(h, conv.weight * conv.mask, conv.bias, stride=self.plan.stride,
                         padding=self.plan.padding)
            h = torch.einsum("pc,bct->bpt", getattr(self, f"pool_{i}"), h)
            h = F.leaky_relu(h, 0.2)
        return h.transpose(1, 2)


class AESKConvEmbedder:
    """FGD feature extractor on ``device``: windows (n, w, 330) -> features
    (n * w // 16, 240), as numpy."""

    def __init__(self, params: Dict, device):
        from ..convert import load_jax_params

        self.encoder = load_jax_params(AESKConv(), params).to(device)
        self.device = torch.device(device)

    def __call__(self, windows: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.asarray(windows, np.float32), device=self.device)
        lat = self.encoder(x).cpu().numpy()
        return lat.reshape(-1, lat.shape[-1])


def params_from_state_dict(state_dict: Dict[str, np.ndarray]) -> Dict:
    """Map a VAESKConv state dict to the encoder's param tree
    ``{"layers": {i: {"0": {"weight", "bias"}}}}`` of numpy arrays. Accepts raw state
    dicts, ``{"model_state": sd}`` wrappers and DDP "module." prefixes; only
    ``encoder.layers.{i}.0.{weight,bias}`` are read (the decoder, fc_mu and fc_logvar
    are ignored). A missing key or a weight of another topology raises."""
    plan = make_plan()
    if "model_state" in state_dict and isinstance(state_dict["model_state"], dict):
        state_dict = state_dict["model_state"]
    clean = {k[len("module."):] if k.startswith("module.") else k: v
             for k, v in state_dict.items()}
    params: Dict = {"layers": {}}
    for i, layer in enumerate(plan.layers):
        w = clean.get(f"encoder.layers.{i}.0.weight")
        b = clean.get(f"encoder.layers.{i}.0.bias")
        if w is None or b is None:
            raise KeyError(
                f"encoder.layers.{i}.0.weight/bias missing from state dict "
                f"(got keys like {sorted(clean)[:4]})"
            )
        w = np.asarray(w, np.float32)
        b = np.asarray(b, np.float32)
        if w.shape != layer.mask.shape:
            raise ValueError(
                f"layer {i} weight shape {w.shape} != expected {layer.mask.shape}: "
                "the checkpoint was trained on a different skeleton topology"
            )
        params["layers"][str(i)] = {"0": {"weight": w, "bias": b}}
    return params


def read_aeskconv(path: str) -> Dict:
    """Read AESKConv_240_100.bin (a torch pickle) on the host into the encoder's param
    tree of numpy arrays, checked against ``make_plan()``."""
    raw = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(raw, dict) and "model_state" in raw:
        raw = raw["model_state"]
    sd = {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v) for k, v in raw.items()}
    return params_from_state_dict(sd)


def load_aeskconv(path: str, device) -> AESKConvEmbedder:
    """Import AESKConv_240_100.bin and build the FGD embedder on ``device``."""
    return AESKConvEmbedder(read_aeskconv(path), device)


__all__ = [
    "AESKConv",
    "AESKConvEmbedder",
    "AESKConvPlan",
    "SMPLX_PARENTS",
    "SkeletonConv",
    "build_edge_topology",
    "find_neighbor",
    "load_aeskconv",
    "make_plan",
    "params_from_state_dict",
    "pool_edges",
    "read_aeskconv",
]
