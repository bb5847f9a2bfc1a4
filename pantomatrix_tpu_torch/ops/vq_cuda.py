"""VQ nearest-code search: the CUDA kernel ``csrc/vq_nearest_code.cu``, its plain
PyTorch version, its launch plan, and the wrapper that picks between them by device.

Counterpart of ``pantomatrix_tpu/ops/vq_pallas.py`` (kernel ``_vq_argmin_kernel``).
Both compute, per row of z, ``argmin_k(||e_k||^2 - 2 z.e_k)`` as int32 with ties to
the lowest k; ``||z||^2`` is dropped because it cannot change a row's argmin.

:func:`nearest_code` sends a CPU tensor to :func:`nearest_code_plain` and a CUDA
tensor to the kernel; on a CUDA tensor it launches the kernel or raises. The kernel
computes the products on the tensor cores in split TF32 (:func:`split_tf32`;
:func:`nearest_code_split_plain` is its arithmetic in plain PyTorch, for the tests) and
splits the codes of one 64-row tile across a thread-block cluster (:func:`plan_search`);
where the cluster cannot be placed, the launch raises. ``launches`` counts the kernel's
executions on the device, one per search, so a run can show that it went through the
kernel: a launch recorded into a CUDA graph adds to ``captured`` instead, and whoever
replays the graph adds its captured launches to ``launches`` per replay
(``models/emage_graph.py``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from . import build

launches = 0
captured = 0  # launches recorded into CUDA graphs, not executed

ROWS_PER_CTA = 64  # one wgmma M (csrc/vq_nearest_code.cu)
CLUSTER_SIZES = (1, 2, 4, 8)  # CTAs that split one row tile's codes (portable cluster sizes)
CODE_TILES = (32, 64, 128, 256)  # codes per tile the kernel takes (half per warpgroup)
THREADS = 256  # two warpgroups
SMEM_PER_BLOCK = 232448  # an H100 block's opt-in shared memory, bytes
# a CTA's fixed time in units of the time per code it owns: from device times per
# launch at N = 512 over S = 1..8 (scripts/torch_k1_sweep.py, H100, PERF.md)
CTA_FIXED_CODES = 340
_BD = 32  # depths per chunk

_fn = None


class SearchPlan(NamedTuple):
    """How one search is cut over the card (see ``csrc/vq_nearest_code.cu``)."""
    rows_per_cta: int    # BM
    cluster: int         # S: CTAs, ranks in ascending k, that split one row tile's codes
    codes_per_tile: int  # BN: codes per tile, walked tiles_per_cta times
    tiles_per_cta: int
    stages: int          # depth of the ring of staged chunks
    smem_bytes: int
    row_tiles: int       # ceil(N / BM)

    @property
    def codes_per_cta(self) -> int:
        return self.codes_per_tile * self.tiles_per_cta

    @property
    def ctas(self) -> int:
        return self.row_tiles * self.cluster


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def stages(codes_per_tile: int) -> int:
    """Depth of the ring of staged chunks for a tile width: deeper where the tile is small.
    Mirrors ``stages_for`` in the CUDA source."""
    return 2 if codes_per_tile >= 256 else 3 if codes_per_tile >= 128 else 4


def smem_bytes(codes_per_tile: int) -> int:
    """Dynamic shared memory of one CTA: 1024 bytes of slack to align the tiles, hi and
    lo code copies (two buffers each), the ring of fp32 stages of z and codes, the
    ||e||^2 partials of two tiles, the two warpgroups' per-row candidates and one
    mbarrier per stage. Mirrors ``smem_bytes`` in the CUDA source."""
    bn, st = codes_per_tile, stages(codes_per_tile)
    return 1024 + 4 * (4 * bn * _BD + st * (ROWS_PER_CTA + bn) * _BD + 2 * THREADS
                       + 4 * ROWS_PER_CTA) + 8 * st


@functools.lru_cache(maxsize=None)
def plan_search(n: int, d: int, k: int, num_sms: int) -> SearchPlan:
    """The launch plan of an (n, d) x (k, d) search on a card of ``num_sms`` SMs.

    Rows go in tiles of 64, one per cluster; the cluster's S CTAs split the K codes, each
    owning a range of ``codes_per_tile * tiles_per_cta`` (the smallest tile width that
    holds its share, up to 256, walked in tiles beyond that) and none owning no code.
    S minimises the estimated time ``waves * (CTA_FIXED_CODES + codes_per_cta)``, with
    ``waves = ceil(CTAs / num_sms)``; ties go to the smaller S. A CTA's time is mostly
    fixed (its serial walk over the depth chunks), so splitting the codes pays only where
    the row tiles leave most SMs idle: N = 512 takes S = 8 (64 CTAs), while N >= 4800
    keeps S = 1. (D does not change the plan: depths stream in chunks.) Raises
    ValueError where it cannot plan."""
    if min(n, d, k, num_sms) < 1 or max(n, d, k) >= 2**31:
        raise ValueError(f"no search plan for n={n}, d={d}, k={k} on {num_sms} SMs")
    row_tiles = _cdiv(n, ROWS_PER_CTA)
    best, best_cost = None, None
    for s in CLUSTER_SIZES:
        share = _cdiv(k, s)
        tile = next(t for t in CODE_TILES if t >= min(share, CODE_TILES[-1]))
        tiles = _cdiv(share, tile)
        if (s - 1) * tile * tiles >= k or s * tile * tiles >= 2**31 or \
                row_tiles * s >= 2**31:
            continue  # a rank would own no code, or the counts overflow int32
        smem = smem_bytes(tile)
        if smem > SMEM_PER_BLOCK:
            continue
        plan = SearchPlan(ROWS_PER_CTA, s, tile, tiles, stages(tile), smem, row_tiles)
        cost = _cdiv(plan.ctas, num_sms) * (CTA_FIXED_CODES + plan.codes_per_cta)
        if best_cost is None or cost < best_cost:
            best, best_cost = plan, cost
    if best is None:
        raise ValueError(f"no search plan for n={n}, d={d}, k={k} on {num_sms} SMs")
    return best


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 x -> (hi, lo): hi = x rounded to TF32 (10 mantissa bits, to nearest, ties
    away from zero, as ``cvt.rna.tf32.f32``) and lo = tf32(x - hi), so that
    |x - hi - lo| <= 2^-22 |x| for normal x. Non-finite values pass through as hi."""
    if x.dtype != torch.float32:
        raise TypeError(f"split_tf32 takes float32, got {x.dtype}")

    def rna(v):
        bits = v.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        r = (bits + 0x1000) & ~0x1FFF
        r = torch.where(torch.isfinite(v), r, bits)
        return torch.where(r >= 2**31, r - 2**32, r).to(torch.int32).view(torch.float32)

    hi = rna(x)
    lo = torch.where(torch.isfinite(x), rna(x - hi), torch.zeros_like(x))
    return hi, lo


def nearest_code_plain(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """The kernel's formula in plain PyTorch: z (..., D), codebook (K, D) -> (...,) int32."""
    flat = z.reshape(-1, z.shape[-1])
    dist = (codebook * codebook).sum(dim=1) - 2.0 * (flat @ codebook.T)
    return dist.argmin(dim=1).to(torch.int32).reshape(z.shape[:-1])


def nearest_code_split_plain(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """The kernel's split-TF32 arithmetic in plain PyTorch (fp32 products of TF32
    halves: z_hi.e_lo + z_lo.e_hi + z_hi.e_hi, ||e||^2 in fp32), a model for the tests
    and chip_smoke.py; the port's path never calls it. (..., D), (K, D) -> (...,) int32."""
    flat = z.reshape(-1, z.shape[-1])
    z_hi, z_lo = split_tf32(flat)
    e_hi, e_lo = split_tf32(codebook)
    dot = z_hi @ e_lo.T + z_lo @ e_hi.T + z_hi @ e_hi.T
    dist = (codebook * codebook).sum(dim=1) - 2.0 * dot
    return dist.argmin(dim=1).to(torch.int32).reshape(z.shape[:-1])


def _kernel():
    global _fn
    if _fn is None:
        lib = build.load("vq_nearest_code")
        fn = lib.vq_nearest_code
        # z, cb, out; n, d, k; rows_per_cta, cluster, codes_per_tile, tiles_per_cta,
        # stages, smem_bytes; stream
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.vq_error_string.argtypes = [ctypes.c_int]
        lib.vq_error_string.restype = ctypes.c_char_p
        _fn = fn
    return _fn


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def nearest_code(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """z (..., D) float32, codebook (K, D) float32 -> (...,) int32 nearest indices.

    CPU tensors take the plain version; CUDA tensors launch the kernel on the current
    stream. Leading dims of z are flattened for the kernel."""
    global launches, captured
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
    if n == 0:
        return out
    fn = _kernel()
    current = torch.cuda.current_device()
    index = current if z.device.index is None else z.device.index
    plan = plan_search(n, d, k, _num_sms(index))  # cached per shape
    args = (z.data_ptr(), codebook.data_ptr(), out.data_ptr(), n, d, k, plan.rows_per_cta,
            plan.cluster, plan.codes_per_tile, plan.tiles_per_cta, plan.stages,
            plan.smem_bytes)
    if index == current:
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(index):  # the launch goes to the current device
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = build.load("vq_nearest_code").vq_error_string(err).decode()
        raise RuntimeError(f"vq_nearest_code launch ({plan}) failed: CUDA error {err} ({msg})")
    if torch.cuda.is_current_stream_capturing():
        captured += 1
    else:
        launches += 1
    return out


__all__ = ["CLUSTER_SIZES", "CODE_TILES", "CTA_FIXED_CODES", "ROWS_PER_CTA", "SearchPlan",
           "captured", "launches", "nearest_code", "nearest_code_plain", "nearest_code_split_plain",
           "plan_search", "smem_bytes", "split_tf32", "stages"]
