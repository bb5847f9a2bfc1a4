"""LSTM recurrences over whole sequences: the CUDA kernel ``csrc/lstm_sequence.cu``, its
plain PyTorch versions, its launch plan, and the wrappers that pick between them by
device.

Counterpart of ``pantomatrix_tpu/ops/lstm_pallas.py`` (kernel ``_lstm_seq_kernel``).
Every function starts from h = c = 0 and uses torch's gate order i, f, g, o.

- :func:`lstm_direction` runs one direction: ``x_proj`` (T, B, 4H) =
  ``x @ W_ih^T + (b_ih + b_hh)`` and ``w_hh`` (4H, H) give every hidden state (T, B, H).
- :func:`lstm_bidirectional` runs both directions of a layer in one launch: ``x_proj``
  (T, B, 8H) holds the forward projection in columns [0, 4H) and the reverse one in
  [4H, 8H), both of the unflipped sequence; ``w_hh`` is (2, 4H, H). It returns
  (T, B, 2H), forward states in [0, H) and reverse states in [H, 2H): exactly
  ``cat([fwd, rev.flip(0)], -1)``, with no flip or concatenation materialised.

Each sends CPU tensors to its plain version and CUDA tensors to the kernel; on a CUDA
tensor it launches the kernel or raises. For training, :class:`LstmLayerFunction` is
``lstm_bidirectional`` under autograd: its forward is the same one launch, and its
backward recomputes the layer through the plain version and returns that version's
vector-Jacobian product for ``x_proj`` and ``w_hh`` (the JAX package's
``_lstm_direction_pallas_bwd``: no backward kernel exists there either). On a CUDA
tensor that needs a gradient ``lstm_bidirectional`` goes through it; on CPU tensors the
plain version runs under ordinary autograd. The kernel is a cooperative launch that needs
all of its CTAs co-resident, one per SM (:func:`plan_layer`), so it wants the whole
card: where that fails (a card shared under MPS, say) the launch raises. ``launches``
counts the kernel's executions on the device, one per layer call, so a run can show
that it went through the kernel; a launch recorded into a CUDA graph adds to
``captured`` instead (see ``ops/vq_cuda.py``). ``forward_flops`` adds up, beside
``launches``, the recurrent products of the executed launches (:func:`layer_flops`),
which ``torch.utils.flop_counter.FlopCounterMode`` cannot see in a ctypes launch.

The kernel computes each step's gate product ``h_{t-1} . W_hh^T`` in one of two ways,
which :func:`plan_layer` picks by shape (``LayerPlan.product``; no flag or setting):

- ``"mma"``: on the tensor cores, in split TF32: each float32 operand is split into
  TF32 halves, x = hi + lo with |x - hi - lo| <= 2^-22 |x| (``ops/vq_cuda.split_tf32``),
  and ``W_hi.h_lo + W_lo.h_hi + W_hi.h_hi`` accumulates in fp32. That is float32-class:
  ``chip_smoke.py`` phase 7 holds the kernel to at most twice the plain fp32 version's
  error against a float64 run, + 1e-6, which a single TF32 pass would not meet.
  :func:`lstm_bidirectional_split_plain` is this arithmetic in plain PyTorch, a model
  for the tests and ``chip_smoke.py`` that the port's path never calls. Taken where
  W_hh's slice is resident, the CTA has 16 units (64 gate rows) and its tile has at
  least ``MMA_MIN_TILE_ROWS`` = 16 batch rows, two of the mma's N, and H % 64 == 0
  (the h tile then arrives by two TMA copies a step, each half of H in whole 32-float
  segments, rather than by cp.async): CaMN/DisCo's layers at B >= 32 (H = 512, both
  directions), the training forward and ``cli.bench_train`` at B = 64.
- ``"ffma"``: on the fp32 pipe, everywhere else: B = 1 to 16 at H = 512 (evaluation,
  serving, CaMN/DisCo at batch 8), where the per-step hand-off sets the pace and a 4-row
  tile would fill half of the mma, and the non-resident plans (H = 1024 in both
  directions).

``mma_launches`` counts, within ``launches``, the executions whose plan took the
tensor-core product (8 in a CaMN forward at B = 64, 0 at B = 8).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import build
from .vq_cuda import split_tf32

launches = 0
captured = 0  # launches recorded into CUDA graphs, not executed
forward_flops = 0  # layer_flops of every launch counted in ``launches``
mma_launches = 0  # launches counted in ``launches`` that took the tensor-core product

THREADS = 256  # threads per CTA (csrc/lstm_sequence.cu)
WARPS = THREADS // 32
TILE_ROWS = (4, 8, 16, 32)  # batch rows per tile the kernel takes
MAX_K_SPLIT = 32  # lanes of one warp that share a register tile's sums
MMA_UNITS = 16  # units per CTA of the tensor-core product: 64 gate rows, 4 mma M tiles
# the tile rows from which it is taken: 8-row tiles were faster, but (20, 16, 512) (an
# 8-row tile) missed chip_smoke.py phase 7's atol 1e-5 against the plain version (PERF.md)
MMA_MIN_TILE_ROWS = 16
# lstm_layer's C signature: xp, w, out, counters; T, B, H, D, U, BT, BR, resident, mma;
# stream
LAYER_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]

_fn = None


class LayerPlan(NamedTuple):
    """How one layer call is cut over the card's SMs (see ``csrc/lstm_sequence.cu``)."""
    units: int          # U: hidden units per CTA, all 4 gates of each
    tile_rows: int      # BT: batch rows per tile of the gate product
    rows: int           # BR: batch rows per CTA, in ceil(BR / BT) tiles a step
    unit_groups: int    # ceil(H / U)
    batch_groups: int   # ceil(B / BR)
    directions: int     # D
    resident: bool      # W_hh's slice held in shared memory for the whole sequence
    smem_bytes: int
    product: str = "ffma"  # the gate product: "mma" (split TF32) or "ffma" (fp32 FMA)

    @property
    def ctas(self) -> int:
        return self.unit_groups * self.batch_groups * self.directions


def layer_flops(t: int, b: int, hidden: int, directions: int = 2) -> int:
    """The recurrent products of one layer call at (T, B, H): each direction takes T
    steps of h (B, H) @ W_hh^T (H, 4H), 2·B·4H·H FLOPs each, as ``FlopCounterMode`` counts
    the plain version's products."""
    return directions * t * 2 * b * 4 * hidden * hidden


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def smem_bytes(hidden: int, units: int, tile_rows: int, rows: int, resident: bool,
               product: str = "ffma") -> int:
    """Shared memory of one CTA: the swizzled W slice (if resident) and h tile, each row
    padded to a multiple of 32 floats (for the tensor-core product, at least the 8 warps'
    partial sums of the tile, which reuse the h tile's room), the tile's gate products,
    the double-buffered xp tile, the cell state and, for the tensor-core product, the
    two mbarriers of its TMA copies and the room to start on a 1024-byte boundary.
    Mirrors ``smem_bytes`` in the CUDA source."""
    hc = _cdiv(_cdiv(hidden, 4), 8) * 8  # float4 chunks per row, a multiple of 8
    r = 4 * units
    h_region = tile_rows * hc
    if product == "mma":
        h_region = max(h_region, WARPS * tile_rows * units)
    return 16 * ((r * hc if resident else 0) + h_region) + \
        4 * (3 * tile_rows * r + rows * units) + (1024 if product == "mma" else 0)


def mma_fits(hidden: int, units: int, tile_rows: int, rows: int, resident: bool,
             smem_per_block: int) -> bool:
    """Whether the kernel has a tensor-core variant for this cut and its shared memory
    fits: a resident W slice, ``MMA_UNITS`` units, tiles of 8, 16 or 32 rows, and H a
    multiple of 64, so that each half of H is whole 32-float segments for its TMA
    copies."""
    return resident and units == MMA_UNITS and tile_rows in (8, 16, 32) and \
        hidden % 64 == 0 and \
        smem_bytes(hidden, units, tile_rows, rows, resident, "mma") <= smem_per_block


def k_split(units: int, tile_rows: int) -> int:
    """Threads that share one register tile (the 4 gates of 2 units where the tile has 32
    rows, else of 1, for 8 rows, or 4 where the tile has 4), each taking every
    k_split-th chunk of k; 0 where the 256 threads do not divide evenly."""
    tile_units = 2 if tile_rows >= 32 else 1
    if units % tile_units:
        return 0
    tiles = units // tile_units * (tile_rows // (8 if tile_rows >= 8 else 4))
    return THREADS // tiles if THREADS % tiles == 0 else 0


@functools.lru_cache(maxsize=None)
def plan_layer(T: int, B: int, H: int, D: int, num_sms: int,
               smem_per_block: int) -> LayerPlan:
    """Choose units per CTA U and batch rows per CTA BR for a (T, B, H) layer of D
    directions, such that every (direction, batch row, unit) has one owner CTA, the
    CTAs fit one per SM, and shared memory stays within ``smem_per_block``. Among those,
    the per-CTA gate product BR x 4U x H is the smallest; ties go to a resident W slice,
    then to fewer floats read from L2 per CTA and step (h, and W if not resident), fewer
    tiles and fewer CTAs. The gate product is then the tensor cores' where the tile has
    at least ``MMA_MIN_TILE_ROWS`` rows and :func:`mma_fits`, else FFMA (see the module
    docstring). Raises ValueError where no plan fits. (T does not change the plan; it is
    taken for the record.)"""
    if min(T, B, H) < 1 or D not in (1, 2):
        raise ValueError(f"no LSTM layer plan for T={T}, B={B}, H={H}, D={D}")
    best, best_key = None, None
    max_units = 1 << max(0, (H - 1).bit_length())  # the power of two >= H
    for resident in (True, False):
        units = 1
        while units <= max_units:
            nj = _cdiv(H, units)
            max_groups = min(B, num_sms // (D * nj)) if D * nj <= num_sms else 0
            seen = set()
            for groups in range(1, max_groups + 1):
                rows = _cdiv(B, groups)
                if rows in seen:
                    continue
                seen.add(rows)
                nbg = _cdiv(B, rows)
                for tile in TILE_ROWS:
                    if not 1 <= k_split(units, tile) <= MAX_K_SPLIT or \
                            (tile > 4 and tile // 2 >= rows):
                        continue  # threads do not divide, or a smaller tile holds the rows
                    smem = smem_bytes(H, units, tile, rows, resident)
                    if smem > smem_per_block:
                        continue
                    l2_floats = rows * H + (0 if resident else 4 * units * H)
                    key = (rows * 4 * units * H, not resident, l2_floats, _cdiv(rows, tile),
                           nj * nbg * D)
                    if best_key is None or key < best_key:
                        best_key = key
                        best = LayerPlan(units, tile, rows, nj, nbg, D, resident, smem)
            units *= 2
    if best is None:
        raise ValueError(f"the LSTM kernel has no plan for B={B}, H={H}, D={D} on "
                         f"{num_sms} SMs with {smem_per_block} bytes of shared memory")
    if best.tile_rows >= MMA_MIN_TILE_ROWS and mma_fits(H, best.units, best.tile_rows,
                                                        best.rows, best.resident,
                                                        smem_per_block):
        best = best._replace(product="mma", smem_bytes=smem_bytes(
            H, best.units, best.tile_rows, best.rows, best.resident, "mma"))
    return best


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


def lstm_bidirectional_plain(x_proj: torch.Tensor, w_hh: torch.Tensor,
                             hidden: int) -> torch.Tensor:
    """Both directions in plain PyTorch: the reverse one runs on the flipped sequence and
    is flipped back. (T, B, 8H), (2, 4H, H) -> (T, B, 2H)."""
    return _both_directions(lstm_direction_plain, x_proj, w_hh, hidden)


def _both_directions(direction, x_proj, w_hh, hidden):
    four_h = 4 * hidden
    fwd = direction(x_proj[..., :four_h], w_hh[0], hidden)
    rev = direction(x_proj[..., four_h:].flip(0), w_hh[1], hidden).flip(0)
    return torch.cat([fwd, rev], dim=-1)


def lstm_direction_split_plain(x_proj: torch.Tensor, w_hh: torch.Tensor,
                               hidden: int) -> torch.Tensor:
    """The kernel's tensor-core arithmetic in plain PyTorch, one step at a time: the gate
    product as fp32 products of TF32 halves, h_hi.W_lo + h_lo.W_hi + h_hi.W_hi
    (:func:`~pantomatrix_tpu_torch.ops.vq_cuda.split_tf32`), the rest as
    :func:`lstm_direction_plain`. A model for the tests and ``chip_smoke.py``; the port's
    path never calls it. (T, B, 4H) float32 -> (T, B, H)."""
    w_hi, w_lo = (part.T for part in split_tf32(w_hh))
    h = x_proj.new_zeros(x_proj.shape[1], hidden)
    c = torch.zeros_like(h)
    hs = []
    for xp in x_proj:
        h_hi, h_lo = split_tf32(h)
        i, f, g, o = (xp + (h_hi @ w_lo + h_lo @ w_hi + h_hi @ w_hi)).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs)


def lstm_bidirectional_split_plain(x_proj: torch.Tensor, w_hh: torch.Tensor,
                                   hidden: int) -> torch.Tensor:
    """Both directions of :func:`lstm_direction_split_plain`, as
    :func:`lstm_bidirectional_plain` lays them out. (T, B, 8H), (2, 4H, H) -> (T, B, 2H)."""
    return _both_directions(lstm_direction_split_plain, x_proj, w_hh, hidden)


def _kernel():
    global _fn
    if _fn is None:
        lib = build.load("lstm_sequence")
        fn = lib.lstm_layer
        fn.argtypes = LAYER_ARGTYPES
        fn.restype = ctypes.c_int
        lib.lstm_device_limits.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        lib.lstm_device_limits.restype = ctypes.c_int
        lib.lstm_error_string.argtypes = [ctypes.c_int]
        lib.lstm_error_string.restype = ctypes.c_char_p
        _fn = fn
    return _fn


def _raise(err: int, what: str):
    msg = build.load("lstm_sequence").lstm_error_string(err).decode()
    raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


@functools.lru_cache(maxsize=None)
def device_limits(index: int):
    """(SM count, opt-in shared memory per block) of CUDA device ``index``."""
    _kernel()
    lib = build.load("lstm_sequence")
    sms, smem = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(index):
        err = lib.lstm_device_limits(ctypes.byref(sms), ctypes.byref(smem))
    if err != 0:
        _raise(err, "lstm_device_limits")
    return sms.value, smem.value


def _check(x_proj, w_hh, hidden, d):
    if x_proj.dtype != torch.float32 or w_hh.dtype != torch.float32:
        raise TypeError(f"the LSTM kernel takes float32, got {x_proj.dtype} and {w_hh.dtype}")
    w_shape = (4 * hidden, hidden) if d == 1 else (d, 4 * hidden, hidden)
    if x_proj.dim() != 3 or x_proj.shape[2] != d * 4 * hidden or tuple(w_hh.shape) != w_shape:
        raise ValueError(f"shapes do not match hidden={hidden}: x_proj {tuple(x_proj.shape)}, "
                         f"w_hh {tuple(w_hh.shape)} (want (T, B, {d * 4}H) and {w_shape})")
    if x_proj.device.type == "cpu" and w_hh.device.type == "cpu":
        return False
    if x_proj.device.type != "cuda" or w_hh.device != x_proj.device:
        raise ValueError(f"x_proj and w_hh must share one CUDA device or both be on the "
                         f"CPU, got {x_proj.device} and {w_hh.device}")
    return True


def _launch(x_proj: torch.Tensor, w_hh: torch.Tensor, hidden: int, d: int) -> torch.Tensor:
    """One kernel launch over a layer of ``d`` directions (inputs already checked)."""
    global launches, captured, forward_flops, mma_launches
    if not (x_proj.is_contiguous() and w_hh.is_contiguous()):
        raise ValueError("the LSTM kernel takes contiguous x_proj and w_hh")
    t, b, _ = x_proj.shape
    out = torch.empty((t, b, d * hidden), dtype=torch.float32, device=x_proj.device)
    if t == 0 or b == 0:
        return out
    fn = _kernel()
    index = x_proj.device.index if x_proj.device.index is not None else \
        torch.cuda.current_device()
    plan = plan_layer(t, b, hidden, d, *device_limits(index))
    counters = torch.zeros(d * plan.batch_groups, dtype=torch.int32, device=x_proj.device)
    with torch.cuda.device(x_proj.device):  # the launch goes to the current device
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x_proj.data_ptr(), w_hh.data_ptr(), out.data_ptr(), counters.data_ptr(),
                 t, b, hidden, d, plan.units, plan.tile_rows, plan.rows, int(plan.resident),
                 int(plan.product == "mma"), stream)
    if err != 0:
        _raise(err, f"lstm_layer launch ({plan})")
    if torch.cuda.is_current_stream_capturing():
        captured += 1
    else:
        launches += 1
        mma_launches += int(plan.product == "mma")
        forward_flops += layer_flops(t, b, hidden, d)
    return out


def lstm_direction(x_proj: torch.Tensor, w_hh: torch.Tensor, hidden: int) -> torch.Tensor:
    """x_proj (T, B, 4H) float32, w_hh (4H, H) float32 -> (T, B, H) hidden states.

    CPU tensors take the plain version; CUDA tensors launch the kernel (one direction) on
    the current stream (x_proj must be contiguous; w_hh is made contiguous here)."""
    if not _check(x_proj, w_hh, hidden, 1):
        return lstm_direction_plain(x_proj, w_hh, hidden)
    return _launch(x_proj, w_hh.contiguous(), hidden, 1)


def _bidirectional_checked(x_proj: torch.Tensor, w_hh: torch.Tensor, hidden: int) -> bool:
    on_card = _check(x_proj, w_hh, hidden, 2)
    if not (x_proj.is_contiguous() and w_hh.is_contiguous()):
        raise ValueError("lstm_bidirectional takes contiguous x_proj and w_hh")
    return on_card


class LstmLayerFunction(torch.autograd.Function):
    """``lstm_bidirectional`` with a gradient: ``apply(x_proj, w_hh, hidden)``. The
    forward launches the kernel once on CUDA tensors (the plain version, in any dtype, on
    CPU tensors, which lets the CPU tests check this function); the backward recomputes
    the layer through ``lstm_bidirectional_plain`` and differentiates that."""

    @staticmethod
    def forward(ctx, x_proj, w_hh, hidden):
        ctx.save_for_backward(x_proj, w_hh)
        ctx.hidden = hidden
        if x_proj.device.type == "cpu" and w_hh.device.type == "cpu":
            return lstm_bidirectional_plain(x_proj, w_hh, hidden)
        _bidirectional_checked(x_proj, w_hh, hidden)
        return _launch(x_proj, w_hh, hidden, 2)

    @staticmethod
    def backward(ctx, grad_out):
        x_proj, w_hh = ctx.saved_tensors
        with torch.enable_grad():
            xp = x_proj.detach().requires_grad_(ctx.needs_input_grad[0])
            w = w_hh.detach().requires_grad_(ctx.needs_input_grad[1])
            out = lstm_bidirectional_plain(xp, w, ctx.hidden)
            wanted = [t for t in (xp, w) if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, grad_out))
        return (next(grads) if xp.requires_grad else None,
                next(grads) if w.requires_grad else None, None)


def lstm_bidirectional(x_proj: torch.Tensor, w_hh: torch.Tensor, hidden: int) -> torch.Tensor:
    """x_proj (T, B, 8H) float32, w_hh (2, 4H, H) float32 -> (T, B, 2H), forward then
    reverse hidden states (see the module docstring). Both must be contiguous. CPU
    tensors take the plain version; CUDA tensors launch the kernel once, both directions
    together, on the current stream, through :class:`LstmLayerFunction` where a gradient
    is wanted."""
    if not _bidirectional_checked(x_proj, w_hh, hidden):
        return lstm_bidirectional_plain(x_proj, w_hh, hidden)
    if torch.is_grad_enabled() and (x_proj.requires_grad or w_hh.requires_grad):
        return LstmLayerFunction.apply(x_proj, w_hh, hidden)
    return _launch(x_proj, w_hh, hidden, 2)


__all__ = ["LayerPlan", "LstmLayerFunction", "captured", "forward_flops", "launches",
           "layer_flops", "lstm_bidirectional", "lstm_bidirectional_plain",
           "lstm_bidirectional_split_plain", "lstm_direction", "lstm_direction_plain",
           "lstm_direction_split_plain", "mma_fits", "mma_launches", "plan_layer",
           "smem_bytes", "k_split"]
