"""Plain PyTorch layers of the benchmark's frozen reference.

Written from the published PantoMatrix models (torch ``nn.Conv1d``, ``nn.Linear``,
``nn.LSTM``, post-norm ``nn.Transformer*Layer`` with ReLU), with the parameter names of
their ``state_dict``s, so one set of weights loads into the reference and into the
program under test. Everything here is float32 unless a :class:`Numerics` other than the
exact one is set on a module tree (the lower-precision control of the benchmark's
correctness check): then the inputs and weights of every matrix product and convolution
are rounded to that precision, and the products accumulate in float32.

Nothing here imports the program: the reference is the yardstick that the program is
judged against.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn


# ---------------------------------------------------------------------------
# numerics: exact float32, or a lower precision for the control
# ---------------------------------------------------------------------------

def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _straight_through(x: torch.Tensor, rounded: torch.Tensor) -> torch.Tensor:
    """``rounded``'s values with ``x``'s gradient: a product reads its operands rounded,
    and the backward pass (run on these values) keeps its own float32 gradients, which a
    cast's backward would round to the narrow type unscaled and flush to zero."""
    return x + (rounded - x).detach()


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor scaled float8 (e4m3) round trip: x's values as an fp8 GEMM reads them."""
    xd = x.detach()
    scale = 448.0 / xd.abs().amax().float().clamp_min(1e-12)
    rounded = ((xd.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(x.dtype)
    return _straight_through(x, rounded)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    return _straight_through(x, x.detach().to(torch.bfloat16).to(x.dtype))


ROUNDERS = {"float32": _identity, "bfloat16": round_bf16, "float8_e4m3": round_fp8}


class Quantized:
    """Mixin: ``self.q`` rounds a product's operands (identity by default)."""

    q: Callable[[torch.Tensor], torch.Tensor] = staticmethod(_identity)


def set_numerics(module: nn.Module, precision: str) -> nn.Module:
    """Round every product operand under ``module`` to ``precision`` (a key of
    ``ROUNDERS``); ``"float32"`` is the exact reference."""
    q = ROUNDERS[precision]
    for m in module.modules():
        if isinstance(m, Quantized):
            m.q = q
    return module


@contextlib.contextmanager
def exact_fp32():
    """Float32 products: TF32 and reduced-precision reductions off, restored after."""
    mm = torch.backends.cuda.matmul
    prev = (mm.allow_tf32, torch.backends.cudnn.allow_tf32,
            mm.allow_bf16_reduced_precision_reduction,
            mm.allow_fp16_reduced_precision_reduction)
    mm.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mm.allow_bf16_reduced_precision_reduction = False
    mm.allow_fp16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (mm.allow_tf32, torch.backends.cudnn.allow_tf32,
         mm.allow_bf16_reduced_precision_reduction,
         mm.allow_fp16_reduced_precision_reduction) = prev


# ---------------------------------------------------------------------------
# parameter-holding layers; ``init`` says how the benchmark draws each tensor
# ---------------------------------------------------------------------------

def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape), requires_grad=False)


def he_init(fan_in: int) -> dict:
    """Weights U(+-sqrt(6 / fan_in)), which keep an activation's scale through a layer,
    so that a deep random stack still answers to its input (torch's default bound,
    1 / sqrt(fan_in), shrinks a signal about 1.7 times a layer, and the outputs of a
    random EMAGE or CaMN then hardly depend on the audio); biases U(+-1 / sqrt(fan_in)),
    torch's default."""
    return {"weight": ("uniform", math.sqrt(6.0 / fan_in)),
            "bias": ("uniform", 1.0 / math.sqrt(fan_in))}


class Linear(Quantized, nn.Module):
    def __init__(self, d_in: int, d_out: int, bias: bool = True):
        super().__init__()
        self.weight = _param(d_out, d_in)
        self.bias = _param(d_out) if bias else None
        self.init = he_init(d_in)

    def forward(self, x):
        return F.linear(self.q(x), self.q(self.weight), self.bias)


class Conv1d(Quantized, nn.Module):
    """Channels-first (B, C, L), as torch's."""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int = 1, padding: int = 0):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = _param(c_out, c_in, k)
        self.bias = _param(c_out)
        self.init = he_init(c_in * k)

    def forward(self, x):
        return F.conv1d(self.q(x), self.q(self.weight), self.bias, self.stride, self.padding)


class BatchNorm1d(nn.Module):
    """Eval-mode BatchNorm over dim 1, on running statistics."""

    def __init__(self, c: int):
        super().__init__()
        self.weight, self.bias = _param(c), _param(c)
        self.register_buffer("running_mean", torch.empty(c))
        self.register_buffer("running_var", torch.empty(c))
        self.register_buffer("num_batches_tracked", torch.empty((), dtype=torch.long))
        self.init = {"weight": ("const", 1.0), "bias": ("const", 0.0),
                     "running_mean": ("const", 0.0), "running_var": ("const", 1.0),
                     "num_batches_tracked": ("const", 0)}

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, 1e-5)


class LayerNorm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight, self.bias = _param(c), _param(c)
        self.init = {"weight": ("const", 1.0), "bias": ("const", 0.0)}

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias, 1e-5)


class Embedding(nn.Module):
    def __init__(self, n: int, d: int):
        super().__init__()
        self.weight = _param(n, d)
        self.init = {"weight": ("normal", 1.0)}

    def forward(self, ids):
        return F.embedding(ids, self.weight)


class MLP(nn.Module):
    def __init__(self, d_in: int, d_mid: int, d_out: int):
        super().__init__()
        self.fc1, self.fc2 = Linear(d_in, d_mid), Linear(d_mid, d_out)

    def forward(self, x):
        return self.fc2(F.leaky_relu(self.fc1(x), 0.1))


# ---------------------------------------------------------------------------
# audio encoder (the reference's WavEncoder of BasicBlocks)
# ---------------------------------------------------------------------------

class BasicBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, k: int, stride: int, first_dilation: int):
        super().__init__()
        self.conv1 = Conv1d(c_in, c_out, k, stride, first_dilation)
        self.bn1 = BatchNorm1d(c_out)
        self.conv2 = Conv1d(c_out, c_out, k, 1, k // 2)
        self.bn2 = BatchNorm1d(c_out)
        self.downsample = None
        if stride != 1 or c_in != c_out:
            self.downsample = nn.Sequential(Conv1d(c_in, c_out, k, stride, first_dilation),
                                            BatchNorm1d(c_out))

    def forward(self, x):
        y = F.leaky_relu(self.bn1(self.conv1(x)), 0.01)
        y = self.bn2(self.conv2(y))
        short = x if self.downsample is None else self.downsample(x)
        return F.leaky_relu(y + short, 0.01)


class WavEncoder(nn.Module):
    """(B, samples) -> (B, frames, channels). ``emage``: total stride 540, widths
    out_dim / 4, / 2, out_dim (EMAGE); ``camn``: total stride 1080, widths 32-128 (CaMN,
    DisCo)."""

    def __init__(self, out_dim: int, variant: str):
        super().__init__()
        if variant == "emage":
            a, b, c = out_dim // 4, out_dim // 2, out_dim
            plan = [(1, a, 5, 1600), (a, a, 6, 0), (a, a, 1, 7), (a, b, 6, 0), (b, b, 1, 7),
                    (b, c, 3, 0)]
        else:
            plan = [(1, 32, 5, 1600), (32, 32, 6, 0), (32, 32, 1, 7), (32, 64, 6, 0),
                    (64, 64, 1, 7), (64, 128, 6, 0)]
        self.feat_extractor = nn.Sequential(*[BasicBlock(i, o, 15, s, d) for i, o, s, d in plan])

    def forward(self, wav):
        return self.feat_extractor(wav.unsqueeze(1)).transpose(1, 2)


# ---------------------------------------------------------------------------
# conv VQ-VAE encoder / decoder (channels-last in, channels-last out)
# ---------------------------------------------------------------------------

class ResBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.model = nn.Sequential(Conv1d(c, c, 3, 1, 1), nn.LeakyReLU(0.2),
                                   Conv1d(c, c, 3, 1, 1))

    def forward(self, x):
        return self.model(x) + x


class VQEncoder(nn.Module):
    def __init__(self, d_in: int, c: int, n_layers: int):
        super().__init__()
        layers = [Conv1d(d_in, c, 3, 1, 1), nn.LeakyReLU(0.2), ResBlock(c)]
        for _ in range(1, n_layers):
            layers += [Conv1d(c, c, 3, 1, 1), nn.LeakyReLU(0.2), ResBlock(c)]
        self.main = nn.Sequential(*layers)

    def forward(self, x):
        return self.main(x.transpose(1, 2)).transpose(1, 2)


class VQDecoder(nn.Module):
    def __init__(self, d_out: int, c: int, n_layers: int):
        super().__init__()
        chans = [c] * n_layers + [d_out]
        layers = [ResBlock(c), ResBlock(c)]
        for i in range(n_layers):
            layers += [Conv1d(chans[i], chans[i + 1], 3, 1, 1), nn.LeakyReLU(0.2)]
        layers.append(Conv1d(d_out, d_out, 3, 1, 1))
        self.main = nn.Sequential(*layers)

    def forward(self, x):
        return self.main(x.transpose(1, 2)).transpose(1, 2)


# ---------------------------------------------------------------------------
# post-norm transformer layers (torch's nn.Transformer*Layer, ReLU, batch-first here)
# ---------------------------------------------------------------------------

class MultiheadAttention(Quantized, nn.Module):
    def __init__(self, e: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = _param(3 * e, e)
        self.in_proj_bias = _param(3 * e)
        self.out_proj = Linear(e, e)
        self.out_proj.init = {"weight": ("uniform", 1.0 / math.sqrt(e)), "bias": ("const", 0.0)}
        self.init = {"in_proj_weight": ("uniform", math.sqrt(6.0 / (4 * e))),
                     "in_proj_bias": ("const", 0.0)}

    def forward(self, query, memory):
        b, tq, e = query.shape
        h, dh = self.heads, e // self.heads
        w = self.q(self.in_proj_weight)
        wq, wk, wv = w.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        split = lambda x: x.reshape(b, -1, h, dh).transpose(1, 2)
        qh = split(F.linear(self.q(query), wq, bq))
        kh = split(F.linear(self.q(memory), wk, bk))
        vh = split(F.linear(self.q(memory), wv, bv))
        att = torch.softmax(self.q(qh) @ self.q(kh).transpose(-1, -2) / math.sqrt(dh), dim=-1)
        out = self.q(att) @ self.q(vh)
        return self.out_proj(out.transpose(1, 2).reshape(b, tq, e))


class EncoderLayer(nn.Module):
    def __init__(self, e: int, ff: int, heads: int):
        super().__init__()
        self.self_attn = MultiheadAttention(e, heads)
        self.linear1, self.linear2 = Linear(e, ff), Linear(ff, e)
        self.norm1, self.norm2 = LayerNorm(e), LayerNorm(e)

    def forward(self, x):
        x = self.norm1(x + self.self_attn(x, x))
        return self.norm2(x + self.linear2(F.relu(self.linear1(x))))


class DecoderLayer(nn.Module):
    def __init__(self, e: int, ff: int, heads: int):
        super().__init__()
        self.self_attn = MultiheadAttention(e, heads)
        self.multihead_attn = MultiheadAttention(e, heads)
        self.linear1, self.linear2 = Linear(e, ff), Linear(ff, e)
        self.norm1, self.norm2, self.norm3 = LayerNorm(e), LayerNorm(e), LayerNorm(e)

    def forward(self, x, memory):
        x = self.norm1(x + self.self_attn(x, x))
        x = self.norm2(x + self.multihead_attn(x, memory))
        return self.norm3(x + self.linear2(F.relu(self.linear1(x))))


class Stack(nn.Module):
    """``layers.{i}``, as torch's nn.TransformerEncoder / nn.TransformerDecoder (no
    final norm)."""

    def __init__(self, layer, n: int, e: int, heads: int = 4):
        super().__init__()
        self.layers = nn.ModuleList([layer(e, 2 * e, heads) for _ in range(n)])

    def forward(self, x, memory=None):
        for layer in self.layers:
            x = layer(x) if memory is None else layer(x, memory)
        return x


# ---------------------------------------------------------------------------
# bidirectional LSTM as a plain recurrence (torch's gate order i, f, g, o)
# ---------------------------------------------------------------------------

class LSTM(Quantized, nn.Module):
    """(B, T, C) -> (B, T, 2H): the forward states, then the backward ones. One matrix
    product a step for both directions together; every product is a plain matmul, so
    ``FlopCounterMode`` counts the recurrence."""

    SFX = ("", "_reverse")

    def __init__(self, d_in: int, hidden: int, layers: int):
        super().__init__()
        self.hidden, self.layers = hidden, layers
        b = 1.0 / math.sqrt(hidden)
        self.init = {}
        for k in range(layers):
            c = d_in if k == 0 else 2 * hidden
            for s in self.SFX:
                for name, shape in ((f"weight_ih_l{k}{s}", (4 * hidden, c)),
                                    (f"weight_hh_l{k}{s}", (4 * hidden, hidden)),
                                    (f"bias_ih_l{k}{s}", (4 * hidden,)),
                                    (f"bias_hh_l{k}{s}", (4 * hidden,))):
                    setattr(self, name, _param(*shape))
                    self.init[name] = ("uniform", b)

    def forward(self, x):
        bsz, t, _ = x.shape
        hdim = self.hidden
        y = x
        for k in range(self.layers):
            p = lambda n: [getattr(self, f"{n}_l{k}{s}") for s in self.SFX]
            w_ih = torch.stack(p("weight_ih"))                              # (2, 4H, C)
            bias = (torch.stack(p("bias_ih")) + torch.stack(p("bias_hh")))[:, None, None]
            # (1, B, T, C) @ (2, 1, C, 4H) -> (2, B, T, 4H)
            xp = torch.matmul(self.q(y)[None], self.q(w_ih).transpose(1, 2)[:, None]) + bias
            w_hh = self.q(torch.stack(p("weight_hh"))).transpose(1, 2)     # (2, H, 4H)
            h = x.new_zeros(2, bsz, hdim)
            c = x.new_zeros(2, bsz, hdim)
            out = x.new_empty(2, bsz, t, hdim)
            for step in range(t):
                rev = t - 1 - step
                xs = torch.stack((xp[0, :, step], xp[1, :, rev]))          # (2, B, 4H)
                gates = xs + torch.bmm(self.q(h), w_hh)
                i, f, g, o = gates.chunk(4, dim=-1)
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                h = torch.sigmoid(o) * torch.tanh(c)
                out[0, :, step] = h[0]
                out[1, :, rev] = h[1]
            y = torch.cat((out[0], out[1]), dim=-1)
        return y


# ---------------------------------------------------------------------------
# rotations (PyTorch3D's formulas) and the joint-mask scatter
# ---------------------------------------------------------------------------

def rot6d_to_matrix(d6):
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = F.normalize(a1, dim=-1)
    b2 = F.normalize(a2 - (b1 * a2).sum(-1, keepdim=True) * b1, dim=-1)
    return torch.stack((b1, b2, torch.cross(b1, b2, dim=-1)), dim=-2)


def matrix_to_axis_angle(m):
    """Rotation matrix -> quaternion (w >= 0) -> axis-angle."""
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    sq = lambda v: torch.sqrt(torch.clamp(v, min=0.0))
    w = 0.5 * sq(1 + m00 + m11 + m22)
    sign = lambda a, b: torch.where((a < 0) != (b < 0), -a, a)
    xyz = torch.stack((sign(0.5 * sq(1 + m00 - m11 - m22), m[..., 2, 1] - m[..., 1, 2]),
                       sign(0.5 * sq(1 - m00 + m11 - m22), m[..., 0, 2] - m[..., 2, 0]),
                       sign(0.5 * sq(1 - m00 - m11 + m22), m[..., 1, 0] - m[..., 0, 1])), -1)
    norm = xyz.norm(dim=-1, keepdim=True)
    half = torch.atan2(norm, w[..., None])
    angle = 2 * half
    small = angle.abs() < 1e-6
    safe = torch.where(small, torch.ones_like(angle), angle)
    s = torch.where(small, 0.5 - angle ** 2 / 48, torch.sin(half) / safe)
    return xyz / s


def rot6d_to_axis_angle(d6):
    return matrix_to_axis_angle(rot6d_to_matrix(d6))


def axis_angle_to_matrix(aa):
    """Rodrigues' formula."""
    theta = aa.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    k = aa / theta
    zero = torch.zeros_like(k[..., 0])
    kx, ky, kz = k[..., 0], k[..., 1], k[..., 2]
    kmat = torch.stack((zero, -kz, ky, kz, zero, -kx, -ky, kx, zero), -1).reshape(
        aa.shape[:-1] + (3, 3))
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    st, ct = torch.sin(theta)[..., None], torch.cos(theta)[..., None]
    return eye + st * kmat + (1 - ct) * (kmat @ kmat)


def recover_from_mask(sel, mask):
    """(..., kept*c) -> (..., len(mask)*c), zeros at the joints the mask drops."""
    keep = torch.tensor(mask, dtype=torch.bool, device=sel.device)
    n = int(keep.sum())
    c = sel.shape[-1] // n
    out = sel.new_zeros(sel.shape[:-1] + (len(mask), c))
    out[..., keep, :] = sel.reshape(sel.shape[:-1] + (n, c))
    return out.reshape(sel.shape[:-1] + (len(mask) * c,))
