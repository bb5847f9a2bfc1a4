"""Plain reference of CaMN's training step: the objective of PantoMatrix's
``train_camn_audio.py`` (lines 91-116) on ``reference/camn.Camn``'s layers, its gradient
by autograd, and Adam written out from its formula.

The step: the targets' axis-angles become rot6d (the first two rows of each rotation
matrix); the WavEncoder runs with train-mode BatchNorm (the biased batch statistics
normalise; the running statistics move by momentum 0.1 towards the batch mean and the
unbiased batch variance); the seed slots of the LSTMs' input hold the targets' first
``seed_frames`` frames with their flag; the body and hands LSTMs are the plain recurrence
of ``reference/layers.LSTM``; the loss is the mean geodesic distance between the
predicted and the target rotations.

Departures from the published objective (each is also the program's):
- no dropout: the recipe's ``dropout_prob`` is 0.1, but the reference cannot draw the
  program's masks, so the traffic mix runs both at 0;
- the geodesic's cosine is clamped to [-1 + 1e-6, 1 - 1e-6] (the published clamps to
  [-1, 1], where arccos's gradient is infinite);
- the speaker is speaker 0 for every row (``speaker_dims`` is 1).

Everything is float32 and runs under ``layers.exact_fp32`` (TF32 off) unless a lower
precision is set on the module tree (``set_step_numerics``: the control, whose products
read float8 operands in the forward and hand float8 gradients on in the backward).
Nothing here imports the program.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .camn import Camn
from .layers import Quantized, axis_angle_to_matrix, round_fp8, rot6d_to_matrix

BN_MOMENTUM = 0.1
BN_EPS = 1e-5
GEODESIC_EPS = 1e-6


class _Fp8Gradient(torch.autograd.Function):
    """Identity in the forward; the gradient rounded to per-tensor scaled float8 (e4m3)
    in the backward."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return round_fp8(grad).detach()


def round_fp8_step(x: torch.Tensor) -> torch.Tensor:
    """A product's operand as a float8 training step reads it: its value rounded to
    float8 (``layers.round_fp8``), and the gradient that reaches it rounded to float8
    too, so that the backward's products read float8 operands as well."""
    return round_fp8(_Fp8Gradient.apply(x))


def set_step_numerics(module: nn.Module) -> nn.Module:
    """Every product operand under ``module`` in float8, forward and backward."""
    for m in module.modules():
        if isinstance(m, Quantized):
            m.q = round_fp8_step
    return module


def rot6d(axis_angle: torch.Tensor) -> torch.Tensor:
    """(B, T, J*3) axis-angles -> (B, T, J*6): each rotation matrix's first two rows."""
    b, t, jc = axis_angle.shape
    m = axis_angle_to_matrix(axis_angle.reshape(b, t, jc // 3, 3))
    return m[..., :2, :].reshape(b, t, -1)


def geodesic(pred6d: torch.Tensor, target6d: torch.Tensor) -> torch.Tensor:
    """Mean over frames and joints of arccos((tr(R_pred R_target^T) - 1) / 2)."""
    b, t, d = target6d.shape
    m1 = rot6d_to_matrix(pred6d.reshape(b, t, d // 6, 6))
    m2 = rot6d_to_matrix(target6d.reshape(b, t, d // 6, 6))
    m = m1 @ m2.transpose(-1, -2)
    cos = (m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2] - 1.0) / 2.0
    return torch.arccos(cos.clamp(-1.0 + GEODESIC_EPS, 1.0 - GEODESIC_EPS)).mean()


def batch_norm(bn, x: torch.Tensor, stats: dict, name: str) -> torch.Tensor:
    """Train-mode BatchNorm over dim 1 of (B, C, L); ``stats[name]`` gets the running
    mean and variance after this batch (the module's own are left as they are)."""
    mean = x.mean((0, 2))
    var = (x - mean[None, :, None]).square().mean((0, 2))
    scale = torch.rsqrt(var + BN_EPS) * bn.weight
    y = (x - mean[None, :, None]) * scale[None, :, None] + bn.bias[None, :, None]
    n = x.numel() // x.shape[1]
    m = BN_MOMENTUM
    with torch.no_grad():
        stats[name] = ((1 - m) * bn.running_mean + m * mean,
                       (1 - m) * bn.running_var + m * var * (n / (n - 1)))
    return y


def _block(block, x, stats: dict, prefix: str) -> torch.Tensor:
    """``layers.BasicBlock.forward`` with train-mode BatchNorm."""
    y = F.leaky_relu(batch_norm(block.bn1, block.conv1(x), stats, prefix + "bn1"), 0.01)
    y = batch_norm(block.bn2, block.conv2(y), stats, prefix + "bn2")
    if block.downsample is None:
        short = x
    else:
        conv, bn = block.downsample
        short = batch_norm(bn, conv(x), stats, prefix + "downsample.1")
    return F.leaky_relu(y + short, 0.01)


def forward(ref: Camn, audio: torch.Tensor, speaker_id: torch.Tensor,
            target6d: torch.Tensor):
    """The train-mode forward: (rot6d motion (B, T, 258), {BatchNorm name: (running
    mean, running variance) after the batch})."""
    cfg, h = ref.cfg, ref.cfg["hidden_size"]
    stats: dict = {}
    x = audio.unsqueeze(1)
    for i, block in enumerate(ref.audio_encoder.feat_extractor):
        x = _block(block, x, stats, f"audio_encoder.feat_extractor.{i}.")
    feat = x.transpose(1, 2)
    bs, t, _ = feat.shape
    spk = ref.speaker_embedding(speaker_id).expand(bs, t, cfg["speaker_f"])
    n = cfg["seed_frames"]
    seed = feat.new_zeros(bs, t, cfg["pose_dims"] + 1)
    seed[:, :n, :-1] = target6d[:, :n]
    seed[:, :n, -1] = 1.0
    x = torch.cat((feat, spk, seed), 2)
    body = ref.body_motion_decoder(x)
    body = ref.body_out(body[..., :h] + body[..., h:])
    hands = ref.hands_motion_decoder(torch.cat((x, body), 2))
    hands = ref.hands_out(hands[..., :h] + hands[..., h:])
    motion = torch.cat((body.reshape(bs, t, -1, 6), hands.reshape(bs, t, -1, 6)), 2)
    return motion.reshape(bs, t, -1), stats


def loss_and_gradient(ref: Camn, audio, speaker_id, motion_axis_angle):
    """(loss, {parameter name: gradient}, {BatchNorm name: (running mean, variance)})
    of one step at ``ref``'s parameters and running statistics."""
    params = dict(ref.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    target = rot6d(motion_axis_angle)
    pred, stats = forward(ref, audio, speaker_id, target)
    loss = geodesic(pred, target)
    grads = torch.autograd.grad(loss, list(params.values()))
    for p in params.values():
        p.requires_grad_(False)
    return loss.detach(), dict(zip(params, grads)), stats


def loss_at(ref: Camn, audio, speaker_id, motion_axis_angle) -> torch.Tensor:
    """The step's loss at ``ref``'s parameters (train-mode BatchNorm reads only the
    batch's statistics), without its gradient."""
    with torch.no_grad():
        target = rot6d(motion_axis_angle)
        return geodesic(forward(ref, audio, speaker_id, target)[0], target)


def adam(param, grad, exp_avg, exp_avg_sq, steps: int, lr: float, beta1: float,
         beta2: float, eps: float):
    """Adam's update number ``steps + 1`` (Kingma and Ba, Algorithm 1):
    (parameter, first moment, second moment) after it."""
    t = steps + 1
    m = beta1 * exp_avg + (1 - beta1) * grad
    v = beta2 * exp_avg_sq + (1 - beta2) * grad * grad
    m_hat = m / (1 - beta1 ** t)
    v_hat = v / (1 - beta2 ** t)
    return param - lr * m_hat / (v_hat.sqrt() + eps), m, v


class Trainer:
    """The reference's step as a program (the check's control runs it with its products
    in a lower precision): the gradient, plain Adam, the running statistics written
    back. ``grad``, ``exp_avg``, ``exp_avg_sq`` and ``steps`` are its state, by name."""

    def __init__(self, ref: Camn, lr: float, beta1: float, beta2: float, eps: float):
        self.ref, self.hyper = ref, (lr, beta1, beta2, eps)
        self.params = dict(ref.named_parameters())
        self.grad: dict = {}
        self.exp_avg = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.exp_avg_sq = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.steps = 0

    def step(self, audio, speaker_id, motion_axis_angle) -> torch.Tensor:
        loss, self.grad, stats = loss_and_gradient(self.ref, audio, speaker_id,
                                                   motion_axis_angle)
        modules = dict(self.ref.named_modules())
        with torch.no_grad():
            for n, p in self.params.items():
                new, self.exp_avg[n], self.exp_avg_sq[n] = adam(
                    p, self.grad[n], self.exp_avg[n], self.exp_avg_sq[n], self.steps,
                    *self.hyper)
                p.copy_(new)
            for name, (mean, var) in stats.items():
                bn = modules[name]
                bn.running_mean.copy_(mean)
                bn.running_var.copy_(var)
                bn.num_batches_tracked.add_(1)
        self.steps += 1
        return loss
