"""Train steps of the three families (counterpart of ``pantomatrix_tpu/train/steps.py``).

Each ``make_*_train_step`` returns ``step(batch, iteration) -> losses``: it puts the model
in train mode, runs the objective, back-propagates and updates the model and the
optimizer in place, and returns the losses as detached 0-d tensors (read them at a log
period: reading syncs the card). ``batch`` holds tensors on the model's device. Where
the JAX package splits its parameter tree into trainable leaves and BatchNorm buffers,
here they are the module's parameters and buffers: BatchNorm updates its running
statistics in place in train mode (``nn/layers.py``). Every step runs under
``strict_fp32`` (no TF32, full-precision reductions), as the port's float32 paths do.

Randomness: each step draws its dropout masks and EMAGE's random mask from generators
seeded by ``(seed, iteration)`` (``nn/layers.DropoutRng``), on the model's device. The
port does not reproduce ``jax.random``'s bits. ``make_multi_step`` (k steps as one TPU
program) is not ported: ``train/loop.py`` runs the steps one by one.

Multi-process (``mesh``, ``train/mesh.py``): ``batch`` holds this process's rows of the
global batch. The step runs inside the mesh's batch-shard scope, so BatchNorm reduces
its statistics over the global batch and every random draw is made at the global shape
(``utils/distributed.py``); DisCo's contrastive terms and the VQ restarts' code counts
and encoder outputs are gathered over the processes; between the backward and the
update the gradients are averaged over the processes (``reduce_gradients``). Each
process's losses are its rows' (the loop averages them at its log period). Without a
process group nothing changes.

``compute_dtype="bfloat16"``: the floating parameters (and the floating buffers other
than BatchNorm's running statistics: the positional-encoding table) are cast inside the
differentiated computation and substituted with ``torch.func.functional_call``, so the
float32 master weights receive float32 gradients. Targets, losses, reductions and the
BatchNorm running statistics stay float32.

Documented reference-bug policy (as in the JAX package):
- grad clip before backward (= no clipping): ``train/optim.py`` ``clip_parity``;
- the EMAGE mask-ratio schedule ``(iter / 135 * 400) * 0.95 + 0.05`` is above 1 from the
  first iteration on (everything masked). ``mask_schedule="reference"`` keeps it;
  ``"corrected"`` uses iter / (135 * 400), capped at 1.

One difference from the JAX EMAGE step, not copied: the JAX package's trainable tree
holds the periodic positional-encoding table (``position_embeddings.pe``), so its
optimizer updates the table. In the reference and here it is a buffer and stays fixed.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.rotations import axis_angle_to_rotation_6d, rotation_6d_to_matrix
from ..models.emage_vq import PARTS, EmageVQSuite, vq_map2index, vq_map2latent, vq_split_inputs
from ..nn.layers import (
    BatchNorm1d,
    DropoutRng,
    dropout_rng,
    frozen_running_stats,
    mix_seed,
    strict_fp32,
)
from ..utils.distributed import all_reduce_sum, batch_shard, gather_rows, rand_rows
from ..utils.precision import compute_dtype_of
from .losses import cls_loss, contrastive_loss, geodesic_loss, rec_loss
from .mesh import Mesh, data_sharding, fsdp_state, reduce_gradients
from .optim import TrainOptimizer

BN_BUFFER_KEYS = ("running_mean", "running_var", "num_batches_tracked")

Step = Callable[[Dict[str, torch.Tensor], int], Dict[str, torch.Tensor]]


def mask_ratio_schedule(iteration: float, mode: str = "reference") -> float:
    """EMAGE's random-mask ratio (the reference's train_emage_audio.py:163)."""
    if mode == "reference":
        return (iteration / 135 * 400) * 0.95 + 0.05
    if mode == "corrected":
        return min(iteration / (135 * 400) * 0.95 + 0.05, 1.0)
    raise ValueError(mode)


def step_seed(seed: int, iteration: int) -> int:
    """The seed of step ``iteration``'s generators."""
    return mix_seed(seed, iteration)


def compute_params(model: nn.Module, dtype: Optional[torch.dtype]) -> Dict[str, torch.Tensor]:
    """The tensors ``torch.func.functional_call`` substitutes in ``model`` under a
    low-precision compute dtype: every floating parameter, and every floating buffer but
    BatchNorm's running statistics, cast to ``dtype`` by differentiable casts. Empty for
    float32, where the model runs as it is."""
    if dtype is None:
        return {}
    out = {n: p.to(dtype) for n, p in model.named_parameters() if p.is_floating_point()}
    out.update({n: b.to(dtype) for n, b in model.named_buffers()
                if b.is_floating_point() and n.rsplit(".", 1)[-1] not in BN_BUFFER_KEYS})
    return out


def sub_params(params: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    """The entries of ``params`` under submodule ``prefix``, relative to it."""
    return {k[len(prefix) + 1:]: v for k, v in params.items() if k.startswith(prefix + ".")}


def call(module: nn.Module, params: Dict[str, torch.Tensor], *args, **kwargs):
    """``module(*args, **kwargs)`` with ``params`` substituted (none: as it is)."""
    if not params:
        return module(*args, **kwargs)
    return torch.func.functional_call(module, params, args, kwargs)


def _cast(dtype: Optional[torch.dtype], x: torch.Tensor) -> torch.Tensor:
    return x if dtype is None else x.to(dtype)


def _rot6d(motion: torch.Tensor) -> torch.Tensor:
    """(bs, t, j*3) axis angles -> (bs, t, j*6) rot6d."""
    bs, t, jc = motion.shape
    return axis_angle_to_rotation_6d(motion.reshape(bs, t, jc // 3, 3)).reshape(bs, t, -1)


def _geodesic(pred6d: torch.Tensor, gt6d: torch.Tensor) -> torch.Tensor:
    bs, t, d = gt6d.shape
    m = lambda x: rotation_6d_to_matrix(x.float().reshape(bs, t, d // 6, 6))
    return geodesic_loss(m(pred6d), m(gt6d))


def _speaker(batch) -> torch.Tensor:
    motion = batch["motion"]
    return torch.zeros((motion.shape[0], 1), dtype=torch.long, device=motion.device)


@contextlib.contextmanager
def _onednn_off():
    prev = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = prev


def _make_step(model: nn.Module, optimizer: TrainOptimizer, loss_fn,
               dtype: Optional[torch.dtype], mesh: Optional[Mesh] = None) -> Step:
    """``loss_fn(batch, iteration) -> (loss, losses)`` as an update step.

    On the CPU in a low-precision dtype oneDNN is off for the step: its bfloat16
    convolution weight gradient comes back non-finite now and then on finite inputs
    (PyTorch 2.13's CPU build; PyTorch's own kernels are used instead).

    ``mesh``: the step runs in its batch-shard scope and averages the gradients over
    the processes before the update; under FSDP it first gathers the parameters."""
    shard = data_sharding(mesh)
    fsdp = fsdp_state(optimizer)
    trainable = [p for p in model.parameters() if p.requires_grad]

    def step(batch: Dict[str, torch.Tensor], iteration: int) -> Dict[str, torch.Tensor]:
        model.train()
        on_cpu = next(model.parameters()).device.type == "cpu"
        no_onednn = _onednn_off() if dtype is not None and on_cpu else contextlib.nullcontext()
        with strict_fp32(), no_onednn, batch_shard(shard):
            if fsdp is not None:
                fsdp.gather()
            loss, losses = loss_fn(batch, iteration)
            optimizer.zero_grad()
            loss.backward()
            reduce_gradients(trainable, mesh)
            optimizer.step()
        return {k: v.detach() for k, v in losses.items()}

    return step


def _amplify_bn_updates(snapshot, k: int) -> None:
    """Turn one same-batch BatchNorm update (from the state in ``snapshot``) into the
    state after ``k`` identical updates: r_k = r_0 + (r_1 - r_0) (1 - (1 - m)^k) / m.
    The reference's three passes run the audio encoders on the same audio, so their
    batch statistics are equal and the three updates collapse to this closed form."""
    with torch.no_grad():
        for bn, (mean0, var0) in snapshot.items():
            m = bn.momentum
            factor = (1.0 - (1.0 - m) ** k) / m
            bn.running_mean.copy_(mean0 + factor * (bn.running_mean - mean0))
            bn.running_var.copy_(var0 + factor * (bn.running_var - var0))
            bn.num_batches_tracked.add_(k - 1)


def make_emage_train_step(model: nn.Module, suite: EmageVQSuite, optimizer: TrainOptimizer,
                          mask_schedule: str = "reference",
                          gradient_checkpointing: bool = False,
                          share_audio_encoder: bool = True,
                          compute_dtype: Optional[str] = None, seed: int = 0,
                          mesh: Optional[Mesh] = None) -> Step:
    """EMAGE's 3-pass masked objective against the frozen tokenizers' targets (the
    reference's train_emage_audio.py:130-183): pass 1 with the seed mask, pass 2 with a
    random mask and audio, pass 3 with the same mask and no audio; latent MSE and code
    classification per pass. Losses: rec_seed, cls_seed, rec_audio, cls_audio, rec_mask,
    cls_mask and their sum, all.

    ``gradient_checkpointing``: each pass runs under ``torch.utils.checkpoint`` (its
    activations are recomputed in the backward pass). The recomputation draws the same
    dropout masks (its generators are seeded inside the checkpointed function) and does
    not update the BatchNorm running statistics again (``frozen_running_stats``).

    ``share_audio_encoder``: run the two WavEncoders once per step instead of once per
    pass. Their input is the same audio in all three passes (pass 3's no-audio flag only
    drops the 8-layer stack), so the shared features and summed gradients equal the
    per-pass ones, and their running statistics take the closed form of three updates
    (``_amplify_bn_updates``)."""
    cfg = model.config
    dtype = compute_dtype_of(compute_dtype)
    w = dict(lu=cfg.lu, ll=cfg.ll, lh=cfg.lh, lf=cfg.lf)
    c = dict(cu=cfg.cu, cl=cfg.cl, ch=cfg.ch, cf=cfg.cf)
    encoders = ("audio_encoder_face", "audio_encoder_body")
    shard = data_sharding(mesh)

    def forward_pass(params, pass_seed, audio, speaker_id, masked_motion, mask, use_audio,
                     audio_features):
        # the scopes are entered inside the checkpointed function: its recomputation runs
        # on autograd's thread, which does not see the step's thread-local scopes
        with dropout_rng(DropoutRng(pass_seed, audio.device)), batch_shard(shard):
            return call(model, params, audio, speaker_id, masked_motion, mask,
                        use_audio=use_audio, audio_features=audio_features)

    def run_pass(*args):
        if not gradient_checkpointing:
            pred = forward_pass(*args)
        else:
            pred = checkpoint(forward_pass, *args, use_reentrant=False,
                              preserve_rng_state=False,
                              context_fn=lambda: (contextlib.nullcontext(),
                                                  frozen_running_stats()))
        return {k: v.float() for k, v in pred.items()}

    def loss_fn(batch, iteration):
        rot6d = _rot6d(batch["motion"])
        speaker_id = _speaker(batch)
        with torch.no_grad():  # targets stay float32: the frozen suite
            args = (suite, rot6d, batch["expressions"], batch["foot_contact"], batch["trans"])
            target_idx, target_lat = vq_map2index(*args), vq_map2latent(*args)
        masked_motion = torch.cat([rot6d, batch["trans"], batch["foot_contact"]], dim=-1)

        params = compute_params(model, dtype)
        audio, masked_motion = _cast(dtype, batch["audio"]), _cast(dtype, masked_motion)
        seed0 = step_seed(seed, iteration)
        features = None
        if share_audio_encoder:
            snapshot = {bn: (bn.running_mean.clone(), bn.running_var.clone())
                        for name in encoders for bn in getattr(model, name).modules()
                        if isinstance(bn, BatchNorm1d)}
            with dropout_rng(DropoutRng(mix_seed(seed0, 0), audio.device)):
                features = tuple(call(getattr(model, name), sub_params(params, name), audio)
                                 for name in encoders)
            _amplify_bn_updates(snapshot, 3)

        losses = {}
        mask1 = torch.ones_like(masked_motion)
        mask1[:, :cfg.seed_frames] = 0.0
        pred = run_pass(params, mix_seed(seed0, 1), audio, speaker_id, masked_motion, mask1,
                        True, features)
        losses["rec_seed"] = rec_loss(pred, target_lat, **w)
        losses["cls_seed"] = cls_loss(pred, target_idx, **c)

        ratio = mask_ratio_schedule(float(iteration), mask_schedule)
        g = torch.Generator(masked_motion.device).manual_seed(mix_seed(seed0, 4))
        mask2 = (rand_rows(masked_motion.shape, g, masked_motion.device)
                 < ratio).to(masked_motion.dtype)
        pred = run_pass(params, mix_seed(seed0, 2), audio, speaker_id, masked_motion, mask2,
                        True, features)
        losses["rec_audio"] = rec_loss(pred, target_lat, **w)
        losses["cls_audio"] = cls_loss(pred, target_idx, **c)

        pred = run_pass(params, mix_seed(seed0, 3), audio, speaker_id, masked_motion, mask2,
                        False, features)
        losses["rec_mask"] = rec_loss(pred, target_lat, **w)
        losses["cls_mask"] = cls_loss(pred, target_idx, **c)
        losses["all"] = sum(losses.values())
        return losses["all"], losses

    return _make_step(model, optimizer, loss_fn, dtype, mesh)


def make_camn_train_step(model: nn.Module, optimizer: TrainOptimizer,
                         compute_dtype: Optional[str] = None, seed: int = 0,
                         mesh: Optional[Mesh] = None) -> Step:
    """CaMN's geodesic objective on rot6d (the reference's train_camn_audio.py:91-116):
    the ground truth's first frames seed the model. Losses: loss (= all_loss)."""
    cfg = model.config
    dtype = compute_dtype_of(compute_dtype)

    def loss_fn(batch, iteration):
        rot6d = _rot6d(batch["motion"])
        params = compute_params(model, dtype)
        with dropout_rng(DropoutRng(step_seed(seed, iteration), rot6d.device)):
            pred = call(model, params, _cast(dtype, batch["audio"]), _speaker(batch),
                        seed_frames=cfg.seed_frames, seed_motion=_cast(dtype, rot6d),
                        return_axis_angle=False)
        loss = _geodesic(pred["motion"], rot6d)
        return loss, {"loss": loss, "all_loss": loss}

    return _make_step(model, optimizer, loss_fn, dtype, mesh)


def _normalize_time(x: torch.Tensor) -> torch.Tensor:
    """The reference's F.normalize(fea, dim=1): unit norm along time."""
    return x / x.norm(dim=1, keepdim=True).clamp_min(1e-12)


def make_disco_train_step(model: nn.Module, optimizer: TrainOptimizer,
                          compute_dtype: Optional[str] = None, seed: int = 0,
                          mesh: Optional[Mesh] = None) -> Step:
    """DisCo's geodesic loss plus the rhythm and content contrastive losses on features
    normalized along time (the reference's train_disco_audio.py:129-170). Losses: loss,
    rhythm, content and their sum, all_loss.

    The contrastive terms pair every row with every other of the global batch: under a
    mesh the features are gathered over the processes with their gradient, so each
    process computes the global terms, and its rows receive the sum over the processes
    of their gradient, which the gradient average turns into the global batch's."""
    cfg = model.config
    dtype = compute_dtype_of(compute_dtype)

    def loss_fn(batch, iteration):
        rot6d = _rot6d(batch["motion"])
        params = compute_params(model, dtype)
        with dropout_rng(DropoutRng(step_seed(seed, iteration), rot6d.device)):
            pred = call(model, params, _cast(dtype, batch["audio"]), _speaker(batch),
                        seed_frames=cfg.seed_frames, seed_motion=_cast(dtype, rot6d),
                        return_axis_angle=False)
        losses = {"loss": _geodesic(pred["motion"], rot6d)}
        for name, fea in (("rhythm", "audio_fea_r"), ("content", "audio_fea_c")):
            losses[name] = contrastive_loss(
                gather_rows(_normalize_time(pred[fea].float()), shard),
                gather_rows(batch[f"{name}_label"], shard))
        losses["all_loss"] = sum(losses.values())
        return losses["all_loss"], losses

    shard = data_sharding(mesh)
    return _make_step(model, optimizer, loss_fn, dtype, mesh)


def vq_global_vae_target(lower_stream: torch.Tensor) -> torch.Tensor:
    """The global-translation VAE's training target: the 61-d lower stream with the
    translation slots [54:57] replaced by (x velocity, y height, z velocity), the
    velocity the forward difference at 30 fps with the last frame repeated, which
    ``velocity2position`` integrates back to the absolute translation (the channels
    ``vq_get_global_motion`` reads)."""
    pos = lower_stream[:, :, 54:57]
    vel = (pos[:, 1:] - pos[:, :-1]) * 30.0
    vel = torch.cat([vel, vel[:, -1:]], dim=1)
    v_xz = torch.cat([vel[:, :, 0:1], pos[:, :, 1:2], vel[:, :, 2:3]], dim=2)
    return torch.cat([lower_stream[:, :, :54], v_xz, lower_stream[:, :, 57:]], dim=2)


def vq_usage_init(suite: EmageVQSuite) -> Dict[str, torch.Tensor]:
    """The initial per-code usage EMA of the dead-code restarts: 1/K for every code, so
    each starts with a full grace window (~350 steps at decay 0.99, threshold 0.03)."""
    out = {}
    for part in PARTS:
        weight = getattr(suite, part).quantizer.embedding.weight
        k = weight.shape[0]
        out[part] = torch.full((k,), 1.0 / k, dtype=torch.float32, device=weight.device)
    return out


class RestartingOptimizer:
    """A :class:`TrainOptimizer` with the dead-code restarts' per-code usage EMA
    (``usage``, {part: (K,) float32}): the JAX step's ``(opt_state, usage)`` state. Its
    ``state_dict`` holds both, so a checkpoint resumes the restarts where they were.
    ``dead`` holds the last step's restart masks."""

    def __init__(self, optimizer: TrainOptimizer, usage: Dict[str, torch.Tensor]):
        self.optimizer = optimizer
        self.usage = usage
        self.dead: Dict[str, torch.Tensor] = {}

    @property
    def lr(self) -> float:
        return self.optimizer.lr

    def zero_grad(self) -> None:
        self.optimizer.zero_grad()

    def step(self) -> None:
        self.optimizer.step()

    def state_dict(self) -> dict:
        return {"optimizer": self.optimizer.state_dict(),
                "usage": {k: v.detach().cpu() for k, v in self.usage.items()}}

    def load_state_dict(self, state: dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        for k, v in state["usage"].items():
            self.usage[k].copy_(v)


def make_vq_train_step(suite: EmageVQSuite, optimizer, compute_dtype: Optional[str] = None,
                       vel_weight: float = 1.0, restart_dead_codes: bool = False,
                       restart_decay: float = 0.99, restart_thresh: float = 0.03,
                       seed: int = 0, mesh: Optional[Mesh] = None) -> Step:
    """Pretrain the five EMAGE tokenizers jointly (the JAX ``make_vq_train_step``).

    Per part VQ-VAE (face, upper, hands, lower): ``rec_{part}``, the MSE on the part
    stream; ``vel_{part}``, the first-difference MSE, weighted by ``vel_weight``;
    ``emb_{part}``, the quantizer's codebook and commitment loss (straight-through,
    ``nn/vq.py``); ``ppl_{part}``, the perplexity, logged only. The global VAE trains
    on ``vq_global_vae_target(lower)`` with the same two reconstruction terms
    (``rec_global``, ``vel_global``). ``all_loss`` is their sum. The streams are
    ``vq_split_inputs`` of the motion's rot6d, the expressions, foot contact and trans.

    ``restart_dead_codes``: ``optimizer`` is a :class:`RestartingOptimizer`. After the
    update, per part, ``u = decay * usage + (1 - decay) * counts / max(sum(counts), 1)``
    from the step's code counts; codes with ``u < thresh / K`` are dead: their codebook
    rows become rows of the batch's detached float32 encoder outputs, picked by a CPU
    generator seeded from (seed, iteration, part) (the same picks on every device; not
    ``jax.random``'s), their usage is reset to 1/K, and ``restarted_{part}`` counts
    them. The optimizer's moments of a restarted row are left as they are, as in the
    JAX step.

    Under a mesh the code counts are summed and the encoder outputs gathered over the
    processes in rank order (the single process's row order), so every process takes
    the same restart decision and picks as one process would; under FSDP each process
    writes the picks into the codebook slice it holds."""
    dtype = compute_dtype_of(compute_dtype)
    shard = data_sharding(mesh)
    if restart_dead_codes and not isinstance(optimizer, RestartingOptimizer):
        raise TypeError("restart_dead_codes needs RestartingOptimizer(optimizer, "
                        "vq_usage_init(suite))")
    aux: Dict[str, tuple] = {}

    def rec_terms(losses, rec, target, name):
        rec = rec.float()
        r = ((rec - target) ** 2).mean()
        v = (((rec[:, 1:] - rec[:, :-1]) - (target[:, 1:] - target[:, :-1])) ** 2).mean()
        losses[f"rec_{name}"], losses[f"vel_{name}"] = r, v
        return r + vel_weight * v

    def loss_fn(batch, iteration):
        streams = vq_split_inputs(_rot6d(batch["motion"]), batch["expressions"],
                                  batch["foot_contact"], batch["trans"])
        params = compute_params(suite, dtype)
        losses: Dict[str, torch.Tensor] = {}
        total = torch.zeros((), device=batch["motion"].device)
        for part in PARTS:
            x = streams[part]
            out = call(getattr(suite, part), sub_params(params, part), _cast(dtype, x))
            emb = out["embedding_loss"].float()
            losses[f"emb_{part}"] = emb
            losses[f"ppl_{part}"] = out["perplexity"].float()
            total = total + rec_terms(losses, out["rec_pose"], x, part) + emb
            if restart_dead_codes:
                z = out["pre_latent"].detach().float()
                k = getattr(suite, part).quantizer.embedding.weight.shape[0]
                counts = torch.bincount(out["indices"].reshape(-1).long(), minlength=k).float()
                zpool = gather_rows(z.reshape(-1, z.shape[-1]), shard)
                aux[part] = (counts if shard is None else all_reduce_sum(counts, shard.group),
                             zpool)
        g_rec = call(suite.global_motion, sub_params(params, "global_motion"),
                     _cast(dtype, streams["lower"]))["rec_pose"]
        total = total + rec_terms(losses, g_rec, vq_global_vae_target(streams["lower"]),
                                  "global")
        losses["all_loss"] = total
        return total, losses

    base = _make_step(suite, optimizer, loss_fn, dtype, mesh)
    if not restart_dead_codes:
        return base
    fsdp = fsdp_state(optimizer)

    @torch.no_grad()
    def restart(losses, iteration):
        seed0 = step_seed(seed, iteration)
        for i, part in enumerate(PARTS):
            counts, zpool = aux.pop(part)
            weight = getattr(suite, part).quantizer.embedding.weight
            k = optimizer.usage[part].shape[0]
            u = (restart_decay * optimizer.usage[part]
                 + (1.0 - restart_decay) * (counts / counts.sum().clamp_min(1.0)))
            dead = u < restart_thresh / k
            g = torch.Generator().manual_seed(mix_seed(seed0, i))
            pick = torch.randint(0, zpool.shape[0], (k,), generator=g).to(zpool.device)
            picked = zpool[pick].to(weight.dtype)
            held, part_of = (weight, lambda t: t) if fsdp is None else fsdp.held(weight)
            held.copy_(torch.where(part_of(dead[:, None].expand_as(picked)), part_of(picked),
                                   held))
            optimizer.usage[part].copy_(torch.where(dead, torch.full_like(u, 1.0 / k), u))
            optimizer.dead[part] = dead
            losses[f"restarted_{part}"] = dead.float().sum()
        return losses

    def step(batch: Dict[str, torch.Tensor], iteration: int) -> Dict[str, torch.Tensor]:
        return restart(base(batch, iteration), iteration)

    return step


__all__ = [
    "BN_BUFFER_KEYS",
    "call",
    "compute_params",
    "make_camn_train_step",
    "make_disco_train_step",
    "make_emage_train_step",
    "make_vq_train_step",
    "mask_ratio_schedule",
    "RestartingOptimizer",
    "step_seed",
    "vq_global_vae_target",
    "vq_usage_init",
]
