"""Entry point of the port's flagship forward (counterpart of the repository's
``__graft_entry__.entry``): one full-width EMAGE masked-transformer window.

    fn, args = entry()       # on the card; entry("cpu") builds it on the CPU
    outputs = fn(*args)      # rec_* latents and cls_* logits of one 64-frame window

``dryrun_multichip(n)`` (the counterpart of ``__graft_entry__.dryrun_multichip``; on the
cards, or over gloo on the CPU with ``device="cpu"``) runs the multi-process paths in
``n`` processes on tiny shapes and holds each against
one process: an EMAGE train step data parallel, one under FSDP on ``(n // 2, 2)``, and
inference with the batch split over the processes and with the FSDP-placed weights.
"""
from __future__ import annotations

import numpy as np
import torch


def _flagship(tiny: bool = False, device="cuda"):
    """The EMAGE audio model at the published widths, or at the tiny test widths, with
    random weights from seed 0."""
    from .models.api import EmageAudioModel
    from .models.configs import EmageAudioConfig

    cfg = (EmageAudioConfig(audio_f=32, motion_f=16, hidden_size=32, speaker_dims=4,
                            pose_length=8, seed_frames=2, vae_codebook_size=16,
                            vae_length=16, dropout_prob=0.0)
           if tiny else EmageAudioConfig())
    return EmageAudioModel(cfg, seed=0, device=device)


def _entry(tiny: bool, device):
    from .models.emage import SAMPLES_PER_FRAME, emage_forward

    model = _flagship(tiny, device)
    cfg = model.config
    t = cfg.pose_length
    dev = model.mask_embedding.device
    rng = np.random.RandomState(0)
    audio = torch.from_numpy(rng.uniform(-1, 1, (1, t * SAMPLES_PER_FRAME))
                             .astype(np.float32)).to(dev)
    speaker_id = torch.zeros((1, 1), dtype=torch.long, device=dev)
    motion = torch.zeros((1, t, cfg.pose_dims + 7), device=dev)
    mask = torch.ones((1, t, cfg.pose_dims + 7), device=dev)

    def fn(model, audio, speaker_id, motion, mask):
        return emage_forward(model, audio, speaker_id, motion, mask)

    return fn, (model, audio, speaker_id, motion, mask)


def entry(device="cuda"):
    """(fn, example_args): ``fn(*example_args)`` is ``emage_forward`` on one full-width
    window (h = 768, 64 frames, 337 motion channels) with batch 1."""
    return _entry(False, device)


DRYRUN_ATOL = 1e-5  # one SGD step at lr 0.1, float32: the reduction order's ulps


def _tiny_suite(device):
    """Tokenizers at the tiny model's widths (codebooks of 16, vae_length 16; the global
    VAE at 24), random from a seed."""
    from .models.configs import EmageVAEConvConfig, EmageVQVAEConvConfig
    from .models.emage_vq import EmageVAE, EmageVQSuite, EmageVQVAE

    g = torch.Generator().manual_seed(1)
    part = lambda dim: EmageVQVAE(EmageVQVAEConvConfig(vae_test_dim=dim, vae_length=16,
                                                       vae_codebook_size=16), generator=g)
    return EmageVQSuite(face=part(106), upper=part(78), hands=part(180), lower=part(61),
                        global_motion=EmageVAE(EmageVAEConvConfig(vae_length=24,
                                                                  vae_test_dim=61),
                                               generator=g)).to(device)


def _dryrun_batch(bs: int, t: int, device) -> dict:
    rng = np.random.RandomState(2)
    b = {"motion": rng.uniform(-0.5, 0.5, (bs, t, 165)), "audio": rng.uniform(-1, 1, (bs, t * 533)),
         "expressions": rng.uniform(-1, 1, (bs, t, 100)), "trans": rng.uniform(-1, 1, (bs, t, 3)),
         "foot_contact": rng.uniform(size=(bs, t, 4)) < 0.5}
    return {k: torch.from_numpy(np.asarray(v, np.float32)).to(device) for k, v in b.items()}


def _max_err(a: dict, b: dict) -> float:
    return max(float((a[k].detach().float() - b[k].detach().float()).abs().max()) for k in a)


def _dryrun_checks(world: int, device) -> dict:
    """The dry run's checks in one process of ``world``; every process returns the same
    dict."""
    from .models.emage import _select_decode_inputs, emage_inference
    from .models.emage_vq import vq_decode
    from .train import mesh as M
    from .train.optim import make_optimizer
    from .train.steps import make_emage_train_step
    from .utils.distributed import gather_rows, local_rows

    suite = _tiny_suite(device)
    batch = _dryrun_batch(2 * world, 8, device)
    mesh = M.make_mesh(world)
    shard = M.data_sharding(mesh)

    def train(mesh):
        model = _flagship(True, device)
        opt = make_optimizer(model.parameters(), learning_rate=0.1, optimizer="sgd")
        if mesh is not None:
            model, opt = M.place_train_state(model, opt, mesh)
        step = make_emage_train_step(model, suite, opt, mesh=mesh, seed=3)
        losses = step(batch if mesh is None else M.shard_batch(batch, mesh), 1)
        losses = M.mean_over_processes({k: float(v) for k, v in losses.items()}, mesh, device)
        M.gather_replicated(model, opt, mesh)
        return model, opt, losses

    def row(got, want, **extra):
        err = _max_err(got, want)
        finite = all(bool(torch.isfinite(v.float()).all()) for v in got.values())
        return {"max_abs_err": err, "equal_to_one_process": finite and err <= DRYRUN_ATOL,
                **extra}

    ref, _, ref_losses = train(None)
    want = dict(ref.named_parameters())
    out = {}
    model, _, losses = train(mesh)
    loss_err = max(abs(losses[k] - v) / max(abs(v), 1e-30) for k, v in ref_losses.items())
    out["train_dp"] = row(dict(model.named_parameters()), want, loss_max_rel_err=loss_err)
    if world % 2 == 0:
        mesh2 = M.make_mesh(world, ("data", "model"), (world // 2, 2))
        model, opt, losses = train(mesh2)
        fsdp = M.fsdp_state(opt)
        held = sum(e.held.numel() for e in fsdp.entries if e.dim is not None)
        full = sum(e.param.numel() for e in fsdp.entries if e.dim is not None)
        out["train_fsdp"] = row(dict(model.named_parameters()), want,
                                sharded_fraction_held=held / full)
    else:  # the JAX dry run also runs FSDP on even counts only
        mesh2 = None

    # inference: 2 full windows and a remainder for 2 rows a process
    ref_model = _flagship(True, device)
    t = 2 * ref_model.config.pose_length + 3
    audio = torch.from_numpy(np.random.RandomState(4).uniform(-1, 1, (2 * world, t * 533))
                             .astype(np.float32)).to(device)
    sid = torch.zeros((2 * world, 1), dtype=torch.long, device=device)

    def infer(model, audio, sid):
        with torch.no_grad():
            net = emage_inference(model, audio, sid, suite)
            dec = vq_decode(suite, **_select_decode_inputs(model.config, net),
                            get_global_motion=True,
                            ref_trans=torch.zeros((audio.shape[0], 3), device=device))
        return {"motion_axis_angle": dec["motion_axis_angle"], "face": net["rec_face"]}

    whole = infer(ref_model, audio, sid)
    mine = infer(ref_model, local_rows(audio, shard), local_rows(sid, shard))
    out["inference_batch_sharded"] = row({k: gather_rows(v, shard) for k, v in mine.items()},
                                         whole)
    if mesh2 is not None:
        model = _flagship(True, device)
        model, opt = M.place_train_state(
            model, make_optimizer(model.parameters(), learning_rate=0.1), mesh2)
        fsdp = M.fsdp_state(opt)
        fsdp.release()  # at rest: the slices only
        fsdp.gather()  # gathered for use
        out["inference_param_sharded"] = row(infer(model, audio, sid), whole)
    return out


def _dryrun_process(world: int, device: str):
    """One process of :func:`dryrun_multichip`: its checks and the group's backend."""
    import torch.distributed as dist

    dev = (torch.device("cuda", torch.cuda.current_device()) if device == "cuda"
           else torch.device("cpu"))
    return _dryrun_checks(world, dev), dist.get_backend()


def dryrun_multichip(n_devices: int = 2, device: str = "cuda", timeout_s: float = 600.0) -> dict:
    """Run the multi-process paths on tiny shapes in ``n_devices`` spawned processes over
    ``torch.distributed``, on the cards (NCCL where each process has a card of its own,
    gloo where they share; raises without CUDA) or, with ``device="cpu"``, over gloo on
    the CPU, against one process: ``train_dp`` (an EMAGE SGD step, the batch split
    over the processes), ``train_fsdp`` (the same under FSDP on ``(n // 2, 2)``, even
    ``n``), ``inference_batch_sharded`` (``emage_inference`` + ``vq_decode``, rows split
    and gathered back) and ``inference_param_sharded`` (the FSDP-placed weights gathered
    for use). Returns process 0's rows ({"max_abs_err", "equal_to_one_process", ...},
    and "backend"); raises if a process fails, hangs past ``timeout_s`` or disagrees."""
    from .models.api import resolve_device
    from .train.mesh import run_processes

    resolve_device(device)
    out, backend = run_processes(_dryrun_process, n_devices, device, (n_devices, device),
                                 timeout_s=timeout_s, what=f"dryrun_multichip({n_devices})")[0]
    bad = {k: v for k, v in out.items() if not v["equal_to_one_process"]}
    if bad:
        raise AssertionError(f"dryrun_multichip({n_devices}) differs from one process: {bad}")
    for v in out.values():
        v["backend"] = backend
    return out


__all__ = ["dryrun_multichip", "entry"]
