"""EMAGE motion-tokenizer (VQ/VAE suite) pretraining (counterpart of
``pantomatrix_tpu/cli/train_emage_vq.py``), on one card or several processes
(``cli/_train_common.py``).

The reference consumes five frozen pretrained tokenizers and ships no trainer for them.
This stage trains all five jointly on BEAT2-format motion (``train/steps.py``
``make_vq_train_step``, dead-code restarts on by default) from codebooks initialized on
the untrained encoders' outputs, and exports them in the layout ``cli.train_emage
--vq_path`` of either package loads:

    <output_dir>/emage_vq/{face,upper,hands,lower,global}/config.json + model.safetensors

Validation: the VQ round-trip windowed FGD on the val split (ground truth -> codes ->
decode), the reconstruction bound any EMAGE audio model trained against these
tokenizers can reach. The round trip decodes from the code indices (``map2index``), as
the JAX package's does, so it makes no nearest-code kernel launch.

Usage: python -m pantomatrix_tpu_torch.cli.train_emage_vq [--config <yaml>] [--debug]
       [--device cuda|cpu] [k=v ...]
"""
from __future__ import annotations

import os

import numpy as np
import torch

SUITE_DIRS = {"face": "face", "upper": "upper", "hands": "hands", "lower": "lower",
              "global_motion": "global"}


def export_suite(out_dir: str, suite) -> str:
    """Write the five tokenizers as checkpoint directories (``config.json`` +
    ``model.safetensors``) under ``<out_dir>/emage_vq``; returns that directory."""
    from ..io.hf_checkpoint import SAFETENSORS_NAME, write_safetensors

    root = os.path.join(out_dir, "emage_vq")
    for part, name in SUITE_DIRS.items():
        module, directory = getattr(suite, part), os.path.join(root, name)
        os.makedirs(directory, exist_ok=True)
        write_safetensors(os.path.join(directory, SAFETENSORS_NAME), module.state_dict())
        module.config.save_json(directory)
    return root


def _streams(batch):
    from ..core.rotations import axis_angle_to_rotation_6d
    from ..models.emage_vq import vq_split_inputs

    motion = batch["motion"]
    bs, t, jc = motion.shape
    rot6d = axis_angle_to_rotation_6d(motion.reshape(bs, t, jc // 3, 3)).reshape(bs, t, -1)
    return rot6d, vq_split_inputs(rot6d, batch["expressions"], batch["foot_contact"],
                                  batch["trans"])


@torch.no_grad()
def data_init_codebooks(suite, loader, seed: int = 0):
    """Replace the reference's U(-1/K, 1/K) codebooks with K rows sampled from the
    untrained encoders' outputs: batches in loader order are pooled until every part
    has 8 K rows, then ``np.random.RandomState(seed).choice`` picks K per part (with
    replacement and 1e-3 jitter where the pool is smaller than K), as the JAX CLI does.
    The reference init puts every code in a +-1/K ball far from the encoder outputs, so
    the nearest-code search picks 1-5 codes and the codebook collapses."""
    from ..data.beat2 import to_device
    from ..models.emage_vq import PARTS
    from ..nn.layers import strict_fp32

    device = next(suite.parameters()).device
    pools = {part: [] for part in PARTS}
    need = {part: getattr(suite, part).config.vae_codebook_size for part in PARTS}
    rng = np.random.RandomState(seed)
    for batch in loader:
        with strict_fp32():
            _, streams = _streams(to_device(batch, device))
            for part in PARTS:
                z = getattr(suite, part).encoder(streams[part])
                pools[part].append(z.reshape(-1, z.shape[-1]).cpu().numpy())
        if all(sum(len(x) for x in pools[p]) >= 8 * need[p] for p in PARTS):
            break
    for part in PARTS:
        pool = np.concatenate(pools[part])
        k = need[part]
        codes = pool[rng.choice(len(pool), size=k, replace=len(pool) < k)]
        if len(pool) < k:
            # tiny (debug) datasets: break the duplicate codes' ties with jitter
            codes = codes + rng.normal(scale=1e-3, size=codes.shape)
        getattr(suite, part).quantizer.embedding.weight.copy_(
            torch.as_tensor(np.asarray(codes, np.float32)))
    print("codebooks initialized from encoder outputs "
          f"({ {p: len(np.concatenate(pools[p])) for p in PARTS} } frames pooled)")
    return suite


def roundtrip_rot6d(suite, batch):
    """Ground truth -> code indices (all four parts) -> decode: the quantized round
    trip, as (decoded rot6d, ground-truth rot6d), 330 channels each."""
    from ..models.emage_vq import vq_decode, vq_map2index

    gt6, _ = _streams(batch)
    idx = vq_map2index(suite, gt6, batch["expressions"], batch["foot_contact"],
                       batch["trans"])
    dec = vq_decode(suite, face_index=idx["face"], upper_index=idx["upper"],
                    hands_index=idx["hands"], lower_index=idx["lower"])
    return dec["all_motion4inference"][:, :, :-7], gt6


def main():
    from ..data.beat2 import BEAT2Dataset, DataLoader
    from ..models.api import EmageVQModel
    from ..train.ckpt import load_train_state
    from ..train.mesh import place_train_state
    from ..train.steps import RestartingOptimizer, make_vq_train_step, vq_usage_init
    from . import _train_common as common

    cfg, device, mesh = common.init_env("emage_vq.yaml")
    common.seed_everything(cfg.seed)
    suite = EmageVQModel.random(seed=cfg.seed, device=device)
    m = cfg.model
    pose_fps, audio_sr = int(m.get("pose_fps", 30)), int(m.get("audio_sr", 16000))
    train_ds = BEAT2Dataset(cfg.data.meta_paths, "train", pose_fps, audio_sr, None,
                            variant="emage_footcontact")
    if bool(m.get("data_init_codebook", True)) and not cfg.get("resume_from_checkpoint"):
        # from the global batches on every process: the single-process codebooks
        data_init_codebooks(suite, DataLoader(train_ds, cfg.data.train_bs, seed=cfg.seed),
                            seed=cfg.seed)
    suite, optimizer = place_train_state(suite, common.optimizer_from_config(cfg, suite), mesh)
    restart = bool(m.get("restart_dead_codes", True))
    if restart:
        optimizer = RestartingOptimizer(optimizer, vq_usage_init(suite))
    step_fn = make_vq_train_step(
        suite, optimizer, compute_dtype=cfg.solver.get("compute_dtype"),
        vel_weight=float(m.get("vel_weight", 1.0)), restart_dead_codes=restart,
        restart_decay=float(m.get("restart_decay", 0.99)),
        restart_thresh=float(m.get("restart_thresh", 0.03)), seed=cfg.seed, mesh=mesh)

    train_loader = DataLoader(train_ds, cfg.data.train_bs, seed=cfg.seed,
                              process_index=mesh.rank, process_count=mesh.world)
    val_ds = BEAT2Dataset(cfg.data.test_meta_paths, "val", pose_fps, audio_sr, None,
                          variant="emage_footcontact")
    val_fn = None
    if len(val_ds):
        val_loader = DataLoader(val_ds, min(cfg.data.train_bs, len(val_ds)), shuffle=False)
        val_fn = common.windowed_fgd_val(val_loader, roundtrip_rot6d, device)
    common.run(cfg, device, suite, step_fn, optimizer, train_loader, val_fn, None, mesh)

    if mesh.rank != 0:  # process 0 wrote the checkpoints and exports
        return
    # the export: the best-val suite, or the last state when no validation ran
    best_bin = os.path.join(cfg.output_dir, "ckpt", "best.bin")
    if os.path.exists(best_bin):
        it, _ = load_train_state(best_bin, suite)
        print(f"exporting best-val suite (step {it})")
    print(f"exported tokenizer suite to {export_suite(cfg.output_dir, suite)}")


if __name__ == "__main__":
    main()
