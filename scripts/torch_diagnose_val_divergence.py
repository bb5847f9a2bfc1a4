"""Diagnose a train/val FGD divergence of a CaMN or DisCo checkpoint of the PyTorch/CUDA
port (the counterpart of scripts/diagnose_val_divergence.py).

It computes the metric the trainer's validation logs (windowed FGD,
``cli/_train_common.windowed_fgd_val`` with the seed-frame predictor) on two splits of
equal size:

  * the val split (what the training log reports), and
  * a subset of the train split (clips the optimizer saw), spread evenly over it.

If a rising val FGD is overfitting, the train-subset FGD stays low (or keeps falling)
while the val FGD climbs; if both rise, the model degenerates on every clip and the
divergence is an optimization problem.

Usage (from the repository root):
  python scripts/torch_diagnose_val_divergence.py --run outputs/<exp> [--ckpt best.bin]
      [--n_clips N] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import glob
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--run", required=True, help="run dir (containing ckpt/ + sanity_check/)")
    ap.add_argument("--ckpt", default="best.bin", help="file under <run>/ckpt/")
    ap.add_argument("--n_clips", type=int, default=None,
                    help="clips per split (default: the val split's size)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from pantomatrix_tpu_torch.cli._train_common import masked_rot6d_predictor, windowed_fgd_val
    from pantomatrix_tpu_torch.core.masking import MASK_DICT
    from pantomatrix_tpu_torch.data.beat2 import BEAT2Dataset, DataLoader
    from pantomatrix_tpu_torch.models.api import resolve_device
    from pantomatrix_tpu_torch.train.ckpt import load_train_state
    from pantomatrix_tpu_torch.utils.config import load_config

    device = resolve_device(args.device)
    run = args.run.rstrip("/")
    yamls = sorted(glob.glob(os.path.join(run, "sanity_check", "*.yaml")))
    if not yamls:
        sys.exit(f"no sanity_check yaml under {run}")
    cfg = load_config(yamls[0], [])
    if cfg.model.class_name == "DiscoAudioModel":
        from pantomatrix_tpu_torch.models.configs import DiscoAudioConfig as Config
        from pantomatrix_tpu_torch.models.disco import DiscoAudio as Model
    elif cfg.model.class_name == "CamnAudioModel":
        from pantomatrix_tpu_torch.models.camn import CamnAudio as Model
        from pantomatrix_tpu_torch.models.configs import CamnAudioConfig as Config
    else:
        sys.exit(f"{cfg.model.class_name}: only CaMN and DisCo runs are diagnosed")
    model_cfg = Config.from_dict(cfg.model.to_dict())
    model = Model(model_cfg, generator=torch.Generator().manual_seed(cfg.seed)).to(device)
    ckpt_path = os.path.join(run, "ckpt", args.ckpt)
    iteration, extra = load_train_state(ckpt_path, model)
    print(f"loaded {ckpt_path} @ iteration {iteration} extra={extra}")
    model.eval()

    split = lambda metas, mode: BEAT2Dataset(metas, mode, model_cfg.pose_fps,
                                             model_cfg.audio_sr, model_cfg.joint_mask)
    val_ds = split(cfg.data.test_meta_paths, "val")
    train_ds = split(cfg.data.meta_paths, "train")
    n = args.n_clips or len(val_ds)
    if n == 0:
        sys.exit("the val split is empty: pass --n_clips")
    # equal sizes: FGD's Gaussian fit depends on the sample count, so splits are
    # compared at one N; the train subset is spread over the split (its first rows
    # would all come from one take)
    stride = max(len(train_ds) // n, 1)
    train_ds.data_list = train_ds.data_list[::stride][:n]
    val_ds.data_list = val_ds.data_list[:n]
    bs = min(int(cfg.data.train_bs), n)
    print(f"{n} clips/split, batch {bs}")

    predict = masked_rot6d_predictor(MASK_DICT[model_cfg.joint_mask])
    out = {}
    for name, ds in (("val", val_ds), ("train-subset", train_ds)):
        fgd = windowed_fgd_val(DataLoader(ds, bs, shuffle=False), predict, device)(model,
                                                                                   iteration)
        print(f"windowed FGD [{name}] @ {iteration}: {fgd:.4f}")
        out[name] = float(fgd)
    return out


if __name__ == "__main__":
    main()
