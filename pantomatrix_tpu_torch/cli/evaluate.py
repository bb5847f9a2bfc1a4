"""Test-set inference and metric evaluation on the GPU (counterpart of
``pantomatrix_tpu/cli/evaluate.py``, the reference's ``--test`` flow): per unique test
video, generate motion from the audio, save BEAT npz, then compute FGD, and BC, L1div,
LVD and MSE when the SMPL-X archive is found (``SMPLX_MODEL_PATH``). The FGD feature net
is read from ``./emage_evaltools/AESKConv_240_100.bin`` when that file exists, else the
statistics embedder stands in (``fgd_embedder`` in metrics.json says which).

    python -m pantomatrix_tpu_torch.cli.evaluate --family camn --model_path <ckpt> \\
        --meta <clip index json> --save_folder ./outputs/test

Without a clip index, point at a bare BEAT2 layout (train_test_split.csv,
smplxflame_30/, wave16k/) and one is built on the fly:

    python -m pantomatrix_tpu_torch.cli.evaluate --family camn --model_path <ckpt> \\
        --beat2_root <BEAT2 dir> --save_folder ./outputs/test

Everything runs on ``--device`` (default cuda); ``--device cpu`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os

from ..eval.test_flow import (
    make_camn_generate,
    make_disco_generate,
    make_emage_generate,
    make_emage_vq_roundtrip_generate,
    run_test_pass,
    unique_test_clips,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--family", choices=["camn", "disco", "emage"], required=True)
    p.add_argument("--model_path", type=str, required=True)
    p.add_argument("--meta", type=str, nargs="+", default=None,
                   help="clip-index JSON(s); omit with --beat2_root")
    p.add_argument("--beat2_root", type=str, default=None,
                   help="bare BEAT2 layout; builds the clip index locally")
    p.add_argument("--clip_length", type=int, default=64)
    p.add_argument("--clip_stride", type=int, default=20)
    p.add_argument("--speaker", type=int, default=2)
    p.add_argument("--save_folder", type=str, required=True)
    p.add_argument("--vq_path", type=str, default=None,
                   help="emage only: checkpoint root of the tokenizers (emage_vq/*); "
                        "default --model_path")
    p.add_argument("--fgd_strict", action="store_true",
                   help="raise if the AESKConv FGD weights are missing or corrupt "
                        "instead of degrading to the stats embedder")
    p.add_argument("--vq_roundtrip", action="store_true",
                   help="emage only: decode GROUND-TRUTH motion through the VQ "
                        "tokenizers instead of generating from audio; the metrics "
                        "bound what any checkpoint can reach with this tokenizer suite")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; the default needs a CUDA card")
    return p


def main(argv=None) -> None:
    from ..models.api import AutoModel, EmageVQModel

    p = build_parser()
    args = p.parse_args(argv)
    if args.vq_roundtrip and args.family != "emage":
        p.error("--vq_roundtrip applies to --family emage only")
    os.makedirs(args.save_folder, exist_ok=True)
    metas = args.meta
    if metas is None:
        if args.beat2_root is None:
            p.error("either --meta or --beat2_root is required")
        from ..data.preprocess import build_clip_index

        metas = [build_clip_index(args.beat2_root, args.save_folder,
                                  stride=args.clip_stride, motion_length=args.clip_length,
                                  speaker_target=args.speaker)]
        print(f"built clip index: {metas[0]}")
    test_list = unique_test_clips(metas)
    model = AutoModel.from_pretrained(args.model_path, device=args.device)
    cfg = model.config

    if args.family == "emage":
        vq = EmageVQModel.from_pretrained(args.vq_path or args.model_path, args.device)
        generate_fn = (make_emage_vq_roundtrip_generate(vq) if args.vq_roundtrip
                       else make_emage_generate(model, vq))
    elif args.family == "disco":
        generate_fn = make_disco_generate(model)
    else:
        generate_fn = make_camn_generate(model)

    metrics = run_test_pass(generate_fn, test_list, args.save_folder,
                            pose_fps=cfg.pose_fps, audio_sr=cfg.audio_sr,
                            with_face=args.family == "emage", fgd_strict=args.fgd_strict,
                            device=args.device)
    print(json.dumps(metrics, indent=2))


if __name__ == "__main__":
    main()
