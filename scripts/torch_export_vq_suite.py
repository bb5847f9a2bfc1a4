"""Export a tokenizer suite from a checkpoint of the PyTorch/CUDA port's VQ trainer
(``python -m pantomatrix_tpu_torch.cli.train_emage_vq``).

The trainer exports its best-val suite when it ends; this rebuilds the ``--vq_path``
layout (``<output_dir>/emage_vq/{face,upper,hands,lower,global}/config.json +
model.safetensors``) from any ``best.bin`` or ``last.bin`` it saved, for instance of an
interrupted run. The layout loads into ``EmageVQModel.from_pretrained`` and into the
JAX package's ``cli.train_emage --vq_path``.

Usage (from the repository root):
    python scripts/torch_export_vq_suite.py <ckpt.bin> <output_dir> [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt_path")
    ap.add_argument("out_dir")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from pantomatrix_tpu_torch.cli.train_emage_vq import export_suite
    from pantomatrix_tpu_torch.models.api import EmageVQModel, resolve_device
    from pantomatrix_tpu_torch.train.ckpt import load_train_state

    suite = EmageVQModel.random(seed=0, device=resolve_device(args.device))
    iteration, extra = load_train_state(args.ckpt_path, suite)
    root = export_suite(args.out_dir, suite)
    print(f"exported tokenizer suite (step {iteration}, extra={extra}) to {root}")


if __name__ == "__main__":
    main()
