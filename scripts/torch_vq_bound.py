"""The VQ round-trip windowed-FGD bound of a tokenizer suite on a BEAT2 split, with the
PyTorch/CUDA port.

It computes the metric the EMAGE trainer logs as ``val/metric`` (windowed FGD over
decoded predictions, ``cli/_train_common.windowed_fgd_val``), with the prediction
replaced by the ground truth's round trip through the suite (codes, then decode; the
VQ trainer's validation, ``cli/train_emage_vq.roundtrip_rot6d``). No audio model
trained against the suite can validate below it.

Usage (from the repository root):
  python scripts/torch_vq_bound.py --random_vq                      # seed-777 random suite
  python scripts/torch_vq_bound.py --vq_path outputs/<vq_exp>       # a trained suite
  [--meta datasets/synth_beat2/data_json/beat2_s20_l64_speaker2.json] [--mode val]
  [--bs 56] [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--meta", default="datasets/synth_beat2/data_json/"
                                      "beat2_s20_l64_speaker2.json")
    ap.add_argument("--vq_path", default=None)
    ap.add_argument("--random_vq", action="store_true")
    ap.add_argument("--mode", default="val", choices=["val", "test", "train"])
    ap.add_argument("--bs", type=int, default=56)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args()

    from pantomatrix_tpu_torch.cli._train_common import windowed_fgd_val
    from pantomatrix_tpu_torch.cli.train_emage import load_suite
    from pantomatrix_tpu_torch.cli.train_emage_vq import roundtrip_rot6d
    from pantomatrix_tpu_torch.data.beat2 import BEAT2Dataset, DataLoader
    from pantomatrix_tpu_torch.models.api import resolve_device

    device = resolve_device(args.device)
    suite = load_suite(args.vq_path, args.random_vq, device)
    ds = BEAT2Dataset([args.meta], args.mode, 30, 16000, None, variant="emage_footcontact")
    if not len(ds):
        raise SystemExit(f"no {args.mode}-mode clips in {args.meta}")
    loader = DataLoader(ds, min(args.bs, len(ds)), shuffle=False)
    print(f"{len(ds)} {args.mode} clips, batch {loader.batch_size}")
    suite.eval()
    bound = float(windowed_fgd_val(loader, roundtrip_rot6d, device)(suite, 0))
    src = args.vq_path or "random(seed 777)"
    print(f"VQ round-trip windowed FGD bound [{src}]: {bound:.6f}")


if __name__ == "__main__":
    main()
