"""Dataset preprocessing (counterpart of ``pantomatrix_tpu/cli/preprocess.py``): the
reference's three scripts (process_testdata.py, foot_contact.py, clustering.py) as
subcommands over ``data/preprocess.py``. The foot-contact FK runs on ``--device``
(default cuda; raises without a card); the DisCo labels use the port's own k-means.

Usage:
  python -m pantomatrix_tpu_torch.cli.preprocess index --beat2_root <dir> \\
      --output_dir ./data_json [--stride 20 --length 64 --speaker 2]
  python -m pantomatrix_tpu_torch.cli.preprocess footcontact \\
      --motion_dir <dir>/smplxflame_30 --output_dir <dir>/footcontact [--device cpu]
  python -m pantomatrix_tpu_torch.cli.preprocess disco --json <clip index json>
"""
from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)

    pi = sub.add_parser("index", help="build the clip-metadata JSON")
    pi.add_argument("--beat2_root", required=True)
    pi.add_argument("--output_dir", required=True)
    pi.add_argument("--stride", type=int, default=20)
    pi.add_argument("--length", type=int, default=64)
    pi.add_argument("--speaker", type=int, default=2)
    pi.add_argument("--use_additional", action="store_true")

    pf = sub.add_parser("footcontact", help="extract per-take (t,4) foot contact")
    pf.add_argument("--motion_dir", required=True)
    pf.add_argument("--output_dir", required=True)
    pf.add_argument("--threshold", type=float, default=0.01)
    pf.add_argument("--device", type=str, default="cuda",
                    help="cuda (default; raises without a card) or cpu")

    pd = sub.add_parser("disco", help="add k-means content/rhythm labels to an index")
    pd.add_argument("--json", required=True)
    pd.add_argument("--output", default=None)
    pd.add_argument("--clusters", type=int, default=10)

    args = p.parse_args(argv)
    from ..data import preprocess

    if args.cmd == "index":
        print(preprocess.build_clip_index(
            args.beat2_root, args.output_dir, stride=args.stride, motion_length=args.length,
            speaker_target=args.speaker, use_additional=args.use_additional))
    elif args.cmd == "footcontact":
        preprocess.extract_foot_contact(args.motion_dir, args.output_dir,
                                        threshold=args.threshold, device=args.device)
        print(args.output_dir)
    elif args.cmd == "disco":
        print(preprocess.build_disco_labels(args.json, args.output, n_clusters=args.clusters))


if __name__ == "__main__":
    main()
