"""Replay-from-init determinism check of a training run of the PyTorch/CUDA port, against
the run's own records (the counterpart of scripts/replay_check.py).

It re-executes the first N steps of a finished single-process run from a fresh init,
with the run's resolved config and its deterministic data stream (the host loader,
whose batches equal the device-resident loader's bit for bit), and compares

  1. every logged loss row with the run's ``metrics.jsonl`` (the loop's running means,
     summed in the same order), and
  2. optionally, the replayed state at a checkpoint step with the run's saved
     ``ckpt/{best,last}.bin``, tensor by tensor.

A trajectory that reproduces the log while the saved state differs points at the
checkpoint write rather than at the run. The family comes from the resolved config's
``model.class_name``; EMAGE also needs the frozen tokenizers the run used (``--vq_path``,
or ``--random_vq`` for the seed-777 random suite).

Usage (from the repository root):
  python scripts/torch_replay_check.py --run_dir outputs/<exp> --steps 550 \\
      [--compare_ckpt ckpt/best.bin --ckpt_step 500] [--rtol 5e-3] [--device cuda|cpu]
Exits 1 when a logged row mismatches.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build(cfg, args, device):
    """(model, optimizer, step, loader) as the run's CLI built them (its
    ``build_training``), on one process."""
    family = {"DiscoAudioModel": "disco", "CamnAudioModel": "camn",
              "EmageAudioModel": "emage"}[cfg.model.class_name]
    if family == "emage":
        from pantomatrix_tpu_torch.cli import train_emage

        suite = train_emage.load_suite(args.vq_path, args.random_vq, device)
        return train_emage.build_training(cfg, device, suite)
    if family == "camn":
        from pantomatrix_tpu_torch.cli.train_camn import build_training
    else:
        from pantomatrix_tpu_torch.cli.train_disco import build_training
    return build_training(cfg, device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--run_dir", required=True,
                    help="a run's output dir with sanity_check/resolved_config.yaml")
    ap.add_argument("--steps", type=int, default=550)
    ap.add_argument("--compare_ckpt", default=None,
                    help="run-dir-relative train state (e.g. ckpt/best.bin)")
    ap.add_argument("--ckpt_step", type=int, default=500,
                    help="replay step at which to snapshot the state for --compare_ckpt")
    ap.add_argument("--vq_path", default=None)
    ap.add_argument("--random_vq", action="store_true")
    ap.add_argument("--rtol", type=float, default=5e-3,
                    help="relative tolerance on logged loss rows (0: exact)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from pantomatrix_tpu_torch.data.beat2 import to_device
    from pantomatrix_tpu_torch.models.api import resolve_device
    from pantomatrix_tpu_torch.train.loop import Meters
    from pantomatrix_tpu_torch.utils.config import load_config

    device = resolve_device(args.device)
    cfg = load_config(os.path.join(args.run_dir, "sanity_check", "resolved_config.yaml"), [])
    model, _, step, loader = build(cfg, args, device)

    logged = {}
    for line in open(os.path.join(args.run_dir, "metrics.jsonl")):
        r = json.loads(line)
        if not any(k.startswith(("val/", "test/")) for k in r):
            logged[int(r["step"])] = r

    log_period = int(cfg.get("log_period", 50))
    meters, snap = Meters(), None
    n_checked = n_bad = it = epoch = 0
    while it < args.steps:
        loader.set_epoch(epoch)
        for batch in loader:
            meters.update(step(to_device(batch, device), it))
            it += 1
            if it % log_period == 0:
                means = meters.means()
                meters.reset()
                row, status = logged.get(it), "(not in log)"
                if row is not None:
                    bad = [k for k, v in means.items() if k in row
                           and abs(v - row[k]) > args.rtol * max(abs(row[k]), 1e-6)]
                    n_checked += 1
                    n_bad += bool(bad)
                    status = "MISMATCH " + ",".join(bad) if bad else "ok"
                print(f"step {it}: " + " ".join(f"{k}={v:.4f}" for k, v in sorted(means.items()))
                      + f"  [{status}]", flush=True)
            if it == args.ckpt_step:
                snap = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
            if it >= args.steps:
                break
        epoch += 1

    print(f"log comparison: {n_checked} rows checked, {n_bad} mismatched (rtol {args.rtol})")
    result = {"rows_checked": n_checked, "rows_mismatched": n_bad}
    if args.compare_ckpt:
        if snap is None:
            sys.exit(f"--ckpt_step {args.ckpt_step} is beyond --steps {args.steps}")
        saved = torch.load(os.path.join(args.run_dir, args.compare_ckpt), map_location="cpu",
                           weights_only=True)["model"]
        diffs = {k: float((saved[k].double() - v.double()).abs().max()) if v.numel() else 0.0
                 for k, v in snap.items()}
        worst = max(diffs.values())
        print(f"replayed state@{args.ckpt_step} vs {args.compare_ckpt}: max tensor diff = "
              f"{worst:.6g}")
        for k in sorted(diffs, key=diffs.get, reverse=True)[:8]:
            print(f"  {k} {tuple(snap[k].shape)} diff {diffs[k]:.6g}")
        result["ckpt_max_diff"] = worst
    if n_bad:
        sys.exit(1)
    return result


if __name__ == "__main__":
    main()
