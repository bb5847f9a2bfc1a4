"""Run the motion-serving daemon (``serve_http.MotionServer``) on the GPU (counterpart of
``pantomatrix_tpu/cli/serve.py``): many concurrent interactive audio streams on one
card, their window steps batched into one CUDA graph replay per wave.

    python -m pantomatrix_tpu_torch.cli.serve --model_path <checkpoint root> \
        [--host 0.0.0.0] [--port 8799] [--batch 8] [--device cuda]
    python -m pantomatrix_tpu_torch.cli.serve --random_init   # demo weights

Prints one JSON line with the bound address, then serves until SIGINT.
"""
from __future__ import annotations

import argparse
import json
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8799)
    p.add_argument("--batch", type=int, default=8,
                   help="pump-wave batch: most sessions stepped per device call")
    p.add_argument("--max_sessions", type=int, default=64,
                   help="opens beyond this get HTTP 503 (open streams keep their latency)")
    p.add_argument("--idle_timeout", type=float, default=600.0,
                   help="seconds of no feed or read before a session is evicted")
    p.add_argument("--model_path", type=str, default=None,
                   help="local checkpoint root (audio model + emage_vq/* subdirs)")
    p.add_argument("--random_init", action="store_true",
                   help="random full-width weights instead of a checkpoint")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; the default needs a CUDA card")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    from ..serve_http import MotionServer
    from .test_emage import load_models

    model, vq = load_models(args.model_path, args.random_init, args.device)
    server = MotionServer(model, vq, batch=args.batch, host=args.host, port=args.port,
                          max_sessions=args.max_sessions,
                          idle_timeout_s=args.idle_timeout).start()
    print(json.dumps({"serving": True, "host": server.host, "port": server.port,
                      "batch": args.batch, "max_sessions": args.max_sessions,
                      "device": server.health()["device"]}), flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
