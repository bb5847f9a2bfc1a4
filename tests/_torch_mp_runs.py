"""The tiny multi-process training runs of the port, shared by
tests/test_torch_multiprocess.py (on the CPU over gloo) and chip_smoke.py phase 21b (on
the card): the train CLIs' argv, the data set they train on, the launcher, and the
comparison that holds two processes to one at the bounds the test's docstring explains.
Imports neither JAX nor the JAX package.
"""
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 600  # seconds for all the processes of one start_runs

EMAGE_ARGV = [
    "--random_vq", "--evaluation", "data.train_bs=8", "log_period=2",
    "solver.max_train_steps=4", "solver.steps_per_dispatch=2", "solver.optimizer=sgd",
    "solver.compute_dtype=float32", "validation.validation_steps=4",
    "validation.test_steps=4", "model.hidden_size=32", "model.n_layer=1",
    "model.dropout_prob=0.1", "model.audio_f=32", "model.motion_f=16",
    "model.speaker_dims=4", "model.pose_length=32", "model.seed_frames=4",
    "model.vae_codebook_size=256", "model.vae_length=256",
]
DISCO_ARGV = [
    "data.train_bs=8", "log_period=2", "solver.max_train_steps=4",
    "solver.steps_per_dispatch=2", "solver.optimizer=sgd",
    "solver.compute_dtype=float32", "validation.validation_steps=4",
    "model.hidden_size=32", "model.n_layer=2", "model.dropout_prob=0.1",
]
RUNS = {  # name: (CLI, argv, processes)
    "emage_single": ("train_emage", EMAGE_ARGV, 1),
    "emage_dp": ("train_emage", EMAGE_ARGV, 2),
    "emage_fsdp": ("train_emage", EMAGE_ARGV + ["solver.fsdp_model_axis=2"], 2),
    "disco_single": ("train_disco", DISCO_ARGV, 1),
    "disco_dp": ("train_disco", DISCO_ARGV, 2),
}
PARAM_RTOL = 1e-5
BOUNDS = {  # two-process run: (loss rtol, parameter atol) against its single run
    "emage_dp": (1e-5, 1e-6), "emage_fsdp": (1e-5, 2e-6), "disco_dp": (5e-5, 1e-5)}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def write_wav(path, x, sr):
    import wave

    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())


def write_data(root: Path):
    """tests/test_multiprocess.py's set: 16 train clips (2 windows x 8 synthetic takes of
    40 frames) and 2 test clips, with DisCo's labels. Returns (train meta, test meta)."""
    root = Path(root)
    for sub in ("smplxflame_30", "footcontact", "wave16k"):
        (root / sub).mkdir(parents=True)
    rng = np.random.RandomState(7)
    train, test = [], []
    for v in range(8):
        vid, n = f"2_mp_0_{v}_{v}", 40
        np.savez(root / "smplxflame_30" / f"{vid}.npz", betas=np.zeros(300, np.float32),
                 poses=rng.uniform(-0.5, 0.5, (n, 165)).astype(np.float32),
                 expressions=rng.uniform(-1, 1, (n, 100)).astype(np.float32),
                 trans=rng.uniform(-1, 1, (n, 3)).astype(np.float32),
                 model="smplx2020", gender="neutral", mocap_frame_rate=30)
        np.save(root / "footcontact" / f"{vid}.npy",
                (rng.uniform(size=(n, 4)) < 0.5).astype(np.float32))
        write_wav(root / "wave16k" / f"{vid}.wav",
                  rng.uniform(-0.3, 0.3, n * 16000 // 30).astype(np.float32), 16000)
        for j, start in enumerate((0, 8)):
            train.append({"video_id": vid, "mode": "train",
                          "motion_path": str(root / "smplxflame_30" / f"{vid}.npz"),
                          "audio_path": str(root / "wave16k" / f"{vid}.wav"),
                          "start_idx": start, "end_idx": start + 32,
                          "content_label": (v + j) % 3, "rhythm_label": v % 2})
        if v < 2:
            test.append({**train[-1], "mode": "test"})
    (root / "meta_train.json").write_text(json.dumps(train))
    (root / "meta_test.json").write_text(json.dumps(test))
    return str(root / "meta_train.json"), str(root / "meta_test.json")


def launch(cli, argv, out, rank, world, port, log_path, device):
    """``python -m pantomatrix_tpu_torch.cli.<cli>``, rank ``rank`` of ``world`` processes
    on this host (the ``PANTO_*`` variables and the local ones); (process, open log)."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    if world > 1:
        env.update(PANTO_COORDINATOR=f"localhost:{port}", PANTO_NUM_PROCESSES=str(world),
                   PANTO_PROCESS_ID=str(rank), LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE=str(world))
    log = open(log_path, "w")
    proc = subprocess.Popen([sys.executable, "-m", f"pantomatrix_tpu_torch.cli.{cli}",
                             "--device", device, *argv, f"output_dir={out}"],
                            env=env, cwd=str(REPO), stdout=log, stderr=subprocess.STDOUT)
    return proc, log


def start_runs(runs, argv, root: Path, device, timeout=TIMEOUT):
    """Every run of ``runs`` ({name: (CLI, argv, processes)}, the rank's output in
    ``root/<name>_<rank>``) with ``argv`` in front, all started together and waited for;
    a process still running at ``timeout`` is killed. Returns {name: [output dir of each
    rank]}; raises RuntimeError with the failed processes' logs."""
    root = Path(root)
    procs, outs = [], {}
    for name, (cli, run_argv, world) in runs.items():
        port = free_port()
        outs[name] = []
        for rank in range(world):
            tag = f"{name}_{rank}"
            outs[name].append(str(root / tag))
            procs.append((tag, *launch(cli, list(argv) + list(run_argv), root / tag, rank,
                                       world, port, root / f"{tag}.log", device)))
    deadline, failed = time.time() + timeout, []
    try:
        for tag, proc, log in procs:
            try:
                rc = proc.wait(timeout=max(deadline - time.time(), 1))
            except subprocess.TimeoutExpired:
                rc = "timeout"
            log.close()
            if rc != 0:
                failed.append((tag, rc))
    finally:
        for _, proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError(f"runs failed: {failed}\n" + "\n".join(
            f"--- {tag} ({rc}):\n{(root / f'{tag}.log').read_text()[-3000:]}"
            for tag, rc in failed))
    return outs


def exp_dir(out) -> str:
    (exp,) = os.listdir(out)
    return os.path.join(out, exp)


def metrics(out):
    return [json.loads(x) for x in open(os.path.join(exp_dir(out), "metrics.jsonl"))]


def last_state(out):
    return torch.load(os.path.join(exp_dir(out), "ckpt", "last.bin"), map_location="cpu",
                      weights_only=True)


def compare_runs(single, ranks, bounds) -> dict:
    """Rank 0 of a multi-process run (``ranks``: its ranks' output dirs) against the
    single-process run: the same logged steps and keys, every loss within ``bounds[0]``
    relative (finite where the single run's is), the last checkpoint's iteration and
    weights within ``bounds[1]`` + PARAM_RTOL relative; the other ranks wrote no
    checkpoint and no metrics. Raises AssertionError; returns the errors."""
    loss_rtol, atol = bounds
    ls, lm = metrics(single), metrics(ranks[0])
    steps = [x["step"] for x in lm]
    keys_agree = [x["step"] for x in ls] == steps and all(a.keys() == b.keys()
                                                         for a, b in zip(ls, lm))
    finite_agree, loss_rel = True, 0.0
    for a, b in zip(ls, lm):
        for k in a:
            if k == "step":
                continue
            finite_agree &= bool(np.isfinite(a[k]) == np.isfinite(b.get(k, np.nan)))
            if np.isfinite(a[k]) and k in b:
                loss_rel = max(loss_rel, abs(b[k] - a[k]) / max(abs(a[k]), 1e-30))
    want, got = last_state(single), last_state(ranks[0])
    ws, gs = want["model"], got["model"]
    excess = max(float(((gs[k].double() - v.double()).abs() - atol
                        - PARAM_RTOL * v.double().abs()).clamp_min(0).max())
                 for k, v in ws.items() if v.is_floating_point())
    others_wrote = [r for r in ranks[1:] if any(
        os.path.exists(os.path.join(exp_dir(r), f)) for f in ("ckpt/last.bin", "metrics.jsonl"))]
    row = {"steps": steps, "loss_max_rel_err": loss_rel, "param_excess_over_bound": excess,
           "iteration": got["iteration"], "losses_bitwise": ls == lm,
           "params_bitwise": all(torch.equal(gs[k], v) for k, v in ws.items())}
    if not (keys_agree and finite_agree and loss_rel <= loss_rtol and excess == 0
            and ws.keys() == gs.keys() and got["iteration"] == want["iteration"]
            and not others_wrote):
        raise AssertionError(f"{ranks[0]} against {single}: {row}; keys agree {keys_agree}, "
                             f"finite agree {finite_agree}, other ranks wrote {others_wrote}")
    return row
