"""The port's run scripts on a tiny CaMN run of the port's CLI on the CPU:
scripts/torch_replay_check.py replays it from init and reproduces its metrics.jsonl rows
exactly (rtol 0) and its last checkpoint within 1e-6; scripts/torch_diagnose_val_divergence.py
prints finite windowed FGDs of the val split and an equal train subset. The synthetic
BEAT2 has takes long enough for one 64-frame FGD window a clip (128 frames at 30 fps)."""
import importlib.util
import json
import math
import os
import sys

import numpy as np
import pytest
import torch

from pantomatrix_tpu_torch.cli import train_camn
from test_data_pipeline import write_wav

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def camn_run(tmp_path_factory):
    """Three 200-frame takes: two train (6 clips), one val (3 clips), clips of 128
    frames; then cli.train_camn --debug (4 steps, a log row each) on them."""
    root = tmp_path_factory.mktemp("scripts_beat2")
    for sub in ("smplxflame_30", "wave16k"):
        (root / sub).mkdir()
    rng = np.random.RandomState(8)
    metas = []
    for i, mode in enumerate(("train", "train", "val")):
        vid, n = f"2_s_0_{i + 1}_{i + 1}", 200
        np.savez(root / "smplxflame_30" / f"{vid}.npz", betas=np.zeros(300, np.float32),
                 poses=rng.uniform(-0.5, 0.5, (n, 165)).astype(np.float32),
                 expressions=rng.uniform(-1, 1, (n, 100)).astype(np.float32),
                 trans=rng.uniform(-1, 1, (n, 3)).astype(np.float32),
                 model="smplx2020", gender="neutral", mocap_frame_rate=30)
        write_wav(root / "wave16k" / f"{vid}.wav",
                  rng.uniform(-0.3, 0.3, n * 16000 // 30).astype(np.float32), 16000)
        for start in (0, 36, 72):
            metas.append({"video_id": vid, "mode": mode, "start_idx": start,
                          "end_idx": start + 128,
                          "motion_path": str(root / "smplxflame_30" / f"{vid}.npz"),
                          "audio_path": str(root / "wave16k" / f"{vid}.wav")})
    meta = root / "meta.json"
    meta.write_text(json.dumps(metas))
    out = tmp_path_factory.mktemp("scripts_run")
    argv = ["prog", "--debug", "--device", "cpu", f"data.meta_paths=['{meta}']",
            f"data.test_meta_paths=['{meta}']", "data.train_bs=2", f"output_dir={out}",
            "log_period=1", "model.hidden_size=32", "model.n_layer=1", "model.dropout_prob=0.0"]
    old = sys.argv
    sys.argv = argv
    try:
        train_camn.main()
    finally:
        sys.argv = old
    (exp,) = os.listdir(out)
    return os.path.join(out, exp)


def test_replay_reproduces_the_run(camn_run, capsys):
    result = _script("torch_replay_check").main(
        ["--run_dir", camn_run, "--steps", "4", "--compare_ckpt", "ckpt/last.bin",
         "--ckpt_step", "4", "--rtol", "0", "--device", "cpu"])
    assert result["rows_checked"] == 4 and result["rows_mismatched"] == 0
    assert result["ckpt_max_diff"] <= 1e-6
    assert "log comparison: 4 rows checked, 0 mismatched" in capsys.readouterr().out


def test_diagnose_val_divergence_prints_both_fgds(camn_run, capsys):
    result = _script("torch_diagnose_val_divergence").main(
        ["--run", camn_run, "--ckpt", "last.bin", "--device", "cpu"])
    assert set(result) == {"val", "train-subset"}
    assert all(math.isfinite(v) for v in result.values()), result
    out = capsys.readouterr().out
    assert "3 clips/split" in out and "windowed FGD [val] @ 4" in out
    assert "windowed FGD [train-subset] @ 4" in out
