"""The port's run scripts on the CPU. On a tiny CaMN run of the port's CLI:
scripts/torch_replay_check.py replays it from init and reproduces its metrics.jsonl rows
exactly (rtol 0) and its last checkpoint within 1e-6; scripts/torch_diagnose_val_divergence.py
prints finite windowed FGDs of the val split and an equal train subset. The synthetic
BEAT2 has takes long enough for one 64-frame FGD window a clip (128 frames at 30 fps).

The EMAGE train-step ladder of scripts/torch_profile_train.py at a tiny EmageAudioConfig
(dropout 0.1) in float32, one SGD step of each rung from the same weights at iteration 0
(where the random mask is drawn): L5 gives the shipped step's losses and parameters
within 1e-6 relative, the reduced rungs give finite losses, and the WavEncoders get a
gradient from L2 on (zeros before); the timed ladder's deltas sum to the last rung's ms."""
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


def _tiny_emage():
    """A tiny EMAGE model with dropout and its tokenizers (chip_smoke.py's tiny configs)."""
    from pantomatrix_tpu_torch.models.api import (EmageAudioModel, EmageVAEConv, EmageVQModel,
                                                  EmageVQVAEConv)
    from pantomatrix_tpu_torch.models.configs import (EmageAudioConfig, EmageVAEConvConfig,
                                                      EmageVQVAEConvConfig)

    cb = 16
    cfg = EmageAudioConfig(audio_f=32, motion_f=16, hidden_size=32, speaker_dims=4,
                           pose_length=8, seed_frames=2, vae_codebook_size=cb, vae_length=cb,
                           dropout_prob=0.1)
    part = lambda dim, seed: EmageVQVAEConv(
        EmageVQVAEConvConfig(vae_test_dim=dim, vae_length=cb, vae_codebook_size=cb),
        seed=seed, device="cpu")
    vq = EmageVQModel(face=part(106, 1), upper=part(78, 2), hands=part(180, 3),
                      lower=part(61, 4),
                      global_motion=EmageVAEConv(EmageVAEConvConfig(
                          vae_layer=4, vae_length=48, vae_test_dim=61), seed=5, device="cpu"))
    rng = np.random.RandomState(5)
    bs, t = 4, 8
    batch = {"motion": rng.uniform(-0.5, 0.5, (bs, t, 165)),
             "audio": rng.uniform(-1, 1, (bs, t * 533)),
             "expressions": rng.uniform(-1, 1, (bs, t, 100)),
             "trans": rng.uniform(-1, 1, (bs, t, 3)),
             "foot_contact": rng.uniform(size=(bs, t, 4)) < 0.5}
    batch = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in batch.items()}
    return EmageAudioModel(cfg, seed=6, device="cpu"), vq, batch


@pytest.fixture(scope="module")
def ladder():
    return _script("torch_profile_train")


def test_ladder_l5_is_the_shipped_step_and_rungs_build_up(ladder):
    from pantomatrix_tpu_torch.train.optim import make_optimizer

    model, vq, batch = _tiny_emage()
    init = {k: v.clone() for k, v in model.state_dict().items()}
    runs = {}
    for i in range(len(ladder.RUNGS)):
        model.load_state_dict(init)
        opt = make_optimizer(model.parameters(), learning_rate=0.1, optimizer="sgd")
        losses = ladder.make_rung(i, model, vq, opt)(batch, 0)
        wav = [p.grad for name in ("audio_encoder_face", "audio_encoder_body")
               for p in getattr(model, name).parameters()]
        runs[i] = ({k: float(v) for k, v in losses.items()},
                   {k: v.clone() for k, v in model.state_dict().items()},
                   sum(float(g.abs().sum()) for g in wav if g is not None))
    l5, shipped = runs[5], runs[ladder.SHIPPED]
    assert set(l5[0]) == set(shipped[0])
    for k, v in shipped[0].items():
        assert abs(l5[0][k] - v) <= 1e-6 * abs(v), k
    for k, v in shipped[1].items():
        if v.is_floating_point():
            np.testing.assert_allclose(l5[1][k].numpy(), v.numpy(), rtol=1e-6, atol=0,
                                       err_msg=k)
    assert any(not torch.equal(shipped[1][k], v) for k, v in init.items())  # it trained
    for i in range(5):
        assert all(math.isfinite(v) for v in runs[i][0].values()), (i, runs[i][0])
    assert [runs[i][2] > 0 for i in range(len(ladder.RUNGS))] == [False, False] + [True] * 5


def test_ladder_rows_and_deltas(ladder):
    model, vq, batch = _tiny_emage()
    lines = []
    rows = ladder.run_ladder(model, vq, batch, range(len(ladder.RUNGS)), k=1, repeats=1,
                             emit=lines.append)
    assert list(rows) == list(ladder.RUNGS) and len(lines) == len(rows)
    last = rows[ladder.RUNGS[-1]]["ms_per_step"]
    assert math.isclose(sum(r["delta_ms"] for r in rows.values()), last, rel_tol=1e-9)
    for name, r in rows.items():
        assert r["ms_per_step"] > 0, name
        assert r["mfu"] is None and r["device_ms"] is None  # no card, no peak or profile
        assert all(math.isfinite(v) for v in r["first_step_losses"].values()), name
    # L0 has no products; every stage adds some
    flops = [rows[n]["flops_per_step"] for n in ladder.RUNGS[:6]]
    assert flops[0] == 0 and all(a < b for a, b in zip(flops, flops[1:])), flops
