"""The port's evaluation (pantomatrix_tpu_torch.eval, data.preprocess) against the JAX
package on the CPU: the DSP and metrics, FGD with the statistics embedder and with an
AESKConv encoder whose random state dict both packages import, FGD's file gates, the clip
index and evaluate_clips (tests/test_torch_eval_flow.py holds the test flow's generate
functions; this file also builds the inputs that those tests and
tests/test_torch_evaluate_cli*.py share).

The SMPL-X archive is a synthetic one with the real archive's key layout at V = 24
(tests/test_torch_smplx.py); the takes are a synthetic BEAT2 layout made from a numpy
seed, long enough (over 4 s) for BC to score them. Model weights are drawn by the port's
init and handed to the JAX package as its param trees. Tolerances: FGD 1e-4 relative;
BC scores and beat times equal; L1div, LVD, MSE 1e-5 relative; AESKConv features 1e-5;
decoded rotations 2e-3 (the reference's sqrt-based matrix -> quaternion step,
tests/test_torch_emage.py); expressions and translations 1e-5.
"""
import csv
import json
import os
import wave

import jax
import numpy as np
import pytest
import torch

from pantomatrix_tpu.core import smplx as jsmplx
from pantomatrix_tpu.data import preprocess as jpreprocess
from pantomatrix_tpu.eval import dsp as jdsp
from pantomatrix_tpu.eval import fgd_encoder as jfgd
from pantomatrix_tpu.eval import metrics as jmetrics
from pantomatrix_tpu.eval import pipeline as jpipeline
from pantomatrix_tpu.eval import test_flow as jflow
from pantomatrix_tpu.io import beat_format as jbeat
from pantomatrix_tpu.models import api as japi
from pantomatrix_tpu.models import configs as jcfgs
from pantomatrix_tpu_torch.core import smplx
from pantomatrix_tpu_torch.data import preprocess
from pantomatrix_tpu_torch.eval import dsp, fgd_encoder, mertic, metrics, pipeline, test_flow
from pantomatrix_tpu_torch.io.hf_checkpoint import unflatten_params
from pantomatrix_tpu_torch.models import api, configs
from test_torch_smplx import write_archive

torch.set_num_threads(2)

FGD_RTOL = 1e-4
RTOL = 1e-5
ROT_ATOL = 2e-3
ATOL = 1e-5
CB = 16
EMAGE_KW = dict(audio_f=32, motion_f=16, hidden_size=32, speaker_dims=4, pose_length=8,
                seed_frames=2, vae_codebook_size=CB, vae_length=CB, dropout_prob=0.0)
LSTM_KW = dict(hidden_size=32, n_layer=1)
PART_DIMS = {"face": 106, "upper": 78, "hands": 180, "lower": 61}
GLOBAL_KW = dict(vae_length=24, vae_test_dim=61)
# (video id, split, frames at 30 fps): two test takes over 4 s, one train take, and a
# take of another speaker
TAKES = [("2_scott_0_1_1", "test", 200), ("2_scott_0_2_2", "test", 160),
         ("2_scott_0_3_3", "train", 80), ("4_lawrence_0_1_1", "test", 80)]


def np_tree(module):
    """A port module's weights as the JAX package's param tree of numpy arrays."""
    return unflatten_params({k: v.numpy() for k, v in module.state_dict().items()})


def write_wav(path, x, sr=16000):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())


def speech_like(n, rng, sr=16000):
    """Noise bursts on a quiet floor, so the onset detector finds beats."""
    x = rng.normal(0, 0.01, n)
    for start in rng.randint(0, max(n - 2000, 1), n // 6000):
        x[start:start + 1600] += rng.normal(0, 0.3, 1600) * np.hanning(1600)
    return x.astype(np.float32)


def write_beat2(root, takes=TAKES, seed=0):
    """A BEAT2 layout: train_test_split.csv, smplxflame_30/*.npz (betas 300, poses
    (t, 165), expressions (t, 100), trans (t, 3)), footcontact/*.npy and wave16k/*.wav."""
    rng = np.random.RandomState(seed)
    for sub in ("smplxflame_30", "footcontact", "wave16k"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    rows = [("id", "type")]
    for vid, mode, t in takes:
        poses = np.cumsum(rng.normal(0, 0.03, (t, 165)), axis=0) + rng.uniform(-0.3, 0.3, 165)
        np.savez(os.path.join(root, "smplxflame_30", f"{vid}.npz"),
                 betas=rng.normal(0, 1, 300).astype(np.float32),
                 poses=poses.astype(np.float32),
                 expressions=rng.normal(0, 0.5, (t, 100)).astype(np.float32),
                 trans=np.cumsum(rng.normal(0, 0.01, (t, 3)), axis=0).astype(np.float32),
                 model="smplx2020", gender="neutral", mocap_frame_rate=30)
        np.save(os.path.join(root, "footcontact", f"{vid}.npy"),
                (rng.uniform(size=(t, 4)) < 0.5).astype(np.float32))
        write_wav(os.path.join(root, "wave16k", f"{vid}.wav"), speech_like(t * 16000 // 30, rng))
        rows.append((vid, mode))
    with open(os.path.join(root, "train_test_split.csv"), "w", newline="") as f:
        csv.writer(f).writerows(rows)
    return root


def write_aeskconv(path, seed=0):
    """A random AESKConv state dict at make_plan()'s shapes, saved as the weight file is."""
    enc = fgd_encoder.AESKConv(generator=torch.Generator().manual_seed(seed))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({f"encoder.{k}": v for k, v in enc.state_dict().items()}, path)
    return path


def write_checkpoints(root, family, seed=0):
    """A port checkpoint of the tiny config of ``family`` (EMAGE with its tokenizers
    under emage_vq/, unit-scale codebooks) and the JAX package's model on the same
    weights. Returns (port model, port vq or None, JAX model, JAX vq or None)."""
    if family in ("camn", "disco"):
        port_cls, cfg_cls, jcls, jcfg_cls = {
            "camn": (api.CamnAudioModel, configs.CamnAudioConfig,
                     japi.CamnAudioModel, jcfgs.CamnAudioConfig),
            "disco": (api.DiscoAudioModel, configs.DiscoAudioConfig,
                      japi.DiscoAudioModel, jcfgs.DiscoAudioConfig)}[family]
        model = port_cls(cfg_cls(**LSTM_KW), seed=seed, device="cpu")
        model.save_pretrained(root)
        return model, None, jcls(jcfg_cls(**LSTM_KW), np_tree(model)), None
    model = api.EmageAudioModel(configs.EmageAudioConfig(**EMAGE_KW), seed=seed, device="cpu")
    model.save_pretrained(root)
    g = torch.Generator().manual_seed(seed + 1)
    parts = {}
    for i, (name, dim) in enumerate(PART_DIMS.items()):
        part = api.EmageVQVAEConv(configs.EmageVQVAEConvConfig(
            vae_test_dim=dim, vae_length=CB, vae_codebook_size=CB), seed=seed + 10 + i,
            device="cpu")
        with torch.no_grad():
            part.quantizer.embedding.weight.copy_(torch.randn(CB, CB, generator=g))
        part.save_pretrained(os.path.join(root, "emage_vq", name))
        parts[name] = part
    glob = api.EmageVAEConv(configs.EmageVAEConvConfig(**GLOBAL_KW), seed=seed + 20,
                            device="cpu")
    glob.save_pretrained(os.path.join(root, "emage_vq", "global"))
    vq = api.EmageVQModel(global_motion=glob, **parts)
    jvq = japi.EmageVQModel(
        global_motion=japi.EmageVAEConv(jcfgs.EmageVAEConvConfig(**GLOBAL_KW), np_tree(glob)),
        **{name: japi.EmageVQVAEConv(jcfgs.EmageVQVAEConvConfig(
            vae_test_dim=dim, vae_length=CB, vae_codebook_size=CB), np_tree(parts[name]))
           for name, dim in PART_DIMS.items()})
    jmodel = japi.EmageAudioModel(jcfgs.EmageAudioConfig(**EMAGE_KW), np_tree(model))
    return model, vq, jmodel, jvq


def assert_metrics_match(got, want):
    assert set(got) == set(want)
    assert got["fgd_embedder"] == want["fgd_embedder"]
    np.testing.assert_allclose(got["fgd"], want["fgd"], rtol=FGD_RTOL, err_msg="fgd")
    if "bc" in want:
        assert got["bc"] == want["bc"]
    for k in ("l1", "lvd", "mse"):
        if k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)


@pytest.fixture(scope="module")
def beat2(tmp_path_factory):
    return write_beat2(str(tmp_path_factory.mktemp("beat2")))


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    return write_archive(tmp_path_factory.mktemp("smplx") / "SMPLX_NEUTRAL_2020.npz")


@pytest.fixture(scope="module")
def aeskconv_file(tmp_path_factory):
    return write_aeskconv(str(tmp_path_factory.mktemp("evaltools") / "emage_evaltools"
                              / "AESKConv_240_100.bin"))


def _test_list(beat2):
    return [{"video_id": vid, "motion_path": os.path.join(beat2, "smplxflame_30", f"{vid}.npz"),
             "audio_path": os.path.join(beat2, "wave16k", f"{vid}.wav"), "mode": mode}
            for vid, mode, _ in TAKES if mode == "test" and vid.startswith("2_")]


def test_dsp_matches_jax():
    rng = np.random.RandomState(0)
    y = speech_like(16000 * 3, rng)
    np.testing.assert_array_equal(dsp.stft_mag(y), jdsp.stft_mag(y))
    np.testing.assert_array_equal(dsp.onset_strength(y, 16000), jdsp.onset_strength(y, 16000))
    got, want = dsp.onset_detect(y, 16000), jdsp.onset_detect(y, 16000)
    assert len(got) > 3
    np.testing.assert_array_equal(got, want)


def test_make_plan_matches_jax():
    got, want = fgd_encoder.make_plan(), jfgd.make_plan()
    assert (got.in_channels, got.out_channels) == (want.in_channels, want.out_channels) == (330, 240)
    for a, b in zip(got.layers, want.layers, strict=True):
        np.testing.assert_array_equal(a.mask, b.mask)
        np.testing.assert_array_equal(a.pool_weight, b.pool_weight)


def test_aeskconv_import_and_features_match_jax(aeskconv_file):
    raw = {k: v.numpy() for k, v in torch.load(aeskconv_file).items()}
    params = fgd_encoder.params_from_state_dict(dict(raw))
    jparams = jfgd.params_from_state_dict(dict(raw))
    assert jax.tree_util.tree_structure(params) == jax.tree_util.tree_structure(jparams)
    for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(a, b)
    windows = np.random.RandomState(1).normal(0, 0.5, (5, 64, 330)).astype(np.float32)
    emb, jemb = fgd_encoder.load_aeskconv(aeskconv_file, "cpu"), jfgd.load_aeskconv(aeskconv_file)
    got, want = emb(windows), jemb(windows)
    assert got.shape == want.shape == (5 * 4, 240)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # the prefixes and wrappers the importer takes
    wrapped = {"model_state": {f"module.{k}": v for k, v in raw.items()}}
    for a, b in zip(jax.tree_util.tree_leaves(fgd_encoder.params_from_state_dict(wrapped)),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    bad = dict(raw, **{"encoder.layers.1.0.weight": raw["encoder.layers.1.0.weight"][:, :-1]})
    with pytest.raises(ValueError, match="topology"):
        fgd_encoder.params_from_state_dict(bad)
    with pytest.raises(KeyError, match="missing"):
        fgd_encoder.params_from_state_dict({"decoder.x": np.zeros(1)})


@pytest.mark.parametrize("embedder", ["stats", "aeskconv"])
def test_fgd_matches_jax(aeskconv_file, tmp_path, embedder):
    path = os.path.dirname(aeskconv_file) if embedder == "aeskconv" else str(tmp_path)
    fgd = metrics.FGD(path, device="cpu")
    jfgd_metric = jmetrics.FGD(path)
    assert fgd.embedder_kind == jfgd_metric.embedder_kind == embedder
    rng = np.random.RandomState(2)
    for t in (300, 200, 130, 40):
        gt = rng.normal(0, 0.5, (1, t, 330)).astype(np.float32)
        pred = gt + rng.normal(0, 0.2, gt.shape).astype(np.float32)
        fgd.update(pred, gt)
        jfgd_metric.update(pred, gt)
    got, want = fgd.compute(), jfgd_metric.compute()
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, want, rtol=FGD_RTOL)
    fgd.reset()
    assert np.isnan(fgd.compute())


def test_fgd_file_gates_match_jax(tmp_path, capsys):
    corrupt = tmp_path / "corrupt"
    corrupt.mkdir()
    (corrupt / "AESKConv_240_100.bin").write_bytes(b"not a torch pickle")
    assert metrics.FGD(str(corrupt), device="cpu").embedder_kind == "stats"
    assert jmetrics.FGD(str(corrupt)).embedder_kind == "stats"
    assert capsys.readouterr().out.count("falling back to the statistics embedding") == 2
    for make in (lambda: metrics.FGD(str(corrupt), strict=True, device="cpu"),
                 lambda: jmetrics.FGD(str(corrupt), strict=True)):
        with pytest.raises(RuntimeError, match="strict mode"):
            make()
    for make in (lambda: metrics.FGD(str(tmp_path), strict=True, device="cpu"),
                 lambda: jmetrics.FGD(str(tmp_path), strict=True)):
        with pytest.raises(FileNotFoundError, match="strict mode"):
            make()


def test_fgd_gate_covers_reading_the_file_only(aeskconv_file, capsys):
    """A fault building the encoder on its device raises; it does not fall back."""
    with pytest.raises((RuntimeError, AssertionError)):
        metrics.FGD(os.path.dirname(aeskconv_file), device="cuda:99")
    assert "falling back" not in capsys.readouterr().out


def test_bc_l1_lvd_mse_match_jax():
    rng = np.random.RandomState(3)
    y = speech_like(16000 * 6, rng)
    pos = np.cumsum(rng.normal(0, 0.02, (180, 55 * 3)), axis=0).astype(np.float32)
    bc, jbc = mertic.BC(sigma=0.3, order=7), jmetrics.BC(sigma=0.3, order=7)
    a_got = bc.load_audio(y, t_start=32000, t_end=64000, without_file=True)
    a_want = jbc.load_audio(y, t_start=32000, t_end=64000, without_file=True)
    np.testing.assert_array_equal(a_got, a_want)
    m_got, m_want = bc.load_motion(pos, 60, 120), jbc.load_motion(pos, 60, 120)
    assert len(m_got) > 0
    np.testing.assert_array_equal(m_got, m_want)
    assert bc.compute(a_got, m_got, 60) == jbc.compute(a_want, m_want, 60)
    assert bc.avg() == jbc.avg()
    for cls, jcls, args in ((mertic.L1div, jmetrics.L1div, (pos,)),
                            (mertic.LVDFace, jmetrics.LVDFace, (pos, pos[::-1] * 0.9)),
                            (mertic.MSEFace, jmetrics.MSEFace, (pos, pos[:150] + 0.01))):
        m, jm = cls(), jcls()
        np.testing.assert_allclose(m.compute(*args), jm.compute(*args), rtol=RTOL)
        np.testing.assert_allclose(m.avg(), jm.avg(), rtol=RTOL)


def test_clip_index_and_unique_test_clips_match_jax(beat2, tmp_path):
    got = preprocess.build_clip_index(beat2, str(tmp_path / "port"), stride=20, motion_length=64)
    want = jpreprocess.build_clip_index(beat2, str(tmp_path / "jax"), stride=20,
                                        motion_length=64)
    assert os.path.basename(got) == os.path.basename(want) == "beat2_s20_l64_speaker2.json"
    assert json.load(open(got)) == json.load(open(want))
    clips = test_flow.unique_test_clips([got])
    assert clips == jflow.unique_test_clips([want])
    assert [c["video_id"] for c in clips] == ["2_scott_0_1_1", "2_scott_0_2_2"]


@pytest.mark.parametrize("with_face", [True, False])
def test_evaluate_clips_matches_jax(beat2, archive, aeskconv_file, tmp_path, with_face):
    gt_list = _test_list(beat2)
    rng = np.random.RandomState(4)
    pred_list = []
    for meta in gt_list:
        gt = dict(np.load(meta["motion_path"]))
        t = gt["poses"].shape[0] - 7  # prediction shorter than the take
        path = str(tmp_path / f"{meta['video_id']}_output.npz")
        jbeat.beat_format_save(path, gt["poses"][:t] + rng.normal(0, 0.05, (t, 165)),
                               expressions=gt["expressions"][:t] * 0.8,
                               trans=gt["trans"][:t])
        pred_list.append({"video_id": meta["video_id"], "motion_path": path})
    kw = dict(pose_fps=30, with_face=with_face, download_path=os.path.dirname(aeskconv_file))
    got = pipeline.evaluate_clips(gt_list, pred_list, smplx.load_smplx(archive, "cpu"),
                                  device="cpu", **kw)
    want = jpipeline.evaluate_clips(gt_list, pred_list, jsmplx.load_smplx(archive), **kw)
    assert set(got) == ({"fgd", "fgd_embedder", "bc", "l1", "lvd", "mse"} if with_face
                        else {"fgd", "fgd_embedder", "bc", "l1"})
    assert 0 < got["bc"] < 1  # beats were found and scored
    assert_metrics_match(got, want)
    # without the SMPL-X model: FGD only
    got = pipeline.evaluate_clips(gt_list, pred_list, device="cpu", **kw)
    want = jpipeline.evaluate_clips(gt_list, pred_list, **kw)
    assert set(got) == {"fgd", "fgd_embedder"}
    assert_metrics_match(got, want)
