"""The port's renders end to end on the CPU, against the JAX package: render2d / render3d
(the frames that reach the writer), the four mesh-video calls (frame counts, audio,
decoded frames), the test CLIs with --visualization, and a train CLI whose test pass
renders (a ``--debug --evaluation --visualization`` run).

Synthetic SMPL-X archives over a small closed surface (``tests/test_torch_viz.py``);
motions and audio from numpy seeds. Bounds: skeleton frames differ from the JAX (cv2)
frames in at most 2% of the pixels either lights (the drawing itself is exact; the two
FKs' ~1e-6 apart can move a truncated joint by a pixel); mesh videos: the same frame count
and audio bytes as the JAX files, decoded frames within a mean absolute difference of 2
grey levels.
"""
import json
import os
import sys

import cv2
import numpy as np
import pytest
import torch

from pantomatrix_tpu.core import smplx as jsmplx
from pantomatrix_tpu.viz import mesh_video as jmesh
from pantomatrix_tpu.viz import render2d as jrender
from pantomatrix_tpu_torch.core import smplx
from pantomatrix_tpu_torch.viz import avi, mesh_video, render2d

from test_data_pipeline import write_wav
from test_torch_viz import motion, write_surface_archive

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    return write_surface_archive(tmp_path_factory.mktemp("viz_render") / "SMPLX_NEUTRAL_2020.npz")


@pytest.fixture(scope="module")
def models(archive):
    return jsmplx.load_smplx(archive), smplx.load_smplx(archive, "cpu")


@pytest.mark.parametrize("kind,face_only", [("2d", False), ("2d", True), ("3d", False)])
def test_render_frames_match_the_jax_frames(models, tmp_path, monkeypatch, kind, face_only):
    jm, pm = models
    monkeypatch.setattr(render2d, "FRAMES_PER_CHUNK", 8)
    data = motion(31, seed=11)  # four chunks, as many frames as the mesh videos
    want, got = [], []
    monkeypatch.setattr(jrender, "write_video",
                        lambda frames, path, fps=30: want.extend(frames) or path)
    draw_frames = render2d.draw_frames

    def keep(*a, **kw):
        out = draw_frames(*a, **kw)
        got.append(out.numpy())
        return out

    monkeypatch.setattr(render2d, "draw_frames", keep)
    jcall = jrender.render2d if kind == "2d" else jrender.render3d
    pcall = render2d.render2d if kind == "2d" else render2d.render3d
    size = {"height": 96, "width": 64} if kind == "3d" else {}
    jcall(data, str(tmp_path / "j.mp4"), model=jm, face_only=face_only, **size)
    out = pcall(data, str(tmp_path / "p.mp4"), model=pm, face_only=face_only, **size)
    assert out == str(tmp_path / "p.avi")
    got, want = np.concatenate(got), np.stack(want)
    assert got.shape == want.shape and got.any()
    # the drawing equals cv2's on the same joints (test_torch_viz.py); end to end the two
    # FKs differ by ~1e-6, which can move a truncated joint by a pixel
    differ = (got != want).any(-1).sum()
    assert differ <= 0.02 * (got.any(-1) | want.any(-1)).sum()
    written = avi.read_avi(out)
    assert len(written["jpegs"]) == 31 and written["fps"] == 30


def _decoded(path):
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f.astype(np.int16))
    cap.release()
    return np.stack(frames)


@pytest.mark.parametrize("call", ["render_one_sequence", "render_one_sequence_no_gt",
                                  "render_one_sequence_with_face",
                                  "render_one_sequence_face_only"])
def test_mesh_videos_match_jax(models, tmp_path, monkeypatch, call):
    jm, pm = models
    n = 31
    np.savez(tmp_path / "pred.npz", **motion(n, seed=12))
    np.savez(tmp_path / "gt.npz", **motion(n, seed=13))
    rng = np.random.RandomState(14)
    write_wav(tmp_path / "take.wav", rng.uniform(-0.3, 0.3, n * 16000 // 30).astype(np.float32),
              16000)
    monkeypatch.setitem(jmesh.RENDER_ARGS, "debug", True)
    monkeypatch.setitem(mesh_video.RENDER_ARGS, "debug", True)
    outs = {}
    for tag, module, model in (("jax", jmesh, jm), ("port", mesh_video, pm)):
        args = [str(tmp_path / "pred.npz")]
        if call == "render_one_sequence":
            args.append(str(tmp_path / "gt.npz"))
        outs[tag] = getattr(module, call)(*args, str(tmp_path / tag), str(tmp_path / "take.wav"),
                                          model=model)
    assert outs["port"].endswith(os.path.join("port", "pred.avi"))
    assert not os.path.exists(tmp_path / "port" / "silence_video.avi")
    ours, theirs = avi.read_avi(outs["port"]), avi.read_avi(outs["jax"])
    assert len(ours["jpegs"]) == len(theirs["jpegs"]) == 30
    assert ours["audio"].tobytes() == theirs["audio"].tobytes()
    a, b = _decoded(outs["port"]), _decoded(outs["jax"])
    assert a.shape == b.shape and (a > 0).any()
    assert np.abs(a - b).mean() <= 2.0


# -- the CLIs ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_second_wav(tmp_path_factory):
    folder = tmp_path_factory.mktemp("viz_wav")
    t = np.arange(16000) / 16000
    write_wav(folder / "clip.wav", (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32), 16000)
    return str(folder)


@pytest.mark.parametrize("family,videos", [("camn", {"_2dbody": (480, 720)}),
                                           ("emage", {"_2dface": (512, 512),
                                                      "_2dbody": (480, 720)})])
def test_test_cli_renders(archive, one_second_wav, tmp_path, monkeypatch, capsys, family,
                          videos):
    from pantomatrix_tpu_torch.cli import test_camn, test_emage

    monkeypatch.setenv("SMPLX_MODEL_PATH", archive)
    main = {"camn": test_camn.main, "emage": test_emage.main}[family]
    main(["--random_init", "--device", "cpu", "--visualization", "--audio_folder",
          one_second_wav, "--save_folder", str(tmp_path)])
    assert "render in" in capsys.readouterr().out
    frames = np.load(tmp_path / "clip_output.npz")["poses"].shape[0]
    assert frames == 30
    for suffix, (w, h) in videos.items():
        written = avi.read_avi(str(tmp_path / f"clip_output{suffix}.avi"))
        assert (len(written["jpegs"]), written["width"], written["height"]) == (frames, w, h)


def test_test_cli_without_the_archive_raises_the_jax_text(one_second_wav, tmp_path,
                                                          monkeypatch):
    from pantomatrix_tpu_torch.cli import test_disco

    monkeypatch.delenv("SMPLX_MODEL_PATH", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError,
                       match=r"SMPL-X model npz not found \(set SMPLX_MODEL_PATH\)"):
        test_disco.main(["--random_init", "--device", "cpu", "--visualization",
                         "--audio_folder", one_second_wav, "--save_folder", str(tmp_path / "o")])
    assert os.path.exists(tmp_path / "o" / "clip_output.npz")  # generated, then raised


def test_train_cli_test_pass_renders(archive, tmp_path, monkeypatch):
    """``--debug --evaluation --visualization``: the test pass at steps 2 and 4 renders
    the first clip's skeleton video, and the run completes."""
    from pantomatrix_tpu_torch.cli import train_camn

    monkeypatch.setenv("SMPLX_MODEL_PATH", archive)
    rng = np.random.RandomState(15)
    metas = []
    for i, vid in enumerate(("2_a_0_1_1", "2_a_0_2_2")):
        n = 40
        np.savez(tmp_path / f"{vid}.npz", betas=np.zeros(300, np.float32),
                 poses=rng.uniform(-0.5, 0.5, (n, 165)).astype(np.float32),
                 expressions=rng.uniform(-1, 1, (n, 100)).astype(np.float32),
                 trans=rng.uniform(-1, 1, (n, 3)).astype(np.float32),
                 model="smplx2020", gender="neutral", mocap_frame_rate=30)
        write_wav(tmp_path / f"{vid}.wav",
                  rng.uniform(-0.3, 0.3, n * 16000 // 30).astype(np.float32), 16000)
        for mode in ("train", "test"):
            metas.append({"video_id": vid, "mode": mode,
                          "motion_path": str(tmp_path / f"{vid}.npz"),
                          "audio_path": str(tmp_path / f"{vid}.wav"),
                          "start_idx": 0, "end_idx": 32})
    meta = tmp_path / "meta.json"
    meta.write_text(json.dumps(metas))
    out = tmp_path / "exp"
    argv = ["prog", "--debug", "--evaluation", "--visualization", "--device", "cpu",
            f"data.meta_paths=['{meta}']", f"data.test_meta_paths=['{meta}']",
            "data.train_bs=2", f"output_dir={out}", "log_period=1", "model.hidden_size=32",
            "model.n_layer=1", "model.dropout_prob=0.0"]
    monkeypatch.setattr(sys, "argv", argv)
    train_camn.main()
    (exp,) = os.listdir(out)
    for it in (2, 4):
        folder = out / exp / f"test_{it}"
        assert os.path.exists(folder / "metrics.json")
        written = avi.read_avi(str(folder / "2_a_0_1_1_output_2dbody.avi"))
        frames = np.load(folder / "2_a_0_1_1_output.npz")["poses"].shape[0]
        assert len(written["jpegs"]) == frames > 0
        assert not os.path.exists(folder / "2_a_0_2_2_output_2dbody.avi")  # the first only
    assert os.path.exists(out / exp / "ckpt" / "last.bin")
