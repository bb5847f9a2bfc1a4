"""The port's audio reader and BEAT save against the JAX package on the CPU: MP3 input
(an ID3 or MPEG frame-sync header goes to the libmpg123 binding, with the JAX reader's
routing and error messages) and the SMPL-X ground offset written when no translation is
given, on a synthetic archive with the real archive's key layout."""
import os

import numpy as np
import pytest

from pantomatrix_tpu.core import smplx as jsmplx
from pantomatrix_tpu.data import audio as jaudio
from pantomatrix_tpu.io import beat_format as jbeat
from pantomatrix_tpu_torch.core import smplx
from pantomatrix_tpu_torch.data import audio
from pantomatrix_tpu_torch.io import beat_format


def _outcome(read, path):
    """What a reader does with a file: its samples and rate, or its error."""
    try:
        x, sr = read(str(path))
        return "read", np.asarray(x), sr
    except (ValueError, RuntimeError) as e:
        return type(e).__name__, str(e), None


HEADERS = {
    "id3": b"ID3\x04\x00\x00" + b"\x00" * 64,
    "mpeg_sync": b"\xff\xfb\x90\x64" + b"\x00" * 64,
    "mpeg_sync_garbage": b"\xff\xe3" + bytes(range(200)),
}


@pytest.mark.parametrize("kind", list(HEADERS))
def test_mp3_headers_route_to_the_native_decoder_as_in_jax(tmp_path, kind, monkeypatch):
    path = tmp_path / "clip.wav"  # the reference's MP3 examples carry .wav names
    path.write_bytes(HEADERS[kind])
    routed = []
    monkeypatch.setattr(audio, "_read_mp3", lambda p: routed.append(p) or (np.zeros(0), 1))
    audio.read_wav(str(path))
    assert routed == [str(path)]
    monkeypatch.undo()
    got, want = _outcome(audio.read_wav, path), _outcome(jaudio.read_wav, path)
    assert got[0] == want[0] and got[2] == want[2]
    if got[0] == "read":
        np.testing.assert_array_equal(got[1], want[1])
    else:
        assert got[1] == want[1]


def test_non_audio_file_raises_the_jax_readers_error(tmp_path):
    path = tmp_path / "notes.wav"
    path.write_bytes(b"plain text, not audio" * 4)
    got, want = _outcome(audio.read_wav, path), _outcome(jaudio.read_wav, path)
    assert got == want == ("ValueError", f"{path}: not a RIFF/WAVE file", None)


def test_missing_libmpg123_raises_a_value_error(tmp_path, monkeypatch):
    from pantomatrix_tpu_torch.native import mp3

    def missing(path):
        raise OSError("libmpg123.so.0: cannot open shared object file")

    monkeypatch.setattr(mp3, "decode", missing)
    path = tmp_path / "clip.mp3"
    path.write_bytes(HEADERS["id3"])
    with pytest.raises(ValueError, match="needs the system libmpg123"):
        audio.read_wav(str(path))


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    """Synthetic npz with the real SMPLX_NEUTRAL_2020 archive's key layout (small V/F),
    as tests/test_smplx_archive_and_ckpt_layout.py builds it."""
    rng = np.random.RandomState(0)
    V, F = 64, 100
    path = tmp_path_factory.mktemp("smplx") / "SMPLX_NEUTRAL_2020.npz"
    faces = rng.randint(0, V, (F, 3)).astype(np.int64)
    kintree = np.zeros((2, 55), np.int64)
    kintree[0] = np.concatenate([[2**32 - 1], np.arange(54)])  # parent row
    np.savez(
        path,
        v_template=rng.normal(0, 0.3, (V, 3)).astype(np.float64),
        shapedirs=rng.normal(0, 0.01, (V, 3, 400)).astype(np.float64),
        posedirs=rng.normal(0, 0.01, (V, 3, 486)).astype(np.float64),
        J_regressor=np.abs(rng.normal(0, 1, (55, V))).astype(np.float64),
        kintree_table=kintree,
        weights=np.abs(rng.normal(0, 1, (V, 55))).astype(np.float64),
        hands_meanl=rng.normal(0, 0.05, 45).astype(np.float64),
        hands_meanr=rng.normal(0, 0.05, 45).astype(np.float64),
        f=faces,
        lmk_faces_idx=rng.randint(0, F, 51).astype(np.int64),
        lmk_bary_coords=np.full((51, 3), 1 / 3, np.float64),
    )
    return str(path)


@pytest.mark.parametrize("with_betas", [False, True])
def test_ground_offset_matches_jax(archive, tmp_path, monkeypatch, with_betas):
    monkeypatch.setenv("SMPLX_MODEL_PATH", archive)
    rng = np.random.RandomState(1)
    motion = rng.uniform(-0.3, 0.3, (5, 165)).astype(np.float32)
    kw = {"betas": rng.normal(0, 1, (5, 300)).astype(np.float32)} if with_betas else {}
    beat_format.beat_format_save(str(tmp_path / "port.npz"), motion, **kw)
    jbeat.beat_format_save(str(tmp_path / "jax.npz"), motion, **kw)
    got, want = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert got["trans"].shape == (5, 3) and got["trans"].dtype == want["trans"].dtype
    assert not np.allclose(got["trans"], 0)  # the rest pose's offset, not the fallback
    np.testing.assert_allclose(got["trans"], want["trans"], rtol=0, atol=1e-5)
    for k in ("poses", "betas", "expressions"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_ground_offset_reads_the_archive_once_per_file_version(archive, tmp_path,
                                                              monkeypatch):
    monkeypatch.setenv("SMPLX_MODEL_PATH", archive)
    reads = []
    load = smplx.load_smplx
    monkeypatch.setattr(smplx, "load_smplx", lambda *a: reads.append(a) or load(*a))
    beat_format._rest_model.cache_clear()
    motion = np.random.RandomState(4).uniform(-0.3, 0.3, (3, 165)).astype(np.float32)
    for i in range(3):
        beat_format.beat_format_save(str(tmp_path / f"{i}.npz"), motion)
    assert len(reads) == 1
    st = os.stat(archive)
    os.utime(archive, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))  # the file changed
    beat_format.beat_format_save(str(tmp_path / "after.npz"), motion)
    assert len(reads) == 2
    first, after = np.load(tmp_path / "0.npz"), np.load(tmp_path / "after.npz")
    np.testing.assert_array_equal(first["trans"], after["trans"])
    beat_format._rest_model.cache_clear()


def test_rest_pose_joints_are_the_jax_lbs_joints_at_the_zero_pose(archive):
    betas = np.random.RandomState(2).normal(0, 1, 300).astype(np.float32)
    got = smplx.rest_pose_joints(smplx.load_smplx(archive, "cpu"), betas).numpy()
    want = np.asarray(jsmplx.rest_pose_joints(jsmplx.load_smplx(archive), betas))
    assert got.shape == (55, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_without_the_archive_both_write_zero_translation(tmp_path, monkeypatch):
    monkeypatch.setenv("SMPLX_MODEL_PATH", str(tmp_path / "absent.npz"))
    motion = np.random.RandomState(3).uniform(-0.3, 0.3, (4, 165)).astype(np.float32)
    beat_format.beat_format_save(str(tmp_path / "port.npz"), motion)
    jbeat.beat_format_save(str(tmp_path / "jax.npz"), motion)
    got, want = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    np.testing.assert_array_equal(got["trans"], np.zeros((4, 3), np.float32))
    np.testing.assert_array_equal(got["trans"], want["trans"])


def test_default_model_path_follows_the_jax_lookup(tmp_path, monkeypatch):
    monkeypatch.setenv("SMPLX_MODEL_PATH", str(tmp_path / "x.npz"))
    assert smplx.default_model_path() == jsmplx.default_model_path() == str(tmp_path / "x.npz")
    monkeypatch.delenv("SMPLX_MODEL_PATH")
    monkeypatch.chdir(tmp_path)  # no candidate under this directory
    assert smplx.default_model_path() == jsmplx.default_model_path()
    cand = tmp_path / "emage_evaltools" / "smplx_models" / "smplx"
    cand.mkdir(parents=True)
    (cand / "SMPLX_NEUTRAL_2020.npz").write_bytes(b"")
    assert smplx.default_model_path() == jsmplx.default_model_path() == \
        "./emage_evaltools/smplx_models/smplx/SMPLX_NEUTRAL_2020.npz"
    assert os.path.exists(smplx.default_model_path())
