"""The port's BEAT2 preprocessing (pantomatrix_tpu_torch/data/preprocess.py,
cli/preprocess.py) against the JAX package on the CPU: foot contact from SMPL-X FK, the
DisCo labels from the port's k-means against the JAX package's scikit-learn KMeans, and
the three CLI subcommands.

Data from numpy seeds: a synthetic SMPL-X archive (tests/test_torch_smplx.py's, V = 24)
and takes of smooth sinusoidal motion. Tolerances: foot contact equal, but for frames
whose float64 velocity lies within 1e-6 relative of the threshold (a float32 near-tie),
of which the fixture has none; DisCo labels the same partition as scikit-learn's (equal
up to a permutation of the label values) on clusters that are well separated.
"""
import json
import os

import numpy as np
import pytest
import torch

from pantomatrix_tpu.core import smplx as jsmplx
from pantomatrix_tpu.data import preprocess as jpre
from pantomatrix_tpu_torch.cli import preprocess as cli
from pantomatrix_tpu_torch.core import smplx
from pantomatrix_tpu_torch.data import preprocess

from test_torch_smplx import write_archive

torch.set_num_threads(2)

THRESHOLD = 0.01
NEAR = 1e-6  # relative distance to the threshold that counts as a near-tie


def _write_take(path, n, rng, amp=0.06):
    t = np.arange(n)[:, None] / 30.0
    wave = lambda ch, a: (a * np.sin(2 * np.pi * rng.uniform(0.3, 2.0, ch) * t
                                     + rng.uniform(0, 2 * np.pi, ch))).astype(np.float32)
    np.savez(path, betas=rng.normal(0, 1, 300).astype(np.float32), poses=wave(165, amp),
             expressions=wave(100, 0.5), trans=wave(3, 0.02))


@pytest.fixture(scope="module")
def beat2(tmp_path_factory):
    """A BEAT2 layout (speaker 2): 3 takes of 200 frames (two 128-frame FK chunks each)
    and an archive."""
    root = tmp_path_factory.mktemp("beat2_pre")
    (root / "smplxflame_30").mkdir()
    rng = np.random.RandomState(3)
    rows = ["id,type"]
    for i, mode in enumerate(("train", "train", "test")):
        vid = f"2_scott_0_{i + 1}_{i + 1}"
        _write_take(root / "smplxflame_30" / f"{vid}.npz", 200, rng)
        rows.append(f"{vid},{mode}")
    (root / "train_test_split.csv").write_text("\n".join(rows) + "\n")
    return root, write_archive(root / "SMPLX_NEUTRAL_2020.npz")


def test_foot_contact_matches_jax(beat2, tmp_path):
    root, archive = beat2
    motion = str(root / "smplxflame_30")
    jpre.extract_foot_contact(motion, str(tmp_path / "jax"), model=jsmplx.load_smplx(archive))
    written = preprocess.extract_foot_contact(motion, str(tmp_path / "port"),
                                              model=smplx.load_smplx(archive, "cpu"))
    assert len(written) == 3
    exact = smplx.SmplxModel.from_numpy(smplx.read_smplx(archive), "cpu", torch.float64)
    near = 0
    for path in written:
        name = os.path.basename(path)
        got, want = np.load(path), np.load(tmp_path / "jax" / name)
        assert got.shape == want.shape == (200, 4) and got.dtype == want.dtype == np.float64
        v64 = preprocess.foot_velocities(exact, *preprocess.read_take(
            os.path.join(motion, name.replace(".npy", ".npz"))))
        tie = np.abs(v64 - THRESHOLD) <= NEAR * THRESHOLD
        near += int(tie.sum())
        np.testing.assert_array_equal(got[~tie], want[~tie])
        assert 0.1 < got.mean() < 0.9  # both still and moving frames
    assert near == 0


def _write_clusters(root):
    """6 takes of 200 frames; content groups (take % 3) differ by a pose offset of 1 rad,
    rhythm groups (take // 2) by a motion period of 20, 10 or 4 frames, which divides
    the clip stride, so every clip of a take has the same beat pattern."""
    (root / "smplxflame_30").mkdir()
    rows = ["id,type"]
    t = np.arange(200)[:, None]
    amp = np.random.RandomState(4).uniform(0.02, 0.05, 165)
    for i in range(6):
        vid = f"2_scott_0_{i + 1}_{i + 1}"
        period = (20, 10, 4)[i // 2]
        poses = (i % 3) * 1.0 + amp * np.sin(2 * np.pi * t / period + 0.3)
        np.savez(root / "smplxflame_30" / f"{vid}.npz", poses=poses.astype(np.float32),
                 betas=np.zeros(300, np.float32), trans=np.zeros((200, 3), np.float32))
        rows.append(f"{vid},train")
    (root / "train_test_split.csv").write_text("\n".join(rows) + "\n")
    return preprocess.build_clip_index(str(root), str(root / "index"))


def _same_partition(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.array_equal(a[:, None] == a[None], b[:, None] == b[None])


def test_disco_labels_partition_equals_scikit_learn(tmp_path):
    index = _write_clusters(tmp_path)
    want = json.load(open(jpre.build_disco_labels(index, str(tmp_path / "jax.json"),
                                                  n_clusters=3)))
    got = json.load(open(preprocess.build_disco_labels(index, n_clusters=3)))
    assert len(got) == len(want) == 42
    for key in ("content_label", "rhythm_label"):
        labels = [d[key] for d in got]
        assert set(labels) == {0, 1, 2}
        assert _same_partition(labels, [d[key] for d in want]), key
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if not k.endswith("_label")} == \
            {k: v for k, v in w.items() if not k.endswith("_label")}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kmeans_recovers_separated_blobs(seed):
    from sklearn.cluster import KMeans

    rng = np.random.RandomState(seed)
    centers = rng.normal(0, 10, (5, 8))
    x = np.concatenate([c + rng.normal(0, 0.3, (20, 8)) for c in centers])
    truth = np.repeat(np.arange(5), 20)
    got = preprocess.kmeans(x, 5, seed=seed)
    assert _same_partition(got, truth)
    assert _same_partition(got, KMeans(n_clusters=5, random_state=seed).fit(x).labels_)
    assert np.array_equal(got, preprocess.kmeans(x, 5, seed=seed))  # seeded


def test_cli_index_footcontact_and_disco(beat2, tmp_path, monkeypatch, capsys):
    root, archive = beat2
    cli.main(["index", "--beat2_root", str(root), "--output_dir", str(tmp_path / "idx"),
              "--length", "64"])
    index = capsys.readouterr().out.strip()
    want = jpre.build_clip_index(str(root), str(tmp_path / "jidx"), motion_length=64)
    assert json.load(open(index)) == json.load(open(want))
    assert os.path.basename(index) == os.path.basename(want)

    monkeypatch.setenv("SMPLX_MODEL_PATH", archive)
    out = tmp_path / "fc"
    cli.main(["footcontact", "--motion_dir", str(root / "smplxflame_30"),
              "--output_dir", str(out), "--device", "cpu"])
    ref = preprocess.extract_foot_contact(str(root / "smplxflame_30"), str(tmp_path / "ref"),
                                          model=smplx.load_smplx(archive, "cpu"))
    for path in ref:
        np.testing.assert_array_equal(np.load(out / os.path.basename(path)), np.load(path))

    cli.main(["disco", "--json", index, "--clusters", "2"])
    labelled = json.load(open(capsys.readouterr().out.strip().splitlines()[-1]))
    assert len(labelled) == len(json.load(open(index)))
    assert all(d["content_label"] in (0, 1) and d["rhythm_label"] in (0, 1) for d in labelled)


def test_cli_footcontact_asks_for_the_card_by_default(beat2, tmp_path, monkeypatch):
    root, archive = beat2
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    monkeypatch.setenv("SMPLX_MODEL_PATH", archive)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["footcontact", "--motion_dir", str(root / "smplxflame_30"),
                  "--output_dir", str(tmp_path / "fc")])
