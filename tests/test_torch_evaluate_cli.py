"""``python -m pantomatrix_tpu_torch.cli.evaluate`` on the CPU against the JAX package's
``cli.evaluate`` on the same checkpoint, takes, SMPL-X archive and FGD weight file: the
metrics.json of each (tests/test_torch_eval.py says how the inputs are made and why its
tolerances hold), and the saved motion; CaMN and DisCo here, EMAGE in
tests/test_torch_evaluate_cli_emage.py.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

from pantomatrix_tpu.cli import evaluate as jevaluate
from pantomatrix_tpu_torch.cli import evaluate
from pantomatrix_tpu_torch.data.preprocess import build_clip_index
from test_torch_eval import (
    ATOL,
    ROT_ATOL,
    assert_metrics_match,
    write_aeskconv,
    write_beat2,
    write_checkpoints,
)
from test_torch_smplx import write_archive

torch.set_num_threads(2)

# (family, clip source, extra flags, AESKConv file present)
CASES = {
    "camn_meta": ("camn", "meta", [], True),
    "camn_beat2_root": ("camn", "beat2_root", [], False),
    "disco_meta": ("disco", "meta", [], True),
}


def make_data(root, families):
    """The takes, the SMPL-X archive, the clip index, working directories with and
    without the AESKConv file, and a checkpoint of each family."""
    beat2 = write_beat2(str(root / "beat2"))
    write_aeskconv(str(root / "with_fgd" / "emage_evaltools" / "AESKConv_240_100.bin"))
    (root / "without_fgd").mkdir()
    return {"root": root, "beat2": beat2,
            "archive": write_archive(root / "SMPLX_NEUTRAL_2020.npz"),
            "meta": build_clip_index(beat2, str(root / "index")),
            "ckpt": {f: (str(root / f), write_checkpoints(str(root / f), f))
                     for f in families}}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_data(tmp_path_factory.mktemp("evaluate"), ("camn", "disco"))


def run_both(data, case, monkeypatch, tmp_path):
    """The port's CLI and the JAX CLI on one case; their metrics.json files and the
    output folders, after checking the keys and the saved motion."""
    family, source, flags, with_fgd = case
    monkeypatch.chdir(data["root"] / ("with_fgd" if with_fgd else "without_fgd"))
    monkeypatch.setenv("SMPLX_MODEL_PATH", data["archive"])
    clips = ["--meta", data["meta"]] if source == "meta" else ["--beat2_root", data["beat2"]]
    argv = ["--family", family, "--model_path", data["ckpt"][family][0], *clips, *flags]
    evaluate.main(argv + ["--save_folder", str(tmp_path / "port"), "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["evaluate"] + argv + ["--save_folder",
                                                            str(tmp_path / "jax")])
    jevaluate.main()
    got = json.load(open(tmp_path / "port" / "metrics.json"))
    want = json.load(open(tmp_path / "jax" / "metrics.json"))
    want_keys = {"fgd", "fgd_embedder", "bc", "l1"} | ({"lvd", "mse"} if family == "emage"
                                                      else set())
    assert set(got) == want_keys
    assert got["fgd_embedder"] == ("aeskconv" if with_fgd else "stats")
    assert_metrics_match(got, want)
    outs = sorted(f for f in os.listdir(tmp_path / "port") if f.endswith("_output.npz"))
    assert outs == ["2_scott_0_1_1_output.npz", "2_scott_0_2_2_output.npz"]
    if source == "beat2_root":
        assert os.path.exists(tmp_path / "port" / "beat2_s20_l64_speaker2.json")
    for name in outs:
        a, b = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
        np.testing.assert_allclose(a["poses"], b["poses"], rtol=0, atol=ROT_ATOL)
        for k in ("expressions", "trans", "betas"):
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=ATOL, err_msg=k)
    return got


@pytest.mark.parametrize("case", list(CASES))
def test_evaluate_cli_matches_jax(data, case, monkeypatch, tmp_path):
    got = run_both(data, CASES[case], monkeypatch, tmp_path)
    assert 0 < got["bc"] < 1  # beats were found and scored


def test_evaluate_cli_rejects_what_jax_rejects(data, tmp_path, monkeypatch):
    argv = ["--family", "camn", "--model_path", data["ckpt"]["camn"][0],
            "--save_folder", str(tmp_path)]
    for extra in (["--meta", data["meta"], "--vq_roundtrip"], []):
        with pytest.raises(SystemExit):
            evaluate.main(argv + extra + ["--device", "cpu"])
        monkeypatch.setattr(sys, "argv", ["evaluate"] + argv + extra)
        with pytest.raises(SystemExit):
            jevaluate.main()
