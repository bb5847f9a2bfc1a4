"""``python -m pantomatrix_tpu_torch.cli.evaluate --family emage`` on the CPU against
the JAX package's CLI (tests/test_torch_evaluate_cli.py has the protocol): the VQ round
trip from a bare BEAT2 layout with the AESKConv file, and AR generation from a clip
index without it.
"""
import pytest
import torch

from test_torch_evaluate_cli import make_data, run_both

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_data(tmp_path_factory.mktemp("evaluate"), ("emage",))


def test_evaluate_cli_vq_roundtrip_matches_jax(data, monkeypatch, tmp_path):
    got = run_both(data, ("emage", "beat2_root", ["--vq_roundtrip"], True), monkeypatch,
                   tmp_path)
    assert 0 < got["bc"] < 1  # beats were found and scored


def test_evaluate_cli_generation_matches_jax(data, monkeypatch, tmp_path):
    # the tiny random EMAGE model's generated motion has no velocity minimum strict over
    # 7 frames either side, so both packages score its BC 0
    run_both(data, ("emage", "meta", [], False), monkeypatch, tmp_path)
