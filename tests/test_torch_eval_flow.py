"""The port's test flow (pantomatrix_tpu_torch.eval.test_flow) against the JAX package
on the CPU: the three generate functions and the VQ round trip on a take of the
synthetic BEAT2 layout, and run_test_pass's gates (visualization not ported, an SMPL-X
archive that cannot be read, a device that cannot take the archive).
tests/test_torch_eval.py says how the inputs and weights are made; tolerances: decoded
rotations 2e-3 (the reference's sqrt-based matrix -> quaternion step,
tests/test_torch_emage.py), expressions and translations 1e-5.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pantomatrix_tpu.eval import test_flow as jflow
from pantomatrix_tpu_torch.data.audio import load_audio
from pantomatrix_tpu_torch.eval import test_flow
from test_torch_eval import ATOL, ROT_ATOL, _test_list, write_beat2, write_checkpoints
from test_torch_smplx import write_archive

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def beat2(tmp_path_factory):
    return write_beat2(str(tmp_path_factory.mktemp("beat2")))


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    return write_archive(tmp_path_factory.mktemp("smplx") / "SMPLX_NEUTRAL_2020.npz")


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    return {f: write_checkpoints(str(root / f), f) for f in ("camn", "disco", "emage")}


def _close(got, want, name, atol):
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("family", ["camn", "disco", "emage", "emage_roundtrip"])
def test_generate_functions_match_jax(beat2, families, family):
    model, vq, jmodel, jvq = families[family.split("_")[0]]
    if family == "camn":
        gen, jgen = test_flow.make_camn_generate(model), jflow.make_camn_generate(
            jmodel.params, jmodel.config)
    elif family == "disco":
        gen, jgen = test_flow.make_disco_generate(model), jflow.make_disco_generate(
            jmodel.params, jmodel.config)
    elif family == "emage":
        gen, jgen = (test_flow.make_emage_generate(model, vq),
                     jflow.make_emage_generate(jmodel.params, jmodel.config, jvq.suite))
    else:
        gen, jgen = (test_flow.make_emage_vq_roundtrip_generate(vq),
                     jflow.make_emage_vq_roundtrip_generate(jvq.suite))
        assert gen.needs_meta and not gen.needs_audio
    meta = _test_list(beat2)[1]
    wave_ = load_audio(meta["audio_path"])
    if family == "emage_roundtrip":
        got, want = gen(None, None, meta=meta), jgen(None, None, meta=meta)
    else:
        got = gen(torch.from_numpy(wave_)[None], torch.zeros((1, 1), dtype=torch.long))
        want = jgen(jnp.asarray(wave_)[None], jnp.zeros((1, 1), jnp.int32))
    assert set(got) == set(want)
    _close(got["motion"], want["motion"], "motion", ROT_ATOL)
    for k in ("expressions", "trans"):
        if k in want:
            assert got[k].shape == want[k].shape
            _close(got[k], want[k], k, ATOL)


def test_run_test_pass_gates(beat2, archive, families, tmp_path, monkeypatch, capsys):
    model = families["camn"][0]
    gen = test_flow.make_camn_generate(model)
    test_list = _test_list(beat2)[1:]
    kw = dict(pose_fps=15, with_face=False, download_path=str(tmp_path), device="cpu")
    # visualization without an archive is skipped with the JAX package's message
    monkeypatch.delenv("SMPLX_MODEL_PATH", raising=False)
    viz = test_flow.run_test_pass(gen, test_list, str(tmp_path / "viz"), visualize=1, **kw)
    assert set(viz) == {"fgd", "fgd_embedder"}
    assert ("visualization skipped (SMPL-X model npz not found (set SMPLX_MODEL_PATH))"
            in capsys.readouterr().out)
    # an archive that cannot be read: FGD only, as in the JAX package
    monkeypatch.setenv("SMPLX_MODEL_PATH", str(tmp_path / "absent.npz"))
    got = test_flow.run_test_pass(gen, test_list, str(tmp_path / "port"), **kw)
    kw.pop("device")
    want = jflow.run_test_pass(jflow.make_camn_generate(families["camn"][2].params,
                                                        families["camn"][2].config),
                               test_list, str(tmp_path / "jax"), **kw)
    assert set(got) == set(want) == {"fgd", "fgd_embedder"}
    assert capsys.readouterr().out.count("computing FGD only") == 2
    assert json.load(open(tmp_path / "port" / "metrics.json"))["fgd_embedder"] == "stats"
    # a readable archive whose device cannot take it raises: the gate covers the read
    monkeypatch.setenv("SMPLX_MODEL_PATH", archive)
    with pytest.raises((RuntimeError, AssertionError)):
        test_flow.run_test_pass(gen, test_list, str(tmp_path / "dev"), device="cuda:99", **kw)
    assert "computing FGD only" not in capsys.readouterr().out
