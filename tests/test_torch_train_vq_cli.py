"""The port's tokenizer-pretraining CLI (pantomatrix_tpu_torch/cli/train_emage_vq.py) and
training benchmark (cli/bench_train.py) on the CPU: the VQ trainer with --debug writes
the --vq_path layout, the port's EMAGE trainer trains on it, the JAX package's loader
reads it and decodes as the port does, its validation round trip equals the JAX
package's, scripts/torch_export_vq_suite.py and scripts/torch_vq_bound.py reproduce the
export and the best validation, and bench_train prints its line.

Data: a synthetic BEAT2 (two train takes and one val take of 100 frames, 64-frame clips,
foot contact) from a numpy seed. The suite is full width (the CLI's init_vq_suite
widths); the EMAGE model is tiny. Tolerance: each tokenizer's decode (and the global
VAE) of the exported suite in the JAX package within 1e-5 of the port's, and the
composite decode's expression and translation within 1e-5, its rotations within 2e-3
(the sqrt-based quaternion step, as in tests/test_torch_emage.py).
"""
import importlib.util
import json
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pantomatrix_tpu.cli.train_emage import load_suite as jload_suite
from pantomatrix_tpu.core.rotations import axis_angle_to_rotation_6d as jaa2r6d
from pantomatrix_tpu.models import emage_vq as jvq
from pantomatrix_tpu_torch.cli import bench_train, train_emage, train_emage_vq
from pantomatrix_tpu_torch.data.beat2 import BEAT2Dataset, DataLoader
from pantomatrix_tpu_torch.models.api import EmageVQModel

from test_data_pipeline import write_wav

torch.set_num_threads(2)

PARTS = ("face", "upper", "hands", "lower", "global")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def vq_beat2(tmp_path_factory):
    root = tmp_path_factory.mktemp("vq_cli_beat2")
    for sub in ("smplxflame_30", "footcontact", "wave16k"):
        (root / sub).mkdir()
    rng = np.random.RandomState(10)
    metas = []
    for vid, mode in (("2_a_0_1_1", "train"), ("2_a_0_2_2", "train"), ("2_a_0_3_3", "val")):
        n = 100
        np.savez(root / "smplxflame_30" / f"{vid}.npz", betas=np.zeros(300, np.float32),
                 poses=rng.uniform(-0.5, 0.5, (n, 165)).astype(np.float32),
                 expressions=rng.uniform(-1, 1, (n, 100)).astype(np.float32),
                 trans=rng.uniform(-1, 1, (n, 3)).astype(np.float32))
        np.save(root / "footcontact" / f"{vid}.npy",
                (rng.uniform(size=(n, 4)) < 0.5).astype(np.float32))
        write_wav(root / "wave16k" / f"{vid}.wav",
                  rng.uniform(-0.3, 0.3, n * 16000 // 30).astype(np.float32), 16000)
        for start in (0, 12, 24):
            metas.append({"video_id": vid, "mode": mode,
                          "motion_path": str(root / "smplxflame_30" / f"{vid}.npz"),
                          "audio_path": str(root / "wave16k" / f"{vid}.wav"),
                          "start_idx": start, "end_idx": start + 64})
    meta = root / "meta.json"
    meta.write_text(json.dumps(metas))
    return str(meta)


def _run(main, argv):
    old = sys.argv
    sys.argv = ["prog", *argv]
    try:
        main()
    finally:
        sys.argv = old


@pytest.fixture(scope="module")
def vq_run(vq_beat2, tmp_path_factory):
    out = tmp_path_factory.mktemp("vq_cli")
    _run(train_emage_vq.main, [
        "--debug", "--device", "cpu", f"data.meta_paths=['{vq_beat2}']",
        f"data.test_meta_paths=['{vq_beat2}']", "data.train_bs=2", f"output_dir={out}",
        "log_period=1"])
    (exp,) = os.listdir(out)
    return os.path.join(out, exp)


def test_vq_cli_debug_writes_the_export_layout(vq_run):
    for part in PARTS:
        for f in ("config.json", "model.safetensors"):
            assert os.path.exists(os.path.join(vq_run, "emage_vq", part, f)), (part, f)
    lines = [json.loads(x) for x in open(os.path.join(vq_run, "metrics.jsonl"))]
    train = [x for x in lines if "all_loss" in x]
    assert [x["step"] for x in train] == [1, 2, 3, 4]
    for x in train:
        assert all(np.isfinite(x[k]) for k in x if k != "step")
        assert {f"restarted_{p}" for p in PARTS[:4]} <= set(x)
    vals = [x["val/metric"] for x in lines if "val/metric" in x]
    assert len(vals) == 2 and all(np.isfinite(vals))
    # the best-val suite was exported
    assert os.path.exists(os.path.join(vq_run, "ckpt", "best.bin"))


def test_port_emage_trainer_consumes_the_export(vq_run, vq_beat2, tmp_path):
    _run(train_emage.main, [
        "--vq_path", vq_run, "--debug", "--device", "cpu",
        f"data.meta_paths=['{vq_beat2}']", f"data.test_meta_paths=['{vq_beat2}']",
        "data.train_bs=2", f"output_dir={tmp_path}", "log_period=1", "model.hidden_size=32",
        "model.n_layer=1", "model.dropout_prob=0.0", "model.audio_f=32", "model.motion_f=16",
        "model.speaker_dims=4", "model.pose_length=64", "model.seed_frames=4"])
    (exp,) = os.listdir(tmp_path)
    lines = [json.loads(x) for x in open(tmp_path / exp / "metrics.jsonl")]
    assert [x["step"] for x in lines if "all" in x] == [1, 2, 3, 4]
    assert all(np.isfinite(x["all"]) for x in lines if "all" in x)


def test_jax_loader_reads_the_export_and_decodes_as_the_port(vq_run):
    suite = EmageVQModel.from_pretrained(vq_run, device="cpu")
    jsuite = jload_suite(vq_run, False)
    rng = np.random.RandomState(3)
    idx = {p: rng.randint(0, 256, (2, 16)).astype(np.int32) for p in PARTS[:4]}
    ref_trans = rng.uniform(-1, 1, (2, 1, 3)).astype(np.float32)
    # each tokenizer's decode, and the global VAE on a lower-body stream
    for p, i in idx.items():
        params, cfg = getattr(jsuite, p)
        want = jax.jit(lambda q, x: jvq.vqvae_decode_index(q, cfg, x))(params, jnp.asarray(i))
        got = getattr(suite, p).decode(torch.from_numpy(i).long())
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5,
                                   err_msg=p)
    lower = rng.uniform(-1, 1, (2, 16, 61)).astype(np.float32)
    params, cfg = jsuite.global_motion
    want = jax.jit(lambda q, x: jvq.vae_forward(q, cfg, x))(params, jnp.asarray(lower))
    got = suite.global_motion(torch.from_numpy(lower))
    np.testing.assert_allclose(got["rec_pose"].detach().numpy(), np.asarray(want["rec_pose"]),
                               rtol=0, atol=1e-5)
    # the composite decode: rotations pass through the reference's sqrt-based matrix ->
    # quaternion step, which turns float32 differences upstream into up to ~1e-3
    # (tests/test_torch_emage.py), so they are held at 2e-3
    kw = lambda conv: {f"{p}_index": conv(v) for p, v in idx.items()}
    want = jax.jit(lambda s, i, r: jvq.vq_decode(s, **i, get_global_motion=True, ref_trans=r))(
        jsuite, kw(jnp.asarray), jnp.asarray(ref_trans))
    got = suite.decode(**kw(lambda v: torch.from_numpy(v).long()), get_global_motion=True,
                       ref_trans=torch.from_numpy(ref_trans))
    for k, atol in (("expression", 1e-5), ("trans", 1e-5), ("all_motion4inference", 2e-3),
                    ("motion_axis_angle", 2e-3)):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=atol,
                                   err_msg=k)


def test_val_roundtrip_matches_the_jax_index_route(vq_run, vq_beat2):
    """The trainer's validation round trip (codes by map2index, decode from indices, as the
    JAX CLI's) against the JAX functions on the exported suite: indices equal, rotations
    within 2e-3 (the quaternion step above), the ground truth within 1e-6."""
    suite = EmageVQModel.from_pretrained(vq_run, device="cpu")
    jsuite = jload_suite(vq_run, False)
    val = BEAT2Dataset([vq_beat2], "val", 30, 16000, None, variant="emage_footcontact")
    batch = next(iter(DataLoader(val, 2, shuffle=False)))
    got, gt6 = train_emage_vq.roundtrip_rot6d(
        suite, {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    motion = jnp.asarray(batch["motion"])
    bs, t, jc = motion.shape
    jgt6 = jaa2r6d(motion.reshape(bs, t, jc // 3, 3)).reshape(bs, t, -1)
    args = (jgt6, jnp.asarray(batch["expressions"]), jnp.asarray(batch["foot_contact"]),
            jnp.asarray(batch["trans"]))
    jidx = jvq.vq_map2index(jsuite, *args)
    idx = suite.map2index(*(torch.from_numpy(np.array(a)) for a in args))
    for p in PARTS[:4]:
        np.testing.assert_array_equal(idx[p].numpy(), np.asarray(jidx[p]), err_msg=p)
    want = jvq.vq_decode(jsuite, **{f"{p}_index": jidx[p] for p in PARTS[:4]})
    np.testing.assert_allclose(gt6.numpy(), np.asarray(jgt6), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want["all_motion4inference"])[:, :, :-7],
                               rtol=0, atol=2e-3)


def test_export_script_rebuilds_the_trainers_export(vq_run, tmp_path):
    """scripts/torch_export_vq_suite.py on the run's best.bin writes the files the trainer
    exported at its end (the best-val suite), byte for byte; without a card its default
    device raises."""
    script = _script("torch_export_vq_suite")
    script.main([os.path.join(vq_run, "ckpt", "best.bin"), str(tmp_path), "--device", "cpu"])
    for part in PARTS:
        for f in ("config.json", "model.safetensors"):
            with open(tmp_path / "emage_vq" / part / f, "rb") as a, \
                    open(os.path.join(vq_run, "emage_vq", part, f), "rb") as b:
                assert a.read() == b.read(), (part, f)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            script.main([os.path.join(vq_run, "ckpt", "best.bin"), str(tmp_path / "cuda")])


def test_vq_bound_script_reproduces_the_best_validation(vq_run, vq_beat2, capsys):
    """scripts/torch_vq_bound.py on the exported (best-val) suite prints the trainer's best
    val/metric: the same round trip, loader and metric (1e-6 relative)."""
    lines = [json.loads(x) for x in open(os.path.join(vq_run, "metrics.jsonl"))]
    best = min(x["val/metric"] for x in lines if "val/metric" in x)
    _run(_script("torch_vq_bound").main, ["--vq_path", vq_run, "--meta", vq_beat2,
                                          "--bs", "2", "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert "VQ round-trip windowed FGD bound" in out
    np.testing.assert_allclose(float(out.rsplit(":", 1)[1]), best, rtol=1e-6)


@pytest.mark.parametrize("family", ["camn", "disco", "emage"])
def test_bench_train_prints_a_parseable_line(family, capsys):
    bench_train.main(["--family", family, "--device", "cpu", "--batch", "2", "--frames", "8",
                      "--k", "1", "--repeats", "2"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("family", "dtype", "batch", "frames", "k", "repeats", "ms_per_step", "ms_min",
                "ms_max", "steps_per_s", "flops_per_step", "tflops", "mfu", "compile_s"):
        assert key in line, key
    assert line["family"] == family and line["batch"] == 2 and line["frames"] == 8
    assert line["ms_min"] <= line["ms_per_step"] <= line["ms_max"]
    assert line["flops_per_step"] > 0 and line["mfu"] is None  # no peak for the CPU
    assert line["k2_launches_per_step"] == 0 and line["k1_launches"] == 0
