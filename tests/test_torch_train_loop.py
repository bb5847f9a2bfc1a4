"""The port's training harness on the CPU (pantomatrix_tpu_torch/train/{ckpt,loop}.py,
data/{beat2,device_data}.py, utils/config.py, cli/train_*.py), against the JAX package
where it has a counterpart: the train-state file, resume, BestKeeper, the loaders'
index batches and items, the device-resident gather, the YAML reader, the three train
CLIs with --debug, and a checkpoint written by the port read by the JAX package.

Data is a synthetic mini-BEAT2 made from a numpy seed (as in
tests/test_train_cli_smoke.py, with three clips per take). The JAX train CLIs are not run
(they compile for minutes); their loaders and the JAX from_pretrained are.
"""
import glob
import json
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from pantomatrix_tpu.cli.train_disco import _WeightedLoader as JWeightedLoader
from pantomatrix_tpu.data import beat2 as jbeat2
from pantomatrix_tpu.models.api import AutoModel as JAutoModel
from pantomatrix_tpu_torch.cli import train_camn, train_disco, train_emage
from pantomatrix_tpu_torch.cli.train_disco import _WeightedLoader
from pantomatrix_tpu_torch.data import beat2
from pantomatrix_tpu_torch.data.device_data import DeviceResidentLoader, StagingUnsupported
from pantomatrix_tpu_torch.models import camn, configs
from pantomatrix_tpu_torch.models.api import AutoModel, CamnAudioModel
from pantomatrix_tpu_torch.train.ckpt import BestKeeper, load_train_state, save_train_state
from pantomatrix_tpu_torch.train.loop import TrainLoopConfig, run_training
from pantomatrix_tpu_torch.train.optim import make_optimizer
from pantomatrix_tpu_torch.train.steps import make_camn_train_step
from pantomatrix_tpu_torch.utils.config import dump_yaml, parse_yaml

from test_data_pipeline import write_wav

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CAMN = dict(hidden_size=32, n_layer=1, dropout_prob=0.0)
VARIANTS = [("base", 15, "local_upper"), ("emage", 30, None),
            ("emage_footcontact", 30, None), ("disco", 15, "local_upper")]


@pytest.fixture(scope="module")
def mini_beat2(tmp_path_factory):
    """Two 40-frame takes, three 32-frame clips each (starts 0, 4, 8), PCM16 WAV audio."""
    root = tmp_path_factory.mktemp("mini_beat2_torch")
    for sub in ("smplxflame_30", "footcontact", "wave16k"):
        (root / sub).mkdir()
    rng = np.random.RandomState(0)
    metas = []
    for i, vid in enumerate(("2_a_0_1_1", "2_a_0_2_2")):
        n = 40
        np.savez(root / "smplxflame_30" / f"{vid}.npz", betas=np.zeros(300, np.float32),
                 poses=rng.uniform(-0.5, 0.5, (n, 165)).astype(np.float32),
                 expressions=rng.uniform(-1, 1, (n, 100)).astype(np.float32),
                 trans=rng.uniform(-1, 1, (n, 3)).astype(np.float32),
                 model="smplx2020", gender="neutral", mocap_frame_rate=30)
        np.save(root / "footcontact" / f"{vid}.npy",
                (rng.uniform(size=(n, 4)) < 0.5).astype(np.float32))
        write_wav(root / "wave16k" / f"{vid}.wav",
                  rng.uniform(-0.3, 0.3, n * 16000 // 30).astype(np.float32), 16000)
        for j, start in enumerate((0, 4, 8)):
            metas.append({"video_id": vid, "mode": "train",
                          "motion_path": str(root / "smplxflame_30" / f"{vid}.npz"),
                          "audio_path": str(root / "wave16k" / f"{vid}.wav"),
                          "start_idx": start, "end_idx": start + 32,
                          "content_label": (i + j) % 2, "rhythm_label": j % 3})
    meta = root / "meta.json"
    meta.write_text(json.dumps(metas))
    return str(meta)


def _camn(seed=1):
    model = camn.CamnAudio(configs.CamnAudioConfig(**TINY_CAMN),
                           generator=torch.Generator().manual_seed(seed))
    return model, make_optimizer(model.parameters(), learning_rate=1e-3)


def _assert_states_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# -- checkpoints ----------------------------------------------------------------------

def test_train_state_round_trip(tmp_path):
    model, opt = _camn()
    step = make_camn_train_step(model, opt)
    rng = np.random.RandomState(2)
    batch = {"motion": torch.from_numpy(rng.uniform(-.5, .5, (2, 16, 129)).astype(np.float32)),
             "audio": torch.from_numpy(rng.uniform(-1, 1, (2, 32 * 533)).astype(np.float32))}
    step(batch, 0)  # optimizer state with moments
    path = str(tmp_path / "last.bin")
    save_train_state(path, model, opt, 123, {"metric": 0.5, "best_test": float("inf")})
    state = torch.load(path, weights_only=True)  # tensors and plain containers only
    assert state["iteration"] == 123
    other, other_opt = _camn(seed=2)
    it, extra = load_train_state(path, other, other_opt)
    assert it == 123 and extra == {"metric": 0.5, "best_test": float("inf")}
    _assert_states_equal(other.state_dict(), model.state_dict())
    # the optimizer state (moments, step count, schedule) came back too: one more step
    # from each gives the same weights
    step(batch, 1)
    make_camn_train_step(other, other_opt)(batch, 1)
    _assert_states_equal(other.state_dict(), model.state_dict())
    with pytest.raises(RuntimeError):  # a checkpoint of another config is refused
        load_train_state(path, camn.CamnAudio(configs.CamnAudioConfig(hidden_size=16, n_layer=1),
                                              generator=torch.Generator()))


def test_best_keeper(tmp_path):
    model, opt = _camn()
    keeper = BestKeeper(str(tmp_path), model.config)
    assert keeper.update(2.0, model, opt, 1)
    assert not keeper.update(3.0, model, opt, 2)
    assert keeper.update(1.0, model, opt, 3)
    assert load_train_state(str(tmp_path / "best.bin"), model)[0] == 3
    assert load_train_state(str(tmp_path / "last.bin"), model)[1]["metric"] == 1.0
    keeper.update(float("inf"), model, opt, 4)
    assert load_train_state(str(tmp_path / "best.bin"), model)[0] == 3
    assert load_train_state(str(tmp_path / "last.bin"), model)[0] == 4
    for d in ("last", "best"):
        assert os.path.exists(tmp_path / d / "pytorch_model.bin")
        assert os.path.exists(tmp_path / d / "config.json")


def _loop(mini_beat2, tmp_path, max_steps, resume=None):
    model, opt = _camn()
    ds = beat2.BEAT2Dataset([mini_beat2], "train", 15, 16000, "local_upper")
    loader = DeviceResidentLoader(beat2.DataLoader(ds, 2, seed=3), "cpu")
    cfg = TrainLoopConfig(max_train_steps=max_steps, validation_steps=100, log_period=2,
                          ckpt_dir=str(tmp_path), resume_from_checkpoint=resume)
    it = run_training(cfg, make_camn_train_step(model, opt, seed=3), model, opt, loader,
                      loader.place_batch, model_config=model.config)
    return it, model


def test_resume_two_plus_two_equals_four(mini_beat2, tmp_path):
    """Three batches an epoch: the resumed run fast-forwards inside the second epoch, and
    ends where the uninterrupted run ends, bit for bit (weights, BatchNorm buffers)."""
    it4, straight = _loop(mini_beat2, tmp_path / "a", 4)
    it2, _ = _loop(mini_beat2, tmp_path / "b", 2)
    it_resumed, resumed = _loop(mini_beat2, tmp_path / "c", 4,
                                resume=str(tmp_path / "b" / "last.bin"))
    assert (it4, it2, it_resumed) == (4, 2, 4)
    _assert_states_equal(resumed.state_dict(), straight.state_dict())


# -- data -----------------------------------------------------------------------------

class _Sized:
    def __init__(self, n):
        self.data_list = [{"content_label": i % 3} for i in range(n)]

    def __len__(self):
        return len(self.data_list)


@pytest.mark.parametrize("n,bs,count,shuffle,drop_last", [
    (23, 4, 1, True, True), (23, 4, 2, True, True), (23, 6, 3, True, False),
    (10, 2, 1, False, True)])
def test_data_loader_index_batches_match_jax(n, bs, count, shuffle, drop_last):
    for index in range(count):
        kw = dict(shuffle=shuffle, seed=5, process_index=index, process_count=count,
                  drop_last=drop_last)
        a, b = beat2.DataLoader(_Sized(n), bs, **kw), jbeat2.DataLoader(_Sized(n), bs, **kw)
        for epoch in range(3):
            a.set_epoch(epoch)
            b.set_epoch(epoch)
            assert len(a) == len(b)
            got, want = list(a.index_batches()), list(b.index_batches())
            assert len(got) == len(want) and all(np.array_equal(x, y) for x, y in zip(got, want))
    a, b = _WeightedLoader(_Sized(n), 4, seed=5), JWeightedLoader(_Sized(n), 4, seed=5)
    for epoch in range(2):
        a.set_epoch(epoch)
        b.set_epoch(epoch)
        assert all(np.array_equal(x, y) for x, y in zip(a.index_batches(), b.index_batches()))


@pytest.mark.parametrize("variant,fps,mask", VARIANTS)
def test_beat2_items_match_jax(mini_beat2, variant, fps, mask):
    got = beat2.BEAT2Dataset([mini_beat2], "train", fps, 16000, mask, variant=variant)
    want = jbeat2.BEAT2Dataset([mini_beat2], "train", fps, 16000, mask, variant=variant)
    assert len(got) == len(want) == 6
    for i in range(len(got)):
        a, b = got[i], want[i]
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (i, k)


@pytest.mark.parametrize("variant,fps,mask", VARIANTS)
def test_device_resident_batches_equal_the_host_loader(mini_beat2, variant, fps, mask):
    ds = beat2.BEAT2Dataset([mini_beat2], "train", fps, 16000, mask, variant=variant)
    host = beat2.DataLoader(ds, 2, seed=4)
    dev = DeviceResidentLoader(host, "cpu")
    assert dev.buffers["audio"].dtype == torch.int16  # PCM16: staged exactly as int16
    for epoch in range(2):
        dev.set_epoch(epoch)
        host_batches = [beat2.to_device(b, "cpu") for b in host]
        dev_batches = [dev.place_batch(idx) for idx in dev]
        assert len(dev_batches) == len(host_batches) == 3
        for a, b in zip(dev_batches, host_batches):
            assert set(a) == set(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_staging_refuses_variable_windows(mini_beat2, tmp_path):
    metas = json.load(open(mini_beat2))
    metas[0]["end_idx"] = 30
    path = tmp_path / "meta.json"
    path.write_text(json.dumps(metas))
    ds = beat2.BEAT2Dataset([str(path)], "train", 30, 16000, None, variant="emage")
    with pytest.raises(StagingUnsupported, match="variable window"):
        DeviceResidentLoader(beat2.DataLoader(ds, 2), "cpu")


# -- config ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", sorted(
    glob.glob(os.path.join(REPO, "pantomatrix_tpu", "configs", "*.yaml"))
    + glob.glob(os.path.join(REPO, "pantomatrix_tpu_torch", "configs", "*.yaml"))),
    ids=lambda p: os.path.relpath(p, REPO))
def test_yaml_reader_equals_safe_load(path):
    text = open(path).read()
    got = parse_yaml(text)
    assert got == yaml.safe_load(text)
    assert parse_yaml(dump_yaml(got)) == got == yaml.safe_load(dump_yaml(got))


def test_yaml_reader_scalars_and_lists():
    text = ("a: [1, 'x', 3e-4, 1.0e-8, yes, null]\nb:\n- 1\n- \"two # not a comment\"\n"
            "c: {}\nd:\n  e: -0.5  # comment\n  f: ''\ng: Off\nh: 010\n")
    assert parse_yaml(text) == yaml.safe_load(text)
    assert parse_yaml(dump_yaml({"x": [1e-08, float("inf"), "a: b"], "y": {}})) == \
        {"x": [1e-08, float("inf"), "a: b"], "y": {}}


# -- the CLIs ---------------------------------------------------------------------------

def _run_cli(main, out, mini_beat2, extra=()):
    argv = ["prog", "--debug", "--device", "cpu", f"data.meta_paths=['{mini_beat2}']",
            f"data.test_meta_paths=['{mini_beat2}']", "data.train_bs=2", f"output_dir={out}",
            "log_period=1", "model.hidden_size=32", "model.n_layer=1",
            "model.dropout_prob=0.0", *extra]
    old = sys.argv
    sys.argv = argv
    try:
        main()
    finally:
        sys.argv = old
    (exp,) = os.listdir(out)
    return os.path.join(out, exp)


@pytest.fixture(scope="module")
def cli_runs(mini_beat2, tmp_path_factory):
    out = {}
    for name, main, extra in (
            ("camn", train_camn.main, ()), ("disco", train_disco.main, ()),
            ("emage", train_emage.main,
             ("--random_vq", "model.audio_f=32", "model.motion_f=16", "model.speaker_dims=4",
              "model.pose_length=32", "model.seed_frames=4"))):
        out[name] = _run_cli(main, tmp_path_factory.mktemp(f"cli_{name}"), mini_beat2, extra)
    return out


@pytest.mark.parametrize("family", ["camn", "disco", "emage"])
def test_train_cli_debug_on_the_cpu(cli_runs, family):
    exp = cli_runs[family]
    for f in ("ckpt/last.bin", "ckpt/last/pytorch_model.bin", "ckpt/last/config.json",
              "metrics.jsonl", "sanity_check/resolved_config.yaml"):
        assert os.path.exists(os.path.join(exp, f)), f
    lines = [json.loads(x) for x in open(os.path.join(exp, "metrics.jsonl"))]
    assert [x["step"] for x in lines] == [1, 2, 3, 4]
    loss = "all" if family == "emage" else "all_loss"
    assert all(np.isfinite(x[loss]) for x in lines)
    model = AutoModel.from_pretrained(os.path.join(exp, "ckpt", "last"), device="cpu")
    assert load_train_state(os.path.join(exp, "ckpt", "last.bin"), model)[0] == 4


def test_train_cli_asks_for_the_card_by_default(mini_beat2, tmp_path):
    argv = ["prog", "--debug", f"data.meta_paths=['{mini_beat2}']", f"output_dir={tmp_path}"]
    old = sys.argv
    sys.argv = argv
    try:
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present: the default device is usable")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_camn.main()
    finally:
        sys.argv = old


def test_port_checkpoint_loads_into_the_jax_package(cli_runs):
    """The CaMN checkpoint the port's CLI wrote (trained weights and BatchNorm buffers)
    loads into the JAX AutoModel.from_pretrained and gives the port's forward within
    1e-5."""
    last = os.path.join(cli_runs["camn"], "ckpt", "last")
    jmodel = JAutoModel.from_pretrained(last)
    model = CamnAudioModel.from_pretrained(last, device="cpu")
    audio = np.random.RandomState(6).uniform(-1, 1, (2, 16000)).astype(np.float32)
    spk = np.zeros((2, 1), np.int64)
    want = jax.jit(lambda p, a, s: type(jmodel)(jmodel.config, p)(a, s))(
        jmodel.params, jnp.asarray(audio), jnp.asarray(spk, jnp.int32))
    got = model(torch.from_numpy(audio), torch.from_numpy(spk))
    np.testing.assert_allclose(got["motion"].numpy(), np.asarray(want["motion"]), rtol=0,
                               atol=1e-5)
    bn = "audio_encoder.feat_extractor.0.bn1.num_batches_tracked"
    assert int(model.state_dict()[bn]) == 4


# -- run records ------------------------------------------------------------------------

def test_run_records_match_jax(tmp_path, monkeypatch):
    """metrics.jsonl lines, the throughput line and a disabled wandb sink, each against
    the JAX package's for the same records and the same clock."""
    import time

    from pantomatrix_tpu.train import logging as jlogging
    from pantomatrix_tpu_torch.train import logging as tlogging

    monkeypatch.setattr(time, "time", lambda: 1000.0)
    lines = []
    for mod, name in ((jlogging, "jax.jsonl"), (tlogging, "port.jsonl")):
        meter = mod.ThroughputMeter(fps=15)
        meter.start = 996.0
        meter.add_frames(120)
        meter.add_frames(60)
        lines.append(meter.report())
        sink = mod.JsonlLogger(str(tmp_path / name))
        sink.log({"loss": 0.5, "all_loss": np.float32(0.25)}, 3)
        sink.log({"val/metric": 1.5}, 4)
        wandb = mod.WandbLogger(False, project="p", api_key="unused")
        wandb.log({"loss": 1.0}, 1)
        wandb.finish()
        assert wandb.run is None
    assert lines == ["cost 4.00s to generate 12.00s of motion (3.0x real-time)"] * 2
    assert (tmp_path / "port.jsonl").read_text() == (tmp_path / "jax.jsonl").read_text()
    assert os.environ.get("WANDB_API_KEY") != "unused"  # disabled: the key is not set
