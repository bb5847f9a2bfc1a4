"""The port's CaMN/DisCo slice (pantomatrix_tpu_torch.models.{camn,disco}) against the
JAX package on the CPU, at the SMALL config of tests/test_models_camn_disco.py: weights
from a JAX init, carried across by convert.py with a strict load; inputs made from a
numpy seed. K2 on the CPU is its plain version.

Tolerances: atol 1e-4 on ``motion``, the audio features and the WavEncoder output
(float32 through a conv stack and two 2-layer LSTMs; measured differences stay below
1e-6). ``motion_axis_angle`` is held to 2e-3: it passes through the reference's
sqrt-based matrix -> quaternion step, which turns ~1e-7 float32 differences upstream
into up to ~1e-3 near a zero quaternion component (tests/test_torch_emage.py).
"""
import wave

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pantomatrix_tpu.core import masking as jmasking
from pantomatrix_tpu.io import beat_format as jbeat
from pantomatrix_tpu.models import camn as jcamn
from pantomatrix_tpu.models import configs as jcfgs
from pantomatrix_tpu.models import disco as jdisco
from pantomatrix_tpu.nn import blocks as jblocks
from pantomatrix_tpu_torch.cli import test_camn as camn_cli
from pantomatrix_tpu_torch.convert import load_jax_params
from pantomatrix_tpu_torch.core import masking
from pantomatrix_tpu_torch.io import beat_format
from pantomatrix_tpu_torch.models import camn, configs, disco
from pantomatrix_tpu_torch.models.api import (
    AutoConfig,
    AutoModel,
    CamnAudioModel,
    DiscoAudioModel,
)
from pantomatrix_tpu_torch.nn.blocks import WavEncoder, wav_encoder_out_len

torch.set_num_threads(2)

ATOL = 1e-4
ROT_ATOL = 2e-3  # axis angles, see the module docstring
SMALL = dict(audio_f=128, speaker_f=8, speaker_dims=4, hidden_size=48, n_layer=2,
             pose_dims=258, body_dims=78, hands_dims=180, dropout_prob=0.0)
FAMILIES = {
    "camn": (jcamn.init_camn, jcamn.camn_forward, jcfgs.CamnAudioConfig,
             camn.CamnAudio, camn.camn_forward, configs.CamnAudioConfig),
    "disco": (jdisco.init_disco, jdisco.disco_forward, jcfgs.DiscoAudioConfig,
              disco.DiscoAudio, disco.disco_forward, configs.DiscoAudioConfig),
}


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_forward(fwd, cfg):
    return jax.jit(lambda p, a, s, sm: fwd(p, cfg, a, s, seed_motion=sm))


@pytest.fixture(scope="module")
def pairs():
    """Per family: the JAX params, the jitted JAX forward, and the port's module
    strictly loaded from those params."""
    out = {}
    for i, (name, (init, fwd, jcls, mod_cls, _, tcls)) in enumerate(FAMILIES.items()):
        jcfg = jcls(**SMALL)
        params = jax.jit(lambda k: init(k, jcfg))(jax.random.PRNGKey(i))
        model = load_jax_params(mod_cls(tcls(**SMALL), generator=torch.Generator()),
                                np_tree(params))
        out[name] = (params, _jax_forward(fwd, jcfg), model)
    return out


def _audio(bs, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, (bs, 16000)).astype(np.float32)


def _close(got, want, name, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=atol,
                               err_msg=name)


@pytest.mark.parametrize("family,seeded", [("camn", False), ("camn", True), ("disco", False)])
def test_forward_matches_jax(pairs, family, seeded):
    params, jfwd, model = pairs[family]
    bs = 1 if seeded else 2
    audio, spk = _audio(bs), np.array([[1], [3]][:bs])
    # a 14-frame seed, longer than seed_frames: the first 4 frames are used
    seed = (np.random.RandomState(2).uniform(-1, 1, (bs, 14, 258)).astype(np.float32)
            if seeded else None)
    want = jfwd(params, jnp.asarray(audio), jnp.asarray(spk),
                None if seed is None else jnp.asarray(seed))
    got = FAMILIES[family][4](model, torch.from_numpy(audio), torch.from_numpy(spk),
                              seed_motion=None if seed is None else torch.from_numpy(seed))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        _close(got[k], want[k], k, ROT_ATOL if k == "motion_axis_angle" else ATOL)
    assert got["motion"].shape == (bs, 15, 258) and got["motion_axis_angle"].shape[-1] == 165


def test_model_classes_call_the_forwards(pairs):
    _, _, model = pairs["camn"]
    wrapped = CamnAudioModel(configs.CamnAudioConfig(**SMALL), device="cpu")
    wrapped.load_state_dict(model.state_dict())
    audio, spk = torch.from_numpy(_audio(1, seed=4)), torch.tensor([[2]])
    got = wrapped(audio, spk, return_axis_angle=False)
    assert set(got) == {"motion"}
    assert torch.equal(got["motion"], camn.camn_forward(model, audio, spk)["motion"])


def test_camn_wav_encoder_variant_matches_jax():
    params = jblocks.init_wav_encoder(jax.random.PRNGKey(3), 64, "camn")
    enc = load_jax_params(WavEncoder(64, "camn", generator=torch.Generator()), np_tree(params))
    audio = _audio(1, seed=5)
    want = jax.jit(lambda p, x: jblocks.wav_encoder(p, x, 64, "camn"))(params, jnp.asarray(audio))
    got = enc(torch.from_numpy(audio))
    assert got.shape == (1, 15, 128)  # width fixed at 128 whatever out_dim is
    _close(got, want, "wav_encoder", ATOL)


@pytest.mark.parametrize("samples,frames", [(16000, 15), (48000, 45), (454400, 421)])
def test_camn_wav_encoder_out_len(samples, frames):
    assert wav_encoder_out_len(samples, 128, "camn") == frames
    assert jblocks.wav_encoder_out_len(samples, 128, "camn") == frames
    # the EMAGE default is unchanged
    assert wav_encoder_out_len(samples, 256) == jblocks.wav_encoder_out_len(samples, 256)


@pytest.mark.parametrize("family", ["camn", "disco"])
def test_full_width_trees_match_jax_shapes(family):
    """At the published widths the port's state_dict has exactly the JAX tree's paths
    and shapes (checked on abstract shapes: no full-size JAX init), and strict-loads
    it."""
    init, _, jcls, mod_cls, _, tcls = FAMILIES[family]
    tree = jax.eval_shape(lambda k: init(k, jcls()), jax.random.PRNGKey(0))
    module = mod_cls(tcls(), generator=torch.Generator().manual_seed(0))
    flat = {".".join(str(getattr(p, "key", p)) for p in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}
    assert {k: tuple(v.shape) for k, v in module.state_dict().items()} == flat
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), tree)
    load_jax_params(module, zeros)
    lstm_in = module.body_motion_decoder.weight_ih_l0.shape[1]
    assert lstm_in == {"camn": 258 + 1 + 16 + 128, "disco": 258 + 1 + 16 + 256}[family]
    if family == "camn":
        assert module.hands_motion_decoder.weight_ih_l0.shape[1] == 403 + 78


def test_speakerless_config_gives_zero_width_speaker_features():
    cfg = configs.CamnAudioConfig(**{**SMALL, "speaker_f": 0})
    model = CamnAudioModel(cfg, device="cpu")
    assert not hasattr(model, "speaker_embedding")
    assert model.body_motion_decoder.weight_ih_l0.shape[1] == 258 + 1 + 128
    out = model(torch.from_numpy(_audio(1)), torch.zeros(1, 1, dtype=torch.long))
    assert out["motion"].shape == (1, 15, 258)


def test_configs_masks_and_selection_match_jax():
    for name in ("CamnAudioConfig", "DiscoAudioConfig"):
        assert getattr(configs, name)().to_dict() == getattr(jcfgs, name)().to_dict()
    assert set(configs.CONFIG_REGISTRY) == set(jcfgs.CONFIG_REGISTRY)
    assert masking.MASK_DICT == jmasking.MASK_DICT
    assert sum(masking.MASK_DICT["local_upper"]) == 43
    x = np.random.RandomState(6).normal(0, 1, (2, 3, 165)).astype(np.float32)
    for mask in masking.MASK_DICT.values():
        got = masking.select_with_mask(torch.from_numpy(x), mask)
        np.testing.assert_array_equal(got.numpy(), jmasking.select_with_mask(x, mask))
        np.testing.assert_array_equal(masking.recover_from_mask(got, mask).numpy(),
                                      jmasking.recover_from_mask(np.asarray(got), mask))


def test_auto_classes_round_trip_a_checkpoint(pairs, tmp_path):
    _, _, model = pairs["disco"]
    saved = DiscoAudioModel(configs.DiscoAudioConfig(**SMALL), device="cpu")
    saved.load_state_dict(model.state_dict())
    saved.save_pretrained(str(tmp_path))
    assert isinstance(AutoConfig.from_pretrained(str(tmp_path)), configs.DiscoAudioConfig)
    back = AutoModel.from_pretrained(str(tmp_path), device="cpu")
    assert isinstance(back, DiscoAudioModel)
    for k, v in saved.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k


def test_entry_points_default_to_cuda():
    """With no device given, models go to the card; without one they raise instead
    of running on the CPU."""
    if torch.cuda.is_available():
        assert CamnAudioModel(configs.CamnAudioConfig(**SMALL)).body_out.fc1.weight.is_cuda
        return
    for cls, cfg in ((CamnAudioModel, configs.CamnAudioConfig),
                     (DiscoAudioModel, configs.DiscoAudioConfig)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls(cfg(**SMALL))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        camn_cli.main(["--random_init", "--audio_folder", ".", "--save_folder", "."])


def test_beat_format_save_upsampled_matches_jax(tmp_path):
    rng = np.random.RandomState(7)
    motion = rng.normal(0, 1, (9, 129)).astype(np.float32)  # 43 joints of local_upper
    mask = masking.MASK_DICT["local_upper"]
    expressions = rng.normal(0, 1, (9, 100)).astype(np.float32)
    for kw in ({"upsample": 2, "mask": mask}, {"upsample": 2, "expressions": expressions}):
        beat_format.beat_format_save(str(tmp_path / "port.npz"), motion, **kw)
        jbeat.beat_format_save(str(tmp_path / "jax.npz"), motion, **kw)
        got, want = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
        assert set(got.files) == set(want.files)
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["poses"].shape[0] == 18 and got["trans"].shape == (18, 3)
    np.testing.assert_array_equal(beat_format.time_upsample(expressions, 3),
                                  jbeat.time_upsample(expressions, 3))


def _write_wav(path, seconds, sr=16000):
    t = np.arange(int(seconds * sr)) / sr
    x = 0.3 * np.sin(2 * np.pi * 220 * t) * np.sin(2 * np.pi * 1.5 * t)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((x * 32767).astype("<i2").tobytes())


def test_camn_cli_random_init_on_cpu(tmp_path, capsys):
    """The full-width CaMN CLI on a 1 s clip: 15 frames at 15 fps, saved as 30 at 30 fps."""
    audio_dir, out_dir = tmp_path / "audio", tmp_path / "out"
    audio_dir.mkdir()
    _write_wav(audio_dir / "clip.wav", 1.0)
    camn_cli.main(["--random_init", "--device", "cpu", "--audio_folder", str(audio_dir),
                   "--save_folder", str(out_dir)])
    assert "generate total 1.00 seconds motion" in capsys.readouterr().out
    out = np.load(out_dir / "clip_output.npz")
    assert out["poses"].shape == (30, 165)
    assert np.isfinite(out["poses"]).all()
    assert out["betas"].shape == (300,) and int(out["mocap_frame_rate"]) == 30
