"""The port's EMAGE slice (pantomatrix_tpu_torch.models) against the JAX package on
the CPU, at the tiny config of tests/test_models_emage.py: weights from a JAX init,
carried across by convert.py with a strict load; inputs made from a numpy seed.

Tolerances: exact equality on integer indices; atol 1e-4 on every float the networks
produce (float32 through ~30 layers; measured differences stay below 2e-6), the
expression, the translation and the foot channels. The decoded rotations
(``motion_axis_angle`` and the rot6d channels of ``all_motion4inference``) pass through
the reference's matrix -> quaternion step, which takes a square root per component
and so is only 1/2-Hoelder near a zero component: float32 differences of ~1e-6
upstream can become ~1e-3 there (test_torch_layers measures the float32 error of that
step against float64 at up to 1e-3 on 2e5 random rotations). Those outputs are held
to 2e-3; the largest difference measured here is 3.1e-4.
At this config the autoregressive loop matches end to end, so the AR test compares
whole sequences; K1 on the CPU is its plain version.
"""
import os
import wave

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pantomatrix_tpu.io.hf_checkpoint import load_params as jax_load_params
from pantomatrix_tpu.models import configs as jcfgs
from pantomatrix_tpu.models import emage as jemage
from pantomatrix_tpu.models import emage_vq as jvq
from pantomatrix_tpu.nn.vq import nearest_code as jax_nearest_code
from pantomatrix_tpu_torch.cli import test_emage as cli
from pantomatrix_tpu_torch.convert import from_jax_params, load_jax_params
from pantomatrix_tpu_torch.io.hf_checkpoint import unflatten_params
from pantomatrix_tpu_torch.models import configs, emage, emage_vq
from pantomatrix_tpu_torch.models.api import EmageAudioModel, EmageVQModel
from pantomatrix_tpu_torch.ops import vq_cuda

torch.set_num_threads(2)

ATOL = 1e-4
ROT_ATOL = 2e-3  # decoded rotations, see the module docstring
CB = 16
KW = dict(audio_f=32, motion_f=16, hidden_size=32, speaker_dims=4, pose_length=8,
          seed_frames=2, vae_codebook_size=CB, vae_length=CB, dropout_prob=0.0)
PART_DIMS = {"face": 106, "upper": 78, "hands": 180, "lower": 61}
GLOBAL_KW = dict(vae_layer=4, vae_length=48, vae_test_dim=61)
JCFG = jcfgs.EmageAudioConfig(**KW)
TCFG = configs.EmageAudioConfig(**KW)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# jitted JAX references (first eager calls compile every primitive: several times slower)
_jax_forward = jax.jit(jemage.emage_forward, static_argnums=1)
_jax_part_decode = {"index": jax.jit(jvq.vqvae_decode_index, static_argnums=1),
                    "latent": jax.jit(jvq.vqvae_decode_latent, static_argnums=1)}


def _jax_init(key):
    k_model, *ks = jax.random.split(key, 6)
    parts = {}
    for k, (name, dim) in zip(ks, PART_DIMS.items()):
        c = jcfgs.EmageVQVAEConvConfig(vae_test_dim=dim, vae_length=CB, vae_codebook_size=CB)
        p = jvq.init_emage_vqvae(k, c)
        # unit-scale codes in place of the reference's U(+-1/K) draw, so the decoded 6D
        # rows have unit scale, where the 6D -> axis-angle conversion is well conditioned
        p["quantizer"]["embedding"]["weight"] = jax.random.normal(k, (CB, CB))
        parts[name] = (p, c)
    gc = jcfgs.EmageVAEConvConfig(**GLOBAL_KW)
    suite = jvq.EmageVQSuite(global_motion=(jvq.init_emage_vae(ks[4], gc), gc), **parts)
    return jemage.init_emage(k_model, JCFG), suite


@pytest.fixture(scope="module")
def pair():
    """JAX-initialised model and tokenizer suite, and the port's modules strictly
    loaded from them."""
    params, jsuite = jax.jit(_jax_init)(jax.random.PRNGKey(0))
    g = torch.Generator().manual_seed(0)
    model = load_jax_params(emage.EmageAudio(TCFG, generator=g), np_tree(params))
    parts = {
        name: load_jax_params(
            emage_vq.EmageVQVAE(configs.EmageVQVAEConvConfig(
                vae_test_dim=dim, vae_length=CB, vae_codebook_size=CB), generator=g),
            np_tree(getattr(jsuite, name)[0]))
        for name, dim in PART_DIMS.items()
    }
    glob = load_jax_params(
        emage_vq.EmageVAE(configs.EmageVAEConvConfig(**GLOBAL_KW), generator=g),
        np_tree(jsuite.global_motion[0]))
    return params, jsuite, model, EmageVQModel(global_motion=glob, **parts)


def _audio(frames, seed=7):
    return np.random.RandomState(seed).uniform(-0.5, 0.5, (2, frames * 533)).astype(np.float32)


def _close(got, want, name, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=atol,
                               err_msg=name)


def test_strict_load_of_jax_initialised_tree(pair):
    params, jsuite, model, suite = pair
    for module, tree in [(model, params), (suite.face, jsuite.face[0]),
                         (suite.global_motion, jsuite.global_motion[0])]:
        flat = from_jax_params(np_tree(tree))
        sd = module.state_dict()
        assert set(sd) == set(flat)
        for k, v in flat.items():
            np.testing.assert_array_equal(sd[k].numpy(), v.numpy(), err_msg=k)
    # the reference's spelling and the PE buffer are part of the tree
    assert "moton_proj.weight" in sd or "moton_proj.weight" in model.state_dict()
    assert "position_embeddings.pe" in model.state_dict()
    # strict: a missing or an extra key fails the load
    flat = np_tree(params)
    del flat["face_cls"]["fc2"]["bias"]
    with pytest.raises(RuntimeError, match="Missing key"):
        load_jax_params(emage.EmageAudio(TCFG, generator=torch.Generator()), flat)
    flat = np_tree(params)
    flat["face_cls"]["fc3"] = {"bias": np.zeros(3, np.float32)}
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_jax_params(emage.EmageAudio(TCFG, generator=torch.Generator()), flat)


def test_full_width_trees_match_jax_shapes():
    """At the published widths the port's state_dicts have exactly the JAX trees'
    paths and shapes (checked on abstract shapes: no full-size JAX init)."""
    g = torch.Generator().manual_seed(0)
    jax_model = jax.eval_shape(lambda k: jemage.init_emage(k, jcfgs.EmageAudioConfig()),
                               jax.random.PRNGKey(0))
    jax_suite = jax.eval_shape(jvq.init_vq_suite, jax.random.PRNGKey(0))
    port_suite = emage_vq.init_vq_suite(g)
    pairs = [(emage.EmageAudio(configs.EmageAudioConfig(), generator=g), jax_model)]
    pairs += [(getattr(port_suite, n), getattr(jax_suite, n)[0])
              for n in (*PART_DIMS, "global_motion")]
    for module, tree in pairs:
        want = {k: tuple(v.shape) for k, v in
                zip(_flat_keys(tree), jax.tree_util.tree_leaves(tree))}
        got = {k: tuple(v.shape) for k, v in module.state_dict().items()}
        assert got == want


def _flat_keys(tree, prefix=""):
    keys = []
    for k in sorted(tree):  # jax flattens dicts in sorted-key order
        if isinstance(tree[k], dict):
            keys += _flat_keys(tree[k], f"{prefix}{k}.")
        else:
            keys.append(f"{prefix}{k}")
    return keys


def test_emage_forward_one_window(pair):
    params, _, model, _ = pair
    bs, t = 2, JCFG.pose_length
    audio = _audio(t)
    rng = np.random.RandomState(3)
    motion = rng.uniform(-1, 1, (bs, t, 337)).astype(np.float32)
    mask = (rng.uniform(size=(bs, t, 1)) < 0.5).astype(np.float32) * np.ones((1, 1, 337),
                                                                             np.float32)
    spk = np.array([[0], [3]])
    want = _jax_forward(params, JCFG, jnp.asarray(audio), jnp.asarray(spk),
                        jnp.asarray(motion), jnp.asarray(mask))
    got = emage.emage_forward(model, torch.from_numpy(audio), torch.from_numpy(spk),
                              torch.from_numpy(motion), torch.from_numpy(mask))
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], k)


_jax_decode = jax.jit(
    lambda s, x, rt: jvq.vq_decode(s, **x, get_global_motion=True, ref_trans=rt))


def _compare_decode(suite, jsuite, sel, ref_trans):
    want = _jax_decode(jsuite, {k: jnp.asarray(v) for k, v in sel.items()},
                       jnp.asarray(ref_trans))
    got = emage_vq.vq_decode(suite, **{k: torch.from_numpy(v) for k, v in sel.items()},
                             get_global_motion=True, ref_trans=torch.from_numpy(ref_trans))
    assert set(got) == set(want)
    for k in want:
        if k == "all_motion4inference":
            _close(got[k][..., :330], want[k][..., :330], "rot6d", atol=ROT_ATOL)
            _close(got[k][..., 330:], want[k][..., 330:], "transfoot")
        else:
            _close(got[k], want[k], k, atol=ROT_ATOL if k == "motion_axis_angle" else ATOL)


@pytest.mark.parametrize("route", ["indices", "latents"])
def test_vq_decode(pair, route):
    _, jsuite, _, suite = pair
    rng = np.random.RandomState(1)
    bs, t = 2, 12
    kind = {"indices": "index", "latents": "latent"}[route]
    if route == "indices":
        sel = {f"{p}_index": rng.randint(0, CB, (bs, t)).astype(np.int32) for p in PART_DIMS}
    else:  # every part re-quantized through K1
        sel = {f"{p}_latent": rng.normal(0, 1, (bs, t, CB)).astype(np.float32)
               for p in PART_DIMS}
    for p in PART_DIMS:  # each part network, then the whole decode
        x = sel[f"{p}_{kind}"]
        want = _jax_part_decode[kind](*getattr(jsuite, p), jnp.asarray(x))
        got = getattr(emage_vq, f"vqvae_decode_{kind}")(getattr(suite, p), torch.from_numpy(x))
        _close(got, want, p)
        if kind == "latent":
            cb = getattr(suite, p).quantizer.embedding.weight.detach()
            np.testing.assert_array_equal(
                vq_cuda.nearest_code(torch.from_numpy(x), cb).numpy(),
                np.asarray(jax_nearest_code(jnp.asarray(x), jnp.asarray(cb.numpy()))))
    _compare_decode(suite, jsuite, sel, rng.uniform(-1, 1, (bs, t, 3)).astype(np.float32))


@pytest.mark.parametrize("frames", [23, 7], ids=["3-windows-and-remainder", "remainder-only"])
def test_emage_inference_and_decode_end_to_end(pair, frames):
    params, jsuite, model, suite = pair
    audio, spk = _audio(frames), np.array([[1], [2]])
    _, _, rounds, _ = emage.prepare_ar_inputs(TCFG, torch.from_numpy(audio))
    assert rounds == {23: 3, 7: 0}[frames]
    want = jemage.emage_inference(params, JCFG, jnp.asarray(audio), jnp.asarray(spk), jsuite)
    got = model_out = emage.emage_inference(model, torch.from_numpy(audio),
                                            torch.from_numpy(spk), suite)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        _close(got[k], want[k], k)
    jsel = jemage._select_decode_inputs(JCFG, want)
    sel = emage._select_decode_inputs(TCFG, model_out)
    for k in ("upper_index", "hands_index", "lower_index"):
        np.testing.assert_array_equal(sel[k].numpy(), np.asarray(jsel[k]), err_msg=k)
    # final decode of the whole sequence from the port's own heads, as the CLI runs it
    sel = {k: v.numpy() for k, v in sel.items() if v is not None}
    _compare_decode(suite, jsuite, sel, np.zeros((1, 3), np.float32))


def _given_motion_and_mask(frames, bs=2):
    """Caller-given motion, and a mask (0 = take the given motion) that opens the first
    seed, window 2's seed slots and a few frames inside windows, differently per clip.
    Shorter than the clip: prepare_ar_inputs pads both to the clip's frames."""
    rng = np.random.RandomState(11)
    motion = rng.uniform(-1, 1, (bs, frames, 337)).astype(np.float32)
    mask = np.ones((bs, frames, 337), np.float32)
    mask[:, :2] = 0
    mask[:, 6:8] = 0
    mask[0, 12:15] = 0
    mask[1, 9] = 0
    return motion, mask


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_emage_inference_with_given_motion_and_mask(pair, compute_dtype):
    """The AR loop with a caller-given ``masked_motion`` and ``mask``: the seed slots
    come from the given motion, not the decoded tail. Float32: every output within
    1e-5 of JAX and head indices equal. bfloat16: the bounds of tests/test_torch_bf16.py
    (correlation > 0.99, head-index agreement > 0.95)."""
    params, jsuite, model, suite = pair
    audio, spk = _audio(23), np.array([[1], [2]])  # 22 frames: 3 windows
    motion, mask = _given_motion_and_mask(20)
    want = jemage.emage_inference(params, JCFG, jnp.asarray(audio), jnp.asarray(spk), jsuite,
                                  jnp.asarray(motion), jnp.asarray(mask),
                                  compute_dtype=compute_dtype)
    got = emage.emage_inference(model, torch.from_numpy(audio), torch.from_numpy(spk), suite,
                                torch.from_numpy(motion), torch.from_numpy(mask),
                                compute_dtype=compute_dtype)
    # the given motion reaches the network: without it the outputs differ
    free = emage.emage_inference(model, torch.from_numpy(audio), torch.from_numpy(spk), suite,
                                 compute_dtype=compute_dtype)
    assert not torch.equal(got["rec_upper"], free["rec_upper"])
    assert set(got) == set(want)
    jsel = jemage._select_decode_inputs(JCFG, want)
    sel = emage._select_decode_inputs(TCFG, got)
    for k in want:
        assert got[k].shape == want[k].shape, k
        if compute_dtype is None:
            _close(got[k], want[k], k, atol=1e-5)
        else:
            a = got[k].double().numpy().ravel()
            b = np.asarray(want[k].astype(jnp.float32), np.float64).ravel()
            assert np.corrcoef(a, b)[0, 1] > 0.99, k
    for k in ("upper_index", "hands_index", "lower_index"):
        if compute_dtype is None:
            np.testing.assert_array_equal(sel[k].numpy(), np.asarray(jsel[k]), err_msg=k)
        else:
            assert float(np.mean(sel[k].numpy() == np.asarray(jsel[k]))) > 0.95, k


def test_short_audio_raises(pair):
    _, _, model, suite = pair
    with pytest.raises(ValueError, match="too short"):
        emage.emage_inference(model, torch.zeros(1, 533 * 3), torch.zeros(1, 1, dtype=torch.long),
                              suite)


def test_checkpoint_round_trip_and_jax_reads_it(pair, tmp_path):
    params, _, _, _ = pair
    model = load_jax_params(EmageAudioModel(TCFG, device="cpu"), np_tree(params))
    model.save_pretrained(str(tmp_path))
    back = EmageAudioModel.from_pretrained(str(tmp_path), device="cpu")
    assert back.config.to_dict() == TCFG.to_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    # the JAX package loads the same directory into its own param tree, which nests
    # exactly as the port's state_dict does
    jtree = np_tree(jax_load_params(str(tmp_path)))
    for k, v in from_jax_params(jtree).items():
        np.testing.assert_array_equal(v.numpy(), model.state_dict()[k].numpy(), err_msg=k)
    port_tree = unflatten_params({k: v.numpy() for k, v in model.state_dict().items()})
    assert (jax.tree_util.tree_structure(port_tree) == jax.tree_util.tree_structure(jtree)
            == jax.tree_util.tree_structure(np_tree(params)))


def test_entry_points_default_to_cuda():
    """With no device given, models go to the card; without one they raise instead
    of running on the CPU."""
    if torch.cuda.is_available():
        assert EmageVQModel.random().face.quantizer.embedding.weight.is_cuda
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EmageVQModel.random()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EmageAudioModel(TCFG)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--random_init", "--audio_folder", ".", "--save_folder", "."])


def _write_wav(path, seconds, sr):
    t = np.arange(int(seconds * sr)) / sr
    x = 0.3 * np.sin(2 * np.pi * 220 * t) * np.sin(2 * np.pi * 1.5 * t)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((x * 32767).astype("<i2").tobytes())


def test_cli_random_init_on_cpu(tmp_path):
    """The full-width CLI path on a 3 s clip, read at 24 kHz and resampled to 16 kHz."""
    audio_dir, out_dir = tmp_path / "audio", tmp_path / "out"
    audio_dir.mkdir()
    _write_wav(audio_dir / "clip.wav", 3.0, 24000)
    cli.main(["--random_init", "--device", "cpu", "--audio_folder", str(audio_dir),
              "--save_folder", str(out_dir)])
    out = np.load(out_dir / "clip_output.npz")
    t = 3 * 30
    assert out["poses"].shape == (t, 165)
    assert out["expressions"].shape == (t, 100)
    assert out["trans"].shape == (t, 3)
    assert out["betas"].shape == (300,)
    for k in ("poses", "expressions", "trans"):
        assert np.isfinite(out[k]).all(), k
    assert int(out["mocap_frame_rate"]) == 30
    assert os.path.exists(out_dir / "clip_output.npz")
