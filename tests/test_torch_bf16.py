"""The port's low-precision serving mode (``compute_dtype="bfloat16"``) and EMAGE's
``batched_wav`` against the JAX package on the CPU.

Models: the tiny EMAGE config and tokenizer suite of tests/test_bf16_inference.py,
drawn by the port and carried into JAX param trees, and its SMALL CaMN/DisCo config,
from a JAX init carried across by convert.py with a strict load; inputs from a numpy
seed.

Bounds. bfloat16 keeps 8 mantissa bits, and the AR loop's head argmax turns rounding
differences into discrete flips, so the whole-model comparisons (port bf16 against JAX
bf16, and against port fp32) use the bounds of tests/test_bf16_inference.py: every
network output correlates > 0.99, head indices agree on > 95% of frames, decoded motion
correlates > 0.99, and CaMN/DisCo rot6d correlates > 0.98, on that file's inputs. They
hold only away from near-ties of the 16-way head logits: with speaker ids (0, 3) in
place of (0, 0), the JAX package's own bf16 mode flips 1-3 of the 38 head indices
against its float32 path (agreement 0.92-0.97, decoded correlation 0.93-0.98), and the
port's bf16 mode flips as many. Beyond bf16 rounding, the port's LSTM recurrence runs in
float32 where the JAX scan carries bf16 (nn/lstm.py).
The primitives, on the same bf16 inputs, agree with JAX to one bf16 ulp (rtol 2^-7).
``batched_wav`` changes no arithmetic in float32, so it is held to 1e-5.
"""
import os
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pantomatrix_tpu.core import integrate as jintegrate
from pantomatrix_tpu.models import camn as jcamn
from pantomatrix_tpu.models import configs as jcfgs
from pantomatrix_tpu.models import disco as jdisco
from pantomatrix_tpu.models import emage as jemage
from pantomatrix_tpu.models import emage_vq as jvq
from pantomatrix_tpu.nn import attention as jattn
from pantomatrix_tpu.nn import blocks as jblocks
from pantomatrix_tpu.nn import layers as jlayers
from pantomatrix_tpu_torch.cli import test_camn as camn_cli
from pantomatrix_tpu_torch.cli import test_emage as emage_cli
from pantomatrix_tpu_torch.convert import load_jax_params
from pantomatrix_tpu_torch.core.integrate import velocity2position
from pantomatrix_tpu_torch.io.hf_checkpoint import unflatten_params
from pantomatrix_tpu_torch.models import camn, configs, disco, emage, emage_vq
from pantomatrix_tpu_torch.models.api import EmageVQModel
from pantomatrix_tpu_torch.nn import layers
from pantomatrix_tpu_torch.nn.attention import MultiheadAttention
from pantomatrix_tpu_torch.nn.lstm import LSTM
from pantomatrix_tpu_torch.ops import lstm_cuda
from pantomatrix_tpu_torch.utils.precision import cast_floating, cast_once, compute_dtype_of

torch.set_num_threads(2)

BF16 = torch.bfloat16
ULP = 2.0 ** -7  # one bfloat16 ulp, relative
CB = 16
KW = dict(audio_f=32, motion_f=16, hidden_size=32, speaker_dims=4, pose_length=8,
          seed_frames=2, vae_codebook_size=CB, vae_length=CB, dropout_prob=0.0)
PART_DIMS = {"face": 106, "upper": 78, "hands": 180, "lower": 61}
GLOBAL_KW = dict(vae_layer=4, vae_length=48, vae_test_dim=61)
JCFG, TCFG = jcfgs.EmageAudioConfig(**KW), configs.EmageAudioConfig(**KW)
SMALL = dict(audio_f=128, speaker_f=8, speaker_dims=4, hidden_size=48, n_layer=2,
             pose_dims=258, body_dims=78, hands_dims=180, dropout_prob=0.0)
HEADS = ("upper_index", "hands_index", "lower_index")


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def f64(x):
    """A JAX array or a torch tensor of any float dtype as float64 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)


def corr(a, b):
    return float(np.corrcoef(f64(a).ravel(), f64(b).ravel())[0, 1])


def jax_tree(module):
    """The JAX param tree of a port module: its state_dict, nested."""
    return jax.tree_util.tree_map(jnp.asarray, unflatten_params(
        {k: v.numpy() for k, v in module.state_dict().items()}))


@pytest.fixture(scope="module")
def pair():
    """The tiny model and suite of tests/test_bf16_inference.py, drawn by the port (a
    JAX init of this model costs 15-40 s on the CPU) and carried into JAX param trees;
    tests/test_torch_emage.py holds that the two trees have one structure."""
    g = torch.Generator().manual_seed(0)
    model = emage.EmageAudio(TCFG, generator=g)
    vq_cfg = lambda dim: configs.EmageVQVAEConvConfig(vae_test_dim=dim, vae_length=CB,
                                                      vae_codebook_size=CB, vae_layer=2)
    parts = {name: emage_vq.EmageVQVAE(vq_cfg(dim), generator=g)
             for name, dim in PART_DIMS.items()}
    glob = emage_vq.EmageVAE(configs.EmageVAEConvConfig(**GLOBAL_KW), generator=g)
    jvq_cfg = lambda dim: jcfgs.EmageVQVAEConvConfig(vae_test_dim=dim, vae_length=CB,
                                                     vae_codebook_size=CB, vae_layer=2)
    g_cfg = jcfgs.EmageVAEConvConfig(**GLOBAL_KW)
    jsuite = jvq.EmageVQSuite(
        global_motion=(jax_tree(glob), g_cfg),
        **{name: (jax_tree(m), jvq_cfg(PART_DIMS[name])) for name, m in parts.items()})
    return jax_tree(model), jsuite, model, EmageVQModel(global_motion=glob, **parts)


def _audio(bs=2, frames=3 * 6 + 2, seed=2):
    return np.random.RandomState(seed).uniform(-1, 1, (bs, frames * 533)).astype(np.float32)


SPK = np.array([[0], [3]])
SPK_BF16_TEST = np.zeros((2, 1), np.int64)  # the inputs of tests/test_bf16_inference.py
_jax_decode = jax.jit(lambda s, x: jvq.vq_decode(s, **x))


@pytest.fixture(scope="module")
def emage_runs(pair):
    """Port bf16, JAX bf16 and port fp32 inference on the inputs of
    tests/test_bf16_inference.py, each with its own head routing and float32 decode."""
    params, jsuite, model, suite = pair
    audio, spk = _audio(), SPK_BF16_TEST
    runs = {}
    for name, dt in (("port_bf16", "bfloat16"), ("port_fp32", None)):
        out = emage.emage_inference(model, torch.from_numpy(audio), torch.from_numpy(spk),
                                    suite, compute_dtype=dt)
        sel = emage._select_decode_inputs(TCFG, out)
        runs[name] = out, sel, emage_vq.vq_decode(suite, **sel)
    out = jemage.emage_inference(params, JCFG, jnp.asarray(audio), jnp.asarray(spk), jsuite,
                                 compute_dtype="bfloat16")
    sel = jemage._select_decode_inputs(JCFG, out)
    runs["jax_bf16"] = out, sel, _jax_decode(jsuite, {k: v for k, v in sel.items()
                                                      if v is not None})
    return runs


@pytest.mark.parametrize("reference", ["jax_bf16", "port_fp32"])
def test_emage_bf16_within_bf16_bounds(emage_runs, reference):
    got, got_sel, got_dec = emage_runs["port_bf16"]
    want, want_sel, want_dec = emage_runs[reference]
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert corr(got[k], want[k]) > 0.99, (k, corr(got[k], want[k]))
    for k in HEADS:
        agree = float(np.mean(got_sel[k].numpy() == np.asarray(want_sel[k])))
        assert agree > 0.95, (k, agree)
    c = corr(got_dec["all_motion4inference"], want_dec["all_motion4inference"])
    assert c > 0.99, c


def test_emage_bf16_dtypes(pair, emage_runs):
    """Network outputs in bf16 as in JAX; the decode, with translation, in float32."""
    _, _, model, suite = pair
    out, sel, _ = emage_runs["port_bf16"]
    jout = emage_runs["jax_bf16"][0]
    for k in out:
        assert out[k].dtype == BF16 and jout[k].dtype == jnp.bfloat16, k
    dec = emage_vq.vq_decode(suite, **sel, get_global_motion=True,
                             ref_trans=torch.zeros(2, 1, 3))
    for k in ("motion_axis_angle", "expression", "trans", "all_motion4inference"):
        assert dec[k].dtype == torch.float32, k
    # the parity path's model is untouched: still float32 after the bf16 run
    assert model.mask_embedding.dtype == torch.float32


def _jax_window_features(params, audio, rounds):
    """The JAX WavEncoders over every full window: one flattened batch, and per window."""
    window, stride = JCFG.pose_length, JCFG.pose_length - JCFG.seed_frames
    spf = jemage.SAMPLES_PER_FRAME
    wins = jnp.stack([audio[:, i * stride * spf:(i * stride + window) * spf]
                      for i in range(rounds)])
    enc = lambda p, x: jblocks.wav_encoder(p, x, JCFG.audio_f, "emage")
    out = {}
    for name in ("audio_encoder_face", "audio_encoder_body"):
        flat = enc(params[name], wins.reshape(rounds * audio.shape[0], -1))
        out[name] = (flat.reshape(rounds, audio.shape[0], *flat.shape[1:]),
                     jnp.stack([enc(params[name], w) for w in wins]))
    return out


def test_batched_wav_features_equal_per_window_features(pair):
    params, _, model, _ = pair
    audio = _audio()
    rounds = emage.prepare_ar_inputs(TCFG, torch.from_numpy(audio))[2]
    feats = emage.batched_audio_features(model, torch.from_numpy(audio), rounds)
    assert len(feats) == rounds == 2
    window, stride = TCFG.pose_length, TCFG.pose_length - TCFG.seed_frames
    spf = emage.SAMPLES_PER_FRAME
    jfeats = jax.jit(_jax_window_features, static_argnums=2)(params, jnp.asarray(audio),
                                                              rounds)
    for i, (face, body) in enumerate(feats):
        win = torch.from_numpy(audio[:, i * stride * spf:(i * stride + window) * spf])
        for name, got, enc in (("audio_encoder_face", face, model.audio_encoder_face),
                               ("audio_encoder_body", body, model.audio_encoder_body)):
            with torch.no_grad():
                want = enc(win)
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
            batched, per_window = jfeats[name]
            np.testing.assert_allclose(np.asarray(batched[i]), np.asarray(per_window[i]),
                                       rtol=0, atol=1e-5)
            np.testing.assert_allclose(got.numpy(), np.asarray(batched[i]), rtol=0, atol=1e-5)


def test_batched_wav_end_to_end_against_jax(pair):
    params, jsuite, model, suite = pair
    audio = _audio(frames=24, seed=7)  # 3 windows and a remainder
    want = jemage.emage_inference(params, JCFG, jnp.asarray(audio), jnp.asarray(SPK), jsuite,
                                  batched_wav=True)
    got = emage.emage_inference(model, torch.from_numpy(audio), torch.from_numpy(SPK), suite,
                                batched_wav=True)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-5,
                                   err_msg=k)
    jsel = jemage._select_decode_inputs(JCFG, want)
    sel = emage._select_decode_inputs(TCFG, got)
    for k in HEADS:
        np.testing.assert_array_equal(sel[k].numpy(), np.asarray(jsel[k]), err_msg=k)
    # and it is the parity path's output: batched_wav changes no float32 arithmetic here
    plain = emage.emage_inference(model, torch.from_numpy(audio), torch.from_numpy(SPK), suite)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), plain[k].numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("rounds,bs,batched", [
    (1, 1, True), (64, 8, True), (512, 1, True), (513, 1, False), (65, 8, False),
    (29, 128, False), (0, 8, False)])
def test_batched_wav_gate_at_512_window_rows(rounds, bs, batched):
    assert emage.BATCHED_WAV_MAX == 512
    assert emage.use_batched_wav(rounds, bs) is batched


def test_batched_wav_above_the_gate_runs_the_per_window_encoder(pair, monkeypatch):
    _, _, model, suite = pair
    audio, spk = torch.from_numpy(_audio(frames=24, seed=7)), torch.from_numpy(SPK)
    calls = []
    hook = model.audio_encoder_face.register_forward_hook(
        lambda m, args, out: calls.append(args[0].shape[0]))
    try:
        emage.emage_inference(model, audio, spk, suite, batched_wav=True)
        assert calls == [3 * 2, 2]  # one batched call over 3 windows x 2 rows, remainder
        calls.clear()
        monkeypatch.setattr(emage, "BATCHED_WAV_MAX", 5)  # 6 window-rows: above it
        emage.emage_inference(model, audio, spk, suite, batched_wav=True)
        assert calls == [2, 2, 2, 2]  # per window, as the parity path
    finally:
        hook.remove()


FAMILIES = {
    "camn": (jcamn.init_camn, jcamn.camn_forward, jcfgs.CamnAudioConfig, camn.CamnAudio,
             camn.camn_forward, configs.CamnAudioConfig),
    "disco": (jdisco.init_disco, jdisco.disco_forward, jcfgs.DiscoAudioConfig,
              disco.DiscoAudio, disco.disco_forward, configs.DiscoAudioConfig),
}


@pytest.mark.parametrize("family", ["camn", "disco"])
def test_camn_disco_bf16_against_jax_bf16_and_port_fp32(family):
    init, jfwd, jcls, mod_cls, fwd, tcls = FAMILIES[family]
    params = jax.jit(lambda k: init(k, jcls(**SMALL)))(jax.random.PRNGKey(3))
    model = load_jax_params(mod_cls(tcls(**SMALL), generator=torch.Generator()),
                            np_tree(params))
    rng = np.random.RandomState(5)
    audio = rng.uniform(-1, 1, (2, 32000)).astype(np.float32)
    seed = rng.uniform(-1, 1, (2, 6, 258)).astype(np.float32)
    spk = np.array([[0], [2]])
    want = jax.jit(lambda p, a, s, sm: jfwd(p, jcls(**SMALL), a, s, seed_motion=sm,
                                            compute_dtype="bfloat16"))(
        params, jnp.asarray(audio), jnp.asarray(spk), jnp.asarray(seed))
    args = (torch.from_numpy(audio), torch.from_numpy(spk))
    got = fwd(model, *args, seed_motion=torch.from_numpy(seed), compute_dtype="bfloat16")
    fp32 = fwd(model, *args, seed_motion=torch.from_numpy(seed))
    for out in (got, fp32):
        assert out["motion"].dtype == torch.float32
        assert out["motion_axis_angle"].dtype == torch.float32
    assert corr(got["motion"], want["motion"]) > 0.98
    assert corr(got["motion"], fp32["motion"]) > 0.98
    assert corr(got["motion_axis_angle"], want["motion_axis_angle"]) > 0.98
    if family == "disco":  # the audio features stay in the compute dtype, as in JAX
        assert got["audio_fea_c"].dtype == BF16 and want["audio_fea_c"].dtype == jnp.bfloat16


def test_bf16_lstm_route_is_the_float32_recurrence_on_bf16_values():
    """The bf16 LSTM: a bf16 input projection, then the float32 recurrence (K2's plain
    version here) on the exactly upcast bf16 x_proj and W_hh, cast back per layer."""
    h, layers_ = 48, 2
    lstm = cast_floating(LSTM(40, h, layers_, generator=torch.Generator().manual_seed(0)),
                         BF16)
    x = torch.randn(3, 11, 40, generator=torch.Generator().manual_seed(1)).to(BF16)
    launches = lstm_cuda.launches
    got = lstm(x)
    assert lstm_cuda.launches == launches  # the CPU takes the plain version
    y = x.transpose(0, 1)
    for layer in range(layers_):
        p = lambda n: [getattr(lstm, f"{n}_l{layer}{s}") for s in ("", "_reverse")]
        x_proj = torch.matmul(y, torch.cat(p("weight_ih")).T) + (
            torch.cat(p("bias_ih")) + torch.cat(p("bias_hh")))
        assert x_proj.dtype == BF16
        y = lstm_cuda.lstm_bidirectional_plain(x_proj.float(), torch.stack(p("weight_hh")).float(),
                                               h).to(BF16)
    assert got.dtype == BF16
    assert torch.equal(got, y.transpose(0, 1))


def _bf16_pair(shape, rng, scale=1.0):
    x = jnp.asarray(rng.normal(0, scale, shape).astype(np.float32)).astype(jnp.bfloat16)
    return x, torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(BF16)


def _within_ulp(got, want, of_scale=False):
    """Within one bf16 ulp of each element, or with ``of_scale`` one ulp of the output's
    RMS: a product whose float32 sum rounds to the other neighbour moves the outputs
    after it by one ulp of that product's scale, which near zero is many ulps."""
    want = f64(want)
    atol = ULP * float(np.sqrt(np.mean(want ** 2))) if of_scale else 0.0
    np.testing.assert_allclose(f64(got), want, rtol=ULP, atol=atol)


def test_batch_norm1d_and_layer_norm_bf16_against_jax():
    rng = np.random.RandomState(0)
    c = 24
    jx, tx = _bf16_pair((3, 17, c), rng, 3.0)
    stats = {"running_mean": rng.normal(0, 1, c), "running_var": rng.uniform(0.5, 2, c),
             "weight": rng.normal(1, 0.2, c), "bias": rng.normal(0, 1, c)}
    jp = {k: jnp.asarray(v.astype(np.float32)).astype(jnp.bfloat16) for k, v in stats.items()}
    tp = {k: torch.from_numpy(np.asarray(v.astype(jnp.float32))).to(BF16) for k, v in jp.items()}
    want = jax.jit(jlayers.batch_norm1d)(jp, jx)
    got = layers.batch_norm1d(tx, tp["running_mean"], tp["running_var"], tp["weight"],
                              tp["bias"])
    assert got.dtype == BF16
    _within_ulp(got, want)
    ln = {"weight": jp["weight"], "bias": jp["bias"]}
    want = jax.jit(jlayers.layer_norm)(ln, jx)
    got = layers.layer_norm(tx, tp["weight"], tp["bias"])
    assert got.dtype == BF16
    _within_ulp(got, want)
    # the float32 forms are unchanged
    x32 = tx.float()
    assert torch.equal(layers.layer_norm(x32, tp["weight"].float(), tp["bias"].float()),
                       torch.nn.functional.layer_norm(x32, (c,), tp["weight"].float(),
                                                      tp["bias"].float()))


def test_attention_bf16_against_jax():
    e, heads = 32, 4
    jp = jattn.init_transformer_decoder(jax.random.PRNGKey(4), 1, e, 2 * e)["layers"]["0"]
    jp = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), jp["self_attn"])
    mha = load_jax_params(MultiheadAttention(e, heads, generator=torch.Generator()),
                          np_tree(jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), jp)))
    mha = cast_floating(mha, BF16)
    rng = np.random.RandomState(5)
    jq, tq = _bf16_pair((2, 9, e), rng)
    jk, tk = _bf16_pair((2, 13, e), rng)
    want = jax.jit(lambda p, q, k: jattn.multi_head_attention(p, q, k, k, heads))(jp, jq, jk)
    got = mha(tq, tk, tk)
    assert got.dtype == BF16
    _within_ulp(got, want, of_scale=True)


def test_velocity2position_bf16_accumulates_in_float32_as_jax():
    rng = np.random.RandomState(6)
    jv, tv = _bf16_pair((2, 300, 3), rng)
    ji, ti = _bf16_pair((2, 3), rng)
    want = jintegrate.velocity2position(jv, 1.0 / 30, ji)
    got = velocity2position(tv, 1.0 / 30, ti)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(f64(got), f64(want), rtol=1e-5, atol=0)


def test_cast_floating_keeps_integer_buffers_and_cast_once_reuses_its_copy():
    bn = layers.BatchNorm1d(8)
    with torch.no_grad():
        bn.num_batches_tracked.fill_(7)
    cast = cast_floating(bn, BF16)
    assert cast is not bn and cast.weight.dtype == BF16 and cast.running_var.dtype == BF16
    assert cast.num_batches_tracked.dtype == torch.long
    assert cast.num_batches_tracked is bn.num_batches_tracked  # shared, not copied
    assert bn.weight.dtype == torch.float32  # the original is untouched
    assert cast_once(bn, None) is bn
    first = cast_once(bn, BF16)
    assert cast_once(bn, BF16) is first  # kept while the weights are unchanged
    with torch.no_grad():
        bn.weight.mul_(2)
    again = cast_once(bn, BF16)
    assert again is not first and torch.equal(again.weight, (bn.weight.detach()).to(BF16))
    # a copy of a module carries none of its kept copies
    assert not cast_floating(bn, BF16).__dict__.get("_compute_dtype_copies")


@pytest.mark.parametrize("name,want", [(None, None), ("float32", None), ("bfloat16", BF16),
                                       (BF16, BF16), (torch.float32, None)])
def test_compute_dtype_names(name, want):
    assert compute_dtype_of(name) == want


def test_compute_dtype_rejects_other_names():
    with pytest.raises(ValueError, match="compute_dtype"):
        compute_dtype_of("int8")


def _write_wav(path, seconds=2.0, sr=16000):
    t = np.arange(int(seconds * sr)) / sr
    x = 0.3 * np.sin(2 * np.pi * 220 * t) * np.sin(2 * np.pi * 1.5 * t)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((x * 32767).astype("<i2").tobytes())


@pytest.mark.parametrize("cli,flags,frames", [
    (emage_cli, ["--compute_dtype", "bfloat16", "--batched_wav"], 60),
    (camn_cli, ["--compute_dtype", "bfloat16"], 60)], ids=["emage", "camn"])
def test_cli_bf16_writes_a_beat_npz(tmp_path, cli, flags, frames):
    audio_dir, out_dir = tmp_path / "audio", tmp_path / "out"
    audio_dir.mkdir()
    _write_wav(audio_dir / "clip.wav")
    cli.main(["--random_init", "--device", "cpu", "--audio_folder", str(audio_dir),
              "--save_folder", str(out_dir), *flags])
    out = np.load(out_dir / "clip_output.npz")
    assert out["poses"].shape == (frames, 165)
    assert out["trans"].shape == (frames, 3)
    for k in ("poses", "expressions", "trans"):
        assert np.isfinite(out[k]).all(), k
    assert os.path.exists(out_dir / "clip_output.npz")
