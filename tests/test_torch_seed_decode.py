"""The window step's seed decode (``models/emage.seed_decode_frames``): the seed from the
heads' last ``seed_frames + _decoder_halo`` frames equals the whole window's decode, one
frame fewer does not, and the AR loop decodes that tail in every dtype, against the JAX
package's full-window decode.

Models: the tokenizers at the published part widths (106/78/180/61, ``vae_layer`` 2, so
the halo is 7 and the tail 4 + 7 = 11 frames), and for the AR loop a narrow EMAGE model
at the published window (64 frames, seed 4), drawn by the port and carried into JAX
param trees as in tests/test_torch_bf16.py, whose bounds the bf16 run is held to.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pantomatrix_tpu.models import configs as jcfgs
from pantomatrix_tpu.models import emage as jemage
from pantomatrix_tpu.models import emage_vq as jvq
from pantomatrix_tpu_torch.io.hf_checkpoint import unflatten_params
from pantomatrix_tpu_torch.models import configs, emage, emage_vq
from pantomatrix_tpu_torch.models.api import EmageVQModel

torch.set_num_threads(2)

BF16 = torch.bfloat16
PRE, WINDOW, TAIL = 4, 64, 11
CB = 16
KW = dict(audio_f=32, motion_f=16, hidden_size=32, speaker_dims=4, pose_length=WINDOW,
          seed_frames=PRE, vae_codebook_size=CB, vae_length=CB, dropout_prob=0.0)
PART_DIMS = {"face": 106, "upper": 78, "hands": 180, "lower": 61}
GLOBAL_KW = dict(vae_layer=4, vae_length=48, vae_test_dim=61)
JCFG, TCFG = jcfgs.EmageAudioConfig(**KW), configs.EmageAudioConfig(**KW)
HEADS = ("upper_index", "hands_index", "lower_index")
FRAMES = 204  # 3 windows of stride 60 and a remainder window of 24 frames
SAMPLES = FRAMES * 16000 // 30


@pytest.fixture(scope="module")
def published_suite():
    return emage_vq.init_vq_suite(torch.Generator().manual_seed(19))


def _heads(size, seed, bs=2, cb=256):
    """Random network outputs of a ``size``-frame window at the published codebook."""
    g = torch.Generator().manual_seed(seed)
    return {f"{kind}_{part}": torch.randn(bs, size, cb, generator=g) * 2
            for kind in ("rec", "cls") for part in ("face", "upper", "hands", "lower")}


def _seed(suite, heads, n):
    cfg = configs.EmageAudioConfig()
    tail = {k: v[:, -n:] for k, v in heads.items()}
    return emage_vq.vq_decode(suite, **emage._select_decode_inputs(cfg, tail))[
        "all_motion4inference"][:, -cfg.seed_frames:]


def test_published_tokenizers_give_an_11_frame_tail(published_suite):
    assert emage._decoder_halo(published_suite) == TAIL - PRE
    assert emage.seed_decode_frames(PRE, published_suite, WINDOW) == TAIL
    assert emage.seed_decode_frames(PRE, published_suite, 24) == TAIL
    assert emage.seed_decode_frames(PRE, published_suite, TAIL - 1) == TAIL - 1


@pytest.mark.parametrize("size", [WINDOW, 24, TAIL + 1, TAIL, 8, PRE + 1])
def test_tail_seed_equals_full_window_seed(published_suite, size):
    """The seed decoded from the tail equals the whole window's last ``seed_frames``
    frames within 1e-6; from one frame fewer it does not, so the tail is as short as it
    can be. A remainder window no longer than the tail decodes whole."""
    heads = _heads(size, seed=size)
    n = emage.seed_decode_frames(PRE, published_suite, size)
    assert n == min(size, TAIL)
    with torch.no_grad():
        want = _seed(published_suite, heads, size)
        got = _seed(published_suite, heads, n)
        shorter = _seed(published_suite, heads, n - 1)
    assert got.shape == want.shape == (2, PRE, 337)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
    assert float((shorter - want).abs().max()) > 1e-4


def jax_tree(module):
    return jax.tree_util.tree_map(jnp.asarray, unflatten_params(
        {k: v.numpy() for k, v in module.state_dict().items()}))


@pytest.fixture(scope="module")
def pair():
    g = torch.Generator().manual_seed(0)
    model = emage.EmageAudio(TCFG, generator=g)
    vq_cfg = lambda dim: configs.EmageVQVAEConvConfig(vae_test_dim=dim, vae_length=CB,
                                                      vae_codebook_size=CB, vae_layer=2)
    parts = {name: emage_vq.EmageVQVAE(vq_cfg(dim), generator=g)
             for name, dim in PART_DIMS.items()}
    glob = emage_vq.EmageVAE(configs.EmageVAEConvConfig(**GLOBAL_KW), generator=g)
    jvq_cfg = lambda dim: jcfgs.EmageVQVAEConvConfig(vae_test_dim=dim, vae_length=CB,
                                                     vae_codebook_size=CB, vae_layer=2)
    jsuite = jvq.EmageVQSuite(
        global_motion=(jax_tree(glob), jcfgs.EmageVAEConvConfig(**GLOBAL_KW)),
        **{name: (jax_tree(m), jvq_cfg(PART_DIMS[name])) for name, m in parts.items()})
    return jax_tree(model), jsuite, model, EmageVQModel(global_motion=glob, **parts)


def f64(x):
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)


def corr(a, b):
    return float(np.corrcoef(f64(a).ravel(), f64(b).ravel())[0, 1])


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_ar_loop_decodes_the_tail_in_every_dtype(pair, monkeypatch, compute_dtype):
    """With a spy on ``vq_decode``: float32 and bfloat16 both decode 11 frames in each of
    the 3 window steps and in the 24-frame remainder. Float32 stays within 1e-5 of JAX,
    which decodes whole windows, with equal heads; bfloat16 within
    tests/test_torch_bf16.py's bounds of JAX's bf16 path."""
    params, jsuite, model, suite = pair
    audio = np.random.RandomState(2).uniform(-1, 1, (2, SAMPLES)).astype(np.float32)
    spk = np.zeros((2, 1), np.int64)
    _, _, rounds, remain = emage.prepare_ar_inputs(TCFG, torch.from_numpy(audio))
    assert (rounds, PRE + remain) == (3, 24)
    decoded, real = [], emage.vq_decode

    def spy(suite, **inputs):
        decoded.append(next(v for v in inputs.values() if v is not None).shape[1])
        return real(suite, **inputs)

    monkeypatch.setattr(emage, "vq_decode", spy)
    got = emage.emage_inference(model, torch.from_numpy(audio), torch.from_numpy(spk), suite,
                                compute_dtype=compute_dtype)
    assert decoded == [TAIL] * 4

    want = jemage.emage_inference(params, JCFG, jnp.asarray(audio), jnp.asarray(spk), jsuite,
                                  compute_dtype=compute_dtype)
    assert set(got) == set(want)
    sel = emage._select_decode_inputs(TCFG, got)
    jsel = jemage._select_decode_inputs(JCFG, want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        if compute_dtype is None:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-5,
                                       err_msg=k)
        else:
            assert got[k].dtype == BF16
            assert corr(got[k], want[k]) > 0.99, (k, corr(got[k], want[k]))
    for k in HEADS:
        if compute_dtype is None:
            np.testing.assert_array_equal(sel[k].numpy(), np.asarray(jsel[k]), err_msg=k)
        else:
            agree = float(np.mean(sel[k].numpy() == np.asarray(jsel[k])))
            assert agree > 0.95, (k, agree)
    if compute_dtype is not None:
        dec = real(suite, **sel)["all_motion4inference"]
        jdec = jvq.vq_decode(jsuite, **{k: v for k, v in jsel.items() if v is not None})
        assert corr(dec, jdec["all_motion4inference"]) > 0.99
