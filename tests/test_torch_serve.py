"""The port's serving engines (pantomatrix_tpu_torch.serve), its CUDA-graph routing,
benchmark and entry point, against the JAX package on the CPU.

The tiny EMAGE config of tests/test_serve.py; one set of weights per file, drawn from a
seed and held by both packages (make_stacks), the port's strict-loaded from the JAX
package's param trees by convert.load_jax_params; inputs made from a numpy seed. The VQ
codebooks are unit-scale normal draws (tests/test_torch_emage.py says why: the decoded
6D rows are then well conditioned). Tolerances: latents and logits 1e-5, head indices
equal; decoded expressions and translation 1e-5; decoded rotations 2e-3, because they
pass through the reference's sqrt-based matrix -> quaternion step (tests/test_torch_emage.py
measures it). Port against port (streaming against offline) is exact on the CPU.

The JAX StreamingPool stacks each session's start translation into an (N, 3) array,
which its vq_get_global_motion reads as one clip's (T, 3): every pooled session's
translation then starts from session 0's position. The port passes (N, 1, 3);
test_pool_sessions_keep_their_own_translation shows both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pantomatrix_tpu import serve as jserve
from pantomatrix_tpu.models import api as japi
from pantomatrix_tpu.models import configs as jcfgs
from pantomatrix_tpu.models import emage as jemage
from pantomatrix_tpu.models import emage_vq as jvq
from pantomatrix_tpu_torch import serve
from pantomatrix_tpu_torch.convert import load_jax_params
from pantomatrix_tpu_torch.io.hf_checkpoint import unflatten_params
from pantomatrix_tpu_torch.models import api, configs, emage, emage_graph
from pantomatrix_tpu_torch.utils.precision import cast_once

torch.set_num_threads(2)

CB = 16
KW = dict(audio_f=32, motion_f=16, hidden_size=32, speaker_dims=4, pose_length=8,
          seed_frames=2, vae_codebook_size=CB, vae_length=CB, dropout_prob=0.0)
PART_DIMS = {"face": 106, "upper": 78, "hands": 180, "lower": 61}
GLOBAL_KW = dict(vae_length=24, vae_test_dim=61)
LAT_ATOL = 1e-5
ROT_ATOL = 2e-3
ZERO_SPK = torch.zeros((1, 1), dtype=torch.long)


def np_tree(module):
    """A port module's weights as the JAX package's param tree of numpy arrays."""
    return unflatten_params({k: v.numpy() for k, v in module.state_dict().items()})


def make_stacks(seed=0):
    """(JAX model, JAX vq, port model, port vq) with the same weights, on the CPU. The
    weights are drawn by the port's init from a seed (the JAX init of this config takes
    40-50 s on a CPU), handed to the JAX package as its param trees, and strict-loaded
    from those trees into fresh port modules with convert.load_jax_params."""
    kw = dict(vae_length=CB, vae_codebook_size=CB)
    drawn = api.EmageAudioModel(configs.EmageAudioConfig(**KW), seed=seed, device="cpu")
    trees = {"model": np_tree(drawn)}
    g = torch.Generator().manual_seed(seed + 1)
    for i, (name, dim) in enumerate(PART_DIMS.items()):
        part = api.EmageVQVAEConv(configs.EmageVQVAEConvConfig(vae_test_dim=dim, **kw),
                                  seed=seed + 10 + i, device="cpu")
        with torch.no_grad():  # unit-scale codes, see the module docstring
            part.quantizer.embedding.weight.copy_(torch.randn(CB, CB, generator=g))
        trees[name] = np_tree(part)
    trees["global"] = np_tree(api.EmageVAEConv(configs.EmageVAEConvConfig(**GLOBAL_KW),
                                               seed=seed + 20, device="cpu"))
    jmodel = japi.EmageAudioModel(jcfgs.EmageAudioConfig(**KW), trees["model"])
    jvq_model = japi.EmageVQModel(
        global_motion=japi.EmageVAEConv(jcfgs.EmageVAEConvConfig(**GLOBAL_KW), trees["global"]),
        **{name: japi.EmageVQVAEConv(jcfgs.EmageVQVAEConvConfig(vae_test_dim=dim, **kw),
                                     trees[name]) for name, dim in PART_DIMS.items()})
    model = load_jax_params(api.EmageAudioModel(configs.EmageAudioConfig(**KW), device="cpu"),
                            trees["model"])
    vq = api.EmageVQModel(
        global_motion=load_jax_params(api.EmageVAEConv(configs.EmageVAEConvConfig(**GLOBAL_KW),
                                                       device="cpu"), trees["global"]),
        **{name: load_jax_params(api.EmageVQVAEConv(configs.EmageVQVAEConvConfig(
            vae_test_dim=dim, **kw), device="cpu"), trees[name])
           for name, dim in PART_DIMS.items()})
    return jmodel, jvq_model, model, vq


@pytest.fixture(scope="module")
def stacks():
    return make_stacks()


def _waves(seed, lengths):
    rng = np.random.RandomState(seed)
    return [rng.uniform(-0.5, 0.5, n).astype(np.float32) for n in lengths]


def _close_results(got, want, what=""):
    assert got.motion_axis_angle.shape == want.motion_axis_angle.shape, what
    np.testing.assert_allclose(got.motion_axis_angle, want.motion_axis_angle, rtol=0,
                               atol=ROT_ATOL, err_msg=what)
    np.testing.assert_allclose(got.expressions, want.expressions, rtol=0, atol=LAT_ATOL,
                               err_msg=what)
    np.testing.assert_allclose(got.trans, want.trans, rtol=0, atol=LAT_ATOL, err_msg=what)


def _latents(gen):
    return {k: np.concatenate([lat[k] for lat in gen.latents], 1) for k in gen.latents[0]}


def _offline(model, vq, wave, spk=0):
    out = emage.emage_inference(model, torch.from_numpy(wave)[None],
                                torch.full((1, 1), spk, dtype=torch.long), vq)
    return {k: v.numpy() for k, v in out.items()}


def test_decoder_halo_matches_jax(stacks):
    _, jvq_model, _, vq = stacks
    assert emage._decoder_halo(vq) == jemage._decoder_halo(jvq_model.suite) == 7


def test_emage_generator_matches_jax(stacks, monkeypatch):
    """Mixed lengths, batch 2, 1 s buckets, speaker ids and start translations: every
    clip's decoded motion and trim equal the JAX engine's. (The JAX engine's decode runs
    eagerly, op by op; here it is jitted, which takes half the time to compile.)"""
    jmodel, jvq_model, model, vq = stacks
    monkeypatch.setattr(jvq_model, "decode", jax.jit(
        lambda **kw: jvq.vq_decode(jvq_model.suite, **kw), static_argnames="get_global_motion"),
        raising=False)
    waves = _waves(0, (16000, 9000, 12000))  # one 1 s bucket shape: one JAX compile
    kw = dict(speaker_ids=[0, 1, 2],
              ref_trans=[np.array([0.5, 0.0, -1.0]), np.zeros(3), np.array([2.0, 1.0, 3.0])])
    want = jserve.EmageGenerator(jmodel, jvq_model, batch_size=2,
                                 bucket_seconds=1.0).generate(waves, **kw)
    got = serve.EmageGenerator(model, vq, batch_size=2, bucket_seconds=1.0).generate(waves, **kw)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.motion_axis_angle.shape[0] == len(waves[i]) * 30 // 16000
        _close_results(g, w, f"clip {i}")


def test_emage_generator_network_outputs_match_jax(stacks):
    """The padded batch the generator builds (clips of 24 and 30 frames in a 30-frame
    bucket) gives the JAX package's latents, logits and head indices."""
    jmodel, jvq_model, model, vq = stacks
    short, longer = _waves(5, (13000, 16000))
    batch = np.stack([np.pad(short, (0, 16000 - len(short))), longer])
    spk = np.array([[1], [3]])
    want = jmodel.inference(jnp.asarray(batch), jnp.asarray(spk), jvq_model)
    got = model.inference(torch.from_numpy(batch), torch.from_numpy(spk), vq)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0,
                                   atol=LAT_ATOL, err_msg=k)
    for part in ("upper", "hands", "lower"):
        np.testing.assert_array_equal(got[f"cls_{part}"].argmax(-1).numpy(),
                                      np.asarray(want[f"cls_{part}"]).argmax(-1))


def test_emage_generator_matches_direct_inference_on_full_windows(stacks):
    _, _, model, vq = stacks
    wave = _waves(1, (16000,))[0]
    res = serve.EmageGenerator(model, vq, batch_size=1, bucket_seconds=1.0).generate([wave])[0]
    out = emage.emage_inference(model, torch.from_numpy(wave)[None], ZERO_SPK, vq)
    direct = vq.decode(**emage._select_decode_inputs(model.config, out),
                       get_global_motion=True, ref_trans=torch.zeros(1, 1, 3))
    t = res.motion_axis_angle.shape[0]
    np.testing.assert_array_equal(res.motion_axis_angle,
                                  direct["motion_axis_angle"][0, :t].numpy())


def test_emage_generator_threads_ref_trans(stacks):
    """x and z integrate from the start translation, y is the VAE's output."""
    _, _, model, vq = stacks
    wave = _waves(6, (16000,))[0]
    gen = serve.EmageGenerator(model, vq, batch_size=1, bucket_seconds=1.0)
    base = gen.generate([wave])[0]
    shifted = gen.generate([wave], ref_trans=[np.array([1.0, 2.0, 3.0])])[0]
    delta = shifted.trans - base.trans
    np.testing.assert_allclose(delta[:, 0], 1.0, atol=1e-5)
    np.testing.assert_allclose(delta[:, 2], 3.0, atol=1e-5)
    np.testing.assert_allclose(delta[:, 1], 0.0, atol=1e-5)


def test_sequence_generator_camn_matches_jax():
    drawn = api.CamnAudioModel(configs.CamnAudioConfig(hidden_size=32, n_layer=1), device="cpu")
    jmodel = japi.CamnAudioModel(jcfgs.CamnAudioConfig(hidden_size=32, n_layer=1), np_tree(drawn))
    model = load_jax_params(api.CamnAudioModel(configs.CamnAudioConfig(hidden_size=32, n_layer=1),
                                               device="cpu"), jmodel.params)
    waves = _waves(0, (16000, 30000, 12000))
    want = jserve.SequenceGenerator(jmodel, batch_size=2, bucket_seconds=1.0).generate(
        waves, speaker_ids=[0, 0, 0])
    got = serve.SequenceGenerator(model, batch_size=2, bucket_seconds=1.0).generate(
        waves, speaker_ids=[0, 0, 0])
    for w, g, wave in zip(want, got, waves):
        assert g.shape == np.asarray(w).shape == (len(wave) * 15 // 16000, 165)
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=ROT_ATOL)


def test_streaming_latents_bit_equal_offline(stacks):
    """Uneven chunks + flush: exactly the offline latent sequence and frame count; all
    at once gives the same stream."""
    _, _, model, vq = stacks
    wave = _waves(7, (23 * 16000 // 30 + 1,))[0]  # 23 offline frames: 3 windows + 5
    off = _offline(model, vq, wave)
    gen = serve.StreamingEmageGenerator(model, vq, collect_latents=True)
    outs = [gen.push(c) for c in (wave[:1000], wave[1000:9000], wave[9000:9001], wave[9001:])]
    outs.append(gen.flush())
    assert sum(o.motion_axis_angle.shape[0] for o in outs) == off["rec_face"].shape[1] == 23
    streamed = _latents(gen)
    for k in off:
        np.testing.assert_array_equal(streamed[k], off[k], err_msg=k)
    once = serve.StreamingEmageGenerator(model, vq, collect_latents=True)
    once.push(wave)
    once.flush()
    for k, v in _latents(once).items():
        np.testing.assert_array_equal(v, streamed[k], err_msg=k)


def test_streaming_decoded_motion_halo_bound():
    """What push() returns against the offline decode of the same latents: exact at
    frames at least _decoder_halo frames inside their chunk on both sides (the bound is
    tight), bounded at the boundaries."""
    from pantomatrix_tpu_torch.core.rotations import axis_angle_to_matrix

    kw = dict(KW, pose_length=32, seed_frames=4)
    model = api.EmageAudioModel(configs.EmageAudioConfig(**kw), seed=0, device="cpu")
    vq = api.EmageVQModel(global_motion=api.EmageVAEConv(
        configs.EmageVAEConvConfig(**GLOBAL_KW), seed=4, device="cpu"),
        **{name: api.EmageVQVAEConv(configs.EmageVQVAEConvConfig(
            vae_test_dim=dim, vae_length=CB, vae_codebook_size=CB), seed=i, device="cpu")
           for i, (name, dim) in enumerate(PART_DIMS.items())})
    wave = _waves(7, (150 * 16000 // 30 + 1,))[0]  # 5 windows (stride 28) + 10 frames
    off = emage.emage_inference(model, torch.from_numpy(wave)[None], ZERO_SPK, vq)
    dec = vq.decode(**emage._select_decode_inputs(model.config, off), get_global_motion=True,
                    ref_trans=torch.zeros(1, 1, 3))
    m_off, e_off, t_off = (dec[k][0].numpy() for k in ("motion_axis_angle", "expression",
                                                       "trans"))
    gen = serve.StreamingEmageGenerator(model, vq)
    outs = [gen.push(wave[:20000]), gen.push(wave[20000:60000]), gen.push(wave[60000:]),
            gen.flush()]
    m_s, e_s, t_s = (np.concatenate([getattr(o, f) for o in outs])
                     for f in ("motion_axis_angle", "expressions", "trans"))
    T = m_off.shape[0]
    assert m_s.shape[0] == T
    halo = emage._decoder_halo(vq)
    stride = 28
    bounds = list(range(0, T, stride)) + [T]
    starts = np.array([max(b for b in bounds if b <= f) for f in range(T)])
    ends = np.array([min(b for b in bounds if b > f) for f in range(T)])
    f = np.arange(T)
    interior = (f - starts >= halo) & (ends - f > halo)
    assert interior.sum() >= T // 3

    def rot(a):
        return axis_angle_to_matrix(torch.from_numpy(a.reshape(-1, 55, 3))).numpy()

    rel = np.einsum("tjab,tjcb->tjac", rot(m_off), rot(m_s))
    geo = np.arccos(np.clip((np.trace(rel, axis1=2, axis2=3) - 1) / 2, -1, 1)).max(1)
    assert geo[interior].max() < 5e-3
    e_err = np.abs(e_off - e_s).max(1)
    assert e_err[interior].max() < 1e-6
    # tight: one frame closer to a boundary than the halo is no longer exact
    assert e_err[~interior].max() > 1e-6
    assert np.abs(t_off - t_s).max(1)[interior].max() < 5e-3
    assert np.abs(e_off - e_s).max() < 0.1 and np.abs(t_off - t_s).max() < 0.02


def _run_pool(pool, waves, speakers, cuts=(0, 2000, 5000, 9000), flush=True):
    sids = [pool.open(speaker_id=s, collect_latents=True) for s in speakers]
    emitted = {sid: [] for sid in sids}
    cuts = list(cuts) + [max(len(w) for w in waves)]
    for a, b in zip(cuts, cuts[1:]):
        for sid, w in zip(sids, waves):
            if a < len(w):
                pool.feed(sid, w[a:min(b, len(w))])
        for sid, res in pool.pump():
            emitted[sid].append(res)
    for sid in sids:
        if flush:
            emitted[sid].append(pool.flush(sid))
    return sids, emitted


def test_pool_latents_match_offline_with_stragglers_and_uneven_phases(stacks):
    """5 sessions on a batch-4 pool, fed in interleaved uneven chunks: every session's
    latents equal its offline batch-1 run (to 1e-5: the CPU's matrix products round by
    batch size) with equal head indices, and its frame count is the offline one."""
    _, _, model, vq = stacks
    waves = _waves(21, (12267, 9000, 12267, 16000, 6000))
    pool = serve.StreamingPool(model, vq, batch=4)
    sids, emitted = _run_pool(pool, waves, [0, 1, 2, 3, 0])
    for sid, w, spk in zip(sids, waves, [0, 1, 2, 3, 0]):
        off = _offline(model, vq, w, spk)
        assert sum(r.motion_axis_angle.shape[0] for r in emitted[sid]) == off["rec_face"].shape[1]
        got = _latents(pool.session(sid))
        for k, v in got.items():
            np.testing.assert_allclose(v, off[k], rtol=0, atol=LAT_ATOL,
                                       err_msg=f"session {sid} {k}")
        for part in ("face", "upper", "hands", "lower"):
            np.testing.assert_array_equal(got[f"cls_{part}"].argmax(-1),
                                          off[f"cls_{part}"].argmax(-1))


POOL_WAVES = (12267, 12267, 12267)  # 23 offline frames each: 3 windows + a 5-frame flush
POOL_SPEAKERS = [0, 1, 2]


@pytest.fixture(scope="module")
def jax_pool(stacks):
    """The JAX package's StreamingPool over POOL_WAVES (batch 3, the cuts of _run_pool),
    its full windows only: the remainder windows (flush) are held against the port's
    offline path, which tests/test_torch_emage.py holds against the JAX package."""
    jmodel, jvq_model, _, _ = stacks
    waves = _waves(22, POOL_WAVES)
    pool = jserve.StreamingPool(jmodel, jvq_model, batch=3)
    return waves, pool, *_run_pool(pool, waves, POOL_SPEAKERS, flush=False)


def _push_in_cuts(gen, wave, cuts=(0, 2000, 5000, 9000)):
    """A single stream fed as _run_pool feeds a session, then flushed."""
    cuts = list(cuts) + [len(wave)]
    return [gen.push(wave[a:b]) for a, b in zip(cuts, cuts[1:])] + [gen.flush()]


def _cat(results, field):
    return np.concatenate([np.asarray(getattr(r, field)) for r in results])


def test_streaming_matches_jax_streaming(stacks, jax_pool):
    """One stream through both packages, against the JAX pool's first session (the one
    whose translation the JAX pool threads right): every full window's emitted chunk,
    latents and head indices."""
    _, _, model, vq = stacks
    waves, jpool, jsids, jemitted = jax_pool
    gen = serve.StreamingEmageGenerator(model, vq, speaker_id=POOL_SPEAKERS[0],
                                        collect_latents=True)
    outs = [o for o in _push_in_cuts(gen, waves[0])[:-1] if o.motion_axis_angle.shape[0]]
    assert len(outs) == len(jemitted[jsids[0]]) == 3
    for i, (g, w) in enumerate(zip(outs, jemitted[jsids[0]])):
        _close_results(g, jserve_result(w), f"emission {i}")
    want = _latents(jpool.session(jsids[0]))
    got = {k: v[:, :want[k].shape[1]] for k, v in _latents(gen).items()}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=LAT_ATOL, err_msg=k)
    for part in ("face", "upper", "hands", "lower"):
        np.testing.assert_array_equal(got[f"cls_{part}"].argmax(-1),
                                      want[f"cls_{part}"].argmax(-1))


def jserve_result(r):
    return serve.GenerationResult(*(np.asarray(x) for x in (r.motion_axis_angle,
                                                           r.expressions, r.trans)))


def test_pool_sessions_keep_their_own_translation(stacks, jax_pool):
    """Each pooled session's emitted motion, translation included, equals its own
    single-stream run in the port, and the JAX pool's latents, poses and expressions. In
    the JAX pool the sessions after the first of a wave integrate from the first
    session's position instead: their translations leave their single streams'."""
    _, _, model, vq = stacks
    waves, jpool, jsids, jemitted = jax_pool
    singles = []
    for w, spk in zip(waves, POOL_SPEAKERS):
        singles.append(_push_in_cuts(serve.StreamingEmageGenerator(model, vq, speaker_id=spk),
                                     w))
    pool = serve.StreamingPool(model, vq, batch=3)
    sids, emitted = _run_pool(pool, waves, POOL_SPEAKERS)
    jax_err = []
    for i, (sid, jsid) in enumerate(zip(sids, jsids)):
        for f, atol in (("motion_axis_angle", ROT_ATOL), ("expressions", LAT_ATOL),
                        ("trans", LAT_ATOL)):
            np.testing.assert_allclose(_cat(emitted[sid], f), _cat(singles[i], f), rtol=0,
                                       atol=atol, err_msg=f"session {i} {f}")
        n = sum(r.motion_axis_angle.shape[0] for r in jemitted[jsid])  # the full windows
        np.testing.assert_allclose(_cat(emitted[sid], "motion_axis_angle")[:n],
                                   _cat(jemitted[jsid], "motion_axis_angle"), rtol=0,
                                   atol=ROT_ATOL)
        np.testing.assert_allclose(_cat(emitted[sid], "expressions")[:n],
                                   _cat(jemitted[jsid], "expressions"), rtol=0, atol=LAT_ATOL)
        want = _latents(jpool.session(jsid))
        for k, v in _latents(pool.session(sid)).items():
            np.testing.assert_allclose(v[:, :want[k].shape[1]], want[k], rtol=0,
                                       atol=LAT_ATOL, err_msg=k)
        jax_err.append(float(np.abs(_cat(jemitted[jsid], "trans")
                                    - _cat(singles[i], "trans")[:n]).max()))
    assert jax_err[0] < 1e-5, jax_err  # the JAX pool's first session: its own start ...
    assert min(jax_err[1:]) > 1e-3, jax_err  # ... the others start from session 0's


def test_window_gating_uses_offline_frame_math(stacks):
    """8 * 533 samples hold frame 8's audio but only 7 offline frames: push fires no
    full window, flush runs the offline 7-frame remainder window."""
    _, _, model, vq = stacks
    wave = _waves(9, (8 * 533,))[0]
    off = _offline(model, vq, wave)
    assert off["rec_face"].shape[1] == 7
    gen = serve.StreamingEmageGenerator(model, vq, collect_latents=True)
    assert gen.push(wave).motion_axis_angle.shape[0] == 0
    assert gen.flush().motion_axis_angle.shape[0] == 7
    for k, v in _latents(gen).items():
        np.testing.assert_array_equal(v, off[k], err_msg=k)


class _StaticStep:
    """A stand-in for a graph replay on the CPU: ``fn``'s result copied into buffers
    allocated on the first call and returned on every call, as a graph's static outputs
    are; ``calls`` counts them."""

    def __init__(self, fn):
        self.fn, self.buffers, self.calls = fn, None, 0

    def __call__(self, *args, **kwargs):
        out = self.fn(*args, **kwargs)
        flat, spec = torch.utils._pytree.tree_flatten(out)
        if self.buffers is None or [b.shape for b in self.buffers] != [x.shape for x in flat]:
            self.buffers = [torch.empty_like(x) for x in flat]
        for b, x in zip(self.buffers, flat):
            b.copy_(x)
        self.calls += 1
        return torch.utils._pytree.tree_unflatten(self.buffers, spec)


@pytest.mark.parametrize("mode", [dict(), dict(compute_dtype="bfloat16"),
                                  dict(batched_wav=True)])
def test_inference_loop_copies_static_outputs_before_the_next_step(stacks, mode):
    """emage_inference's loop with a step whose outputs are overwritten by its next call
    (as a graph replay's are) gives exactly the eager result; every full window goes to
    that step, the remainder window to the eager one."""
    _, _, model, vq = stacks
    wave = _waves(10, (41 * 16000 // 30 + 1,))[0]  # 41 frames: 6 windows + 5
    audio, spk = torch.from_numpy(wave)[None], torch.full((1, 1), 3, dtype=torch.long)
    want = emage.emage_inference(model, audio, spk, vq, **mode)
    step = _StaticStep(emage._window_step)
    got = emage._inference_loop(model, audio, spk, vq, None, None, mode.get("compute_dtype"),
                                mode.get("batched_wav", False), step)
    assert step.calls == 6
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_pool_consumes_static_outputs_before_the_next_step(stacks, monkeypatch):
    """The pool with a step and a decode whose outputs are overwritten by their next
    call, as graph replays' are: the same latents and frames as with fresh outputs."""
    _, _, model, vq = stacks
    waves = _waves(23, (12267, 9000, 16000))
    want = _run_pool(serve.StreamingPool(model, vq, batch=2), waves, [0, 1, 2])
    monkeypatch.setattr(serve, "_window_step", _StaticStep(emage._window_step))
    monkeypatch.setattr(serve, "vq_decode", _StaticStep(serve.vq_decode))
    pool = serve.StreamingPool(model, vq, batch=2)
    got = _run_pool(pool, waves, [0, 1, 2])
    assert serve._window_step.calls > 3
    for (sid, w_res), g_res in zip(want[1].items(), got[1].values()):
        for f in ("motion_axis_angle", "expressions", "trans"):
            np.testing.assert_array_equal(np.concatenate([getattr(r, f) for r in g_res]),
                                          np.concatenate([getattr(r, f) for r in w_res]))
    for sid in got[0]:
        assert pool.session(sid).latents


def _motion(bs, length, dtype=torch.float32):
    return torch.zeros(bs, length, 337, dtype=dtype)


def test_graph_key_separates_mode_batch_length_and_features(stacks):
    _, _, model, vq = stacks
    keys = {
        emage_graph.step_key(model, vq, _motion(8, 8), False),
        emage_graph.step_key(model, vq, _motion(2, 8), False),
        emage_graph.step_key(model, vq, _motion(2, 5), False),
        emage_graph.step_key(model, vq, _motion(2, 8), True),
        emage_graph.step_key(cast_once(model, torch.bfloat16), vq,
                             _motion(2, 8, torch.bfloat16), False),
    }
    assert len(keys) == 5
    assert emage_graph.step_key(model, vq, _motion(2, 8), False) == \
        emage_graph.step_key(model, vq, _motion(2, 8), False)
    # the decode graph: by batch and frames kept
    net = {"rec_face": torch.zeros(2, 8, 16)}
    assert emage_graph.decode_key(vq, net, 6) != emage_graph.decode_key(vq, net, 8)
    assert emage_graph.decode_key(vq, net, 6) != emage_graph.decode_key(
        vq, {"rec_face": torch.zeros(3, 8, 16)}, 6)


def test_graph_key_is_new_after_cast_once_sees_new_weights():
    model = api.EmageAudioModel(configs.EmageAudioConfig(**KW), seed=1, device="cpu")
    vq = object()
    motion = _motion(2, 8, torch.bfloat16)
    bf = cast_once(model, torch.bfloat16)
    key = emage_graph.step_key(bf, vq, motion, False)
    assert cast_once(model, torch.bfloat16) is bf  # same weights: the same key
    with torch.no_grad():
        model.face_out_proj.weight.add_(1.0)
    bf2 = cast_once(model, torch.bfloat16)
    assert bf2 is not bf
    new = emage_graph.step_key(bf2, vq, motion, False)
    assert new[0] == key[0] and new != key
    # a cast copy starts with no graphs of its own
    emage_graph.graphs_of(model)
    copy = cast_once(model, torch.float16)
    assert len(emage_graph.graphs_of(copy)) == 0
    assert emage_graph.graphs_of(copy) is not emage_graph.graphs_of(model)


def test_entry_tiny_on_the_cpu():
    """The tiny variant of entry(): one window's forward, run twice, bit-equal, with the
    shapes of the full-width one at the tiny widths."""
    from pantomatrix_tpu_torch import entry as port_entry

    fn, args = port_entry._entry(True, "cpu")
    model, audio, spk, motion, mask = args
    assert audio.shape == (1, 8 * emage.SAMPLES_PER_FRAME) and motion.shape == (1, 8, 337)
    out, again = fn(*args), fn(*args)
    assert set(out) == {f"{kind}_{p}" for kind in ("rec", "cls")
                        for p in ("face", "upper", "hands", "lower")}
    for k, v in out.items():
        assert v.shape == (1, 8, CB) and bool(torch.isfinite(v).all()), k
        assert torch.equal(v, again[k]), k


def test_entry_runs_on_the_card_unless_asked():
    from pantomatrix_tpu_torch.entry import entry

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()


def test_bench_stream_protocol_on_the_cpu(stacks):
    from pantomatrix_tpu_torch.cli.bench_stream import bench_pool, pump_stats

    stats = pump_stats([float(t) for t in range(10, 0, -1)], sessions=4, stride_frames=60)
    assert stats["pump_ms_median"] == 6.0 and stats["pump_ms_p90"] == 9.0
    assert stats["realtime_streams_capacity"] == pytest.approx(2.0 * 4 / 0.006)
    _, _, model, vq = stacks
    line = bench_pool(model, vq, sessions=2, repeats=3)
    assert line["sessions"] == 2 and line["repeats"] == 3 and line["first_pump_s"] > 0
    assert line["motion_seconds_per_pump"] == pytest.approx(2 * 6 / 30)
