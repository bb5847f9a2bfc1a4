"""The port's tokenizer pretraining step (pantomatrix_tpu_torch/train/steps.py
make_vq_train_step, vq_global_vae_target, dead-code restarts) and the VQ CLI's
data-dependent codebook init, against the JAX package on the CPU.

The tiny suite of tests/test_train_steps.py (codebooks of 16, vae_length 16, the global
VAE at vae_length 24), weights from the JAX init carried by convert.load_jax_params,
inputs from numpy seeds, plain SGD. The JAX steps are their bodies (``step.raw``) under
one ``jax.jit`` each, which compiles in seconds where running them op by op takes
~40 s.

Tolerances: the global VAE target within 1e-6 (and its integral within 2e-6 of the
absolute translation); one step's losses within 1e-5 relative and every parameter
within 1e-5; with restarts, the dead masks equal, the new usage within 1e-7, rows not
restarted within 1e-5 and each restarted row within 1e-5 of a row of the step's encoder
output pool (the picks are the port's own: it does not reproduce ``jax.random``); the
bf16 step's all_loss within 2% of the JAX float32 step's (the bf16 bound of
tests/test_torch_train_steps.py), float32 masters; the data-initialized codebooks within
1e-5 of the JAX CLI's.
"""
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pantomatrix_tpu.cli import train_emage_vq as jcli
from pantomatrix_tpu.core.rotations import axis_angle_to_rotation_6d as jrot6d
from pantomatrix_tpu.data import beat2 as jbeat2
from pantomatrix_tpu.models import configs as jcfgs
from pantomatrix_tpu.models import emage_vq as jvq
from pantomatrix_tpu.train import steps as jsteps
from pantomatrix_tpu.train.optim import make_optimizer as jmake_optimizer
from pantomatrix_tpu_torch.cli import train_emage_vq
from pantomatrix_tpu_torch.convert import load_jax_params
from pantomatrix_tpu_torch.core.integrate import velocity2position
from pantomatrix_tpu_torch.data import beat2
from pantomatrix_tpu_torch.io.hf_checkpoint import flatten_params
from pantomatrix_tpu_torch.models import configs, emage_vq
from pantomatrix_tpu_torch.train.optim import make_optimizer
from pantomatrix_tpu_torch.train.steps import (
    RestartingOptimizer,
    make_vq_train_step,
    vq_global_vae_target,
    vq_usage_init,
)

from test_data_pipeline import write_wav

torch.set_num_threads(2)

CB, LR = 16, 0.1
DIMS = {"face": 106, "upper": 78, "hands": 180, "lower": 61}
SUBS = (*DIMS, "global_motion")
GLOBAL_KW = dict(vae_length=24, vae_test_dim=61)
DECAY, THRESH = 0.9, 0.5


def _jax_suite(key):
    """tests/test_train_steps.py's tiny_suite."""
    ks = jax.random.split(key, 5)
    mk = lambda k, dim: (
        jvq.init_emage_vqvae(k, jcfgs.EmageVQVAEConvConfig(vae_test_dim=dim, vae_length=CB,
                                                           vae_codebook_size=CB)),
        jcfgs.EmageVQVAEConvConfig(vae_test_dim=dim, vae_length=CB, vae_codebook_size=CB))
    g_cfg = jcfgs.EmageVAEConvConfig(**GLOBAL_KW)
    return jvq.EmageVQSuite(face=mk(ks[0], 106), upper=mk(ks[1], 78), hands=mk(ks[2], 180),
                            lower=mk(ks[3], 61),
                            global_motion=(jvq.init_emage_vae(ks[4], g_cfg), g_cfg))


def _port_suite(host):
    g = torch.Generator()
    part = lambda dim: emage_vq.EmageVQVAE(configs.EmageVQVAEConvConfig(
        vae_test_dim=dim, vae_length=CB, vae_codebook_size=CB), generator=g)
    suite = emage_vq.EmageVQSuite(
        **{name: part(dim) for name, dim in DIMS.items()},
        global_motion=emage_vq.EmageVAE(configs.EmageVAEConvConfig(**GLOBAL_KW), generator=g))
    for name in SUBS:
        load_jax_params(getattr(suite, name), host[name])
    return suite


def _batch(bs=8, t=8, seed=5):
    rng = np.random.RandomState(seed)
    return {
        "motion": rng.uniform(-0.5, 0.5, (bs, t, 165)).astype(np.float32),
        "expressions": rng.uniform(-1, 1, (bs, t, 100)).astype(np.float32),
        "trans": rng.uniform(-1, 1, (bs, t, 3)).astype(np.float32),
        "foot_contact": (rng.uniform(size=(bs, t, 4)) < 0.5).astype(np.float32),
    }


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _usage(seed=9):
    """A per-code usage state from a numpy seed, spread over [0, 2/K): about half the
    codes fall under THRESH / K after one update, none within rounding of it."""
    rng = np.random.RandomState(seed)
    return {p: rng.uniform(0, 2.0 / CB, CB).astype(np.float32) for p in DIMS}


@pytest.fixture(scope="module")
def ref():
    """The JAX suite (host arrays), and one SGD step of it without and with restarts."""
    jsuite = jax.jit(_jax_suite)(jax.random.PRNGKey(3))
    host = {n: jax.tree_util.tree_map(np.asarray, getattr(jsuite, n)[0]) for n in SUBS}
    params = lambda: {n: jax.tree_util.tree_map(jnp.asarray, host[n]) for n in SUBS}
    opt = jmake_optimizer(learning_rate=LR, optimizer="sgd")
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    out = {"host": host}
    for restart in (False, True):
        step = jsteps.make_vq_train_step(jsuite, opt, restart_dead_codes=restart,
                                         restart_decay=DECAY, restart_thresh=THRESH)
        p = params()
        state = jsteps.init_opt_state(opt, p)
        if restart:
            state = (state, {k: jnp.asarray(v) for k, v in _usage().items()})
        new, new_state, losses = jax.jit(step.raw)(p, state, batch, jax.random.PRNGKey(0),
                                                   jnp.asarray(1.0))
        out[restart] = (flatten_params(jax.tree_util.tree_map(np.asarray, new)),
                        {k: float(v) for k, v in losses.items()},
                        {k: np.asarray(v) for k, v in new_state[1].items()} if restart
                        else None)
    # the step's encoder outputs and code indices, per part, on the state before it
    @jax.jit
    def forward(params, b):
        rot6d = jrot6d(b["motion"].reshape(8, 8, 55, 3)).reshape(8, 8, 330)
        streams = jvq.vq_split_inputs(rot6d, b["expressions"], b["foot_contact"], b["trans"])
        return {n: jvq.vqvae_forward(params[n], getattr(jsuite, n)[1], streams[n])
                for n in DIMS}

    fwd = forward(params(), batch)
    out["pool"] = {n: np.asarray(f["pre_latent"]).reshape(-1, CB) for n, f in fwd.items()}
    out["indices"] = {n: np.asarray(f["indices"]).reshape(-1) for n, f in fwd.items()}
    return out


def _port_step(host, restart=False, compute_dtype=None, lr=LR, optimizer="sgd"):
    suite = _port_suite(host)
    opt = make_optimizer(suite.parameters(), learning_rate=lr, optimizer=optimizer)
    if restart:
        opt = RestartingOptimizer(opt, {k: torch.from_numpy(v) for k, v in _usage().items()})
    step = make_vq_train_step(suite, opt, compute_dtype=compute_dtype,
                              restart_dead_codes=restart, restart_decay=DECAY,
                              restart_thresh=THRESH)
    return suite, opt, step


def _state(suite):
    return {f"{n}.{k}": v.detach().numpy() for n in SUBS
            for k, v in getattr(suite, n).state_dict().items()}


def test_global_vae_target_matches_jax_and_integrates_back():
    lower = np.random.RandomState(0).uniform(-1, 1, (2, 16, 61)).astype(np.float32)
    want = np.asarray(jsteps.vq_global_vae_target(jnp.asarray(lower)))
    got = vq_global_vae_target(torch.from_numpy(lower))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[:, :, :54].numpy(), lower[:, :, :54])
    np.testing.assert_array_equal(got[:, :, 57:].numpy(), lower[:, :, 57:])
    np.testing.assert_array_equal(got[:, :, 55].numpy(), lower[:, :, 55])
    for c in (0, 2):  # x and z integrate back to the absolute translation
        pos = velocity2position(got[:, :, 54 + c:55 + c], 1.0 / 30,
                                torch.from_numpy(lower[:, 0, 54 + c:55 + c]))
        np.testing.assert_allclose(pos.numpy(), lower[:, :, 54 + c:55 + c], rtol=0, atol=2e-6)


def test_sgd_step_matches_jax(ref):
    want, want_losses, _ = ref[False]
    suite, _, step = _port_step(ref["host"])
    losses = step(_torch_batch(_batch()), 1)
    assert set(losses) == set(want_losses)
    for k, v in want_losses.items():
        np.testing.assert_allclose(float(losses[k]), v, rtol=1e-5, err_msg=k)
    got = _state(suite)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-5, err_msg=k)
    before = flatten_params(ref["host"])
    for n in SUBS:  # every sub-model trained
        assert any(not np.allclose(got[k], before[k]) for k in got if k.startswith(n + "."))


@pytest.mark.parametrize("part", list(DIMS))
def test_restart_decision_and_rows_match_jax(ref, part):
    want, want_losses, want_usage = ref[True]
    suite, opt, step = _port_step(ref["host"], restart=True)
    losses = step(_torch_batch(_batch()), 1)
    assert not any(k.startswith("_") for k in losses), sorted(losses)
    # the decision, from the JAX forward's code counts and the fed usage
    counts = np.bincount(ref["indices"][part], minlength=CB).astype(np.float32)
    u = DECAY * _usage()[part] + (1 - DECAY) * counts / max(counts.sum(), 1.0)
    dead = u < THRESH / CB
    assert 0 < dead.sum() < CB
    np.testing.assert_allclose(want_usage[part], np.where(dead, 1.0 / CB, u), rtol=0, atol=1e-7)
    np.testing.assert_array_equal(opt.dead[part].numpy(), dead)
    np.testing.assert_allclose(opt.usage[part].numpy(), want_usage[part], rtol=0, atol=1e-7)
    assert float(losses[f"restarted_{part}"]) == want_losses[f"restarted_{part}"] == dead.sum()
    for k, v in want_losses.items():
        if not k.startswith("restarted_"):
            np.testing.assert_allclose(float(losses[k]), v, rtol=1e-5, err_msg=k)
    # rows: kept ones as JAX's, restarted ones from the step's encoder-output pool
    got = _state(suite)
    key = f"{part}.quantizer.embedding.weight"
    np.testing.assert_allclose(got[key][~dead], want[key][~dead], rtol=0, atol=1e-5)
    pool = ref["pool"][part]
    for row in got[key][dead]:
        assert np.abs(pool - row).max(axis=1).min() <= 1e-5
    for k, v in want.items():  # the other parts' codebooks are their own cases
        if not k.endswith("quantizer.embedding.weight"):
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-5, err_msg=k)


def test_restart_state_round_trips_through_a_checkpoint(ref, tmp_path):
    from pantomatrix_tpu_torch.train.ckpt import load_train_state, save_train_state

    suite, opt, step = _port_step(ref["host"], restart=True, optimizer="adam", lr=1e-3)
    step(_torch_batch(_batch()), 0)
    save_train_state(str(tmp_path / "s.bin"), suite, opt, 1)
    suite2, opt2, _ = _port_step(ref["host"], restart=True, optimizer="adam", lr=1e-3)
    assert load_train_state(str(tmp_path / "s.bin"), suite2, opt2)[0] == 1
    for p in DIMS:
        assert torch.equal(opt2.usage[p], opt.usage[p])
    a, b = opt.optimizer.state_dict(), opt2.optimizer.state_dict()
    assert a["scheduler"] == b["scheduler"]
    for i, s in a["optimizer"]["state"].items():
        assert torch.equal(s["exp_avg"], b["optimizer"]["state"][i]["exp_avg"])


def test_reconstruction_falls_over_40_same_batch_steps(ref):
    suite, _, step = _port_step(ref["host"], restart=True, optimizer="adam", lr=2e-3)
    batch = _torch_batch(_batch())
    rec = lambda losses: sum(float(v) for k, v in losses.items() if k.startswith("rec_"))
    first = step(batch, 0)
    for i in range(1, 40):
        last = step(batch, i)
    assert all(np.isfinite(float(v)) for v in last.values())
    assert rec(last) < rec(first)


def test_bf16_step_within_bounds_with_float32_masters(ref):
    _, want_losses, _ = ref[False]
    suite, _, step = _port_step(ref["host"], compute_dtype="bfloat16")
    losses = step(_torch_batch(_batch()), 1)
    assert all(np.isfinite(float(v)) for v in losses.values())
    assert abs(float(losses["all_loss"]) - want_losses["all_loss"]) \
        / abs(want_losses["all_loss"]) < 0.02
    for name, t in suite.state_dict().items():
        assert t.dtype == torch.float32 and torch.isfinite(t).all(), name


def test_restarts_need_the_usage_state(ref):
    suite = _port_suite(ref["host"])
    with pytest.raises(TypeError, match="RestartingOptimizer"):
        make_vq_train_step(suite, make_optimizer(suite.parameters()), restart_dead_codes=True)
    usage = vq_usage_init(suite)
    assert set(usage) == set(DIMS)
    assert all(torch.equal(u, torch.full((CB,), 1.0 / CB)) for u in usage.values())


@pytest.fixture(scope="module")
def vq_beat2(tmp_path_factory):
    """Three 40-frame takes with foot contact, 16-frame clips at stride 4."""
    root = tmp_path_factory.mktemp("vq_beat2")
    for sub in ("smplxflame_30", "footcontact", "wave16k"):
        (root / sub).mkdir()
    rng = np.random.RandomState(2)
    metas = []
    for vid in ("2_a_0_1_1", "2_a_0_2_2", "2_a_0_3_3"):
        n = 40
        np.savez(root / "smplxflame_30" / f"{vid}.npz", betas=np.zeros(300, np.float32),
                 poses=rng.uniform(-0.5, 0.5, (n, 165)).astype(np.float32),
                 expressions=rng.uniform(-1, 1, (n, 100)).astype(np.float32),
                 trans=rng.uniform(-1, 1, (n, 3)).astype(np.float32))
        np.save(root / "footcontact" / f"{vid}.npy",
                (rng.uniform(size=(n, 4)) < 0.5).astype(np.float32))
        write_wav(root / "wave16k" / f"{vid}.wav",
                  rng.uniform(-0.3, 0.3, n * 16000 // 30).astype(np.float32), 16000)
        for start in range(0, n - 16, 4):
            metas.append({"video_id": vid, "mode": "train",
                          "motion_path": str(root / "smplxflame_30" / f"{vid}.npz"),
                          "audio_path": str(root / "wave16k" / f"{vid}.wav"),
                          "start_idx": start, "end_idx": start + 16})
    return root, metas


@pytest.mark.parametrize("clips", [18, 1], ids=["pooled", "jittered"])
def test_data_init_codebooks_match_the_jax_cli(ref, vq_beat2, clips):
    """18 clips: batches pooled until 8 K rows (the loader's order); 1 clip: a pool of 16
    rows for K = 16 codes, so picks with replacement plus jitter."""
    root, metas = vq_beat2
    meta = root / f"meta_{clips}.json"
    meta.write_text(json.dumps(metas[:clips]))
    bs = min(2, clips)
    jds = jbeat2.BEAT2Dataset([str(meta)], "train", 30, 16000, None,
                              variant="emage_footcontact")
    params = {n: jax.tree_util.tree_map(jnp.asarray, ref["host"][n]) for n in SUBS}
    cfgs = {n: jcfgs.EmageVQVAEConvConfig(vae_test_dim=d, vae_length=CB, vae_codebook_size=CB)
            for n, d in DIMS.items()}
    want = jcli.data_init_codebooks(params, cfgs, jbeat2.DataLoader(jds, bs, seed=7), seed=11)
    ds = beat2.BEAT2Dataset([str(meta)], "train", 30, 16000, None, variant="emage_footcontact")
    suite = train_emage_vq.data_init_codebooks(_port_suite(ref["host"]),
                                               beat2.DataLoader(ds, bs, seed=7), seed=11)
    for n in DIMS:
        got = getattr(suite, n).quantizer.embedding.weight.detach().numpy()
        np.testing.assert_allclose(got, np.asarray(want[n]["quantizer"]["embedding"]["weight"]),
                                   rtol=0, atol=1e-5, err_msg=n)
