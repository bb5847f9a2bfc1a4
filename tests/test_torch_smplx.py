"""The port's SMPL-X FK and motion representation (pantomatrix_tpu_torch.core.smplx,
core.motion_rep) against the JAX package on the CPU.

Both packages load one synthetic archive with the real SMPLX_NEUTRAL_2020.npz's key
layout at V = 24 (the real archive is not in the repository); inputs are made from a
numpy seed. Tolerances: joints, vertices, positions and rot6d 1e-5 absolute; the
velocities, which divide frame differences by 1/fps, 1e-5 x fps.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pantomatrix_tpu.core import motion_rep as jmotion_rep
from pantomatrix_tpu.core import smplx as jsmplx
from pantomatrix_tpu_torch.core import motion_rep, smplx

torch.set_num_threads(2)

ATOL = 1e-5
V, F = 24, 40


def write_archive(path, v=V, f=F, seed=0, n_shape=400):
    """A synthetic archive with the real archive's keys, shapes over (V, F) and a
    55-joint chain kintree."""
    rng = np.random.RandomState(seed)
    kintree = np.zeros((2, 55), np.int64)
    kintree[0] = np.concatenate([[2**32 - 1], np.arange(54)])
    bary = rng.uniform(0.1, 1.0, (51, 3))
    np.savez(
        path,
        v_template=rng.normal(0, 0.3, (v, 3)),
        shapedirs=rng.normal(0, 0.01, (v, 3, n_shape)),
        posedirs=rng.normal(0, 0.01, (v, 3, 486)),
        J_regressor=np.abs(rng.normal(0, 1, (55, v))) / v,
        kintree_table=kintree,
        weights=np.abs(rng.normal(0, 1, (v, 55))) / 55,
        hands_meanl=rng.normal(0, 0.1, 45),
        hands_meanr=rng.normal(0, 0.1, 45),
        f=rng.randint(0, v, (f, 3)).astype(np.int64),
        lmk_faces_idx=rng.randint(0, f, 51).astype(np.int64),
        lmk_bary_coords=bary / bary.sum(1, keepdims=True),
    )
    return str(path)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = write_archive(tmp_path_factory.mktemp("smplx") / "SMPLX_NEUTRAL_2020.npz")
    return jsmplx.load_smplx(path), smplx.load_smplx(path, "cpu")


def _inputs(t=9, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-0.6, 0.6, (t, 165)).astype(np.float32),
            rng.normal(0, 1, 300).astype(np.float32),
            rng.normal(0, 1, (t, 100)).astype(np.float32),
            rng.normal(0, 0.5, (t, 3)).astype(np.float32))


def _close(got, want, name, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol,
                               err_msg=name)


def test_load_smplx_matches_jax(models):
    jm, m = models
    for k in ("v_template", "shapedirs", "exprdirs", "posedirs", "j_regressor",
              "lbs_weights", "hands_mean"):
        got, want = getattr(m, k), np.asarray(getattr(jm, k))
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape, k
        np.testing.assert_array_equal(got.numpy(), want, err_msg=k)
    np.testing.assert_array_equal(m.parents, np.asarray(jm.parents))
    for k in ("faces", "lmk_faces_idx", "lmk_bary_coords"):
        np.testing.assert_array_equal(getattr(m, k), getattr(jm, k), err_msg=k)
    assert m.num_vertices == jm.num_vertices == V and m.device == torch.device("cpu")


def test_too_few_blendshapes_raise_as_in_jax(tmp_path):
    path = write_archive(tmp_path / "small.npz", n_shape=350)
    with pytest.raises(ValueError, match="blendshapes"):
        jsmplx.load_smplx(path)
    with pytest.raises(ValueError, match="blendshapes"):
        smplx.read_smplx(path)


@pytest.mark.parametrize("case", ["plain", "per_frame_betas", "expr_trans", "flat_hands",
                                  "joints_only"])
def test_lbs_matches_jax(models, case):
    jm, m = models
    poses, betas, expr, trans = _inputs()
    kw = {}
    if case == "per_frame_betas":
        betas = np.random.RandomState(2).normal(0, 1, (9, 300)).astype(np.float32)
    if case == "expr_trans":
        kw = dict(expressions=expr, trans=trans)
    if case == "flat_hands":
        kw = dict(flat_hand_mean=True)
    if case == "joints_only":
        kw = dict(return_vertices=False)
    got = smplx.lbs(m, betas, poses, **kw)
    want = jsmplx.lbs(jm, jnp.asarray(betas), jnp.asarray(poses),
                      **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                         for k, v in kw.items()})
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        _close(got[k], want[k], k)


def test_body_joints_face_vertices_and_rest_pose_match_jax(models):
    jm, m = models
    poses, betas, expr, _ = _inputs(seed=3)
    _close(smplx.body_joints(m, torch.from_numpy(poses), torch.from_numpy(betas)),
           jsmplx.body_joints(jm, jnp.asarray(poses), jnp.asarray(betas)), "body joints")
    _close(smplx.body_joints(m, torch.from_numpy(poses)),
           jsmplx.body_joints(jm, jnp.asarray(poses)), "body joints, no betas")
    _close(smplx.face_vertices(m, torch.from_numpy(poses), torch.from_numpy(expr),
                               torch.from_numpy(betas)),
           jsmplx.face_vertices(jm, jnp.asarray(poses), jnp.asarray(expr), jnp.asarray(betas)),
           "face vertices")
    _close(smplx.rest_pose_joints(m, betas), jsmplx.rest_pose_joints(jm, jnp.asarray(betas)),
           "rest pose")
    _close(smplx.full_pose_with_hand_mean(m, torch.from_numpy(poses)),
           jsmplx.full_pose_with_hand_mean(jm, jnp.asarray(poses)), "hand mean")


def test_extended_joints_match_jax(models):
    jm, m = models
    poses, betas, expr, trans = _inputs(seed=4)
    out = smplx.lbs(m, betas, poses, expressions=expr, trans=trans)
    jout = jsmplx.lbs(jm, jnp.asarray(betas), jnp.asarray(poses), jnp.asarray(expr),
                      jnp.asarray(trans))
    got = smplx.extended_joints(m, out["vertices"], out["joints"])
    want = jsmplx.extended_joints(jm, jout["vertices"], jout["joints"])
    assert tuple(got.shape) == want.shape == (9, 76 + 51, 3)
    _close(got, want, "extended joints")


def test_synthetic_model_drives_the_jax_lbs_alike():
    m = smplx.make_synthetic_model(torch.Generator().manual_seed(0), "cpu", num_vertices=V)
    jm = jsmplx.SmplxModel(
        **{k: jnp.asarray(getattr(m, k).numpy()) for k in (
            "v_template", "shapedirs", "exprdirs", "posedirs", "j_regressor", "lbs_weights",
            "hands_mean")}, parents=jnp.asarray(m.parents.astype(np.int32)), faces=m.faces)
    assert tuple(m.posedirs.shape) == (54 * 9, V * 3)
    torch.testing.assert_close(m.lbs_weights.sum(1), torch.ones(V))
    poses, betas, expr, trans = _inputs(seed=5)
    got = smplx.lbs(m, betas, poses, expressions=expr, trans=trans)
    want = jsmplx.lbs(jm, jnp.asarray(betas), jnp.asarray(poses), jnp.asarray(expr),
                      jnp.asarray(trans))
    for k in want:
        _close(got[k], want[k], k)


@pytest.mark.parametrize("with_betas", [False, True])
def test_motion_rep_matches_jax(models, with_betas):
    jm, m = models
    fps = 30
    poses, betas, expr, _ = _inputs(t=12, seed=6)
    b = betas if with_betas else None
    got = motion_rep.get_motion_rep(m, poses, fps, betas=b)
    want = jmotion_rep.get_motion_rep(jm, poses, fps, betas=b)
    assert set(got) == set(want)
    for k, atol in (("position", ATOL), ("rotation", ATOL), ("velocity", ATOL * fps),
                    ("angular_velocity", ATOL * fps), ("rep15d", ATOL * fps)):
        assert got[k].shape == want[k].shape and isinstance(got[k], np.ndarray), k
        _close(got[k], want[k], k, atol)
    np.testing.assert_array_equal(got["axis_angle"], want["axis_angle"])
    fv = motion_rep.get_motion_rep(m, poses, fps, betas=b, expressions=expr,
                                   expression_only=True)
    jfv = jmotion_rep.get_motion_rep(jm, poses, fps, betas=b, expressions=expr,
                                     expression_only=True)
    assert set(fv) == {"vertices"} and fv["vertices"].shape == (12, V * 3)
    _close(fv["vertices"], jfv["vertices"], "face vertices")
    with pytest.raises(ValueError, match="expressions"):
        motion_rep.get_motion_rep(m, poses, fps, expression_only=True)
