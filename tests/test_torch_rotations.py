"""The port's Euler-angle, quaternion-algebra and random-rotation functions
(pantomatrix_tpu_torch/core/rotations.py) against the JAX package's
(pantomatrix_tpu/core/rotations.py) on the CPU, on float32 inputs from numpy seeds.

Euler angles are drawn inside each convention's unique range: Tait-Bryan (three distinct
axes) middle angle in (-1.2, 1.2), as tests/test_rotations.py draws them; proper Euler
(first axis = last) middle angle in (0.2, 2.9); the outer angles in (-3, 3).
Tolerances: matrices 1e-6, angles 1e-5 (the round trip too), the quaternion algebra
1e-6 against JAX, quaternion_apply 1e-5 against the matrix action. The random functions
take a torch.Generator where JAX takes a key, so their draws are not JAX's: they are
held to the same properties (unit norm, det 1, orthonormal) and to the same transform
(normals, normalised), and must repeat from a seeded generator.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pantomatrix_tpu.core import rotations as jrot
from pantomatrix_tpu_torch.core import rotations as rot

torch.set_num_threads(2)

TAIT_BRYAN = ["XYZ", "XZY", "YXZ", "YZX", "ZXY", "ZYX"]
PROPER = ["XYX", "XZX", "YXY", "YZY", "ZXZ", "ZYZ"]
CONVENTIONS = TAIT_BRYAN + PROPER


def _euler(convention, n=64, seed=0):
    rng = np.random.default_rng(seed + CONVENTIONS.index(convention))
    mid = (-1.2, 1.2) if convention in TAIT_BRYAN else (0.2, 2.9)
    return np.stack([rng.uniform(-3.0, 3.0, n), rng.uniform(*mid, n),
                     rng.uniform(-3.0, 3.0, n)], -1).astype(np.float32)


def _quats(n=32, seed=3):
    q = np.random.default_rng(seed).normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


@pytest.mark.parametrize("axis", ["X", "Y", "Z"])
def test_axis_angle_rotation_matches_jax(axis):
    angle = np.random.default_rng(1).uniform(-3, 3, (5, 7)).astype(np.float32)
    got = rot._axis_angle_rotation(axis, torch.from_numpy(angle))
    want = np.asarray(jrot._axis_angle_rotation(axis, jnp.asarray(angle)))
    assert got.shape == (5, 7, 3, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("convention", CONVENTIONS)
def test_euler_angles_to_matrix_matches_jax(convention):
    euler = _euler(convention)
    got = rot.euler_angles_to_matrix(torch.from_numpy(euler), convention).numpy()
    want = np.asarray(jrot.euler_angles_to_matrix(jnp.asarray(euler), convention))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("convention", CONVENTIONS)
def test_matrix_to_euler_angles_matches_jax_and_round_trips(convention):
    euler = _euler(convention, seed=20)
    # both packages read the same float32 matrices
    m = np.array(jrot.euler_angles_to_matrix(jnp.asarray(euler), convention))
    got = rot.matrix_to_euler_angles(torch.from_numpy(m), convention).numpy()
    want = np.asarray(jrot.matrix_to_euler_angles(jnp.asarray(m), convention))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    back = rot.matrix_to_euler_angles(
        rot.euler_angles_to_matrix(torch.from_numpy(euler), convention), convention)
    np.testing.assert_allclose(back.numpy(), euler, atol=1e-5, rtol=0)


def test_index_from_letter_matches_jax():
    for letter in "XYZ":
        assert rot._index_from_letter(letter) == jrot._index_from_letter(letter)


@pytest.mark.parametrize("tait_bryan", [True, False])
def test_angle_from_tan_matches_jax(tait_bryan):
    data = np.random.default_rng(4).normal(size=(16, 3)).astype(np.float32)
    for axis, other, horizontal in itertools.product("XYZ", "XYZ", (False, True)):
        if axis == other:
            continue
        got = rot._angle_from_tan(axis, other, torch.from_numpy(data), horizontal, tait_bryan)
        want = jrot._angle_from_tan(axis, other, jnp.asarray(data), horizontal, tait_bryan)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0,
                                   err_msg=f"{axis}{other} horizontal={horizontal}")


def test_quaternion_algebra_matches_jax():
    qa, qb = _quats(seed=5), _quats(seed=6)
    ta, tb, ja, jb = torch.from_numpy(qa), torch.from_numpy(qb), jnp.asarray(qa), jnp.asarray(qb)
    pairs = {
        "raw_multiply": (rot.quaternion_raw_multiply(ta, tb), jrot.quaternion_raw_multiply(ja, jb)),
        "multiply": (rot.quaternion_multiply(ta, tb), jrot.quaternion_multiply(ja, jb)),
        "invert": (rot.quaternion_invert(ta), jrot.quaternion_invert(ja)),
        "standardize": (rot.standardize_quaternion(ta), jrot.standardize_quaternion(ja)),
    }
    for name, (got, want) in pairs.items():
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0,
                                   err_msg=name)
    assert bool((rot.quaternion_multiply(ta, tb)[..., 0] >= 0).all())
    # composing quaternions composes their matrices
    np.testing.assert_allclose(
        rot.quaternion_to_matrix(rot.quaternion_raw_multiply(ta, tb)).numpy(),
        (rot.quaternion_to_matrix(ta) @ rot.quaternion_to_matrix(tb)).numpy(), atol=1e-5)


def test_quaternion_apply_matches_matrix_action_and_jax():
    q = _quats(seed=7)
    pts = np.random.default_rng(8).normal(size=(32, 3)).astype(np.float32)
    got = rot.quaternion_apply(torch.from_numpy(q), torch.from_numpy(pts))
    matmul = np.einsum("bij,bj->bi", rot.quaternion_to_matrix(torch.from_numpy(q)).numpy(), pts)
    np.testing.assert_allclose(got.numpy(), matmul, atol=1e-5, rtol=0)
    want = np.asarray(jrot.quaternion_apply(jnp.asarray(q), jnp.asarray(pts)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


BAD_INPUTS = {  # name: (function, its arguments, with zeros of the package's arrays)
    "euler_shape": ("euler_angles_to_matrix", lambda z: (z((4, 2)), "XYZ")),
    "convention_length": ("euler_angles_to_matrix", lambda z: (z((4, 3)), "XY")),
    "repeated_middle": ("euler_angles_to_matrix", lambda z: (z((4, 3)), "XXZ")),
    "repeated_middle_last": ("euler_angles_to_matrix", lambda z: (z((4, 3)), "XZZ")),
    "euler_letter": ("euler_angles_to_matrix", lambda z: (z((4, 3)), "XWZ")),
    "matrix_convention_length": ("matrix_to_euler_angles", lambda z: (z((4, 3, 3)), "ZYZZ")),
    "matrix_repeated_middle": ("matrix_to_euler_angles", lambda z: (z((4, 3, 3)), "ZZY")),
    "matrix_letter": ("matrix_to_euler_angles", lambda z: (z((4, 3, 3)), "XYA")),
    "matrix_shape": ("matrix_to_euler_angles", lambda z: (z((4, 2, 3)), "XYZ")),
    "apply_not_3d": ("quaternion_apply", lambda z: (z((4, 4)), z((4, 2)))),
    "axis_letter": ("_axis_angle_rotation", lambda z: ("W", z((4,)))),
}


@pytest.mark.parametrize("case", sorted(BAD_INPUTS))
def test_bad_inputs_raise_value_error_in_both(case):
    name, args = BAD_INPUTS[case]
    for mod, zeros in ((rot, torch.zeros), (jrot, jnp.zeros)):
        with pytest.raises(ValueError):
            getattr(mod, name)(*args(zeros))


def test_random_quaternions_draw_normals_and_normalise():
    q = rot.random_quaternions(64, torch.Generator().manual_seed(9))
    normals = torch.randn((64, 4), generator=torch.Generator().manual_seed(9))
    np.testing.assert_allclose(q.numpy(), (normals / normals.norm(dim=-1, keepdim=True)).numpy(),
                               atol=1e-7, rtol=0)
    # the JAX function: the same transform of its own normals
    jq = np.asarray(jrot.random_quaternions(jax.random.PRNGKey(9), 64))
    jn = np.asarray(jax.random.normal(jax.random.PRNGKey(9), (64, 4)))
    np.testing.assert_allclose(jq, jn / np.linalg.norm(jn, axis=-1, keepdims=True), atol=1e-6)
    assert q.shape == jq.shape == (64, 4) and q.dtype == torch.float32
    np.testing.assert_allclose(q.norm(dim=-1).numpy(), 1.0, atol=1e-6)
    assert bool((q[:, 0] < 0).any()), "random_quaternions is not standardized"


def test_random_rotations_are_rotations_and_repeat():
    m = rot.random_rotations(128, torch.Generator().manual_seed(10))
    assert m.shape == (128, 3, 3)
    np.testing.assert_allclose(torch.linalg.det(m).numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose((m @ m.transpose(-1, -2)).numpy(),
                               np.broadcast_to(np.eye(3), (128, 3, 3)), atol=1e-5)
    again = rot.random_rotations(128, torch.Generator().manual_seed(10))
    assert torch.equal(m, again)
    assert not torch.equal(m, rot.random_rotations(128, torch.Generator().manual_seed(11)))
    one = rot.random_rotation(torch.Generator().manual_seed(10), dtype=torch.float64)
    assert one.shape == (3, 3) and one.dtype == torch.float64
    np.testing.assert_allclose(float(torch.linalg.det(one)), 1.0, atol=1e-12)
    # the JAX function keeps the same properties
    jm = np.asarray(jrot.random_rotations(jax.random.PRNGKey(10), 128))
    np.testing.assert_allclose(np.linalg.det(jm), 1.0, atol=1e-5)
    assert np.asarray(jrot.random_rotation(jax.random.PRNGKey(10))).shape == (3, 3)
