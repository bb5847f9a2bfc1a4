"""K2, one LSTM direction (pantomatrix_tpu_torch/ops/lstm_cuda.py), and the LSTM module
(pantomatrix_tpu_torch/nn/lstm.py) on the CPU, against the JAX package: the scan
direction ``_lstm_direction``, the Pallas kernel run in interpret mode, and ``lstm``
with the same weights. Inputs come from a numpy seed.

Tolerance atol 1e-5: torch and XLA sum the recurrent product in different orders on
the CPU, and the difference compounds over the steps. At (20, 16, 512) the kernel
test's N(0, 0.2) recurrent weights (eight times torch's init scale) give gate
pre-activations of standard deviation ~4, and there the JAX scan itself is 1.5e-5
from a float64 run while the port's plain version is 7.0e-6 from it; so that shape
is held to 2e-5 against JAX. At every shape the port is also held to the float64 run:
no further from it than twice the JAX result's distance plus 1e-6. The CUDA kernel
itself runs only on the card (chip_smoke.py holds it against the plain version).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pantomatrix_tpu.nn.lstm import _lstm_direction, init_lstm, lstm
from pantomatrix_tpu.ops.lstm_pallas import lstm_sequence_pallas
from pantomatrix_tpu_torch.convert import load_jax_params
from pantomatrix_tpu_torch.nn.lstm import LSTM
from pantomatrix_tpu_torch.ops import build, lstm_cuda

torch.set_num_threads(2)

ATOL = 1e-5
SHAPES = [(12, 8, 128), (9, 5, 96), (20, 16, 512)]
WIDE_ATOL = {(20, 16, 512): 2e-5}  # see the module docstring


def _inputs(t, b, h, seed=2):
    """The JAX kernel test's distributions: x_proj N(0, 1), w_hh N(0, 0.2)."""
    rng = np.random.RandomState(seed)
    return (rng.normal(0, 1, (t, b, 4 * h)).astype(np.float32),
            rng.normal(0, 0.2, (4 * h, h)).astype(np.float32))


@pytest.mark.parametrize("reference", ["scan", "pallas_interpret"])
@pytest.mark.parametrize("t,b,h", SHAPES)
def test_plain_k2_matches_jax(t, b, h, reference):
    xp, w = _inputs(t, b, h)
    if reference == "scan":
        want = _lstm_direction(jnp.asarray(xp), jnp.asarray(w), h)
    else:
        want = lstm_sequence_pallas(jnp.asarray(xp), jnp.asarray(w), h, interpret=True)
    got = lstm_cuda.lstm_direction_plain(torch.from_numpy(xp), torch.from_numpy(w), h)
    assert got.shape == (t, b, h)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=WIDE_ATOL.get((t, b, h), ATOL))
    exact = lstm_cuda.lstm_direction_plain(torch.from_numpy(xp).double(),
                                           torch.from_numpy(w).double(), h).numpy()
    jax_err = np.abs(np.asarray(want) - exact).max()
    assert np.abs(got.numpy() - exact).max() <= 2 * jax_err + 1e-6


def test_wrapper_serves_cpu_with_the_plain_version_and_counts_no_launch():
    xp, w = _inputs(6, 3, 32, seed=5)
    before = lstm_cuda.launches
    got = lstm_cuda.lstm_direction(torch.from_numpy(xp), torch.from_numpy(w), 32)
    want = lstm_cuda.lstm_direction_plain(torch.from_numpy(xp), torch.from_numpy(w), 32)
    assert torch.equal(got, want)
    assert lstm_cuda.launches == before  # the CPU path never reaches the kernel


@pytest.mark.parametrize("xp_shape,w_shape,hidden,dtype,err", [
    ((4, 2, 32), (32, 8), 8, torch.float64, TypeError),
    ((4, 2, 30), (32, 8), 8, torch.float32, ValueError),
    ((4, 2, 32), (32, 7), 8, torch.float32, ValueError),
    ((2, 32), (32, 8), 8, torch.float32, ValueError),
])
def test_wrapper_rejects_bad_inputs(xp_shape, w_shape, hidden, dtype, err):
    with pytest.raises(err):
        lstm_cuda.lstm_direction(torch.zeros(xp_shape, dtype=dtype),
                                 torch.zeros(w_shape, dtype=dtype), hidden)


@pytest.mark.parametrize("layers", [1, 2])
def test_lstm_module_matches_jax(layers):
    """Bidirectional, JAX-initialised weights strict-loaded into the module."""
    c, h = 20, 24
    params = init_lstm(jax.random.PRNGKey(0), c, h, layers)
    tree = jax.tree_util.tree_map(np.asarray, params)
    module = load_jax_params(LSTM(c, h, layers, generator=torch.Generator()), tree)
    x = np.random.RandomState(1).normal(0, 1, (3, 11, c)).astype(np.float32)
    want = lstm(params, jnp.asarray(x), h, layers)
    got = module(torch.from_numpy(x))
    assert got.shape == (3, 11, 2 * h)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_lstm_module_names_shapes_and_init_follow_torch():
    module = LSTM(20, 16, 2, generator=torch.Generator().manual_seed(0))
    ref = torch.nn.LSTM(20, 16, 2, bidirectional=True)
    got = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    assert got == {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    bound = 16 ** -0.5
    for k, v in module.state_dict().items():
        assert float(v.abs().max()) <= bound, k
    # the same module computes what torch.nn.LSTM computes with its weights
    ref.load_state_dict(module.state_dict())
    x = torch.randn(2, 7, 20, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want, _ = ref(x.transpose(0, 1))
    torch.testing.assert_close(module(x).detach(), want.transpose(0, 1), rtol=0, atol=ATOL)


def test_kernel_source_builds_for_hopper_without_fast_math():
    assert (build.CSRC_DIR / "lstm_sequence.cu").is_file()
    assert build.library_path("lstm_sequence").parent == build.BUILD_DIR
    assert "-gencode=arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert not any("fast_math" in f or "fast-math" in f for f in build.NVCC_FLAGS)
