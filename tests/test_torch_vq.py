"""K1, the VQ nearest-code search (pantomatrix_tpu_torch/ops/vq_cuda.py), on the CPU:
its plain version against the JAX Pallas kernel run in interpret mode and against the
JAX reference search, on random-normal data where the indices are equal. The CUDA
kernel itself runs only on the card (chip_smoke.py holds it against this plain version).
"""
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pantomatrix_tpu.nn.vq import nearest_code as jax_nearest_code
from pantomatrix_tpu.ops.vq_pallas import nearest_code_pallas
from pantomatrix_tpu_torch.nn import vq as port_vq
from pantomatrix_tpu_torch.ops import build, vq_cuda

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _normal(seed, *shape):
    return np.random.RandomState(seed).normal(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("n,d,k", [(512, 256, 256), (37, 16, 24), (640, 106, 256)])
def test_plain_k1_matches_pallas_and_reference(n, d, k):
    z, cb = _normal(0, n, d), _normal(1, k, d)
    got = vq_cuda.nearest_code_plain(torch.from_numpy(z), torch.from_numpy(cb))
    assert got.dtype == torch.int32
    pallas = np.asarray(nearest_code_pallas(jnp.asarray(z), jnp.asarray(cb), interpret=True))
    np.testing.assert_array_equal(got.numpy(), pallas)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_nearest_code(jnp.asarray(z),
                                                                           jnp.asarray(cb))))
    # the port's reference search keeps ||z||^2, as the JAX one does
    np.testing.assert_array_equal(
        port_vq.nearest_code(torch.from_numpy(z), torch.from_numpy(cb)).numpy(), got.numpy())


def test_wrapper_flattens_leading_dims_and_counts_no_cpu_launch():
    z, cb = _normal(2, 2, 8, 16), _normal(3, 16, 16)
    before = vq_cuda.launches
    got = vq_cuda.nearest_code(torch.from_numpy(z), torch.from_numpy(cb))
    assert got.shape == (2, 8) and got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(nearest_code_pallas(jnp.asarray(z), jnp.asarray(cb),
                                                    interpret=True)))
    assert vq_cuda.launches == before  # the CPU path never reaches the kernel


@pytest.mark.parametrize("z_shape,cb_shape,dtype,err", [
    ((4, 16), (8, 12), torch.float32, ValueError),
    ((4, 16), (8, 16), torch.float64, TypeError),
    ((4, 16), (16,), torch.float32, ValueError),
])
def test_wrapper_rejects_bad_inputs(z_shape, cb_shape, dtype, err):
    with pytest.raises(err):
        vq_cuda.nearest_code(torch.zeros(z_shape, dtype=dtype), torch.zeros(cb_shape, dtype=dtype))


def test_module_imports_and_runs_plain_without_nvcc(tmp_path):
    """Importing the kernel module builds nothing: it imports and serves CPU tensors
    with no CUDA compiler anywhere, and asking for the build then fails loudly."""
    code = (
        "import torch\n"
        "from pantomatrix_tpu_torch.ops import build, vq_cuda\n"
        "idx = vq_cuda.nearest_code(torch.randn(5, 4), torch.randn(3, 4))\n"
        "assert idx.shape == (5,) and vq_cuda.launches == 0\n"
        "try:\n"
        "    build.nvcc_path()\n"
        "except RuntimeError as e:\n"
        "    print('no nvcc:', e)\n"
        "else:\n"
        "    raise SystemExit('nvcc unexpectedly found')\n"
    )
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path / "no-cuda"),
               PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=str(tmp_path),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "no nvcc" in r.stdout


def test_build_targets_hopper_from_repo_sources():
    assert "-gencode=arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    lib = build.library_path("vq_nearest_code")
    assert lib.parent == build.BUILD_DIR
    assert (build.CSRC_DIR / "vq_nearest_code.cu").is_file()
    assert build.BUILD_DIR.relative_to(REPO).parts == ("build", "torch_kernels")
