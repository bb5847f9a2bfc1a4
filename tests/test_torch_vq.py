"""K1, the VQ nearest-code search (pantomatrix_tpu_torch/ops/vq_cuda.py), on the CPU:
its plain version against the JAX Pallas kernel run in interpret mode and against the
JAX reference search, on random-normal data where the indices are equal. The CUDA
kernel itself runs only on the card (chip_smoke.py holds it against this plain version).
"""
import ctypes
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


# --- the launch plan of the split-TF32 cluster kernel -------------------------------

MAIN_PATH = [(8 * 64, 256, 256), (8 * 60, 256, 256), (8 * 600, 256, 256),
             (128 * 64, 256, 256), (128 * 60, 256, 256), (128 * 1800, 256, 256)]
KERNEL_TESTS = [(512, 256, 256), (37, 16, 24), (640, 106, 256)]
PLAN_CASES = MAIN_PATH + KERNEL_TESTS + [
    (n, d, k) for n in (1, 512, 64 * 132 * 3 + 5) for d, k in ((16, 16), (256, 256), (106, 256))
] + [(100, 32, 300), (4096, 64, 1000), (512, 256, 4096)]


@pytest.mark.parametrize("n,d,k", PLAN_CASES)
def test_plan_search_covers_rows_and_codes(n, d, k):
    plan = vq_cuda.plan_search(n, d, k, 132)
    assert plan.rows_per_cta == 64 and plan.row_tiles == -(-n // 64)
    assert plan.cluster in (1, 2, 4, 8) and plan.ctas % plan.cluster == 0
    assert plan.codes_per_tile in (32, 64, 128, 256) and plan.tiles_per_cta >= 1
    # every code has one owner rank and no rank owns none
    assert plan.cluster * plan.codes_per_cta >= k > (plan.cluster - 1) * plan.codes_per_cta
    assert plan.smem_bytes == vq_cuda.smem_bytes(plan.codes_per_tile) <= 232448
    assert plan.stages == vq_cuda.stages(plan.codes_per_tile) >= 2
    if n >= 512 and k >= 256:
        assert plan.ctas >= 64
    # no other cluster size has a lower estimated time
    cost = lambda p: -(-p.ctas // 132) * (vq_cuda.CTA_FIXED_CODES + p.codes_per_cta)
    for s in (1, 2, 4, 8):
        if s == plan.cluster:
            continue
        share = -(-k // s)
        tile = next(t for t in (32, 64, 128, 256) if t >= min(share, 256))
        tiles = -(-share // tile)
        if (s - 1) * tile * tiles >= k:
            continue
        other = plan._replace(cluster=s, codes_per_tile=tile, tiles_per_cta=tiles)
        assert cost(other) > cost(plan) or (cost(other) == cost(plan) and s > plan.cluster)


@pytest.mark.parametrize("n,cluster,ctas,codes", [
    (512, 8, 64, 32), (480, 8, 64, 32), (4800, 1, 75, 256),
    (8192, 1, 128, 256), (7680, 1, 120, 256), (230400, 1, 3600, 256)])
def test_plan_search_main_path(n, cluster, ctas, codes):
    plan = vq_cuda.plan_search(n, 256, 256, 132)
    assert (plan.cluster, plan.ctas, plan.codes_per_cta) == (cluster, ctas, codes)


@pytest.mark.parametrize("n,d,k,sms", [(0, 256, 256, 132), (512, 0, 256, 132),
                                       (512, 256, 0, 132), (512, 256, 256, 0),
                                       (2**31, 256, 256, 132), (-1, 16, 16, 132)])
def test_plan_search_rejects(n, d, k, sms):
    with pytest.raises(ValueError):
        vq_cuda.plan_search(n, d, k, sms)


# --- split TF32 and its model of the product ------------------------------------------

def _near_tie_mismatches(z, cb, got, want):
    """Rows where two index vectors differ, and the largest relative float64 distance gap
    between the two chosen codes over those rows (chip_smoke.py phase 3's criterion)."""
    z64, cb64 = z.astype(np.float64), cb.astype(np.float64)
    dist = lambda idx: ((z64 - cb64[idx]) ** 2).sum(-1)
    differ = got != want
    if not differ.any():
        return 0, 0.0
    d_got, d_want = dist(got[differ]), dist(want[differ])
    return int(differ.sum()), float((np.abs(d_got - d_want) / np.abs(d_want)).max())


def test_split_tf32_halves_are_tf32_and_exact_to_2_pow_minus_22():
    rs = np.random.RandomState(4)
    x = (rs.normal(0, 1, 20000) * np.exp2(rs.uniform(-60, 60, 20000))).astype(np.float32)
    hi, lo = vq_cuda.split_tf32(torch.from_numpy(x))
    for half in (hi, lo):
        assert (half.view(torch.int32) & 0x1FFF).eq(0).all()
    resid = np.abs(x.astype(np.float64) - hi.double().numpy() - lo.double().numpy())
    assert (resid <= 2.0 ** -22 * np.abs(x.astype(np.float64))).all()


@pytest.mark.parametrize("x,want", [(1 + 2**-12, 1.0), (1 + 2**-11, 1 + 2**-10),
                                    (-(1 + 2**-11), -(1 + 2**-10)), (0.0, 0.0),
                                    (float("inf"), float("inf"))])
def test_split_tf32_rounds_to_nearest_ties_away(x, want):
    hi, lo = vq_cuda.split_tf32(torch.tensor([x], dtype=torch.float32))
    assert float(hi) == want
    assert float(lo) == (0.0 if not np.isfinite(x) else np.float32(x) - np.float32(want))


@pytest.mark.parametrize("n,d,k", KERNEL_TESTS + [(8 * 64, 256, 256), (8 * 600, 256, 256)])
def test_split_model_matches_jax_reference_up_to_near_ties(n, d, k):
    """The 3xTF32 product keeps fp32-grade indices: against the JAX reference search
    (CPU, highest precision) rows differ only at near-ties within 1e-5 relative, in
    under 0.1% of rows."""
    z, cb = _normal(5, n, d), _normal(6, k, d)
    got = vq_cuda.nearest_code_split_plain(torch.from_numpy(z), torch.from_numpy(cb)).numpy()
    want = np.asarray(jax_nearest_code(jnp.asarray(z), jnp.asarray(cb)))
    assert got.dtype == np.int32 and got.shape == (n,)
    n_diff, gap = _near_tie_mismatches(z, cb, got, want)
    assert n_diff < 1e-3 * n and gap < 1e-5, (n_diff, gap)


def test_split_model_on_emage_scale_latents():
    """An EMAGE window at its own scale: codes from the reference init U(+-1/K) and
    latents near them, where distances are small and ties are closer."""
    rs = np.random.RandomState(7)
    cb = rs.uniform(-1 / 256, 1 / 256, (256, 256)).astype(np.float32)
    z = (cb[rs.randint(0, 256, 512)] + rs.normal(0, 1e-3, (512, 256))).astype(np.float32)
    got = vq_cuda.nearest_code_split_plain(torch.from_numpy(z), torch.from_numpy(cb)).numpy()
    want = np.asarray(jax_nearest_code(jnp.asarray(z), jnp.asarray(cb)))
    n_diff, gap = _near_tie_mismatches(z, cb, got, want)
    assert n_diff < 1e-3 * 512 and gap < 1e-5, (n_diff, gap)


def test_kernel_source_is_split_tf32_cluster_and_matches_its_binding(monkeypatch):
    """The repo's source builds for sm_90a into the build directory, runs its product on
    the tensor cores with a cluster launch, and its C entry point takes the arguments
    the wrapper passes."""
    src = (build.CSRC_DIR / "vq_nearest_code.cu").read_text()
    assert "-gencode=arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert build.library_path("vq_nearest_code").parent == build.BUILD_DIR
    for needle in ("wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32",
                   "cudaLaunchAttributeClusterDimension",
                   "mapa.shared::cluster", "cp.async.bulk.tensor.2d", "SWIZZLE_128B"):
        assert needle in src, needle
    sig = src[src.index("int vq_nearest_code("):]
    params = sig[sig.index("(") + 1:sig.index(")")].split(",")
    assert len(params) == 13
    fake = type("Lib", (), {})()
    fake.vq_nearest_code = type("Fn", (), {})()
    fake.vq_error_string = type("Fn", (), {})()
    monkeypatch.setattr(build, "load", lambda name: fake)
    monkeypatch.setattr(vq_cuda, "_fn", None)
    fn = vq_cuda._kernel()
    assert len(fn.argtypes) == len(params)
    assert fn.argtypes[-1] is ctypes.c_void_p
