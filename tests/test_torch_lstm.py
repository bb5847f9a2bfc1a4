"""K2, the LSTM recurrence (pantomatrix_tpu_torch/ops/lstm_cuda.py: one direction, both
directions of a layer, and the kernel's launch plan), and the LSTM module
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
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pantomatrix_tpu.nn.lstm import _lstm_direction, init_lstm, lstm
from pantomatrix_tpu.ops.lstm_pallas import lstm_sequence_pallas
from pantomatrix_tpu_torch.convert import load_jax_params
from pantomatrix_tpu_torch.nn.lstm import LSTM
from pantomatrix_tpu_torch.ops import build, lstm_cuda, vq_cuda

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
    before = (lstm_cuda.launches, lstm_cuda.mma_launches)
    got = lstm_cuda.lstm_direction(torch.from_numpy(xp), torch.from_numpy(w), 32)
    want = lstm_cuda.lstm_direction_plain(torch.from_numpy(xp), torch.from_numpy(w), 32)
    assert torch.equal(got, want)
    # the CPU path never reaches the kernel
    assert (lstm_cuda.launches, lstm_cuda.mma_launches) == before


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


def test_every_kernel_variant_keeps_the_name_the_benchmark_reads():
    """The benchmark finds K2 in a device trace by the substring ``lstm_layer_kernel``
    (benchmark/metrics/k2_roofline.offline.py): every __global__ function of the source,
    whichever gate product it computes, carries it."""
    src = (build.CSRC_DIR / "lstm_sequence.cu").read_text()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(", src)
    assert names and all("lstm_layer_kernel" in n for n in names)
    # both products are instantiations of that one template
    assert "lstm_layer_kernel<true, 0, 0, 4>" in src
    assert "lstm_layer_kernel<true, RT, UT, 0>" in src


def test_kernel_source_builds_for_hopper_without_fast_math():
    assert (build.CSRC_DIR / "lstm_sequence.cu").is_file()
    assert build.library_path("lstm_sequence").parent == build.BUILD_DIR
    assert "-gencode=arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert not any("fast_math" in f or "fast-math" in f for f in build.NVCC_FLAGS)
    # the library is named by the source and the flags together: other flags, other file
    assert build.library_path("lstm_sequence") == \
        build.library_path("lstm_sequence", list(build.NVCC_FLAGS))
    other = [f for f in build.NVCC_FLAGS if f != "-O3"] + ["-O2"]
    assert build.library_path("lstm_sequence", other) != build.library_path("lstm_sequence")


# --- the kernel's launch plan: which CTA owns which (direction, batch row, unit) ---

H100_SMS, H100_SMEM = 132, 232448


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("h", [48, 96, 128, 512, 1024])
@pytest.mark.parametrize("b", [1, 5, 8, 13, 32, 64, 128, 256])
def test_plan_layer_owns_every_cell_once_and_fits_the_card(b, h, d):
    plan = lstm_cuda.plan_layer(421, b, h, d, H100_SMS, H100_SMEM)
    owners = np.zeros((d, b, h), np.int64)
    # the CUDA grid is (unit group, batch group, direction); a CTA owns units
    # [j * U, (j + 1) * U) and rows [g * BR, (g + 1) * BR), cut at H and B
    for di in range(d):
        for g in range(plan.batch_groups):
            for j in range(plan.unit_groups):
                owners[di, g * plan.rows:(g + 1) * plan.rows,
                       j * plan.units:(j + 1) * plan.units] += 1
    assert (owners == 1).all()
    assert plan.ctas <= H100_SMS
    assert plan.smem_bytes == lstm_cuda.smem_bytes(h, plan.units, plan.tile_rows, plan.rows,
                                                   plan.resident, plan.product) <= H100_SMEM
    # the kernel splits its 256 threads into (row tile, unit, k split within a warp)
    assert plan.tile_rows in (4, 8, 16, 32)
    assert 1 <= lstm_cuda.k_split(plan.units, plan.tile_rows) <= 32


def test_plan_layer_keeps_w_hh_resident_at_the_path_shapes():
    """CaMN/DisCo's layers at B = 8 and 64: W_hh's slices stay in shared memory and the
    per-CTA product is the whole layer's split evenly over 128 CTAs."""
    for b in (8, 64):
        plan = lstm_cuda.plan_layer(421, b, 512, 2, H100_SMS, H100_SMEM)
        assert plan.resident and plan.ctas == 128
        assert plan.rows * plan.units * plan.ctas == b * 512 * 2


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("h", [48, 512, 1024])
@pytest.mark.parametrize("b", [1, 5, 8, 13, 32, 64, 128, 256])
def test_plan_layer_takes_the_tensor_cores_where_the_tile_fills_the_mma(b, h, d):
    """The product follows the shape alone: split TF32 on the tensor cores where W_hh's
    slice is resident, the CTA has 16 units (64 gate rows), its tile has at least
    MMA_MIN_TILE_ROWS batch rows, H is a multiple of 64 (the TMA copies of h take each
    half of H in whole 32-float segments) and the warps' partial sums fit shared memory;
    FFMA otherwise. The cut of the card does not depend on the product."""
    plan = lstm_cuda.plan_layer(421, b, h, d, H100_SMS, H100_SMEM)
    assert plan.product in ("ffma", "mma")
    mma_smem = lstm_cuda.smem_bytes(h, plan.units, plan.tile_rows, plan.rows, plan.resident,
                                    "mma")
    want = plan.resident and plan.units == 16 and h % 64 == 0 and \
        plan.tile_rows >= lstm_cuda.MMA_MIN_TILE_ROWS and mma_smem <= H100_SMEM
    assert (plan.product == "mma") == want
    ffma_plan = plan._replace(product="ffma", smem_bytes=lstm_cuda.smem_bytes(
        h, plan.units, plan.tile_rows, plan.rows, plan.resident))
    # the same cut as the FFMA-only planner would make: only the product and its memory
    assert 1 <= lstm_cuda.k_split(ffma_plan.units, ffma_plan.tile_rows) <= 32
    assert ffma_plan.smem_bytes <= plan.smem_bytes <= H100_SMEM
    if plan.product == "mma":
        assert lstm_cuda.mma_fits(h, plan.units, plan.tile_rows, plan.rows, plan.resident,
                                  H100_SMEM)


@pytest.mark.parametrize("t,b,h,d,product", [
    (421, 64, 512, 2, "mma"),   # CaMN/DisCo offline at batch 64: the benchmark's cell
    (421, 32, 512, 2, "mma"),
    (421, 32, 512, 1, "ffma"),  # an 8-row tile (see MMA_MIN_TILE_ROWS)
    (421, 16, 512, 2, "ffma"),
    (421, 8, 512, 2, "ffma"),   # CaMN/DisCo at batch 8: a 4-row tile
    (421, 1, 512, 2, "ffma"),
    (960, 1, 512, 2, "ffma"),   # evaluation's take at batch 1
    (64, 64, 512, 2, "mma"),    # the training forward
    (127, 64, 512, 2, "mma"),   # cli.bench_train
    (421, 64, 1024, 2, "ffma"),  # W_hh not resident
])
def test_plan_layer_product_at_the_path_shapes(t, b, h, d, product):
    plan = lstm_cuda.plan_layer(t, b, h, d, H100_SMS, H100_SMEM)
    assert plan.product == product
    if (b, h) == (64, 512):  # the partial sums fit in the h tile's room: no more memory
        # than the FFMA layout's but the TMA copies' two mbarriers and 1,024-byte alignment
        assert plan.smem_bytes == lstm_cuda.smem_bytes(h, plan.units, plan.tile_rows,
                                                       plan.rows, plan.resident) + 1024


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("h", [48, 96, 128, 192, 512])
@pytest.mark.parametrize("b", [1, 5, 8, 13, 32, 64, 128, 200, 256])
def test_plan_layer_takes_the_tensor_cores_only_where_tma_cuts_h(b, h, d):
    """The tensor-core variants take h by TMA copies of whole 32-float segments, half of
    H a copy: their plans have H % 64 == 0 and the TMA layout's memory (two mbarriers and
    the room to align the tile to 1,024 bytes) within the card's; every other plan keeps
    the FFMA layout."""
    plan = lstm_cuda.plan_layer(421, b, h, d, H100_SMS, H100_SMEM)
    ffma = lstm_cuda.smem_bytes(h, plan.units, plan.tile_rows, plan.rows, plan.resident)
    if h % 64:
        assert plan.product == "ffma"
    if plan.product == "mma":
        assert h % 64 == 0 and plan.resident and plan.units == lstm_cuda.MMA_UNITS
        assert lstm_cuda.mma_fits(h, plan.units, plan.tile_rows, plan.rows, plan.resident,
                                  H100_SMEM)
        assert ffma + 1024 <= plan.smem_bytes <= H100_SMEM
    else:
        assert plan.smem_bytes == ffma


@pytest.mark.parametrize("h", [48, 64, 96, 100, 128, 192, 320, 512, 1024])
def test_mma_fits_needs_h_in_whole_32_float_halves(h):
    fits = lstm_cuda.mma_fits(h, lstm_cuda.MMA_UNITS, 16, 16, True, 1 << 30)
    assert fits == (h % 64 == 0)


def _c_function(src: str, signature: str) -> str:
    """The text of a top-level C function of the CUDA source, from its signature to its
    closing brace at the start of a line, or to the end of its line for a one-line body."""
    start = src.index(signature)
    line = src[start:src.index("\n", start) + 1]
    if line.rstrip().endswith("}"):
        return line
    return src[start:src.index("\n}\n", start) + 3]


def _host_program(tmp_path, body: str, main: str):
    """Compiles ``body`` (functions of the CUDA source, the device ones as host inline
    functions) and ``main`` as host C++; returns the executable."""
    import shutil
    import subprocess

    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a host C++ compiler builds the source's functions for this check"
    src = (build.CSRC_DIR / "lstm_sequence.cu").read_text()
    consts = "\n".join(re.findall(r"^constexpr int (?:THREADS|WARPS) = [^;]+;", src, re.M))
    prog = tmp_path / "prog.cpp"
    prog.write_text("#include <cstddef>\n#include <cstdio>\n#define __device__\n"
                    "#define __forceinline__ inline\n" + consts + "\n" + body + main)
    exe = tmp_path / "prog"
    subprocess.run([cxx, "-std=c++17", "-o", str(exe), str(prog)], check=True)
    return exe


def test_smem_bytes_mirrors_the_cuda_source(tmp_path):
    """The source's smem_bytes, compiled as host C++ with its constants, gives the
    wrapper's number at every cut: both products, residency, ragged H."""
    import subprocess

    src = (build.CSRC_DIR / "lstm_sequence.cu").read_text()
    cases = [(h, u, bt, br, res, mma) for h in (48, 96, 100, 512, 1024)
             for u in (8, 16, 64) for bt in (4, 8, 16, 32) for br in (1, 13, 32, 64)
             for res in (0, 1) for mma in (0, 1)]
    exe = _host_program(tmp_path, _c_function(src, "size_t smem_bytes("), r"""
int main() {
  int h, u, bt, br, res, mma;
  while (scanf("%d %d %d %d %d %d", &h, &u, &bt, &br, &res, &mma) == 6)
    printf("%zu\n", smem_bytes(h, u, bt, br, res, mma));
}
""")
    out = subprocess.run([str(exe)], input="\n".join(" ".join(map(str, c)) for c in cases),
                         capture_output=True, text=True, check=True).stdout.split()
    want = [lstm_cuda.smem_bytes(h, u, bt, br, bool(res), "mma" if mma else "ffma")
            for h, u, bt, br, res, mma in cases]
    assert [int(x) for x in out] == want


@pytest.mark.parametrize("hc", [16, 32, 128])
@pytest.mark.parametrize("bt", [8, 16, 32])
def test_tma_layout_of_h_is_a_bank_conflict_free_permutation(tmp_path, bt, hc):
    """The source's tma_hs, mma_row and red_col, compiled as host C++: the TMA layout
    holds each float4 of the BT x HC tile once, in 1,024-byte segments; the 8 lanes of a
    quarter warp read 8 different bank groups in mma_blocks; and a warp's stores of its
    partial sums hit 32 different banks."""
    import subprocess

    src = (build.CSRC_DIR / "lstm_sequence.cu").read_text()
    body = "\n".join(_c_function(src, sig) for sig in (
        "__device__ __forceinline__ int mma_row(", "__device__ __forceinline__ int tma_hs(",
        "__device__ __forceinline__ int red_col("))
    exe = _host_program(tmp_path, body, r"""
int main() {
  int bt, hc;
  if (scanf("%d %d", &bt, &hc) != 2) return 1;
  for (int bl = 0; bl < bt; ++bl)
    for (int c = 0; c < hc; ++c) printf("hs %d %d %d\n", bl, c, tma_hs(bt, bl, c));
  for (int g = 0; g < 8; ++g) printf("row %d %d\n", g, mma_row(g));
  for (int n = 0; n < bt; ++n)
    for (int r = 0; r < 64; ++r) printf("red %d %d %d\n", n, r, red_col(n, r));
}
""")
    out = subprocess.run([str(exe)], input=f"{bt} {hc}", capture_output=True, text=True,
                         check=True).stdout.split("\n")
    hs, row, red = {}, {}, {}
    for line in filter(None, out):
        kind, *v = line.split()
        v = tuple(map(int, v))
        {"hs": hs, "row": row, "red": red}[kind][v[:-1]] = v[-1]
    # a permutation of the tile; each 32-float segment of BT rows starts on 1,024 bytes
    assert sorted(hs.values()) == list(range(bt * hc))
    assert all(hs[bl, 8 * seg] // (8 * bt) == seg and (hs[0, 8 * seg] * 16) % 1024 == 0
               for bl in range(bt) for seg in range(hc // 8))
    assert sorted(row[g,] for g in range(8)) == list(range(8))
    for nt in range(bt // 8):
        for kb in range(hc // 4):
            for quarter in range(4):  # lanes 8 quarter .. 8 quarter + 7: g, q = lane / 4, % 4
                lanes = range(8 * quarter, 8 * quarter + 8)
                groups = {hs[8 * nt + row[lane >> 2,], 4 * kb + (lane & 3)] % 8 for lane in lanes}
                assert len(groups) == 8
    for nt in range(bt // 8):
        for mt in range(4):
            for k in range(4):  # one store of the warp: fragment element k of every lane
                banks = set()
                for lane in range(32):
                    g, q = lane >> 2, lane & 3
                    r = 16 * mt + g + 8 * (k >> 1)
                    bl = 8 * nt + row[2 * q + (k & 1),]
                    banks.add((bl * 64 + red[bl, r]) % 32)
                assert len(banks) == 32


def test_lstm_layer_signature_matches_the_wrapper_argtypes():
    """lstm_layer's C parameters, in order, against LAYER_ARGTYPES: four pointers, the nine
    ints of the shape and plan, the stream."""
    import ctypes

    src = (build.CSRC_DIR / "lstm_sequence.cu").read_text()
    params = re.search(r"int lstm_layer\(([^)]*)\)", src).group(1)
    kinds = [ctypes.c_void_p if ("*" in p or "cudaStream_t" in p) else ctypes.c_int
             for p in (" ".join(p.split()) for p in params.split(","))]
    assert kinds == lstm_cuda.LAYER_ARGTYPES
    names = [p.split()[-1].lstrip("*") for p in params.split(",")]
    assert names[-2:] == ["mma", "stream"]


def test_kernel_source_takes_h_by_tma_in_the_tensor_core_variants():
    """The tensor-core variants' h tile: 3-D TMA copies in the 128-byte swizzle, completing
    on mbarriers with their bytes, after a proxy fence; one cooperative launch for every
    variant, refused where H is no multiple of 64 for the tensor-core product."""
    src = (build.CSRC_DIR / "lstm_sequence.cu").read_text()
    assert "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes " \
        in _c_function(src, "__device__ __forceinline__ void tma_load(")
    assert "CU_TENSOR_MAP_SWIZZLE_128B" in _c_function(src, "cudaError_t make_h_map(")
    assert "mbarrier.arrive.expect_tx" in src and "mbarrier.try_wait.parity" in src
    assert "fence.proxy.async;" in src and "fence.mbarrier_init" in src
    launch = _c_function(src, "int lstm_layer(")
    assert "cudaLaunchCooperativeKernel" in launch and "cudaLaunchKernelEx" not in launch
    assert "mma && H % 64 != 0" in launch and "make_h_map" in launch


def test_plan_layer_raises_where_nothing_fits():
    with pytest.raises(ValueError):
        lstm_cuda.plan_layer(10, 8, 512, 2, 132, 4 * 1024)
    with pytest.raises(ValueError):
        lstm_cuda.plan_layer(10, 8, 512, 3, 132, H100_SMEM)


# --- both directions of a layer in one call ---

def _layer_inputs(t, b, c, h, seed):
    rng = np.random.RandomState(seed)
    bound = h ** -0.5
    u = lambda *shape: rng.uniform(-bound, bound, shape).astype(np.float32)
    return (rng.normal(0, 1, (t, b, c)).astype(np.float32),
            {sfx: (u(4 * h, c), u(4 * h, h), u(4 * h), u(4 * h)) for sfx in ("", "_r")})


@pytest.mark.parametrize("layers", [1, 2])
def test_plain_bidirectional_matches_jax_lstm(layers):
    """Each layer as the port's module runs it (one projection against the stacked input
    weights, then lstm_bidirectional_plain), against the JAX package's lstm."""
    c, h = 20, 24
    params = jax.tree_util.tree_map(np.asarray, init_lstm(jax.random.PRNGKey(3), c, h, layers))
    x = np.random.RandomState(4).normal(0, 1, (2, 9, c)).astype(np.float32)
    want = np.asarray(lstm(params, jnp.asarray(x), h, layers))
    y = torch.from_numpy(x).transpose(0, 1)
    for layer in range(layers):
        p = lambda name: [torch.from_numpy(params[f"{name}_l{layer}{sfx}"])
                          for sfx in ("", "_reverse")]
        x_proj = (torch.matmul(y, torch.cat(p("weight_ih")).T)
                  + torch.cat(p("bias_ih")) + torch.cat(p("bias_hh"))).contiguous()
        y = lstm_cuda.lstm_bidirectional_plain(x_proj, torch.stack(p("weight_hh")), h)
    got = y.transpose(0, 1).numpy()
    assert got.shape == (2, 9, 2 * h)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_bidirectional_halves_are_the_two_scan_directions():
    """The forward half is _lstm_direction on the sequence; the reverse half is
    _lstm_direction on the flipped reverse projection, flipped back."""
    t, b, h = 13, 3, 32
    rng = np.random.RandomState(6)
    xp = rng.normal(0, 1, (t, b, 8 * h)).astype(np.float32)
    w = rng.normal(0, 0.2, (2, 4 * h, h)).astype(np.float32)
    got = lstm_cuda.lstm_bidirectional(torch.from_numpy(xp), torch.from_numpy(w), h).numpy()
    fwd = _lstm_direction(jnp.asarray(xp[..., :4 * h]), jnp.asarray(w[0]), h)
    rev = _lstm_direction(jnp.asarray(xp[::-1, :, 4 * h:]), jnp.asarray(w[1]), h)[::-1]
    assert got.shape == (t, b, 2 * h)
    np.testing.assert_allclose(got[..., :h], np.asarray(fwd), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got[..., h:], np.asarray(rev), rtol=0, atol=ATOL)


def test_bidirectional_wrapper_serves_cpu_with_the_plain_version_and_counts_no_launch():
    rng = np.random.RandomState(7)
    xp = torch.from_numpy(rng.normal(0, 1, (5, 2, 8 * 16)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 0.2, (2, 64, 16)).astype(np.float32))
    before = lstm_cuda.launches
    assert torch.equal(lstm_cuda.lstm_bidirectional(xp, w, 16),
                       lstm_cuda.lstm_bidirectional_plain(xp, w, 16))
    assert lstm_cuda.launches == before


@pytest.mark.parametrize("case", ["dtype", "4h_projection", "w_hh_shape", "non_contiguous",
                                  "mixed_devices"])
def test_bidirectional_wrapper_rejects_bad_inputs(case):
    h = 8
    xp, w = torch.zeros(4, 2, 8 * h), torch.zeros(2, 4 * h, h)
    err = ValueError
    if case == "dtype":
        xp, w, err = xp.double(), w.double(), TypeError
    elif case == "4h_projection":
        xp = torch.zeros(4, 2, 4 * h)
    elif case == "w_hh_shape":
        w = torch.zeros(4 * h, h)
    elif case == "non_contiguous":
        xp = torch.zeros(2, 4, 8 * h).transpose(0, 1)
    else:
        w = w.to("meta")
    with pytest.raises(err):
        lstm_cuda.lstm_bidirectional(xp, w, h)


# --- the tensor-core product's arithmetic, as plain PyTorch ---

@pytest.mark.parametrize("dist", ["jax_test", "torch_default"])
@pytest.mark.parametrize("t,b,h", SHAPES)
def test_split_tf32_model_is_float32_accurate(t, b, h, dist):
    """lstm_bidirectional_split_plain (the kernel's split-TF32 gate product: W_hi.h_lo +
    W_lo.h_hi + W_hi.h_hi, fp32 accumulation) against a float64 recurrence, held to
    chip_smoke.py phase 7's criterion: no further from it than twice the plain fp32
    version + 1e-6. A single TF32 pass is not (checked beside it)."""
    rng = np.random.RandomState(11)
    if dist == "jax_test":
        xp = rng.normal(0, 1, (t, b, 8 * h))
        w = rng.normal(0, 0.2, (2, 4 * h, h))
    else:  # an inner layer of CaMN: torch-default weights on N(0, 1) input of width 2H
        bound = h ** -0.5
        x = rng.normal(0, 1, (t, b, 2 * h))
        xp = x @ rng.uniform(-bound, bound, (8 * h, 2 * h)).T + \
            rng.uniform(-2 * bound, 2 * bound, 8 * h)
        w = rng.uniform(-bound, bound, (2, 4 * h, h))
    xp, w = torch.from_numpy(xp.astype(np.float32)), torch.from_numpy(w.astype(np.float32))
    exact = lstm_cuda.lstm_bidirectional_plain(xp.double(), w.double(), h)
    plain = lstm_cuda.lstm_bidirectional_plain(xp, w, h)
    split = lstm_cuda.lstm_bidirectional_split_plain(xp, w, h)
    assert split.shape == plain.shape == (t, b, 2 * h) and split.dtype == torch.float32
    plain_err = float((plain.double() - exact).abs().max())
    assert float((split.double() - exact).abs().max()) <= 2 * plain_err + 1e-6
    # the halves are the two directions of the split model, laid out as the plain version's
    fwd = lstm_cuda.lstm_direction_split_plain(xp[..., :4 * h], w[0], h)
    assert torch.equal(split[..., :h], fwd)
    # one TF32 pass (operands rounded once, no lo terms) misses the criterion
    one_pass = lstm_cuda.lstm_bidirectional_plain(
        xp, vq_cuda.split_tf32(w)[0], h) if dist == "jax_test" else None
    if one_pass is not None:
        assert float((one_pass.double() - exact).abs().max()) > 2 * plain_err + 1e-6


def test_split_tf32_model_splits_both_operands():
    """The split leaves at most 2^-22 |x| out; the model's product takes W_hh's lo terms
    (dropping them moves the result) and stays within the kernel test's tolerance of the
    plain version."""
    rng = np.random.RandomState(12)
    xp = torch.from_numpy(rng.normal(0, 1, (6, 3, 4 * 16)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 0.3, (4 * 16, 16)).astype(np.float32))
    w_hi, w_lo = vq_cuda.split_tf32(w)
    assert float(w_lo.abs().max()) > 0
    assert bool(((w.double() - w_hi.double() - w_lo.double()).abs()
                 <= 2.0 ** -22 * w.double().abs()).all())
    got = lstm_cuda.lstm_direction_split_plain(xp, w, 16)
    assert float((got - lstm_cuda.lstm_direction_plain(xp, w, 16)).abs().max()) < ATOL
    assert not torch.equal(lstm_cuda.lstm_direction_split_plain(xp, w_hi, 16), got)
