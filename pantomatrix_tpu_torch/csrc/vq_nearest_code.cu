// VQ nearest-code search for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel pantomatrix_tpu/ops/vq_pallas.py::_vq_argmin_kernel
// (reached through nearest_code_fast from models/emage_vq.py::vqvae_decode_latent).
// For z (N, D) and a codebook (K, D) it writes, per row, the int32
//     argmin_k ( ||e_k||^2 - 2 z . e_k )
// ||z||^2 is constant per row and dropped, as in the TPU kernel; ties go to the
// lowest k, as in jnp.argmin and torch.argmin.
//
// Bound on an H100 SXM: at the final decode of the benchmark shape (N = 128*1800,
// D = K = 256) the search is 2*N*D*K = 30.2 GFLOP of fp32 FMA work (no tensor cores:
// TF32 would break index parity), 0.45 ms at the 67 TFLOP/s fp32 peak, against
// 237 MB of traffic (z read once, 236 MB; the 256 KiB codebook; the indices),
// 0.07 ms at 3.35 TB/s. About 127 FLOP per byte against a ridge of 20: the kernel is
// bound by operations, not bytes.
//
// Design: this first version is simple and exact, not fast.
//  * A block owns BM = 64 rows. The fp32 256x256 codebook (256 KiB) exceeds a
//    block's 227 KB of shared memory, so codes stream through shared memory in
//    K-tiles of BK = 64, and the depth D in chunks of BD = 32; the z rows of the
//    current chunk sit beside them: 16.75 KB of static shared memory, so no opt-in
//    above 48 KB is needed (ptxas: 64 registers, no spills).
//  * 256 threads as 16 x 16: thread (ty, tx) keeps a 4 x 4 register tile of dot
//    products, rows ty + 16 i and codes tx + 16 j, so each pair of shared-memory
//    reads feeds 2 FMAs. Rows padded to BD + 1 floats keep the reads free of bank
//    conflicts.
//  * ||e||^2 is accumulated by threads 0..BK-1 during the same D loop.
//  * Each thread keeps a running (min, argmin) per row, comparing with strict <
//    in ascending k; the 16 threads that share a row reduce with shuffles under
//    (v < best) || (v == best && k < best_k), so ties still go to the lowest k.
//  * Any N, D, K: ragged edges are masked (zero-filled loads, codes k >= K never
//    compared), nothing is padded in device memory.
//  * fp32 FMA throughout. Making it fast (wgmma with a split-precision product,
//    TMA, a persistent grid) is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;       // rows per block
constexpr int BK = 64;       // codes per K-tile
constexpr int BD = 32;       // depth per chunk
constexpr int THREADS = 256; // 16 x 16
constexpr int RM = BM / 16;  // rows per thread
constexpr int RK = BK / 16;  // codes per thread per tile

__global__ void __launch_bounds__(THREADS)
vq_nearest_code_kernel(const float* __restrict__ z, const float* __restrict__ cb,
                       int32_t* __restrict__ out, int n, int d, int k) {
  __shared__ float zs[BM][BD + 1];
  __shared__ float cs[BK][BD + 1];
  __shared__ float esq_s[BK];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long row0 = static_cast<long long>(blockIdx.x) * BM;

  float best[RM];
  int best_k[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    best[i] = __int_as_float(0x7f800000);  // +inf
    best_k[i] = 0;
  }

  for (int k0 = 0; k0 < k; k0 += BK) {
    float acc[RM][RK];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) acc[i][j] = 0.f;
    float esq = 0.f;  // ||e_{k0 + tid}||^2, for tid < BK

    for (int d0 = 0; d0 < d; d0 += BD) {
      for (int e = tid; e < BM * BD; e += THREADS) {
        const int r = e / BD, c = e % BD;
        const long long gr = row0 + r;
        const int gc = d0 + c;
        zs[r][c] = (gr < n && gc < d) ? z[gr * d + gc] : 0.f;
      }
      for (int e = tid; e < BK * BD; e += THREADS) {
        const int r = e / BD, c = e % BD;
        const int gk = k0 + r;
        const int gc = d0 + c;
        cs[r][c] = (gk < k && gc < d) ? cb[static_cast<long long>(gk) * d + gc] : 0.f;
      }
      __syncthreads();

      if (tid < BK) {
#pragma unroll 8
        for (int c = 0; c < BD; ++c) esq = fmaf(cs[tid][c], cs[tid][c], esq);
      }
#pragma unroll 8
      for (int c = 0; c < BD; ++c) {
        float a[RM], b[RK];
#pragma unroll
        for (int i = 0; i < RM; ++i) a[i] = zs[ty + 16 * i][c];
#pragma unroll
        for (int j = 0; j < RK; ++j) b[j] = cs[tx + 16 * j][c];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RK; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

    if (tid < BK) esq_s[tid] = esq;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < RK; ++j) {  // ascending k within this thread
      const int kk = k0 + tx + 16 * j;
      if (kk < k) {
        const float e = esq_s[tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float v = fmaf(-2.f, acc[i][j], e);
          if (v < best[i]) {
            best[i] = v;
            best_k[i] = kk;
          }
        }
      }
    }
    __syncthreads();  // esq_s is rewritten by the next tile
  }

  // The 16 threads of a row group are one half-warp (lane = (ty % 2) * 16 + tx):
  // xor offsets 8..1 stay inside it.
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    float v = best[i];
    int bk = best_k[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int ok = __shfl_xor_sync(0xffffffffu, bk, off);
      if (ov < v || (ov == v && ok < bk)) {
        v = ov;
        bk = ok;
      }
    }
    const long long gr = row0 + ty + 16 * i;
    if (tx == 0 && gr < n) out[gr] = bk;
  }
}

}  // namespace

extern "C" {

// z (n, d), cb (k, d) float32 row-major; out (n,) int32. Launches on `stream` and
// returns cudaGetLastError() right after the launch (0 = success).
int vq_nearest_code(const float* z, const float* cb, int32_t* out, int n, int d, int k,
                    cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((n + BM - 1) / BM);
  vq_nearest_code_kernel<<<grid, THREADS, 0, stream>>>(z, cb, out, n, d, k);
  return static_cast<int>(cudaGetLastError());
}

const char* vq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
