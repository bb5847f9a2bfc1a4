// Fused LSTM sequence, one direction, for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel pantomatrix_tpu/ops/lstm_pallas.py::_lstm_seq_kernel
// (reached through lstm_sequence_pallas from nn/lstm.py::_lstm_direction_pallas).
// Given xp (T, B, 4H) = x . W_ih^T + b_ih + b_hh and w_t = W_hh^T (H, 4H), it runs the
// recurrence from h = c = 0 in torch's gate order i, f, g, o:
//     gates = xp[t] + h_{t-1} . W_hh^T
//     c_t = sigmoid(f) * c_{t-1} + sigmoid(i) * tanh(g),   h_t = sigmoid(o) * tanh(c_t)
// and writes every h_t to out (T, B, H).
//
// Bound on an H100 SXM: at CaMN/DisCo's T = 421, B = 64, H = 512 one direction is
// 2*T*B*4H*H = 56.5 GFLOP of fp32 FMA work, 0.84 ms at the 67 TFLOP/s fp32 peak,
// against 0.28 GB of traffic (xp and out once, W_hh once), 0.08 ms at 3.35 TB/s:
// bound by operations. But the T steps are sequential, each needing the h of the
// one before, so the latency of one step (a launch, a (B, H) x (H, 4H) product far
// too small to fill the card, the gate math) puts a floor of T times that latency
// under the kernel whatever the rate. At B = 8 that floor, not the arithmetic, is
// the limit.
//
// Design: simple and right, not fast. The host loops over t and launches one step
// kernel per timestep on the caller's stream; stream order puts step t after t-1.
//  * A block owns JT = 32 hidden units (one per lane) and BB = 8 batch rows. Warp w
//    loads row w of h_{t-1} (out[t-1]; nothing at t = 0, where h = 0) into shared
//    memory laid out [k][BB], so a lane later reads its BB values as two 16-byte
//    broadcasts.
//  * The block's KS = 8 warps split the reduction over k. Lane j of warp w keeps, in
//    registers, the 4 gate dot products of unit j for the BB rows over
//    k = w, w + KS, ...; the loads of W_hh^T[k, g*H + j] are coalesced across lanes
//    and unrolled 8 deep, so a block keeps ~32 KB of them in flight: the first
//    version, with 4 warps and half that depth, waited on L2 latency at ~24 us a step.
//  * Every warp leaves its partial sums in shared memory; then warp w finishes batch
//    row b0 + w: it adds the KS partials in a fixed order, adds xp[t] and applies the
//    gates with expf and tanhf (the build uses no fast-math intrinsics).
//  * The cell state lives in c (B, H) in device memory, and only the thread that
//    finishes (b, j) reads and writes c[b, j]. No gates tensor goes to device memory.
//  * W_hh^T (4 MiB at H = 512) is re-read from L2 every step, once per batch tile.
//  * Ragged H and B are masked with bounds checks; nothing is padded.
// A persistent kernel (gate columns split across CTAs with their W_hh slices in
// shared memory, one grid barrier or cluster sync per step) is later work.

#include <cstddef>
#include <cuda_runtime.h>

namespace {

constexpr int JT = 32;  // hidden units per block, one per lane
constexpr int KS = 8;   // warps per block, splitting the reduction over k
constexpr int BB = 8;   // batch rows per block, one finished by each warp
static_assert(KS == BB, "warp w finishes batch row w");

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__global__ void __launch_bounds__(JT * KS)
lstm_step_kernel(const float* __restrict__ xp_t,    // (B, 4H) of step t
                 const float* __restrict__ w_t,     // (H, 4H)
                 const float* __restrict__ h_prev,  // (B, H) of step t-1; null at t = 0
                 float* __restrict__ h_out,         // (B, H) of step t
                 float* __restrict__ c,             // (B, H), updated in place
                 int B, int H) {
  extern __shared__ float4 hs4[];                   // h_{t-1} as [k][BB]
  float* hs = reinterpret_cast<float*>(hs4);
  __shared__ float part[KS][4][BB][JT];             // partial sums of each warp

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int j = blockIdx.x * JT + lane;
  const int b = blockIdx.y * BB + warp;             // the row this warp finishes
  const bool first = h_prev == nullptr;             // uniform across the grid
  const size_t four_h = 4 * static_cast<size_t>(H);

  if (!first) {
    const float* hb = h_prev + static_cast<size_t>(b) * H;
#pragma unroll 4
    for (int k = lane; k < H; k += JT) hs[k * BB + warp] = b < B ? hb[k] : 0.f;
    __syncthreads();

    float acc[4][BB];
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int r = 0; r < BB; ++r) acc[g][r] = 0.f;
    if (j < H) {
#pragma unroll 8
      for (int k = warp; k < H; k += KS) {
        const float* wk = w_t + k * four_h + j;
        const float w[4] = {wk[0], wk[H], wk[2 * H], wk[3 * H]};
        const float4 lo = hs4[k * (BB / 4)];
        const float4 hi = hs4[k * (BB / 4) + 1];
        const float h[BB] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int r = 0; r < BB; ++r) acc[g][r] = fmaf(w[g], h[r], acc[g][r]);
      }
    }
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int r = 0; r < BB; ++r) part[warp][g][r][lane] = acc[g][r];
    __syncthreads();
  }

  if (j >= H || b >= B) return;
  const float* x = xp_t + b * four_h + j;
  float gate[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    float s = 0.f;
    if (!first) {
#pragma unroll
      for (int w = 0; w < KS; ++w) s += part[w][g][warp][lane];
    }
    gate[g] = x[g * H] + s;
  }
  const size_t cj = static_cast<size_t>(b) * H + j;
  const float c_prev = first ? 0.f : c[cj];
  const float c_new = sigmoid(gate[1]) * c_prev + sigmoid(gate[0]) * tanhf(gate[2]);
  c[cj] = c_new;
  h_out[cj] = sigmoid(gate[3]) * tanhf(c_new);
}

}  // namespace

extern "C" {

// xp (T, B, 4H), w_t (H, 4H), out (T, B, H), c_ws (B, H) scratch: float32, row-major,
// on one device. Launches T step kernels on `stream` without synchronising; returns
// the first non-zero cudaGetLastError() (0 = success).
int lstm_sequence(const float* xp, const float* w_t, float* out, float* c_ws, int T, int B,
                  int H, cudaStream_t stream) {
  if (T <= 0 || B <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  // static + dynamic shared memory above 48 KB needs this opt-in (H > 512)
  const size_t dyn = sizeof(float) * BB * static_cast<size_t>(H);
  const cudaError_t set = cudaFuncSetAttribute(
      lstm_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(dyn));
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid((H + JT - 1) / JT, (B + BB - 1) / BB);
  const dim3 block(JT, KS);
  const size_t step_in = static_cast<size_t>(B) * 4 * H;
  const size_t step_out = static_cast<size_t>(B) * H;
  for (int t = 0; t < T; ++t) {
    lstm_step_kernel<<<grid, block, dyn, stream>>>(
        xp + t * step_in, w_t, t == 0 ? nullptr : out + (t - 1) * step_out,
        out + t * step_out, c_ws, B, H);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaSuccess);
}

const char* lstm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
