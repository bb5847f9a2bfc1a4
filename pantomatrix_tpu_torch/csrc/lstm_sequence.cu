// A whole LSTM layer, one or both directions, in one persistent kernel for Hopper
// (sm_90a), fp32.
//
// Replaces the TPU kernel pantomatrix_tpu/ops/lstm_pallas.py::_lstm_seq_kernel
// (reached through lstm_sequence_pallas from nn/lstm.py::_lstm_direction_pallas).
// Given xp (T, B, D*4H), direction d's input projection x . W_ih_d^T + b_ih_d + b_hh_d
// in columns [d*4H, (d+1)*4H) of the unflipped sequence, and w (D, 4H, H) = W_hh of
// each direction in torch layout, it runs the recurrence from h = c = 0 in torch's gate
// order i, f, g, o:
//     gates = xp_d[t] + h_{t-1} . W_hh_d^T
//     c_t = sigmoid(f) * c_{t-1} + sigmoid(i) * tanh(g),   h_t = sigmoid(o) * tanh(c_t)
// and writes h_t to out (T, B, D*H), columns [d*H, (d+1)*H). Direction 1 (D = 2) is the
// reverse one: its step s reads xp[T-1-s] and writes out[T-1-s], so out is exactly
// cat([forward, reverse.flip(0)], -1) and nothing is ever flipped or concatenated.
//
// Bound on an H100 SXM: at CaMN/DisCo's T = 421, B = 64, H = 512 a bidirectional layer is
// D*2*T*B*4H*H = 113 GFLOP of fp32 FMA work, 1.69 ms at the 67 TFLOP/s fp32 peak, against
// 0.56 GB of traffic (xp and out once, W_hh once), 0.17 ms at 3.35 TB/s: bound by
// operations. The T steps are sequential, though, and at B = 8 the work of one step
// (8 x 512 x 2048 FMAs per direction) is far too small to fill the card, so there the
// per-step latency (a grid-wide hand-off of h_{t-1}) is the limit.
//
// Design: one cooperative launch per layer; no host loop over timesteps.
//  * The grid is (unit group, batch group, direction). A CTA owns U hidden units of one
//    direction, all four gates of each (4U rows of W_hh), for BR batch rows. The plan
//    (U, BT, BR, whether W stays resident) comes from ops/lstm_cuda.py::plan_layer, which
//    keeps the CTAs at most one per SM so that all of them are co-resident;
//    cudaLaunchCooperativeKernel refuses the launch (rather than deadlocking) if not.
//  * W_hh's slice (4U x H) is loaded into shared memory once and stays there for all T
//    steps. Where the layer's W_hh does not fit the card's shared memory (H = 1024 in
//    both directions is 32 MiB), the plan turns residency off and the product reads
//    W_hh from L2 instead: slower, but every shape up to that is served.
//  * The cell state c of the CTA's (BR, U) cells lives in shared memory for the whole
//    sequence and never goes to device memory.
//  * out is the exchange buffer: step t of a CTA reads h_{t-1} of its rows (all H units,
//    written by the other CTAs of its batch group) from out[t-1] through L2 only, never
//    the non-coherent L1 (cp.async.cg, all of a tile's loads in flight at once; __ldcg
//    where H % 4 != 0), in tiles of BT rows. Every element of out is written once, so no
//    step can overwrite what another still reads.
//  * The per-step barrier is one int32 counter per (direction, batch group), zeroed by
//    the caller: a CTA waits (one thread spins on an acquire load) until its counter
//    reaches s * (unit groups), and after writing h_s (a CTA barrier) one thread adds 1
//    with release semantics. Counters only grow; batch groups never wait on each other.
//    A wait longer than about 17 s traps, so a fault ends the launch with an error
//    instead of a hang.
//  * The gate product (BT rows x 4U gates, over H) is split over 256 threads: a thread
//    takes the 4 gates of UT units for RT batch rows, a 4UT x RT register tile fed by
//    float4 loads of W and h along k. A 16-byte shared-memory load of a warp takes at
//    least 4 of the SM's 1-per-clock wavefronts (one per quarter warp), and on the card
//    the product's time follows that count plus the FMAs, so the larger the tile, the
//    more FMAs each load feeds: RT = 8 (4 where BT = 4) and UT = 2 where BT = 32 (each
//    load then feeds 32 FMAs), else 1, since a larger K_SPLIT costs more shuffles than
//    the loads it saves at small tiles (measured). The K_SPLIT = 256 / ((U / UT) *
//    (BT / RT)) <= 32 neighbouring lanes of one tile take every K_SPLIT-th chunk of k and
//    add their sums with a reduce-scatter of warp shuffles. Rows of W and h are stored
//    as float4 chunks XOR-swizzled by row, so the 8 lanes of a quarter warp read 8
//    different bank groups.
//  * The h tile is loaded in two cp.async groups, chunks [0, HC/2) and [HC/2, HC), and
//    the product starts on the first half while the second is in flight.
//  * Every sum is taken in a fixed order (chunk by chunk, x y z w within a chunk, then a
//    fixed shuffle tree): no atomics on values, so two calls give bitwise equal results.
//    The gates use expf and tanhf; the build uses no fast-math intrinsics.
//  * xp of the next tile (the next step's first tile, when a CTA has one) is prefetched
//    with cp.async into the other half of a double buffer while the current one runs.
//  * Ragged H and B are masked with bounds checks; device memory is not padded.

#include <cstddef>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr long long kSpinLimit = 1LL << 35;  // clock cycles, about 17 s at 1.98 GHz

struct Layer {
  const float* xp;  // (T, B, D*4H)
  const float* w;   // (D, 4H, H)
  float* out;       // (T, B, D*H)
  int* counters;    // (D, batch groups), zero at launch
  int T, B, H, D;
  int U, BT, BR;    // units per CTA, rows per tile, rows per CTA
  int NJ, HC;       // unit groups; float4 chunks per row of H, padded to a multiple of 8
};

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// chunk c of row r is stored at chunk c ^ (r % 8) of that row
__device__ __forceinline__ int swz(int r, int c) { return c ^ (r & 7); }

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's newest cp.async groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes from device memory through L2 only (.cg: never a stale L1 line); the bytes
// past `src_bytes` are zero-filled
__device__ __forceinline__ void cp_async16_zfill(float4* dst, const float* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void red_release_add(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// 4 consecutive floats of a row from device memory, zero past `n`
__device__ __forceinline__ float4 load4(const float* src, int k, int n, bool aligned,
                                        bool cg) {
  if (aligned && k + 3 < n)
    return cg ? __ldcg(reinterpret_cast<const float4*>(src)) :
                __ldg(reinterpret_cast<const float4*>(src));
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = k + i < n ? (cg ? __ldcg(src + i) : __ldg(src + i)) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float dot4(float acc, float4 a, float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// One round of the reduce-scatter of V sums over the K_SPLIT lanes of a tile (lane bits
// 0 .. log2 K_SPLIT - 1): at distance m = 2^ROUND a lane keeps one half of its sums
// plus its partner's copy of that half; once one sum is left, both partners add. Every
// index into v is a constant and no value is picked by a select of two elements of v,
// so v stays in registers.
template <int V, int ROUND>
__device__ __forceinline__ void scatter_round(float (&v)[V], int ks, int n_split, int& first,
                                              int& kept) {
  constexpr int m = 1 << ROUND, half = V >> (ROUND + 1);
  if (m >= n_split) return;
  const bool upper = (ks & m) != 0;
  if constexpr (half >= 1) {
#pragma unroll
    for (int j = 0; j < half; ++j) {
      const float lo = v[j], hi = v[j + half];
      const float lo_in = __shfl_xor_sync(0xffffffffu, lo, m);
      const float hi_in = __shfl_xor_sync(0xffffffffu, hi, m);
      v[j] = upper ? hi + hi_in : lo + lo_in;
    }
    if (upper) first += half;
    kept = half;
  } else {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], m);
    if (upper) kept = 0;  // its partner writes the sum
  }
}

#ifdef LSTM_PHASE_CLOCKS
// Built with -DLSTM_PHASE_CLOCKS (scripts/torch_profile_k2_phases.py), thread 0 of CTA
// (0, 0, 0) sums the clock cycles of each phase of its steps: the barrier wait, the h
// tile's arrival, the gate product, the gates; then the whole launch in cycles and in
// globaltimer nanoseconds. The default build has none of this.
__device__ long long g_phase_clocks[6];
#define PHASE_MARK(k)                                        \
  do {                                                       \
    if (clocked) {                                           \
      const long long now = clock64();                       \
      phase[k] += now - mark;                                \
      mark = now;                                            \
    }                                                        \
  } while (0)
#else
#define PHASE_MARK(k) \
  do {                \
  } while (0)
#endif

template <bool RESIDENT, int RT, int UT>
__global__ void __launch_bounds__(THREADS, 1) lstm_layer_kernel(const Layer p) {
  // sums a thread holds: index (q * UT + e) * 4 + g for row q, unit e, gate g
  constexpr int V = 4 * UT * RT;
  extern __shared__ float4 smem4[];
  const int U = p.U, R = 4 * U, BT = p.BT, HC = p.HC, H = p.H, B = p.B, T = p.T;
  const int four_h = 4 * H, xp_row = p.D * four_h, out_row = p.D * H;
  const int j0 = blockIdx.x * U;
  const int d = blockIdx.z;
  const bool reverse = d == 1;
  const int row0 = blockIdx.y * p.BR;
  const int row_end = min(B, row0 + p.BR);
  const int ntile = (row_end - row0 + BT - 1) / BT;
  const bool aligned = (H & 3) == 0;  // float4 loads of h and W along k
  const float* w = p.w + static_cast<size_t>(d) * four_h * H;
  int* counter = p.counters + d * gridDim.y + blockIdx.y;

  float4* ws = smem4;                                  // [R][HC], swizzled (if RESIDENT)
  float4* hs = ws + (RESIDENT ? R * HC : 0);           // [BT][HC], swizzled
  float* part = reinterpret_cast<float*>(hs + BT * HC);  // [BT][R], the gate products
  float* xs = part + BT * R;                           // [2][BT][R]
  float* cs = xs + 2 * BT * R;                         // [BR][U]

  const int tid = threadIdx.x;
  const int nbt = BT / RT, nut = U / UT;
  const int n_split = THREADS / (nut * nbt);  // K_SPLIT, a power of two <= 32
  const int ks = tid % n_split;               // its chunks of k: ks, ks + K_SPLIT, ...
  const int u0 = (tid / n_split) % nut * UT;  // its units u0 .. u0 + UT - 1, 4 gates each
  const int bt = tid / (n_split * nut);       // its rows: bt, bt + nbt, bt + 2 nbt, ...
  const int half_hc = HC / 2;

  if (RESIDENT) {
    for (int idx = tid; idx < R * HC; idx += THREADS) {
      const int r = idx / HC, c = idx % HC, j = j0 + r % U;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j < H) {
        const float* src = w + static_cast<size_t>((r / U) * H + j) * H + 4 * c;
        float e[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) e[i] = 4 * c + i < H ? src[i] : 0.f;
        v = make_float4(e[0], e[1], e[2], e[3]);
      }
      ws[r * HC + swz(r, c)] = v;
    }
  }
  for (int idx = tid; idx < p.BR * U; idx += THREADS) cs[idx] = 0.f;

  // work item n = step s, tile i (n = s * ntile + i); its xp goes to half n % 2 of xs
  auto prefetch = [&](int n) {
    if (n < T * ntile) {
      const int s = n / ntile;
      const int t = reverse ? T - 1 - s : s;
      const int tb = row0 + (n % ntile) * BT;
      float* dst = xs + (n & 1) * BT * R;
      for (int idx = tid; idx < BT * R; idx += THREADS) {
        const int bl = idx / R, r = idx % R, j = j0 + r % U, b = tb + bl;
        if (b < row_end && j < H)
          cp_async4(dst + idx, p.xp + (static_cast<size_t>(t) * B + b) * xp_row +
                                   d * four_h + (r / U) * H + j);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count uniform
  };

  prefetch(0);
#ifdef LSTM_PHASE_CLOCKS
  const bool clocked = tid == 0 && blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0;
  long long phase[4] = {0, 0, 0, 0};
  long long mark = clock64();
  const long long clock0 = mark;
  unsigned long long ns0;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns0));
#endif
  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const int t_prev = reverse ? t + 1 : t - 1;
    if (s > 0) {  // wait until every unit group of this batch group has written h_{t_prev}
      if (tid == 0) {
        const int target = s * p.NJ;
        const long long start = clock64();
        while (load_acquire(counter) < target) {
          // a CTA that never arrives is a fault: end the launch with an error, not a hang
          if (clock64() - start > kSpinLimit) __trap();
        }
      }
      __syncthreads();
    }
    PHASE_MARK(0);
    for (int i = 0; i < ntile; ++i) {
      const int n = s * ntile + i;
      const int tb = row0 + i * BT;
      // h_{t_prev} of the tile's rows, all in flight at once where aligned, in two groups
      // (chunks [0, HC/2) and [HC/2, HC)) so the product starts on the first half
      for (int part_k = 0; part_k < 2; ++part_k) {
        for (int idx = tid; s > 0 && idx < BT * half_hc; idx += THREADS) {
          const int bl = idx / half_hc, c = part_k * half_hc + idx % half_hc, b = tb + bl;
          const float* src =
              p.out + (static_cast<size_t>(t_prev) * B + b) * out_row + d * H + 4 * c;
          float4* dst = hs + bl * HC + swz(bl, c);
          if (aligned) {
            cp_async16_zfill(dst, b < row_end && 4 * c < H ? src : p.out,
                             b < row_end && 4 * c < H ? 16 : 0);
          } else {
            *dst = b < row_end ? load4(src, 4 * c, H, false, true) :
                                 make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
        cp_async_commit();
      }
      prefetch(n + 1);
      cp_async_wait<2>();  // this item's xp and the first half of h have landed
      __syncthreads();
      PHASE_MARK(1);
      if (s > 0) {
        float v[V];
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] = 0.f;
        int c = ks;
#pragma unroll 1
        for (int part_k = 0; part_k < 2; ++part_k) {
          if (part_k == 1) {
            cp_async_wait<1>();  // the second half of h
            __syncthreads();
          }
          for (; c < (part_k + 1) * half_hc; c += n_split) {
            float4 wv[UT][4];
#pragma unroll
            for (int e = 0; e < UT; ++e)
#pragma unroll
              for (int g = 0; g < 4; ++g) {
                const int r = g * U + u0 + e;
                if (RESIDENT)
                  wv[e][g] = ws[r * HC + swz(r, c)];
                else
                  wv[e][g] = j0 + u0 + e < H ?
                      load4(w + (static_cast<size_t>(g) * H + j0 + u0 + e) * H + 4 * c, 4 * c,
                            H, aligned, false) :
                      make_float4(0.f, 0.f, 0.f, 0.f);
              }
#pragma unroll
            for (int q = 0; q < RT; ++q) {
              const int bl = bt + q * nbt;
              const float4 hv = hs[bl * HC + swz(bl, c)];
#pragma unroll
              for (int e = 0; e < UT; ++e)
#pragma unroll
                for (int g = 0; g < 4; ++g) {
                  float& acc = v[(q * UT + e) * 4 + g];
                  acc = dot4(acc, wv[e][g], hv);
                }
            }
          }
        }
        int first = 0, kept = V;  // this lane's sums, as a range of indices into v
        scatter_round<V, 0>(v, ks, n_split, first, kept);
        scatter_round<V, 1>(v, ks, n_split, first, kept);
        scatter_round<V, 2>(v, ks, n_split, first, kept);
        scatter_round<V, 3>(v, ks, n_split, first, kept);
        scatter_round<V, 4>(v, ks, n_split, first, kept);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          if (j < kept) {
            const int idx = first + j, q = idx / (4 * UT), e = idx / 4 % UT, g = idx % 4;
            part[(bt + q * nbt) * R + g * U + u0 + e] = v[j];
          }
        }
      }
      __syncthreads();
      PHASE_MARK(2);

      const float* x = xs + (n & 1) * BT * R;
      for (int e = tid; e < BT * U; e += THREADS) {
        const int bl = e / U, uu = e % U, b = tb + bl, j = j0 + uu;
        if (b >= row_end || j >= H) continue;
        float gate[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          gate[g] = x[bl * R + g * U + uu] + (s > 0 ? part[bl * R + g * U + uu] : 0.f);
        }
        float& c = cs[(b - row0) * U + uu];
        const float c_new = sigmoid(gate[1]) * c + sigmoid(gate[0]) * tanhf(gate[2]);
        c = c_new;
        p.out[(static_cast<size_t>(t) * B + b) * out_row + d * H + j] =
            sigmoid(gate[3]) * tanhf(c_new);
      }
      __syncthreads();  // hs, part and this half of xs are free again; h_t is written
      PHASE_MARK(3);
    }
    // the CTA barrier above orders every h_t of this CTA before the release
    if (tid == 0) red_release_add(counter, 1);
  }
#ifdef LSTM_PHASE_CLOCKS
  if (clocked) {
    unsigned long long ns1;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns1));
    for (int k = 0; k < 4; ++k) g_phase_clocks[k] = phase[k];
    g_phase_clocks[4] = clock64() - clock0;
    g_phase_clocks[5] = static_cast<long long>(ns1 - ns0);
  }
#endif
}

size_t smem_bytes(int H, int U, int BT, int BR, bool resident) {
  const size_t hc = static_cast<size_t>(((H + 3) / 4 + 7) / 8 * 8);
  const size_t r = 4 * static_cast<size_t>(U);
  return 16 * ((resident ? r * hc : 0) + BT * hc) +
         4 * (3 * BT * r + static_cast<size_t>(BR) * U);
}

// rows and units of a thread's register tile for a tile of BT rows
int tile_rows_per_thread(int BT) { return BT >= 8 ? 8 : 4; }
int tile_units_per_thread(int BT) { return BT >= 32 ? 2 : 1; }

template <int RT, int UT>
const void* kernel_for(bool resident) {
  return resident ? reinterpret_cast<const void*>(lstm_layer_kernel<true, RT, UT>)
                  : reinterpret_cast<const void*>(lstm_layer_kernel<false, RT, UT>);
}

}  // namespace

extern "C" {

// The current device's SM count and opt-in shared memory per block; returns the error.
int lstm_device_limits(int* num_sms, int* smem_per_block) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(num_sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(smem_per_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<int>(e);
}

// One LSTM layer of D directions (see the note at the top). xp (T, B, D*4H), w (D, 4H, H),
// out (T, B, D*H): float32, row-major, contiguous, on the current device; counters:
// D * ceil(B / BR) zeroed int32. The plan (U, BT, BR, resident) must keep every CTA
// co-resident; BT is 4, 8, 16 or 32, and (U / UT) * (BT / RT) must divide 256 into at
// most 32 (RT = 8 rows, 4 where BT = 4; UT = 2 units where BT = 32, else 1); the shared
// memory it takes is smem_bytes(), which ops/lstm_cuda.py mirrors. Launches one
// cooperative kernel on `stream` without synchronising and returns its error (0 =
// success; cudaErrorCooperativeLaunchTooLarge when the grid cannot be co-resident, e.g.
// on a shared card).
int lstm_layer(const float* xp, const float* w, float* out, int* counters, int T, int B,
               int H, int D, int U, int BT, int BR, int resident, cudaStream_t stream) {
  if (T <= 0 || B <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  const int rt = tile_rows_per_thread(BT), ut = tile_units_per_thread(BT);
  const int tiles = U % ut == 0 && BT % rt == 0 ? U / ut * (BT / rt) : 0;
  const int split = tiles > 0 && THREADS % tiles == 0 ? THREADS / tiles : 0;
  if (D < 1 || D > 2 || BR < 1 || split < 1 || split > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  Layer p{xp, w, out, counters, T, B, H, D, U, BT, BR, (H + U - 1) / U,
          ((H + 3) / 4 + 7) / 8 * 8};
  const size_t smem = smem_bytes(H, U, BT, BR, resident != 0);
  const void* fn = ut == 2 ? kernel_for<8, 2>(resident != 0)
                 : rt == 8 ? kernel_for<8, 1>(resident != 0) : kernel_for<4, 1>(resident != 0);
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(p.NJ, (B + BR - 1) / BR, D);
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(fn, grid, dim3(THREADS), args, smem, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

#ifdef LSTM_PHASE_CLOCKS
// The phase clocks of the last launch (see g_phase_clocks); returns the error.
int lstm_phase_clocks(long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_phase_clocks, sizeof(g_phase_clocks)));
}
#endif

const char* lstm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
