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
//    (U, BT, BR, whether W stays resident, which gate product) comes from
//    ops/lstm_cuda.py::plan_layer, which keeps the CTAs at most one per SM so that all of
//    them are co-resident; cudaLaunchCooperativeKernel refuses the launch (rather than
//    deadlocking) if not.
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
//  * The gate product (BT rows x 4U gates, over H) takes one of two forms, which the
//    plan picks by shape (LayerPlan.product); both write the tile's sums to `part`.
//  * "ffma", on the fp32 pipe, split over 256 threads: a thread takes the 4 gates of UT
//    units for RT batch rows, a 4UT x RT register tile fed by float4 loads of W and h
//    along k. A 16-byte shared-memory load of a warp takes at least 4 of the SM's
//    1-per-clock wavefronts (one per quarter warp), and on the card the product's time
//    follows that count plus the FMAs, so the larger the tile, the more FMAs each load
//    feeds: RT = 8 (4 where BT = 4) and UT = 2 where BT = 32 (each load then feeds 32
//    FMAs), else 1, since a larger K_SPLIT costs more shuffles than the loads it saves at
//    small tiles (measured). The K_SPLIT = 256 / ((U / UT) * (BT / RT)) <= 32
//    neighbouring lanes of one tile take every K_SPLIT-th chunk of k and add their sums
//    with a reduce-scatter of warp shuffles. Rows of W and h are stored as float4 chunks
//    XOR-swizzled by row (c ^ (r % 8)), so the 8 lanes of a quarter warp read 8
//    different bank groups.
//  * "mma", on the tensor cores in split TF32, float32-accurate: mma.sync m16n8k8 .tf32
//    with the gates as M (U = 16: MT = 4 tiles of 16 rows of W, row-major), the tile's
//    batch rows as N (NT = BT / 8 tiles of 8 rows of h, k contiguous) and H as K. Each fp32
//    operand is split in registers as its fragment loads, x = hi + lo with hi = tf32(x)
//    and lo = tf32(x - hi) (round to nearest, ties away, as cvt.rna.tf32.f32; ops/
//    vq_cuda.split_tf32), |x - hi - lo| <= 2^-22 |x|, and each m16n8 tile accumulates
//    W_hi.h_lo + W_lo.h_hi + W_hi.h_hi in fp32, a 16-wide k block at a time on the
//    tensor core, the blocks' sums in fp32 registers (see mma_blocks). The 8 warps
//    split K: warp w takes the 16-wide k blocks w, w + 8, ... of each half of H, all
//    MT x NT tiles, so every element of W and h is loaded and split once a step. A
//    thread's float4 of a row (k = 16 kb + 4 (lane % 4) + 0..3) feeds two k8 steps, k
//    slots lane % 4 and lane % 4 + 4 taking its elements 0, 1 and then 2, 3 (the same
//    permutation of k in A and B, so the product is unchanged). Rows of W are swizzled
//    c ^ 4 (r % 2), so that the two rows of a quarter warp read different halves of the 8
//    bank groups (h: see the TMA copy below). The warps' partial sums then go, in a fixed
//    order, through shared memory over the h tile (the region is widened where 8 x BT x
//    4U floats exceed the tile) and are summed, warp 0 to 7, into `part`. The split keeps the kernel within
//    chip_smoke.py phase 7's float64 criterion (the error against a float64 run at most
//    twice the plain fp32 version's + 1e-6), which a single TF32 pass would not meet.
//    The plan takes it from BT = 16 (B >= 32 at H = 512 for both directions). At B = 1
//    and 8 the tile has 4 rows, half of a padded 8-row tile would be waste, the barrier
//    and the h tile's arrival set the pace, and the FFMA product stays; 8-row tiles were
//    faster in split TF32 but missed phase 7's atol 1e-5 at one test shape, so they stay
//    FFMA too (ops/lstm_cuda.plan_layer, which also keeps FFMA for non-resident plans and
//    for U != 16; PERF.md has the measurements). The wrapper
//    counts the launches that take it in ops/lstm_cuda.mma_launches. mma.sync's TF32
//    rate, about half of wgmma's, sets the product's time (-DLSTM_ONE_TF32_PASS shows
//    it); a wgmma form, W's fragments in registers (W and the h tile's halves do not fit
//    shared memory together), waits on each k chunk before its registers are free and
//    measured slower.
//  * The h tile arrives in two halves, chunks [0, HC/2) and [HC/2, HC), and the product
//    starts on the first half while the second is in flight. For the FFMA product each
//    half is a cp.async group of 16-byte copies (BT x HC/2 of them).
//  * For the tensor-core product (which needs H % 64 == 0) each half is one 3-D TMA copy
//    (a tensor map over out: 32 floats, rows (t, b), 32-float segments of the D*H
//    columns, in the 128-byte swizzle) that reports its bytes to that half's mbarrier.
//    At (421, 64, 512) 4,096 cp.async a step took 3.4 us to land the tile and the two
//    copies take 1.7 (PERF.md). Thread-block clusters that multicast the copy, so
//    that each cluster reads the tile from L2 once, landed it no sooner (measured): the
//    count of copies set the pace, not the L2 read. The tile is [segment][BT rows][32
//    floats], each 128-byte row swizzled by (row % 8); mma column g of an 8-row tile reads
//    row perm(g) = g / 2 + 4 (g % 2), so the two rows a quarter warp reads sit in opposite
//    halves of the bank groups, and the warps' partial sums go to that row. Each output's
//    sum is the same, over the same values in the same order, as with any layout of the
//    tile. Rows past row_end (a ragged tile) arrive with whatever out holds there, or zeros
//    past its end; they feed only products that are never read. A copy overwrites the h
//    region, which also holds the warps' partial sums: it is issued by thread 0 after the
//    CTA barrier that ends the previous tile and, at a step's first tile, after the
//    counter's acquire; its proxy fence then orders the generic accesses (every CTA's h_t
//    stores, ordered before the counter's release, and this CTA's reads and partial sums in
//    the h region) before the async proxy's copies.
//  * Every sum is taken in a fixed order (ffma: chunk by chunk, x y z w within a chunk,
//    then a fixed shuffle tree; mma: the tensor cores' k steps in a fixed sequence, then
//    the warps' partials 0 to 7): no atomics on values, so two calls give bitwise equal
//    results. The gates use expf and tanhf; the build uses no fast-math intrinsics.
//  * xp of the next tile (the next step's first tile, when a CTA has one) is prefetched
//    with cp.async into the other half of a double buffer while the current one runs.
//  * Ragged H and B are masked with bounds checks; device memory is not padded.

#include <cstddef>
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
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

// chunk c of row r is stored at chunk c ^ (r % 8) of that row for the FFMA product, at
// chunk c ^ 4 (r % 2) for the tensor-core one (HC is a multiple of 8, so both stay in
// the row)
template <bool MMA>
__device__ __forceinline__ int swz(int r, int c) { return MMA ? c ^ ((r & 1) << 2) : c ^ (r & 7); }

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

// --- the tensor-core product's h tile: mbarrier and TMA primitives ---
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// orders this thread's generic-proxy accesses (global and shared) before the async-proxy
// accesses that follow it in causality order, and the other way round
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// wait for the completion of the barrier's phase of this parity; a wait longer than
// kSpinLimit traps, as the counter's does
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - start > kSpinLimit) __trap();
  }
}
// the box of the 3-D tensor map at (c0, c1, c2) to `dst`, completing on the mbarrier `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
        "r"(smem_u32(bar)) : "memory");
}

// the row of an 8-row tile that mma column g reads (see the note at the top)
__device__ __forceinline__ int mma_row(int g) { return (g >> 1) | ((g & 1) << 2); }

// the float4 of tile row bl, chunk c (of HC) in the TMA's layout: segment c / 8 holds BT
// rows of 128 bytes, chunk c % 8 of row bl at (c % 8) ^ (bl % 8)
__device__ __forceinline__ int tma_hs(int BT, int bl, int c) {
  return ((c >> 3) * BT + bl) * 8 + ((c & 7) ^ (bl & 7));
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

// x rounded to TF32 as cvt.rna.tf32.f32 does (to nearest, ties away from zero), in two
// integer operations (as csrc/vq_nearest_code.cu)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo + O(2^-22 |x|), both TF32 (low 13 mantissa bits zero)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d (16 x 8, fp32) += a (16 x 8, tf32, row-major) . b (8 x 8, tf32)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The tensor-core gate product of this warp over the 16-wide k blocks kb0 + warp,
// kb0 + warp + WARPS, ... below kb1 (see the note at the top): acc[mt][nt] is the m16n8
// tile of gate rows 16 mt .. 16 mt + 15 (ws) and batch rows 8 nt .. 8 nt + 7 (hs). Each
// block's 6 products of a tile (2 k8 steps x 3) accumulate from zero on the tensor core
// and the block's sum is then added to acc in fp32 (round to nearest), so that the
// tensor core's own accumulation, which is not rounded to nearest, never adds into the
// running sum. Built with -DLSTM_ONE_TF32_PASS (a profiling aid, wrong in the last bits)
// it issues the hi . hi products alone. hs is in the TMA's layout and column g reads row
// mma_row(g) (see the note at the top).
template <int MT, int NT>
__device__ __forceinline__ void mma_blocks(const float4* ws, const float4* hs, int HC, int kb0,
                                           int kb1, int warp, int lane,
                                           float (&acc)[MT][NT][4]) {
  const int g = lane >> 2, q = lane & 3;
  for (int kb = kb0 + warp; kb < kb1; kb += WARPS) {
    const int c = 4 * kb + q;
    uint32_t bhi[2][NT][2], blo[2][NT][2];  // [k8 step][n tile][slot q, q + 4]
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float4 v = hs[tma_hs(8 * NT, 8 * nt + mma_row(g), c)];
      split_tf32(v.x, bhi[0][nt][0], blo[0][nt][0]);  // k slots q and q + 4 of step 0 take
      split_tf32(v.y, bhi[0][nt][1], blo[0][nt][1]);  // elements 0 and 1, of step 1 2 and 3
      split_tf32(v.z, bhi[1][nt][0], blo[1][nt][0]);
      split_tf32(v.w, bhi[1][nt][1], blo[1][nt][1]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r = 16 * mt + g;
      const float4 v0 = ws[r * HC + swz<true>(r, c)];
      const float4 v8 = ws[(r + 8) * HC + swz<true>(r + 8, c)];
      uint32_t ahi[2][4], alo[2][4];  // [k8 step][rows g, g + 8 at slot q, then at q + 4]
      split_tf32(v0.x, ahi[0][0], alo[0][0]);
      split_tf32(v8.x, ahi[0][1], alo[0][1]);
      split_tf32(v0.y, ahi[0][2], alo[0][2]);
      split_tf32(v8.y, ahi[0][3], alo[0][3]);
      split_tf32(v0.z, ahi[1][0], alo[1][0]);
      split_tf32(v8.z, ahi[1][1], alo[1][1]);
      split_tf32(v0.w, ahi[1][2], alo[1][2]);
      split_tf32(v8.w, ahi[1][3], alo[1][3]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
#ifndef LSTM_ONE_TF32_PASS
          mma_tf32(d, ahi[kk], blo[kk][nt]);
          mma_tf32(d, alo[kk], bhi[kk][nt]);
#endif
          mma_tf32(d, ahi[kk], bhi[kk][nt]);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[mt][nt][k] += d[k];
      }
    }
  }
}

// column of gate row r (of 64) in row n of a warp's partial sums: r ^ 8 (n % 4), so that
// the fragments' stores of a warp (rows mma_row) hit 32 different banks
__device__ __forceinline__ int red_col(int n, int r) { return r ^ ((n & 3) << 3); }

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

// RT x UT: the FFMA product's register tile (NT = 0); NT: the tensor-core product's
// 8-row tiles of h (RT = UT = 0; U = 16, so 4 tiles of 16 gate rows; resident W only;
// the h tile by TMA, h_map)
template <bool RESIDENT, int RT, int UT, int NT>
__global__ void __launch_bounds__(THREADS, 1)
    lstm_layer_kernel(const Layer p, const __grid_constant__ CUtensorMap h_map) {
  constexpr bool MMA = NT > 0;
  constexpr int MT = 4;  // the tensor-core product's tiles of 16 of the 64 gate rows
  static_assert(!MMA || RESIDENT, "the tensor-core product reads a resident W");
  // sums a thread holds: index (q * UT + e) * 4 + g for row q, unit e, gate g
  constexpr int V = 4 * UT * RT;
  extern __shared__ float4 smem_raw[];
  // MMA: the layout starts on a 1024-byte boundary, as the TMA's 128-byte swizzle wants
  float4* smem4 = MMA ? smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024 / 16 : smem_raw;
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

  // the h tile's region also holds the tensor-core product's partial sums of the warps
  const int h_region = MMA ? max(BT * HC, WARPS * BT * U) : BT * HC;  // float4s
  float4* ws = smem4;                                  // [R][HC], swizzled (if RESIDENT)
  // [BT][HC] swizzled; MMA: [HC / 8][BT][8], tma_hs
  float4* hs = ws + (RESIDENT ? R * HC : 0);
  float* part = reinterpret_cast<float*>(hs + h_region);  // [BT][R], the gate products
  float* xs = part + BT * R;                           // [2][BT][R]
  float* cs = xs + 2 * BT * R;                         // [BR][U]
  // MMA: the two halves' mbarriers, 8-byte aligned since U = 16 makes BR * U even
  uint64_t* bars = reinterpret_cast<uint64_t*>(cs + p.BR * U);

  const int tid = threadIdx.x;
  constexpr int RT1 = RT > 0 ? RT : 1, UT1 = UT > 0 ? UT : 1;
  const int nbt = BT / RT1, nut = U / UT1;
  const int n_split = MMA ? 1 : THREADS / (nut * nbt);  // K_SPLIT, a power of two <= 32
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
      ws[r * HC + swz<MMA>(r, c)] = v;
    }
  }
  for (int idx = tid; idx < p.BR * U; idx += THREADS) cs[idx] = 0.f;
  int h_parity = 0;  // MMA: the parity of the mbarriers' current phase (one per h tile)
  if constexpr (MMA) {
    if (tid == 0) {
      mbar_init(&bars[0], 1);
      mbar_init(&bars[1], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();  // the barriers exist before any thread waits on them
  }

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
      if constexpr (MMA) {
        // h_{t_prev} of the tile's rows: one copy for each half of H. The CTA is done with
        // its h region (the CTA barrier that ended the previous tile), and every CTA of the
        // batch group has written h_{t_prev} (the counter), so the copies may start.
        if (s > 0 && tid == 0) {
          const int seg_half = HC / 16;  // 32-float segments in each half of H
          // the proxy fence on the causality path from the generic accesses (h_{t_prev}'s
          // stores, ordered before the counter's release and seen by this thread's acquire;
          // this CTA's reads and partial sums in hs, before its barrier) to the copies
          fence_proxy_async();
          for (int part_k = 0; part_k < 2; ++part_k) {
            mbar_expect_tx(&bars[part_k], BT * HC * 8);  // bytes of half the tile
            tma_load(hs + part_k * seg_half * BT * 8, &h_map, 0, t_prev * B + tb,
                     d * H / 32 + part_k * seg_half, &bars[part_k]);
          }
        }
      } else {
        // h_{t_prev} of the tile's rows, all in flight at once where aligned, in two groups
        // (chunks [0, HC/2) and [HC/2, HC)) so the product starts on the first half
        for (int part_k = 0; part_k < 2; ++part_k) {
          for (int idx = tid; s > 0 && idx < BT * half_hc; idx += THREADS) {
            const int bl = idx / half_hc, c = part_k * half_hc + idx % half_hc, b = tb + bl;
            const float* src =
                p.out + (static_cast<size_t>(t_prev) * B + b) * out_row + d * H + 4 * c;
            float4* dst = hs + bl * HC + swz<MMA>(bl, c);
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
      }
      prefetch(n + 1);
      // this item's xp and (but for MMA, whose h is no cp.async group) the first half of h
      cp_async_wait<MMA ? 1 : 2>();
      __syncthreads();
      if constexpr (MMA) {
        if (s > 0) mbar_wait(&bars[0], h_parity);  // the first half of h
      }
      PHASE_MARK(1);
      if constexpr (MMA) {
        if (s > 0) {
          const int warp = tid / 32, lane = tid % 32;
          float acc[MT][NT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int k = 0; k < 4; ++k) acc[mt][nt][k] = 0.f;
          const int kb_half = HC / 8;  // 16-wide k blocks in each half of H
          mma_blocks<MT, NT>(ws, hs, HC, 0, kb_half, warp, lane, acc);
          mbar_wait(&bars[1], h_parity);  // the second half of h
          h_parity ^= 1;
          mma_blocks<MT, NT>(ws, hs, HC, kb_half, 2 * kb_half, warp, lane, acc);
          __syncthreads();  // every warp is done with hs: its partial sums go there
          float* red = reinterpret_cast<float*>(hs) + warp * BT * R;  // [BT][R], red_col
          const int g = lane >> 2, q = lane & 3;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int k = 0; k < 4; ++k) {  // c0..c3: rows g, g, g + 8, g + 8
                const int r = 16 * mt + g + 8 * (k >> 1), col = 2 * q + (k & 1);
                const int bl = 8 * nt + mma_row(col);
                red[bl * R + red_col(bl, r)] = acc[mt][nt][k];
              }
          __syncthreads();
          const float4* red4 = reinterpret_cast<const float4*>(hs);
          for (int idx = tid; idx < BT * U; idx += THREADS) {  // 4 gate rows at a time
            const int bl = idx / U, c = red_col(bl, 4 * (idx % U)) / 4;
            float4 v = red4[bl * U + c];
#pragma unroll
            for (int k = 1; k < WARPS; ++k) {
              const float4 o = red4[(k * BT + bl) * U + c];
              v.x += o.x;
              v.y += o.y;
              v.z += o.z;
              v.w += o.w;
            }
            reinterpret_cast<float4*>(part)[idx] = v;
          }
        }
      } else if (s > 0) {
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
                  wv[e][g] = ws[r * HC + swz<MMA>(r, c)];
                else
                  wv[e][g] = j0 + u0 + e < H ?
                      load4(w + (static_cast<size_t>(g) * H + j0 + u0 + e) * H + 4 * c, 4 * c,
                            H, aligned, false) :
                      make_float4(0.f, 0.f, 0.f, 0.f);
              }
#pragma unroll
            for (int q = 0; q < RT; ++q) {
              const int bl = bt + q * nbt;
              const float4 hv = hs[bl * HC + swz<MMA>(bl, c)];
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

// The shared memory of one CTA: W's slice if resident, the h tile (for the tensor-core
// product at least the 8 warps' partial sums, 8 x BT x 4U floats), the gate products, the
// double-buffered xp tile, the cell state and, for the tensor-core product, the two
// halves' mbarriers and the room to start the layout on a 1024-byte boundary
size_t smem_bytes(int H, int U, int BT, int BR, bool resident, bool mma) {
  const size_t hc = static_cast<size_t>(((H + 3) / 4 + 7) / 8 * 8);
  const size_t r = 4 * static_cast<size_t>(U);
  const size_t h_tile = BT * hc, partials = WARPS * static_cast<size_t>(BT) * U;  // float4s
  return 16 * ((resident ? r * hc : 0) + (mma && partials > h_tile ? partials : h_tile)) +
         4 * (3 * BT * r + static_cast<size_t>(BR) * U) + (mma ? 16 + 1008 : 0);
}

// rows and units of a thread's register tile for a tile of BT rows
int tile_rows_per_thread(int BT) { return BT >= 8 ? 8 : 4; }
int tile_units_per_thread(int BT) { return BT >= 32 ? 2 : 1; }

template <int RT, int UT>
const void* kernel_for(bool resident) {
  return resident ? reinterpret_cast<const void*>(lstm_layer_kernel<true, RT, UT, 0>)
                  : reinterpret_cast<const void*>(lstm_layer_kernel<false, RT, UT, 0>);
}

// the tensor-core variant for U units and a tile of BT rows (NT = BT / 8 tiles of 8), or
// null where none is built: U = 16, BT in {8, 16, 32}
const void* mma_kernel(int U, int BT) {
  if (U != 16) return nullptr;
  return BT == 8 ? reinterpret_cast<const void*>(lstm_layer_kernel<true, 0, 0, 1>)
       : BT == 16 ? reinterpret_cast<const void*>(lstm_layer_kernel<true, 0, 0, 2>)
       : BT == 32 ? reinterpret_cast<const void*>(lstm_layer_kernel<true, 0, 0, 4>)
                  : nullptr;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda; as
// csrc/vq_nearest_code.cu)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The h tile's tensor map of out (T, B, D*H): 32 floats, then the T * B rows, then the
// D*H / 32 segments of 32 floats; boxes of BT rows x `segments` segments, in the 128-byte
// swizzle, zero past the edges
cudaError_t make_h_map(CUtensorMap* map, const float* out, int T, int B, int H, int D, int BT,
                       int segments) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {32, static_cast<cuuint64_t>(T) * B,
                              static_cast<cuuint64_t>(D) * H / 32};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * H * 4, 128};  // bytes
  const cuuint32_t box[3] = {32, static_cast<cuuint32_t>(BT),
                             static_cast<cuuint32_t>(segments)};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(out),
                            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
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
// D * ceil(B / BR) zeroed int32. The plan (U, BT, BR, resident, mma) must keep every CTA
// co-resident; BT is 4, 8, 16 or 32. The FFMA product (mma = 0) needs (U / UT) * (BT / RT)
// to divide 256 into at most 32 (RT = 8 rows, 4 where BT = 4; UT = 2 units where BT = 32,
// else 1); the tensor-core product (mma = 1) a resident W, U = 16, BT in {8, 16, 32} and
// H % 64 == 0 (its TMA copies take each half of H in whole 32-float segments). The shared
// memory it takes is smem_bytes(), which ops/lstm_cuda.py mirrors. Launches one
// cooperative kernel on `stream` without synchronising and returns its error (0 =
// success; cudaErrorCooperativeLaunchTooLarge when the grid cannot be co-resident, e.g. on
// a shared card).
int lstm_layer(const float* xp, const float* w, float* out, int* counters, int T, int B,
               int H, int D, int U, int BT, int BR, int resident, int mma,
               cudaStream_t stream) {
  if (T <= 0 || B <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  const int rt = tile_rows_per_thread(BT), ut = tile_units_per_thread(BT);
  const int tiles = U % ut == 0 && BT % rt == 0 ? U / ut * (BT / rt) : 0;
  const int split = tiles > 0 && THREADS % tiles == 0 ? THREADS / tiles : 0;
  const void* fn = mma ? (resident ? mma_kernel(U, BT) : nullptr)
                 : ut == 2 ? kernel_for<8, 2>(resident != 0)
                 : rt == 8 ? kernel_for<8, 1>(resident != 0) : kernel_for<4, 1>(resident != 0);
  if (D < 1 || D > 2 || BR < 1 || fn == nullptr || (!mma && (split < 1 || split > 32)) ||
      (mma && H % 64 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  Layer p{xp, w, out, counters, T, B, H, D, U, BT, BR, (H + U - 1) / U,
          ((H + 3) / 4 + 7) / 8 * 8};
  const size_t smem = smem_bytes(H, U, BT, BR, resident != 0, mma != 0);
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  alignas(64) CUtensorMap h_map = {};  // read by the tensor-core variants only
  if (mma) {
    e = make_h_map(&h_map, out, T, B, H, D, BT, H / 64);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(p.NJ, (B + BR - 1) / BR, D);
  void* args[] = {&p, &h_map};
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
