// VQ nearest-code search for Hopper (sm_90a): a split-TF32 tensor-core product.
//
// Replaces the TPU kernel pantomatrix_tpu/ops/vq_pallas.py::_vq_argmin_kernel
// (reached through nearest_code_fast from models/emage_vq.py::vqvae_decode_latent).
// For z (N, D) and a codebook (K, D), both fp32, it writes per row the int32
//     argmin_k ( ||e_k||^2 - 2 z . e_k )
// ||z||^2 is constant per row and dropped, as in the TPU kernel; ties go to the
// lowest k, as in jnp.argmin and torch.argmin.
//
// Bound on an H100 SXM. Plain TF32 (10 mantissa bits) would change indices, so the
// product is split: x = hi + lo with hi = tf32(x) and lo = tf32(x - hi) (round to
// nearest, ties away, as cvt.rna.tf32.f32), and
//     z . e ~= z_hi . e_lo + z_lo . e_hi + z_hi . e_hi       (fp32 accumulate),
// which keeps fp32-grade error (the dropped z_lo . e_lo is ~2^-22 of the product).
// At the final decode of the benchmark shape (N = 128*1800, D = K = 256) that is
// 3 x 2NKD = 90.6 GFLOP on the tensor cores, 0.183 ms at the 495 TFLOP/s TF32 peak,
// against 237 MB of traffic (z read once; the 256 KiB codebook; the indices),
// 0.071 ms at 3.35 TB/s: bound by operations.
//
// What each choice does about what held back the fp32-FMA kernel it replaces (one
// 64-row CTA per tile walking all codes: 8 CTAs at N = 512; synchronous loads; 8
// scalar shared loads per 16 FMAs; tensor cores idle):
//  * Products on the tensor cores. A CTA owns BM = 64 rows; its two warpgroups each
//    take half of the tile's BN codes and issue wgmma.mma_async m64n(BN/2)k8 .tf32:
//    A is z, split into hi/lo in registers from the staged fp32 tile; B is the codes,
//    split into hi/lo copies in shared memory (the staged layout, elementwise) as each
//    chunk arrives. Three products per k8 step go into one fp32 accumulator, small
//    terms first: hi.lo, lo.hi, hi.hi. ||e||^2 is summed in fp32 from the staged codes
//    during the split. The split is two integer operations per half.
//  * Asynchronous staging. Each chunk (64 rows x 32 depths of z, BN codes x 32 depths)
//    arrives by two 2-D TMA loads on an mbarrier (tensor maps in the 128-byte swizzle,
//    zero past the edges; cuTensorMapEncodeTiled looked up with cudaGetDriverEntryPoint,
//    so no -lcuda), into a ring of 2 to 4 stages. The swizzle keeps the A loads and the
//    split's 16-byte accesses free of bank conflicts and is the layout wgmma reads
//    (SWIZZLE_128B descriptors). The codes' hi/lo copies are double-buffered and
//    each warpgroup keeps two sets of A fragments, so chunk c + 1 is split while the
//    wgmmas of chunk c run; one wgmma group stays in flight across chunks. Where TMA
//    cannot take the tensors (D % 4 != 0, D < 32, or an unaligned base), 4-byte
//    cp.async copies, zero-filled past the edges, fill the same layout.
//  * The grid. The K codes of one 64-row tile may be split across a thread-block
//    cluster of S in {1, 2, 4, 8} CTAs (rank r owns codes [r * codes_per_cta,
//    (r + 1) * codes_per_cta)), launched with cudaLaunchKernelEx.
//    ops/vq_cuda.py::plan_search chooses S from a cost model fitted on the card: a
//    CTA's time is mostly fixed (its serial walk over the depth chunks), so a split
//    pays only where the row tiles leave most SMs idle (N = 512: S = 8, 64 CTAs) and
//    S = 1 is fastest from N = 4800 up. Each CTA leaves its per-row (min, argmin) in
//    shared memory; after a cluster barrier rank 0 reads its peers through distributed
//    shared memory (mapa + ld.shared::cluster) in ascending rank, i.e. ascending k,
//    merging with strict <, and writes the result; a second cluster barrier keeps the
//    peers' shared memory alive until it has been read. One launch per search, no
//    scratch tensor, no atomics: the result is bitwise repeatable.
//  * Ties. Each thread scans its columns in ascending k with strict <; the four lanes
//    that share a row, and then warpgroup 0 before warpgroup 1, merge under
//    (v < best) || (v == best && k < best_k).
//  * Any N, D, K: depths past D and rows past N are zero-filled in shared memory and
//    codes outside a CTA's range (k >= K) are never compared; nothing is padded in
//    device memory. More than 256 codes per CTA are walked in tiles of BN.
//  * -DVQ_SKIP_SPLIT / -DVQ_SKIP_MMA drop the split or the products (wrong indices;
//    for scripts/torch_k1_sweep.py's breakdown of the time only).
//
// ptxas (-Xptxas -v on the H100 machine, as chip_smoke.py prints it; registers per thread for
// BN = 256 / 128 / 64 / 32): TMA path 204 / 178 / 156 / 159, cp.async path 226 / 198 /
// 190 / 166; no stack frame and no spills in any instance. Shared memory is dynamic:
// smem_bytes(BN) = 217,104 / 143,384 / 102,432 / 69,664 bytes, one CTA of 256 threads.

#include <climits>
#include <cstdint>
#include <type_traits>
#include <cuda.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;        // rows per CTA (one wgmma M)
constexpr int BD = 32;        // depths per chunk: four k8 steps, one 128-byte swizzle row
constexpr int THREADS = 256;  // two warpgroups, each on half of the tile's codes

// depth of the ring of staged chunks for BN codes per tile: deeper where the tile is small
__host__ __device__ constexpr int stages_for(int bn) { return bn >= 256 ? 2 : bn >= 128 ? 3 : 4; }

// Dynamic shared memory of one CTA for BN codes per tile (mirrored by
// ops/vq_cuda.py::smem_bytes): 1024 bytes of slack to align the tiles for the 128-byte
// swizzle, hi and lo code copies (two buffers each), the ring of fp32 stages (z and
// codes), the ||e||^2 partials (two tiles), the two warpgroups' per-row candidates
// (min, argmin) and one mbarrier per stage.
__host__ __device__ constexpr int smem_bytes(int bn) {
  return 1024 + 4 * (4 * bn * BD + stages_for(bn) * (BM + bn) * BD + 2 * THREADS + 4 * BM) +
         8 * stages_for(bn);
}

// Offset in floats of (row r, depth c) of a tile of 32-depth rows in the 128-byte
// swizzle that TMA writes and wgmma reads (K-major, SWIZZLE_128B): the 16-byte chunk
// c / 4 of row r sits at chunk (c / 4) ^ (r % 8).
__device__ __forceinline__ int swz(int r, int c) {
  return r * BD + ((((c >> 2) ^ (r & 7)) << 2) | (c & 3));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// x rounded to TF32 as cvt.rna.tf32.f32 does (to nearest, ties away from zero), in two
// integer operations
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo + O(2^-22 |x|), both TF32 (low 13 mantissa bits zero)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// wgmma descriptor of a K-major tile in the 128-byte swizzle: rows of 128 bytes, groups
// of 8 rows 1024 bytes apart (SBO); a k8 step within the row advances the start address
// by 32 bytes
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |            // LBO: unused in this layout
         (static_cast<uint64_t>(1024 >> 4) << 32) |    // SBO
         (static_cast<uint64_t>(1) << 62);             // SWIZZLE_128B
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n}\n"
      :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}
// 2-D TMA load of the box at (inner c0, outer c1) into dst, completing on bar; boxes
// past the tensor's edges are zero-filled
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

__device__ __forceinline__ int cluster_ctarank() {
  int r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t peer_addr(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_u32(p)), "r"(rank));
  return r;
}
__device__ __forceinline__ float ld_peer_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ int ld_peer_s32(uint32_t addr) {
  int v;
  asm volatile("ld.shared::cluster.s32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// d (N/2 fp32 accumulators a thread) += A (64 x 8, tf32 fragment a[4]) x B^T, B the
// N x 8 tf32 tile at descriptor `desc`.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a, uint64_t desc);

template <> __device__ __forceinline__ void wgmma_tf32<16>(float* d, const uint32_t* a,
                                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_tf32<32>(float* d, const uint32_t* a,
                                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_tf32<64>(float* d, const uint32_t* a,
                                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_tf32<128>(float* d, const uint32_t* a,
                                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <int BN, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
vq_nearest_code_kernel(const __grid_constant__ CUtensorMap z_map,
                       const __grid_constant__ CUtensorMap cb_map, const float* __restrict__ z,
                       const float* __restrict__ cb, int32_t* __restrict__ out, int n, int d,
                       int k, int cluster, int codes_per_cta) {
  constexpr int STAGES = stages_for(BN);
  constexpr int TILE = BN * BD;        // words of one code chunk
  constexpr int WN = BN / 2;           // codes per warpgroup (its wgmma N)
  constexpr int TPC = THREADS / BN;    // threads that share one code's ||e||^2
  extern __shared__ unsigned char smem_raw[];
  // every tile starts on a 1024-byte boundary, as the 128-byte swizzle wants
  unsigned char* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  uint32_t* bhi = reinterpret_cast<uint32_t*>(smem);      // [2][TILE]
  uint32_t* blo = bhi + 2 * TILE;                         // [2][TILE]
  float* cs = reinterpret_cast<float*>(blo + 2 * TILE);   // [STAGES][TILE]
  float* zs = cs + STAGES * TILE;                         // [STAGES][BM * BD]
  float* esq_part = zs + STAGES * BM * BD;                // [2][THREADS]
  float* cand_v = esq_part + 2 * THREADS;                 // [2][BM]
  int* cand_k = reinterpret_cast<int*>(cand_v + 2 * BM);  // [2][BM]
  uint64_t* full = reinterpret_cast<uint64_t*>(cand_k + 2 * BM);  // [STAGES]

  const int tid = threadIdx.x;
  const int wg = tid / 128;  // warpgroup: codes [wg * WN, (wg + 1) * WN) of each tile
  const int lane = tid % 32, q = lane % 4;
  const int r0 = 16 * (tid % 128 / 32) + lane / 4;  // this thread's rows: r0 and r0 + 8
  const int rank = cluster > 1 ? cluster_ctarank() : 0;
  const long long row_base = static_cast<long long>(blockIdx.x / cluster) * BM;
  const int code_lo = rank * codes_per_cta;
  const int code_hi = min(k, code_lo + codes_per_cta);
  const int n_dchunks = (d + BD - 1) / BD;
  const int n_chunks = code_hi > code_lo ? (code_hi - code_lo + BN - 1) / BN * n_dchunks : 0;

  if (VEC && tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // chunk c = (code tile c / n_dchunks, depths [32 (c % n_dchunks), +32)) -> stage
  // c % STAGES: two TMA boxes (z: 64 rows, codes: BN rows, 32 depths each, zero past
  // the edges) on the stage's mbarrier, or, where TMA cannot take the tensors, 4-byte
  // cp.async copies zero-filled past the edges, one commit group per call
  auto load_chunk = [&](int c) {
    const int code0 = code_lo + (c / n_dchunks) * BN;
    const int d0 = (c % n_dchunks) * BD;
    float* zst = zs + (c % STAGES) * BM * BD;
    float* cst = cs + (c % STAGES) * TILE;
    if (VEC) {
      if (tid == 0 && c < n_chunks) {
        uint64_t* bar = &full[c % STAGES];
        mbar_expect_tx(bar, (BM + BN) * BD * 4);
        tma_load(zst, &z_map, d0, static_cast<int>(row_base), bar);
        tma_load(cst, &cb_map, d0, code0, bar);
      }
      return;
    }
    if (c < n_chunks) {
      for (int e = tid; e < BM * BD; e += THREADS) {
        const int r = e / BD, cc = e % BD;
        const long long gr = row_base + r;
        const int gc = d0 + cc;
        const bool ok = gr < n && gc < d;
        cp_async4(zst + swz(r, cc), ok ? z + gr * d + gc : z, ok ? 4 : 0);
      }
      for (int e = tid; e < BN * BD; e += THREADS) {
        const int nn = e / BD, cc = e % BD;
        const int gk = code0 + nn, gc = d0 + cc;
        const bool ok = gk < k && gc < d;
        cp_async4(cst + swz(nn, cc), ok ? cb + static_cast<long long>(gk) * d + gc : cb,
                  ok ? 4 : 0);
      }
    }
    cp_async_commit();
  };
  // chunk c has landed in its stage (for every thread, after the barrier that follows)
  auto wait_chunk = [&](int c) {
    if (VEC) {
      mbar_wait(&full[c % STAGES], (c / STAGES) & 1);
    } else {
      cp_async_wait<STAGES - 1>();
    }
  };

  // split code chunk c into hi/lo buffer c % 2 (the same swizzled layout), summing
  // ||e||^2 of code tid % BN: a quarter-warp reads one 16-byte chunk of 8 consecutive
  // codes, which the swizzle puts in distinct banks
  float esq = 0.f;
  auto split_b = [&](int c) {
    const float* cst = cs + (c % STAGES) * TILE;
    uint32_t* hi = bhi + (c % 2) * TILE;
    uint32_t* lo = blo + (c % 2) * TILE;
#pragma unroll
    for (int i = 0; i < BN * BD / 4 / THREADS; ++i) {
      const int e = tid + THREADS * i;
      const int off = swz(e % BN, 4 * (e / BN));
      const float4 x = *reinterpret_cast<const float4*>(cst + off);
      uint4 h, l;
      split_tf32(x.x, h.x, l.x);
      split_tf32(x.y, h.y, l.y);
      split_tf32(x.z, h.z, l.z);
      split_tf32(x.w, h.w, l.w);
      *reinterpret_cast<uint4*>(hi + off) = h;
      *reinterpret_cast<uint4*>(lo + off) = l;
      esq = fmaf(x.x, x.x, esq);
      esq = fmaf(x.y, x.y, esq);
      esq = fmaf(x.z, x.z, esq);
      esq = fmaf(x.w, x.w, esq);
    }
    if (c % n_dchunks == n_dchunks - 1) {  // the code tile's last chunk: publish
      esq_part[((c / n_dchunks) % 2) * THREADS + tid] = esq;  // part tid / BN of code tid % BN
      esq = 0.f;
    }
  };

  // A fragments (m64k8 tf32: rows r0 / r0 + 8, columns q / q + 4) of the four k8 steps,
  // split; two sets, so that one chunk's are loaded while the other's wgmmas run
  uint32_t ahi[2][4][4], alo[2][4][4];
  auto load_a = [&](auto par, int c) {
    constexpr int P = decltype(par)::value;
    const float* zst = zs + (c % STAGES) * BM * BD;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int col = 8 * s + q;
      split_tf32(zst[swz(r0, col)], ahi[P][s][0], alo[P][s][0]);
      split_tf32(zst[swz(r0 + 8, col)], ahi[P][s][1], alo[P][s][1]);
      split_tf32(zst[swz(r0, col + 4)], ahi[P][s][2], alo[P][s][2]);
      split_tf32(zst[swz(r0 + 8, col + 4)], ahi[P][s][3], alo[P][s][3]);
    }
  };

  float acc[WN / 2];
#pragma unroll
  for (int i = 0; i < WN / 2; ++i) acc[i] = 0.f;
  float best0 = __int_as_float(0x7f800000), best1 = best0;  // +inf
  int bk0 = 0, bk1 = 0;

  // fold code tile `tile` into the running (min, argmin) of rows r0 and r0 + 8: this
  // thread's columns wg * WN + 8j + 2q + h in ascending k. Accumulator layout of m64nWN:
  // acc[4j+h] is (r0, 8j + 2q + h), acc[4j+2+h] is (r0 + 8, 8j + 2q + h).
  auto epilogue = [&](int tile) {
    const int code0 = code_lo + tile * BN;
    const float* ep = esq_part + (tile % 2) * THREADS;
#pragma unroll
    for (int j = 0; j < WN / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = wg * WN + 8 * j + 2 * q + h;
        float e = ep[col];
#pragma unroll
        for (int p = 1; p < TPC; ++p) e += ep[p * BN + col];
        const float v0 = fmaf(-2.f, acc[4 * j + h], e);
        const float v1 = fmaf(-2.f, acc[4 * j + 2 + h], e);
        if (code0 + col < code_hi) {
          if (v0 < best0) { best0 = v0; bk0 = code0 + col; }
          if (v1 < best1) { best1 = v1; bk1 = code0 + col; }
        }
        acc[4 * j + h] = 0.f;
        acc[4 * j + 2 + h] = 0.f;
      }
    }
  };

  // chunk c (A set P = c % 2): issue its 12 wgmmas, then, while they run, split chunk
  // c + 1 and load its A set; one wgmma group stays in flight across chunks
  auto step = [&](auto par, int c) {
    constexpr int P = decltype(par)::value;
    // hi/lo of chunk c visible to the async proxy; stage c % STAGES fully read
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    load_chunk(c + STAGES);
    wgmma_fence();
    const uint32_t hi_addr = smem_u32(bhi + (c % 2) * TILE) + wg * WN * BD * 4;
    const uint32_t lo_addr = smem_u32(blo + (c % 2) * TILE) + wg * WN * BD * 4;
#ifndef VQ_SKIP_MMA
#pragma unroll
    for (int s = 0; s < 4; ++s) {  // small terms first
      const uint64_t dhi = make_desc(hi_addr + 32 * s);
      const uint64_t dlo = make_desc(lo_addr + 32 * s);
      wgmma_tf32<WN>(acc, ahi[P][s], dlo);
      wgmma_tf32<WN>(acc, alo[P][s], dhi);
      wgmma_tf32<WN>(acc, ahi[P][s], dhi);
    }
#endif
    wgmma_commit();
    wgmma_wait<1>();  // chunk c - 1 done: its hi/lo buffer and A set are free
    if (c + 1 < n_chunks) {
      wait_chunk(c + 1);
      __syncthreads();  // chunk c + 1 staged; both warpgroups past chunk c - 1
#ifndef VQ_SKIP_SPLIT
      split_b(c + 1);
#endif
      load_a(std::integral_constant<int, 1 - P>(), c + 1);
    }
    if (c % n_dchunks == n_dchunks - 1) {
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < WN / 2; ++i) fence_operand(acc[i]);
      epilogue(c / n_dchunks);
    }
  };

#pragma unroll
  for (int c = 0; c < STAGES; ++c) load_chunk(c);
  if (n_chunks > 0) {
    wait_chunk(0);
    __syncthreads();
    split_b(0);
    load_a(std::integral_constant<int, 0>(), 0);
  }
  for (int c = 0; c < n_chunks; c += 2) {
    step(std::integral_constant<int, 0>(), c);
    if (c + 1 < n_chunks) step(std::integral_constant<int, 1>(), c + 1);
  }
  wgmma_wait<0>();
  if (!VEC) cp_async_wait<0>();

  // the four lanes of a quad share rows r0 and r0 + 8
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const float o0 = __shfl_xor_sync(0xffffffffu, best0, off);
    const int k0 = __shfl_xor_sync(0xffffffffu, bk0, off);
    const float o1 = __shfl_xor_sync(0xffffffffu, best1, off);
    const int k1 = __shfl_xor_sync(0xffffffffu, bk1, off);
    if (o0 < best0 || (o0 == best0 && k0 < bk0)) { best0 = o0; bk0 = k0; }
    if (o1 < best1 || (o1 == best1 && k1 < bk1)) { best1 = o1; bk1 = k1; }
  }
  if (q == 0) {
    cand_v[wg * BM + r0] = best0;
    cand_k[wg * BM + r0] = bk0;
    cand_v[wg * BM + r0 + 8] = best1;
    cand_k[wg * BM + r0 + 8] = bk1;
  }
  __syncthreads();
  if (tid < BM) {  // warpgroup 1's codes follow warpgroup 0's: strict <
    if (cand_v[BM + tid] < cand_v[tid]) {
      cand_v[tid] = cand_v[BM + tid];
      cand_k[tid] = cand_k[BM + tid];
    }
    if (cluster == 1 && row_base + tid < n) out[row_base + tid] = cand_k[tid];
  }
  if (cluster == 1) return;
  cluster_sync();
  if (rank == 0 && tid < BM) {
    float v = cand_v[tid];
    int bk = cand_k[tid];
    for (int r = 1; r < cluster; ++r) {  // ascending rank = ascending k: strict <
      const float ov = ld_peer_f32(peer_addr(cand_v + tid, r));
      const int ok = ld_peer_s32(peer_addr(cand_k + tid, r));
      if (ov < v) { v = ov; bk = ok; }
    }
    if (row_base + tid < n) out[row_base + tid] = bk;
  }
  cluster_sync();  // peers' shared memory stays alive until rank 0 has read it
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda)
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

// The tensor map of a (rows, d) fp32 row-major tensor read in boxes of box_rows x 32,
// in the 128-byte swizzle, zero past the edges
cudaError_t make_map(CUtensorMap* map, const float* base, int rows, int d, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * 4};
  const cuuint32_t box[2] = {BD, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base),
                            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int BN, bool VEC>
cudaError_t launch(const float* z, const float* cb, int32_t* out, int n, int d, int k,
                   int ctas, int cluster, int codes_per_cta, cudaStream_t stream) {
  auto kernel = vq_nearest_code_kernel<BN, VEC>;
  CUtensorMap z_map = {}, cb_map = {};
  cudaError_t err = cudaSuccess;
  if (VEC) {
    err = make_map(&z_map, z, n, d, BM);
    if (err == cudaSuccess) err = make_map(&cb_map, cb, k, d, BN);
    if (err != cudaSuccess) return err;
  }
  static unsigned long long smem_set = 0;  // the opt-in above 48 KB, once per device
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !(smem_set >> dev & 1)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes(BN));
    if (err != cudaSuccess) return err;
    if (dev < 64) smem_set |= 1ull << dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes(BN);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, z_map, cb_map, z, cb, out, n, d, k, cluster,
                           codes_per_cta);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <bool VEC>
cudaError_t dispatch(const float* z, const float* cb, int32_t* out, int n, int d, int k,
                     int ctas, int cluster, int codes_per_tile, int codes_per_cta,
                     cudaStream_t stream) {
  switch (codes_per_tile) {
    case 32: return launch<32, VEC>(z, cb, out, n, d, k, ctas, cluster, codes_per_cta, stream);
    case 64: return launch<64, VEC>(z, cb, out, n, d, k, ctas, cluster, codes_per_cta, stream);
    case 128: return launch<128, VEC>(z, cb, out, n, d, k, ctas, cluster, codes_per_cta, stream);
    default: return launch<256, VEC>(z, cb, out, n, d, k, ctas, cluster, codes_per_cta, stream);
  }
}

}  // namespace

extern "C" {

// z (n, d), cb (k, d) float32 row-major; out (n,) int32. The launch plan comes from
// ops/vq_cuda.py::plan_search and is checked here: 64 rows per CTA, a cluster of
// 1, 2, 4 or 8 CTAs per row tile splitting the codes (each owns codes_per_tile *
// tiles_per_cta of them, none empty), and the stages and shared-memory bytes of
// that tile width. A plan that does not hold returns cudaErrorInvalidValue without a
// launch; otherwise it launches on `stream` and returns the launch's error (0 = success).
int vq_nearest_code(const float* z, const float* cb, int32_t* out, int n, int d, int k,
                    int rows_per_cta, int cluster, int codes_per_tile, int tiles_per_cta,
                    int stages, int smem, cudaStream_t stream) {
  const long long codes_per_cta = static_cast<long long>(codes_per_tile) * tiles_per_cta;
  const long long ctas = (static_cast<long long>(n) + BM - 1) / BM * cluster;
  const bool ok =
      n > 0 && d > 0 && k > 0 && rows_per_cta == BM && stages == stages_for(codes_per_tile) &&
      (cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8) &&
      (codes_per_tile == 32 || codes_per_tile == 64 || codes_per_tile == 128 ||
       codes_per_tile == 256) &&
      tiles_per_cta > 0 && codes_per_cta * cluster >= k && codes_per_cta * (cluster - 1) < k &&
      codes_per_cta * cluster <= INT_MAX && smem == smem_bytes(codes_per_tile) &&
      ctas <= INT_MAX;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  // TMA takes rows of whole 16-byte units from 16-byte aligned bases, and a box no
  // deeper than the tensor
  const bool vec = d % 4 == 0 && d >= BD && reinterpret_cast<uintptr_t>(z) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(cb) % 16 == 0;
  const int cpc = static_cast<int>(codes_per_cta);
  const cudaError_t err =
      vec ? dispatch<true>(z, cb, out, n, d, k, static_cast<int>(ctas), cluster, codes_per_tile,
                           cpc, stream)
          : dispatch<false>(z, cb, out, n, d, k, static_cast<int>(ctas), cluster,
                            codes_per_tile, cpc, stream);
  return static_cast<int>(err);
}

const char* vq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
