// The flash-attention backward for bf16 inputs on Hopper's tensor cores
// (sm_90a): two kernels that replace, for bf16, the Pallas TPU kernels of
// chainermn_tpu/ops/flash_attention.py::_flash_bwd_bhtd:
//
// - K2 flash_dq_mma_kernel  <- its dq call (body _bwd_dq_body);
// - K3 flash_dkv_mma_kernel <- its dk/dv call (body _bwd_dkv_body), with
//   the optional full dbias.
//
// They take every option of the CUDA-core kernels in flash_attention.cu
// (which keep the fp32 backward): causal with q_offset, the sliding window
// and its band, GQA, packed segment ids, the additive fp32 bias with
// size-1 dims, bias_grad's full fp32 dbias, ragged tails for any T, head
// dim 32, 64 or 128. As there, each CTA owns its output tile and loops
// over the other axis itself, so there are no atomics and every sum is
// taken in one fixed order: the results repeat bit for bit.
//
// What bounds them: operations. Each (query row, visible key) pair costs
// 6*D (K2) or 8*D (K3) operations, and at T 2048, D 64 a CTA does some
// 100 operations per byte it reads even from L2 -- above the H100's ~295
// operations per byte of HBM only on tensor cores. So the design puts
// every product on the tensor cores and keeps the operands moving:
//
// - products are wgmma (sm_90a) with fp32 accumulators in registers: one
//   warpgroup (4 warps) per CTA issues m64n64k16 for the CTA's 64-row
//   tile (q rows in K2, keys in K3) against the other tile's 64 rows;
// - operands sit in shared memory as bf16 [64][D] tiles in wgmma's
//   canonical swizzled layout (128-byte rows with the 16-byte chunk index
//   XORed with the row's low bits; 64-byte rows for D 32), read through
//   matrix descriptors: K-major for S = Q K^T and dP = dO V^T, MN-major
//   (transposed) for the products over the tile's rows;
// - the streamed tiles (K/V in K2, q/dO with their LSE, delta and segment
//   ids in K3) pass through a two-stage ring filled by cp.async, so the
//   next tile's copy overlaps this tile's products;
// - P and dS never go to shared memory: the m64n64 accumulator, rounded
//   to bf16 in registers, is the register A operand of the next wgmma
//   (dq += dS K in K2; dv += P^T dO and dk += dS^T q in K3, which works in
//   the transposed frame S^T = K q^T, dP^T = V dO^T);
// - S and dP are two wgmma groups: P is formed while dP's product runs,
//   and in K3 dv's product runs while dS is formed. A tile pair whose
//   every entry is visible (the bulk of a causal band) takes a
//   straight-line path: exp2 on the special-function unit, no mask;
// - K2 runs its CTAs longest first (the q tiles at the causal end);
// - the segment-aware tile skip: each CTA reduces its own tile's segment
//   ids and those of every tile of its band to (min, max), and drops a
//   tile pair whose ranges do not overlap before loading it -- sound for
//   any ids, sorted or not, since such a pair holds no equal ids. The
//   mask rule below makes the skip exact. With bias_grad, K3 writes zeros
//   to every dbias tile it does not visit. Each CTA adds the (q tile,
//   k tile, q head) triples it visits and skips to counters on the card
//   (two atomic adds a CTA), which flash_bwd_tile_counts reads: the
//   proof that the skip ran.
//
// Later work: TMA with an mbarrier ring in place of cp.async (issuing the
// copies and the barrier take about a quarter of a tile's time on the
// H100), warp
// specialisation (a producer warp, two consumer warpgroups), a
// persistent grid.
//
// Numerics: scores = (q . k, fp32 accumulators) * scale (+ bias);
// p = mask ? exp(s - lse) : 0 from the saved LSE (exact 0 on every masked
// entry, also on a row that saw no key); dS = p * (dP - delta) * scale,
// rounded to bf16 (k's dtype for dq, q's for dk); dbias = dS before the
// scale, in fp32; dv = P^T dO with P rounded to bf16 -- the TPU kernel
// and the plain version take fp32 p, a relative change of about 2^-9 per
// term; dq/dk/dv/dbias are written in fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "flash_attention.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 4;  // each warp owns 16 rows of the CTA's tile
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;
// CTAs per SM that a kernel's register budget is set for: three at head
// dim 32 and 64 (at most 168 registers a thread; measured faster on the
// H100 than two, though K3 then spills a few bytes), one at 128 (which
// would spill heavily under that budget).
template <int D>
constexpr int kMinBlocks = D <= 64 ? 3 : 1;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

// (q tile, k tile, q head) triples of the band that K2 ([0]) and K3 ([1])
// visited ([.][0]) and skipped by segment ranges ([.][1]) since the last
// flash_bwd_tile_counts on this device.
__device__ unsigned long long g_tile_counts[2][2];

__device__ __forceinline__ void count_tiles(int kernel, int visited,
                                            int skipped) {
  atomicAdd(&g_tile_counts[kernel][0], (unsigned long long)visited);
  atomicAdd(&g_tile_counts[kernel][1], (unsigned long long)skipped);
}

// ------------------------------------------------------------ primitives

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk `c` of row `r` in a [64][D] bf16 tile laid
// out as wgmma's canonical swizzled layout: 128-byte rows (64 columns; D
// 128 as two column blocks of 8 KB) with the chunk index XORed with the
// row's low 3 bits, or for D 32 64-byte rows with it XORed with bits 1-2.
// Every 8 consecutive rows at one logical chunk land in 8 distinct bank
// groups, and the tile base sits on 1024 bytes, as the swizzle needs.
template <int D>
__device__ __forceinline__ uint32_t tile_off(int r, int c) {
  if (D == 32) return (uint32_t)(r * 64 + ((c ^ ((r >> 1) & 3)) << 4));
  return (uint32_t)((c >> 3) * 8192 + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

// wgmma's shared-memory matrix descriptor: start address, leading and
// stride byte offsets (in 16-byte units) and the swizzle mode (1: 128
// bytes, 2: 64 bytes).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t swz) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)swz << 62);
}
template <int D>
constexpr uint32_t kSwizzle = D == 32 ? 2 : 1;
template <int D>
constexpr uint32_t kRows8 = D == 32 ? 512 : 1024;  // bytes of 8 rows

// A tile as the K-major operand of a product over its D columns: the
// k16 step ks (columns 16 ks .. 16 ks + 15) of its 64 rows.
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int ks) {
  const uint32_t off = D == 32 ? ks * 32 : (ks >> 2) * 8192 + (ks & 3) * 32;
  return make_desc(tile + off, 16, kRows8<D>, kSwizzle<D>);
}

// A tile as the MN-major operand of a product over its rows: the k16
// step kk (rows 16 kk .. 16 kk + 15) against its D columns.
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return make_desc(tile + kk * 2 * kRows8<D>, 8192, kRows8<D>, kSwizzle<D>);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared-memory writes of the generic proxy (cp.async) made visible to
// wgmma's operand reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup's wgmma are
// still in flight.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep registers that an asynchronous wgmma reads or writes live and in
// place until after the wait.
template <int N>
__device__ __forceinline__ void keep(float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(x[i][e])::"memory");
}
__device__ __forceinline__ void keep(uint32_t (&x)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(x[i][e])::"memory");
}

// d (m64n64, fp32) = A B^T (+ d where accumulate) over k16, both
// operands K-major in shared memory.
__device__ __forceinline__ void wgmma_ss64(float d[8][4], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (m64n32, fp32) += A B over k16: A (bf16) in registers, B MN-major
// in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[4][4], const uint32_t a[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64n64, fp32) += A B over k16: A (bf16) in registers, B MN-major
// in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4], const uint32_t a[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64n128, fp32) += A B over k16: A (bf16) in registers, B MN-major
// in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[16][4], const uint32_t a[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// 2^x on the special-function unit (flushes results below 2^-126 to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Rows [r0, r0 + 64) of one (batch, head) slice of a BTHD bf16 tensor into
// a swizzled [64][D] tile; rows at or past n are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          int64_t row_stride, int r0, int n) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int it = 0; it < kTile * kChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r0 + r < n;
    const bf16* g = ok ? src + (int64_t)(r0 + r) * row_stride + c * 8 : src;
    cp_async16(dst + tile_off<D>(r, c), g, ok);
  }
}

// Entries [i0, i0 + 64) of a row of 4-byte values (segment ids, LSE,
// delta); entries at or past n are zero-filled.
__device__ __forceinline__ void load_vec(uint32_t dst, const void* src,
                                         int i0, int n) {
  if (threadIdx.x < kTile) {
    const int i = i0 + threadIdx.x;
    const bool ok = i < n;
    cp_async4(dst + 4 * threadIdx.x,
              static_cast<const char*>(src) + 4 * (int64_t)(ok ? i : 0), ok);
  }
}

// s = A B^T over the D columns of two K-major [64][D] tiles, 64 x 64,
// issued by the warpgroup (not committed). Every thread holds its m16n8
// fragments: rows 16 warp + lane / 4 (+ 8), columns 8 n + 2 (lane % 4)
// (+ 1). S = Q K^T and dP = dO V^T in K2, their transposes in K3.
template <int D>
__device__ __forceinline__ void wg_abt(float (&s)[8][4], uint32_t A,
                                       uint32_t B) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    wgmma_ss64(s, desc_k<D>(A, ks), desc_k<D>(B, ks), ks > 0);
}

// The m16n8 accumulator fragments of a 64 x 64 product, rounded to bf16,
// as the register A fragments of four k16 steps.
__device__ __forceinline__ void to_a(uint32_t a[4][4], const float x[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[kk][1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[kk][2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
  }
}

// acc += X B over the 64 columns of X (register fragments a) against the
// rows of the MN-major [64][D] tile B.
template <int D>
__device__ __forceinline__ void wg_xb(float (&acc)[D / 8][4], uint32_t (&a)[4][4],
                                      uint32_t B) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, a[kk], desc_mn<D>(B, kk));
}

// (min, max) of the in-range segment ids [i0, min(i0 + 64, n)) of a row,
// reduced over one warp (every lane gets the result).
__device__ __forceinline__ void seg_range(const int* seg, int i0, int n,
                                          int* lo, int* hi) {
  const int lane = threadIdx.x & 31;
  int a = INT_MAX, b = INT_MIN;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = i0 + lane + 32 * j;
    if (i < n) {
      const int s = seg[i];
      a = min(a, s);
      b = max(b, s);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a = min(a, __shfl_xor_sync(kFull, a, o));
    b = max(b, __shfl_xor_sync(kFull, b, o));
  }
  *lo = a;
  *hi = b;
}

// The tiles [t0, t1) of the other axis that this CTA visits, in order,
// into list[]: those whose segment range meets `own` (the CTA's own
// tile's (min, max); seg_oth null: no segments, every tile of the band).
// Their ranges go to tmin[]/tmax[] and, where flag is not null, flag[t]
// is 1 for a visited tile and 0 for every other tile of [0, nt). Adds
// per_tile x the tiles visited and skipped to g_tile_counts[kernel] --
// here, where the count is at hand: adding it in the kernel's body after
// the plan doubled K3's register spills (ptxas -v) and slowed K3.
// Returns the count, after a __syncthreads.
__device__ int plan_tiles(const int own[2], const int* seg_oth, int n_oth,
                          int t0, int t1, int nt, int* list, int* tmin,
                          int* tmax, int* flag, int* shared_n, int kernel,
                          int per_tile) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (seg_oth != nullptr) {
    for (int t = t0 + warp; t < t1; t += kWarps) {
      int lo, hi;
      seg_range(seg_oth, t * kTile, n_oth, &lo, &hi);
      if (lane == 0) {
        tmin[t] = lo;
        tmax[t] = hi;
      }
    }
  }
  if (flag != nullptr)
    for (int t = threadIdx.x; t < nt; t += kThreads) flag[t] = 0;
  __syncthreads();
  if (warp == 0) {
    int count = 0;
    for (int base = t0; base < t1; base += 32) {
      const int t = base + lane;
      bool live = t < t1;
      if (live && seg_oth != nullptr)
        live = tmin[t] <= own[1] && own[0] <= tmax[t];
      const unsigned m = __ballot_sync(kFull, live);
      if (live) {
        list[count + __popc(m & ((1u << lane) - 1u))] = t;
        if (flag != nullptr) flag[t] = 1;
      }
      count += __popc(m);
    }
    if (lane == 0) {
      *shared_n = count;
      count_tiles(kernel, per_tile * count, per_tile * (t1 - t0 - count));
    }
  }
  __syncthreads();
  return *shared_n;
}

// Does every (row, key) of q tile [q0, q0 + 64) x k tile [k0, k0 + 64)
// pass the causal/window/range rule? (Segments are checked apart.)
__device__ __forceinline__ bool band_full(const FlashParams& p, int q0,
                                          int k0) {
  if (q0 + kTile > p.Tq || k0 + kTile > p.Tk) return false;
  if (!p.causal) return true;
  if (k0 + kTile - 1 > q0 + p.q_offset) return false;
  return p.window <= 0 || q0 + kTile - 1 + p.q_offset - k0 < p.window;
}

// Is every (row, key) of the tile pair visible: the band rule, and one
// segment id shared by both tiles?
__device__ __forceinline__ bool tile_full(const FlashParams& p, int q0,
                                          int k0, const int* qr,
                                          const int* kr) {
  if (!band_full(p, q0, k0)) return false;
  return p.seg_q == nullptr ||
         (qr[0] == qr[1] && kr[0] == kr[1] && qr[0] == kr[0]);
}

__device__ __forceinline__ float bias_at(const FlashParams& p, int b, int h,
                                         int qi, int kj) {
  return p.bias[b * p.bias_sb + h * p.bias_sh + (int64_t)qi * p.bias_sq +
                (int64_t)kj * p.bias_sk];
}

// ------------------------------------------------------------------ K2

// Shared memory: the tiles from a 1024-byte boundary (q, dO, then K, V
// per stage), the stages' segment ids, the tile list and ranges.
template <int D>
constexpr size_t dq_smem(int nk) {
  return 1024 + (size_t)(2 + 2 * kStages) * kTile * D * 2 +
         (size_t)kStages * kTile * 4 + (size_t)3 * nk * 4 + 16;
}

// The dynamic shared memory's first 1024-byte boundary (wgmma's swizzled
// operands are laid out from one), as a shared address and a pointer.
__device__ __forceinline__ uint32_t aligned_smem(unsigned char* smem,
                                                 unsigned char** ptr) {
  const uint32_t raw = smem_u32(smem), base = (raw + 1023u) & ~1023u;
  *ptr = smem + (base - raw);
  return base;
}

template <int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks<D>)
flash_dq_mma_kernel(const FlashParams p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr int kTileBytes = kTile * D * 2;
  constexpr int kStageBytes = 2 * kTileBytes;  // K, V
  const int nq = (p.Tq + kTile - 1) / kTile, nk = (p.Tk + kTile - 1) / kTile;
  unsigned char* base;
  const uint32_t s_q = aligned_smem(smem, &base), s_do = s_q + kTileBytes;
  const uint32_t s_stage = s_do + kTileBytes;
  int* seg_s = reinterpret_cast<int*>(base + (2 + 2 * kStages) * kTileBytes);
  int* list = seg_s + kStages * kTile;
  int* tmin = list + nk;
  int* tmax = tmin + nk;
  int* shared_n = tmax + nk;

  // the q tiles at the causal end (the longest loops) start first
  const int q0 = (nq - 1 - (int)blockIdx.x) * kTile;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (p.H / p.Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* dob =
      static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const int* segq = p.seg_q ? p.seg_q + b * p.segq_sb : nullptr;
  const int* segk = p.seg_k ? p.seg_k + b * p.segk_sb : nullptr;

  load_tile<D>(s_q, qb, p.q_st, q0, p.Tq);
  load_tile<D>(s_do, dob, p.do_st, q0, p.Tq);
  cp_commit();

  // This thread's two rows of the warp's 16: LSE (scaled to base 2),
  // delta and segment id.
  int qi[2], sq[2];
  float lse2[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qi[i] = q0 + 16 * warp + (lane >> 2) + 8 * i;
    const bool in = qi[i] < p.Tq;
    const int64_t row = ((int64_t)b * p.H + h) * p.Tq + qi[i];
    lse2[i] = in ? p.lse[row] * kLog2e : 0.f;
    delta[i] = in ? p.delta[row] : 0.f;
    sq[i] = in && segq ? segq[qi[i]] : 0;
  }

  int qr[2] = {0, 0};  // this q tile's segment range
  if (segq) seg_range(segq, q0, p.Tq, &qr[0], &qr[1]);
  int t0, t1;
  key_tiles(p, q0, &t0, &t1);
  const int n = plan_tiles(qr, segk, p.Tk, t0, t1, nk, list, tmin, tmax,
                           nullptr, shared_n, 0, 1);

  auto issue = [&](int i) {
    const int k0 = list[i] * kTile;
    const uint32_t st = s_stage + (i % kStages) * kStageBytes;
    load_tile<D>(st, kb, p.k_st, k0, p.Tk);
    load_tile<D>(st + kTileBytes, vb, p.v_st, k0, p.Tk);
    if (segk) load_vec(smem_u32(seg_s + (i % kStages) * kTile), segk, k0, p.Tk);
    cp_commit();
  };

  float dq[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
  const float scale2 = p.scale * kLog2e;

  if (n > 0) issue(0);
  for (int i = 0; i < n; ++i) {
    if (i + 1 < n) {
      issue(i + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    fence_async_smem();
    __syncthreads();
    const int t = list[i], k0 = t * kTile;
    const uint32_t s_k = s_stage + (i % kStages) * kStageBytes;
    const uint32_t s_v = s_k + kTileBytes;
    const int* sk = seg_s + (i % kStages) * kTile;

    // S and dP in two groups: P is formed while dP is still in flight
    float s[8][4] = {}, dp[8][4] = {};
    wg_fence();
    wg_abt<D>(s, s_q, s_k);
    wg_commit();
    wg_abt<D>(dp, s_do, s_v);
    wg_commit();
    wg_wait<1>();
    keep(s);
    const int kr[2] = {segk ? tmin[t] : 0, segk ? tmax[t] : 0};
    if (p.bias == nullptr && tile_full(p, q0, k0, qr, kr)) {
      // every entry visible (the bulk of the band)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[nt][e] = ex2(fmaf(s[nt][e], scale2, -lse2[e >> 1]));
    } else if (p.bias == nullptr) {  // a partial tile: the mask
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, c = 8 * nt + 2 * (lane & 3) + (e & 1);
          const bool ok =
              visible(p, qi[r], k0 + c, sq[r], segk ? sk[c] : 0);
          const float x = ex2(fmaf(s[nt][e], scale2, -lse2[r]));
          s[nt][e] = ok ? x : 0.f;
        }
    } else {  // the mask and the bias
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, c = 8 * nt + 2 * (lane & 3) + (e & 1);
          const bool ok =
              visible(p, qi[r], k0 + c, sq[r], segk ? sk[c] : 0);
          float x = s[nt][e] * scale2;
          if (ok) x += bias_at(p, b, h, qi[r], k0 + c) * kLog2e;
          s[nt][e] = ok ? ex2(x - lse2[r]) : 0.f;
        }
    }
    wg_wait<0>();
    keep(dp);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)  // dS
        s[nt][e] *= (dp[nt][e] - delta[e >> 1]) * p.scale;
    uint32_t a[4][4];
    to_a(a, s);
    wg_fence();
    wg_xb<D>(dq, a, s_k);
    wg_commit();
    wg_wait<0>();
    keep(dq);
    keep(a);
    __syncthreads();  // this stage is refilled two tiles on
  }
  cp_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qi[r] >= p.Tq) continue;
    float* out = p.dq + (((int64_t)b * p.Tq + qi[r]) * p.H + h) * D +
                 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(out + 8 * j) =
          make_float2(dq[j][2 * r], dq[j][2 * r + 1]);
  }
}

// ------------------------------------------------------------------ K3

// Shared memory: the tiles from a 1024-byte boundary (K, V, then q, dO
// per stage), the stages' LSE, delta and segment ids, the tile list,
// ranges and flags.
template <int D>
constexpr size_t dkv_smem(int nq) {
  return 1024 + (size_t)(2 + 2 * kStages) * kTile * D * 2 +
         (size_t)kStages * 3 * kTile * 4 + (size_t)4 * nq * 4 + 16;
}

template <int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks<D>)
flash_dkv_mma_kernel(const FlashParams p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr int kTileBytes = kTile * D * 2;
  constexpr int kStageBytes = 2 * kTileBytes;  // q, dO
  const int nq = (p.Tq + kTile - 1) / kTile;
  unsigned char* base;
  const uint32_t s_k = aligned_smem(smem, &base), s_v = s_k + kTileBytes;
  const uint32_t s_stage = s_v + kTileBytes;
  // per stage: LSE, delta, segment ids of its 64 q rows
  float* vec_s = reinterpret_cast<float*>(base + (2 + 2 * kStages) * kTileBytes);
  int* list = reinterpret_cast<int*>(vec_s + kStages * 3 * kTile);
  int* tmin = list + nq;
  int* tmax = tmin + nq;
  int* flag = tmax + nq;
  int* shared_n = flag + nq;

  const int k0 = blockIdx.x * kTile, hk = blockIdx.y, b = blockIdx.z;
  const int group = p.H / p.Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const int* segq = p.seg_q ? p.seg_q + b * p.segq_sb : nullptr;
  const int* segk = p.seg_k ? p.seg_k + b * p.segk_sb : nullptr;
  const bool want_dbias = p.dbias != nullptr;

  load_tile<D>(s_k, kb, p.k_st, k0, p.Tk);
  load_tile<D>(s_v, vb, p.v_st, k0, p.Tk);
  cp_commit();

  // This thread's two keys of the warp's 16, and their segment ids.
  int kj[2], sk[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    kj[i] = k0 + 16 * warp + (lane >> 2) + 8 * i;
    sk[i] = kj[i] < p.Tk && segk ? segk[kj[i]] : 0;
  }

  int kr[2] = {0, 0};  // this k tile's segment range
  if (segk) seg_range(segk, k0, p.Tk, &kr[0], &kr[1]);
  int t0, t1;
  query_tiles(p, k0, &t0, &t1);
  const int n = plan_tiles(kr, segq, p.Tq, t0, t1, nq, list, tmin, tmax,
                           want_dbias ? flag : nullptr, shared_n, 1, group);

  if (want_dbias) {
    // The dbias tiles of this k tile that no visited pair writes: zeros,
    // as the TPU kernel writes its dead tiles.
    for (int g = 0; g < group; ++g) {
      float* db = p.dbias + ((int64_t)b * p.H + hk * group + g) * p.Tq * p.Tk;
      for (int t = 0; t < nq; ++t) {
        if (flag[t]) continue;
        for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
          const int q = t * kTile + i / kTile, k = k0 + i % kTile;
          if (q < p.Tq && k < p.Tk) db[(int64_t)q * p.Tk + k] = 0.f;
        }
      }
    }
  }

  // One step per (q head of the group, visited q tile).
  const int steps = group * n;
  auto issue = [&](int j) {
    const int h = hk * group + j / n, q0 = list[j % n] * kTile;
    const uint32_t st = s_stage + (j % kStages) * kStageBytes;
    load_tile<D>(st, static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh,
                 p.q_st, q0, p.Tq);
    load_tile<D>(st + kTileBytes,
                 static_cast<const bf16*>(p.dout) + b * p.do_sb +
                     h * p.do_sh,
                 p.do_st, q0, p.Tq);
    const int64_t row = ((int64_t)b * p.H + h) * p.Tq;
    const uint32_t sv = smem_u32(vec_s + (j % kStages) * 3 * kTile);
    load_vec(sv, p.lse + row, q0, p.Tq);
    load_vec(sv + kTile * 4, p.delta + row, q0, p.Tq);
    if (segq) load_vec(sv + 2 * kTile * 4, segq, q0, p.Tq);
    cp_commit();
  };

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  const float scale2 = p.scale * kLog2e;

  if (steps > 0) issue(0);
  for (int j = 0; j < steps; ++j) {
    if (j + 1 < steps) {
      issue(j + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    fence_async_smem();
    __syncthreads();
    const int h = hk * group + j / n, t = list[j % n], q0 = t * kTile;
    const uint32_t s_q = s_stage + (j % kStages) * kStageBytes;
    const uint32_t s_do = s_q + kTileBytes;
    const float* lse = vec_s + (j % kStages) * 3 * kTile;
    const float* dlt = lse + kTile;
    const int* sq = reinterpret_cast<const int*>(dlt + kTile);

    // The transposed frame: rows are the CTA's keys, columns q rows. S^T
    // and dP^T in two groups; P^T is formed while dP^T is in flight, and
    // dv's product runs while dS^T is formed.
    float s[8][4] = {}, dp[8][4] = {};
    wg_fence();
    wg_abt<D>(s, s_k, s_q);
    wg_commit();
    wg_abt<D>(dp, s_v, s_do);
    wg_commit();
    wg_wait<1>();
    keep(s);
    const int qr[2] = {segq ? tmin[t] : 0, segq ? tmax[t] : 0};
    if (p.bias == nullptr && tile_full(p, q0, k0, qr, kr)) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float2 l = *reinterpret_cast<const float2*>(
            lse + 8 * nt + 2 * (lane & 3));
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[nt][e] = ex2(fmaf(s[nt][e], scale2, -(e & 1 ? l.y : l.x) * kLog2e));
      }
    } else if (p.bias == nullptr) {  // a partial tile: the mask
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, c = 8 * nt + 2 * (lane & 3) + (e & 1);
          const bool ok =
              visible(p, q0 + c, kj[r], segq ? sq[c] : 0, sk[r]);
          const float x = ex2(fmaf(s[nt][e], scale2, -lse[c] * kLog2e));
          s[nt][e] = ok ? x : 0.f;
        }
    } else {  // the mask and the bias
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, c = 8 * nt + 2 * (lane & 3) + (e & 1);
          const int qi = q0 + c;
          const bool ok =
              visible(p, qi, kj[r], segq ? sq[c] : 0, sk[r]);
          float x = s[nt][e] * scale2;
          if (ok) x += bias_at(p, b, h, qi, kj[r]) * kLog2e;
          s[nt][e] = ok ? ex2(x - lse[c] * kLog2e) : 0.f;
        }
    }
    uint32_t pa[4][4];
    to_a(pa, s);
    wg_fence();
    wg_xb<D>(dv, pa, s_do);  // dv += P^T dO
    wg_commit();
    wg_wait<1>();  // dP^T is ready; dv's product may still run
    keep(dp);
    if (want_dbias) {
      float* db = p.dbias + ((int64_t)b * p.H + h) * p.Tq * p.Tk;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, c = 8 * nt + 2 * (lane & 3) + (e & 1);
          const float ds = s[nt][e] * (dp[nt][e] - dlt[c]);
          if (q0 + c < p.Tq && kj[r] < p.Tk)
            db[(int64_t)(q0 + c) * p.Tk + kj[r]] = ds;  // before the scale
          dp[nt][e] = ds * p.scale;
        }
    } else {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float2 d = *reinterpret_cast<const float2*>(
            dlt + 8 * nt + 2 * (lane & 3));
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[nt][e] = s[nt][e] * (dp[nt][e] - (e & 1 ? d.y : d.x)) * p.scale;
      }
    }
    uint32_t da[4][4];
    to_a(da, dp);
    wg_fence();
    wg_xb<D>(dk, da, s_q);  // dk += dS^T q
    wg_commit();
    wg_wait<0>();
    keep(dv);
    keep(dk);
    keep(pa);
    keep(da);
    __syncthreads();  // this stage is refilled two steps on
  }
  cp_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kj[r] >= p.Tk) continue;
    const int64_t base =
        (((int64_t)b * p.Tk + kj[r]) * p.Hkv + hk) * D + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(p.dk + base + 8 * j) =
          make_float2(dk[j][2 * r], dk[j][2 * r + 1]);
      *reinterpret_cast<float2*>(p.dv + base + 8 * j) =
          make_float2(dv[j][2 * r], dv[j][2 * r + 1]);
    }
  }
}

// ------------------------------------------------------------------ host

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, dim3 grid,
                   const FlashParams& p, cudaStream_t stream) {
  // Above 48 KB a block may only use dynamic shared memory after this
  // opt-in (per device, so it is repeated on every launch).
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const FlashParams& p, cudaStream_t s) {
  const int nk = (p.Tk + kTile - 1) / kTile;
  const dim3 grid((p.Tq + kTile - 1) / kTile, p.H, p.B);
  return launch(flash_dq_mma_kernel<D>, dq_smem<D>(nk), grid, p, s);
}

template <int D>
cudaError_t launch_dkv(const FlashParams& p, cudaStream_t s) {
  const int nq = (p.Tq + kTile - 1) / kTile;
  const dim3 grid((p.Tk + kTile - 1) / kTile, p.Hkv, p.B);
  return launch(flash_dkv_mma_kernel<D>, dkv_smem<D>(nq), grid, p, s);
}

}  // namespace

cudaError_t flash_dq_bf16(const FlashParams& p, cudaStream_t s) {
  switch (p.D) {
    case 32:
      return launch_dq<32>(p, s);
    case 64:
      return launch_dq<64>(p, s);
    case 128:
      return launch_dq<128>(p, s);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t flash_dkv_bf16(const FlashParams& p, cudaStream_t s) {
  switch (p.D) {
    case 32:
      return launch_dkv<32>(p, s);
    case 64:
      return launch_dkv<64>(p, s);
    case 128:
      return launch_dkv<128>(p, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The counts of the tile skip since the last call, into out[4]: K2
// visited, K2 skipped, K3 visited, K3 skipped ((q tile, k tile, q head)
// triples of the band); resets them. Synchronous, on the current device.
extern "C" int flash_bwd_tile_counts(unsigned long long* out) {
  const cudaError_t err =
      cudaMemcpyFromSymbol(out, g_tile_counts, sizeof(g_tile_counts));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[4] = {};
  return (int)cudaMemcpyToSymbol(g_tile_counts, zero, sizeof(zero));
}
