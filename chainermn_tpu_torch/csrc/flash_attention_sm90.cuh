// What the bf16 attention kernels on Hopper's tensor cores share
// (flash_attention_fwd_sm90.cu: K1; flash_attention_bwd_sm90.cu: K2 and
// K3; paged_prefill_sm90.cu: K4's prefill): the swizzled tile layout and
// wgmma's matrix descriptors, the wgmma and cp.async wrappers, the tile
// loads, the online-softmax step, and the segment-aware tile skip with
// its band rules. Each source that includes it keeps its own counters of
// the skip on the card (each library builds one object per source,
// without relocatable device code, so a __device__ variable cannot be
// shared between them) and hands plan_tiles or count_tiles the row to
// add to.

#pragma once

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

// Adds the tiles a CTA visited and skipped to a kernel's counters on the
// card: counts[0] visited, counts[1] skipped.
__device__ __forceinline__ void count_tiles(unsigned long long* counts,
                                            int visited, int skipped) {
  atomicAdd(&counts[0], (unsigned long long)visited);
  atomicAdd(&counts[1], (unsigned long long)skipped);
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

// One key tile's step of the online softmax (K1, K4's prefill). s holds
// the tile's scores in base-2 units (masked entries NEG_INF; with
// kMasked, bit 4 nt + e of ok is clear where s[nt][e] is masked). The rows' running max m moves on,
// this thread's part of each row sum l and the accumulators o are
// rescaled, and s becomes p = mask ? 2^(s - m) : 0.
template <int D, bool kMasked>
__device__ __forceinline__ void softmax_step(float (&s)[8][4], uint32_t ok,
                                             float (&m)[2], float (&l)[2],
                                             float (&o)[D / 8][4]) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
  float corr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // the four lanes that hold a row
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
    corr[r] = ex2(m[r] - mx[r]);  // 1 while the row has seen no key
    m[r] = mx[r];
    l[r] *= corr[r];
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = ex2(s[nt][e] - mx[e >> 1]);
      s[nt][e] = !kMasked || ((ok >> (4 * nt + e)) & 1u) ? x : 0.f;
      l[e >> 1] += s[nt][e];
    }
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] *= corr[e >> 1];
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
// per_tile x the tiles visited and skipped to counts[0] and counts[1] --
// here, where the count is at hand: adding it in the kernel's body after
// the plan doubled K3's register spills (ptxas -v) and slowed K3.
// Returns the count, after a __syncthreads.
__device__ int plan_tiles(const int own[2], const int* seg_oth, int n_oth,
                          int t0, int t1, int nt, int* list, int* tmin,
                          int* tmax, int* flag, int* shared_n,
                          unsigned long long* counts, int per_tile) {
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
      count_tiles(counts, per_tile * count, per_tile * (t1 - t0 - count));
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

// The dynamic shared memory's first 1024-byte boundary (wgmma's swizzled
// operands are laid out from one), as a shared address and a pointer.
__device__ __forceinline__ uint32_t aligned_smem(unsigned char* smem,
                                                 unsigned char** ptr) {
  const uint32_t raw = smem_u32(smem), base = (raw + 1023u) & ~1023u;
  *ptr = smem + (base - raw);
  return base;
}

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

}  // namespace
