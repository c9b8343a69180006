// K4's bf16 prefill on Hopper's tensor cores (sm_90a):
// paged_prefill_mma_kernel.
//
// Replaces the Pallas TPU kernel chainermn_tpu/ops/paged_decode.py::
// paged_flash_decode (body _decode_body :99) for the bf16 calls with more
// than 16 query rows per (slot, kv head) (R = T * group, row r = t *
// group + g) at head dim 32, 64 or 128: every prefill of serving, and a
// decode tick whose q-head group alone passes 16 rows. The decode rows
// (R <= 16) keep paged_decode_split_kernel (paged_decode_sm90.cu); fp32
// keeps paged_decode_kernel (paged_decode.cu).
//
// What bounds it: a (row, visible key) pair costs 4 D operations (S = Q
// K^T and O += P V), and a key's K and V are 4 D bytes, read once for
// every row that sees it. Most shapes are bounded by bytes (chip_smoke.py
// _k4_work): short prompts, windows, the decode ticks. A causal prefill
// from position 0 does ~T / 2 * group operations per K/V byte, so at T >=
// 512 with no window the bound is close to operations: at T 512, Hq = Hkv
// = 8, D 64, 0.27 us of operations against 0.63 us of bytes; at T 2048,
// 4.3 us of operations (989 TFLOP/s) against 2.5 us of bytes (3.35 TB/s).
// That is far above what CUDA cores give (paged_decode_kernel did fp32
// FMAs, one lane per key), so the products run on the tensor cores, and
// the design is K1's (flash_attention_fwd_sm90.cu), reading its K/V
// through the block table:
//
// - one CTA of one warpgroup (128 threads) per (64-row q tile, kv head,
//   slot); the q tiles at the causal end (the longest loops) start first.
//   The whole q-head group rides as rows of the tile, so each K/V tile is
//   read once for all of the group's heads;
// - the Q tile is copied with 16-byte cp.async into wgmma's swizzled
//   [64][D] layout (flash_attention_sm90.cuh); row r reads q[b, r / group,
//   h * group + r % group, :], and rows >= R are zero-filled;
// - K and V are gathered through the table, never through a dense view:
//   key kpos lives in physical block tables[b, kpos / bs] at offset kpos %
//   bs, its head slice strided by Hkv * D. Each 64-key tile is copied row
//   by row with 16-byte cp.async, so any block size works (a tile may span
//   several blocks or part of one), into a two-stage ring: the next tile's
//   copy is issued while this tile's S is computed. A key outside the
//   CTA's [kmin, kmax], or in the scratch block, is zero-filled (src-size
//   0), never read, and masked;
// - with one warpgroup on an SM nothing hides a long instruction stream,
//   so the copy's address arithmetic is done once per key, not once per
//   16-byte chunk: 64 threads plan a tile's key rows (block lookup,
//   division, pool offset, copied flag) into a three-slot ring in shared
//   memory two tiles ahead, while the tile before runs its P V product,
//   and the copy reads one offset per row (a first version that computed
//   every chunk's address in the copy took longer at every prefill shape,
//   PERF.md);
// - the causal/window tile skip: kmax is the qpos of the tile's last row
//   below R (clamped to the table, M * bs - 1), kmin the first row's qpos
//   - window + 1 (or 0), and only the key tiles meeting [kmin, kmax] are
//   visited. Each CTA adds the tiles it visited and those of the table it
//   skipped to counters on the card (paged_prefill_tile_counts reads
//   them; ops/paged_decode.py::_prefill_live_tiles is the rule);
// - S = Q K^T is wgmma m64n64k16 with both operands K-major; the online
//   softmax runs in base 2 with ex2 on the special-function unit, as in K1
//   (so ROADMAP section 3's open check on ex2.approx applies here too); P
//   goes to registers, rounded to bf16, as the A operand of O += P V, with
//   V read MN-major: nothing is transposed in memory;
// - a tile whose every entry is visible to every row (no causal edge, no
//   window edge, no key out of the table or in the scratch block) takes
//   the unmasked path; the others the masked one;
// - the epilogue writes O in bf16 to out[b, t, h * group + g, :]. No
//   atomics touch the output and every sum is taken in one order, so two
//   launches give the same bits.
//
// Later work: a split over the key range for short prompts (a T 512
// prefill is 64 CTAs on 132 SMs, each walking up to 8 key tiles alone),
// 128-row q tiles with two warpgroups, TMA in place of the cp.async rows
// where bs >= 64.
//
// Numerics follow _decode_body: s = (q . k, fp32 accumulators) * scale;
// masked s = NEG_INF (-1e30); p = mask ? exp(s - m_new) : 0 against the
// running max; l sums the fp32 p; P is rounded to bf16 before P V; a row
// whose l is 0 writes an exact 0.
//
// The host entry launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include "flash_attention_sm90.cuh"

namespace {

// (64-row q tile, 64-key tile, kv head) triples that the kernel visited
// ([0]) and skipped of the table's tiles ([1]) since the last
// paged_prefill_tile_counts on this device.
__device__ unsigned long long g_prefill_tile_counts[2];

// Clock64 probes of thread 0, by phase of the key-tile loop, for
// chainermn_tpu_torch/tools/k4_prefill_clocks.py: only a build with
// -DK4_PREFILL_CLOCKS (a library of its own) has them. Per CTA: cycles in
// the whole CTA, in its prologue, in the five phases summed over its
// tiles (the wait for a tile's copy, S, the issue of the next copy, the
// softmax, P V), and its key tiles.
#ifdef K4_PREFILL_CLOCKS
constexpr int kClockCtas = 4096;  // the first CTAs' clocks are kept
__device__ long long g_prefill_clocks[kClockCtas][8];
#define K4_CLOCK(t) const long long t = clock64()
#define K4_CLOCKED(...) __VA_ARGS__
#else
#define K4_CLOCK(t)
#define K4_CLOCKED(...)
#endif

struct PrefillParams {
  const bf16* q;         // [B, T, Hq, D]
  const bf16* k;         // [num_blocks, bs, Hkv, D]
  const bf16* v;
  const int* tables;     // [B, M]
  const int* positions;  // [B]
  bf16* out;             // [B, T, Hq, D]
  int T, Hq, Hkv, group, R, bs, M, window, scratch;
  float scale;
};

// Rows [r0, r0 + 64) of slot b's query rows for kv head h into a swizzled
// [64][D] tile: row r is token r / group, q head h * group + r % group.
// Rows at or past R are zero-filled.
template <int D>
__device__ __forceinline__ void load_q_rows(uint32_t dst,
                                            const PrefillParams& p, int b,
                                            int h, int r0) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int it = 0; it < kTile * kChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kChunks, c = i % kChunks, row = r0 + r;
    const bool ok = row < p.R;
    const bf16* g = p.q;
    if (ok)
      g += (((int64_t)b * p.T + row / p.group) * p.Hq + h * p.group +
            row % p.group) * D + c * 8;
    cp_async16(dst + tile_off<D>(r, c), g, ok);
  }
}

// Slots of the ring of key-row plans (offsets and flags): a tile's plan
// is made two tiles ahead of its products, read by its copy one tile
// ahead and by its mask with the tile.
constexpr int kPlanSlots = 3;

// The plan of keys [k0, k0 + 64) of one slot's table for kv head h, one
// key a thread (threads 0-63): off[r] is the element offset of key k0 + r
// in the pools, or -1 where the key lies outside [kmin, kmax] or in the
// scratch block (zero-filled, never read, masked); live[r] is 1 for a key
// that is copied. Each key's block lookup and division happen here once,
// not once per 16-byte chunk: with one warpgroup on an SM, the copy's
// address arithmetic is a serial instruction stream on the tile's path.
template <int D>
__device__ __forceinline__ void plan_keys(int64_t* off, unsigned char* live,
                                          const int* table,
                                          const PrefillParams& p, int h,
                                          int k0, int kmin, int kmax) {
  if (threadIdx.x >= kTile) return;
  const int kpos = k0 + threadIdx.x;
  bool ok = kpos >= kmin && kpos <= kmax;
  int64_t o = -1;
  if (ok) {
    const int j = kpos / p.bs;
    const int blk = table[j];
    ok = blk != p.scratch;
    o = (((int64_t)blk * p.bs + kpos - j * p.bs) * p.Hkv + h) * D;
  }
  off[threadIdx.x] = ok ? o : -1;
  live[threadIdx.x] = ok;
}

// One tile's K or V rows, gathered from a pool by a plan's offsets into a
// swizzled [64][D] tile (a row at offset -1 is zero-filled).
template <int D>
__device__ __forceinline__ void load_keys(uint32_t dst, const bf16* pool,
                                          const int64_t* off) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int it = 0; it < kTile * kChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kChunks, c = i % kChunks;
    const int64_t o = off[r];
    cp_async16(dst + tile_off<D>(r, c), o >= 0 ? pool + o + c * 8 : pool,
               o >= 0);
  }
}

// Shared memory: the tiles from a 1024-byte boundary (q, then K, V per
// stage), then the key-row plans' offsets and flags.
template <int D>
constexpr size_t prefill_smem() {
  return 1024 + (size_t)(1 + 2 * kStages) * kTile * D * 2 +
         (size_t)kPlanSlots * kTile * (sizeof(int64_t) + 1);
}

template <int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks<D>)
paged_prefill_mma_kernel(const PrefillParams p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr int kTileBytes = kTile * D * 2;
  constexpr int kStageBytes = 2 * kTileBytes;  // K, V
  const int nq = (p.R + kTile - 1) / kTile;
  unsigned char* base;
  const uint32_t s_q = aligned_smem(smem, &base);
  const uint32_t s_stage = s_q + kTileBytes;
  int64_t* off_s =
      reinterpret_cast<int64_t*>(base + (1 + 2 * kStages) * kTileBytes);
  unsigned char* live_s =
      reinterpret_cast<unsigned char*>(off_s + kPlanSlots * kTile);

  K4_CLOCK(c_entry);
  K4_CLOCKED(long long phase[5] = {});
  // the q tiles at the causal end (the longest loops) start first
  const int r0 = (nq - 1 - (int)blockIdx.x) * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int* table = p.tables + (int64_t)b * p.M;
  const int pos0 = p.positions[b];
  const int n_keys = p.M * p.bs;

  load_q_rows<D>(s_q, p, b, h, r0);
  cp_commit();

  // The keys some row of this tile can see, [kmin, kmax], and the key
  // tiles that meet them: t0 .. t0 + n - 1.
  const int q_first = pos0 + r0 / p.group;
  const int q_last = pos0 + (min(r0 + kTile, p.R) - 1) / p.group;
  const int kmax = min(q_last, n_keys - 1);
  const int kmin = p.window > 0 ? max(0, q_first - p.window + 1) : 0;
  const int t0 = kmin / kTile;
  const int n = kmax >= kmin ? kmax / kTile - t0 + 1 : 0;
  if (threadIdx.x == 0)
    count_tiles(g_prefill_tile_counts, n, (n_keys + kTile - 1) / kTile - n);

  // This thread's two rows of the warp's 16 and their positions.
  int qi[2], qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qi[i] = r0 + 16 * warp + (lane >> 2) + 8 * i;
    qpos[i] = pos0 + qi[i] / p.group;
  }

  auto plan = [&](int i) {  // tile i's key rows into plan slot i % 3
    plan_keys<D>(off_s + (i % kPlanSlots) * kTile,
                 live_s + (i % kPlanSlots) * kTile, table, p, h,
                 (t0 + i) * kTile, kmin, kmax);
  };
  auto issue = [&](int i) {  // tile i's copy into ring stage i % 2
    const uint32_t s_k = s_stage + (i % kStages) * kStageBytes;
    const int64_t* off = off_s + (i % kPlanSlots) * kTile;
    load_keys<D>(s_k, p.k, off);
    load_keys<D>(s_k + kTileBytes, p.v, off);
    cp_commit();
  };

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float scale2 = p.scale * kLog2e;

  if (n > 0) plan(0);
  if (n > 1) plan(1);
  __syncthreads();
  if (n > 0) issue(0);
  K4_CLOCK(c_loop);
  for (int i = 0; i < n; ++i) {
    K4_CLOCK(c0);
    cp_wait<0>();  // tile i (issued during tile i - 1's products)
    fence_async_smem();
    __syncthreads();
    K4_CLOCK(c1);
    const int k0 = (t0 + i) * kTile;
    const uint32_t s_k = s_stage + (i % kStages) * kStageBytes;
    const uint32_t s_v = s_k + kTileBytes;
    const unsigned char* live = live_s + (i % kPlanSlots) * kTile;

    float s[8][4] = {};
    wg_fence();
    wg_abt<D>(s, s_q, s_k);
    wg_commit();
    // tile i + 1's copy, while S is computed: its stage was last read by
    // tile i - 1's products, before the barrier that ended tile i - 1
    K4_CLOCK(c2);
    if (i + 1 < n) issue(i + 1);
    K4_CLOCK(c3);
    wg_wait<0>();
    keep(s);
    K4_CLOCK(c4);

    // Which of this thread's 16 keys were copied, at the bits of its
    // scores (4 nt + e: both rows of a column).
    uint32_t copied = 0;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = 8 * nt + 2 * (lane & 3);
      const uint32_t two = live[c] | (uint32_t)live[c + 1] << 1;
      copied |= (two | two << 2) << (4 * nt);
    }
    // every entry visible: no causal edge, no window edge, every key
    // copied (the warp's lanes hold all 64 columns between them)
    const bool full = k0 + kTile - 1 <= q_first &&
                      (p.window <= 0 || q_last - k0 < p.window) &&
                      __all_sync(kFull, copied == 0xffffffffu);
    if (full) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] *= scale2;
      softmax_step<D, false>(s, 0u, m, l, o);
    } else {
      uint32_t ok = 0;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int kpos = k0 + 8 * nt + 2 * (lane & 3) + (e & 1);
          const bool vis = ((copied >> (4 * nt + e)) & 1u) & (qi[r] < p.R) &
                           (kpos <= qpos[r]) &
                           ((p.window <= 0) | (qpos[r] - kpos < p.window));
          ok |= (uint32_t)vis << (4 * nt + e);
          s[nt][e] = vis ? s[nt][e] * scale2 : kNegInf;
        }
      softmax_step<D, true>(s, ok, m, l, o);
    }
    K4_CLOCK(c5);
    uint32_t a[4][4];
    to_a(a, s);
    wg_fence();
    wg_xb<D>(o, a, s_v);  // O += P V
    wg_commit();
    // tile i + 2's plan, while the product runs: its slot was last read
    // by tile i - 1's mask, before the barrier that ended tile i - 1
    if (i + 2 < n) plan(i + 2);
    wg_wait<0>();
    keep(o);
    keep(a);
    __syncthreads();  // this stage is refilled two tiles on
    K4_CLOCKED({
      const long long c6 = clock64();
      phase[0] += c1 - c0;
      phase[1] += c4 - c1 - (c3 - c2);
      phase[2] += c3 - c2;
      phase[3] += c5 - c4;
      phase[4] += c6 - c5;
    });
  }
  cp_wait<0>();

  float lt[2];  // the row sums, over the four lanes that hold a row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lt[r] = l[r] + __shfl_xor_sync(kFull, l[r], 1);
    lt[r] += __shfl_xor_sync(kFull, lt[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qi[r] >= p.R) continue;
    const bool any = lt[r] > 0.f;  // else every key masked: an exact 0
    bf16* out = p.out +
                (((int64_t)b * p.T + qi[r] / p.group) * p.Hq + h * p.group +
                 qi[r] % p.group) * D + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
          any ? __floats2bfloat162_rn(o[j][2 * r] / lt[r],
                                      o[j][2 * r + 1] / lt[r])
              : __floats2bfloat162_rn(0.f, 0.f);
  }
  K4_CLOCKED({
    const int cta = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
                    blockIdx.x;
    if (threadIdx.x == 0 && cta < kClockCtas) {
      long long* c = g_prefill_clocks[cta];
      c[0] = clock64() - c_entry;
      c[1] = c_loop - c_entry;
      for (int k = 0; k < 5; ++k) c[2 + k] = phase[k];
      c[7] = n;
    }
  });
}

template <int D>
cudaError_t launch_prefill(const PrefillParams& p, int B,
                           cudaStream_t stream) {
  auto kernel = paged_prefill_mma_kernel<D>;
  constexpr size_t smem = prefill_smem<D>();
  // Above 48 KB a block may only use dynamic shared memory after this
  // opt-in (per device, so it is repeated on every launch).
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.R + kTile - 1) / kTile, p.Hkv, B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// bf16 only. window <= 0 means no window; scratch_block < 0 disables the
// scratch mask. Tensors are contiguous: q/out [B, n_tok, Hq, D], pools
// [num_blocks, bs, Hkv, D] (16-byte aligned), tables [B, M] int32,
// positions [B] int32; q 16-byte aligned.
extern "C" int paged_flash_prefill_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* tables, const void* positions, void* out, int B, int n_tok,
    int Hq, int Hkv, int D, int bs, int M, int window, float scale,
    int scratch_block, void* stream) {
  PrefillParams p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k_pool);
  p.v = static_cast<const bf16*>(v_pool);
  p.tables = static_cast<const int*>(tables);
  p.positions = static_cast<const int*>(positions);
  p.out = static_cast<bf16*>(out);
  p.T = n_tok;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.group = Hq / Hkv;
  p.R = n_tok * p.group;
  p.bs = bs;
  p.M = M;
  p.window = window;
  p.scratch = scratch_block;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return (int)launch_prefill<32>(p, B, s);
    case 64:
      return (int)launch_prefill<64>(p, B, s);
    case 128:
      return (int)launch_prefill<128>(p, B, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

#ifdef K4_PREFILL_CLOCKS
// The probes of the last launch, into out[kClockCtas][8] (see
// g_prefill_clocks). Synchronous, on the current device.
extern "C" int paged_prefill_clocks(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_prefill_clocks,
                                   sizeof(g_prefill_clocks));
}
#endif

// The prefill kernel's tile counts since the last call, into out[2]:
// visited, skipped ((q tile, key tile, kv head) triples of the table);
// resets them. Synchronous, on the current device.
extern "C" int paged_prefill_tile_counts(unsigned long long* out) {
  const cudaError_t err = cudaMemcpyFromSymbol(
      out, g_prefill_tile_counts, sizeof(g_prefill_tile_counts));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[2] = {};
  return (int)cudaMemcpyToSymbol(g_prefill_tile_counts, zero, sizeof(zero));
}
