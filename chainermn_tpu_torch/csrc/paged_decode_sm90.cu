// Paged flash decoding of bf16 decode rows for Hopper (sm_90a): split-K
// over the block table, a cp.async ring of bf16 K/V tiles, and a merge of
// the splits in a fixed order.
//
// Replaces the Pallas TPU kernel chainermn_tpu/ops/paged_decode.py::
// paged_flash_decode (body _decode_body :99) for the calls that decode:
// bf16, at most 16 query rows per (slot, kv head) (R = T * group rows,
// row r = t * group + g), head dim 32, 64 or 128. Prefill (R > 16) and
// fp32 stay on paged_decode_kernel (paged_decode.cu).
//
// What bounds it: HBM bytes. A row does 4 * D operations per key while
// the key's K and V are 4 * D bytes, so a CTA does about `group`
// operations per byte read, far below the ~295 at which an H100 stops
// being memory-bound: the least time is the live K/V read once over the
// memory rate. What stood between paged_decode_kernel and that bound was
// latency: one CTA per (row tile, kv head, slot) (128 CTAs at the 16-slot
// decode tick, 32 under GQA) walked a whole row's keys with no load in
// flight across its chunk steps. The design here:
//
// - split-K: one CTA per (split s, kv head h, slot b), split s covering
//   logical blocks [s * P, (s + 1) * P) of row b's table, so a decode
//   tick puts ~1000 CTAs on 132 SMs (the wrapper's _split_plan picks P
//   from B, Hkv, M and bs alone: no read of positions on the host). A CTA
//   reads positions[b] and its table entries itself; when none of its
//   blocks is live (inside the rows' [kmin, kmax] band and not the
//   scratch block) it writes an empty partial (m = NEG_INF, l = 0) and
//   exits, so the splits of a short context cost a launch slot each;
// - no barrier in the loop: each of the CTA's four warps runs its own
//   pipeline over the split's live 64-key tiles, taking the same 16-key
//   quarter of each, with its own online-softmax state; the four states
//   meet once, at the end, in warp order. A CTA's latency is then its
//   live tiles times one warp's short step, not times three CTA barriers;
// - loads in flight: each warp copies its keys' K and V head slices
//   (rows strided by Hkv * D) into its own shared-memory ring of three
//   stages (two at D 128) with 16-byte cp.async, so two chunks are in
//   flight while one is computed. The ring stays bf16 (4 KB a stage at D
//   64); a key outside the band or in the scratch block is zero-filled by
//   the copy (src-size 0), never read, and masked;
// - q . k spreads each key row over D / 8 lanes (8 bf16 each, one 16-byte
//   shared load) and folds the rows' partial sums across those lanes by
//   halves (a reduce-scatter of shuffles), instead of one lane per key
//   reading a padded fp32 row;
// - the online softmax runs per row in a half-warp, a key per lane; P is
//   rounded to bf16 before P V and the accumulators are fp32
//   (_decode_body's numerics: masked scores NEG_INF = -1e30, p = mask ?
//   exp(s - m_new) : 0, l sums the unrounded p); P V gives each lane D /
//   32 head dims of every row;
// - the merge (paged_decode_merge_kernel, a second launch) reads the
//   splits' (m, l, acc) in split order, rescales each by exp(m_s - m_max)
//   and writes O in bf16; a row whose total l is 0 writes an exact 0. It
//   is launched as a programmatic dependent of the split kernel, so its
//   launch overlaps the split kernel's last CTAs. No atomics anywhere, so
//   two launches on the same inputs give the same bits.
//
// The host entry launches both kernels on the caller's stream, allocates
// nothing (the wrapper passes the fp32 partials) and returns the first
// CUDA error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 64;    // keys per ring stage (a tile)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void widen8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// Folds N per-row partial sums across the lanes of a group that differ in
// bits O, O / 2, ..., 1 of g: while a lane holds more than one row, it
// keeps half of them (the upper half when its bit O is set) and adds the
// partner's copy of that half; once it holds one row the rest is a plain
// xor-sum. Afterwards v[0 .. max(1, N / (2 O))) are whole sums of rows
// fold_base<N, O>(g), fold_base<N, O>(g) + 1, ...
template <int N, int O>
__device__ __forceinline__ void fold_rows(float* v, int g) {
  if constexpr (O >= 1) {
    if constexpr (N > 1) {
      constexpr int H = N / 2;
      const bool up = (g & O) != 0;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = up ? v[i] : v[i + H];
        const float keep = up ? v[i + H] : v[i];
        v[i] = keep + __shfl_xor_sync(kFull, send, O);
      }
      fold_rows<H, O / 2>(v, g);
    } else {
      v[0] += __shfl_xor_sync(kFull, v[0], O);
      fold_rows<1, O / 2>(v, g);
    }
  }
}

// The first row whose whole sum fold_rows<N, O> leaves in a lane of the
// group: the same for every pass, so it is computed once.
template <int N, int O>
__device__ __forceinline__ int fold_base(int g) {
  if constexpr (O >= 1 && N > 1)
    return ((g & O) ? N / 2 : 0) + fold_base<N / 2, O / 2>(g);
  else
    return 0;
}

// Each warp runs its own pipeline over the CTA's live tiles: it takes the
// same 16-key quarter of every tile, so the loop has no CTA barrier.
constexpr int kWarpKeys = kKeys / kWarps;
// Ring stages per warp: 3 (4 KB each at head dim 64), 2 at 128, so that
// four CTAs fit on an SM at head dim 64 and three at 128.
template <int D>
constexpr int kStages = D == 128 ? 2 : 3;

// Shared memory of one split CTA, in this order: each warp's ring
// (kStages x [K | V], kWarpKeys x D bf16 each), each warp's scores then
// P [ROWS][kWarpKeys] fp32 and corrections [ROWS] (padded to 16 bytes),
// each warp's per-key "loaded" flags [kStages][kWarpKeys], the split's
// table entries [P] (-1 = not live), and the count and indices of its
// live tiles.
template <int D, int ROWS>
struct SplitSmem {
  static constexpr int kStagesD = kStages<D>;
  static constexpr int kWarpRing = kStagesD * 2 * kWarpKeys * D;  // bf16
  static constexpr int kWarpP = ROWS * kWarpKeys + (ROWS + 3) / 4 * 4;
  static constexpr size_t kPOff = sizeof(bf16) * kWarps * kWarpRing;
  static constexpr size_t kLoadedOff = kPOff + sizeof(float) * kWarps * kWarpP;
  static constexpr size_t kFixed = kLoadedOff + kWarps * kStagesD * kWarpKeys;
};

__host__ __device__ inline int split_max_tiles(int P, int bs) {
  return (P * bs + kKeys - 1) / kKeys + 1;
}

template <int D, int ROWS>
size_t split_smem_bytes(int P, int bs) {
  return SplitSmem<D, ROWS>::kFixed +
         sizeof(int) * (P + split_max_tiles(P, bs) + 1);
}

// The rest of the CTA's grid may start: the merge launched after this
// kernel waits in griddep_wait for all of it to finish.
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

template <int D, int ROWS>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k_pool,
                          const bf16* __restrict__ v_pool,
                          const int* __restrict__ tables,
                          const int* __restrict__ positions,
                          float* __restrict__ part_ml,
                          float* __restrict__ part_acc, int n_tok, int Hq,
                          int Hkv, int group, int bs, int M, int P,
                          int window, float scale, int scratch) {
  static_assert(D == 32 || D == 64 || D == 128, "head dim 32, 64 or 128");
  constexpr int S = kStages<D>;
  constexpr int WK = kWarpKeys;
  constexpr int LPK = D / 8;               // lanes per key row in q . k
  constexpr int KPW = 32 / LPK;            // keys per warp pass
  constexpr int RPL = ROWS >= LPK ? ROWS / LPK : 1;  // rows a lane sums
  constexpr int CPR = D / 8;               // 16-byte chunks per K/V row
  constexpr int DPL = D / 32;              // head dims per lane in P V
  constexpr int RH = (ROWS + 1) / 2;       // softmax rows per half-warp
  static_assert(WK == 16 && WK % KPW == 0, "a half-warp per softmax row");

  typedef SplitSmem<D, ROWS> L;
  griddep_launch_dependents();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  bf16* ring = reinterpret_cast<bf16*>(smem_raw) + warp * L::kWarpRing;
  float* sp = reinterpret_cast<float*>(smem_raw + L::kPOff) + warp * L::kWarpP;
  float* corr_s = sp + ROWS * WK;
  unsigned char* loaded = smem_raw + L::kLoadedOff + warp * S * WK;
  int* tbl_s = reinterpret_cast<int*>(smem_raw + L::kFixed);
  int* tiles_s = tbl_s + P;  // [0] = count, then the live tiles

  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int R = n_tok * group;
  const size_t cell = ((size_t)b * Hkv + h) * n_splits + s;
  float* ml = part_ml + cell * R * 2;

  // The position, the split's table entries and q are loaded together.
  const int split_lo = s * P * bs;
  const int nblk = min(P, M - s * P);
  int entry[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = tid + i * kThreads;
    entry[i] = j < nblk ? tables[(size_t)b * M + s * P + j] : scratch;
  }
  const int g = lane % LPK;
  float qr[ROWS][8];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r < R) {
      const int t = r / group, gg = r % group;
      widen8(*reinterpret_cast<const uint4*>(
                 q + ((size_t)(b * n_tok + t) * Hq + h * group + gg) * D +
                 g * 8),
             qr[r]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) qr[r][e] = 0.f;
    }
  }
  const int pos0 = positions[b];

  // This split's keys [split_lo, split_hi] and the rows' band: the last
  // row's position, clamped to the table horizon, and the first row's
  // window.
  const int split_hi = split_lo + nblk * bs - 1;
  const int kmax = min(pos0 + n_tok - 1, M * bs - 1);
  const int kmin = window > 0 ? max(0, pos0 - window + 1) : 0;
  const int lo = max(split_lo, kmin), hi = min(split_hi, kmax);
  auto keep = [&](int j, int e) {  // block j is live: in band, not scratch
    const int first = split_lo + j * bs;
    tbl_s[j] = (first <= hi && first + bs - 1 >= lo && e != scratch) ? e : -1;
  };
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (tid + i * kThreads < nblk) keep(tid + i * kThreads, entry[i]);
  for (int j = tid + 4 * kThreads; j < nblk; j += kThreads)
    keep(j, tables[(size_t)b * M + s * P + j]);
  __syncthreads();
  // 64-key tiles from the one holding lo; warp 0 keeps, in order, those
  // with a live block.
  const int key_base = split_lo + (lo - split_lo) / kKeys * kKeys;
  if (warp == 0) {
    const int n_tiles = lo <= hi ? (hi - key_base) / kKeys + 1 : 0;
    int n = 0;
    for (int t0 = 0; t0 < n_tiles; t0 += 32) {
      const int t = t0 + lane;
      bool live = false;
      if (t < n_tiles) {
        const int a = max(lo, key_base + t * kKeys);
        const int z = min(hi, key_base + t * kKeys + kKeys - 1);
        for (int j = (a - split_lo) / bs; j <= (z - split_lo) / bs; ++j)
          live |= tbl_s[j] >= 0;
      }
      const unsigned mask = __ballot_sync(kFull, live);
      if (live) tiles_s[1 + n + __popc(mask & ((1u << lane) - 1))] = t;
      n += __popc(mask);
    }
    if (lane == 0) tiles_s[0] = n;
  }
  __syncthreads();
  const int n_live = tiles_s[0];
  if (n_live == 0) {  // an empty partial: the merge reads no acc for it
    for (int r = tid; r < R; r += kThreads) {
      ml[2 * r] = kNegInf;
      ml[2 * r + 1] = 0.f;
    }
    return;
  }

  // This warp's 16 keys of live tile i into its stage `stage`; a key
  // outside the band or in the scratch block is zero-filled, not read.
  // When one block holds the chunk's keys in the band (always when bs is
  // a multiple of 16) its entry and first row are looked up once.
  auto issue = [&](int i, int stage) {
    const int c0 = key_base + tiles_s[1 + i] * kKeys + warp * WK;
    const int a = max(c0, lo), z = min(c0 + WK - 1, hi);
    const bool one = a > z || (a - split_lo) / bs == (z - split_lo) / bs;
    int e0 = -1, row0 = 0;
    if (a <= z && one) {
      const int j = (a - split_lo) / bs;
      e0 = tbl_s[j];
      row0 = c0 - split_lo - j * bs;
    }
    bf16* ks = ring + stage * 2 * WK * D;
    bf16* vs = ks + WK * D;
#pragma unroll
    for (int c = lane; c < WK * CPR; c += 32) {
      const int kk = c / CPR, part = c % CPR;
      const int key = c0 + kk;
      const bool in_band = key >= lo && key <= hi;
      int e = -1, row = row0 + kk;
      if (one) {
        if (in_band) e = e0;
      } else if (in_band) {
        const int j = (key - split_lo) / bs;
        e = tbl_s[j];
        row = key - split_lo - j * bs;
      }
      const bool ok = e >= 0;
      const size_t off =
          ok ? (((size_t)e * bs + row) * Hkv + h) * D + part * 8 : 0;
      cp_async16(ks + kk * D + part * 8, k_pool + off, ok);
      cp_async16(vs + kk * D + part * 8, v_pool + off, ok);
      if (part == 0) loaded[stage * WK + kk] = ok;
    }
  };

  // A key is visible to a row at position qpos (-1 for a padding row):
  // loaded, causal, inside the window. Each lane's rows' positions are
  // fixed for the whole kernel: those it writes scores for, and those
  // of its softmax rows.
  auto visible = [&](int qpos, int key, bool ok) {
    return ok && key <= qpos && (window <= 0 || key > qpos - window);
  };
  auto row_pos = [&](int r) { return r < R ? pos0 + r / group : -1; };
  const int base = fold_base<ROWS, LPK / 2>(g);
  int qpos_w[RPL], qpos_s[RH];
#pragma unroll
  for (int j = 0; j < RPL; ++j) qpos_w[j] = row_pos(base + j);
#pragma unroll
  for (int i2 = 0; i2 < RH; ++i2) qpos_s[i2] = row_pos(lane / 16 + 2 * i2);

  float m_row[RH], l_row[RH];
#pragma unroll
  for (int i = 0; i < RH; ++i) {
    m_row[i] = kNegInf;
    l_row[i] = 0.f;
  }
  float acc[ROWS][DPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[r][j] = 0.f;

#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    if (st < n_live) issue(st, st);
    cp_async_commit();
  }

  for (int i = 0; i < n_live; ++i) {
    cp_async_wait<S - 2>();
    __syncwarp();  // chunk i landed; chunk i - 1 is no longer read
    if (i + S - 1 < n_live) issue(i + S - 1, (i + S - 1) % S);
    cp_async_commit();
    const int stage = i % S;
    const bf16* ks = ring + stage * 2 * WK * D;
    const bf16* vs = ks + WK * D;
    const unsigned char* ld = loaded + stage * WK;
    const int key0 = key_base + tiles_s[1 + i] * kKeys + warp * WK;

    // Scores: LPK lanes per key, the rows folded across them.
#pragma unroll
    for (int pass = 0; pass < WK / KPW; ++pass) {
      const int kk = pass * KPW + lane / LPK;
      float kf[8];
      widen8(*reinterpret_cast<const uint4*>(ks + kk * D + g * 8), kf);
      float v[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) a += qr[r][e] * kf[e];
        v[r] = a;
      }
      fold_rows<ROWS, LPK / 2>(v, g);
      const bool writer = ROWS >= LPK || (g & (LPK / ROWS - 1)) == 0;
      if (writer) {
        const int key = key0 + kk;
        const bool ok = ld[kk];
#pragma unroll
        for (int j = 0; j < RPL; ++j)
          sp[(base + j) * WK + kk] =
              visible(qpos_w[j], key, ok) ? v[j] * scale : kNegInf;
      }
    }
    __syncwarp();

    // Online softmax: a half-warp per row, a key per lane; P in place.
    const int k = lane % 16;
    const bool ok_k = ld[k];
#pragma unroll
    for (int i2 = 0; i2 < RH; ++i2) {
      const int r = lane / 16 + 2 * i2;
      const bool ok = visible(qpos_s[i2], key0 + k, ok_k);
      const float sc = r < ROWS ? sp[r * WK + k] : kNegInf;
      float mx = sc;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_new = fmaxf(m_row[i2], mx);
      // Guard fully masked rows: with every score NEG_INF,
      // exp(s - m_new) would be exp(0) = 1 per entry.
      const float p = ok ? expf(sc - m_new) : 0.f;
      const float corr = expf(m_row[i2] - m_new);
      float ps = p;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) ps += __shfl_xor_sync(kFull, ps, o);
      l_row[i2] = l_row[i2] * corr + ps;
      m_row[i2] = m_new;
      if (r < ROWS) {
        sp[r * WK + k] = __bfloat162float(__float2bfloat16(p));
        if (k == 0) corr_s[r] = corr;
      }
    }
    __syncwarp();

    // P V: head dims [lane * DPL, lane * DPL + DPL) of every row.
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float c = corr_s[r];
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[r][j] *= c;
    }
#pragma unroll
    for (int k4 = 0; k4 < WK; k4 += 4) {
      float vv[4][DPL];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const bf16* src = vs + (k4 + u) * D + lane * DPL;
        if constexpr (DPL == 1) {
          vv[u][0] = __bfloat162float(*src);
        } else if constexpr (DPL == 2) {
          const float2 f =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src));
          vv[u][0] = f.x;
          vv[u][1] = f.y;
        } else {
          const uint2 w = *reinterpret_cast<const uint2*>(src);
          const float2 f0 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&w.x));
          const float2 f1 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&w.y));
          vv[u][0] = f0.x;
          vv[u][1] = f0.y;
          vv[u][2] = f1.x;
          vv[u][3] = f1.y;
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 pr = *reinterpret_cast<const float4*>(sp + r * WK + k4);
#pragma unroll
        for (int j = 0; j < DPL; ++j)
          acc[r][j] += pr.x * vv[0][j] + pr.y * vv[1][j] + pr.z * vv[2][j] +
                       pr.w * vv[3][j];
      }
    }
  }

  // The warps' states meet in shared memory (the rings, now idle) and
  // merge in warp order, as the merge kernel merges the splits.
  cp_async_wait<0>();
  __syncthreads();
  float* wacc = reinterpret_cast<float*>(smem_raw);  // [kWarps][ROWS][D]
  float* wml = wacc + kWarps * ROWS * D;             // [kWarps][ROWS][2]
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < DPL; ++j)
      wacc[(warp * ROWS + r) * D + lane * DPL + j] = acc[r][j];
#pragma unroll
  for (int i2 = 0; i2 < RH; ++i2) {
    const int r = lane / 16 + 2 * i2;
    if (r < ROWS && lane % 16 == 0) {
      wml[(warp * ROWS + r) * 2] = m_row[i2];
      wml[(warp * ROWS + r) * 2 + 1] = l_row[i2];
    }
  }
  __syncthreads();
  float* acc_out = part_acc + cell * R * D;
  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wml[(w * ROWS + r) * 2]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float l = wml[(w * ROWS + r) * 2 + 1];
      if (l > 0.f) {
        const float f = expf(wml[(w * ROWS + r) * 2] - mx);
        lsum += l * f;
        a += wacc[w * ROWS * D + i] * f;
      }
    }
    acc_out[i] = a;
    if (i % D == 0) {
      ml[2 * r] = mx;
      ml[2 * r + 1] = lsum;
    }
  }
}

// One CTA per (row, kv head, slot), one thread per head dim: the splits'
// partials in split order. It starts while the split kernel finishes
// (programmatic dependent launch) and waits for all of it before reading.
template <int D>
__global__ void __launch_bounds__(D)
paged_decode_merge_kernel(const float* __restrict__ part_ml,
                          const float* __restrict__ part_acc,
                          bf16* __restrict__ out, int n_tok, int Hq,
                          int Hkv, int group, int n_splits) {
  extern __shared__ float ml_s[];  // [n_splits][2]: each split's (m, l)
  const int r = blockIdx.x, h = blockIdx.y, b = blockIdx.z, d = threadIdx.x;
  const int R = gridDim.x;
  const size_t cell0 = ((size_t)b * Hkv + h) * n_splits;
  griddep_wait();
  for (int s = d; s < n_splits; s += D) {
    ml_s[2 * s] = part_ml[((cell0 + s) * R + r) * 2];
    ml_s[2 * s + 1] = part_ml[((cell0 + s) * R + r) * 2 + 1];
  }
  __syncthreads();
  float mx = kNegInf;
  for (int s = 0; s < n_splits; ++s) mx = fmaxf(mx, ml_s[2 * s]);
  float lsum = 0.f, a = 0.f;
#pragma unroll 4
  for (int s = 0; s < n_splits; ++s) {
    const float l = ml_s[2 * s + 1];
    if (l > 0.f) {  // an empty split wrote no acc
      const float f = expf(ml_s[2 * s] - mx);
      lsum += l * f;
      a += part_acc[((cell0 + s) * R + r) * D + d] * f;
    }
  }
  // Fully masked rows (padding, released slots) emit exact 0.
  const float o = lsum > 0.f ? a / fmaxf(lsum, 1e-37f) : 0.f;
  const int t = r / group, g = r % group;
  out[((size_t)(b * n_tok + t) * Hq + h * group + g) * D + d] =
      __float2bfloat16(o);
}

template <int D, int ROWS>
cudaError_t launch_split(const void* q, const void* k_pool,
                         const void* v_pool, const void* tables,
                         const void* positions, void* out, float* part,
                         int B, int n_tok, int Hq, int Hkv, int bs, int M,
                         int P, int n_splits, int window, float scale,
                         int scratch, cudaStream_t stream) {
  auto kernel = paged_decode_split_kernel<D, ROWS>;
  const size_t smem = split_smem_bytes<D, ROWS>(P, bs);
  // Above 48 KB a block may only use dynamic shared memory after this
  // opt-in (per device, so it is repeated on every launch).
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int group = Hq / Hkv;
  const int R = n_tok * group;
  float* part_ml = part;
  float* part_acc = part + (size_t)B * Hkv * n_splits * R * 2;
  kernel<<<dim3(n_splits, Hkv, B), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_pool),
      static_cast<const bf16*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(positions), part_ml, part_acc, n_tok, Hq, Hkv,
      group, bs, M, P, window, scale, scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // The merge may be scheduled as the split kernel's last CTAs run; it
  // waits for the whole grid (griddep_wait) before reading the partials.
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(R, Hkv, B);
  cfg.blockDim = dim3(D);
  cfg.dynamicSmemBytes = sizeof(float) * 2 * n_splits;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, paged_decode_merge_kernel<D>,
                           static_cast<const float*>(part_ml),
                           static_cast<const float*>(part_acc),
                           static_cast<bf16*>(out), n_tok, Hq, Hkv, group,
                           n_splits);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_split_rows(const void* q, const void* k_pool,
                              const void* v_pool, const void* tables,
                              const void* positions, void* out, float* part,
                              int B, int n_tok, int Hq, int Hkv, int bs,
                              int M, int P, int n_splits, int window,
                              float scale, int scratch, cudaStream_t stream) {
  // Rows of the CTA's q tile: R rounded up to a power of two.
  const int R = n_tok * (Hq / Hkv);
#define PD_SPLIT_ROWS(N)                                                  \
  if (R <= N)                                                             \
    return launch_split<D, N>(q, k_pool, v_pool, tables, positions, out,  \
                              part, B, n_tok, Hq, Hkv, bs, M, P, n_splits, \
                              window, scale, scratch, stream);
  PD_SPLIT_ROWS(1)
  PD_SPLIT_ROWS(2)
  PD_SPLIT_ROWS(4)
  PD_SPLIT_ROWS(8)
  PD_SPLIT_ROWS(16)
#undef PD_SPLIT_ROWS
  return cudaErrorInvalidValue;
}

}  // namespace

// bf16 only, R = n_tok * (Hq / Hkv) <= 16. window <= 0 means no window;
// scratch_block < 0 disables the scratch mask. Tensors are contiguous:
// q/out [B, n_tok, Hq, D], pools [num_blocks, bs, Hkv, D], tables [B, M]
// int32, positions [B] int32; part holds B * Hkv * n_splits * R * (D + 2)
// fp32 (every (m, l) pair, then every acc row); split s covers logical
// blocks [s * P, (s + 1) * P), n_splits = ceil(M / P).
extern "C" int paged_flash_decode_split_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* tables, const void* positions, void* out, void* part, int B,
    int n_tok, int Hq, int Hkv, int D, int bs, int M, int P, int n_splits,
    int window, float scale, int scratch_block, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  cudaError_t err;
  switch (D) {
    case 32:
      err = launch_split_rows<32>(q, k_pool, v_pool, tables, positions, out,
                                  p, B, n_tok, Hq, Hkv, bs, M, P, n_splits,
                                  window, scale, scratch_block, st);
      break;
    case 64:
      err = launch_split_rows<64>(q, k_pool, v_pool, tables, positions, out,
                                  p, B, n_tok, Hq, Hkv, bs, M, P, n_splits,
                                  window, scale, scratch_block, st);
      break;
    case 128:
      err = launch_split_rows<128>(q, k_pool, v_pool, tables, positions, out,
                                   p, B, n_tok, Hq, Hkv, bs, M, P, n_splits,
                                   window, scale, scratch_block, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
