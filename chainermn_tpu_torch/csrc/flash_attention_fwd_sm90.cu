// The flash-attention forward for bf16 inputs on Hopper's tensor cores
// (sm_90a): K1 flash_fwd_mma_kernel replaces, for bf16, the Pallas TPU
// kernel chainermn_tpu/ops/flash_attention.py::_flash_fwd_bhtd (body
// _fwd_body): online softmax over key tiles, O and the per-row logsumexp
// (LSE) that the backward kernels K2/K3 read. fp32 keeps the CUDA-core
// flash_fwd_kernel of flash_attention.cu.
//
// It takes every option of that kernel: causal with q_offset, the sliding
// window and its band, GQA, packed segment ids, the additive fp32 bias
// with size-1 dims, ragged tails for any T, head dim 32, 64 or 128. Each
// CTA owns one q tile of one q head and loops over the key tiles itself,
// so there are no atomics on the outputs and every sum is taken in one
// fixed order: the results repeat bit for bit.
//
// What bounds it: operations. Each (query row, visible key) pair costs
// 4*D operations (S = Q K^T and O += P V), and a CTA reads each K/V tile
// once for 64 rows -- at T 2048, D 64 that is some 64 operations per
// byte even from L2, above the H100's ~295 operations per byte of HBM only
// on tensor cores (the bound of the training shape is 0.035 ms in
// operations at plain causal, 0.020 ms in bytes at the packed rows). So
// the products run on the tensor cores and the operands keep moving, as
// in K2 (flash_attention_bwd_sm90.cu):
//
// - one warpgroup (4 warps, 128 threads) per CTA owns a 64-row q tile and
//   issues wgmma m64n64k16 against each 64-key tile; CTAs run longest
//   first (the q tiles at the causal end);
// - Q sits in shared memory as a bf16 [64][D] tile in wgmma's canonical
//   swizzled layout (flash_attention_sm90.cuh); K and V stream through a
//   two-stage ring filled by cp.async, so the next tile's copy overlaps
//   this tile's products;
// - S = Q K^T is one wgmma group with both operands read through K-major
//   descriptors;
// - P never goes to shared memory: the m64n64 accumulator, rounded to
//   bf16 in registers, is the register A operand of O += P V, and V is
//   read through an MN-major descriptor, so nothing is transposed in
//   memory;
// - scores are kept in base-2 units (scaled by log2(e)) for exp2 on the
//   special-function unit; the running max and this thread's part of the
//   row sum stay in registers, per row, and the four lanes that share a
//   row meet only for the max (two shuffles a tile) and at the end;
// - a tile pair whose every entry is visible (the bulk of a causal band)
//   takes a straight-line path with no mask; partial tiles a branch-free
//   mask held as one bit per score; the bias its own loop;
// - the segment-aware tile skip of K2/K3: the CTA reduces its q tile's
//   segment ids and those of every key tile of its band to (min, max) and
//   drops a key tile whose range does not meet its own before loading
//   it. Such a tile holds no equal ids, so every entry is masked and adds
//   p = 0: the skip is exact for any ids, sorted or not, also on a row
//   that sees no key (m stays NEG_INF, l = 0, so O = 0 and LSE =
//   NEG_INF). Each CTA adds the (q tile, k tile, q head) triples it
//   visits and skips to counters on the card (two atomic adds a CTA),
//   which flash_fwd_tile_counts reads: the proof that the skip ran, and
//   the same triples as K2's.
//
// Later work, as for K2/K3: TMA with an mbarrier ring in place of
// cp.async, warp specialisation, a persistent grid. Each CTA reads 16 KB
// of K/V (D 64) for every 1 MFLOP it does, so at ~200 TFLOP/s the CTAs
// together pull ~3 TB/s from L2: 128-row q tiles (two warpgroups sharing
// each K/V tile) would halve that. Running one tile's P V under the next
// tile's softmax (a three-stage ring) was measured only 2-4% faster on
// the H100 and is not done (PERF.md).
//
// Numerics follow _fwd_body: s = (q . k, fp32 accumulators) * scale
// (+ fp32 bias), masked s = NEG_INF (-1e30); m_new = max(m, rowmax(s));
// p = mask ? exp(s - m_new) : 0, exact 0 on every masked entry; the row
// sum l over the fp32 p; P rounded to bf16 (V's dtype) before P V; O = 0
// and LSE = NEG_INF where l = 0, else O = acc / l (bf16) and LSE =
// m + log(l) (fp32).

#include "flash_attention_sm90.cuh"

namespace {

constexpr float kLn2 = 0.6931471805599453f;

// (q tile, k tile, q head) triples of the band that K1 visited ([0]) and
// skipped by segment ranges ([1]) since the last flash_fwd_tile_counts on
// this device.
__device__ unsigned long long g_fwd_tile_counts[2];

// Shared memory: the tiles from a 1024-byte boundary (q, then K, V per
// stage), the stages' segment ids, the tile list and ranges.
template <int D>
constexpr size_t fwd_smem(int nk) {
  return 1024 + (size_t)(1 + 2 * kStages) * kTile * D * 2 +
         (size_t)kStages * kTile * 4 + (size_t)3 * nk * 4 + 16;
}

template <int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks<D>)
flash_fwd_mma_kernel(const FlashParams p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr int kTileBytes = kTile * D * 2;
  constexpr int kStageBytes = 2 * kTileBytes;  // K, V
  const int nq = (p.Tq + kTile - 1) / kTile, nk = (p.Tk + kTile - 1) / kTile;
  unsigned char* base;
  const uint32_t s_q = aligned_smem(smem, &base);
  const uint32_t s_stage = s_q + kTileBytes;
  int* seg_s = reinterpret_cast<int*>(base + (1 + 2 * kStages) * kTileBytes);
  int* list = seg_s + kStages * kTile;
  int* tmin = list + nk;
  int* tmax = tmin + nk;
  int* shared_n = tmax + nk;

  // the q tiles at the causal end (the longest loops) start first
  const int q0 = (nq - 1 - (int)blockIdx.x) * kTile;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (p.H / p.Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const int* segq = p.seg_q ? p.seg_q + b * p.segq_sb : nullptr;
  const int* segk = p.seg_k ? p.seg_k + b * p.segk_sb : nullptr;

  load_tile<D>(s_q, qb, p.q_st, q0, p.Tq);
  cp_commit();

  // This thread's two rows of the warp's 16 and their segment ids.
  int qi[2], sq[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qi[i] = q0 + 16 * warp + (lane >> 2) + 8 * i;
    sq[i] = qi[i] < p.Tq && segq ? segq[qi[i]] : 0;
  }

  int qr[2] = {0, 0};  // this q tile's segment range
  if (segq) seg_range(segq, q0, p.Tq, &qr[0], &qr[1]);
  int t0, t1;
  key_tiles(p, q0, &t0, &t1);
  const int n = plan_tiles(qr, segk, p.Tk, t0, t1, nk, list, tmin, tmax,
                           nullptr, shared_n, g_fwd_tile_counts, 1);

  auto issue = [&](int i) {
    const int k0 = list[i] * kTile;
    const uint32_t st = s_stage + (i % kStages) * kStageBytes;
    load_tile<D>(st, kb, p.k_st, k0, p.Tk);
    load_tile<D>(st + kTileBytes, vb, p.v_st, k0, p.Tk);
    if (segk) load_vec(smem_u32(seg_s + (i % kStages) * kTile), segk, k0, p.Tk);
    cp_commit();
  };

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
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

    float s[8][4] = {};
    wg_fence();
    wg_abt<D>(s, s_q, s_k);
    wg_commit();
    wg_wait<0>();
    keep(s);
    const int kr[2] = {segk ? tmin[t] : 0, segk ? tmax[t] : 0};
    if (p.bias == nullptr && tile_full(p, q0, k0, qr, kr)) {
      // every entry visible (the bulk of the band)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] *= scale2;
      softmax_step<D, false>(s, 0u, m, l, o);
    } else {
      uint32_t ok = 0;
      if (p.bias == nullptr) {  // a partial tile: the mask
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, c = 8 * nt + 2 * (lane & 3) + (e & 1);
            const bool vis =
                visible(p, qi[r], k0 + c, sq[r], segk ? sk[c] : 0);
            ok |= (uint32_t)vis << (4 * nt + e);
            s[nt][e] = vis ? s[nt][e] * scale2 : kNegInf;
          }
      } else {  // the mask and the bias
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, c = 8 * nt + 2 * (lane & 3) + (e & 1);
            const bool vis =
                visible(p, qi[r], k0 + c, sq[r], segk ? sk[c] : 0);
            ok |= (uint32_t)vis << (4 * nt + e);
            float x = s[nt][e] * scale2;
            if (vis) x += bias_at(p, b, h, qi[r], k0 + c) * kLog2e;
            s[nt][e] = vis ? x : kNegInf;
          }
      }
      softmax_step<D, true>(s, ok, m, l, o);
    }
    uint32_t a[4][4];
    to_a(a, s);
    wg_fence();
    wg_xb<D>(o, a, s_v);  // O += P V
    wg_commit();
    wg_wait<0>();
    keep(o);
    keep(a);
    __syncthreads();  // this stage is refilled two tiles on
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
    if (qi[r] >= p.Tq) continue;
    const bool live = lt[r] > 0.f;
    bf16* out = static_cast<bf16*>(p.out) +
                (((int64_t)b * p.Tq + qi[r]) * p.H + h) * D + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
          live ? __floats2bfloat162_rn(o[j][2 * r] / lt[r],
                                       o[j][2 * r + 1] / lt[r])
               : __floats2bfloat162_rn(0.f, 0.f);
    if ((lane & 3) == 0)
      p.lse_out[((int64_t)b * p.H + h) * p.Tq + qi[r]] =
          live ? m[r] * kLn2 + logf(lt[r]) : kNegInf;
  }
}

template <int D>
cudaError_t launch_fwd(const FlashParams& p, cudaStream_t s) {
  const int nk = (p.Tk + kTile - 1) / kTile;
  const dim3 grid((p.Tq + kTile - 1) / kTile, p.H, p.B);
  return launch(flash_fwd_mma_kernel<D>, fwd_smem<D>(nk), grid, p, s);
}

}  // namespace

cudaError_t flash_fwd_bf16(const FlashParams& p, cudaStream_t s) {
  switch (p.D) {
    case 32:
      return launch_fwd<32>(p, s);
    case 64:
      return launch_fwd<64>(p, s);
    case 128:
      return launch_fwd<128>(p, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The counts of K1's tile skip since the last call, into out[2]: visited,
// skipped ((q tile, k tile, q head) triples of the band); resets them.
// Synchronous, on the current device.
extern "C" int flash_fwd_tile_counts(unsigned long long* out) {
  const cudaError_t err = cudaMemcpyFromSymbol(out, g_fwd_tile_counts,
                                               sizeof(g_fwd_tile_counts));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[2] = {};
  return (int)cudaMemcpyToSymbol(g_fwd_tile_counts, zero, sizeof(zero));
}
