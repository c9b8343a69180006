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
// The primitives, the tile loads and the skip's plan are shared with the
// bf16 forward K1 (flash_attention_fwd_sm90.cu) through
// flash_attention_sm90.cuh.
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

#include "flash_attention_sm90.cuh"

namespace {

// (q tile, k tile, q head) triples of the band that K2 ([0]) and K3 ([1])
// visited ([.][0]) and skipped by segment ranges ([.][1]) since the last
// flash_bwd_tile_counts on this device.
__device__ unsigned long long g_tile_counts[2][2];

// ------------------------------------------------------------------ K2

// Shared memory: the tiles from a 1024-byte boundary (q, dO, then K, V
// per stage), the stages' segment ids, the tile list and ranges.
template <int D>
constexpr size_t dq_smem(int nk) {
  return 1024 + (size_t)(2 + 2 * kStages) * kTile * D * 2 +
         (size_t)kStages * kTile * 4 + (size_t)3 * nk * 4 + 16;
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
                           nullptr, shared_n, g_tile_counts[0], 1);

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
                           want_dbias ? flag : nullptr, shared_n,
                           g_tile_counts[1], group);

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
