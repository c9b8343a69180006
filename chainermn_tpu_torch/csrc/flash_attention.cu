// Flash attention, forward and backward, for Hopper (sm_90a): the fp32
// forward and backward on CUDA cores, and the library's C entry points.
// bf16 runs on tensor cores: the forward in flash_attention_fwd_sm90.cu,
// the backward in flash_attention_bwd_sm90.cu; dispatch() below picks by
// the input dtype.
//
// Three kernels replace the Pallas TPU kernels of
// chainermn_tpu/ops/flash_attention.py:
//
// - K1 flash_fwd_kernel  <- _flash_fwd_bhtd (body _fwd_body): online
//   softmax over key tiles, O and the per-row logsumexp (LSE);
// - K2 flash_dq_kernel   <- _flash_bwd_bhtd's dq call (_bwd_dq_body):
//   P = mask ? exp(S - LSE) : 0, dS = P * (dP - delta) * scale, dq = dS K;
// - K3 flash_dkv_kernel  <- _flash_bwd_bhtd's dk/dv call (_bwd_dkv_body):
//   dv = P^T dO, dk = dS^T q, and with bias_grad the full dbias.
//
// Options, as in the TPU kernels: causal (with q_offset), a sliding
// window, GQA (kv head = q head / group), packed segment ids and an
// additive fp32 bias [B|1, H|1, Tq, Tk] (size-1 dims read through a zero
// stride), added after the scale and before the mask.
//
// What bounds them: operations. At the training shapes (T 2048, head dim
// 64) each (row, visible key) pair costs 4*D (K1), 6*D (K2) or 8*D (K3)
// operations on a few bytes of K/V per key that stay on chip for a
// 64-row tile, far above the ~295 operations per byte where an H100
// stops being memory-bound. The design follows from that:
//
// - the TPU grid's sequential last axis (which carries m/l/acc or the
//   gradient accumulators in VMEM) becomes a loop INSIDE the CTA, and
//   each CTA owns its output tile, so nothing is carried between CTAs
//   and nothing needs atomics;
// - K1 and K2: one CTA per (q tile, q head, batch row), looping over key
//   tiles from the window band's first tile (the TPU's _band_k) to the
//   causal diagonal (its _live block skip);
// - K3: one CTA per (k tile, KV head, batch row), looping over the
//   group's q heads and over the q tiles that can see this k tile (the
//   TPU's _band_q). dk/dv accumulate per kv head inside the CTA, which
//   removes the TPU version's per-q-head [B, H, Tk, D] buffers and the
//   group sum after the kernel. With bias_grad the CTA visits every q
//   tile and writes zeros to the dbias tiles no query of the band reaches;
// - tiles are 64 x 64 with 256 threads; each thread computes a 4 x 4 block
//   of scores from fp32 copies of the tiles in shared memory (rows padded
//   by one float so lane-per-row reads hit distinct banks) and owns a
//   4 x D/16 block of the output accumulators. Products run on fp32 CUDA
//   cores: simple and exact for fp32. The kernels here take fp32 only; bf16
//   has its own tensor-core kernels (K1 flash_fwd_mma_kernel, K2/K3
//   flash_dq_mma_kernel and flash_dkv_mma_kernel);
// - the public layout is BTHD and the kernels address it through the
//   tensors' batch, token and head strides, so no operand is transposed
//   or copied; ragged tails are masked, so any T runs.
//
// Numerics follow the TPU kernels: scores = (q . k in fp32) * scale
// (+ bias), masked scores = NEG_INF (-1e30), in K1 p = mask ? exp(s -
// m_new) : 0 (P needs no rounding on fp32 V); O = 0 and LSE =
// NEG_INF where the row sum is 0. K2 and K3 re-derive p = mask ? exp(s -
// lse) : 0 from the saved LSE: a masked entry gives exactly 0, also on a
// row that saw no key (LSE = NEG_INF, where exp(s - lse) alone would be
// 1), so such a row gets dq = 0 and adds nothing to dk, dv or dbias --
// the gradient of the forward's constant O = 0, whatever tiles are
// visited. On their fp32 inputs dS needs no rounding (the TPU kernel
// rounds it to k's and q's dtype) and dv takes the fp32 p; fp32
// accumulators. dq/dk/dv/dbias are fp32.
//
// Each host entry launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_attention.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 scores each
constexpr int kPad = kTile + 1;
constexpr unsigned kFull = 0xffffffffu;

// Reductions over the 16 lanes that hold one row (a half warp).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Rows [r0, r0 + 64) of one (batch, head) slice of a BTHD tensor into
// shared memory [64][D + 1]; rows at or past n are zero.
template <int D>
__device__ void load_rows(float* dst, const float* src, int64_t row_stride,
                          int r0, int n) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float x = 0.f;
    if (r0 + r < n) x = src[(int64_t)(r0 + r) * row_stride + d];
    dst[r * (D + 1) + d] = x;
  }
}

__device__ void load_seg(int* dst, const int* seg, int r0, int n) {
  for (int i = threadIdx.x; i < kTile; i += kThreads)
    dst[i] = r0 + i < n ? seg[r0 + i] : 0;
}

// s[i][j] = sum_d A[ty + 16 i][d] * Bm[tx + 16 j][d] over [64][D + 1] tiles.
template <int D>
__device__ __forceinline__ void dot_tile(const float* A, const float* Bm,
                                         float s[4][4]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bm[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] += a[i] * b[j];
  }
}

// acc[i][j] += sum_c P[ty + 16 i][c] * X[c][tx + 16 j]: P is [64][65],
// X is [64][D + 1] (PV in K1, dS K in K2).
template <int D>
__device__ __forceinline__ void p_times(const float* P, const float* X,
                                        float acc[4][D / 16]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
  for (int c = 0; c < kTile; ++c) {
    float p[4], x[D / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = P[(ty + 16 * i) * kPad + c];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) x[j] = X[c * (D + 1) + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] += p[i] * x[j];
  }
}

// acc[i][j] += sum_r P[r][ty + 16 i] * X[r][tx + 16 j]: the transposed
// product of K3 (P^T dO for dv, dS^T q for dk).
template <int D>
__device__ __forceinline__ void pt_times(const float* P, const float* X,
                                         float acc[4][D / 16]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
  for (int r = 0; r < kTile; ++r) {
    float p[4], x[D / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = P[r * kPad + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) x[j] = X[r * (D + 1) + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] += p[i] * x[j];
  }
}

// The masked, scaled score of (qi, kj) for q head h of batch row b.
__device__ __forceinline__ float score(const FlashParams& p, float dot, int b,
                                       int h, int qi, int kj, bool ok) {
  float x = dot * p.scale;
  if (p.bias != nullptr && ok)
    x += p.bias[b * p.bias_sb + h * p.bias_sh + (int64_t)qi * p.bias_sq +
                (int64_t)kj * p.bias_sk];
  return ok ? x : kNegInf;
}

// ------------------------------------------------------------------ K1

template <int D>
__host__ __device__ constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * kTile * (D + 1) + kTile * kPad) +
         sizeof(int) * 2 * kTile;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const FlashParams p) {
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTile * (D + 1);
  float* Vs = Ks + kTile * (D + 1);
  float* Ps = Vs + kTile * (D + 1);
  int* sq = reinterpret_cast<int*>(Ps + kTile * kPad);
  int* sk = sq + kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;

  load_rows<D>(Qs, qb, p.q_st, q0, p.Tq);
  if (p.seg_q != nullptr) load_seg(sq, p.seg_q + b * p.segq_sb, q0, p.Tq);

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  int t0, t1;
  key_tiles(p, q0, &t0, &t1);
  for (int t = t0; t < t1; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_rows<D>(Ks, kb, p.k_st, k0, p.Tk);
    load_rows<D>(Vs, vb, p.v_st, k0, p.Tk);
    if (p.seg_k != nullptr) load_seg(sk, p.seg_k + b * p.segk_sb, k0, p.Tk);
    __syncthreads();

    float s[4][4];
    dot_tile<D>(Qs, Ks, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qi = q0 + r;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        ok[j] = visible(p, qi, k0 + c, sq[r], sk[c]);
        s[i][j] = score(p, s[i][j], b, h, qi, k0 + c, ok[j]);
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // p = mask ? exp(s - m_new) : 0 (a fully masked row would
        // otherwise give exp(0) = 1 per entry)
        const float pr = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += pr;
        Ps[r * kPad + tx + 16 * j] = pr;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();
    p_times<D>(Ps, Vs, acc);
  }

  float* out = static_cast<float*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= p.Tq) continue;
    const bool live = l[i] > 0.f;
    const float denom = fmaxf(l[i], 1e-37f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      out[(((int64_t)b * p.Tq + qi) * p.H + h) * D + tx + 16 * j] =
          live ? acc[i][j] / denom : 0.f;
    if (tx == 0)
      p.lse_out[((int64_t)b * p.H + h) * p.Tq + qi] =
          live ? m[i] + logf(denom) : kNegInf;
  }
}

// ------------------------------------------------------------------ K2

template <int D>
__host__ __device__ constexpr size_t dq_smem() {
  return sizeof(float) * (4 * kTile * (D + 1) + kTile * kPad) +
         sizeof(int) * 2 * kTile;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const FlashParams p) {
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* DOs = Qs + kTile * (D + 1);
  float* Ks = DOs + kTile * (D + 1);
  float* Vs = Ks + kTile * (D + 1);
  float* DSs = Vs + kTile * (D + 1);
  int* sq = reinterpret_cast<int*>(DSs + kTile * kPad);
  int* sk = sq + kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* dob =
      static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;

  load_rows<D>(Qs, qb, p.q_st, q0, p.Tq);
  load_rows<D>(DOs, dob, p.do_st, q0, p.Tq);
  if (p.seg_q != nullptr) load_seg(sq, p.seg_q + b * p.segq_sb, q0, p.Tq);
  float lse[4], delta[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    const int64_t row = ((int64_t)b * p.H + h) * p.Tq + qi;
    lse[i] = qi < p.Tq ? p.lse[row] : 0.f;
    delta[i] = qi < p.Tq ? p.delta[row] : 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  int t0, t1;
  key_tiles(p, q0, &t0, &t1);
  for (int t = t0; t < t1; ++t) {
    const int k0 = t * kTile;
    __syncthreads();
    load_rows<D>(Ks, kb, p.k_st, k0, p.Tk);
    load_rows<D>(Vs, vb, p.v_st, k0, p.Tk);
    if (p.seg_k != nullptr) load_seg(sk, p.seg_k + b * p.segk_sb, k0, p.Tk);
    __syncthreads();

    float s[4][4], dp[4][4];
    dot_tile<D>(Qs, Ks, s);
    dot_tile<D>(DOs, Vs, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qi = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool ok = visible(p, qi, k0 + c, sq[r], sk[c]);
        const float pr =
            ok ? expf(score(p, s[i][j], b, h, qi, k0 + c, ok) - lse[i]) : 0.f;
        DSs[r * kPad + c] = pr * (dp[i][j] - delta[i]) * p.scale;
      }
    }
    __syncthreads();
    p_times<D>(DSs, Ks, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= p.Tq) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      p.dq[(((int64_t)b * p.Tq + qi) * p.H + h) * D + tx + 16 * j] = acc[i][j];
  }
}

// ------------------------------------------------------------------ K3

template <int D>
__host__ __device__ constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * kTile * (D + 1) + kTile * kPad + 2 * kTile) +
         sizeof(int) * 2 * kTile;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const FlashParams p) {
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTile * (D + 1);
  float* Qs = Vs + kTile * (D + 1);
  float* DOs = Qs + kTile * (D + 1);
  float* Ps = DOs + kTile * (D + 1);
  float* lse_s = Ps + kTile * kPad;
  float* delta_s = lse_s + kTile;
  int* sq = reinterpret_cast<int*>(delta_s + kTile);
  int* sk = sq + kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int k0 = blockIdx.x * kTile, hk = blockIdx.y, b = blockIdx.z;
  const int group = p.H / p.Hkv;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;

  load_rows<D>(Ks, kb, p.k_st, k0, p.Tk);
  load_rows<D>(Vs, vb, p.v_st, k0, p.Tk);
  if (p.seg_k != nullptr) load_seg(sk, p.seg_k + b * p.segk_sb, k0, p.Tk);

  float dk[4][DJ], dv[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  int t0, t1;
  query_tiles(p, k0, &t0, &t1);
  const int nq = (p.Tq + kTile - 1) / kTile;
  const bool want_dbias = p.dbias != nullptr;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
    const float* dob =
        static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
    for (int t = want_dbias ? 0 : t0; t < (want_dbias ? nq : t1); ++t) {
      const int q0 = t * kTile;
      if (t < t0 || t >= t1) {
        // A dbias tile no query of the band reaches: zeros, as the TPU
        // kernel writes its dead tiles.
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = q0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int kj = k0 + tx + 16 * j;
            if (qi < p.Tq && kj < p.Tk)
              p.dbias[(((int64_t)b * p.H + h) * p.Tq + qi) * p.Tk + kj] = 0.f;
          }
        }
        continue;
      }
      __syncthreads();  // the previous tile's readers are done
      load_rows<D>(Qs, qb, p.q_st, q0, p.Tq);
      load_rows<D>(DOs, dob, p.do_st, q0, p.Tq);
      if (p.seg_q != nullptr) load_seg(sq, p.seg_q + b * p.segq_sb, q0, p.Tq);
      for (int i = threadIdx.x; i < kTile; i += kThreads) {
        const int qi = q0 + i;
        const int64_t row = ((int64_t)b * p.H + h) * p.Tq + qi;
        lse_s[i] = qi < p.Tq ? p.lse[row] : 0.f;
        delta_s[i] = qi < p.Tq ? p.delta[row] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
      dot_tile<D>(Qs, Ks, s);
      dot_tile<D>(DOs, Vs, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i, qi = q0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const bool ok = visible(p, qi, k0 + c, sq[r], sk[c]);
          s[i][j] = ok ? expf(score(p, s[i][j], b, h, qi, k0 + c, ok) -
                              lse_s[r])
                       : 0.f;
          Ps[r * kPad + c] = s[i][j];  // dv takes the fp32 p
        }
      }
      __syncthreads();
      pt_times<D>(Ps, DOs, dv);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i, qi = q0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j, kj = k0 + c;
          const float ds = s[i][j] * (dp[i][j] - delta_s[r]);
          if (want_dbias && qi < p.Tq && kj < p.Tk)
            // dbias is dS before the scale (the bias adds after it)
            p.dbias[(((int64_t)b * p.H + h) * p.Tq + qi) * p.Tk + kj] = ds;
          Ps[r * kPad + c] = ds * p.scale;
        }
      }
      __syncthreads();
      pt_times<D>(Ps, Qs, dk);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= p.Tk) continue;
    const int64_t base = (((int64_t)b * p.Tk + kj) * p.Hkv + hk) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      p.dk[base + tx + 16 * j] = dk[i][j];
      p.dv[base + tx + 16 * j] = dv[i][j];
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

enum Which { kFwd, kDq, kDkv };

// f(std::integral_constant<int, D>()) for the record's head dim.
template <typename F>
cudaError_t by_head_dim(int D, F f) {
  switch (D) {
    case 32:
      return f(std::integral_constant<int, 32>());
    case 64:
      return f(std::integral_constant<int, 64>());
    case 128:
      return f(std::integral_constant<int, 128>());
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t launch_fwd_f32(const FlashParams& p, cudaStream_t s) {
  const dim3 grid((p.Tq + kTile - 1) / kTile, p.H, p.B);
  return by_head_dim(p.D, [&](auto d) {
    constexpr int D = decltype(d)::value;
    return launch(flash_fwd_kernel<D>, fwd_smem<D>(), grid, p, s);
  });
}

cudaError_t launch_dq_f32(const FlashParams& p, cudaStream_t s) {
  const dim3 grid((p.Tq + kTile - 1) / kTile, p.H, p.B);
  return by_head_dim(p.D, [&](auto d) {
    constexpr int D = decltype(d)::value;
    return launch(flash_dq_kernel<D>, dq_smem<D>(), grid, p, s);
  });
}

cudaError_t launch_dkv_f32(const FlashParams& p, cudaStream_t s) {
  const dim3 grid((p.Tk + kTile - 1) / kTile, p.Hkv, p.B);
  return by_head_dim(p.D, [&](auto d) {
    constexpr int D = decltype(d)::value;
    return launch(flash_dkv_kernel<D>, dkv_smem<D>(), grid, p, s);
  });
}

int dispatch(Which which, const FlashParams* p, void* stream) {
  if (p->H % p->Hkv != 0) return (int)cudaErrorInvalidValue;
  // An empty grid is not a launch: nothing to compute, nothing written.
  if (p->B == 0 || p->H == 0 || (which == kDkv ? p->Tk : p->Tq) == 0)
    return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // By input dtype, never as a fallback: fp32 runs every kernel here
  // (exact on CUDA cores), bf16 every kernel on the tensor cores.
  if (p->dtype == 0 && which == kFwd) return (int)launch_fwd_f32(*p, s);
  if (p->dtype == 0 && which == kDq) return (int)launch_dq_f32(*p, s);
  if (p->dtype == 0) return (int)launch_dkv_f32(*p, s);
  if (p->dtype == 1 && which == kFwd) return (int)flash_fwd_bf16(*p, s);
  if (p->dtype == 1 && which == kDq) return (int)flash_dq_bf16(*p, s);
  if (p->dtype == 1) return (int)flash_dkv_bf16(*p, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window <= 0 means no window; null
// seg_q/bias/dbias pointers mean no segments, no bias, no bias gradient.
// Outputs are contiguous: out [B, Tq, H, D] (q's dtype), lse [B, H, Tq],
// dq [B, Tq, H, D], dk/dv [B, Tk, Hkv, D], dbias [B, H, Tq, Tk], all fp32.
extern "C" int flash_fwd_launch(const FlashParams* p, void* stream) {
  return dispatch(kFwd, p, stream);
}
extern "C" int flash_dq_launch(const FlashParams* p, void* stream) {
  return dispatch(kDq, p, stream);
}
extern "C" int flash_dkv_launch(const FlashParams* p, void* stream) {
  return dispatch(kDkv, p, stream);
}
