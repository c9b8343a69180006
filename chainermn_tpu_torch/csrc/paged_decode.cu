// Paged flash decoding for Hopper (sm_90a), fp32: K4's rows route.
//
// Replaces the Pallas TPU kernel chainermn_tpu/ops/paged_decode.py::
// paged_flash_decode (body _decode_body) for fp32 calls (the bf16 calls
// take paged_decode_sm90.cu's split route or paged_prefill_sm90.cu's mma
// route): attention of T >= 1 fresh query
// rows per slot against a paged KV pool [num_blocks, bs, Hkv, D] addressed
// through a per-slot block table, with causal, sliding-window and
// scratch-block masks, GQA rows r = t * group + g, fp32 accumulation.
//
// What bounds it: HBM bytes. Each query row does ~4*D flops per key it
// reads, far below the ~295 flops/byte at which an H100 stops being
// memory-bound, so the least time is the live K+V bytes read once over
// the memory rate. The design follows from that:
//
// - one CTA per (query-row tile, kv head, slot); the Pallas grid's
//   sequential block axis becomes a loop INSIDE the CTA, so the online
//   softmax state never leaves registers;
// - the CTA walks only the keys its rows can see: from the window's first
//   visible position to the tile's last query position, clamped to the
//   table horizon (the causal block skip); a key whose table entry is the
//   scratch block is never read, so the bytes moved are the live K/V once;
// - the q-head group sharing a kv head rides as extra rows of the same
//   tile, so each K/V byte is read once for the whole group;
// - the 4 warps split the key range (32 keys per warp step, one per lane)
//   and merge their (max, sum, acc) once at the end, so a single decode
//   row still has 4 warps of loads in flight;
// - each warp loads its 32 key rows with coalesced 16-byte vectors into
//   its own shared-memory slice; tables and positions are read from
//   global memory in the kernel (the TPU kernel's scalar prefetch).
//
// Numerics follow _decode_body: scores = (q . k in fp32) * scale, masked
// scores = NEG_INF (-1e30, not -inf), p = mask ? exp(s - m_new) : 0 (P in
// V's dtype, fp32, for the PV product), fp32 accumulators, and rows whose
// sum l is 0 emit an exact 0.
//
// The host entry launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kChunk = 32;  // keys per warp step: one per lane
constexpr unsigned kFull = 0xffffffffu;

// One 16-byte vector of a K/V row.
__device__ __forceinline__ void load_vec(const float* src, float* dst) {
  const float4 f = *reinterpret_cast<const float4*>(src);
  dst[0] = f.x; dst[1] = f.y; dst[2] = f.z; dst[3] = f.w;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Floats of one warp's shared-memory slice: K chunk [32][D+1] (padded so
// lane-per-key reads hit distinct banks), V chunk [32][D], P [ROWS][32].
template <int D, int ROWS>
__host__ __device__ constexpr int warp_floats() {
  return kChunk * (D + 1) + kChunk * D + ROWS * kChunk;
}

template <int D, int ROWS>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * (ROWS * D + kWarps * warp_floats<D, ROWS>());
}

template <int D, int ROWS>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const float* __restrict__ q,
                    const float* __restrict__ k_pool,
                    const float* __restrict__ v_pool,
                    const int* __restrict__ tables,
                    const int* __restrict__ positions, float* __restrict__ out,
                    int n_tok, int Hq, int Hkv, int group, int bs, int M,
                    int window, float scale, int scratch) {
  static_assert(D % 32 == 0, "head_dim must be a multiple of 32");
  constexpr int DL = D / 32;               // head dims per lane in PV
  constexpr int VEC = 4;                   // floats per 16-byte load
  constexpr int VPR = D / VEC;             // vectors per key row
  constexpr int WF = warp_floats<D, ROWS>();

  extern __shared__ float smem[];
  float* qs = smem;  // [ROWS][D] query tile, shared by the warps
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* ks = smem + ROWS * D + warp * WF;
  float* vs = ks + kChunk * (D + 1);
  float* ps = vs + kChunk * D;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int R = n_tok * group;
  const int row0 = blockIdx.x * ROWS;
  const int pos0 = positions[b];

  for (int i = threadIdx.x; i < ROWS * D; i += blockDim.x) {
    const int r = i / D, d = i % D, rg = row0 + r;
    float x = 0.f;
    if (rg < R) {
      const int t = rg / group, g = rg % group;
      x = q[((size_t)(b * n_tok + t) * Hq + h * group + g) * D + d];
    }
    qs[i] = x;
  }
  __syncthreads();

  // Keys any row of this tile can see: [kmin, kmax].
  const int t_lo = row0 / group;
  const int t_hi = min(R - 1, row0 + ROWS - 1) / group;
  const int kmax = min(pos0 + t_hi, M * bs - 1);
  const int kmin = window > 0 ? max(0, pos0 + t_lo - window + 1) : 0;
  const int n_chunks = kmax >= kmin ? (kmax - kmin + kChunk) / kChunk : 0;

  float m[ROWS], l[ROWS], acc[ROWS][DL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[r][i] = 0.f;
  }

  for (int c = warp; c < n_chunks; c += kWarps) {
    const int key = kmin + c * kChunk + lane;
    int blk = -1;  // physical block of this lane's key; -1 = not read
    if (key <= kmax) {
      const int e = tables[b * M + key / bs];
      if (e != scratch) blk = e;
    }
    const unsigned live = __ballot_sync(kFull, blk >= 0);
    if (live == 0) continue;

    for (int i = lane; i < kChunk * VPR; i += 32) {
      const int kl = i / VPR, vi = i % VPR;
      const int kblk = __shfl_sync(kFull, blk, kl);
      float kv[VEC], vv[VEC];
      if (kblk >= 0) {
        const int s = (kmin + c * kChunk + kl) % bs;
        const size_t off = (((size_t)kblk * bs + s) * Hkv + h) * D + vi * VEC;
        load_vec(k_pool + off, kv);
        load_vec(v_pool + off, vv);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kv[e] = vv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        ks[kl * (D + 1) + vi * VEC + e] = kv[e];
        vs[kl * D + vi * VEC + e] = vv[e];
      }
    }
    __syncwarp();

    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = ks[lane * (D + 1) + d];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) s[r] += qs[r * D + d] * kd;
    }

#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int rg = row0 + r;
      const int qpos = pos0 + rg / group;
      const bool ok = blk >= 0 && rg < R && key <= qpos &&
                      (window <= 0 || key > qpos - window);
      const float sc = ok ? s[r] * scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sc));
      // Guard fully masked rows: with every score NEG_INF,
      // exp(s - m_new) would be exp(0) = 1 per entry.
      const float p = ok ? expf(sc - m_new) : 0.f;
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p);
      m[r] = m_new;
      ps[r * kChunk + lane] = p;
#pragma unroll
      for (int i = 0; i < DL; ++i) acc[r][i] *= corr;
    }
    __syncwarp();

    for (int kk = 0; kk < kChunk; ++kk) {
      if (!((live >> kk) & 1u)) continue;
      float v[DL];
#pragma unroll
      for (int i = 0; i < DL; ++i) v[i] = vs[kk * D + lane + 32 * i];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float pr = ps[r * kChunk + kk];
#pragma unroll
        for (int i = 0; i < DL; ++i) acc[r][i] += pr * v[i];
      }
    }
    __syncwarp();
  }

  // Merge the warps' partial softmax states: [m | l | acc] per warp.
  __syncthreads();
  float* mine = smem + ROWS * D + warp * WF;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (lane == 0) {
      mine[r] = m[r];
      mine[ROWS + r] = l[r];
    }
#pragma unroll
    for (int i = 0; i < DL; ++i) mine[2 * ROWS + r * D + lane + 32 * i] = acc[r][i];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < ROWS * D; i += blockDim.x) {
    const int r = i / D, d = i % D, rg = row0 + r;
    if (rg >= R) continue;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, smem[ROWS * D + w * WF + r]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* part = smem + ROWS * D + w * WF;
      const float f = expf(part[r] - mx);
      lsum += part[ROWS + r] * f;
      a += part[2 * ROWS + r * D + d] * f;
    }
    // Fully masked rows (padding, released slots) emit exact 0.
    const float o = lsum > 0.f ? a / fmaxf(lsum, 1e-37f) : 0.f;
    const int t = rg / group, g = rg % group;
    out[((size_t)(b * n_tok + t) * Hq + h * group + g) * D + d] = o;
  }
}

template <int D, int ROWS>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* tables, const void* positions, void* out,
                   int B, int n_tok, int Hq, int Hkv, int bs, int M,
                   int window, float scale, int scratch,
                   cudaStream_t stream) {
  auto kernel = paged_decode_kernel<D, ROWS>;
  constexpr size_t smem = smem_bytes<D, ROWS>();
  // Above 48 KB a block may only use dynamic shared memory after this
  // opt-in (per device, so it is repeated on every launch).
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  const int group = Hq / Hkv;
  const int R = n_tok * group;
  const dim3 grid((R + ROWS - 1) / ROWS, Hkv, B);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_pool),
      static_cast<const float*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(positions), static_cast<float*>(out), n_tok, Hq,
      Hkv, group, bs, M, window, scale, scratch);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_rows(const void* q, const void* k_pool,
                        const void* v_pool, const void* tables,
                        const void* positions, void* out, int B, int n_tok,
                        int Hq, int Hkv, int bs, int M, int window,
                        float scale, int scratch, cudaStream_t stream) {
  // Rows per CTA: the whole q-head group of one decode token where it
  // fits, else 16-row tiles (prefill spreads over more CTAs).
  const int R = n_tok * (Hq / Hkv);
  if (R <= 1)
    return launch<D, 1>(q, k_pool, v_pool, tables, positions, out, B, n_tok,
                        Hq, Hkv, bs, M, window, scale, scratch, stream);
  if (R <= 4)
    return launch<D, 4>(q, k_pool, v_pool, tables, positions, out, B, n_tok,
                        Hq, Hkv, bs, M, window, scale, scratch, stream);
  return launch<D, 16>(q, k_pool, v_pool, tables, positions, out, B, n_tok,
                       Hq, Hkv, bs, M, window, scale, scratch, stream);
}

}  // namespace

// fp32 only (bf16 calls take the split or mma route). window <= 0 means
// no window; scratch_block < 0 disables the scratch mask. Tensors are
// contiguous: q/out [B, n_tok, Hq, D], pools [num_blocks, bs, Hkv, D],
// tables [B, M] int32, positions [B] int32.
extern "C" int paged_flash_decode_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* tables, const void* positions, void* out, int B, int n_tok,
    int Hq, int Hkv, int D, int bs, int M, int window, float scale,
    int scratch_block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 32:
      err = launch_rows<32>(q, k_pool, v_pool, tables, positions, out, B,
                            n_tok, Hq, Hkv, bs, M, window, scale,
                            scratch_block, s);
      break;
    case 64:
      err = launch_rows<64>(q, k_pool, v_pool, tables, positions, out, B,
                            n_tok, Hq, Hkv, bs, M, window, scale,
                            scratch_block, s);
      break;
    case 128:
      err = launch_rows<128>(q, k_pool, v_pool, tables, positions, out, B,
                             n_tok, Hq, Hkv, bs, M, window, scale,
                             scratch_block, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
