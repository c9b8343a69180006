// What the flash-attention sources share: the launch record that
// ops/flash_attention.py::_Params mirrors, the mask rule and the band of
// tiles a CTA visits, and the entry points of the bf16 tensor-core
// kernels (flash_attention_fwd_sm90.cu, flash_attention_bwd_sm90.cu) that
// flash_attention.cu dispatches to.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Mirrored field for field by ops/flash_attention.py::_Params.
struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const int* seg_q;
  const int* seg_k;
  const float* bias;
  const float* lse;
  const float* delta;
  void* out;
  float* lse_out;
  float* dq;
  float* dk;
  float* dv;
  float* dbias;
  int64_t q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  int64_t do_sb, do_st, do_sh, segq_sb, segk_sb;
  int64_t bias_sb, bias_sh, bias_sq, bias_sk;
  int B, Tq, Tk, H, Hkv, D, causal, window, q_offset, dtype;
  float scale;
};

// The bf16 kernels on tensor cores: the forward
// (flash_attention_fwd_sm90.cu) and the backward
// (flash_attention_bwd_sm90.cu); each launches on `stream` and returns
// cudaGetLastError().
cudaError_t flash_fwd_bf16(const FlashParams& p, cudaStream_t stream);
cudaError_t flash_dq_bf16(const FlashParams& p, cudaStream_t stream);
cudaError_t flash_dkv_bf16(const FlashParams& p, cudaStream_t stream);

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kTile = 64;  // rows of a q tile and of a k tile

// Is key kj visible from query row qi (both in range)? Branch-free, for
// the kernels' element loops.
__device__ __forceinline__ bool visible(const FlashParams& p, int qi, int kj,
                                        int sq, int sk) {
  const int qpos = qi + p.q_offset;
  bool ok = (qi < p.Tq) & (kj < p.Tk);
  ok &= !p.causal |
        ((kj <= qpos) & ((p.window <= 0) | (qpos - kj < p.window)));
  return ok & ((p.seg_q == nullptr) | (sq == sk));
}

// Key tiles [*t0, *t1) that query rows [q0, q0 + 64) can see: from the
// window band's first key to the causal diagonal (all keys if not causal).
__device__ __forceinline__ void key_tiles(const FlashParams& p, int q0,
                                          int* t0, int* t1) {
  int kbeg = 0, kend = p.Tk;
  if (p.causal) {
    const int qlast = min(q0 + kTile, p.Tq) - 1;
    kend = min(p.Tk, qlast + p.q_offset + 1);
    if (p.window > 0) kbeg = max(0, q0 + p.q_offset - p.window + 1);
  }
  if (kend <= kbeg) {
    *t0 = *t1 = 0;
    return;
  }
  *t0 = kbeg / kTile;
  *t1 = (kend + kTile - 1) / kTile;
}

// Query tiles [*t0, *t1) whose rows can see some key of [k0, k0 + 64).
__device__ __forceinline__ void query_tiles(const FlashParams& p, int k0,
                                            int* t0, int* t1) {
  int qbeg = 0, qend = p.Tq;
  if (p.causal) {
    qbeg = max(0, k0 - p.q_offset);
    if (p.window > 0) {
      const int klast = min(k0 + kTile, p.Tk) - 1;
      qend = min(p.Tq, klast + p.window - p.q_offset);
    }
  }
  if (qend <= qbeg) {
    *t0 = *t1 = 0;
    return;
  }
  *t0 = qbeg / kTile;
  *t1 = (qend + kTile - 1) / kTile;
}

}  // namespace
