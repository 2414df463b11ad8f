// What the flash-attention kernels (flash_fwd.cu, flash_bwd.cu) share: the
// problem description, the masked logit, and the staging of a [64, HD] tile
// of one head into shared memory.
//
// Layout. q, k, v are [B, L, H, hd] (the JAX package's attention layout)
// with the head at stride hd and the dimension at stride 1; the batch and
// sequence strides are given, so the q/k/v views of a fused qkv projection
// are read in place. o, dO, dq, dk and dv are contiguous [B, L, H, hd]; the
// row log-sum-exp and D = rowsum(dO o) are f32 [B*H, Lq]. The sequences are
// not padded in memory: a tile's rows past L read as zeros.
//
// Why padded rows cannot change a real row. A key row past Lk gets the
// logit -inf, so its probability is exactly 0 for every query: it adds
// nothing to the row sum or to O, and its gradients are never written. A
// query row past Lq is computed from zeros, never written, and its
// probabilities are set to 0 in the backward, so it adds nothing to dK and
// dV. Every real row's softmax runs over the real keys alone; a masked key
// (kv_mask false) takes the logit -1e9, as the plain version does, and gets
// no gradient through the logit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace flash {

constexpr int kBlock = 64;    // queries or keys per tile of the tensor-core kernels
constexpr int kWarps = 4;     // 16 rows of a tile per warp
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxHd = 128;

struct Problem {
  const void* q;
  const void* k;
  const void* v;
  const unsigned char* kv_mask;  // [B, Lk], 0 = key excluded; may be null
  int B, H, Lq, Lk, hd;
  long long q_sb, q_sl, k_sb, k_sl, v_sb, v_sl;  // element strides
  float scale;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// The logit of key j for a query of sequence b, from the scaled-by-nothing
// dot product: -inf past Lk, -1e9 where kv_mask excludes the key.
__device__ __forceinline__ float logit(const Problem& p, int b, int j, float dot) {
  if (j >= p.Lk) return -CUDART_INF_F;
  if (p.kv_mask != nullptr && p.kv_mask[(size_t)b * p.Lk + j] == 0) return -1e9f;
  return dot * p.scale;
}

// Whether key j of sequence b takes a gradient through its logit.
__device__ __forceinline__ bool key_live(const Problem& p, int b, int j) {
  return j < p.Lk && (p.kv_mask == nullptr || p.kv_mask[(size_t)b * p.Lk + j] != 0);
}

// Rows r0 .. r0 + 63 of head h of sequence b of a bf16 [B, L, H, hd] tensor
// into dst [64][ld], 16 bytes per load (the wrapper checks the alignment);
// rows past L are zero.
template <int HD>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst, int ld,
                                           const __nv_bfloat16* base,
                                           long long sb, long long sl, int b,
                                           int h, int r0, int L) {
  constexpr int kVecs = HD / 8;
  for (int idx = threadIdx.x; idx < kBlock * kVecs; idx += blockDim.x) {
    const int r = idx / kVecs, c = (idx % kVecs) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < L)
      val = *reinterpret_cast<const uint4*>(base + b * sb + (long long)(r0 + r) * sl
                                            + (long long)h * HD + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// The same for f32 tensors of any hd, rows r0 .. r0 + rows - 1, into
// dst [rows][ld].
__device__ __forceinline__ void stage_rows_f32(float* dst, int ld, const float* base,
                                               long long sb, long long sl, int b,
                                               int h, int hd, int r0, int rows, int L) {
  for (int idx = threadIdx.x; idx < rows * hd; idx += blockDim.x) {
    const int r = idx / hd, c = idx % hd;
    dst[r * ld + c] = r0 + r < L ? base[b * sb + (long long)(r0 + r) * sl
                                        + (long long)h * hd + c] : 0.0f;
  }
}

}  // namespace flash
