// Flash attention, backward: the Hopper kernels behind
// lara_tpu_torch/ops/flash.py:flash_mha (_FlashFunction.backward).
//
// Replaces the backward of the TPU kernel lara_tpu/ops/flash.py:78
// flash_mha: the two backward Pallas kernels of JAX's bundled flash
// attention (dK/dV and dQ) behind its custom VJP (:62-75).
//
// What it computes: the FlashAttention-2 backward, from the forward's row
// log-sum-exp, without the [L, L] probabilities in device memory:
//   D_i  = sum_d dO_id O_id                               (f32)
//   P_ij = exp(s_ij - lse_i),  s_ij = (q_i . k_j) scale (masked as forward)
//   dV_j = sum_i P_ij dO_i
//   dP_ij = dO_i . v_j,  dS_ij = P_ij (dP_ij - D_i)
//   dK_j = scale sum_i dS_ij q_i,   dQ_i = scale sum_j dS_ij k_j
// A key that kv_mask excludes or that lies past Lk gets dS = 0 (its logit
// is a constant); a query past Lq gets P = 0, so it adds nothing.
//
// Layout: three kernels per call, no atomics, so every run gives the same
// bits.
//  1. rowdot: D, one thread per (query, head).
//  2. dkdv: one CTA per (sequence*head, block of 64 keys), looping over the
//     query blocks; dK and dV stay in accumulators for the whole loop.
//  3. dq: one CTA per (sequence*head, block of 64 queries), looping over
//     the key blocks.
//  - bf16: 4 warps, each owns 16 rows of the CTA's block; every product
//    (S, dP, dV, dK, dQ) runs on the tensor cores through WMMA (bf16
//    operands, f32 accumulation), with P and dS rounded to bf16 as their
//    operands; S and dP go through shared memory, where two lanes per row
//    form P and dS in f32. head_dim a multiple of 16 up to 128.
//  - f32: one thread per key (dkdv) or query (dq) row, plain FMA in f32,
//    the other side's rows broadcast from shared memory in blocks of 32;
//    any head_dim up to 128.
// Built without --fmad=false: nothing here decides on a threshold.
//
// What bounds it on this card. The algorithm needs five products of the
// forward's size (S recomputed, dP, dV, dK, dQ): 2.5 x the forward's flops,
// 2.5 * 3.87e10 = 9.67e10 at the train shape (12 x 1025 tokens, 12 heads of
// 64), 98 us at 989 TFLOP/s, against 45 us for its 151 MB (q, k, v, o, dO
// read, dq, dk, dv written) at 3.35 TB/s: compute-bound. These kernels
// recompute S in both passes (seven products in all) and use WMMA through
// mma.sync, not wgmma.

#include <mma.h>

#include "flash_common.cuh"

namespace {

using namespace nvcuda;
using flash::kBlock;
using flash::kThreads;
using flash::Problem;
using bf16 = __nv_bfloat16;

struct Grads {
  const void* o;
  const void* dout;
  const float* lse;
  float* dsum;  // D [B*H, Lq]
  void* dq;
  void* dk;
  void* dv;
};

template <typename T>
__global__ void rowdot(Problem p, Grads g) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long rows = (long long)p.B * p.Lq * p.H;
  if (row >= rows) return;
  const T* o = static_cast<const T*>(g.o) + row * p.hd;
  const T* d = static_cast<const T*>(g.dout) + row * p.hd;
  float s = 0.0f;
  for (int c = 0; c < p.hd; ++c) s += flash::to_float(o[c]) * flash::to_float(d[c]);
  const int h = row % p.H;
  const long long bi = row / p.H;
  const int i = bi % p.Lq, b = bi / p.Lq;
  g.dsum[((long long)b * p.H + h) * p.Lq + i] = s;
}

template <int HD>
struct TileLd {
  static constexpr int kK = HD + 8;
  static constexpr int kP = kBlock + 8;
  static constexpr int kF = (HD > kBlock ? HD : kBlock) + 4;
  static constexpr size_t kSmem = sizeof(bf16) * 4 * kBlock * kK
                                  + sizeof(float) * 2 * kBlock
                                  + sizeof(float) * flash::kWarps * 16 * kF
                                  + sizeof(bf16) * flash::kWarps * 16 * kP;
};

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// out_w [16 x 64] (f32, ld kF) = A_w [16 x HD] . B^T, B [64 x HD]
template <int HD>
__device__ __forceinline__ void rows_times_tile_t(float* out, const bf16* a_rows,
                                                  const bf16* b_tile) {
  using Ld = TileLd<HD>;
  for (int n = 0; n < kBlock / 16; ++n) {
    FragC c;
    wmma::fill_fragment(c, 0.0f);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      FragA a;
      FragBCol bt;
      wmma::load_matrix_sync(a, a_rows + kk * 16, Ld::kK);
      wmma::load_matrix_sync(bt, b_tile + n * 16 * Ld::kK + kk * 16, Ld::kK);
      wmma::mma_sync(c, a, bt, c);
    }
    wmma::store_matrix_sync(out + n * 16, c, Ld::kF, wmma::mem_row_major);
  }
}

// acc[n] += X_w [16 x 64] (bf16, ld kP) . B [64 x HD], for the HD/16 column tiles
template <int HD>
__device__ __forceinline__ void accumulate(FragC* acc, const bf16* x, const bf16* b_tile) {
  using Ld = TileLd<HD>;
#pragma unroll
  for (int n = 0; n < HD / 16; ++n) {
#pragma unroll
    for (int kk = 0; kk < kBlock / 16; ++kk) {
      FragA a;
      FragBRow bm;
      wmma::load_matrix_sync(a, x + kk * 16, Ld::kP);
      wmma::load_matrix_sync(bm, b_tile + kk * 16 * Ld::kK + n * 16, Ld::kK);
      wmma::mma_sync(acc[n], a, bm, acc[n]);
    }
  }
}

// Write a warp's [16 x HD] accumulator times `scale` as bf16 rows of the
// contiguous [B, L, H, HD] tensor dst, rows r0 + 0..15 below L.
template <int HD>
__device__ __forceinline__ void store_rows(FragC* acc, float scale, float* stage,
                                           bf16* dst, int b, int h, int H, int r0,
                                           int L, int lane) {
  using Ld = TileLd<HD>;
#pragma unroll
  for (int n = 0; n < HD / 16; ++n) {
#pragma unroll
    for (int e = 0; e < acc[n].num_elements; ++e) acc[n].x[e] *= scale;
    wmma::store_matrix_sync(stage + n * 16, acc[n], Ld::kF, wmma::mem_row_major);
  }
  __syncwarp();
  for (int idx = lane; idx < 16 * HD; idx += 32) {
    const int r = idx / HD, c = idx % HD;
    if (r0 + r < L)
      dst[((size_t)(b * L + r0 + r) * H + h) * HD + c] = __float2bfloat16(stage[r * Ld::kF + c]);
  }
  __syncwarp();
}

template <int HD>
__global__ void __launch_bounds__(kThreads) dkdv_bf16(Problem p, Grads g) {
  using Ld = TileLd<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kBlock * Ld::kK;
  bf16* sQ = sV + kBlock * Ld::kK;
  bf16* sO = sQ + kBlock * Ld::kK;   // dO of the query block
  float* sLse = reinterpret_cast<float*>(sO + kBlock * Ld::kK);
  float* sD = sLse + kBlock;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* sF = sD + kBlock + warp * 16 * Ld::kF;
  bf16* sB = reinterpret_cast<bf16*>(sD + kBlock + flash::kWarps * 16 * Ld::kF)
             + warp * 16 * Ld::kP;

  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.x * kBlock;
  const long long o_sb = (long long)p.Lq * p.H * HD, o_sl = (long long)p.H * HD;
  flash::stage_tile<HD>(sK, Ld::kK, static_cast<const bf16*>(p.k), p.k_sb, p.k_sl, b, h, k0, p.Lk);
  flash::stage_tile<HD>(sV, Ld::kK, static_cast<const bf16*>(p.v), p.v_sb, p.v_sl, b, h, k0, p.Lk);

  // lanes: key row r of the warp, query columns [half * 32, half * 32 + 32)
  const int r = lane >> 1, half = lane & 1;
  const int j = k0 + warp * 16 + r;
  const bool live = flash::key_live(p, b, j);
  FragC dk[HD / 16], dv[HD / 16];
#pragma unroll
  for (int n = 0; n < HD / 16; ++n) {
    wmma::fill_fragment(dk[n], 0.0f);
    wmma::fill_fragment(dv[n], 0.0f);
  }

  for (int i0 = 0; i0 < p.Lq; i0 += kBlock) {
    __syncthreads();
    flash::stage_tile<HD>(sQ, Ld::kK, static_cast<const bf16*>(p.q), p.q_sb, p.q_sl, b, h, i0, p.Lq);
    flash::stage_tile<HD>(sO, Ld::kK, static_cast<const bf16*>(g.dout), o_sb, o_sl, b, h, i0, p.Lq);
    for (int t = threadIdx.x; t < kBlock; t += blockDim.x) {
      const bool ok = i0 + t < p.Lq;
      sLse[t] = ok ? g.lse[(size_t)bh * p.Lq + i0 + t] : 0.0f;
      sD[t] = ok ? g.dsum[(size_t)bh * p.Lq + i0 + t] : 0.0f;
    }
    __syncthreads();

    // S^T_w [16 keys x 64 queries] = K_w Q^T, then P^T
    rows_times_tile_t<HD>(sF, sK + warp * 16 * Ld::kK, sQ);
    __syncwarp();
    float pr[32];
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int qi = half * 32 + c;
      const float s = flash::logit(p, b, j, sF[r * Ld::kF + qi]);
      pr[c] = i0 + qi < p.Lq ? __expf(s - sLse[qi]) : 0.0f;
      sB[r * Ld::kP + qi] = __float2bfloat16(pr[c]);
    }
    __syncwarp();
    accumulate<HD>(dv, sB, sO);                       // dV += P^T dO
    rows_times_tile_t<HD>(sF, sV + warp * 16 * Ld::kK, sO);   // dP^T = V dO^T
    __syncwarp();
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int qi = half * 32 + c;
      const float ds = live ? pr[c] * (sF[r * Ld::kF + qi] - sD[qi]) : 0.0f;
      sB[r * Ld::kP + qi] = __float2bfloat16(ds);
    }
    __syncwarp();
    accumulate<HD>(dk, sB, sQ);                       // dK += dS^T Q
    __syncwarp();
  }
  store_rows<HD>(dk, p.scale, sF, static_cast<bf16*>(g.dk), b, h, p.H,
                 k0 + warp * 16, p.Lk, lane);
  store_rows<HD>(dv, 1.0f, sF, static_cast<bf16*>(g.dv), b, h, p.H,
                 k0 + warp * 16, p.Lk, lane);
}

template <int HD>
__global__ void __launch_bounds__(kThreads) dq_bf16(Problem p, Grads g) {
  using Ld = TileLd<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sO = sQ + kBlock * Ld::kK;   // dO of the query block
  bf16* sK = sO + kBlock * Ld::kK;
  bf16* sV = sK + kBlock * Ld::kK;
  float* base = reinterpret_cast<float*>(sV + kBlock * Ld::kK) + 2 * kBlock;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* sF = base + warp * 16 * Ld::kF;
  bf16* sB = reinterpret_cast<bf16*>(base + flash::kWarps * 16 * Ld::kF) + warp * 16 * Ld::kP;

  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int i0 = blockIdx.x * kBlock;
  const long long o_sb = (long long)p.Lq * p.H * HD, o_sl = (long long)p.H * HD;
  flash::stage_tile<HD>(sQ, Ld::kK, static_cast<const bf16*>(p.q), p.q_sb, p.q_sl, b, h, i0, p.Lq);
  flash::stage_tile<HD>(sO, Ld::kK, static_cast<const bf16*>(g.dout), o_sb, o_sl, b, h, i0, p.Lq);

  // lanes: query row r of the warp, key columns [half * 32, half * 32 + 32)
  const int r = lane >> 1, half = lane & 1;
  const int i = i0 + warp * 16 + r;
  const bool q_ok = i < p.Lq;
  const float lse_i = q_ok ? g.lse[(size_t)bh * p.Lq + i] : 0.0f;
  const float d_i = q_ok ? g.dsum[(size_t)bh * p.Lq + i] : 0.0f;
  FragC dq[HD / 16];
#pragma unroll
  for (int n = 0; n < HD / 16; ++n) wmma::fill_fragment(dq[n], 0.0f);

  for (int j0 = 0; j0 < p.Lk; j0 += kBlock) {
    __syncthreads();
    flash::stage_tile<HD>(sK, Ld::kK, static_cast<const bf16*>(p.k), p.k_sb, p.k_sl, b, h, j0, p.Lk);
    flash::stage_tile<HD>(sV, Ld::kK, static_cast<const bf16*>(p.v), p.v_sb, p.v_sl, b, h, j0, p.Lk);
    __syncthreads();

    rows_times_tile_t<HD>(sF, sQ + warp * 16 * Ld::kK, sK);   // S_w = Q_w K^T
    __syncwarp();
    float pr[32];
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int col = half * 32 + c;
      const float s = flash::logit(p, b, j0 + col, sF[r * Ld::kF + col]);
      pr[c] = q_ok ? __expf(s - lse_i) : 0.0f;
    }
    __syncwarp();
    rows_times_tile_t<HD>(sF, sO + warp * 16 * Ld::kK, sV);   // dP_w = dO_w V^T
    __syncwarp();
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int col = half * 32 + c;
      const float ds = flash::key_live(p, b, j0 + col)
                           ? pr[c] * (sF[r * Ld::kF + col] - d_i) : 0.0f;
      sB[r * Ld::kP + col] = __float2bfloat16(ds);
    }
    __syncwarp();
    accumulate<HD>(dq, sB, sK);                       // dQ += dS K
    __syncwarp();
  }
  store_rows<HD>(dq, p.scale, sF, static_cast<bf16*>(g.dq), b, h, p.H,
                 i0 + warp * 16, p.Lq, lane);
}

constexpr int kF32Rows = 64;  // own rows (threads) per CTA
constexpr int kF32Other = 32; // rows of the other side per staged block

size_t f32_smem(int hd) {
  return sizeof(float) * (4 * kF32Rows * (hd + 1) + 2 * kF32Other * hd + 2 * kF32Other);
}

__global__ void __launch_bounds__(kF32Rows) dkdv_f32(Problem p, Grads g) {
  extern __shared__ float fsm[];
  const int hd = p.hd, ld = hd + 1;
  float* sK = fsm;                       // own rows [64][hd + 1]
  float* sV = sK + kF32Rows * ld;
  float* sdK = sV + kF32Rows * ld;
  float* sdV = sdK + kF32Rows * ld;
  float* sQ = sdV + kF32Rows * ld;       // [32][hd]
  float* sO = sQ + kF32Other * hd;       // dO [32][hd]
  float* sLse = sO + kF32Other * hd;
  float* sD = sLse + kF32Other;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.x * kF32Rows, t = threadIdx.x, j = k0 + t;
  const long long o_sb = (long long)p.Lq * p.H * hd, o_sl = (long long)p.H * hd;
  flash::stage_rows_f32(sK, ld, static_cast<const float*>(p.k), p.k_sb, p.k_sl, b, h, hd,
                        k0, kF32Rows, p.Lk);
  flash::stage_rows_f32(sV, ld, static_cast<const float*>(p.v), p.v_sb, p.v_sl, b, h, hd,
                        k0, kF32Rows, p.Lk);
  for (int d = 0; d < hd; ++d) sdK[t * ld + d] = sdV[t * ld + d] = 0.0f;
  const bool live = flash::key_live(p, b, j);

  for (int i0 = 0; i0 < p.Lq; i0 += kF32Other) {
    __syncthreads();
    flash::stage_rows_f32(sQ, hd, static_cast<const float*>(p.q), p.q_sb, p.q_sl, b, h, hd,
                          i0, kF32Other, p.Lq);
    flash::stage_rows_f32(sO, hd, static_cast<const float*>(g.dout), o_sb, o_sl, b, h, hd,
                          i0, kF32Other, p.Lq);
    for (int u = t; u < kF32Other; u += blockDim.x) {
      const bool ok = i0 + u < p.Lq;
      sLse[u] = ok ? g.lse[(size_t)bh * p.Lq + i0 + u] : 0.0f;
      sD[u] = ok ? g.dsum[(size_t)bh * p.Lq + i0 + u] : 0.0f;
    }
    __syncthreads();
    for (int u = 0; u < kF32Other && i0 + u < p.Lq; ++u) {
      float dot = 0.0f, dp = 0.0f;
      for (int d = 0; d < hd; ++d) {
        dot += sQ[u * hd + d] * sK[t * ld + d];
        dp += sO[u * hd + d] * sV[t * ld + d];
      }
      const float pij = expf(flash::logit(p, b, j, dot) - sLse[u]);
      const float ds = live ? pij * (dp - sD[u]) : 0.0f;
      for (int d = 0; d < hd; ++d) {
        sdV[t * ld + d] += pij * sO[u * hd + d];
        sdK[t * ld + d] += ds * sQ[u * hd + d];
      }
    }
  }
  if (j < p.Lk) {
    const size_t row = ((size_t)(b * p.Lk + j) * p.H + h) * hd;
    float* dk = static_cast<float*>(g.dk) + row;
    float* dv = static_cast<float*>(g.dv) + row;
    for (int d = 0; d < hd; ++d) {
      dk[d] = sdK[t * ld + d] * p.scale;
      dv[d] = sdV[t * ld + d];
    }
  }
}

__global__ void __launch_bounds__(kF32Rows) dq_f32(Problem p, Grads g) {
  extern __shared__ float fsm[];
  const int hd = p.hd, ld = hd + 1;
  float* sQ = fsm;                       // own rows [64][hd + 1]
  float* sO = sQ + kF32Rows * ld;        // dO, own rows
  float* sdQ = sO + kF32Rows * ld;
  float* sK = sdQ + kF32Rows * ld;       // [32][hd]
  float* sV = sK + kF32Other * hd;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int i0 = blockIdx.x * kF32Rows, t = threadIdx.x, i = i0 + t;
  const long long o_sb = (long long)p.Lq * p.H * hd, o_sl = (long long)p.H * hd;
  flash::stage_rows_f32(sQ, ld, static_cast<const float*>(p.q), p.q_sb, p.q_sl, b, h, hd,
                        i0, kF32Rows, p.Lq);
  flash::stage_rows_f32(sO, ld, static_cast<const float*>(g.dout), o_sb, o_sl, b, h, hd,
                        i0, kF32Rows, p.Lq);
  for (int d = 0; d < hd; ++d) sdQ[t * ld + d] = 0.0f;
  const bool q_ok = i < p.Lq;
  const float lse_i = q_ok ? g.lse[(size_t)bh * p.Lq + i] : 0.0f;
  const float d_i = q_ok ? g.dsum[(size_t)bh * p.Lq + i] : 0.0f;

  for (int j0 = 0; j0 < p.Lk; j0 += kF32Other) {
    __syncthreads();
    flash::stage_rows_f32(sK, hd, static_cast<const float*>(p.k), p.k_sb, p.k_sl, b, h, hd,
                          j0, kF32Other, p.Lk);
    flash::stage_rows_f32(sV, hd, static_cast<const float*>(p.v), p.v_sb, p.v_sl, b, h, hd,
                          j0, kF32Other, p.Lk);
    __syncthreads();
    for (int u = 0; u < kF32Other && j0 + u < p.Lk; ++u) {
      float dot = 0.0f, dp = 0.0f;
      for (int d = 0; d < hd; ++d) {
        dot += sQ[t * ld + d] * sK[u * hd + d];
        dp += sO[t * ld + d] * sV[u * hd + d];
      }
      const float pij = expf(flash::logit(p, b, j0 + u, dot) - lse_i);
      const float ds = flash::key_live(p, b, j0 + u) ? pij * (dp - d_i) : 0.0f;
      for (int d = 0; d < hd; ++d) sdQ[t * ld + d] += ds * sK[u * hd + d];
    }
  }
  if (q_ok) {
    float* dq = static_cast<float*>(g.dq) + ((size_t)(b * p.Lq + i) * p.H + h) * hd;
    for (int d = 0; d < hd; ++d) dq[d] = sdQ[t * ld + d] * p.scale;
  }
}

template <typename K>
int launch(K kernel, dim3 grid, int threads, size_t smem, cudaStream_t s,
           const Problem& p, const Grads& g) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, s>>>(p, g);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_bf16(const Problem& p, const Grads& g, cudaStream_t s) {
  const size_t smem = TileLd<HD>::kSmem;
  int err = launch(dkdv_bf16<HD>, dim3((p.Lk + kBlock - 1) / kBlock, p.B * p.H),
                   kThreads, smem, s, p, g);
  if (err != 0) return err;
  return launch(dq_bf16<HD>, dim3((p.Lq + kBlock - 1) / kBlock, p.B * p.H),
                kThreads, smem, s, p, g);
}

}  // namespace

// The tensors of lara_flash_fwd, plus dout (the cotangent of o, contiguous
// like o), dsum f32 [B*H, Lq] scratch for D, and dq, dk, dv contiguous
// [B, L, H, hd] in the input dtype (every element written).
extern "C" int lara_flash_bwd(const void* q, const void* k, const void* v,
                              const unsigned char* kv_mask, const void* o,
                              const void* dout, const float* lse, float* dsum,
                              void* dq, void* dk, void* dv,
                              int B, int H, int Lq, int Lk, int hd,
                              long long q_sb, long long q_sl, long long k_sb,
                              long long k_sl, long long v_sb, long long v_sl,
                              float scale, int is_bf16, void* stream) {
  Problem p{q, k, v, kv_mask, B, H, Lq, Lk, hd, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, scale};
  Grads g{o, dout, lse, dsum, dq, dk, dv};
  auto s = static_cast<cudaStream_t>(stream);
  if (Lq <= 0 || Lk <= 0 || hd <= 0 || hd > flash::kMaxHd)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = (long long)B * Lq * H;
  const int per = 256;
  if (is_bf16)
    rowdot<bf16><<<(unsigned)((rows + per - 1) / per), per, 0, s>>>(p, g);
  else
    rowdot<float><<<(unsigned)((rows + per - 1) / per), per, 0, s>>>(p, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!is_bf16) {
    const size_t smem = f32_smem(hd);
    int e = launch(dkdv_f32, dim3((Lk + kF32Rows - 1) / kF32Rows, B * H), kF32Rows, smem, s, p, g);
    if (e != 0) return e;
    return launch(dq_f32, dim3((Lq + kF32Rows - 1) / kF32Rows, B * H), kF32Rows, smem, s, p, g);
  }
  switch (hd) {
    case 16: return launch_bf16<16>(p, g, s);
    case 32: return launch_bf16<32>(p, g, s);
    case 48: return launch_bf16<48>(p, g, s);
    case 64: return launch_bf16<64>(p, g, s);
    case 80: return launch_bf16<80>(p, g, s);
    case 96: return launch_bf16<96>(p, g, s);
    case 112: return launch_bf16<112>(p, g, s);
    case 128: return launch_bf16<128>(p, g, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
