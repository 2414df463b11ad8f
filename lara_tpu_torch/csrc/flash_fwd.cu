// Flash attention, forward: the Hopper kernels behind
// lara_tpu_torch/ops/flash.py:flash_mha (_FlashFunction.forward).
//
// Replaces the TPU kernel lara_tpu/ops/flash.py:78 flash_mha, which runs
// JAX's bundled Pallas TPU flash attention (_fa.flash_attention, :113) with
// SegmentIds masking the padding to 128 and the optional kv_mask. Here the
// kernel masks the ragged edge itself (flash_common.cuh), and no sequence is
// padded in memory.
//
// What it computes. For every sequence b, head h and query i:
//   o_i = sum_j softmax_j(s_ij) v_j,   s_ij = (q_i . k_j) scale,
// with s_ij = -1e9 for a key that kv_mask excludes, and the row log-sum-exp
// lse_i = m_i + log(sum_j exp(s_ij - m_i)) (f32 [B*H, Lq]) for the backward.
// S, the running max m and sum l and the O accumulator are f32; O is written
// in the input dtype.
//
// Layout. One CTA per (sequence*head, block of 64 queries); the loop over
// the keys walks blocks of 64 staged in shared memory, with an online
// softmax: per key block, S = Q K^T, m_new = max(m, rowmax S),
// P = exp(S - m_new), l = l exp(m - m_new) + rowsum P,
// O = O exp(m - m_new) + P V, and o = O / l at the end.
//  - bf16 (the flagship's autocast): 4 warps, each owns 16 query rows. S and
//    P V are products on the tensor cores through WMMA (bf16 operands, f32
//    accumulation, 16x16x16 tiles, mma.sync underneath), staged through
//    shared memory, where two lanes per row do the row max, the exponentials
//    and the rescaling. P is rounded to bf16 before P V (as the plain
//    version rounds nothing, this is the one rounding the kernel adds inside
//    a row; the bar in chip_smoke.py follows from it). head_dim a multiple
//    of 16 up to 128, a template parameter.
//  - f32 (the reduced check's f32 net, head_dim 12): one thread per query
//    row, plain FMA in f32, keys in blocks of 32 broadcast from shared
//    memory, any head_dim up to 128.
// Built without --fmad=false: nothing here decides on a threshold.
//
// What bounds it on this card. At the train shape (12 sequences of 1025
// tokens, 12 heads of 64) one layer's forward is 4 * 1025^2 * 64 * 12 * 12
// = 3.87e10 flops: 39 us at 989 TFLOP/s (bf16 dense), against 23 us for the
// 75.6 MB of q, k, v and o at 3.35 TB/s, so it is compute-bound. WMMA
// through mma.sync reaches a fraction of what wgmma would; wgmma, TMA and
// warp specialisation are later work.

#include <mma.h>

#include "flash_common.cuh"

namespace {

using namespace nvcuda;
using flash::kBlock;
using flash::kThreads;
using flash::Problem;
using bf16 = __nv_bfloat16;

template <int HD>
struct TileLd {
  static constexpr int kK = HD + 8;                       // bf16 [64][HD] tiles
  static constexpr int kP = kBlock + 8;                   // bf16 [16][64] per warp
  static constexpr int kF = (HD > kBlock ? HD : kBlock) + 4;  // f32 [16][.] per warp
  static constexpr size_t kSmem = sizeof(bf16) * 3 * kBlock * kK
                                  + sizeof(float) * flash::kWarps * 16 * kF
                                  + sizeof(bf16) * flash::kWarps * 16 * kP;
};

template <int HD>
__global__ void __launch_bounds__(kThreads)
fwd_bf16(Problem p, bf16* __restrict__ o, float* __restrict__ lse) {
  using Ld = TileLd<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kBlock * Ld::kK;
  bf16* sV = sK + kBlock * Ld::kK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* sF = reinterpret_cast<float*>(sV + kBlock * Ld::kK) + warp * 16 * Ld::kF;
  bf16* sP = reinterpret_cast<bf16*>(reinterpret_cast<float*>(sV + kBlock * Ld::kK)
                                     + flash::kWarps * 16 * Ld::kF) + warp * 16 * Ld::kP;

  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * kBlock;
  const auto* q = static_cast<const bf16*>(p.q);
  const auto* k = static_cast<const bf16*>(p.k);
  const auto* v = static_cast<const bf16*>(p.v);
  flash::stage_tile<HD>(sQ, Ld::kK, q, p.q_sb, p.q_sl, b, h, q0, p.Lq);

  // two lanes per row: row r, columns [half * 32, half * 32 + 32) of S and
  // [half * HD / 2, (half + 1) * HD / 2) of O
  const int r = lane >> 1, half = lane & 1;
  constexpr int kOc = HD / 2;
  float acc[kOc];
#pragma unroll
  for (int d = 0; d < kOc; ++d) acc[d] = 0.0f;
  float m_run = -CUDART_INF_F, l_run = 0.0f;

  for (int j0 = 0; j0 < p.Lk; j0 += kBlock) {
    __syncthreads();  // the previous block's K and V are no longer read
    flash::stage_tile<HD>(sK, Ld::kK, k, p.k_sb, p.k_sl, b, h, j0, p.Lk);
    flash::stage_tile<HD>(sV, Ld::kK, v, p.v_sb, p.v_sl, b, h, j0, p.Lk);
    __syncthreads();

    // S_w [16 x 64] = Q_w K^T
    for (int n = 0; n < kBlock / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
      wmma::fill_fragment(s, 0.0f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
        wmma::load_matrix_sync(a, sQ + warp * 16 * Ld::kK + kk * 16, Ld::kK);
        wmma::load_matrix_sync(bt, sK + n * 16 * Ld::kK + kk * 16, Ld::kK);
        wmma::mma_sync(s, a, bt, s);
      }
      wmma::store_matrix_sync(sF + n * 16, s, Ld::kF, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax of the row: logits, max, P (bf16 into shared memory)
    float sv[32];
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int col = half * 32 + c;
      sv[c] = flash::logit(p, b, j0 + col, sF[r * Ld::kF + col]);
      mx = fmaxf(mx, sv[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    // key 0 is real and lies in the first block, so m_new is finite
    const float m_new = fmaxf(m_run, mx);
    const float corr = __expf(m_run - m_new);
    float rs = 0.0f;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float pv = __expf(sv[c] - m_new);
      rs += pv;
      sP[r * Ld::kP + half * 32 + c] = __float2bfloat16(pv);
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    l_run = l_run * corr + rs;
    m_run = m_new;
    __syncwarp();  // S read, P written: sF takes P V next

    // P V [16 x HD] on the tensor cores, added to the rescaled O
    for (int n = 0; n < HD / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> pv;
      wmma::fill_fragment(pv, 0.0f);
#pragma unroll
      for (int kk = 0; kk < kBlock / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, sP + kk * 16, Ld::kP);
        wmma::load_matrix_sync(bv, sV + kk * 16 * Ld::kK + n * 16, Ld::kK);
        wmma::mma_sync(pv, a, bv, pv);
      }
      wmma::store_matrix_sync(sF + n * 16, pv, Ld::kF, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int d = 0; d < kOc; ++d)
      acc[d] = acc[d] * corr + sF[r * Ld::kF + half * kOc + d];
    __syncwarp();  // sF is overwritten by the next block's S
  }

  const int i = q0 + warp * 16 + r;
  if (i < p.Lq) {
    const float inv_l = 1.0f / l_run;
    bf16* orow = o + ((size_t)(b * p.Lq + i) * p.H + h) * HD + half * kOc;
#pragma unroll
    for (int d = 0; d < kOc; ++d) orow[d] = __float2bfloat16(acc[d] * inv_l);
    if (half == 0) lse[(size_t)bh * p.Lq + i] = m_run + logf(l_run);
  }
}

constexpr int kF32Rows = 64;  // query rows (threads) per CTA
constexpr int kF32Keys = 32;  // keys per staged block

size_t f32_smem(int hd) {
  return sizeof(float) * (2 * kF32Rows * (hd + 1) + 2 * kF32Keys * hd);
}

__global__ void __launch_bounds__(kF32Rows)
fwd_f32(Problem p, float* __restrict__ o, float* __restrict__ lse) {
  extern __shared__ float fsm[];
  const int hd = p.hd, ld = hd + 1;
  float* sQ = fsm;                      // [64][hd + 1], own row per thread
  float* sO = sQ + kF32Rows * ld;       // [64][hd + 1]
  float* sK = sO + kF32Rows * ld;       // [32][hd]
  float* sV = sK + kF32Keys * hd;       // [32][hd]
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * kF32Rows, t = threadIdx.x, i = q0 + t;
  const auto* q = static_cast<const float*>(p.q);
  flash::stage_rows_f32(sQ, ld, q, p.q_sb, p.q_sl, b, h, hd, q0, kF32Rows, p.Lq);
  for (int d = 0; d < hd; ++d) sO[t * ld + d] = 0.0f;
  float m_run = -CUDART_INF_F, l_run = 0.0f;

  for (int j0 = 0; j0 < p.Lk; j0 += kF32Keys) {
    __syncthreads();
    flash::stage_rows_f32(sK, hd, static_cast<const float*>(p.k), p.k_sb, p.k_sl,
                          b, h, hd, j0, kF32Keys, p.Lk);
    flash::stage_rows_f32(sV, hd, static_cast<const float*>(p.v), p.v_sb, p.v_sl,
                          b, h, hd, j0, kF32Keys, p.Lk);
    __syncthreads();
    float sv[kF32Keys];
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int jj = 0; jj < kF32Keys; ++jj) {
      float dot = 0.0f;
      for (int d = 0; d < hd; ++d) dot += sQ[t * ld + d] * sK[jj * hd + d];
      sv[jj] = flash::logit(p, b, j0 + jj, dot);
      mx = fmaxf(mx, sv[jj]);
    }
    const float m_new = fmaxf(m_run, mx);
    const float corr = expf(m_run - m_new);
    float rs = 0.0f;
#pragma unroll
    for (int jj = 0; jj < kF32Keys; ++jj) {
      sv[jj] = expf(sv[jj] - m_new);
      rs += sv[jj];
    }
    l_run = l_run * corr + rs;
    m_run = m_new;
    for (int d = 0; d < hd; ++d) {
      float a = sO[t * ld + d] * corr;
#pragma unroll
      for (int jj = 0; jj < kF32Keys; ++jj) a += sv[jj] * sV[jj * hd + d];
      sO[t * ld + d] = a;
    }
  }
  if (i < p.Lq) {
    float* orow = o + ((size_t)(b * p.Lq + i) * p.H + h) * hd;
    for (int d = 0; d < hd; ++d) orow[d] = sO[t * ld + d] / l_run;
    lse[(size_t)bh * p.Lq + i] = m_run + logf(l_run);
  }
}

template <int HD>
int launch_bf16(const Problem& p, void* o, float* lse, cudaStream_t s) {
  const size_t smem = TileLd<HD>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(fwd_bf16<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.Lq + kBlock - 1) / kBlock, p.B * p.H);
  fwd_bf16<HD><<<grid, kThreads, smem, s>>>(p, static_cast<bf16*>(o), lse);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v [B, L, H, hd] of one dtype (bf16: is_bf16 = 1, else f32), the
// head at stride hd and the dimension at stride 1, batch and sequence
// strides given in elements; kv_mask uint8 [B, Lk] or null; o contiguous
// [B, Lq, H, hd] of the same dtype; lse f32 [B*H, Lq]. bf16 takes head_dim
// 16, 32, ..., 128, f32 any head_dim up to 128.
extern "C" int lara_flash_fwd(const void* q, const void* k, const void* v,
                              const unsigned char* kv_mask, void* o, float* lse,
                              int B, int H, int Lq, int Lk, int hd,
                              long long q_sb, long long q_sl, long long k_sb,
                              long long k_sl, long long v_sb, long long v_sl,
                              float scale, int is_bf16, void* stream) {
  Problem p{q, k, v, kv_mask, B, H, Lq, Lk, hd, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, scale};
  auto s = static_cast<cudaStream_t>(stream);
  if (Lq <= 0 || Lk <= 0 || hd <= 0 || hd > flash::kMaxHd)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!is_bf16) {
    const size_t smem = f32_smem(hd);
    cudaError_t err = cudaFuncSetAttribute(fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((Lq + kF32Rows - 1) / kF32Rows, B * H);
    fwd_f32<<<grid, kF32Rows, smem, s>>>(p, static_cast<float*>(o), lse);
    return static_cast<int>(cudaGetLastError());
  }
  switch (hd) {
    case 16: return launch_bf16<16>(p, o, lse, s);
    case 32: return launch_bf16<32>(p, o, lse, s);
    case 48: return launch_bf16<48>(p, o, lse, s);
    case 64: return launch_bf16<64>(p, o, lse, s);
    case 80: return launch_bf16<80>(p, o, lse, s);
    case 96: return launch_bf16<96>(p, o, lse, s);
    case 112: return launch_bf16<112>(p, o, lse, s);
    case 128: return launch_bf16<128>(p, o, lse, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
