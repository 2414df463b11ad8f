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
// bf16 (the flagship's autocast), any head_dim a multiple of 16 up to 128,
// padded to HDP = 64 or 128 columns (flash_common.cuh):
//  - One CTA per (sequence*head, block of 128 queries): two consumer
//    warpgroups of 64 query rows each, and one producer warpgroup that
//    hands its registers to them (setmaxnreg: 40 and 232 per thread). One
//    producer warp loads Q once by TMA, then walks the key blocks of 64
//    through a ring of four stages (K and V tiles, and the block's kv_mask
//    as a 64-bit word) guarded by full and empty mbarriers, so loads run
//    ahead of the products.
//  - S = Q K^T is wgmma m64n64k16 with both operands K-major in shared
//    memory. The online softmax runs on the accumulator in registers: each
//    thread holds 16 columns of two rows, the row max and sum are
//    reductions in the thread and then over the quad of lanes that shares a
//    row (__shfl_xor 1, 2). Keys past Lk get -inf and masked keys -1e9.
//    Exponentials are exp2 of logits in base-2 units (s scale log2 e), one
//    FFMA and one MUFU.EX2 each on a block inside Lk without a mask.
//  - Software pipeline: key block j issues S_j = Q K_j^T and then
//    O += P_{j-1} V_{j-1}, runs the softmax of S_j while the tensor cores
//    take P_{j-1} V_{j-1}, and returns stage j - 1 to the producer once
//    that is done. Both products retire within the block: ptxas follows
//    which wgmma wait retires which product only inside one iteration, and
//    serialises every wgmma of a loop that keeps one in flight across its
//    back edge (warnings C7514/C7515 in the build log) or that issues one
//    on a branch it cannot prove uniform (C7520: hence the broadcast warp
//    index and the polling loop inside the mbarrier wait's asm). The first
//    block is peeled (no P V yet) rather than branched on.
//  - P is rounded to bf16 in registers and is the register A operand of
//    O += P V (wgmma m64nHDPk16): the f32 accumulator layout of S is the A
//    fragment layout of the next k16 slices, so no value moves between
//    threads; V is the MN-major B operand (the transpose bit), read as TMA
//    left it. O stays in registers, rescaled per block, and is stored from
//    them with rows past Lq masked. Nothing but the TMA-fed operand tiles
//    goes through shared memory. P's rounding to bf16 before P V is the
//    one rounding the kernel adds inside a row (the bar in chip_smoke.py
//    follows from it).
//  - Block sizes. 128 queries share each K and V tile between two
//    warpgroups (half the shared-memory reads per product of one); 64 keys
//    keep S at 32 registers per thread. At L = 1025 (32^2 patches + CLS) the
//    last query block holds one real row and the last key block one real
//    key: a warpgroup whose 64 rows all lie past Lq skips its products, so
//    the padded work is 1088 / 1025 on each axis (12.7 % in all) rather than
//    1152 x 1088 / 1025^2 (19.3 %).
// f32 (the reduced check's f32 net, head_dim 12): one thread per query row,
// plain FMA in f32, keys in blocks of 32 broadcast from shared memory, any
// head_dim up to 128.
// Built without --fmad=false: nothing here decides on a threshold.
//
// What bounds it on this card. At the train shape (12 sequences of 1025
// tokens, 12 heads of 64) one layer's forward is 4 * 1025^2 * 64 * 12 * 12
// = 3.87e10 flops: 39 us at 989 TFLOP/s (bf16 dense), against 23 us for the
// 75.6 MB of q, k, v and o at 3.35 TB/s, so it is compute-bound: wgmma is
// the only way to the tensor cores' full rate, and TMA keeps the loads off
// the consumers' instruction stream.

#include <type_traits>

#include "flash_common.cuh"

namespace {

using flash::Problem;
using bf16 = __nv_bfloat16;

template <int HDP>
struct FwdCfg {
  static constexpr int kBQ = 128, kBK = 64, kStages = 4;
  static constexpr int kThreads = 3 * 128;  // two consumer warpgroups, one producer warpgroup
  static constexpr int kQBytes = HDP / flash::kPanel * kBQ * flash::kPanelBytes;
  static constexpr int kKBytes = HDP / flash::kPanel * kBK * flash::kPanelBytes;  // K or V
  static constexpr int kKOff = kQBytes;                                  // stage s: K, then V
  static constexpr int kBarOff = kKOff + kStages * 2 * kKBytes;
  // Q barrier, full[kStages], empty[kStages], mask word[kStages]
  static constexpr size_t kSmem = kBarOff + 8 * (1 + 3 * kStages) + 1024;
};

template <int HDP>
__global__ void __launch_bounds__(FwdCfg<HDP>::kThreads, 1)
fwd_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
         const __grid_constant__ CUtensorMap tv, Problem p, bf16* __restrict__ o,
         float* __restrict__ lse) {
  using C = FwdCfg<HDP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = flash::smem_base(smem_raw);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + C::kBarOff);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + C::kStages;
  uint64_t* mask_bits = empty + C::kStages;

  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * C::kBQ;
  const int nblk = (p.Lk + C::kBK - 1) / C::kBK;
  const int warp = flash::warp_index(), lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    flash::mbar_init(qbar, 1);
    for (int s = 0; s < C::kStages; ++s) {
      flash::mbar_init(&full[s], 1);
      flash::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    flash::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {
    // producer warpgroup; its first warp loads Q once, then K, V and the
    // mask word of every key block
    flash::producer_regs();
    if (warp == 8) {
      if (lane == 0) {
        flash::mbar_expect_tx(qbar, C::kQBytes);
        flash::tma_tile<HDP>(smem, &tq, qbar, C::kBQ, h, q0, b);
      }
      for (int j = 0; j < nblk; ++j) {
        const int s = j % C::kStages;
        if (j >= C::kStages) flash::mbar_wait(&empty[s], ((j / C::kStages) - 1) & 1);
        const int k0 = j * C::kBK;
        uint64_t bits = ~0ull;
        if (p.kv_mask != nullptr) {
          const unsigned char* m = p.kv_mask + (size_t)b * p.Lk;
          const unsigned lo =
              __ballot_sync(0xffffffffu, k0 + lane < p.Lk && m[k0 + lane] != 0);
          const unsigned hi =
              __ballot_sync(0xffffffffu, k0 + 32 + lane < p.Lk && m[k0 + 32 + lane] != 0);
          bits = (uint64_t)lo | ((uint64_t)hi << 32);
        }
        if (lane == 0) {
          mask_bits[s] = bits;
          unsigned char* st = smem + C::kKOff + s * 2 * C::kKBytes;
          flash::mbar_expect_tx(&full[s], 2 * C::kKBytes);
          flash::tma_tile<HDP>(st, &tk, &full[s], C::kBK, h, k0, b);
          flash::tma_tile<HDP>(st + C::kKBytes, &tv, &full[s], C::kBK, h, k0, b);
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63
    flash::consumer_regs();
    const int wg = warp / 4;
    const int r_lo = q0 + wg * 64 + (warp % 4) * 16 + lane / 4;  // and r_lo + 8
    const float c2 = p.scale * flash::kLog2e;
    const uint32_t q_tile = flash::smem_u32(smem) + wg * 64 * flash::kPanelBytes;
    const uint32_t stages = flash::smem_u32(smem + C::kKOff);

    if (q0 + wg * 64 >= p.Lq) {
      // every row of this warpgroup lies past Lq: release the stages only
      for (int j = 0; j < nblk; ++j) {
        flash::mbar_wait(&full[j % C::kStages], (j / C::kStages) & 1);
        if (lane == 0) flash::mbar_arrive(&empty[j % C::kStages]);
      }
      return;
    }

    float acc[HDP / 2], sc[32];
    uint32_t pa[16];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.0f;
    float m_lo = -CUDART_INF_F, m_hi = -CUDART_INF_F, l_lo = 0.0f, l_hi = 0.0f;

    auto issue_s = [&](int j) {
      const uint32_t k_tile = stages + (j % C::kStages) * 2 * C::kKBytes;
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk)
        flash::SS<64>::mma(sc, flash::desc_k(q_tile, C::kBQ, kk),
                           flash::desc_k(k_tile, C::kBK, kk), kk > 0);
      flash::wg_commit();
    };
    auto issue_pv = [&](int j) {
      const uint32_t v_tile = stages + (j % C::kStages) * 2 * C::kKBytes + C::kKBytes;
#pragma unroll
      for (int t = 0; t < C::kBK / 16; ++t)
        flash::RS<HDP>::mma(acc, pa + 4 * t, flash::desc_mn(v_tile, C::kBK, t));
      flash::wg_commit();
    };
    // the online softmax of S_j in sc: P_j (f32) in sc, m and l updated;
    // returns the factors that take O from the old maxima to the new
    auto softmax = [&](float (&sc)[32], int j, float& corr_lo, float& corr_hi) {
      // logits in base-2 units, masked; the row max over the quad. A block
      // inside Lk without a mask takes the plain path: the max of the raw
      // products, then 2^(s c2 - m) as one FFMA and one MUFU.EX2.
      const uint64_t bits = mask_bits[j % C::kStages];
      const int kbase = j * C::kBK;
      const bool plain = bits == ~0ull && kbase + C::kBK <= p.Lk && c2 > 0.0f;
      float mx_lo = -CUDART_INF_F, mx_hi = -CUDART_INF_F;
      if (plain) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          mx_lo = fmaxf(mx_lo, fmaxf(sc[4 * i], sc[4 * i + 1]));
          mx_hi = fmaxf(mx_hi, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
        }
        mx_lo *= c2;
        mx_hi *= c2;
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = flash::acc_col(i, e, lane);
            const bool past = kbase + col >= p.Lk, on = (bits >> col) & 1;
            float& x0 = sc[4 * i + e];
            float& x1 = sc[4 * i + 2 + e];
            x0 = past ? -CUDART_INF_F : on ? x0 * c2 : flash::kMasked2;
            x1 = past ? -CUDART_INF_F : on ? x1 * c2 : flash::kMasked2;
            mx_lo = fmaxf(mx_lo, x0);
            mx_hi = fmaxf(mx_hi, x1);
          }
        }
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
      }
      // key kbase is real, so the new maxima are finite
      const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
      corr_lo = flash::ex2(m_lo - mn_lo);
      corr_hi = flash::ex2(m_hi - mn_hi);
      m_lo = mn_lo;
      m_hi = mn_hi;
      const float mul = plain ? c2 : 1.0f;
      float sum_lo = 0.0f, sum_hi = 0.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[4 * i + e] = flash::ex2(fmaf(sc[4 * i + e], mul, -mn_lo));
          sc[4 * i + 2 + e] = flash::ex2(fmaf(sc[4 * i + 2 + e], mul, -mn_hi));
          sum_lo += sc[4 * i + e];
          sum_hi += sc[4 * i + 2 + e];
        }
      }
      // this thread's share of the row sums; the quad adds them at the end
      l_lo = l_lo * corr_lo + sum_lo;
      l_hi = l_hi * corr_hi + sum_hi;
    };
    // key block j: issue S_j = Q K_j^T and then O += P_{j-1} V_{j-1}, run
    // the softmax of S_j while the tensor cores take P_{j-1} V_{j-1}, and
    // retire both before the next block, so no product is in flight across
    // the loop's back edge (the compiler follows the waits only within it)
    auto step = [&](int j, auto first) {
      constexpr bool kFirst = decltype(first)::value;
      flash::mbar_wait(&full[j % C::kStages], (j / C::kStages) & 1);
      flash::wg_fence();
      issue_s(j);
      if constexpr (!kFirst) issue_pv(j - 1);
      if constexpr (kFirst) flash::wg_wait<0>();
      else flash::wg_wait<1>();  // S_j
      flash::fence_acc(sc);
      float corr_lo, corr_hi;
      softmax(sc, j, corr_lo, corr_hi);
      if constexpr (!kFirst) {
        // P_{j-1} V_{j-1} done: O and P_{j-1}'s registers are free, and
        // stage j - 1 goes back to the producer
        flash::wg_wait<0>();
        flash::fence_acc(acc);
        flash::fence_acc(sc);
        if (lane == 0) flash::mbar_arrive(&empty[(j - 1) % C::kStages]);
#pragma unroll
        for (int i = 0; i < HDP / 8; ++i) {
          acc[4 * i] *= corr_lo;
          acc[4 * i + 1] *= corr_lo;
          acc[4 * i + 2] *= corr_hi;
          acc[4 * i + 3] *= corr_hi;
        }
      }
      flash::acc_to_a(sc, pa);
    };

    flash::mbar_wait(qbar, 0);
    step(0, std::true_type{});
    for (int j = 1; j < nblk; ++j) step(j, std::false_type{});
    flash::wg_fence();
    issue_pv(nblk - 1);
    flash::wg_wait<0>();
    flash::fence_acc(acc);

#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
    }
    flash::store_rows<HDP>(acc, 1.0f / l_lo, 1.0f / l_hi, o, b, h, p.H, p.Lq, p.hd, r_lo,
                           lane);
    if ((lane & 3) == 0) {
      if (r_lo < p.Lq) lse[(size_t)bh * p.Lq + r_lo] = m_lo * flash::kLn2 + logf(l_lo);
      if (r_lo + 8 < p.Lq) lse[(size_t)bh * p.Lq + r_lo + 8] = m_hi * flash::kLn2 + logf(l_hi);
    }
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

template <int HDP>
int launch_bf16(const Problem& p, void* o, float* lse, cudaStream_t s) {
  using C = FwdCfg<HDP>;
  CUtensorMap tq, tk, tv;
  int err = flash::make_map(&tq, p.q, p.B, p.Lq, p.H, p.hd, p.q_sb, p.q_sl, C::kBQ);
  if (err == 0) err = flash::make_map(&tk, p.k, p.B, p.Lk, p.H, p.hd, p.k_sb, p.k_sl, C::kBK);
  if (err == 0) err = flash::make_map(&tv, p.v, p.B, p.Lk, p.H, p.hd, p.v_sb, p.v_sl, C::kBK);
  if (err != 0) return err;
  dim3 grid((p.Lq + C::kBQ - 1) / C::kBQ, p.B * p.H);
  return flash::launch(fwd_bf16<HDP>, grid, C::kThreads, C::kSmem, s, tq, tk, tv, p,
                       static_cast<bf16*>(o), lse);
}

}  // namespace

// q, k, v [B, L, H, hd] of one dtype (bf16: is_bf16 = 1, else f32), the
// head at stride hd and the dimension at stride 1, batch and sequence
// strides given in elements (for bf16 multiples of 8, the base 16-byte
// aligned: TMA's terms); kv_mask uint8 [B, Lk] or null; o contiguous
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
    dim3 grid((Lq + kF32Rows - 1) / kF32Rows, B * H);
    return flash::launch(fwd_f32, grid, kF32Rows, f32_smem(hd), s, p, static_cast<float*>(o),
                         lse);
  }
  if (hd % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return hd <= 64 ? launch_bf16<64>(p, o, lse, s) : launch_bf16<128>(p, o, lse, s);
}

// Dynamic shared memory per CTA of the bf16 forward kernel at head_dim hd.
extern "C" int lara_flash_fwd_smem(int hd) {
  return static_cast<int>(hd <= 64 ? FwdCfg<64>::kSmem : FwdCfg<128>::kSmem);
}
