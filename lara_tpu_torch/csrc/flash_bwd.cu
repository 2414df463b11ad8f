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
//  1. rowdot: D. bf16: hd / 8 lanes per row (16-byte loads), summed over
//     the lanes by __shfl_xor; f32: one thread per (query, head).
//  2. dkdv: one CTA per (sequence*head, block of 128 keys): two consumer
//     warpgroups of 64 key rows and one producer warpgroup (setmaxnreg: 40
//     registers per thread for it, 232 for the consumers), of which one
//     warp works. K and V come in once by TMA; Q and dO tiles of BQ
//     queries, with the block's lse and D, through a TMA ring of four
//     stages (full and empty mbarriers). Per query
//     block, both products of the block's size, S^T = K Q^T and
//     dP^T = V dO^T (wgmma, operands K-major in shared memory), then P^T and
//     dS^T = P^T (dP^T - D) in registers (zero where the key is not live),
//     then dV += P^T dO and dK += dS^T Q with P^T and dS^T as the register A
//     operand (the accumulator layout of a [64 x BQ] product is the A
//     fragment of its k16 slices) and dO and Q as MN-major B operands
//     (transpose bit) from the same tiles. dK and dV stay in registers for
//     the whole loop; dK is scaled once at the end. Query block i issues
//     S^T_i, dP^T_i and then dV, dK of block i - 1, so the exponentials of
//     block i run while dP^T_i and the block before's dV, dK are on the
//     tensor cores; all three retire within the block (as in the forward,
//     ptxas serialises wgmma kept in flight across a loop's back edge), and
//     the first block is peeled.
//  3. dq: one CTA per (sequence*head, block of 128 queries), two consumer
//     warpgroups of 64 query rows: Q and dO once by TMA, K and V blocks of
//     64 (and the block's kv_mask word) through the ring: S = Q K^T,
//     dP = dO V^T, P and dS in registers, dQ += dS K (K as MN-major B),
//     pipelined as dkdv.
//  P and dS are rounded to bf16 as operands. Nothing goes through shared
//  memory but the TMA-fed operand tiles and the lse and D slices.
//  Block sizes: BQ = 64 at head_dim <= 64, 32 above, so that dK, dV, S^T and
//  dP^T (2 HDP / 2 + 2 BQ / 2 f32 registers per thread) fit without
//  spilling; 128 rows per CTA share each streamed tile between two
//  warpgroups. A warpgroup whose 64 rows all lie past L skips its products
//  (at L = 1025, 1088 rows of work per axis instead of 1152).
//  f32 (the reduced check's f32 net, head_dim 12): one thread per key
//  (dkdv) or query (dq) row, plain FMA in f32, the other side's rows
//  broadcast from shared memory in blocks of 32; any head_dim up to 128.
// Built without --fmad=false: nothing here decides on a threshold.
//
// What bounds it on this card. The algorithm needs five products of the
// forward's size (S recomputed, dP, dV, dK, dQ): 2.5 x the forward's flops,
// 2.5 * 3.87e10 = 9.67e10 at the train shape (12 x 1025 tokens, 12 heads of
// 64), 98 us at 989 TFLOP/s, against 45 us for its 151 MB (q, k, v, o, dO
// read, dq, dk, dv written) at 3.35 TB/s: compute-bound. These kernels
// recompute S and dP in the dq pass, seven products in all, to keep dQ free
// of atomics (FlashAttention-2 adds dQ with atomics and does five): their
// own floor is 7/5 of that bound, 0.137 ms.

#include <type_traits>

#include "flash_common.cuh"

namespace {

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

__global__ void rowdot_f32(Problem p, Grads g) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long rows = (long long)p.B * p.Lq * p.H;
  if (row >= rows) return;
  const float* o = static_cast<const float*>(g.o) + row * p.hd;
  const float* d = static_cast<const float*>(g.dout) + row * p.hd;
  float s = 0.0f;
  for (int c = 0; c < p.hd; ++c) s += o[c] * d[c];
  const int h = row % p.H;
  const long long bi = row / p.H;
  const int i = bi % p.Lq, b = bi / p.Lq;
  g.dsum[((long long)b * p.H + h) * p.Lq + i] = s;
}

// lanes lanes (a power of two >= hd / 8) per row, 8 bf16 each
__global__ void rowdot_bf16(Problem p, Grads g, int lanes) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = t / lanes, rows = (long long)p.B * p.Lq * p.H;
  const int c = static_cast<int>(t % lanes) * 8;
  float s = 0.0f;
  if (row < rows && c < p.hd) {
    const uint4 ov = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(g.o) + row * p.hd + c);
    const uint4 dv = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(g.dout) + row * p.hd + c);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 a = __bfloat1622float2(o2[e]), b = __bfloat1622float2(d2[e]);
      s += a.x * b.x + a.y * b.y;
    }
  }
  for (int off = lanes / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (row < rows && c == 0) {
    const int h = row % p.H;
    const long long bi = row / p.H;
    const int i = bi % p.Lq, b = bi / p.Lq;
    g.dsum[((long long)b * p.H + h) * p.Lq + i] = s;
  }
}

template <int HDP>
struct DkdvCfg {
  static constexpr int kBK = 128, kBQ = HDP == 64 ? 64 : 32, kStages = 4;
  static constexpr int kThreads = 3 * 128;  // two consumer warpgroups, one producer warpgroup
  static constexpr int kKBytes = HDP / flash::kPanel * kBK * flash::kPanelBytes;  // K or V
  static constexpr int kQBytes = HDP / flash::kPanel * kBQ * flash::kPanelBytes;  // Q or dO
  static constexpr int kStageOff = 2 * kKBytes;                 // stage s: Q, then dO
  static constexpr int kRowOff = kStageOff + kStages * 2 * kQBytes;  // lse [S][BQ], D [S][BQ]
  static constexpr int kBarOff = kRowOff + 2 * kStages * kBQ * 4;
  // K/V barrier, full[kStages], empty[kStages]
  static constexpr size_t kSmem = kBarOff + 8 * (1 + 2 * kStages) + 1024;
};

template <int HDP>
__global__ void __launch_bounds__(DkdvCfg<HDP>::kThreads, 1)
dkdv_bf16(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
          const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
          Problem p, Grads g) {
  using C = DkdvCfg<HDP>;
  constexpr int kBQ = C::kBQ;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = flash::smem_base(smem_raw);
  float* s_lse = reinterpret_cast<float*>(smem + C::kRowOff);  // lse * log2(e)
  float* s_d = s_lse + C::kStages * kBQ;
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(smem + C::kBarOff);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + C::kStages;

  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.x * C::kBK;
  const int nblk = (p.Lq + kBQ - 1) / kBQ;
  const int warp = flash::warp_index(), lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    flash::mbar_init(kvbar, 1);
    for (int s = 0; s < C::kStages; ++s) {
      flash::mbar_init(&full[s], 32);  // every producer lane, after its lse and D
      flash::mbar_init(&empty[s], 8);
    }
    flash::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {
    flash::producer_regs();
    if (warp == 8) {
      if (lane == 0) {
        flash::mbar_expect_tx(kvbar, 2 * C::kKBytes);
        flash::tma_tile<HDP>(smem, &tk, kvbar, C::kBK, h, k0, b);
        flash::tma_tile<HDP>(smem + C::kKBytes, &tv, kvbar, C::kBK, h, k0, b);
      }
      for (int i = 0; i < nblk; ++i) {
        const int s = i % C::kStages;
        if (i >= C::kStages) flash::mbar_wait(&empty[s], ((i / C::kStages) - 1) & 1);
        for (int t = lane; t < kBQ; t += 32) {
          const int row = i * kBQ + t;
          const bool ok = row < p.Lq;
          s_lse[s * kBQ + t] = ok ? g.lse[(size_t)bh * p.Lq + row] * flash::kLog2e : 0.0f;
          s_d[s * kBQ + t] = ok ? g.dsum[(size_t)bh * p.Lq + row] : 0.0f;
        }
        if (lane == 0) {
          unsigned char* st = smem + C::kStageOff + s * 2 * C::kQBytes;
          flash::mbar_expect_tx(&full[s], 2 * C::kQBytes);
          flash::tma_tile<HDP>(st, &tq, &full[s], kBQ, h, i * kBQ, b);
          flash::tma_tile<HDP>(st + C::kQBytes, &tdo, &full[s], kBQ, h, i * kBQ, b);
        } else {
          flash::mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns key rows k0 + 64 wg .. + 63
    flash::consumer_regs();
    const int wg = warp / 4;
    const int j_lo = k0 + wg * 64 + (warp % 4) * 16 + lane / 4;  // and j_lo + 8
    if (k0 + wg * 64 >= p.Lk) {
      // every key row of this warpgroup lies past Lk: release the stages only
      for (int i = 0; i < nblk; ++i) {
        flash::mbar_wait(&full[i % C::kStages], (i / C::kStages) & 1);
        if (lane == 0) flash::mbar_arrive(&empty[i % C::kStages]);
      }
      return;
    }
    const float c2 = p.scale * flash::kLog2e;
    // a key row's logit as mul * s + add: live c2 s, masked -1e9, past Lk
    // -inf; keep = 1 where the key takes a gradient through its logit
    const bool live_lo = flash::key_live(p, b, j_lo), live_hi = flash::key_live(p, b, j_lo + 8);
    const float mul_lo = live_lo ? c2 : 0.0f, mul_hi = live_hi ? c2 : 0.0f;
    const float add_lo = live_lo ? 0.0f : j_lo < p.Lk ? flash::kMasked2 : -CUDART_INF_F;
    const float add_hi = live_hi ? 0.0f : j_lo + 8 < p.Lk ? flash::kMasked2 : -CUDART_INF_F;
    const float keep_lo = live_lo ? 1.0f : 0.0f, keep_hi = live_hi ? 1.0f : 0.0f;
    const uint32_t k_tile = flash::smem_u32(smem) + wg * 64 * flash::kPanelBytes;
    const uint32_t v_tile = k_tile + C::kKBytes;
    const uint32_t stages = flash::smem_u32(smem + C::kStageOff);

    float dk[HDP / 2], dv[HDP / 2], st[kBQ / 2], dpt[kBQ / 2];
    uint32_t pa[kBQ / 4], da[kBQ / 4];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) dk[i] = dv[i] = 0.0f;

    // S^T = K Q^T and dP^T = V dO^T of query block i, as two groups
    auto issue_s = [&](int i) {
      const uint32_t q_tile = stages + (i % C::kStages) * 2 * C::kQBytes;
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk)
        flash::SS<kBQ>::mma(st, flash::desc_k(k_tile, C::kBK, kk),
                            flash::desc_k(q_tile, kBQ, kk), kk > 0);
      flash::wg_commit();
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk)
        flash::SS<kBQ>::mma(dpt, flash::desc_k(v_tile, C::kBK, kk),
                            flash::desc_k(q_tile + C::kQBytes, kBQ, kk), kk > 0);
      flash::wg_commit();
    };

    auto issue_b = [&](int i) {  // dV += P^T dO, dK += dS^T Q of query block i
      const uint32_t q_tile = stages + (i % C::kStages) * 2 * C::kQBytes;
#pragma unroll
      for (int t = 0; t < kBQ / 16; ++t)
        flash::RS<HDP>::mma(dv, pa + 4 * t, flash::desc_mn(q_tile + C::kQBytes, kBQ, t));
#pragma unroll
      for (int t = 0; t < kBQ / 16; ++t)
        flash::RS<HDP>::mma(dk, da + 4 * t, flash::desc_mn(q_tile, kBQ, t));
      flash::wg_commit();
    };
    // query block i: issue S^T_i, dP^T_i and then dV, dK of block i - 1;
    // the exponentials of block i run while dP^T_i and the block before's
    // dV, dK are on the tensor cores; all three retire before the next
    // block, so no product is in flight across the loop's back edge
    auto block = [&](int i, auto first) {
      constexpr bool kFirst = decltype(first)::value;
      const int s = i % C::kStages;
      flash::mbar_wait(&full[s], (i / C::kStages) & 1);
      flash::wg_fence();
      issue_s(i);
      if constexpr (!kFirst) issue_b(i - 1);
      if constexpr (kFirst) flash::wg_wait<1>();
      else flash::wg_wait<2>();
      flash::fence_acc(st);

      // columns are queries: P^T from the column's lse; zero past Lq
      const float* lse2 = s_lse + s * kBQ;
      const float* dd = s_d + s * kBQ;
#pragma unroll
      for (int c = 0; c < kBQ / 8; ++c) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = flash::acc_col(c, e, lane);
          const bool ok = i * kBQ + col < p.Lq;
          const float l2 = lse2[col];
          const int a = 4 * c + e, z = 4 * c + 2 + e;
          st[a] = ok ? flash::ex2(fmaf(st[a], mul_lo, add_lo - l2)) : 0.0f;
          st[z] = ok ? flash::ex2(fmaf(st[z], mul_hi, add_hi - l2)) : 0.0f;
        }
      }
      if constexpr (kFirst) flash::wg_wait<0>();
      else flash::wg_wait<1>();
      flash::fence_acc(dpt);
      // dS^T = P^T (dP^T - D), zero where the key is not live
#pragma unroll
      for (int c = 0; c < kBQ / 8; ++c) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float d = dd[flash::acc_col(c, e, lane)];
          const int a = 4 * c + e, z = 4 * c + 2 + e;
          dpt[a] = st[a] * (dpt[a] - d) * keep_lo;
          dpt[z] = st[z] * (dpt[z] - d) * keep_hi;
        }
      }
      if constexpr (!kFirst) {
        // dV, dK of block i - 1 done: the operand registers are free, and
        // stage i - 1 goes back to the producer
        flash::wg_wait<0>();
        flash::fence_acc(dv);
        flash::fence_acc(dk);
        flash::fence_acc(st);
        flash::fence_acc(dpt);
        if (lane == 0) flash::mbar_arrive(&empty[(i - 1) % C::kStages]);
      }
      flash::acc_to_a(st, pa);
      flash::acc_to_a(dpt, da);
    };

    flash::mbar_wait(kvbar, 0);
    block(0, std::true_type{});
    for (int i = 1; i < nblk; ++i) block(i, std::false_type{});
    flash::wg_fence();
    issue_b(nblk - 1);
    flash::wg_wait<0>();
    flash::fence_acc(dv);
    flash::fence_acc(dk);
    flash::store_rows<HDP>(dk, p.scale, p.scale, static_cast<bf16*>(g.dk), b, h, p.H, p.Lk,
                           p.hd, j_lo, lane);
    flash::store_rows<HDP>(dv, 1.0f, 1.0f, static_cast<bf16*>(g.dv), b, h, p.H, p.Lk, p.hd,
                           j_lo, lane);
  }
}

template <int HDP>
struct DqCfg {
  static constexpr int kBQ = 128, kBK = 64, kStages = 4;
  static constexpr int kThreads = 3 * 128;
  static constexpr int kQBytes = HDP / flash::kPanel * kBQ * flash::kPanelBytes;  // Q or dO
  static constexpr int kKBytes = HDP / flash::kPanel * kBK * flash::kPanelBytes;  // K or V
  static constexpr int kStageOff = 2 * kQBytes;                 // stage s: K, then V
  static constexpr int kBarOff = kStageOff + kStages * 2 * kKBytes;
  // Q/dO barrier, full[kStages], empty[kStages], mask word[kStages]
  static constexpr size_t kSmem = kBarOff + 8 * (1 + 3 * kStages) + 1024;
};

template <int HDP>
__global__ void __launch_bounds__(DqCfg<HDP>::kThreads, 1)
dq_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
        const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
        Problem p, Grads g) {
  using C = DqCfg<HDP>;
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
      flash::mbar_init(&empty[s], 8);
    }
    flash::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {
    flash::producer_regs();
    if (warp == 8) {
      if (lane == 0) {
        flash::mbar_expect_tx(qbar, 2 * C::kQBytes);
        flash::tma_tile<HDP>(smem, &tq, qbar, C::kBQ, h, q0, b);
        flash::tma_tile<HDP>(smem + C::kQBytes, &tdo, qbar, C::kBQ, h, q0, b);
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
          unsigned char* st = smem + C::kStageOff + s * 2 * C::kKBytes;
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
    if (q0 + wg * 64 >= p.Lq) {
      for (int j = 0; j < nblk; ++j) {
        flash::mbar_wait(&full[j % C::kStages], (j / C::kStages) & 1);
        if (lane == 0) flash::mbar_arrive(&empty[j % C::kStages]);
      }
      return;
    }
    const float c2 = p.scale * flash::kLog2e;
    const bool ok_lo = r_lo < p.Lq, ok_hi = r_lo + 8 < p.Lq;
    const float lse_lo = ok_lo ? g.lse[(size_t)bh * p.Lq + r_lo] * flash::kLog2e : 0.0f;
    const float lse_hi = ok_hi ? g.lse[(size_t)bh * p.Lq + r_lo + 8] * flash::kLog2e : 0.0f;
    const float d_lo = ok_lo ? g.dsum[(size_t)bh * p.Lq + r_lo] : 0.0f;
    const float d_hi = ok_hi ? g.dsum[(size_t)bh * p.Lq + r_lo + 8] : 0.0f;
    const uint32_t q_tile = flash::smem_u32(smem) + wg * 64 * flash::kPanelBytes;
    const uint32_t do_tile = q_tile + C::kQBytes;
    const uint32_t stages = flash::smem_u32(smem + C::kStageOff);

    float dq[HDP / 2], sc[32], dp[32];
    uint32_t da[16];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) dq[i] = 0.0f;

    // S = Q K^T and dP = dO V^T of key block j, as two groups
    auto issue_s = [&](int j) {
      const uint32_t k_tile = stages + (j % C::kStages) * 2 * C::kKBytes;
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk)
        flash::SS<64>::mma(sc, flash::desc_k(q_tile, C::kBQ, kk),
                           flash::desc_k(k_tile, C::kBK, kk), kk > 0);
      flash::wg_commit();
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk)
        flash::SS<64>::mma(dp, flash::desc_k(do_tile, C::kBQ, kk),
                           flash::desc_k(k_tile + C::kKBytes, C::kBK, kk), kk > 0);
      flash::wg_commit();
    };

    auto issue_b = [&](int j) {  // dQ += dS K_j
      const uint32_t k_tile = stages + (j % C::kStages) * 2 * C::kKBytes;
#pragma unroll
      for (int t = 0; t < C::kBK / 16; ++t)
        flash::RS<HDP>::mma(dq, da + 4 * t, flash::desc_mn(k_tile, C::kBK, t));
      flash::wg_commit();
    };
    // key block j: issue S_j, dP_j and then dQ of block j - 1; the same
    // overlap as dK/dV, everything retired before the next block
    auto block = [&](int j, auto first) {
      constexpr bool kFirst = decltype(first)::value;
      const int s = j % C::kStages;
      flash::mbar_wait(&full[s], (j / C::kStages) & 1);
      flash::wg_fence();
      issue_s(j);
      if constexpr (!kFirst) issue_b(j - 1);
      if constexpr (kFirst) flash::wg_wait<1>();
      else flash::wg_wait<2>();
      flash::fence_acc(sc);

      // P, zero where the key is not live (its dS is 0)
      const uint64_t bits = mask_bits[s];
      const int kbase = j * C::kBK;
      if (bits == ~0ull && kbase + C::kBK <= p.Lk) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            sc[4 * i + e] = flash::ex2(fmaf(sc[4 * i + e], c2, -lse_lo));
            sc[4 * i + 2 + e] = flash::ex2(fmaf(sc[4 * i + 2 + e], c2, -lse_hi));
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = flash::acc_col(i, e, lane);
            const bool live = kbase + col < p.Lk && ((bits >> col) & 1);
            const int a = 4 * i + e, z = 4 * i + 2 + e;
            sc[a] = live ? flash::ex2(fmaf(sc[a], c2, -lse_lo)) : 0.0f;
            sc[z] = live ? flash::ex2(fmaf(sc[z], c2, -lse_hi)) : 0.0f;
          }
        }
      }
      if constexpr (kFirst) flash::wg_wait<0>();
      else flash::wg_wait<1>();
      flash::fence_acc(dp);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        dp[4 * i] = sc[4 * i] * (dp[4 * i] - d_lo);
        dp[4 * i + 1] = sc[4 * i + 1] * (dp[4 * i + 1] - d_lo);
        dp[4 * i + 2] = sc[4 * i + 2] * (dp[4 * i + 2] - d_hi);
        dp[4 * i + 3] = sc[4 * i + 3] * (dp[4 * i + 3] - d_hi);
      }
      if constexpr (!kFirst) {
        // dQ of block j - 1 done: da is free, and stage j - 1 goes back
        flash::wg_wait<0>();
        flash::fence_acc(dq);
        flash::fence_acc(dp);
        if (lane == 0) flash::mbar_arrive(&empty[(j - 1) % C::kStages]);
      }
      flash::acc_to_a(dp, da);
    };

    flash::mbar_wait(qbar, 0);
    block(0, std::true_type{});
    for (int j = 1; j < nblk; ++j) block(j, std::false_type{});
    flash::wg_fence();
    issue_b(nblk - 1);
    flash::wg_wait<0>();
    flash::fence_acc(dq);
    flash::store_rows<HDP>(dq, p.scale, p.scale, static_cast<bf16*>(g.dq), b, h, p.H, p.Lq,
                           p.hd, r_lo, lane);
  }
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

template <int HDP>
int launch_bf16(const Problem& p, const Grads& g, cudaStream_t s) {
  using A = DkdvCfg<HDP>;
  using Q = DqCfg<HDP>;
  const long long o_sb = (long long)p.Lq * p.H * p.hd, o_sl = (long long)p.H * p.hd;
  CUtensorMap tk, tv, tq, tdo;
  int err = flash::make_map(&tk, p.k, p.B, p.Lk, p.H, p.hd, p.k_sb, p.k_sl, A::kBK);
  if (err == 0) err = flash::make_map(&tv, p.v, p.B, p.Lk, p.H, p.hd, p.v_sb, p.v_sl, A::kBK);
  if (err == 0) err = flash::make_map(&tq, p.q, p.B, p.Lq, p.H, p.hd, p.q_sb, p.q_sl, A::kBQ);
  if (err == 0) err = flash::make_map(&tdo, g.dout, p.B, p.Lq, p.H, p.hd, o_sb, o_sl, A::kBQ);
  if (err != 0) return err;
  err = flash::launch(dkdv_bf16<HDP>, dim3((p.Lk + A::kBK - 1) / A::kBK, p.B * p.H),
                      A::kThreads, A::kSmem, s, tk, tv, tq, tdo, p, g);
  if (err != 0) return err;
  err = flash::make_map(&tq, p.q, p.B, p.Lq, p.H, p.hd, p.q_sb, p.q_sl, Q::kBQ);
  if (err == 0) err = flash::make_map(&tdo, g.dout, p.B, p.Lq, p.H, p.hd, o_sb, o_sl, Q::kBQ);
  if (err == 0) err = flash::make_map(&tk, p.k, p.B, p.Lk, p.H, p.hd, p.k_sb, p.k_sl, Q::kBK);
  if (err == 0) err = flash::make_map(&tv, p.v, p.B, p.Lk, p.H, p.hd, p.v_sb, p.v_sl, Q::kBK);
  if (err != 0) return err;
  return flash::launch(dq_bf16<HDP>, dim3((p.Lq + Q::kBQ - 1) / Q::kBQ, p.B * p.H),
                       Q::kThreads, Q::kSmem, s, tq, tdo, tk, tv, p, g);
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
  if (Lq <= 0 || Lk <= 0 || hd <= 0 || hd > flash::kMaxHd || (is_bf16 && hd % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = (long long)B * Lq * H;
  const int per = 256;
  if (is_bf16) {
    int lanes = 2;
    while (lanes * 8 < hd) lanes *= 2;
    rowdot_bf16<<<(unsigned)((rows * lanes + per - 1) / per), per, 0, s>>>(p, g, lanes);
  } else {
    rowdot_f32<<<(unsigned)((rows + per - 1) / per), per, 0, s>>>(p, g);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!is_bf16) {
    const size_t smem = f32_smem(hd);
    int e = flash::launch(dkdv_f32, dim3((Lk + kF32Rows - 1) / kF32Rows, B * H), kF32Rows,
                          smem, s, p, g);
    if (e != 0) return e;
    return flash::launch(dq_f32, dim3((Lq + kF32Rows - 1) / kF32Rows, B * H), kF32Rows, smem,
                         s, p, g);
  }
  return hd <= 64 ? launch_bf16<64>(p, g, s) : launch_bf16<128>(p, g, s);
}

// Dynamic shared memory per CTA of the bf16 dK/dV (which = 0) and dQ
// (which = 1) kernels at head_dim hd.
extern "C" int lara_flash_bwd_smem(int which, int hd) {
  if (which == 0) return static_cast<int>(hd <= 64 ? DkdvCfg<64>::kSmem : DkdvCfg<128>::kSmem);
  return static_cast<int>(hd <= 64 ? DqCfg<64>::kSmem : DqCfg<128>::kSmem);
}
