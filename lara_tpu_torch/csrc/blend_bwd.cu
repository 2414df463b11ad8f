// Per-tile 2DGS surfel blend, backward, from the stashed carries or by
// replaying the forward walk: the Hopper kernel behind the backward of
// lara_tpu_torch/ops/rasterizer/cuda_blend.py (_BlendFunction).
//
// Replaces two TPU kernels of lara_tpu/ops/rasterizer/pallas_blend.py, which
// take jax.vjp of _chunk_fn chunk by chunk: _bwd_kernel_stash
// (_bwd_one_tile with carr_ref, launched by _run_bwd_stash) in stash mode,
// and _bwd_kernel (_bwd_one_tile with carr_ref=None, launched by _run_bwd,
// RenderConfig.pallas_stash_carries=False) in replay mode. Here the
// vector-Jacobian product is derived by hand, in the suffix-sum form of the
// CUDA 2DGS backward.
//
// What it computes. Per tile, from the entries [K, 13], the cotangent of the
// raw accumulators [10, 256] (the median's is ignored: its gradient is
// defined as 0), the forward's stash [budget/chunk + 1, 4, 256] and its
// processed-chunk count ndone: the gradient of every entry row [K, 13]
// (center_cam, au, bv, rgb, opacity), summed over the tile's 256 pixels.
// Rows of chunks >= ndone and entries >= count are written as zeros, so
// every row is written exactly once.
//
// The derivation, per pixel, over the entries k it composited (w_k =
// alpha_k T_k > 0), with g the pixel's cotangent:
//   dL/dw_k     = g_rgb.rgb_k + g_A + g_D depth_k + g_N.n_k
//                 + g_dist (m_k^2 A + M2 - 2 m_k M1)
//   dL/dalpha_k = T_k dL/dw_k - S_k / (1 - alpha_k),
//                 S_k = sum_{j>k} w_j dL/dw_j   (over all later chunks too)
//   dL/dm_k     = 2 g_dist w_k (m_k A - M1)
// where (A, M1, M2) are the pixel's final moments (sum w, sum w m,
// sum w m^2). The distortion sum_k w_k (m_k^2 A_k + M2_k - 2 m_k M1_k) over
// the exclusive prefix moments equals sum_{j<k} w_j w_k (m_j - m_k)^2; its
// derivative by w_k collects the prefix terms (j < k) and the Sigma_{j>k}
// terms into sum_j w_j (m_k - m_j)^2, which is the expression above with the
// final moments, so no prefix moment has to be recovered in reverse. The
// cotangent of the carry (T, A, M1, M2) that the TPU kernel passes from one
// chunk to the previous one is thus S (= T_out dL/dT_out) for T, and
// constants of the pixel for the moments: S is the one value carried in a
// register from chunk to chunk, and it never leaves its thread.
// From dL/dalpha: the min(0.99, .) clamp passes no gradient where it bites;
// alpha = op exp(-rho/2) gives op and rho; rho = min(rho_3d, rho_2d) picks
// one branch, and the same switch makes depth the ray-plane hit t (3D) or
// the center z (2D); t = (n.c) / (n.d), u = t (au.d) - au.c, v likewise.
// Each pixel accumulates 19 per-entry partials (normal, n.c, au, au.c, bv,
// bv.c, screen center, center z, rgb, opacity); after the block reduction
// one thread per entry chains them through n.c, the screen projection
// (with the cz_safe guard), and the normal's normalisation and its flip
// toward the camera into the 13 columns of the row.
//
// Precision. T_k is not recovered by dividing by (1 - alpha), which loses up
// to 100x at alpha = 0.99: each chunk is first walked forward from its
// stashed carry-in, and every T_k is kept in shared memory ([chunk, 256]
// f32, 64 KB at chunk 64). The walk repeats the forward kernel's arithmetic
// operation for operation (built with the same --fmad=false, 1/sqrtf), so
// alpha, the alpha >= alpha_min cull, the T * (1 - alpha) >=
// transmittance_min test and the 3D/2D switch decide exactly as in the
// forward.
//
// Layout. One 256-thread CTA per tile, one thread per pixel, chunks from
// ndone-1 down to 0. A chunk's rows and their pixel-independent quantities
// are staged in shared memory, as in the forward. For each entry the 19
// partials are summed over a warp with shuffles (skipped when no lane of the
// warp composited the entry) and over the 8 warps through shared memory. No
// global atomics: the cross-tile sum is the window gather's backward.
//
// Replay mode (stash null on input). The tile first walks its chunks
// forward from (T = 1, A = M1 = M2 = 0) with the forward kernel's exit rule
// (a pixel stops at the entry with T (1 - alpha) < transmittance_min, the
// tile after the chunk where no pixel has T >= transmittance_min left, or
// when the count runs out) and its exact operations, so every carry-in, the
// final carry and the processed-chunk count ndone are bit for bit those the
// stash forward writes; then the reverse walk runs unchanged, with the
// totals (A, M1, M2) from the final carry. Where the carries live: each
// thread keeps its own pixel's carry-in T per chunk in a per-thread array
// of kMaxReplayChunks slots (local memory, cached in L1; the reverse walk
// reads one slot per chunk) and the final (A, M1, M2) in registers. Shared
// memory stays what the stash mode uses (108 KB at chunk 64, two blocks per
// SM); [K/C + 1, 4, 256] f32 more of it (12 KB at the train config) would
// have dropped the kernel to one block per SM. budget/chunk above
// kMaxReplayChunks is refused. With the optional outputs non-null the replay
// also writes what it rebuilt, in the stash forward's layout, for a check
// against the stash path.
//
// What bounds it on this card. Per processed entry-pixel it does the
// forward's ~40 flops and one expf twice (the forward walk and the reverse
// walk) plus ~60 flops of derivatives, and per entry and warp up to
// 19 x 5 shuffles: ALU and shuffle work, not bytes (a train render reads
// 1024 tiles x 128 x 13 f32 = 6.8 MB of entries and writes as much). The
// replay mode adds one more forward walk (~40 flops and one expf per
// entry-pixel of a processed chunk). Shared memory (about 108 KB per block
// at chunk 64) allows two blocks per SM in both modes.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kPackCols = 13;
constexpr int kNumChannels = 10;
constexpr int kWarps = 8;  // 256 pixels per tile
constexpr int kMaxReplayChunks = 16;  // cuda_blend.MAX_REPLAY_CHUNKS
enum Field {
  kN0, kN1, kN2, kC2x, kC2y, kNc, kCau, kCbv, kCz,
  kAu0, kAu1, kAu2, kBv0, kBv1, kBv2, kR, kG, kB, kOp, kNumFields
};
// per-entry partial gradients, summed over the tile's pixels
enum Partial {
  dN0, dN1, dN2, dNc, dAu0, dAu1, dAu2, dCau, dBv0, dBv1, dBv2, dCbv,
  dC2x, dC2y, dCz, dR, dG, dB, dOp, kNumPartials
};

struct Params {
  int tiles_x, tile, width, height, budget, chunk;
  float alpha_min, t_min, near_cull, dist_near, dist_far, filter2d_invsq;
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The entry-pixel quantities of the forward kernel, in its exact operations.
struct Hit {
  float nd, tt, dau, dbv, u, v, ex, ey, rho, depth, gauss, alpha;
  bool nd_ok, use3d;
};

__device__ __forceinline__ Hit entry_hit(const float* sm, int c, int j,
                                         float px, float py, float dx,
                                         float dy, float op, const Params& p) {
  Hit h;
  const float n0 = sm[kN0 * c + j], n1 = sm[kN1 * c + j], n2 = sm[kN2 * c + j];
  h.nd = n0 * dx + n1 * dy + n2;
  h.nd_ok = fabsf(h.nd) >= 1e-8f;
  h.tt = sm[kNc * c + j] / (h.nd_ok ? h.nd : 1e-8f);
  h.dau = sm[kAu0 * c + j] * dx + sm[kAu1 * c + j] * dy + sm[kAu2 * c + j];
  h.dbv = sm[kBv0 * c + j] * dx + sm[kBv1 * c + j] * dy + sm[kBv2 * c + j];
  h.u = h.tt * h.dau - sm[kCau * c + j];
  h.v = h.tt * h.dbv - sm[kCbv * c + j];
  const float rho3d = h.nd_ok ? h.u * h.u + h.v * h.v : CUDART_INF_F;
  h.ex = px - sm[kC2x * c + j];
  h.ey = py - sm[kC2y * c + j];
  const float rho2d = p.filter2d_invsq * (h.ex * h.ex + h.ey * h.ey);
  h.use3d = rho3d <= rho2d;
  h.rho = h.use3d ? rho3d : rho2d;
  h.depth = h.use3d ? h.tt : sm[kCz * c + j];
  h.gauss = op * expf(-0.5f * h.rho);
  h.alpha = fminf(0.99f, h.gauss);
  return h;
}

// Stage the chunk's m rows and their pixel-independent quantities in shared
// memory, in the forward kernel's exact operations.
__device__ __forceinline__ void stage_chunk(float* sm, const float* rows,
                                            int c, int m, float fx, float fy,
                                            float half_w, float half_h) {
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    const float* r = rows + (size_t)j * kPackCols;
    const float cx = r[0], cy = r[1], cz = r[2];
    const float au0 = r[3], au1 = r[4], au2 = r[5];
    const float bv0 = r[6], bv1 = r[7], bv2 = r[8];
    float n0 = au1 * bv2 - au2 * bv1;
    float n1 = au2 * bv0 - au0 * bv2;
    float n2 = au0 * bv1 - au1 * bv0;
    const float inv = 1.0f / sqrtf(n0 * n0 + n1 * n1 + n2 * n2 + 1e-20f);
    const float sgn = (cx * n0 + cy * n1 + cz * n2 <= 0.0f) ? inv : -inv;
    n0 *= sgn; n1 *= sgn; n2 *= sgn;
    const float cz_safe = fabsf(cz) < 1e-6f ? 1e-6f : cz;
    sm[kN0 * c + j] = n0;
    sm[kN1 * c + j] = n1;
    sm[kN2 * c + j] = n2;
    sm[kC2x * c + j] = fx * cx / cz_safe + half_w;
    sm[kC2y * c + j] = fy * cy / cz_safe + half_h;
    sm[kNc * c + j] = n0 * cx + n1 * cy + n2 * cz;
    sm[kCau * c + j] = au0 * cx + au1 * cy + au2 * cz;
    sm[kCbv * c + j] = bv0 * cx + bv1 * cy + bv2 * cz;
    sm[kCz * c + j] = cz;
    sm[kAu0 * c + j] = au0;
    sm[kAu1 * c + j] = au1;
    sm[kAu2 * c + j] = au2;
    sm[kBv0 * c + j] = bv0;
    sm[kBv1 * c + j] = bv1;
    sm[kBv2 * c + j] = bv2;
    sm[kR * c + j] = r[9];
    sm[kG * c + j] = r[10];
    sm[kB * c + j] = r[11];
    sm[kOp * c + j] = r[12];
  }
}

// kReplay false: stash and ndone_arr are the stash forward's outputs, read.
// kReplay true: they are optional outputs (null to skip) of the replay walk.
template <bool kReplay>
__global__ void blend_bwd_kernel(const float* __restrict__ entries,
                                 const int* __restrict__ counts,
                                 const float* __restrict__ scalars,
                                 float* __restrict__ stash,
                                 int* __restrict__ ndone_arr,
                                 const float* __restrict__ cot,
                                 float* __restrict__ grad, Params p) {
  extern __shared__ float smem[];
  const int c = p.chunk;
  float* sm = smem;                                  // [kNumFields][chunk]
  float* tbuf = sm + kNumFields * c;                 // [chunk][256] T_k or -1
  float* red = tbuf + c * blockDim.x;                // [kWarps][kNumPartials][chunk]

  const int t = blockIdx.x;
  const int pid = threadIdx.x;
  const int npix = blockDim.x;
  const int lane = pid & 31, warp = pid >> 5;
  const int n = min(counts[t], p.budget);
  const int slots = p.budget / c + 1;

  const float fx = p.width / (2.0f * scalars[0]);
  const float fy = p.height / (2.0f * scalars[1]);
  const float half_w = p.width * 0.5f, half_h = p.height * 0.5f;
  const float px = (t % p.tiles_x) * p.tile + (pid % p.tile) + 0.5f;
  const float py = (t / p.tiles_x) * p.tile + (pid / p.tile) + 0.5f;
  const float dx = (px - half_w) / fx;
  const float dy = (py - half_h) / fy;
  const float nrm_c = p.dist_far / (p.dist_far - p.dist_near);
  const float* tile_rows = entries + (size_t)t * p.budget * kPackCols;
  float* st = stash == nullptr ? nullptr : stash + (size_t)t * slots * 4 * npix + pid;

  int ndone;
  float a_tot, m1_tot, m2_tot;
  float t_in[kReplay ? kMaxReplayChunks : 1];  // replay: carry-in T per chunk
  if constexpr (kReplay) {
    // the forward kernel's walk, without its colour sums
    float T = 1.0f, A = 0.0f, M1 = 0.0f, M2 = 0.0f;
    auto put_carry = [&](int ci) {
      if (st != nullptr) {
        st[(ci * 4) * npix] = T;
        st[(ci * 4 + 1) * npix] = A;
        st[(ci * 4 + 2) * npix] = M1;
        st[(ci * 4 + 3) * npix] = M2;
      }
    };
    int ci = 0;
    for (int k0 = 0; k0 < n; k0 += c) {
      const int m = min(c, n - k0);
      t_in[ci] = T;
      put_carry(ci);
      ++ci;
      stage_chunk(sm, tile_rows + (size_t)k0 * kPackCols, c, m, fx, fy, half_w, half_h);
      __syncthreads();
      if (T >= p.t_min) {
        for (int j = 0; j < m; ++j) {
          const float op = sm[kOp * c + j];
          if (!(op > 0.0f)) continue;
          const Hit h = entry_hit(sm, c, j, px, py, dx, dy, op, p);
          if (!(h.alpha >= p.alpha_min && h.depth >= p.near_cull)) continue;
          const float t_next = T * (1.0f - h.alpha);
          if (t_next < p.t_min) {
            T = t_next;
            break;
          }
          const float w = h.alpha * T;
          const float md = nrm_c * (1.0f - p.dist_near / fmaxf(h.depth, 1e-6f));
          A += w;
          M1 += w * md;
          M2 += w * md * md;
          T = t_next;
        }
      }
      // also the barrier before the next staging (here or in the reverse walk)
      if (__syncthreads_count(T >= p.t_min) == 0) break;
    }
    put_carry(ci);
    if (ndone_arr != nullptr && pid == 0) ndone_arr[t] = ci;
    ndone = ci;
    a_tot = A;
    m1_tot = M1;
    m2_tot = M2;
  } else {
    ndone = ndone_arr[t];
    a_tot = st[(ndone * 4 + 1) * npix];
    m1_tot = st[(ndone * 4 + 2) * npix];
    m2_tot = st[(ndone * 4 + 3) * npix];
  }

  const float* g = cot + (size_t)t * kNumChannels * npix + pid;
  const float g_r = g[0], g_g = g[npix], g_b = g[2 * npix], g_a = g[3 * npix];
  const float g_d = g[4 * npix], g_n0 = g[6 * npix], g_n1 = g[7 * npix];
  const float g_n2 = g[8 * npix], g_dist = g[9 * npix];

  float* tile_grad = grad + (size_t)t * p.budget * kPackCols;
  for (int i = ndone * c * kPackCols + pid; i < p.budget * kPackCols; i += npix)
    tile_grad[i] = 0.0f;

  float S = 0.0f;  // sum over later composited entries of w_j dL/dw_j
  for (int ci = ndone - 1; ci >= 0; --ci) {
    const int k0 = ci * c;
    const int m = min(c, n - k0);
    stage_chunk(sm, tile_rows + (size_t)k0 * kPackCols, c, m, fx, fy, half_w, half_h);
    __syncthreads();

    // forward walk of this chunk from its carry-in: T_k of every entry this
    // pixel composited, -1 for the others
    float T = kReplay ? t_in[ci] : st[(ci * 4) * npix];
    for (int j = 0; j < m; ++j) {
      float tk = -1.0f;
      const float op = sm[kOp * c + j];
      if (T >= p.t_min && op > 0.0f) {
        const Hit h = entry_hit(sm, c, j, px, py, dx, dy, op, p);
        if (h.alpha >= p.alpha_min && h.depth >= p.near_cull) {
          const float t_next = T * (1.0f - h.alpha);
          if (t_next >= p.t_min) tk = T;
          T = t_next;  // a killing entry leaves T below t_min: no more hits
        }
      }
      tbuf[j * npix + pid] = tk;
    }

    // reverse walk: per-entry partials, reduced over the block
    for (int j = m - 1; j >= 0; --j) {
      float d[kNumPartials];
#pragma unroll
      for (int f = 0; f < kNumPartials; ++f) d[f] = 0.0f;
      const float tk = tbuf[j * npix + pid];
      const bool hit = tk >= 0.0f;
      if (hit) {
        const float op = sm[kOp * c + j];
        const Hit h = entry_hit(sm, c, j, px, py, dx, dy, op, p);
        const float n0 = sm[kN0 * c + j], n1 = sm[kN1 * c + j], n2 = sm[kN2 * c + j];
        const float rr = sm[kR * c + j], gg = sm[kG * c + j], bb = sm[kB * c + j];
        const float w = h.alpha * tk;
        const float md = nrm_c * (1.0f - p.dist_near / fmaxf(h.depth, 1e-6f));
        const float dl_dw = g_r * rr + g_g * gg + g_b * bb + g_a + g_d * h.depth
                            + g_n0 * n0 + g_n1 * n1 + g_n2 * n2
                            + g_dist * (md * md * a_tot + m2_tot - 2.0f * md * m1_tot);
        const float dl_dalpha = tk * dl_dw - S / (1.0f - h.alpha);
        S += w * dl_dw;
        const float dl_dmd = 2.0f * g_dist * w * (md * a_tot - m1_tot);
        const float dl_ddepth = g_d * w
            + (h.depth > 1e-6f
                   ? dl_dmd * nrm_c * p.dist_near / (h.depth * h.depth) : 0.0f);
        const float dl_dgauss = h.gauss < 0.99f ? dl_dalpha : 0.0f;
        const float dl_drho = -0.5f * h.gauss * dl_dgauss;
        d[dOp] = dl_dgauss * expf(-0.5f * h.rho);
        d[dR] = w * g_r;
        d[dG] = w * g_g;
        d[dB] = w * g_b;
        d[dN0] = w * g_n0;
        d[dN1] = w * g_n1;
        d[dN2] = w * g_n2;
        if (h.use3d) {
          const float dl_du = 2.0f * h.u * dl_drho;
          const float dl_dv = 2.0f * h.v * dl_drho;
          const float dl_dtt = dl_ddepth + dl_du * h.dau + dl_dv * h.dbv;
          const float dl_dnd = h.nd_ok ? -dl_dtt * h.tt / h.nd : 0.0f;
          d[dNc] = dl_dtt / (h.nd_ok ? h.nd : 1e-8f);
          d[dN0] += dl_dnd * dx;
          d[dN1] += dl_dnd * dy;
          d[dN2] += dl_dnd;
          const float ddau = dl_du * h.tt, ddbv = dl_dv * h.tt;
          d[dAu0] = ddau * dx;
          d[dAu1] = ddau * dy;
          d[dAu2] = ddau;
          d[dCau] = -dl_du;
          d[dBv0] = ddbv * dx;
          d[dBv1] = ddbv * dy;
          d[dBv2] = ddbv;
          d[dCbv] = -dl_dv;
        } else {
          const float k = -2.0f * p.filter2d_invsq * dl_drho;
          d[dC2x] = k * h.ex;
          d[dC2y] = k * h.ey;
          d[dCz] = dl_ddepth;
        }
      }
      float* rj = red + warp * kNumPartials * c + j;
      if (__any_sync(0xffffffffu, hit)) {
#pragma unroll
        for (int f = 0; f < kNumPartials; ++f) {
          const float s = warp_sum(d[f]);
          if (lane == 0) rj[f * c] = s;
        }
      } else if (lane == 0) {
#pragma unroll
        for (int f = 0; f < kNumPartials; ++f) rj[f * c] = 0.0f;
      }
    }
    __syncthreads();

    // one thread per entry: sum the warps, chain into the 13 columns
    for (int j = pid; j < c; j += npix) {
      float* out = tile_grad + (size_t)(k0 + j) * kPackCols;
      if (j >= m) {
        for (int f = 0; f < kPackCols; ++f) out[f] = 0.0f;
        continue;
      }
      float d[kNumPartials];
      for (int f = 0; f < kNumPartials; ++f) {
        float s = 0.0f;
        for (int wi = 0; wi < kWarps; ++wi) s += red[(wi * kNumPartials + f) * c + j];
        d[f] = s;
      }
      const float* r = tile_rows + (size_t)(k0 + j) * kPackCols;
      const float cx = r[0], cy = r[1], cz = r[2];
      const float au0 = r[3], au1 = r[4], au2 = r[5];
      const float bv0 = r[6], bv1 = r[7], bv2 = r[8];
      const float c0 = au1 * bv2 - au2 * bv1;
      const float c1 = au2 * bv0 - au0 * bv2;
      const float c2 = au0 * bv1 - au1 * bv0;
      const float inv = 1.0f / sqrtf(c0 * c0 + c1 * c1 + c2 * c2 + 1e-20f);
      const float sgn = (cx * c0 + cy * c1 + cz * c2 <= 0.0f) ? inv : -inv;
      const float n0 = c0 * sgn, n1 = c1 * sgn, n2 = c2 * sgn;
      const bool cz_ok = !(fabsf(cz) < 1e-6f);
      const float cz_safe = cz_ok ? cz : 1e-6f;

      // n.c, au.c, bv.c and the screen center feed the center and the axes
      const float dn0 = d[dN0] + d[dNc] * cx;
      const float dn1 = d[dN1] + d[dNc] * cy;
      const float dn2 = d[dN2] + d[dNc] * cz;
      const float dsafe = -(d[dC2x] * fx * cx + d[dC2y] * fy * cy) / (cz_safe * cz_safe);
      const float dcx = d[dNc] * n0 + d[dCau] * au0 + d[dCbv] * bv0 + d[dC2x] * fx / cz_safe;
      const float dcy = d[dNc] * n1 + d[dCau] * au1 + d[dCbv] * bv1 + d[dC2y] * fy / cz_safe;
      const float dcz = d[dNc] * n2 + d[dCau] * au2 + d[dCbv] * bv2 + d[dCz]
                        + (cz_ok ? dsafe : 0.0f);
      // n = sgn * (au x bv), sgn = +-1/|au x bv|: back through the
      // normalisation (the flip's sign is a decision, not a value)
      const float proj = (c0 * dn0 + c1 * dn1 + c2 * dn2) * inv * inv;
      const float dc0 = sgn * (dn0 - proj * c0);
      const float dc1 = sgn * (dn1 - proj * c1);
      const float dc2 = sgn * (dn2 - proj * c2);
      // c = au x bv: d_au = bv x d_c, d_bv = d_c x au
      out[0] = dcx;
      out[1] = dcy;
      out[2] = dcz;
      out[3] = d[dAu0] + d[dCau] * cx + (bv1 * dc2 - bv2 * dc1);
      out[4] = d[dAu1] + d[dCau] * cy + (bv2 * dc0 - bv0 * dc2);
      out[5] = d[dAu2] + d[dCau] * cz + (bv0 * dc1 - bv1 * dc0);
      out[6] = d[dBv0] + d[dCbv] * cx + (dc1 * au2 - dc2 * au1);
      out[7] = d[dBv1] + d[dCbv] * cy + (dc2 * au0 - dc0 * au2);
      out[8] = d[dBv2] + d[dCbv] * cz + (dc0 * au1 - dc1 * au0);
      out[9] = d[dR];
      out[10] = d[dG];
      out[11] = d[dB];
      out[12] = d[dOp];
    }
    // barrier before the next chunk overwrites shared memory
    __syncthreads();
  }
}

// Shared memory of one block, in bytes.
size_t smem_bytes(int chunk, int tile) {
  return sizeof(float) * ((size_t)kNumFields * chunk + (size_t)chunk * tile * tile
                          + (size_t)kWarps * kNumPartials * chunk);
}

template <bool kReplay>
int launch(const float* entries, const int* counts, const float* scalars,
           float* stash, int* ndone, const float* cot, float* grad,
           int num_tiles, const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.chunk, p.tile);
  cudaError_t err = cudaFuncSetAttribute(
      blend_bwd_kernel<kReplay>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  blend_bwd_kernel<kReplay><<<num_tiles, p.tile * p.tile, smem, stream>>>(
      entries, counts, scalars, stash, ndone, cot, grad, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// replay 0: stash f32 [num_tiles, budget/chunk + 1, 4, tile*tile] and ndone
// int32 [num_tiles] are inputs, from lara_blend_fwd. replay 1: the kernel
// rebuilds them, and writes them there where the pointers are non-null.
// cot f32 [num_tiles, 10, tile*tile]; grad f32 [num_tiles, budget, 13]
// (every element written). tile must be 16.
extern "C" int lara_blend_bwd(const float* entries, const int* counts,
                              const float* scalars, float* stash, int* ndone,
                              const float* cot, float* grad, int replay,
                              int num_tiles, int tiles_x, int tile, int width,
                              int height, int budget, int chunk,
                              float alpha_min, float t_min, float near_cull,
                              float dist_near, float dist_far,
                              float filter2d_invsq, void* stream) {
  if (tile * tile != 32 * kWarps) return static_cast<int>(cudaErrorInvalidValue);
  if (replay && budget / chunk > kMaxReplayChunks)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!replay && (stash == nullptr || ndone == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{tiles_x, tile, width, height, budget, chunk,
           alpha_min, t_min, near_cull, dist_near, dist_far, filter2d_invsq};
  auto s = static_cast<cudaStream_t>(stream);
  return replay ? launch<true>(entries, counts, scalars, stash, ndone, cot, grad, num_tiles, p, s)
                : launch<false>(entries, counts, scalars, stash, ndone, cot, grad, num_tiles, p, s);
}
