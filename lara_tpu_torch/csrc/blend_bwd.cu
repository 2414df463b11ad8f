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
// What it computes. Per tile of P = tile^2 pixels (tiles 8, 16 and 32: one
// template instantiation each; any other edge as sub-tiles of one of these,
// blend_common.cuh, each sub-tile's rows summed in sub-tile order by
// sum_parts_kernel), from the entries [K, 13], the cotangent of
// the raw accumulators [10, P] (the median's is ignored: its gradient is
// defined as 0), the forward's stash [budget/chunk + 1, 4, P] and its
// processed-chunk count ndone: the gradient of every entry row [K, 13]
// (center_cam, au, bv, rgb, opacity), summed over the tile's P pixels.
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
// Decisions and precision. Which entries a pixel composited is decided once,
// by a forward walk (per chunk from its stashed carry-in, or in replay mode
// over the whole tile) with the forward kernel's decisions and carry update
// (blend_common.cuh), so alpha, the alpha >= alpha_min cull, the
// T * (1 - alpha) >= transmittance_min test and the 3D/2D switch decide
// exactly as in the forward; the walk keeps one bit per entry and pixel, and
// T after the last entry composited at the end of every 32-entry sub-block.
// The reverse walk then recovers T_k of each composited entry from the T
// after it by one division by (1 - alpha_k):
// the forward rounded T_k (1 - alpha_k) once with the same (1 - alpha_k), so
// each step is within two roundings, and the error of a sub-block's at most
// 32 steps stays under 1e-5 relative, far inside the gradient bar
// (5e-4 + 1e-3 relative); each sub-block restarts from its exact end value.
// The derivative chain feeds no decision: it contracts (fmaf) and divides by
// (1 - alpha), n.d and depth^2 with __fdividef / __frcp_rn.
//
// What bounds it on this card: issue slots. Per processed entry-pixel it
// computes the hit (~30 flops, one expf, one division) in the forward walk
// and again, with ~60 flops of derivatives, in the reverse walk where the
// pixel composited the entry, and its share of the reduction of 19 partials
// over the tile's pixels; a train render reads 1024 tiles x 128 x 13 f32 =
// 6.8 MB of entries and writes as much. The first version (one pixel per
// thread; each of the 19 partials summed over a warp by its own 5-shuffle
// butterfly, 95 shuffles per entry and warp; T_k of the whole chunk and the
// partials of every warp in shared memory, 108 KB per block, two blocks per
// SM) spent about 4.8 SM clocks per entry-pixel at the train config, most
// of it in shuffles.
//
// What the design does about it (the numbers are tile 16's):
//  - one block of P / 2 threads per tile (128 at tile 16), two pixels per
//    thread (p and p + P / 2):
//    a thread sums its two pixels' partials in registers before any
//    shuffle, and the two pixels are independent chains;
//  - a transposed warp reduction (warp_sum19): at each butterfly level a
//    lane keeps half of its partial vector and sends the other half, so the
//    19 partials take 10 + 5 + 3 + 2 + 1 = 21 shuffles per entry and warp,
//    and lane l ends with the warp's total of partial slot19(l); the order
//    of every sum is fixed and there are no atomics, so two calls agree bit
//    for bit; an entry no lane of the warp composited skips it;
//  - no T_k buffer: the hit bits and the sub-block end values of a chunk
//    take 2 x ceil(chunk / 32) x 256 x 4 B, 4 KB at chunk 64, so shared
//    memory per block falls from 108 KB to 28 KB (staged records 5,120 B,
//    bits and end values 4,096 B, the per-warp partials of the chunk
//    [4][chunk][19] 19,456 B: 28,672 B), and registers, not shared memory,
//    set the blocks per SM (__launch_bounds__ asks for 16 warps of two
//    pixels each: four blocks at tile 16, sixteen at tile 8, one at tile 32);
//    a sub-block re-walk into a [16, 256] T_k buffer
//    (45 KB per block) was measured first and was slower;
//  - the forward walk takes two entries at a time and computes their four
//    hits (two entries, two pixels) before the four decisions, so the
//    scheduler has four independent chains between two T updates; a pair
//    with no opacity (the fine stage's deselected surfels) skips them;
//  - the per-warp partials are chained into rows once per reduction group,
//    one thread per entry, after one barrier: the whole chunk at tile 16 up
//    to chunk 128, one 32-entry sub-block at tiles 8 and 32 and past 128, so
//    the partials' shared memory does not grow with the chunk;
//  - a chunk longer than 512 entries is staged in pieces of 512, walked
//    forward in order and in reverse backward; the early exit and the stash
//    slots stay per chunk, as in the TPU kernel;
//  - blocks take the tiles heaviest first (blend_common.cuh:
//    tile_of_block), so no heavy tile is left for the last wave.
// Five blocks per SM (the cotangents and totals moved to shared memory, 93
// registers) ran faster on the random scene of the coarse decoder at init
// and slower on the trained-statistics scene, on the H100; four are kept.
//
// Replay mode (stash null on input). The tile walks its chunks forward once
// from (T = 1, A = M1 = M2 = 0), with the forward kernel's exit rules (a
// pixel stops at the entry with T (1 - alpha) < transmittance_min, the tile
// after the chunk where no pixel has T >= transmittance_min left, or when
// the count runs out) and its exact operations, so every carry-in, the
// final carry and the processed-chunk count ndone are bit for bit those the
// stash forward writes. It is the stash mode's paired walk (walk_chunk),
// which here also adds the moments (A, M1, M2) of every composited entry,
// and it keeps the hit bits and end values of every sub-block of every
// processed chunk in shared memory, [budget/chunk][ceil(chunk/32)][256]
// each: 2 x budget/chunk x ceil(chunk/32) KB, 8 KB at budget 128 and chunk
// 64 (32,768 B per block), 32 KB at budget 512 (57,344 B per block: four
// blocks and the 1 KB the SM reserves for each fill its 233,472 B exactly,
// so the kernel declares no static shared memory; with tile_of_block's 20 B
// of it three blocks fit, and the eval replay ran at 0.77 ms, not 0.53, on
// the H100). The reverse walk then runs chunk by chunk from those bits, with
// the totals (A, M1, M2) from the final carry, so each entry-pixel's hit is
// computed once forward and, where the pixel composited the entry, once in
// reverse, as in the stash mode. Bits past a pixel's stop are 0. With the
// optional outputs non-null the replay also writes what it rebuilt, in the
// stash forward's layout, for a check against the stash path.
//
// Sub-tiles. In stash mode a sub-tile walks every chunk up to its tile's
// ndone from the (filled) stash; in replay mode it replays until its own
// pixels are saturated, which gives the same decisions for them, and rows
// of chunks past its own count are its zeros. The sum over the sub-tiles is
// a second launch, in a fixed order, so the replay equals the stash path and
// two calls agree, bit for bit.
//
// The global form. Where the block's shared memory (smem_bytes) would pass
// the 232,448 B a block may ask for (the replay at budget 4096 and chunk 64
// at tile 16, 286,720 B; at budget 1024 and chunk 64 at tile 32; the stash
// mode at chunks past 512 at tile 32), the kept hit bits and end values go
// to a scratch buffer in device memory instead, one region per tile, which
// the wrapper allocates: the same kernel (kGlobal), with each thread
// reading back only the words it wrote, so nothing else changes. The form
// follows (tile, budget, chunk, mode) alone.

#include "blend_common.cuh"

namespace {

using namespace blend;

constexpr int kSub = 32;              // entries per sub-block: one word of hit bits
constexpr int kPartials = 19;
constexpr int kMaxSmem = 232448;      // dynamic shared memory a block may ask for on sm_90

// Entries whose per-warp partials are reduced together: the chunk, up to
// this many, so that the partials do not grow with the chunk. At tile 16,
// 128: a chunk up to 128 reduces once, after one barrier (4 warps x 128 x
// 19 partials: 38,912 B at most); at tiles 8 and 32 one sub-block (1 and 16
// warps: 2,432 and 38,912 B).
__host__ __device__ constexpr int reduce_group(int tile) { return tile == 16 ? 128 : kSub; }

// Blocks per SM the launch bounds ask for: 16 warps each, as at tile 16
// (4 blocks of 128 threads), so a thread keeps up to 128 registers.
template <int kTile>
__host__ __device__ constexpr int min_blocks() { return 16 / TileShape<kTile>::kWarps; }
// per-entry partial gradients, summed over the tile's pixels
enum Partial {
  dN0, dN1, dN2, dNc, dAu0, dAu1, dAu2, dCau, dBv0, dBv1, dBv2, dCbv,
  dC2x, dC2y, dCz, dR, dG, dB, dOp
};

// Sum 19 values over the warp, transposed: at the level of lane bit b, a
// lane keeps the half of its vector that its bit selects and adds what its
// partner sends of the same half. Returns the warp's total of the value
// slot19(lane), or of a padding slot.
__device__ __forceinline__ float warp_sum19(const float (&v)[kPartials], int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2, b0 = lane & 1;
  float a[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const float lo = v[i], hi = i + 10 < kPartials ? v[i + 10] : 0.0f;
    a[i] = (b4 ? hi : lo) + __shfl_xor_sync(0xffffffffu, b4 ? lo : hi, 16);
  }
  float b[5];
#pragma unroll
  for (int i = 0; i < 5; ++i)
    b[i] = (b3 ? a[i + 5] : a[i]) + __shfl_xor_sync(0xffffffffu, b3 ? a[i] : a[i + 5], 8);
  float c[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float lo = b[i], hi = i + 3 < 5 ? b[i + 3] : 0.0f;
    c[i] = (b2 ? hi : lo) + __shfl_xor_sync(0xffffffffu, b2 ? lo : hi, 4);
  }
  float d[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lo = c[i], hi = i + 2 < 3 ? c[i + 2] : 0.0f;
    d[i] = (b1 ? hi : lo) + __shfl_xor_sync(0xffffffffu, b1 ? lo : hi, 2);
  }
  return (b0 ? d[1] : d[0]) + __shfl_xor_sync(0xffffffffu, b0 ? d[0] : d[1], 1);
}

// The partial whose total warp_sum19 leaves in `lane`, or -1 for padding.
__device__ __forceinline__ int slot19(int lane) {
  const int in_c = ((lane & 2) ? 2 : 0) + (lane & 1);      // of c's 3 (+1 pad)
  const int in_b = ((lane & 4) ? 3 : 0) + in_c;             // of b's 5 (+1 pad)
  const int f = ((lane & 16) ? 10 : 0) + ((lane & 8) ? 5 : 0) + in_b;
  return (in_c < 3 && in_b < 5 && f < kPartials) ? f : -1;
}

// One pixel's state in the backward: its ray, its cotangent, the final
// moments, and S = sum over the later composited entries of w dL/dw.
struct PixelGrad {
  Pixel q;
  float g_r, g_g, g_b, g_a, g_d, g_n0, g_n1, g_n2, g_dist;
  float a_tot, m1_tot, m2_tot, S;
};

// One decision of the forward walk, from the entry-pixel's hit: whether the
// pixel composites the entry; the carry after it (T, and with kMoments the
// moments, in the stash forward's operations); and Tc, T after the last
// entry it composited (T but for the entry that saturates the pixel, which
// it does not composite).
template <bool kMoments>
__device__ __forceinline__ bool decide(const Entry& en, const Hit& h, Carry& c, float& Tc,
                                       const Params& p, const View& v) {
  if (!(c.T >= p.t_min && en.ctr.w > 0.0f && passes_cull(h, p))) return false;
  const float t_next = next_t(c.T, h.alpha);
  if (t_next < p.t_min) {  // a saturating entry leaves T below t_min: no more hits
    c.T = t_next;
    return false;
  }
  if constexpr (kMoments) add_moments(c, __fmul_rn(h.alpha, c.T), dist_depth(h.depth, p, v));
  c.T = t_next;
  Tc = t_next;
  return true;
}

// The forward walk over the m staged entries of one chunk, from the carry c
// and Tc of the thread's two pixels q0, q1: per 32-entry sub-block sb, the
// hit bits of each pixel into hits[sb][P] and Tc at the sub-block's end
// into tend[sb][P] (pixel tid and tid + P / 2); each thread reads back only
// its own pixels' words. Two entries at a time: their
// four hits before the four decisions, each pixel's in entry order, so the
// scheduler has four independent chains between two T updates. A pair with
// no opacity (the fine stage's deselected surfels) records no hit without
// computing one. A pixel that has stopped decides nothing more; skipping
// the pairs met when both of a thread's pixels have stopped made both modes
// slower on the H100, on the random and the trained-statistics scenes, so
// the hits are computed.
template <int kTile, bool kMoments>
__device__ __forceinline__ void walk_chunk(const float4* rec, int m, const Pixel& q0,
                                           const Pixel& q1, Carry (&c)[2], float (&Tc)[2],
                                           unsigned* hits, float* tend, const Params& p,
                                           const View& v) {
  constexpr int kPixels = TileShape<kTile>::kPixels, kThreads = TileShape<kTile>::kThreads;
  const int tid = threadIdx.x;
  unsigned bits0 = 0u, bits1 = 0u;
  auto record = [&](int j, bool hit0, bool hit1) {
    bits0 |= static_cast<unsigned>(hit0) << (j % kSub);
    bits1 |= static_cast<unsigned>(hit1) << (j % kSub);
    if (j % kSub == kSub - 1 || j == m - 1) {
      const int at = (j / kSub) * kPixels + tid;
      hits[at] = bits0;
      hits[at + kThreads] = bits1;
      tend[at] = Tc[0];
      tend[at + kThreads] = Tc[1];
      bits0 = bits1 = 0u;
    }
  };
  for (int j = 0; j < m; j += 2) {
    const Entry e0 = load_entry(rec, j), e1 = load_entry(rec, min(j + 1, m - 1));
    if (!(e0.ctr.w > 0.0f) && !(j + 1 < m && e1.ctr.w > 0.0f)) {
      record(j, false, false);
      if (j + 1 < m) record(j + 1, false, false);
      continue;
    }
    const Hit h00 = entry_hit(e0, q0, p.filter2d_invsq);
    const Hit h01 = entry_hit(e0, q1, p.filter2d_invsq);
    const Hit h10 = entry_hit(e1, q0, p.filter2d_invsq);
    const Hit h11 = entry_hit(e1, q1, p.filter2d_invsq);
    record(j, decide<kMoments>(e0, h00, c[0], Tc[0], p, v),
           decide<kMoments>(e0, h01, c[1], Tc[1], p, v));
    if (j + 1 < m)
      record(j + 1, decide<kMoments>(e1, h10, c[0], Tc[0], p, v),
             decide<kMoments>(e1, h11, c[1], Tc[1], p, v));
  }
}

// The partials of one composited entry-pixel, added into d; S moves past
// it, and Tc, T after the entry, becomes T_k, T before it.
__device__ __forceinline__ void add_partials(const Entry& en, PixelGrad& s, float& Tc,
                                             const Params& p, const View& v,
                                             float (&d)[kPartials]) {
  const Hit h = entry_hit(en, s.q, p.filter2d_invsq);
  // the forward rounded T_k (1 - alpha) once: T_k back within two roundings
  const float tk = __fdividef(Tc, 1.0f - h.alpha);
  Tc = tk;
  const float w = __fmul_rn(h.alpha, tk);
  const float md = dist_depth(h.depth, p, v);
  float dl_dw = fmaf(s.g_r, en.rgb.x, fmaf(s.g_g, en.rgb.y, fmaf(s.g_b, en.rgb.z, s.g_a)));
  dl_dw = fmaf(s.g_d, h.depth, dl_dw);
  dl_dw = fmaf(s.g_n0, en.n.x, fmaf(s.g_n1, en.n.y, fmaf(s.g_n2, en.n.z, dl_dw)));
  dl_dw = fmaf(s.g_dist, fmaf(md * md, s.a_tot, fmaf(-2.0f * md, s.m1_tot, s.m2_tot)), dl_dw);
  const float dl_dalpha = fmaf(tk, dl_dw, -__fdividef(s.S, 1.0f - h.alpha));
  s.S = fmaf(w, dl_dw, s.S);
  const float dl_dmd = 2.0f * s.g_dist * w * fmaf(md, s.a_tot, -s.m1_tot);
  const float dl_ddepth = fmaf(s.g_d, w, h.depth > 1e-6f
      ? dl_dmd * __fdividef(v.nrm_c * p.dist_near, h.depth * h.depth) : 0.0f);
  const float dl_dgauss = h.gauss < 0.99f ? dl_dalpha : 0.0f;
  const float dl_drho = -0.5f * h.gauss * dl_dgauss;
  d[dOp] = fmaf(dl_dgauss, h.e, d[dOp]);
  d[dR] = fmaf(w, s.g_r, d[dR]);
  d[dG] = fmaf(w, s.g_g, d[dG]);
  d[dB] = fmaf(w, s.g_b, d[dB]);
  d[dN0] = fmaf(w, s.g_n0, d[dN0]);
  d[dN1] = fmaf(w, s.g_n1, d[dN1]);
  d[dN2] = fmaf(w, s.g_n2, d[dN2]);
  if (h.use3d) {
    const float dl_du = 2.0f * h.u * dl_drho;
    const float dl_dv = 2.0f * h.v * dl_drho;
    const float dl_dtt = fmaf(dl_du, h.dau, fmaf(dl_dv, h.dbv, dl_ddepth));
    const float inv_nd = __frcp_rn(h.nd_ok ? h.nd : 1e-8f);
    const float dl_dnd = h.nd_ok ? -dl_dtt * h.tt * inv_nd : 0.0f;
    d[dNc] = fmaf(dl_dtt, inv_nd, d[dNc]);
    d[dN0] = fmaf(dl_dnd, s.q.dx, d[dN0]);
    d[dN1] = fmaf(dl_dnd, s.q.dy, d[dN1]);
    d[dN2] += dl_dnd;
    const float ddau = dl_du * h.tt, ddbv = dl_dv * h.tt;
    d[dAu0] = fmaf(ddau, s.q.dx, d[dAu0]);
    d[dAu1] = fmaf(ddau, s.q.dy, d[dAu1]);
    d[dAu2] += ddau;
    d[dCau] -= dl_du;
    d[dBv0] = fmaf(ddbv, s.q.dx, d[dBv0]);
    d[dBv1] = fmaf(ddbv, s.q.dy, d[dBv1]);
    d[dBv2] += ddbv;
    d[dCbv] -= dl_dv;
  } else {
    const float k = -2.0f * p.filter2d_invsq * dl_drho;
    d[dC2x] = fmaf(k, h.ex, d[dC2x]);
    d[dC2y] = fmaf(k, h.ey, d[dC2y]);
    d[dCz] += dl_ddepth;
  }
}

// Chain the block's partials of entry row r into its 13 gradient columns.
__device__ __forceinline__ void chain_row(const float (&d)[kPartials], const float* r,
                                          const View& v, float* out) {
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
  const float dsafe = -(d[dC2x] * v.fx * cx + d[dC2y] * v.fy * cy) / (cz_safe * cz_safe);
  const float dcx = d[dNc] * n0 + d[dCau] * au0 + d[dCbv] * bv0 + d[dC2x] * v.fx / cz_safe;
  const float dcy = d[dNc] * n1 + d[dCau] * au1 + d[dCbv] * bv1 + d[dC2y] * v.fy / cz_safe;
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

// Chunks whose hit bits and end values a block keeps: one in stash mode,
// every chunk of the budget in replay mode.
__host__ __device__ inline int kept_chunks(int budget, int chunk, bool replay) {
  return replay ? budget / chunk : 1;
}

// Shared memory of one block, in bytes (cuda_blend.kernel_smem mirrors it):
// the staged records (a piece of at most kMaxStaged entries), the kept
// chunks' hit bits and end values (in the shared form only), the per-warp
// partials of a reduction group.
size_t smem_bytes(int tile, int budget, int chunk, bool replay, bool global) {
  const size_t pixels = static_cast<size_t>(tile) * tile, warps = pixels / 64;
  const size_t nsub = (chunk + kSub - 1) / kSub;
  const size_t staged = chunk < kMaxStaged ? chunk : kMaxStaged;
  const size_t group = chunk < reduce_group(tile) ? chunk : reduce_group(tile);
  const size_t bits = global ? 0 : 2 * kept_chunks(budget, chunk, replay) * nsub * pixels;
  return sizeof(float4) * kRecords * staged + sizeof(float) * (bits + warps * group * kPartials);
}

// The backward of one block.
// kReplay false: stash and ndone_arr are the stash forward's outputs, read.
// kReplay true: they are optional outputs (null to skip) of the replay walk.
// kGlobal: the hit bits and end values live in `scratch`, [T][2][kept][nsub]
// [P] words, instead of shared memory (each thread reads back only what it
// wrote, so the form changes where they live and nothing else).
// kSplit: the chunk is longer than reduce_group(kTile) entries, so it is
// reduced in groups and, past kMaxStaged, staged in pieces. A template
// parameter, so that shorter chunks fold the loops to one pass: at tile 16
// the stash mode keeps 118 registers (123 with the loops at run time).
// kSubTiled: the block is sub-tile `part` of a tile of edge p.tile, parts_x a
// side (blend_common.cuh): its pixels map into the tile; the stash mode
// reads the tile's count ndone_arr[t] and walks to it; the replay walks to
// its own count, written (when asked) to ndone_arr[t][parts]; the rows go to
// grad[part][t] ([parts][T][K][13], summed by sum_parts_kernel), and the
// global form's region is the sub-tile's.
template <int kTile, bool kReplay, bool kGlobal, bool kSplit, bool kSubTiled>
__device__ __forceinline__ void bwd_block(const float* __restrict__ entries,
                                          const int* __restrict__ counts,
                                          const float* __restrict__ scalars,
                                          float* __restrict__ stash, int* __restrict__ ndone_arr,
                                          const float* __restrict__ cot,
                                          float* __restrict__ grad, unsigned* __restrict__ scratch,
                                          Params p, int parts_x) {
  constexpr int kPixels = TileShape<kTile>::kPixels, kThreads = TileShape<kTile>::kThreads;
  constexpr int kWarps = TileShape<kTile>::kWarps;
  extern __shared__ float4 smem4[];
  const int c = p.chunk;
  const int nsub = (c + kSub - 1) / kSub;
  const int kept = kept_chunks(p.budget, c, kReplay);
  float4* rec = smem4;                                    // [min(chunk, kMaxStaged)][kRecords]
  unsigned* hits;                                         // [kept][nsub][P] bits
  float* tend;                                            // and end Tc
  float* red;                                             // [kWarps][group][19]
  if constexpr (kGlobal) {
    red = reinterpret_cast<float*>(rec + min(c, kMaxStaged) * kRecords);
  } else {
    hits = reinterpret_cast<unsigned*>(rec + min(c, kMaxStaged) * kRecords);
    tend = reinterpret_cast<float*>(hits + kept * nsub * kPixels);
    red = tend + kept * nsub * kPixels;
  }

  // the partials' buffer is first written after the staging's barrier
  const int parts = kSubTiled ? parts_x * parts_x : 1;
  const SubBlock sb = kSubTiled ? sub_block(parts_x) : SubBlock{0, 0};
  const int num_tiles = kSubTiled ? gridDim.x / parts : gridDim.x;
  int t;
  if constexpr (kSubTiled) {
    t = tile_of_block<kThreads>(counts, num_tiles, sb.rank, p.budget, reinterpret_cast<int*>(red));
  } else {
    t = tile_of_block<kThreads>(counts, gridDim.x, blockIdx.x, p.budget,
                                reinterpret_cast<int*>(red));
  }
  if constexpr (kGlobal) {
    hits = scratch + (kSubTiled ? static_cast<size_t>(t) * parts + sb.part : t)
                     * 2 * kept * nsub * kPixels;
    tend = reinterpret_cast<float*>(hits + static_cast<size_t>(kept) * nsub * kPixels);
  }
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int slot = slot19(lane);
  const int n = min(counts[t], p.budget);
  const int slots = p.budget / c + 1;
  const View v = make_view(scalars, p);
  const float* tile_rows = entries + static_cast<size_t>(t) * p.budget * kPackCols;
  // the thread's two pixels in the tile (-1 past a sub-tiled tile's edge)
  const int pixels = kSubTiled ? p.tile * p.tile : kPixels;
  const int pix[2] = {
      kSubTiled ? tile_pixel<kTile>(tid, sb.part, parts_x, p.tile) : tid,
      kSubTiled ? tile_pixel<kTile>(tid + kThreads, sb.part, parts_x, p.tile) : tid + kThreads};
  const bool in[2] = {!kSubTiled || pix[0] >= 0, !kSubTiled || pix[1] >= 0};
  // the stash of the tile, at the thread's first pixel (one block a tile) or
  // at its corner (sub-tiles); off[h]: the pixel h from there
  float* st = stash == nullptr ? nullptr
                               : stash + static_cast<size_t>(t) * slots * 4 * pixels
                                     + (kSubTiled ? 0 : tid);
  const int off[2] = {kSubTiled ? pix[0] : 0, kSubTiled ? pix[1] : kThreads};

  PixelGrad s[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    s[h].q = make_pixel(t, kSubTiled ? max(pix[h], 0) : tid + h * kThreads, p, v);
    const float* g = cot + static_cast<size_t>(t) * kNumChannels * pixels
                     + (kSubTiled ? pix[h] : tid) + (kSubTiled ? 0 : h * kThreads);
    s[h].g_r = in[h] ? g[0] : 0.0f;
    s[h].g_g = in[h] ? g[pixels] : 0.0f;
    s[h].g_b = in[h] ? g[2 * pixels] : 0.0f;
    s[h].g_a = in[h] ? g[3 * pixels] : 0.0f;
    s[h].g_d = in[h] ? g[4 * pixels] : 0.0f;
    s[h].g_n0 = in[h] ? g[6 * pixels] : 0.0f;
    s[h].g_n1 = in[h] ? g[7 * pixels] : 0.0f;
    s[h].g_n2 = in[h] ? g[8 * pixels] : 0.0f;
    s[h].g_dist = in[h] ? g[9 * pixels] : 0.0f;
    s[h].S = 0.0f;
  }

  int ndone;
  if constexpr (kReplay) {
    // the forward kernel's walk, without its colour sums, over every chunk;
    // a pixel past the tile's edge starts saturated
    Carry cr[2] = {{in[0] ? 1.0f : -1.0f, 0.0f, 0.0f, 0.0f},
                   {in[1] ? 1.0f : -1.0f, 0.0f, 0.0f, 0.0f}};
    float Tc[2] = {1.0f, 1.0f};
    auto put_carry = [&](int ci) {
      if (st != nullptr) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!in[h]) continue;
          float* sh = st + (ci * 4) * pixels + off[h];
          sh[0] = cr[h].T;
          sh[pixels] = cr[h].A;
          sh[2 * pixels] = cr[h].M1;
          sh[3 * pixels] = cr[h].M2;
        }
      }
    };
    int ci = 0;
    for (int k0 = 0; k0 < n; k0 += c) {
      const int m = min(c, n - k0);
      put_carry(ci);
      for (int s0 = 0;; s0 += kMaxStaged) {  // one piece unless kSplit
        const int ms = kSplit ? min(kMaxStaged, m - s0) : m;
        stage_chunk(rec, tile_rows + static_cast<size_t>(k0 + s0) * kPackCols, ms, v);
        __syncthreads();
        const int at = (ci * nsub + s0 / kSub) * kPixels;
        walk_chunk<kTile, true>(rec, ms, s[0].q, s[1].q, cr, Tc, hits + at, tend + at, p, v);
        if (!kSplit || s0 + kMaxStaged >= m) break;
        __syncthreads();  // the piece is read
      }
      ++ci;
      // also the barrier before the next staging (here or in the reverse walk)
      if (__syncthreads_count(cr[0].T >= p.t_min || cr[1].T >= p.t_min) == 0) break;
    }
    put_carry(ci);
    if (ndone_arr != nullptr && tid == 0) {
      if constexpr (kSubTiled) ndone_arr[t * parts + sb.part] = ci;
      else ndone_arr[t] = ci;
    }
    ndone = ci;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      s[h].a_tot = cr[h].A;
      s[h].m1_tot = cr[h].M1;
      s[h].m2_tot = cr[h].M2;
    }
  } else {
    ndone = ndone_arr[t];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* sh = st + (ndone * 4) * pixels + off[h];
      s[h].a_tot = in[h] ? sh[pixels] : 0.0f;
      s[h].m1_tot = in[h] ? sh[2 * pixels] : 0.0f;
      s[h].m2_tot = in[h] ? sh[3 * pixels] : 0.0f;
    }
  }

  // rows no pixel took: in chunks the walk never reached, and (kSplit; the
  // one-group code zeroes them with the chunk's rows) past the count
  float* tile_grad = grad + (kSubTiled ? static_cast<size_t>(sb.part) * num_tiles + t : t)
                            * p.budget * kPackCols;
  const int zero_from = kSplit ? min(n, ndone * c) : ndone * c;
  for (int i = zero_from * kPackCols + tid; i < p.budget * kPackCols; i += kThreads)
    tile_grad[i] = 0.0f;

  for (int ci = ndone - 1; ci >= 0; --ci) {
    const int k0 = ci * c;
    const int m = min(c, n - k0);
    const int last = kSplit ? ((m - 1) / kMaxStaged) * kMaxStaged : 0;  // the last piece
    // the reverse walk starts at the last piece (staged here before the
    // stash walk's place: staged below it, the replay took 127 registers at
    // tile 16, not 125)
    if constexpr (kReplay) {
      stage_chunk(rec, tile_rows + static_cast<size_t>(k0 + last) * kPackCols, m - last, v);
      __syncthreads();
    }

    // which entries each pixel composited (one bit each) and Tc at the end
    // of each sub-block: in stash mode from a walk of the chunk from its
    // carry-in, in replay mode kept from the tile's walk
    const int base = kReplay ? ci * nsub * kPixels : 0;
    if constexpr (!kReplay) {
      Carry cw[2];
      float Tc[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        cw[h].T = Tc[h] = in[h] ? st[(ci * 4) * pixels + off[h]] : -1.0f;
        cw[h].A = cw[h].M1 = cw[h].M2 = 0.0f;
      }
      for (int s0 = 0;; s0 += kMaxStaged) {  // one piece unless kSplit
        const int ms = kSplit ? min(kMaxStaged, m - s0) : m;
        stage_chunk(rec, tile_rows + static_cast<size_t>(k0 + s0) * kPackCols, ms, v);
        __syncthreads();
        const int at = (s0 / kSub) * kPixels;
        walk_chunk<kTile, false>(rec, ms, s[0].q, s[1].q, cw, Tc, hits + at, tend + at, p, v);
        if (!kSplit || s0 + kMaxStaged >= m) break;
        __syncthreads();  // the piece is read
      }
    }

    // reverse walk, piece by piece (the last one is staged: above in replay
    // mode, by the walk in stash mode), a reduction group at a time, a
    // sub-block at a time from its end's Tc: T_k of each composited entry by
    // division, per-entry partials summed over the two pixels, then over the
    // warp; after each group one thread per entry chains them into its row.
    // Without kSplit: one piece, one group of the whole chunk, whose rows
    // past m are zeroed here
    const int group = kSplit ? reduce_group(kTile) : c;
    for (int s0 = last;; s0 -= kMaxStaged) {
      const int ms = kSplit ? min(kMaxStaged, m - s0) : m;
      if (s0 != last) {  // the previous group's barrier freed the records
        stage_chunk(rec, tile_rows + static_cast<size_t>(k0 + s0) * kPackCols, ms, v);
        __syncthreads();
      }
      for (int g0 = kSplit ? ((ms - 1) / group) * group : 0;; g0 -= group) {
        const int gm = kSplit ? min(group, ms - g0) : m;
        for (int j0 = g0 + ((gm - 1) / kSub) * kSub; j0 >= g0; j0 -= kSub) {
          const int at = base + ((s0 + j0) / kSub) * kPixels + tid;
          const unsigned w0 = hits[at], w1 = hits[at + kThreads];
          float tc0 = tend[at], tc1 = tend[at + kThreads];
          for (int j = min(g0 + gm, j0 + kSub) - 1; j >= j0; --j) {
            const bool hit0 = (w0 >> (j - j0)) & 1u, hit1 = (w1 >> (j - j0)) & 1u;
            float* rj = red + (warp * group + j - g0) * kPartials;
            if (__any_sync(0xffffffffu, hit0 || hit1)) {
              float d[kPartials];
#pragma unroll
              for (int f = 0; f < kPartials; ++f) d[f] = 0.0f;
              const Entry en = load_entry(rec, j);
              if (hit0) add_partials(en, s[0], tc0, p, v, d);
              if (hit1) add_partials(en, s[1], tc1, p, v, d);
              const float total = warp_sum19(d, lane);
              if (slot >= 0) rj[slot] = total;
            } else if (slot >= 0) {
              rj[slot] = 0.0f;
            }
          }
        }
        __syncthreads();

        // one thread per entry: sum the warps, chain into the 13 columns
        for (int j = tid; j < (kSplit ? gm : c); j += kThreads) {
          const size_t row = static_cast<size_t>(k0 + s0 + g0 + j) * kPackCols;
          float* out = tile_grad + row;
          if (j >= gm) {
            for (int f = 0; f < kPackCols; ++f) out[f] = 0.0f;
            continue;
          }
          float d[kPartials];
#pragma unroll
          for (int f = 0; f < kPartials; ++f) {
            float sum = 0.0f;
#pragma unroll
            for (int wi = 0; wi < kWarps; ++wi) sum += red[(wi * group + j) * kPartials + f];
            d[f] = sum;
          }
          chain_row(d, tile_rows + row, v, out);
        }
        // barrier before the next group, piece or chunk overwrites shared memory
        __syncthreads();
        if (!kSplit || g0 == 0) break;
      }
      if (!kSplit || s0 == 0) break;
    }
  }
}

// One block per tile of edge kTile.
template <int kTile, bool kReplay, bool kGlobal, bool kSplit>
__global__ void __launch_bounds__(TileShape<kTile>::kThreads, min_blocks<kTile>())
    blend_bwd_kernel(const float* __restrict__ entries, const int* __restrict__ counts,
                     const float* __restrict__ scalars, float* __restrict__ stash,
                     int* __restrict__ ndone_arr, const float* __restrict__ cot,
                     float* __restrict__ grad, unsigned* __restrict__ scratch, Params p) {
  bwd_block<kTile, kReplay, kGlobal, kSplit, false>(entries, counts, scalars, stash, ndone_arr,
                                                    cot, grad, scratch, p, 1);
}

// One block per sub-tile of edge kTile, parts_x^2 per tile of edge p.tile.
template <int kTile, bool kReplay, bool kGlobal, bool kSplit>
__global__ void __launch_bounds__(TileShape<kTile>::kThreads, min_blocks<kTile>())
    blend_bwd_sub_kernel(const float* __restrict__ entries, const int* __restrict__ counts,
                         const float* __restrict__ scalars, float* __restrict__ stash,
                         int* __restrict__ ndone_arr, const float* __restrict__ cot,
                         float* __restrict__ grad, unsigned* __restrict__ scratch, Params p,
                         int parts_x) {
  bwd_block<kTile, kReplay, kGlobal, kSplit, true>(entries, counts, scalars, stash, ndone_arr,
                                                   cot, grad, scratch, p, parts_x);
}

// grad[i] = the sum of the n sub-tiles' rows parts[0..parts)[i], in sub-tile
// order, so that two calls give the same bits.
__global__ void sum_parts_kernel(const float* __restrict__ part_grads, float* __restrict__ grad,
                                 size_t n, int parts) {
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float sum = part_grads[i];
    for (int k = 1; k < parts; ++k) sum += part_grads[k * n + i];
    grad[i] = sum;
  }
}

template <int kTile, bool kReplay, bool kGlobal, bool kSubTiled>
int launch(const float* entries, const int* counts, const float* scalars,
           float* stash, int* ndone, const float* cot, float* grad, unsigned* scratch,
           int num_tiles, int parts_x, const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(kTile, p.budget, p.chunk, kReplay, kGlobal);
  const bool split = p.chunk > reduce_group(kTile);
  if constexpr (kSubTiled) {
    auto kernel = split ? blend_bwd_sub_kernel<kTile, kReplay, kGlobal, true>
                        : blend_bwd_sub_kernel<kTile, kReplay, kGlobal, false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<num_tiles * parts_x * parts_x, TileShape<kTile>::kThreads, smem, stream>>>(
        entries, counts, scalars, stash, ndone, cot, grad, scratch, p, parts_x);
  } else {
    auto kernel = split ? blend_bwd_kernel<kTile, kReplay, kGlobal, true>
                        : blend_bwd_kernel<kTile, kReplay, kGlobal, false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<num_tiles, TileShape<kTile>::kThreads, smem, stream>>>(
        entries, counts, scalars, stash, ndone, cot, grad, scratch, p);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int kTile, bool kSubTiled>
int launch_tile(const float* entries, const int* counts, const float* scalars,
                float* stash, int* ndone, const float* cot, float* grad, bool replay,
                unsigned* scratch, int num_tiles, int parts_x, const Params& p, cudaStream_t s) {
  if (scratch != nullptr)
    return replay ? launch<kTile, true, true, kSubTiled>(entries, counts, scalars, stash, ndone,
                                                         cot, grad, scratch, num_tiles, parts_x,
                                                         p, s)
                  : launch<kTile, false, true, kSubTiled>(entries, counts, scalars, stash, ndone,
                                                          cot, grad, scratch, num_tiles, parts_x,
                                                          p, s);
  return replay ? launch<kTile, true, false, kSubTiled>(entries, counts, scalars, stash, ndone,
                                                        cot, grad, scratch, num_tiles, parts_x,
                                                        p, s)
                : launch<kTile, false, false, kSubTiled>(entries, counts, scalars, stash, ndone,
                                                         cot, grad, scratch, num_tiles, parts_x,
                                                         p, s);
}

// The form follows (edge, budget, chunk, mode) alone, the edge being the
// tile's or, sub-tiled, the sub-tile's: the shared form where its shared
// memory fits kMaxSmem, else the global form, which needs `scratch`, and
// only then. sub_edge 0: one block per tile (tiles 8, 16, 32). Otherwise
// ceil(tile / sub_edge)^2 sub-tiles of sub_edge a tile: where that is more
// than one, the blocks write their rows to part_grads [parts][T][K][13],
// summed into grad by sum_parts_kernel, and a replay that writes its walk
// puts the sub-tiles' counts into part_ndone [T][parts] for
// fill_stash_kernel.
int run(const float* entries, const int* counts, const float* scalars, float* stash,
        int* ndone, const float* cot, float* grad, int replay, unsigned* scratch,
        int num_tiles, int tiles_x, int tile, int width, int height, int budget, int chunk,
        float alpha_min, float t_min, float near_cull, float dist_near, float dist_far,
        float filter2d_invsq, void* stream, int sub_edge, float* part_grads,
        int* part_ndone) {
  if (chunk <= 0 || budget % chunk != 0 || tile <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!replay && (stash == nullptr || ndone == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool global = smem_bytes(sub_edge ? sub_edge : tile, budget, chunk, replay != 0, false)
                      > kMaxSmem;
  if (global != (scratch != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  Params p{tiles_x, tile, width, height, budget, chunk,
           alpha_min, t_min, near_cull, dist_near, dist_far, filter2d_invsq};
  auto s = static_cast<cudaStream_t>(stream);
  if (sub_edge == 0) {
    switch (tile) {
      case 8: return launch_tile<8, false>(entries, counts, scalars, stash, ndone, cot, grad,
                                           replay != 0, scratch, num_tiles, 1, p, s);
      case 16: return launch_tile<16, false>(entries, counts, scalars, stash, ndone, cot, grad,
                                             replay != 0, scratch, num_tiles, 1, p, s);
      case 32: return launch_tile<32, false>(entries, counts, scalars, stash, ndone, cot, grad,
                                             replay != 0, scratch, num_tiles, 1, p, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const int parts_x = (tile + sub_edge - 1) / sub_edge, parts = parts_x * parts_x;
  const bool fill = replay && stash != nullptr && parts > 1;
  if ((parts > 1 && part_grads == nullptr) || (fill && part_ndone == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  float* rows = parts > 1 ? part_grads : grad;
  int* counts_out = fill ? part_ndone : ndone;
  int err;
  switch (sub_edge) {
    case 8: err = launch_tile<8, true>(entries, counts, scalars, stash, counts_out, cot, rows,
                                       replay != 0, scratch, num_tiles, parts_x, p, s);
      break;
    case 16: err = launch_tile<16, true>(entries, counts, scalars, stash, counts_out, cot, rows,
                                         replay != 0, scratch, num_tiles, parts_x, p, s);
      break;
    case 32: err = launch_tile<32, true>(entries, counts, scalars, stash, counts_out, cot, rows,
                                         replay != 0, scratch, num_tiles, parts_x, p, s);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  if (parts > 1) {
    const size_t n = static_cast<size_t>(num_tiles) * budget * kPackCols;
    const size_t blocks = (n + 255) / 256;
    sum_parts_kernel<<<blocks < 4096 ? blocks : 4096, 256, 0, s>>>(part_grads, grad, n, parts);
  }
  if (fill) {
    fill_stash_kernel<<<num_tiles, 256, 0, s>>>(stash, part_ndone, ndone, tile, sub_edge,
                                                parts_x, budget / chunk + 1);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// replay 0: stash f32 [num_tiles, budget/chunk + 1, 4, tile*tile] and ndone
// int32 [num_tiles] are inputs, from lara_blend_fwd. replay 1: the kernel
// rebuilds them, and writes them there where the pointers are non-null.
// cot f32 [num_tiles, 10, tile*tile]; grad f32 [num_tiles, budget, 13]
// (every element written). tile must be 8, 16 or 32 and chunk must divide
// budget. This entry point runs the shared form: it refuses a config whose
// block would need more than 232,448 B of shared memory (smem_bytes), which
// lara_blend_bwd_global takes.
extern "C" int lara_blend_bwd(const float* entries, const int* counts,
                              const float* scalars, float* stash, int* ndone,
                              const float* cot, float* grad, int replay,
                              int num_tiles, int tiles_x, int tile, int width,
                              int height, int budget, int chunk,
                              float alpha_min, float t_min, float near_cull,
                              float dist_near, float dist_far,
                              float filter2d_invsq, void* stream) {
  return run(entries, counts, scalars, stash, ndone, cot, grad, replay, nullptr, num_tiles,
             tiles_x, tile, width, height, budget, chunk, alpha_min, t_min, near_cull,
             dist_near, dist_far, filter2d_invsq, stream, 0, nullptr, nullptr);
}

// The global form, for exactly the configs lara_blend_bwd refuses for their
// shared memory: the same arguments, and `scratch`, num_tiles x 2 x kept x
// ceil(chunk / 32) x tile*tile 32-bit words (kept = budget / chunk in
// replay mode, else 1), which the kernel writes before it reads.
extern "C" int lara_blend_bwd_global(const float* entries, const int* counts,
                                     const float* scalars, float* stash, int* ndone,
                                     const float* cot, float* grad, int replay,
                                     int num_tiles, int tiles_x, int tile, int width,
                                     int height, int budget, int chunk,
                                     float alpha_min, float t_min, float near_cull,
                                     float dist_near, float dist_far,
                                     float filter2d_invsq, void* stream, void* scratch) {
  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return run(entries, counts, scalars, stash, ndone, cot, grad, replay,
             static_cast<unsigned*>(scratch), num_tiles, tiles_x, tile, width, height, budget,
             chunk, alpha_min, t_min, near_cull, dist_near, dist_far, filter2d_invsq, stream, 0,
             nullptr, nullptr);
}

// Any tile, as ceil(tile / sub_edge)^2 sub-tiles of sub_edge (8, 16 or 32):
// the arguments of lara_blend_bwd_global, `scratch` null where the
// sub-tile's shared form fits (smem_bytes at sub_edge), and where a tile
// has more than one sub-tile, `part_grads`, f32 [parts, num_tiles, budget,
// 13], and in replay mode with the stash outputs `part_ndone`, int32
// [num_tiles, parts], both scratch. Each scratch region of the global form
// is a sub-tile's: num_tiles x parts x 2 x kept x ceil(chunk / 32) x
// sub_edge^2 words.
extern "C" int lara_blend_bwd_sub(const float* entries, const int* counts,
                                  const float* scalars, float* stash, int* ndone,
                                  const float* cot, float* grad, int replay,
                                  int num_tiles, int tiles_x, int tile, int width,
                                  int height, int budget, int chunk,
                                  float alpha_min, float t_min, float near_cull,
                                  float dist_near, float dist_far,
                                  float filter2d_invsq, void* stream, void* scratch,
                                  int sub_edge, void* part_grads, void* part_ndone) {
  if (sub_edge != 8 && sub_edge != 16 && sub_edge != 32)
    return static_cast<int>(cudaErrorInvalidValue);
  return run(entries, counts, scalars, stash, ndone, cot, grad, replay,
             static_cast<unsigned*>(scratch), num_tiles, tiles_x, tile, width, height, budget,
             chunk, alpha_min, t_min, near_cull, dist_near, dist_far, filter2d_invsq, stream,
             sub_edge, static_cast<float*>(part_grads), static_cast<int*>(part_ndone));
}
