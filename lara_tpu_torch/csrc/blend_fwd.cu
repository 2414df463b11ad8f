// Per-tile 2DGS surfel blend, forward: the Hopper kernel behind
// lara_tpu_torch/ops/rasterizer/cuda_blend.py:blend_tiles.
//
// Replaces the TPU kernel lara_tpu/ops/rasterizer/pallas_blend.py
// (_fwd_kernel -> _fwd_one_tile -> _chunk_fn, launched by _run_fwd), with
// and without its stash outputs (_run_fwd(stash=True)).
//
// What it computes. For each tile (8x8, 16x16 or 32x32: one template
// instantiation each, P = tile^2 pixels; any other edge as sub-tiles of one
// of these, blend_common.cuh), the depth-sorted window of packed
// rows [K, 13] (center_cam, au, bv, rgb, opacity) is composited front to
// back into 10 raw accumulators per pixel: rgb, alpha, depth sum, median
// depth, camera-space normal, distortion. Per (entry, pixel): ray-plane hit
// t, rho = min(rho_3d, filter2d_invsq * d^2) (the min also switches the depth
// to the center z), alpha = min(0.99, op * exp(-rho / 2)), culled below
// alpha_min / near_cull; a pixel stops at the first entry with
// T * (1 - alpha) < transmittance_min.
//
// What bounds it on this card. At the serving budget K = 512 a view reads
// 1024 tiles x 512 x 13 f32 = 27 MB of windows (about 8 us at 3.35 TB/s),
// but does 256 pixels x ~40 flops, one expf and one division per entry
// read: issue slots per entry-pixel bound it, not bytes. The first version
// (one pixel per thread, the entry as 19 scalar fields in shared memory,
// the staging on a quarter of the block, one dependent chain per thread)
// spent about 1.6 SM clocks per entry-pixel at the eval config.
//
// What the design does about it:
//  - one block of P / 2 threads per tile (128 at 16x16), two pixels per
//    thread (p and p + P / 2, rows y and y + tile / 2): each entry is read
//    once for two pixels, and the two pixels' hits are independent chains;
//  - a chunk of entries is staged in shared memory as five float4 records
//    per entry (blend_common.cuh: stage_chunk), with the per-entry values
//    that do not depend on the pixel (unit normal flipped toward the camera,
//    screen center, n.c, au.c, bv.c) computed there once; all threads stage,
//    two per entry; a thread reads an entry as five broadcast 16-byte loads;
//    a chunk longer than 512 entries is staged in pieces of 512 (40,960 B),
//    with the exit test still at the chunk's end;
//  - an entry with no opacity (the fine stage's deselected surfels) is
//    skipped before its hits, a branch uniform over the block; the hits of
//    an entry do not depend on T: both pixels' hits are computed before
//    either composite, so the scheduler interleaves two chains; the
//    decisions are those of the first version, taken in the same order;
//  - each thread keeps T, the 10 accumulators and the distortion moments
//    (A, M1, M2) of its two pixels in registers; T is multiplicative,
//    T <- T (1 - alpha), which selects the same entries as the TPU kernel's
//    log-domain `live` mask because T only decreases;
//  - blocks take the tiles heaviest first (blend_common.cuh:
//    tile_of_block): tiles range from empty to the full budget, and a heavy
//    tile started in the last wave would run on while most SMs idle;
//  - a thread whose pixels are both done leaves the chunk, and the block
//    leaves its tile as soon as every pixel is done (__syncthreads_count),
//    so opaque tiles read only the chunks they need.
//
// Stash (training; `stash` non-null). The backward kernel (blend_bwd.cu)
// walks the processed chunks in reverse and needs, per pixel, each chunk's
// carry-in and the final carry. So the kernel writes the carry
// (T, A, M1, M2) at the start of every chunk it processes, into slot ci of
// stash [T, budget/chunk + 1, 4, P], then the carry after the last chunk
// into slot ndone, and the processed-chunk count into ndone[tile] (the
// iteration at which the __syncthreads_count exit fires, or budget/chunk
// runs out). Slots past ndone are not written. A pixel that dies inside a
// chunk keeps the T of the entry that killed it (T * (1 - alpha) <
// transmittance_min): it is stashed so in every later slot. The JAX carry
// keeps multiplying by (1 - alpha) instead; both stay below
// transmittance_min, and the backward only tests T >= transmittance_min,
// so either gives the same gradients. With `stash` null (serving) the same
// code writes nothing more and the outputs are bit for bit the same.
//
// Rounding: see blend_common.cuh. The decisions round as the plain version
// (blend_tiles_reference) does; the colour, depth, normal and distortion
// sums use fmaf.

#include "blend_common.cuh"

namespace {

using namespace blend;

// The accumulators and the carry of one pixel.
struct Acc {
  Carry c;              // T, A (the alpha channel), M1, M2
  float r, g, b, dsum, med, nx, ny, nz, dist;
};

__device__ __forceinline__ void composite(Acc& a, const Entry& en, const Hit& h, const Params& p,
                                          const View& v) {
  if (!(a.c.T >= p.t_min && passes_cull(h, p))) return;
  const float t_next = next_t(a.c.T, h.alpha);
  if (t_next < p.t_min) {  // this pixel is saturated: it stops here
    a.c.T = t_next;
    return;
  }
  const float w = __fmul_rn(h.alpha, a.c.T);
  a.r = fmaf(w, en.rgb.x, a.r);
  a.g = fmaf(w, en.rgb.y, a.g);
  a.b = fmaf(w, en.rgb.z, a.b);
  a.dsum = fmaf(w, h.depth, a.dsum);
  a.nx = fmaf(w, en.n.x, a.nx);
  a.ny = fmaf(w, en.n.y, a.ny);
  a.nz = fmaf(w, en.n.z, a.nz);
  const float md = dist_depth(h.depth, p, v);
  // w (m^2 A + M2 - 2 m M1) over the exclusive prefix moments
  a.dist = fmaf(w, fmaf(-2.0f * md, a.c.M1, fmaf(md * md, a.c.A, a.c.M2)), a.dist);
  add_moments(a.c, w, md);
  if (a.c.T > 0.5f) a.med = h.depth;
  a.c.T = t_next;
}

// The walk of one block. kSplit: the chunk is longer than kMaxStaged
// entries and is staged in pieces; a template parameter, so that shorter
// chunks run the one-piece code: 80 registers at tile 16 (91 with the piece
// loop at run time). kSubTiled: the block is one sub-tile of a tile of edge
// p.tile (blend_common.cuh), parts_x a side; its stash count goes to
// part_ndone [T][parts], its pixels to their places in the tile.
template <int kTile, bool kSplit, bool kSubTiled>
__device__ __forceinline__ void fwd_block(const float* __restrict__ entries,
                                          const int* __restrict__ counts,
                                          const float* __restrict__ scalars,
                                          float* __restrict__ out, float* __restrict__ stash,
                                          int* __restrict__ ndone, Params p,
                                          int parts_x) {
  constexpr int kPixels = TileShape<kTile>::kPixels, kThreads = TileShape<kTile>::kThreads;
  extern __shared__ float4 rec[];  // [min(chunk, kMaxStaged)][kRecords]
  __shared__ int order[order_scratch(kThreads)];
  const SubBlock sb = kSubTiled ? sub_block(parts_x) : SubBlock{static_cast<int>(blockIdx.x), 0};
  const int num_tiles = kSubTiled ? gridDim.x / (parts_x * parts_x) : gridDim.x;
  const int t = tile_of_block<kThreads>(counts, num_tiles, sb.rank, p.budget, order);
  const int tid = threadIdx.x;
  // the thread's two pixels in the tile (-1 past a sub-tiled tile's edge)
  const int pixels = kSubTiled ? p.tile * p.tile : kPixels;
  const int i0 = kSubTiled ? tile_pixel<kTile>(tid, sb.part, parts_x, p.tile) : tid;
  const int i1 = kSubTiled ? tile_pixel<kTile>(tid + kThreads, sb.part, parts_x, p.tile)
                      : tid + kThreads;
  const int n = min(counts[t], p.budget);
  const View v = make_view(scalars, p);
  const Pixel q0 = make_pixel(t, kSubTiled ? max(i0, 0) : i0, p, v);
  const Pixel q1 = make_pixel(t, kSubTiled ? max(i1, 0) : i1, p, v);
  Acc a0{}, a1{};
  a0.c.T = kSubTiled && i0 < 0 ? -1.0f : 1.0f;  // past the edge: saturated from the start
  a1.c.T = kSubTiled && i1 < 0 ? -1.0f : 1.0f;

  // stash slot ci of this tile and pixel: stash[t][ci][j][pixel]
  const int slots = p.budget / p.chunk + 1;
  // the thread's first pixel (one block a tile) or the tile's corner
  // (sub-tiles), and each pixel from there
  const int base = kSubTiled ? 0 : tid, off0 = kSubTiled ? i0 : 0;
  const int off1 = kSubTiled ? i1 : kThreads;
  auto stash_carry = [&](int ci) {
    float* s = stash + (static_cast<size_t>(t) * slots + ci) * 4 * pixels + base;
    auto put = [&](const Carry& c, float* sh) {
      sh[0] = c.T;
      sh[pixels] = c.A;
      sh[2 * pixels] = c.M1;
      sh[3 * pixels] = c.M2;
    };
    if (!kSubTiled || i0 >= 0) put(a0.c, s + off0);
    if (!kSubTiled || i1 >= 0) put(a1.c, s + off1);
  };

  const float* tile_rows = entries + static_cast<size_t>(t) * p.budget * kPackCols;
  // composite the ms entries staged from row k
  auto walk = [&](int k, int ms) {
    stage_chunk(rec, tile_rows + static_cast<size_t>(k) * kPackCols, ms, v);
    __syncthreads();
    for (int j = 0; j < ms; ++j) {
      if (!(a0.c.T >= p.t_min || a1.c.T >= p.t_min)) break;
      const Entry en = load_entry(rec, j);
      if (!(en.ctr.w > 0.0f)) continue;  // never composited (the fine stage's deselected)
      const Hit h0 = entry_hit(en, q0, p.filter2d_invsq);
      const Hit h1 = entry_hit(en, q1, p.filter2d_invsq);
      composite(a0, en, h0, p, v);
      composite(a1, en, h1, p, v);
    }
  };
  int ci = 0;
  for (int k0 = 0; k0 < n; k0 += p.chunk) {
    const int m = min(p.chunk, n - k0);
    if (stash != nullptr) stash_carry(ci);
    ++ci;
    if constexpr (kSplit) {
      // staged in pieces; the exit test stays at the chunk's end, as in the
      // TPU kernel
      for (int s0 = 0; s0 < m; s0 += kMaxStaged) {
        if (s0 > 0) __syncthreads();  // the previous piece is read
        walk(k0 + s0, min(kMaxStaged, m - s0));
      }
    } else {
      walk(k0, m);
    }
    // barrier before the next chunk overwrites shared memory; the tile is
    // done once no pixel has transmittance left
    if (__syncthreads_count(a0.c.T >= p.t_min || a1.c.T >= p.t_min) == 0) break;
  }
  if (stash != nullptr) {
    stash_carry(ci);
    if (tid == 0) ndone[kSubTiled ? t * parts_x * parts_x + sb.part : t] = ci;
  }

  float* o = out + static_cast<size_t>(t) * kNumChannels * pixels + base;
  auto write = [&](const Acc& a, float* oh) {
    oh[0 * pixels] = a.r;
    oh[1 * pixels] = a.g;
    oh[2 * pixels] = a.b;
    oh[3 * pixels] = a.c.A;
    oh[4 * pixels] = a.dsum;
    oh[5 * pixels] = a.med;
    oh[6 * pixels] = a.nx;
    oh[7 * pixels] = a.ny;
    oh[8 * pixels] = a.nz;
    oh[9 * pixels] = a.dist;
  };
  if (!kSubTiled || i0 >= 0) write(a0, o + off0);
  if (!kSubTiled || i1 >= 0) write(a1, o + off1);
}

// One block per tile of edge kTile.
template <int kTile, bool kSplit>
__global__ void __launch_bounds__(TileShape<kTile>::kThreads) blend_fwd_kernel(
    const float* __restrict__ entries, const int* __restrict__ counts,
    const float* __restrict__ scalars, float* __restrict__ out, float* __restrict__ stash,
    int* __restrict__ ndone, Params p) {
  fwd_block<kTile, kSplit, false>(entries, counts, scalars, out, stash, ndone, p, 1);
}

// One block per sub-tile of edge kTile, parts_x^2 per tile of edge p.tile;
// ndone: the sub-tiles' counts [T][parts_x^2].
template <int kTile, bool kSplit>
__global__ void __launch_bounds__(TileShape<kTile>::kThreads) blend_fwd_sub_kernel(
    const float* __restrict__ entries, const int* __restrict__ counts,
    const float* __restrict__ scalars, float* __restrict__ out, float* __restrict__ stash,
    int* __restrict__ ndone, Params p, int parts_x) {
  fwd_block<kTile, kSplit, true>(entries, counts, scalars, out, stash, ndone, p, parts_x);
}

// At least this much dynamic shared memory per block, so that at most 20
// warps share an SM: at tile 16, five blocks (with six, which 80 registers
// allow, the H100 ran up to 14 % slower, on synthetic scenes and on a
// serving request's windows, and no case faster); at tile 8, twenty blocks
// of one warp. At tile 32 the registers already hold a 16-warp block to one
// per SM.
template <int kTile>
constexpr size_t min_smem() {
  constexpr int blocks = 20 / TileShape<kTile>::kWarps;
  return blocks >= 2 ? 233472 / (blocks + 1) - 1024 + 16 : 0;
}

template <int kTile>
int launch(const float* entries, const int* counts, const float* scalars, float* out,
           float* stash, int* ndone, int num_tiles, const Params& p, cudaStream_t stream) {
  const bool split = p.chunk > kMaxStaged;
  const size_t records = sizeof(float4) * kRecords * (split ? kMaxStaged : p.chunk);
  const size_t smem = records > min_smem<kTile>() ? records : min_smem<kTile>();
  auto kernel = split ? blend_fwd_kernel<kTile, true> : blend_fwd_kernel<kTile, false>;
  kernel<<<num_tiles, TileShape<kTile>::kThreads, smem, stream>>>(
      entries, counts, scalars, out, stash, ndone, p);
  return static_cast<int>(cudaGetLastError());
}

// The sub-tiled launch: num_tiles x parts_x^2 blocks of edge kTile; with a
// stash, the sub-tiles' counts (into part_ndone, or straight into ndone when
// a tile is one sub-tile), then fill_stash_kernel.
template <int kTile>
int launch_sub(const float* entries, const int* counts, const float* scalars, float* out,
               float* stash, int* ndone, int* part_ndone, int num_tiles, int parts_x,
               const Params& p, cudaStream_t stream) {
  const bool split = p.chunk > kMaxStaged;
  const size_t records = sizeof(float4) * kRecords * (split ? kMaxStaged : p.chunk);
  const size_t smem = records > min_smem<kTile>() ? records : min_smem<kTile>();
  auto kernel = split ? blend_fwd_sub_kernel<kTile, true> : blend_fwd_sub_kernel<kTile, false>;
  const bool fill = stash != nullptr && parts_x > 1;
  kernel<<<num_tiles * parts_x * parts_x, TileShape<kTile>::kThreads, smem, stream>>>(
      entries, counts, scalars, out, stash, fill ? part_ndone : ndone, p, parts_x);
  if (fill) {
    fill_stash_kernel<<<num_tiles, 256, 0, stream>>>(stash, part_ndone, ndone, p.tile, kTile,
                                                     parts_x, p.budget / p.chunk + 1);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `stash` and `ndone` may be null (no stash); otherwise stash is f32
// [num_tiles, budget/chunk + 1, 4, tile*tile] and ndone int32 [num_tiles].
// tile must be 8, 16 or 32 (lara_blend_fwd_sub takes the others); chunk
// must divide budget.
extern "C" int lara_blend_fwd(const float* entries, const int* counts,
                              const float* scalars, float* out, float* stash,
                              int* ndone, int num_tiles,
                              int tiles_x, int tile, int width, int height,
                              int budget, int chunk, float alpha_min,
                              float t_min, float near_cull, float dist_near,
                              float dist_far, float filter2d_invsq,
                              void* stream) {
  if (chunk <= 0 || budget % chunk != 0) return static_cast<int>(cudaErrorInvalidValue);
  Params p{tiles_x, tile, width, height, budget, chunk,
           alpha_min, t_min, near_cull, dist_near, dist_far, filter2d_invsq};
  auto s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 8: return launch<8>(entries, counts, scalars, out, stash, ndone, num_tiles, p, s);
    case 16: return launch<16>(entries, counts, scalars, out, stash, ndone, num_tiles, p, s);
    case 32: return launch<32>(entries, counts, scalars, out, stash, ndone, num_tiles, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Any tile, as ceil(tile / sub_edge)^2 sub-tiles of sub_edge (8, 16 or 32)
// each: the same arguments as lara_blend_fwd, and with a stash, where a
// tile has more than one sub-tile, `part_ndone`, int32 [num_tiles,
// ceil(tile / sub_edge)^2] of scratch.
extern "C" int lara_blend_fwd_sub(const float* entries, const int* counts,
                                  const float* scalars, float* out, float* stash,
                                  int* ndone, int num_tiles,
                                  int tiles_x, int tile, int width, int height,
                                  int budget, int chunk, float alpha_min,
                                  float t_min, float near_cull, float dist_near,
                                  float dist_far, float filter2d_invsq,
                                  void* stream, int sub_edge, int* part_ndone) {
  if (chunk <= 0 || budget % chunk != 0 || tile <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int parts_x = (tile + sub_edge - 1) / sub_edge;
  if (stash != nullptr && parts_x > 1 && part_ndone == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{tiles_x, tile, width, height, budget, chunk,
           alpha_min, t_min, near_cull, dist_near, dist_far, filter2d_invsq};
  auto s = static_cast<cudaStream_t>(stream);
  switch (sub_edge) {
    case 8: return launch_sub<8>(entries, counts, scalars, out, stash, ndone, part_ndone,
                                 num_tiles, parts_x, p, s);
    case 16: return launch_sub<16>(entries, counts, scalars, out, stash, ndone, part_ndone,
                                   num_tiles, parts_x, p, s);
    case 32: return launch_sub<32>(entries, counts, scalars, out, stash, ndone, part_ndone,
                                   num_tiles, parts_x, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
