// What the blend kernels share (blend_fwd.cu, blend_bwd.cu): the staging of
// a chunk of entries into shared memory, the entry-pixel hit, the forward
// walk's decisions and its carry update.
//
// Rounding. Every value a decision reads (the staged normal, screen center
// and dot products, the hit t, rho_3d against rho_2d, alpha against
// alpha_min, depth against near_cull, T * (1 - alpha) against
// transmittance_min) is written here with explicit IEEE round-to-nearest
// operations (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn), in the order of
// the plain version's elementwise ops (cuda_blend.blend_tiles_reference), so
// it does not depend on what the compiler contracts into FMAs, and the
// kernels take every decision as the plain version does. The carry (T, A,
// M1, M2) is updated here too, so the stash forward and the replay walk of
// the backward write the same bits. The sources are still built with
// --fmad=false (ops/_build.py), so any product and sum not written with
// fmaf() rounds on its own and the two template modes of the backward
// compute the same bits; the kernels write fmaf() where a value feeds no
// decision and no carry (the forward's colour, depth, normal and
// distortion sums, the backward's derivative chain).
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace blend {

constexpr int kPackCols = 13;
constexpr int kNumChannels = 10;
constexpr int kRecords = 5;                 // float4 per staged entry
// entries staged in shared memory at a time: a longer chunk is staged in
// pieces of this many (40,960 B of records)
constexpr int kMaxStaged = 512;

// One block per kTile x kTile tile, two pixels per thread: pixel p and
// p + kThreads, rows y and y + kTile / 2. The kernels are instantiated at
// tiles 8, 16 and 32: 32, 128 and 512 threads.
//
// Sub-tiles. A tile of another edge t runs as parts_x^2 sub-tiles of an
// instantiated edge kTile (parts_x = ceil(t / kTile); the wrapper picks
// kTile, cuda_blend.subtile), one block each, row-major from the tile's
// corner: the sub kernels (blend_fwd_sub_kernel, blend_bwd_sub_kernel) are
// the same code with each pixel mapped into the tile (tile_pixel). Where
// kTile does not divide t, a sub-tile's pixels past the tile's edge start
// saturated: they never hit, never hold back the exit, are never written.
// A sub-tile walks until its own pixels are saturated: a saturated pixel
// adds nothing, so the accumulators are those of the whole tile's walk; the
// stash of the tile's last processed chunk and its count are completed by
// fill_stash_kernel, and the backward's per-sub-tile gradients are summed
// in sub-tile order (blend_bwd.cu: sum_parts_kernel).
template <int kTile>
struct TileShape {
  static constexpr int kPixels = kTile * kTile;
  static constexpr int kThreads = kPixels / 2;
  static constexpr int kWarps = kThreads / 32;
};

struct Params {
  int tiles_x, tile, width, height, budget, chunk;
  float alpha_min, t_min, near_cull, dist_near, dist_far, filter2d_invsq;
};

// The tile a block takes: the one of rank `rank` (blockIdx.x, or the
// block's tile rank when a tile runs as sub-tiles) when the tiles are
// ordered by descending work, min(count, budget), ties by ascending index,
// so the heaviest tiles start first and the light ones fill the last wave
// (longest processing time first); every tile is taken by exactly one
// block. Found by a binary search over the count value and a scan over the
// tiles of that value: about ten block-wide sums of per-thread registers,
// against a tile's tens of microseconds. Every thread of the block calls it
// (it synchronises). More than kThreads * order_per_thread(kThreads) tiles
// (at least 1,024, the most that binning's 5-bit tile bounds allow) keep
// the launch order (tile `rank`). `scratch` is order_scratch(kThreads) ints of shared
// memory that no thread touches again before the block's next barrier (the
// backward lends its dynamic shared memory: a static array would add to
// every block's shared memory, and the replay backward at tile 16 and
// budget 512 fits 4 blocks per SM with no byte to spare).
__host__ __device__ constexpr int order_per_thread(int threads) {
  return threads * 16 >= 1024 ? 16 : 1024 / threads;
}
__host__ __device__ constexpr int order_scratch(int threads) { return threads / 32 + 1; }

template <int kThreads>
__device__ __forceinline__ int tile_of_block(const int* __restrict__ counts, int num_tiles,
                                             int rank, int budget, int* scratch) {
  constexpr int kOrderPerThread = order_per_thread(kThreads);
  int* warp_sums = scratch;  // [kThreads / 32]
  int& picked = scratch[kThreads / 32];
  if (num_tiles > kThreads * kOrderPerThread) return rank;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (num_tiles + kThreads - 1) / kThreads;
  int c[kOrderPerThread];  // the work of tiles tid * per + i, -1 past the end
#pragma unroll
  for (int i = 0; i < kOrderPerThread; ++i) {
    const int t = tid * per + i;
    c[i] = (i < per && t < num_tiles) ? min(counts[t], budget) : -1;
  }
  auto block_sum = [&](int v) {
    v = __reduce_add_sync(0xffffffffu, v);
    __syncthreads();  // the previous sum is read
    if (lane == 0) warp_sums[warp] = v;
    __syncthreads();
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) sum += warp_sums[w];
    return sum;
  };
  // the work value of rank b: the least x with #{c > x} <= b
  const int b = rank;
  int lo = 0, hi = budget;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    int above = 0;
#pragma unroll
    for (int i = 0; i < kOrderPerThread; ++i) above += c[i] > mid;
    if (block_sum(above) <= b) hi = mid;
    else lo = mid + 1;
  }
  int above = 0, same = 0;
#pragma unroll
  for (int i = 0; i < kOrderPerThread; ++i) {
    above += c[i] > lo;
    same += c[i] == lo;
  }
  const int k = b - block_sum(above);  // rank among the tiles of work lo
  // exclusive scan of `same` over the threads, in tile order
  int incl = same;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  __syncthreads();
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int before = incl - same;
  for (int w = 0; w < warp; ++w) before += warp_sums[w];
  if (k >= before && k < before + same) {
    int r = k - before;
#pragma unroll
    for (int i = 0; i < kOrderPerThread; ++i) {
      if (c[i] == lo) {
        if (r == 0) picked = tid * per + i;
        --r;
      }
    }
  }
  __syncthreads();
  return picked;
}

// The block of a sub-tiled launch: its tile's rank among the tiles and its
// sub-tile (row-major in the tile, parts_x a side).
struct SubBlock {
  int rank, part;
};

__device__ __forceinline__ SubBlock sub_block(int parts_x) {
  const int parts = parts_x * parts_x;
  return SubBlock{static_cast<int>(blockIdx.x) / parts, static_cast<int>(blockIdx.x) % parts};
}

// The tile pixel (y * tile + x) of local pixel l of sub-tile `part` of an
// edge-kTile instantiation, or -1 past the tile's edge.
template <int kTile>
__device__ __forceinline__ int tile_pixel(int l, int part, int parts_x, int tile) {
  const int x = (part % parts_x) * kTile + l % kTile;
  const int y = (part / parts_x) * kTile + l / kTile;
  return (x < tile && y < tile) ? y * tile + x : -1;
}

// After a sub-tiled walk that wrote the stash [T][slots][4][tile^2]: each
// sub-tile wrote its own processed-chunk count into part_ndone [T][parts]
// and its carries up to that slot. A tile's count is the largest of its
// sub-tiles' (the whole tile's walk stops after the chunk where its last
// pixel saturates), and a sub-tile that stopped earlier holds its final
// carry in every later slot up to it: a saturated pixel's carry does not
// change. One block per tile.
__global__ void fill_stash_kernel(float* __restrict__ stash, const int* __restrict__ part_ndone,
                                  int* __restrict__ ndone, int tile, int sub_edge, int parts_x,
                                  int slots) {
  const int t = blockIdx.x, parts = parts_x * parts_x, pixels = tile * tile;
  const int* own = part_ndone + static_cast<size_t>(t) * parts;
  int nd = 0;
  for (int i = 0; i < parts; ++i) nd = max(nd, own[i]);
  if (threadIdx.x == 0) ndone[t] = nd;
  float* s = stash + static_cast<size_t>(t) * slots * 4 * pixels;
  for (int pix = threadIdx.x; pix < pixels; pix += blockDim.x) {
    const int from = own[(pix / tile / sub_edge) * parts_x + pix % tile / sub_edge];
    for (int ci = from + 1; ci <= nd; ++ci)
      for (int j = 0; j < 4; ++j) s[(ci * 4 + j) * pixels + pix] = s[(from * 4 + j) * pixels + pix];
  }
}

// Per view: focal lengths, image center, the distortion's depth map scale.
struct View {
  float fx, fy, half_w, half_h, nrm_c;
};

__device__ __forceinline__ View make_view(const float* scalars, const Params& p) {
  View v;
  v.fx = __fdiv_rn(static_cast<float>(p.width), __fmul_rn(2.0f, scalars[0]));
  v.fy = __fdiv_rn(static_cast<float>(p.height), __fmul_rn(2.0f, scalars[1]));
  v.half_w = p.width * 0.5f;
  v.half_h = p.height * 0.5f;
  v.nrm_c = __fdiv_rn(p.dist_far, __fsub_rn(p.dist_far, p.dist_near));
  return v;
}

// One pixel: its center and its ray direction (z = 1) in camera space.
struct Pixel {
  float px, py, dx, dy;
};

__device__ __forceinline__ Pixel make_pixel(int t, int pid, const Params& p, const View& v) {
  Pixel q;
  q.px = static_cast<float>((t % p.tiles_x) * p.tile + pid % p.tile) + 0.5f;
  q.py = static_cast<float>((t / p.tiles_x) * p.tile + pid / p.tile) + 0.5f;
  q.dx = __fdiv_rn(__fsub_rn(q.px, v.half_w), v.fx);
  q.dy = __fdiv_rn(__fsub_rn(q.py, v.half_h), v.fy);
  return q;
}

// (a.b) summed left to right, as the plain version's a0*b0 + a1*b1 + a2*b2.
__device__ __forceinline__ float dot3_rn(float a0, float a1, float a2, float b0, float b1,
                                         float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)), __fmul_rn(a2, b2));
}

// Stage the m rows of a chunk as records of five float4 per entry:
//   [0] n0, n1, n2, n.c   the unit normal flipped toward the camera, n.c
//   [1] au0, au1, au2, au.c
//   [2] bv0, bv1, bv2, bv.c
//   [3] c2x, c2y, cz, op  the screen center, the center's z, the opacity
//   [4] r, g, b, 0
// Two threads per entry, each computing half of the record, all threads of
// the block at work. The caller synchronises before reading.
__device__ __forceinline__ void stage_chunk(float4* rec, const float* rows, int m,
                                            const View& v) {
  for (int i = threadIdx.x; i < 2 * m; i += blockDim.x) {
    const int j = i >> 1;
    const float* r = rows + static_cast<size_t>(j) * kPackCols;
    const float cx = r[0], cy = r[1], cz = r[2];
    float4* out = rec + j * kRecords;
    if ((i & 1) == 0) {
      const float au0 = r[3], au1 = r[4], au2 = r[5];
      const float bv0 = r[6], bv1 = r[7], bv2 = r[8];
      float n0 = __fsub_rn(__fmul_rn(au1, bv2), __fmul_rn(au2, bv1));
      float n1 = __fsub_rn(__fmul_rn(au2, bv0), __fmul_rn(au0, bv2));
      float n2 = __fsub_rn(__fmul_rn(au0, bv1), __fmul_rn(au1, bv0));
      const float nn = __fadd_rn(dot3_rn(n0, n1, n2, n0, n1, n2), 1e-20f);
      const float inv = __fdiv_rn(1.0f, __fsqrt_rn(nn));
      const float sgn = dot3_rn(cx, cy, cz, n0, n1, n2) <= 0.0f ? inv : -inv;
      n0 = __fmul_rn(n0, sgn);
      n1 = __fmul_rn(n1, sgn);
      n2 = __fmul_rn(n2, sgn);
      out[0] = make_float4(n0, n1, n2, dot3_rn(n0, n1, n2, cx, cy, cz));
      out[4] = make_float4(r[9], r[10], r[11], 0.0f);
    } else {
      const float au0 = r[3], au1 = r[4], au2 = r[5];
      const float bv0 = r[6], bv1 = r[7], bv2 = r[8];
      const float cz_safe = fabsf(cz) < 1e-6f ? 1e-6f : cz;
      out[1] = make_float4(au0, au1, au2, dot3_rn(au0, au1, au2, cx, cy, cz));
      out[2] = make_float4(bv0, bv1, bv2, dot3_rn(bv0, bv1, bv2, cx, cy, cz));
      out[3] = make_float4(__fadd_rn(__fdiv_rn(__fmul_rn(v.fx, cx), cz_safe), v.half_w),
                           __fadd_rn(__fdiv_rn(__fmul_rn(v.fy, cy), cz_safe), v.half_h),
                           cz, r[12]);
    }
  }
}

// One staged entry, read as five broadcast 16-byte loads.
struct Entry {
  float4 n, au, bv, ctr, rgb;
};

__device__ __forceinline__ Entry load_entry(const float4* rec, int j) {
  const float4* e = rec + j * kRecords;
  return Entry{e[0], e[1], e[2], e[3], e[4]};
}

// The entry-pixel quantities: ray-plane hit t, its (u, v) in the surfel's
// axes, the screen offset, rho = min(rho_3d, rho_2d) with the depth it
// selects, e = exp(-rho / 2), gauss = op e and alpha = min(0.99, gauss).
struct Hit {
  float nd, tt, dau, dbv, u, v, ex, ey, rho, depth, e, gauss, alpha;
  bool nd_ok, use3d;
};

__device__ __forceinline__ Hit entry_hit(const Entry& en, const Pixel& q, float f2) {
  Hit h;
  h.nd = __fadd_rn(__fadd_rn(__fmul_rn(en.n.x, q.dx), __fmul_rn(en.n.y, q.dy)), en.n.z);
  h.nd_ok = fabsf(h.nd) >= 1e-8f;
  h.tt = __fdiv_rn(en.n.w, h.nd_ok ? h.nd : 1e-8f);
  h.dau = __fadd_rn(__fadd_rn(__fmul_rn(en.au.x, q.dx), __fmul_rn(en.au.y, q.dy)), en.au.z);
  h.dbv = __fadd_rn(__fadd_rn(__fmul_rn(en.bv.x, q.dx), __fmul_rn(en.bv.y, q.dy)), en.bv.z);
  h.u = __fsub_rn(__fmul_rn(h.tt, h.dau), en.au.w);
  h.v = __fsub_rn(__fmul_rn(h.tt, h.dbv), en.bv.w);
  const float rho3d = h.nd_ok ? __fadd_rn(__fmul_rn(h.u, h.u), __fmul_rn(h.v, h.v))
                              : CUDART_INF_F;
  h.ex = __fsub_rn(q.px, en.ctr.x);
  h.ey = __fsub_rn(q.py, en.ctr.y);
  const float rho2d = __fmul_rn(f2, __fadd_rn(__fmul_rn(h.ex, h.ex), __fmul_rn(h.ey, h.ey)));
  h.use3d = rho3d <= rho2d;
  h.rho = h.use3d ? rho3d : rho2d;
  h.depth = h.use3d ? h.tt : en.ctr.z;
  h.e = expf(__fmul_rn(-0.5f, h.rho));
  h.gauss = __fmul_rn(en.ctr.w, h.e);
  h.alpha = fminf(0.99f, h.gauss);
  return h;
}

// Whether a live pixel takes the entry at all (before the saturation test).
__device__ __forceinline__ bool passes_cull(const Hit& h, const Params& p) {
  return h.alpha >= p.alpha_min && h.depth >= p.near_cull;
}

__device__ __forceinline__ float next_t(float T, float alpha) {
  return __fmul_rn(T, __fsub_rn(1.0f, alpha));
}

// The distortion's normalised depth m of a hit (feeds no decision).
__device__ __forceinline__ float dist_depth(float depth, const Params& p, const View& v) {
  return v.nrm_c * (1.0f - __fdividef(p.dist_near, fmaxf(depth, 1e-6f)));
}

// The pixel's carry: transmittance and the distortion moments
// A = sum w, M1 = sum w m, M2 = sum w m^2.
struct Carry {
  float T, A, M1, M2;
};

// Composite weight w and moments of one taken entry into the carry.
__device__ __forceinline__ void add_moments(Carry& c, float w, float md) {
  const float wm = __fmul_rn(w, md);
  c.A = __fadd_rn(c.A, w);
  c.M1 = __fadd_rn(c.M1, wm);
  c.M2 = __fadd_rn(c.M2, __fmul_rn(wm, md));
}

}  // namespace blend
