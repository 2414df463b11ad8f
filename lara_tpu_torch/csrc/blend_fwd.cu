// Per-tile 2DGS surfel blend, forward: the Hopper kernel behind
// lara_tpu_torch/ops/rasterizer/cuda_blend.py:blend_tiles.
//
// Replaces the TPU kernel lara_tpu/ops/rasterizer/pallas_blend.py
// (_fwd_kernel -> _fwd_one_tile -> _chunk_fn, launched by _run_fwd), with
// and without its stash outputs (_run_fwd(stash=True)).
//
// What it computes. For each 16x16 tile, the depth-sorted window of packed
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
// but does 256 pixels x ~40 flops and one expf per entry read: ALU and
// transcendental work per entry-pixel dominates, not bytes.
//
// What the design does about it:
//  - one 256-thread CTA per tile, one thread per pixel (grid = num tiles);
//  - a chunk of entries is staged in shared memory, and the per-entry
//    quantities that do not depend on the pixel (unit normal flipped toward
//    the camera, screen center, n.c, au.c, bv.c) are computed there once per
//    entry instead of once per pixel;
//  - each thread keeps T, the 10 accumulators and the distortion moments
//    (A, M1, M2) in registers; T is multiplicative, T <- T (1 - alpha),
//    which selects the same entries as the TPU kernel's log-domain `live`
//    mask because T only decreases;
//  - a thread that is done skips the math, and the block leaves its tile
//    as soon as every pixel is done (__syncthreads_count), so opaque tiles
//    read only the chunks they need.
//
// Stash (training; `stash` non-null). The backward kernel (blend_bwd.cu)
// walks the processed chunks in reverse and needs, per pixel, each chunk's
// carry-in and the final carry. So the kernel writes the carry
// (T, A, M1, M2) at the start of every chunk it processes, into slot ci of
// stash [T, budget/chunk + 1, 4, 256], then the carry after the last chunk
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
// No fast-math, and no FMA contraction (--fmad=false): the alpha >=
// alpha_min cull and the T > 0.5 median test are threshold decisions, and
// alpha is computed with the same correctly rounded operations, in the same
// order, as the plain version (blend_tiles_reference) so that both take them
// alike.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kPackCols = 13;
constexpr int kNumChannels = 10;
// per-entry values staged in shared memory (structure of arrays)
enum Field {
  kN0, kN1, kN2, kC2x, kC2y, kNc, kCau, kCbv, kCz,
  kAu0, kAu1, kAu2, kBv0, kBv1, kBv2, kR, kG, kB, kOp, kNumFields
};

struct Params {
  int tiles_x, tile, width, height, budget, chunk;
  float alpha_min, t_min, near_cull, dist_near, dist_far, filter2d_invsq;
};

__global__ void blend_fwd_kernel(const float* __restrict__ entries,
                                 const int* __restrict__ counts,
                                 const float* __restrict__ scalars,
                                 float* __restrict__ out,
                                 float* __restrict__ stash,
                                 int* __restrict__ ndone, Params p) {
  extern __shared__ float sm[];  // [kNumFields][chunk]
  const int t = blockIdx.x;
  const int pid = threadIdx.x;
  const int npix = blockDim.x;
  const int n = min(counts[t], p.budget);

  const float fx = p.width / (2.0f * scalars[0]);
  const float fy = p.height / (2.0f * scalars[1]);
  const float half_w = p.width * 0.5f, half_h = p.height * 0.5f;
  const float px = (t % p.tiles_x) * p.tile + (pid % p.tile) + 0.5f;
  const float py = (t / p.tiles_x) * p.tile + (pid / p.tile) + 0.5f;
  const float dx = (px - half_w) / fx;
  const float dy = (py - half_h) / fy;
  const float nrm_c = p.dist_far / (p.dist_far - p.dist_near);

  float T = 1.0f;
  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, acc_a = 0.f, dsum = 0.f;
  float med = 0.f, nx = 0.f, ny = 0.f, nz = 0.f, dist = 0.f;
  float m1 = 0.f, m2 = 0.f;  // sum w*m and sum w*m^2 (A is acc_a)

  // stash slot ci of this tile and pixel: stash[t][ci][j][pid]
  const int slots = p.budget / p.chunk + 1;
  auto stash_carry = [&](int ci) {
    float* s = stash + ((size_t)t * slots + ci) * 4 * npix + pid;
    s[0] = T;
    s[npix] = acc_a;
    s[2 * npix] = m1;
    s[3 * npix] = m2;
  };

  const float* tile_rows = entries + (size_t)t * p.budget * kPackCols;
  int ci = 0;
  for (int k0 = 0; k0 < n; k0 += p.chunk) {
    const int m = min(p.chunk, n - k0);
    if (stash != nullptr) stash_carry(ci);
    ++ci;
    for (int j = pid; j < m; j += npix) {
      const float* r = tile_rows + (size_t)(k0 + j) * kPackCols;
      const float cx = r[0], cy = r[1], cz = r[2];
      const float au0 = r[3], au1 = r[4], au2 = r[5];
      const float bv0 = r[6], bv1 = r[7], bv2 = r[8];
      float n0 = au1 * bv2 - au2 * bv1;
      float n1 = au2 * bv0 - au0 * bv2;
      float n2 = au0 * bv1 - au1 * bv0;
      // correctly rounded sqrt and division (not rsqrtf), as the plain version
      const float inv = 1.0f / sqrtf(n0 * n0 + n1 * n1 + n2 * n2 + 1e-20f);
      const float sgn = (cx * n0 + cy * n1 + cz * n2 <= 0.0f) ? inv : -inv;
      n0 *= sgn; n1 *= sgn; n2 *= sgn;
      const float cz_safe = fabsf(cz) < 1e-6f ? 1e-6f : cz;
      sm[kN0 * p.chunk + j] = n0;
      sm[kN1 * p.chunk + j] = n1;
      sm[kN2 * p.chunk + j] = n2;
      sm[kC2x * p.chunk + j] = fx * cx / cz_safe + half_w;
      sm[kC2y * p.chunk + j] = fy * cy / cz_safe + half_h;
      sm[kNc * p.chunk + j] = n0 * cx + n1 * cy + n2 * cz;
      sm[kCau * p.chunk + j] = au0 * cx + au1 * cy + au2 * cz;
      sm[kCbv * p.chunk + j] = bv0 * cx + bv1 * cy + bv2 * cz;
      sm[kCz * p.chunk + j] = cz;
      sm[kAu0 * p.chunk + j] = au0;
      sm[kAu1 * p.chunk + j] = au1;
      sm[kAu2 * p.chunk + j] = au2;
      sm[kBv0 * p.chunk + j] = bv0;
      sm[kBv1 * p.chunk + j] = bv1;
      sm[kBv2 * p.chunk + j] = bv2;
      sm[kR * p.chunk + j] = r[9];
      sm[kG * p.chunk + j] = r[10];
      sm[kB * p.chunk + j] = r[11];
      sm[kOp * p.chunk + j] = r[12];
    }
    __syncthreads();

    if (T >= p.t_min) {
      for (int j = 0; j < m; ++j) {
        const float op = sm[kOp * p.chunk + j];
        if (!(op > 0.0f)) continue;
        const float n0 = sm[kN0 * p.chunk + j];
        const float n1 = sm[kN1 * p.chunk + j];
        const float n2 = sm[kN2 * p.chunk + j];
        const float nd = n0 * dx + n1 * dy + n2;
        const bool nd_ok = fabsf(nd) >= 1e-8f;
        const float tt = sm[kNc * p.chunk + j] / (nd_ok ? nd : 1e-8f);
        const float dau = sm[kAu0 * p.chunk + j] * dx + sm[kAu1 * p.chunk + j] * dy
                          + sm[kAu2 * p.chunk + j];
        const float dbv = sm[kBv0 * p.chunk + j] * dx + sm[kBv1 * p.chunk + j] * dy
                          + sm[kBv2 * p.chunk + j];
        const float u = tt * dau - sm[kCau * p.chunk + j];
        const float v = tt * dbv - sm[kCbv * p.chunk + j];
        const float rho3d = nd_ok ? u * u + v * v : CUDART_INF_F;
        const float ex = px - sm[kC2x * p.chunk + j];
        const float ey = py - sm[kC2y * p.chunk + j];
        const float rho2d = p.filter2d_invsq * (ex * ex + ey * ey);
        const bool use3d = rho3d <= rho2d;
        const float rho = use3d ? rho3d : rho2d;
        const float depth = use3d ? tt : sm[kCz * p.chunk + j];
        const float alpha = fminf(0.99f, op * expf(-0.5f * rho));
        if (!(alpha >= p.alpha_min && depth >= p.near_cull)) continue;

        const float t_next = T * (1.0f - alpha);
        if (t_next < p.t_min) {  // this pixel is saturated: stop it here
          T = t_next;
          break;
        }
        const float w = alpha * T;
        acc_r += w * sm[kR * p.chunk + j];
        acc_g += w * sm[kG * p.chunk + j];
        acc_b += w * sm[kB * p.chunk + j];
        dsum += w * depth;
        nx += w * n0;
        ny += w * n1;
        nz += w * n2;
        const float md = nrm_c * (1.0f - p.dist_near / fmaxf(depth, 1e-6f));
        dist += w * (md * md * acc_a + m2 - 2.0f * md * m1);
        acc_a += w;
        m1 += w * md;
        m2 += w * md * md;
        if (T > 0.5f) med = depth;
        T = t_next;
      }
    }
    // barrier before the next chunk overwrites shared memory; the tile is
    // done once no pixel has transmittance left
    if (__syncthreads_count(T >= p.t_min) == 0) break;
  }
  if (stash != nullptr) {
    stash_carry(ci);
    if (pid == 0) ndone[t] = ci;
  }

  float* o = out + (size_t)t * kNumChannels * npix + pid;
  o[0 * npix] = acc_r;
  o[1 * npix] = acc_g;
  o[2 * npix] = acc_b;
  o[3 * npix] = acc_a;
  o[4 * npix] = dsum;
  o[5 * npix] = med;
  o[6 * npix] = nx;
  o[7 * npix] = ny;
  o[8 * npix] = nz;
  o[9 * npix] = dist;
}

}  // namespace

// `stash` and `ndone` may be null (no stash); otherwise stash is f32
// [num_tiles, budget/chunk + 1, 4, tile*tile] and ndone int32 [num_tiles].
extern "C" int lara_blend_fwd(const float* entries, const int* counts,
                              const float* scalars, float* out, float* stash,
                              int* ndone, int num_tiles,
                              int tiles_x, int tile, int width, int height,
                              int budget, int chunk, float alpha_min,
                              float t_min, float near_cull, float dist_near,
                              float dist_far, float filter2d_invsq,
                              void* stream) {
  Params p{tiles_x, tile, width, height, budget, chunk,
           alpha_min, t_min, near_cull, dist_near, dist_far, filter2d_invsq};
  const size_t smem = sizeof(float) * kNumFields * chunk;
  blend_fwd_kernel<<<num_tiles, tile * tile, smem,
                     static_cast<cudaStream_t>(stream)>>>(entries, counts,
                                                          scalars, out, stash,
                                                          ndone, p);
  return static_cast<int>(cudaGetLastError());
}
