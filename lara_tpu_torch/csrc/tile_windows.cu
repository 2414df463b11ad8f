// Tile-window extraction: the Hopper kernel behind
// lara_tpu_torch/ops/rasterizer/cuda_windows.py:tile_windows.
//
// Replaces the TPU kernel of tools/profile_binning.py (`win_kernel`,
// launched by `win_pallas`): a scalar-prefetch copy over a grid of 8-tile
// blocks with the whole padded key array in ANY memory.
//
// What it computes. The binning's sorted slot keys `keys [M]` (int32) and
// each tile's first sorted position `starts [T]` (0 <= starts[t] <= M) give
// the [T, K] window of tile t: out[t, k] = padded[starts[t] + k], where
// `padded` is `keys` followed by K sentinels INT32_MAX. Positions at or past
// M read the sentinel. The padded array is never built: a lane that falls
// past M writes INT32_MAX itself.
//
// What bounds it on this card. It is a pure copy: T*K int32 written, at most
// T*K read (fewer where windows overlap) and T starts. At the train config
// (T = 1024, K = 128) that is about 1 MB, 0.3 us at 3.35 TB/s, and at the
// eval config (K = 512) about 4 MB: a launch costs more than the bytes, so
// the kernel is held to the time of a launch that does nothing.
//
// What the design does about it: one warp per segment of a tile window (128
// words, or 32 where K % 4 != 0), the segments on the grid's second axis
// and the tiles in a tile-stride loop over at most kWaves waves of full SMs,
// so a long window (K 512: four segments) is cut by four warps at once and
// no index is divided. Lane 0 loads starts[t] and broadcasts it
// (__shfl_sync). Where K % 4 == 0 (and the output is 16-byte aligned) each
// lane reads four consecutive key words (scalar loads: the start is not
// aligned; the warp's loads still cover 128 consecutive words) and writes
// them as one 16-byte store, so a warp writes 512 contiguous bytes; other K
// take one word per lane. Each word is read once and nothing is staged.
// One warp per whole window (four 16-byte stores per lane at K 512) left
// the K 512 call twice as far above the floor as the K 128 one (H100).

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // tile windows in flight per block
constexpr int kWaves = 4;              // grid at most this many full waves of blocks

// 32-bit positions: start <= M < 2^31 and j < K < 2^31, so start + j < 2^32.
__device__ __forceinline__ int key_at(const int* __restrict__ keys, unsigned m, unsigned pos) {
  return pos < m ? keys[pos] : INT_MAX;
}

// Words of a window one warp takes: four per lane, or one.
template <bool kVec4>
constexpr int kSegment = kVec4 ? 4 * 32 : 32;

template <bool kVec4>
__global__ void __launch_bounds__(kThreads) tile_windows_kernel(
    const int* __restrict__ keys, int m, const int* __restrict__ starts, int num_tiles, int k,
    int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  for (int t = blockIdx.x * kWarps + (threadIdx.x >> 5); t < num_tiles;
       t += gridDim.x * kWarps) {
    int start = 0;
    if (lane == 0) start = starts[t];
    start = __shfl_sync(0xffffffffu, start, 0);
    int* row = out + static_cast<size_t>(t) * k;
    for (int j0 = blockIdx.y * kSegment<kVec4>; j0 < k; j0 += gridDim.y * kSegment<kVec4>) {
      if constexpr (kVec4) {
        const int j = j0 + 4 * lane;
        if (j < k) {
          const unsigned pos = static_cast<unsigned>(start) + j;
          *reinterpret_cast<int4*>(row + j) =
              make_int4(key_at(keys, m, pos), key_at(keys, m, pos + 1),
                        key_at(keys, m, pos + 2), key_at(keys, m, pos + 3));
        }
      } else {
        const int j = j0 + lane;
        if (j < k) row[j] = key_at(keys, m, static_cast<unsigned>(start) + j);
      }
    }
  }
}

}  // namespace

// keys int32 [m], starts int32 [num_tiles], out int32 [num_tiles, k];
// num_tiles * k > 0. Returns the launch's cudaError_t.
extern "C" int lara_tile_windows(const int* keys, int m, const int* starts,
                                 int num_tiles, int k, int* out,
                                 void* stream) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxThreadsPerMultiProcessor, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec4 = k % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int segment = vec4 ? kSegment<true> : kSegment<false>;
  const long long segments = (static_cast<long long>(k) + segment - 1) / segment;
  const long long most = static_cast<long long>(kWaves) * sms * (per_sm / kThreads);
  const dim3 grid(static_cast<unsigned>(std::max(1LL, std::min(
                      (static_cast<long long>(num_tiles) + kWarps - 1) / kWarps,
                      most / std::min(segments, most)))),
                  static_cast<unsigned>(std::min(segments, 65535LL)));
  auto s = static_cast<cudaStream_t>(stream);
  if (vec4)
    tile_windows_kernel<true><<<grid, kThreads, 0, s>>>(keys, m, starts, num_tiles, k, out);
  else
    tile_windows_kernel<false><<<grid, kThreads, 0, s>>>(keys, m, starts, num_tiles, k, out);
  return static_cast<int>(cudaGetLastError());
}
