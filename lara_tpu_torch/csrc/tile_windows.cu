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
// M read the sentinel. The padded array is never built: a thread that falls
// past M writes INT32_MAX itself.
//
// What bounds it on this card. It is a pure copy: T*K int32 written, at most
// T*K read (fewer where windows overlap) and T starts. At the train config
// (T = 1024, K = 128) that is about 1 MB, 0.3 us at 3.35 TB/s, and at the
// eval config (K = 512) about 4 MB: a launch costs more than the bytes.
//
// What the design does about it: one flat pass over the [T, K] output, one
// element per thread, 256 threads per block, any T and K (the TPU grid's
// T % 8 == 0 is a layout rule of the TPU). Neighbouring threads write
// neighbouring words of the output and read neighbouring words of the keys
// inside a window, so both sides coalesce; starts[t] is one broadcast load
// per warp and tile. Nothing is staged: each word is read once.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void tile_windows_kernel(const int* __restrict__ keys, int m,
                                    const int* __restrict__ starts,
                                    long long total, int k,
                                    int* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const long long t = i / k;
  const long long pos = static_cast<long long>(starts[t]) + (i - t * k);
  out[i] = (pos >= 0 && pos < m) ? keys[pos] : INT_MAX;
}

}  // namespace

// keys int32 [m], starts int32 [num_tiles], out int32 [num_tiles, k];
// num_tiles * k > 0. Returns the launch's cudaError_t.
extern "C" int lara_tile_windows(const int* keys, int m, const int* starts,
                                 int num_tiles, int k, int* out,
                                 void* stream) {
  const long long total = static_cast<long long>(num_tiles) * k;
  const long long blocks = (total + kThreads - 1) / kThreads;
  tile_windows_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(keys, m, starts,
                                                             total, k, out);
  return static_cast<int>(cudaGetLastError());
}
