// What the flash-attention kernels (flash_fwd.cu, flash_bwd.cu) share: the
// problem description, the masked logit, the f32 kernels' staging, and the
// Hopper machinery of the bf16 kernels: TMA tensor maps, mbarriers and
// wgmma on 128-byte-swizzled shared-memory tiles.
//
// Layout. q, k, v are [B, L, H, hd] (the JAX package's attention layout)
// with the head at stride hd and the dimension at stride 1; the batch and
// sequence strides are given, so the q/k/v views of a fused qkv projection
// are read in place. o, dO, dq, dk and dv are contiguous [B, L, H, hd]; the
// row log-sum-exp and D = rowsum(dO o) are f32 [B*H, Lq]. The sequences are
// not padded in memory: a tile's rows past L read as zeros.
//
// Why padded rows cannot change a real row. A key row past Lk gets the
// logit -inf, so its probability is exactly 0 for every query: it adds
// nothing to the row sum or to O, and its gradients are never written. A
// query row past Lq is computed from zeros, never written, and its
// probabilities are set to 0 in the backward, so it adds nothing to dK and
// dV. Every real row's softmax runs over the real keys alone; a masked key
// (kv_mask false) takes the logit -1e9, as the plain version does, and gets
// no gradient through the logit.
//
// bf16 tiles. TMA copies a tile of `rows` rows of one head into shared
// memory as 64-column panels: each panel row is 64 bf16 = 128 bytes, one
// CU_TENSOR_MAP_SWIZZLE_128B atom, the layout wgmma reads. The tensor map
// declares the head dimension as hd, so TMA fills columns hd..63 (or
// hd..127) with zeros, as it does rows past L: every bf16 head_dim up to 128
// runs through one kernel padded to HDP = 64 or 128 columns. A padding
// column adds 0 to every dot product, and its outputs are never stored. The
// fused-qkv view's row stride (3 * 768 bf16 = 4,608 bytes) is a multiple of
// 16 bytes, so TMA reads the view in place.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the driver is reached through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace flash {

constexpr int kMaxHd = 128;
constexpr int kPanel = 64;             // bf16 columns of one 128-byte swizzle row
constexpr int kPanelBytes = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// the masked logit -1e9 in the kernels' base-2 units (logit * log2(e))
constexpr float kMasked2 = -1e9f * kLog2e;

struct Problem {
  const void* q;
  const void* k;
  const void* v;
  const unsigned char* kv_mask;  // [B, Lk], 0 = key excluded; may be null
  int B, H, Lq, Lk, hd;
  long long q_sb, q_sl, k_sb, k_sl, v_sb, v_sl;  // element strides
  float scale;
};

// The logit of key j for a query of sequence b, from the scaled-by-nothing
// dot product: -inf past Lk, -1e9 where kv_mask excludes the key.
__device__ __forceinline__ float logit(const Problem& p, int b, int j, float dot) {
  if (j >= p.Lk) return -CUDART_INF_F;
  if (p.kv_mask != nullptr && p.kv_mask[(size_t)b * p.Lk + j] == 0) return -1e9f;
  return dot * p.scale;
}

// Whether key j of sequence b takes a gradient through its logit.
__device__ __forceinline__ bool key_live(const Problem& p, int b, int j) {
  return j < p.Lk && (p.kv_mask == nullptr || p.kv_mask[(size_t)b * p.Lk + j] != 0);
}

// Rows r0 .. r0 + rows - 1 of head h of sequence b of an f32 [B, L, H, hd]
// tensor into dst [rows][ld]; rows past L are zero.
__device__ __forceinline__ void stage_rows_f32(float* dst, int ld, const float* base,
                                               long long sb, long long sl, int b,
                                               int h, int hd, int r0, int rows, int L) {
  for (int idx = threadIdx.x; idx < rows * hd; idx += blockDim.x) {
    const int r = idx / hd, c = idx % hd;
    dst[r * ld + c] = r0 + r < L ? base[b * sb + (long long)(r0 + r) * sl
                                        + (long long)h * hd + c] : 0.0f;
  }
}

// ---------------------------------------------------------------- host side

// cuTensorMapEncodeTiled, reached through the runtime so that nothing links
// against libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// The tensor map of a bf16 [B, L, H, hd] tensor with element strides sb, sl
// (head at stride hd, dimension at stride 1): boxes of 64 columns by `rows`
// rows of one head, 128-byte swizzle, zeros outside the tensor. Returns a
// cudaError_t code.
inline int make_map(CUtensorMap* map, const void* base, int B, int L, int H, int hd,
                    long long sb, long long sl, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)sl * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kPanel, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                        dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Set a kernel's dynamic shared memory and launch it on stream s.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t s,
           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// -------------------------------------------------------------- device side

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// The dynamic shared memory rounded up to 1,024 bytes, the 128-byte
// swizzle's period (a kernel asks for 1,024 bytes more than it uses).
__device__ __forceinline__ unsigned char* smem_base(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + (((a + 1023u) & ~1023u) - a);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One arrival that also expects `bytes` of TMA traffic on this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed. The
// polling loop lives inside the asm block, so the compiler sees no
// data-dependent branch around the wgmma that follow (it would serialise
// them); a wait of the kernels ends in microseconds, so a lost arrival or
// transaction count traps after 2^26 polls instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      " .reg .pred p;\n"
      " .reg .u32 n;\n"
      " mov.u32 n, 0;\n"
      "LAB_WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @p bra LAB_DONE;\n"
      " add.u32 n, n, 1;\n"
      " setp.lt.u32 p, n, %2;\n"
      " @p bra LAB_WAIT;\n"
      " trap;\n"
      "LAB_DONE:\n"
      "}\n"
      :: "r"(smem_u32(bar)), "r"(parity), "n"(1 << 26) : "memory");
}

// TMA: the box at (column c0, head h, row r, sequence b) of `map` into dst,
// completing `bytes` of transaction on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int h, int r, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(h), "r"(r), "r"(b)
      : "memory");
}

// The `rows` rows from r of head h of sequence b as HDP / 64 panels of
// rows x 128 bytes at dst.
template <int HDP>
__device__ __forceinline__ void tma_tile(unsigned char* dst, const CUtensorMap* map,
                                         uint64_t* bar, int rows, int h, int r, int b) {
#pragma unroll
  for (int panel = 0; panel < HDP / kPanel; ++panel)
    tma_load(dst + panel * rows * kPanelBytes, map, bar, panel * kPanel, h, r, b);
}

// A wgmma shared-memory descriptor of a 128-byte-swizzled tile (layout type
// 1): start address, leading and stride byte offsets, in 16-byte units.
//  - K-major operand (rows of the M or N dimension, 64 K-columns per panel):
//    stride offset 1,024 (8 rows of 128 bytes); the k16 slice kk starts
//    32 * (kk % 4) bytes into panel kk / 4; the leading offset is unused.
//  - MN-major operand (rows of the K dimension, 64 N-columns per panel, the
//    transpose bit set): stride offset 1,024 (8 K-rows), leading offset the
//    panel stride (the next 64 N-columns); the k16 slice t starts at row 16 t.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lead_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lead_bytes >> 4) << 16)
         | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// K-major operand stored as panels of `rows` rows: slice kk.
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int rows, int kk) {
  return desc(tile + (kk / 4) * rows * kPanelBytes + (kk % 4) * 32, 16);
}

// MN-major operand: rows of K, panels of `rows` rows: slice t (rows 16t..).
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int rows, int t) {
  return desc(tile + t * 16 * kPanelBytes, rows * kPanelBytes);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most N committed wgmma groups are pending (groups complete
// in commit order).
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// Warp specialisation: the producer warpgroup gives its registers to the
// two consumer warpgroups (a 384-thread CTA starts at 168 per thread;
// 128 x 40 + 256 x 232 = 64,512 of the SM's 65,536).
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
}

// The warp's index, provably the same in every lane (a broadcast), so that
// branches on it are uniform to the compiler: wgmma in a branch it cannot
// prove uniform are serialised, and setmaxnreg is not applied per role.
__device__ __forceinline__ int warp_index() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 32, 0);
}

// 2^x on the special-function unit (one MUFU.EX2; 2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Keep the compiler from touching an accumulator across a wgmma wait.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define FLASH_D4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define FLASH_D16(d, i) FLASH_D4(d, i), FLASH_D4(d, i + 4), FLASH_D4(d, i + 8), FLASH_D4(d, i + 12)

// D [64 x N] (+)= A [64 x 16] B [16 x N], A and B K-major in shared memory.
template <int N> struct SS;

template <> struct SS<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : FLASH_D16(d, 0)
        : "l"(a), "l"(b), "r"(acc));
  }
};

template <> struct SS<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : FLASH_D16(d, 0), FLASH_D16(d, 16)
        : "l"(a), "l"(b), "r"(acc));
  }
};

// D [64 x N] += A [64 x 16] B [16 x N], A in registers (four bf16x2 per
// thread, the accumulator layout of a k16 slice), B MN-major in shared
// memory (the transpose bit).
template <int N> struct RS;

template <> struct RS<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : FLASH_D16(d, 0), FLASH_D16(d, 16)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <> struct RS<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : FLASH_D16(d, 0), FLASH_D16(d, 16), FLASH_D16(d, 32), FLASH_D16(d, 48)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

#undef FLASH_D16
#undef FLASH_D4

// Two f32 as one bf16x2 register, the lower column in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A operand of k16 slice t from an f32 accumulator of a [64 x N]
// product: its columns 16t .. 16t + 15 are registers 8t .. 8t + 7, in the
// order of the A fragment, so no value moves between threads.
template <int N>
__device__ __forceinline__ void acc_to_a(const float (&d)[N], uint32_t (&a)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) a[i] = pack_bf16(d[2 * i], d[2 * i + 1]);
}

// Accumulator layout of a [64 x N] wgmma product: warp w of the warpgroup
// holds rows 16w .. 16w + 15; lane l holds row 16w + l/4 (registers 4i, 4i+1)
// and row 16w + l/4 + 8 (4i + 2, 4i + 3) at columns 8i + 2 (l % 4) + {0, 1}.
__device__ __forceinline__ int acc_col(int i, int e, int lane) { return 8 * i + 2 * (lane & 3) + e; }

// Store rows r_lo and r_lo + 8 of a [64 x HDP] accumulator times `scale` as
// bf16 into the contiguous [B, L, H, hd] tensor dst, columns below hd, rows
// below L.
template <int HDP>
__device__ __forceinline__ void store_rows(const float (&d)[HDP / 2], float scale_lo,
                                           float scale_hi, __nv_bfloat16* dst, int b, int h,
                                           int H, int L, int hd, int r_lo, int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r_lo + 8 * half;
    if (r >= L) continue;
    const float sc = half ? scale_hi : scale_lo;
    __nv_bfloat16* row = dst + ((size_t)(b * L + r) * H + h) * hd;
#pragma unroll
    for (int i = 0; i < HDP / 8; ++i) {
      const int c = acc_col(i, 0, lane);
      if (c < hd)
        *reinterpret_cast<__nv_bfloat162*>(row + c) =
            __floats2bfloat162_rn(d[4 * i + 2 * half] * sc, d[4 * i + 2 * half + 1] * sc);
    }
  }
}

}  // namespace flash
