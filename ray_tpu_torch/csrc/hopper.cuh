// Hopper (sm_90a) building blocks shared by the flash-attention kernels
// that run on wgmma: mbarriers, TMA tile loads, wgmma shared-memory
// descriptors and the m64n64k16 products, register fences, and the host
// side that encodes a TMA tensor map over a strided [B, T, H, D] tensor.
//
// Tile convention. Every 16-bit tile in shared memory is kRows = 64 rows
// of the head_dim axis, stored as D / 64 "atoms" of 64 rows x 64 columns
// (128 bytes a row, rows back to back, 8 KB an atom), each atom
// 1024-byte aligned and 128-byte swizzled: the 16-byte chunk c of row r
// sits at chunk c ^ (r % 8).
// That is the layout a TMA load with CU_TENSOR_MAP_SWIZZLE_128B and a box
// of 64 columns writes, and the one a wgmma descriptor with 128-byte
// swizzling reads, both K-major (rows are the M or N index, head_dim the
// reduction) and MN-major (rows are the reduction index).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace hopper {

constexpr int kRows = 64;    // rows of every tile: wgmma's M, the keys of a K/V tile
constexpr int kAtom = kRows * 128;  // bytes of one 64-column atom of a tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces ``bytes`` of TMA traffic to come.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits for the phase of parity ``parity`` to complete. A copy that never
// lands would hang the card; after ~2^33 cycles (seconds) the kernel traps
// instead, and the launch reports an error.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > (1LL << 33)) __trap();
  }
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// A box of the 4-D map (coordinates innermost first: column, head,
// position, batch) into shared memory at ``dst``, completing on ``bar``.
// Positions past the tensor's end are filled with zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Rows [row0, row0 + 64) of head ``h`` of batch ``b``: every 64-column
// atom of the tile, one box each.
template <int D>
__device__ __forceinline__ void tma_load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                              int b, int h, int row0) {
#pragma unroll
  for (int atom = 0; atom < D / 64; ++atom)
    tma_load_4d(dst + atom * kAtom, map, bar, atom * 64, h, row0, b);
}

// 2^x as one ex2.approx.ftz (2 ulp, like exp2f): a result below 2^-126
// becomes 0 instead of a denormal, which changes no sum by more than
// 1e-38, and the softmax saves the instructions exp2f spends on
// denormals for every score.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor with 128-byte swizzling: start address,
// leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// K-major operand: reduction step ``kk`` (16 head_dim columns) of a tile.
// Within an atom a step moves 32 bytes along the row; the hardware
// applies the swizzle to the address. 8-row groups lie 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int kk) {
  return desc_sw128(tile + (kk / 4) * kAtom + (kk % 4) * 32, 16, 1024);
}

// MN-major operand: reduction step ``kk`` (rows 16 kk .. 16 kk + 15) of
// the 64 columns of atom ``atom`` of a tile. Two 8-row groups, 1024
// bytes apart. An instruction reads 64 columns, one atom, so the stride
// between atoms never enters: both offsets are set to 1024.
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int atom, int kk) {
  return desc_sw128(tile + atom * kAtom + kk * 16 * 128, 1024, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N of the committed wgmma groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Register fences: the compiler may not read an accumulator, or reuse the
// registers of an A fragment, between an asynchronous wgmma and the wait
// that completes it. A fence after the wait ties both to the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define HOPPER_D32                                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define HOPPER_ACC32(d)                                                                   \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),    \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),          \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),       \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])

// The m64n64k16 products with f32 accumulation, by 16-bit input type.
// d (32 floats a thread) is the 64 x 64 accumulator: thread (warp w, lane
// 4 g + t) holds rows 16 w + g (+ 8 for index bit 1) and columns
// 8 (i / 4) + 2 t + (i % 2).
//   ss: A (K-major) and B (K-major) from shared memory;
//   rs: A from registers (4 x 2 values a thread, the layout of d's 16
//       columns), B MN-major from shared memory.
// scale_d = 0 overwrites d, 1 accumulates into it.
template <typename T>
struct Wgmma;

#define HOPPER_WGMMA(TYPE, PTX_TYPE)                                                         \
  template <>                                                                                \
  struct Wgmma<TYPE> {                                                                       \
    static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da, uint64_t db,      \
                                              int scale_d) {                                 \
      asm volatile(                                                                          \
          "{\n"                                                                              \
          ".reg .pred p;\n"                                                                  \
          "setp.ne.b32 p, %34, 0;\n"                                                         \
          "wgmma.mma_async.sync.aligned.m64n64k16.f32." PTX_TYPE "." PTX_TYPE " " HOPPER_D32 \
          ", %32, %33, p, 1, 1, 0, 0;\n"                                                     \
          "}\n"                                                                              \
          : HOPPER_ACC32(d)                                                                  \
          : "l"(da), "l"(db), "r"(scale_d));                                                 \
    }                                                                                        \
    static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t* a, uint64_t db, \
                                              int scale_d) {                                 \
      asm volatile(                                                                          \
          "{\n"                                                                              \
          ".reg .pred p;\n"                                                                  \
          "setp.ne.b32 p, %37, 0;\n"                                                         \
          "wgmma.mma_async.sync.aligned.m64n64k16.f32." PTX_TYPE "." PTX_TYPE " " HOPPER_D32 \
          ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"                                       \
          "}\n"                                                                              \
          : HOPPER_ACC32(d)                                                                  \
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));              \
    }                                                                                        \
  };

HOPPER_WGMMA(__nv_bfloat16, "bf16")
HOPPER_WGMMA(__half, "f16")

#undef HOPPER_WGMMA
#undef HOPPER_ACC32
#undef HOPPER_D32

// Two floats rounded to T and packed into one 32-bit register, ``lo`` in
// the low half (the lower column).
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The f32 accumulator of a 64 x 64 product (registers of one thread, as
// Wgmma lays them out) as the A fragments of the next product, rounded to
// T: step kk (columns 16 kk .. 16 kk + 15) is a[4 kk .. 4 kk + 3].
template <typename T>
__device__ __forceinline__ void acc_to_a(const float (&d)[32], uint32_t (&a)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) a[i] = pack2<T>(d[2 * i], d[2 * i + 1]);
}

// A warpgroup's 64 x D tile of f32 accumulators (this thread's
// ``acc[atom]`` holds columns 64 atom .. 64 atom + 63 of its two rows),
// scaled by 1 / div per row half, out to rows [row0, min(row0 + 64,
// t_end)) of ``g`` (row stride ``st`` elements, contiguous columns,
// 16-byte aligned rows) in T with 16-byte stores. The tile is staged in
// ``stage``, a free 64 x D tile of shared memory in the swizzled layout
// (which keeps both passes free of bank conflicts). Every thread of the
// block (one warpgroup) must call it.
template <typename T, int D>
__device__ __forceinline__ void store_tile(const float (&acc)[D / 64][32], const float (&div)[2],
                                           unsigned char* stage, T* g, long long st, int row0,
                                           int t_end) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g8 = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int atom = 0; atom < D / 64; ++atom) {
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int half = (i >> 1) & 1, chunk = i >> 2;
      const int r = 16 * warp + g8 + 8 * half;
      const int off = atom * kAtom + r * 128 + ((chunk ^ (r & 7)) << 4) + 4 * t4;
      *reinterpret_cast<uint32_t*>(stage + off) =
          pack2<T>(acc[atom][i] / div[half], acc[atom][i + 1] / div[half]);
    }
  }
  __syncthreads();
  constexpr int kChunks = D / 8;  // 16-byte chunks in a row
  for (int idx = threadIdx.x; idx < kRows * kChunks; idx += blockDim.x) {
    const int r = idx / kChunks, c = idx % kChunks;
    if (row0 + r >= t_end) continue;
    const int off = (c / 8) * kAtom + r * 128 + (((c % 8) ^ (r & 7)) << 4);
    *reinterpret_cast<uint4*>(g + (row0 + r) * st + c * 8) =
        *reinterpret_cast<const uint4*>(stage + off);
  }
}

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime so
// that the library needs no -lcuda.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 13000
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    return err == cudaSuccess && status == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 4-D map over one [B, T, H, D] tensor of 16-bit values (dtype 1 fp16,
// 2 bf16) read through its strides in elements (sb, st, sh; head_dim
// contiguous): dims (D, H, T, B), boxes of 64 columns x 64 positions of
// one (batch, head), 128-byte swizzled, zeros past T. TMA needs a
// 16-byte aligned base and strides that are multiples of 16 bytes
// (ops/_kernels.py:tma_aligned).
inline cudaError_t make_map(CUtensorMap* map, const void* base, int dtype, int batch, int seq,
                            int heads, int head_dim, long long sb, long long st, long long sh) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(head_dim), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2, static_cast<cuuint64_t>(st) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, kRows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
      const_cast<void*>(base), dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
