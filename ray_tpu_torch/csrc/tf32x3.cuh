// 3xTF32 building blocks shared by the fp32 flash-attention kernels for
// Hopper (sm_90a): the forward (flash_fwd.cu) and the backward passes
// (flash_bwd.cu). Each fp32 product runs on the tensor cores as three
// mma.sync.m16n8k8 TF32 products of the operands' hi and lo parts.
//
// The split. Every fp32 value x is split once into hi = tf32(x) and
// lo = tf32(x - hi) (cvt.rna: nearest, ties away), and every product a.b
// is taken as hi_a.lo_b + lo_a.hi_b + hi_a.hi_b into fresh f32
// accumulators, the small terms first. What this drops (lo.lo and the
// rounding of each lo) is about 2^-22 of |a.b|, the order of fp32's own
// rounding over a 64-term sum. The tensor cores' f32 accumulation
// truncates, each product at an ulp of the sum it adds to, so the products
// of every kChain = 2 steps of 8 start from zero, the four small ones
// first, then the two large ones, and the chain is added to the running
// sum with an f32 add, which rounds to nearest.
//
// The tiling (Tiling<kOuter, kSplit>). A block of kWarps = 8 warps owns
// kOuter rows of its own tile (q for the forward and the dQ pass; k, v for
// the dK/dV pass), 16 rows a group of kSplit warps; each warp of a group
// takes 1/kSplit of every inner tile and sums its own part in registers.
// The backward passes and the forward at head_dim 128 take 64 rows, warps
// w and w + 4 sharing 16; the forward at head_dim 64 takes 128 rows, one
// warp each 16.
//
// The layout. A tile of R rows lands by TMA as D / 32 atoms of R rows x 32
// floats (128 bytes a row), the 16-byte chunk c of row r at c ^ (r % 8)
// (the 128-byte swizzle), raw in its hi plane; split_tile turns it into
// hi in place and writes lo into the plane after it. The products read
// tiles along rows (ldmatrix.x4, which hands each thread word t of row g,
// the TF32 fragment pattern) and along columns (scalar loads of rows 2t
// and 2t+1, column g); the XOR swizzle keeps both free of bank conflicts.
// An accumulator block (rows g, g+8 x columns 2t, 2t+1) is the A fragment
// of the next product as it lies: its column t stands for column 2t and
// t+4 for 2t+1, so the B rows are read in that order.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace tf32x3 {

constexpr int kWarps = 8;  // a block of every 3xTF32 kernel
constexpr int kThreads = kWarps * 32;
constexpr int kChain = 2;  // 8-deep steps whose products share fresh accumulators

// kOuter rows of a block's own tile; kSplit warps share each 16 of them,
// each taking 1/kSplit of every inner tile.
template <int kOuterRows, int kSplitWarps>
struct Tiling {
  static constexpr int kOuter = kOuterRows;
  static constexpr int kSplit = kSplitWarps;
  static constexpr int kGroupBits = kOuter == 128 ? 3 : 2;
  static constexpr int kGroups = 1 << kGroupBits;  // warps owning distinct rows
  static_assert(16 * kGroups == kOuter && kGroups * kSplit == kWarps,
                "a tiling takes every warp of the block");
};

// ---------------------------------------------------------------------------
// 3xTF32
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + (at most ~2^-22 |x|), both TF32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d (+)= a.b, one m16n8k8 TF32 product: a rows g, g+8 x columns t, t+4;
// b rows (k) t, t+4 x column (n) g; d rows g, g+8 x columns 2t, 2t+1.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_zero(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f), "f"(0.f),
        "f"(0.f), "f"(0.f));
}

// acc (=)+= a.b over C 8-deep steps in 3xTF32: every small product
// (hi.lo, lo.hi) first, then the large ones (hi.hi), into fresh
// accumulators, then one f32 add each. A chain of tensor-core
// accumulations that truncates loses up to an ulp of the running sum at
// every product; here only the C large products lose that much, of the
// chain's own sum, and the running sum rounds to nearest. B fragments:
// words n, n + 1 of b_hi[j], b_lo[j] (one 8-column block).
template <int C>
__device__ __forceinline__ void mma3(float (&acc)[4], bool first, const uint32_t (&a_hi)[C][4],
                                     const uint32_t (&a_lo)[C][4], const uint32_t (&b_hi)[C][4],
                                     const uint32_t (&b_lo)[C][4], int n) {
  float d[4];
  mma_zero(d, a_hi[0], b_lo[0][n], b_lo[0][n + 1]);
  mma(d, a_lo[0], b_hi[0][n], b_hi[0][n + 1]);
#pragma unroll
  for (int j = 1; j < C; ++j) {
    mma(d, a_hi[j], b_lo[j][n], b_lo[j][n + 1]);
    mma(d, a_lo[j], b_hi[j][n], b_hi[j][n + 1]);
  }
#pragma unroll
  for (int j = 0; j < C; ++j) mma(d, a_hi[j], b_hi[j][n], b_hi[j][n + 1]);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = first ? d[i] : acc[i] + d[i];
}

// The A fragment of an accumulator block (rows g, g+8 x columns 2t, 2t+1),
// split: column t of the fragment is column 2t, column t+4 is 2t+1.
__device__ __forceinline__ void acc_to_a(const float (&c)[4], uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  split(c[0], hi[0], lo[0]);
  split(c[2], hi[1], lo[1]);
  split(c[1], hi[2], lo[2]);
  split(c[3], hi[3], lo[3]);
}

// ---------------------------------------------------------------------------
// Shared memory
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[4], uint32_t addr) {  // into r[0], r[1]
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t lds(uint32_t addr) {
  uint32_t r;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(r) : "r"(addr));
  return r;
}

// Orders this thread's generic-proxy writes to shared memory (the split)
// before the TMA loads that later overwrite the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of 8-column step ``step`` in a tile of R rows for a lane
// whose offset at step 0 is ``lane_off``: the step moves by atoms of 32
// columns and, within an atom, XORs chunk pairs (c ^ (r % 8) is linear in
// c's XOR).
template <int R>
__device__ __forceinline__ uint32_t step_off(uint32_t lane_off, int step) {
  return (step >> 2) * (R * 128) + (lane_off ^ ((step & 3) << 5));
}

// Rows [row0, row0 + R) of head h of batch b: one TMA box per 32-column atom.
template <int D, int R>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int b, int h, int row0) {
#pragma unroll
  for (int atom = 0; atom < D / 32; ++atom)
    hopper::tma_load_4d(dst + atom * R * 128, map, bar, atom * 32, h, row0, b);
}

// The raw tile in the kPlane bytes at ``hi`` becomes its hi part, and its
// lo part goes to the plane after it; each thread takes every kThreads-th
// 16-byte chunk (same offsets in both planes: the layout is kept).
template <int kPlane>
__device__ __forceinline__ void split_tile(unsigned char* hi) {
#pragma unroll 4
  for (int i = threadIdx.x * 16; i < kPlane; i += kThreads * 16) {
    const float4 x = *reinterpret_cast<const float4*>(hi + i);
    uint4 h, l;
    split(x.x, h.x, l.x);
    split(x.y, h.y, l.y);
    split(x.z, h.z, l.z);
    split(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + i) = h;
    *reinterpret_cast<uint4*>(hi + kPlane + i) = l;
  }
}

// Per-lane offsets of the fragment loads under tiling T, at step 0:
//  a: ldmatrix.x4 of the A fragment of the warp's 16 rows of an own tile
//     (matrices: rows 0-7 / 8-15 x words 0-3 / 4-7);
//  b: ldmatrix.x4 (.x2: lanes 0-15) of the B fragments of two 8-row
//     blocks of a tile (block 0 words 0-3 / 4-7, block 1 words 0-3 / 4-7);
//  col[e]: the scalar B load of row 2t + e, column g of an 8 x 8 block.
template <class T>
struct LaneOffsets {
  uint32_t a, b, col[2];
  __device__ __forceinline__ LaneOffsets(int warp, int lane) {
    const int g = lane >> 2, t = lane & 3, r8 = lane & 7;
    a = (16 * (warp & (T::kGroups - 1)) + r8 + 8 * ((lane >> 3) & 1)) * 128 +
        (((lane >> 4) ^ r8) << 4);
    b = (r8 + 8 * (lane >> 4)) * 128 + ((((lane >> 3) & 1) ^ r8) << 4);
#pragma unroll
    for (int e = 0; e < 2; ++e)
      col[e] = (2 * t + e) * 128 + (((g >> 2) ^ (2 * t + e)) << 4) + ((g & 3) << 2);
  }
};

// s[nb] = X . Y^T over D for the warp's 16 rows of an own tile X (at
// ``x``) and the warp's R / kSplit rows of an inner tile of R rows (at
// ``y``), both read along rows; each as hi and lo planes kXPlane /
// kYPlane apart. ``kRolled`` keeps the loop over the chains rolled (fewer
// registers; the forward's), else it is unrolled.
template <int D, int R, int kXPlane, int kYPlane, bool kRolled = false, class T>
__device__ __forceinline__ void product_rows(float (&s)[R / 8 / T::kSplit][4], uint32_t x,
                                             uint32_t y, const LaneOffsets<T>& off) {
  constexpr int kBlocks = R / 8 / T::kSplit;
#pragma unroll(kRolled ? 1 : D / 8 / kChain)
  for (int k0 = 0; k0 < D / 8; k0 += kChain) {
    uint32_t a_hi[kChain][4], a_lo[kChain][4];
#pragma unroll
    for (int j = 0; j < kChain; ++j) {
      const uint32_t xa = x + step_off<T::kOuter>(off.a, k0 + j);
      ldsm_x4(a_hi[j], xa);
      ldsm_x4(a_lo[j], xa + kXPlane);
    }
#pragma unroll
    for (int np = 0; np < (kBlocks + 1) / 2; ++np) {
      uint32_t b_hi[kChain][4], b_lo[kChain][4];
#pragma unroll
      for (int j = 0; j < kChain; ++j) {
        const uint32_t yb = y + np * 16 * 128 + step_off<R>(off.b, k0 + j);
        if constexpr (kBlocks == 1) {
          ldsm_x2(b_hi[j], yb);
          ldsm_x2(b_lo[j], yb + kYPlane);
        } else {
          ldsm_x4(b_hi[j], yb);
          ldsm_x4(b_lo[j], yb + kYPlane);
        }
      }
      mma3<kChain>(s[2 * np], k0 == 0, a_hi, a_lo, b_hi, b_lo, 0);
      if constexpr (kBlocks > 1) mma3<kChain>(s[2 * np + 1], k0 == 0, a_hi, a_lo, b_hi, b_lo, 2);
    }
  }
}

// acc[nb] (columns 8 nb.. of the warp's rows) += A . B over the warp's
// R / kSplit rows of an inner tile, A the accumulator blocks ``c`` (as
// acc_to_a reads them), B the tile rows at ``tile`` (hi plane; lo kPlane
// bytes after) read along their columns, rows in the order 2t, 2t + 1.
template <int D, int R, int kPlane, class T>
__device__ __forceinline__ void product_cols(float (&acc)[D / 8][4],
                                             const float (&c)[R / 8 / T::kSplit][4],
                                             uint32_t tile, const LaneOffsets<T>& off) {
  constexpr int kBlocks = R / 8 / T::kSplit;
  constexpr int C = kBlocks % kChain == 0 ? kChain : 1;
#pragma unroll
  for (int k0 = 0; k0 < kBlocks; k0 += C) {
    uint32_t a_hi[C][4], a_lo[C][4];
#pragma unroll
    for (int j = 0; j < C; ++j) acc_to_a(c[k0 + j], a_hi[j], a_lo[j]);
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
      uint32_t b_hi[C][4], b_lo[C][4];
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const uint32_t at = tile + (nb >> 2) * (R * 128) + (k0 + j) * 1024;
        const uint32_t x0 = at + (off.col[0] ^ ((nb & 3) << 5));
        const uint32_t x1 = at + (off.col[1] ^ ((nb & 3) << 5));
        b_hi[j][0] = lds(x0);
        b_hi[j][1] = lds(x1);
        b_lo[j][0] = lds(x0 + kPlane);
        b_lo[j][1] = lds(x1 + kPlane);
      }
      mma3<C>(acc[nb], false, a_hi, a_lo, b_hi, b_lo, 0);
    }
  }
}

// A warp's f32 accumulators (its 16 rows, columns 8 nb + 2t, 2t + 1) to
// its part of ``red`` ([kSplit][kOuter][D + 8] under tiling T; the pitch
// keeps the warps' 8-byte stores free of bank conflicts).
template <class T, int D>
__device__ __forceinline__ void stage_partial(const float (&acc)[D / 8][4], float* red, int warp,
                                              int lane) {
  constexpr int kPitch = D + 8;
  float* r = red + ((warp >> T::kGroupBits) * T::kOuter + 16 * (warp & (T::kGroups - 1)) +
                    (lane >> 2)) * kPitch +
             2 * (lane & 3);
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb)
      *reinterpret_cast<float2*>(r + half * 8 * kPitch + 8 * nb) =
          make_float2(acc[nb][2 * half], acc[nb][2 * half + 1]);
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int nb = 0; nb < N; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nb][i] = 0.f;
}

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (hopper::smem_addr(raw) & 1023)) & 1023);
}

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------

// A 4-D TMA map over one [B, T, H, D] f32 tensor read through its strides
// in elements (sb, st, sh; head_dim contiguous): dims (D, H, T, B), boxes
// of 32 columns x ``rows`` positions of one (batch, head), 128-byte
// swizzled, zeros past T. TMA needs a 16-byte aligned base and strides
// that are multiples of 16 bytes (ops/_kernels.py:tma_aligned).
inline cudaError_t make_map(CUtensorMap* map, const void* base, int batch, int seq, int heads,
                            int head_dim, long long sb, long long st, long long sh, int rows) {
  const hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(head_dim), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 4, static_cast<cuuint64_t>(st) * 4,
                                 static_cast<cuuint64_t>(sb) * 4};
  const cuuint32_t box[4] = {32, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(base),
                            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace tf32x3
