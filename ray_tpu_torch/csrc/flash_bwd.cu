// Flash-attention backward for Hopper (sm_90a): the dK/dV pass in every
// type and the fp32 dQ pass. The bf16/fp16 dQ pass is flash_bwd_dq.cu.
//
// Counterparts of ray_tpu/ops/attention.py:_flash_bwd_dkv_kernel and
// _flash_bwd_dq_kernel (the Pallas TPU kernels launched by
// _flash_backward; shared math _bwd_block). Same function: with the
// forward's row log-sum-exp LSE and delta = rowsum(dO * O), for every
// attended (query, key) pair
//   p  = exp(s - LSE),  s = (q.k^T) * scale  (masked scores: p exactly 0)
//   dP = dO . v^T                             (f32)
//   dS = p * (dP - delta) * scale
//   dQ = sum_k dS . k    (dS rounded to k's type before the product)
//   dV = sum_q p^T . dO,  dK = sum_q dS^T . q
// with every sum accumulated in f32 and each result written in its input's
// type. delta is computed outside the kernels, as in the reference
// (ray_tpu_torch/ops/attention.py:_flash_backward).
//
// Rounding against the reference. bf16/fp16 products run on the tensor
// cores, which take 16-bit operands: where the TPU kernel forms dV and dK
// from an unrounded f32 p and dS, the dK/dV kernel rounds p and dS to the
// input type first. fp32 inputs keep full fp32 math on the FMA units,
// since a TF32 product would not match the reference.
//
// What bounds it on this card. Per attended (q, k) pair and (batch, head)
// the dK/dV pass does 4 products of length D (S, dP, dV, dK: 8*D
// operations) against q, k, v, dO read once and dK, dV written once. At
// GPT-2 124M's training shape (B=8, T=1024, H=12, D=64, bf16, causal) it
// must move ~76 MB (23 us at 3.35 TB/s) and do ~26 GFLOP (26 us at 989
// TFLOP/s): the tensor cores bound it, with the bytes close behind.
//
// The dK/dV kernel still has the first port's design, which
// flash_bwd_dq.cu replaced for the dQ pass: WMMA (mma.sync) fragments
// reloaded from shared memory for every product, scalar synchronous tile
// loads with no copy/compute overlap, and S and dP staged through shared
// memory for the elementwise step. It keeps the O(T^2) p and dS out of
// device memory, reads q/k/v/dO in their public [B, T, H, D] layout
// through strides, skips the tiles the causal mask empties, and keeps the
// TPU kernels' two-pass split, so no atomics: gradients come out the same
// from run to run.
//
// Blocking. The TPU grids carried the dQ accumulator across a sequential
// key axis and the dK/dV accumulators across a sequential query axis, in
// VMEM scratch; Hopper runs blocks in no order. So one block of 4 warps
// per (batch*head, 64-row query tile) loops over 64-key tiles for dQ, and
// one block per (batch*head, 64-key tile) loops over 64-row query tiles
// for dK and dV; each warp owns 16 rows of the block's tile and keeps its
// accumulators in registers (WMMA accumulator fragments on the tensor-core
// path). The f32 S and dP tiles share memory with the 16-bit p and dS
// tiles written over them, which keeps a block at 70-105 KB of dynamic
// shared memory on the tensor-core path. Ragged edges (T not a multiple of
// 64) are masked in the kernel; a causal key tile that lies beyond every
// query (Tq < Tk) runs no iteration and writes zeros.
//
// Built by ray_tpu_torch/ops/_kernels.py with nvcc into a shared library
// with a plain C interface; every launch returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <climits>
#include <cstddef>

namespace {

using namespace nvcuda;

constexpr int kTile = 64;                      // rows of a block's tile and of the inner tiles
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = kTile / kWarps;   // 16: one WMMA row tile
constexpr int kThreads = kWarps * 32;
constexpr int kLdS = kTile + 4;                // pitch of the f32 S and dP tiles

template <typename T>
struct Num;
template <>
struct Num<float> {
  static __device__ __forceinline__ float to_f(float x) { return x; }
  static __device__ __forceinline__ float from_f(float x) { return x; }
};
template <>
struct Num<__half> {
  static __device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
  static __device__ __forceinline__ __half from_f(float x) { return __float2half_rn(x); }
};
template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float x) {
    return __float2bfloat16_rn(x);
  }
};

constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

// Shared-memory layout, the same for both passes: four input tiles
// (q, dO, k, v), the f32 S and dP tiles of the four warps, and the 64
// rows' LSE and delta. On the tensor-core path p and dS are written in
// the input type over S and dP (pitch kLdP). Pitches keep WMMA's rules
// (a multiple of 8 elements for 16-bit types; every tile start 32-byte
// aligned) and stagger rows across banks; the FMA path reads columns of
// the input tiles, so their pitch is odd there.
template <typename T, int D, bool kTensorCores>
struct Layout {
  static constexpr int kLdX = kTensorCores ? D + 8 : D + 1;
  static constexpr int kLdP = kTensorCores ? kTile + 8 : kLdS;
  static constexpr size_t kTileBytes = align128(sizeof(T) * kTile * kLdX);
  static constexpr size_t kQ = 0;
  static constexpr size_t kDO = kTileBytes;
  static constexpr size_t kK = 2 * kTileBytes;
  static constexpr size_t kV = 3 * kTileBytes;
  static constexpr size_t kS = 4 * kTileBytes;
  static constexpr size_t kDP = kS + align128(sizeof(float) * kTile * kLdS);
  static constexpr size_t kStats = kDP + align128(sizeof(float) * kTile * kLdS);
  static constexpr size_t kBytes = kStats + 2 * kTile * sizeof(float);
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B*H, Tq]
  const float* delta;  // [B*H, Tq]
  void* dq;
  void* dk;
  void* dv;
  long long q_sb, q_st, q_sh;  // strides in elements: batch, position, head
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long do_sb, do_st, do_sh;
  long long dq_sb, dq_st, dq_sh;
  long long dk_sb, dk_st, dk_sh;
  long long dv_sb, dv_st, dv_sh;
  int heads, tq, tk, n_tiles, causal;
  float scale;
};

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Rows [row0, row0 + 64) of one (batch, head) of a [B, T, H, D] tensor
// into a tile; rows at or past t_end are zero.
template <typename T, int D, int kLd>
__device__ __forceinline__ void load_tile(T* tile, const T* g, long long st, int row0,
                                          int t_end) {
  const T zero = Num<T>::from_f(0.f);
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i % D, t = row0 + r;
    tile[r * kLd + c] = t < t_end ? g[t * st + c] : zero;
  }
}

// Tensor cores: out[16][64] (f32, pitch kLdS) = A[16][D] . B[64][D]^T.
template <typename T, int D, int kLd>
__device__ __forceinline__ void product_nt_tc(const T* a, const T* b, float* out) {
#pragma unroll
  for (int jn = 0; jn < kTile / 16; ++jn) {
    Acc fc;
    wmma::fill_fragment(fc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, a + kk * 16, kLd);
      wmma::load_matrix_sync(fb, b + jn * 16 * kLd + kk * 16, kLd);
      wmma::mma_sync(fc, fa, fb, fc);
    }
    wmma::store_matrix_sync(out + jn * 16, fc, kLdS, wmma::mem_row_major);
  }
}

// Tensor cores: acc[16][D] += A[16][64] (pitch kLdA) . B[64][D] (pitch kLd).
template <typename T, int D, int kLd, int kLdA>
__device__ __forceinline__ void product_nn_tc(const T* a, const T* b, Acc (&acc)[D / 16]) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, a + kk * 16, kLdA);
#pragma unroll
    for (int jn = 0; jn < D / 16; ++jn) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, b + kk * 16 * kLd + jn * 16, kLd);
      wmma::mma_sync(acc[jn], fa, fb, acc[jn]);
    }
  }
}

// FMA units: s[r][j] = A[r][:] . B[lane + 32 j][:] for the warp's 16 rows
// of A and the tile's 64 rows of B.
template <typename T, int D, int kLd>
__device__ __forceinline__ void product_nt_fma(const T* a, const T* b, int lane,
                                               float (&s)[kRowsPerWarp][2]) {
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < D; ++kk) {
    const float b0 = Num<T>::to_f(b[lane * kLd + kk]);
    const float b1 = Num<T>::to_f(b[(lane + 32) * kLd + kk]);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float av = Num<T>::to_f(a[r * kLd + kk]);
      s[r][0] = fmaf(av, b0, s[r][0]);
      s[r][1] = fmaf(av, b1, s[r][1]);
    }
  }
}

// FMA units: acc[r][c] += sum_j A[r][j] * B[j][lane + 32 c], A f32 with
// pitch kLdS.
template <typename T, int D, int kLd>
__device__ __forceinline__ void product_nn_fma(const float* a, const T* b, int lane,
                                               float (&acc)[kRowsPerWarp][D / 32]) {
#pragma unroll 4
  for (int j = 0; j < kTile; ++j) {
    float bv[D / 32];
#pragma unroll
    for (int c = 0; c < D / 32; ++c) bv[c] = Num<T>::to_f(b[j * kLd + lane + 32 * c]);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float aj = a[r * kLdS + j];
#pragma unroll
      for (int c = 0; c < D / 32; ++c) acc[r][c] = fmaf(aj, bv[c], acc[r][c]);
    }
  }
}

// A warp's 16 accumulated rows out to device memory, in T. Rows at or
// past t_end are not written. The tensor-core path stages each 16x16
// fragment through the warp's f32 tile ``stage``.
template <typename T, int D>
__device__ __forceinline__ void store_rows_tc(Acc (&acc)[D / 16], float* stage, T* g,
                                              long long st, int t0, int t_end, int lane) {
  __syncwarp();
#pragma unroll
  for (int jn = 0; jn < D / 16; ++jn) {
    wmma::store_matrix_sync(stage, acc[jn], kLdS, wmma::mem_row_major);
    __syncwarp();
    for (int i = lane; i < 16 * 16; i += 32) {
      const int r = i / 16, c = i % 16, t = t0 + r;
      if (t < t_end) g[t * st + jn * 16 + c] = Num<T>::from_f(stage[r * kLdS + c]);
    }
    __syncwarp();
  }
}

template <typename T, int D>
__device__ __forceinline__ void store_rows_fma(const float (&acc)[kRowsPerWarp][D / 32], T* g,
                                               long long st, int t0, int t_end, int lane) {
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int t = t0 + r;
    if (t >= t_end) continue;
#pragma unroll
    for (int c = 0; c < D / 32; ++c) g[t * st + lane + 32 * c] = Num<T>::from_f(acc[r][c]);
  }
}

// The 64 rows' LSE and delta from [B*H, Tq]; rows at or past Tq get 0
// (their p is masked or their inputs are zero).
__device__ __forceinline__ void load_stats(float* lse_s, float* dl_s, const Args& a, int bh,
                                           int m0) {
  if (threadIdx.x < kTile) {
    const int t = m0 + threadIdx.x;
    const long long i = static_cast<long long>(bh) * a.tq + t;
    lse_s[threadIdx.x] = t < a.tq ? a.lse[i] : 0.f;
    dl_s[threadIdx.x] = t < a.tq ? a.delta[i] : 0.f;
  }
}

// dQ pass, fp32: one block per (batch*head, 64-row query tile), looping
// over the key tiles at or below the diagonal, on the FMA units.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_fp32_kernel(const Args a) {
  using T = float;
  using L = Layout<T, D, false>;
  constexpr int kLd = L::kLdX;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem + L::kQ);
  T* dos = reinterpret_cast<T*>(smem + L::kDO);
  T* ks = reinterpret_cast<T*>(smem + L::kK);
  T* vs = reinterpret_cast<T*>(smem + L::kV);
  float* lse_s = reinterpret_cast<float*>(smem + L::kStats);
  float* dl_s = lse_s + kTile;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // Longest causal rows first, so the heaviest blocks start earliest.
  const int qt = a.n_tiles - 1 - static_cast<int>(blockIdx.x % a.n_tiles);
  const int bh = static_cast<int>(blockIdx.x / a.n_tiles);
  const int b = bh / a.heads;
  const int h = bh % a.heads;
  const int m0 = qt * kTile;
  const int row0 = warp * kRowsPerWarp;  // the warp's first row in the tile

  const T* kg = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  load_tile<T, D, kLd>(qs, static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh, a.q_st, m0,
                       a.tq);
  load_tile<T, D, kLd>(dos, static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh,
                       a.do_st, m0, a.tq);
  load_stats(lse_s, dl_s, a, bh, m0);

  float* ss = reinterpret_cast<float*>(smem + L::kS) + row0 * kLdS;

  float acc[kRowsPerWarp][D / 32];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < D / 32; ++c) acc[r][c] = 0.f;

  const int n_end = a.causal ? min(a.tk, m0 + kTile) : a.tk;
  for (int n0 = 0; n0 < n_end; n0 += kTile) {
    __syncthreads();  // the previous tiles are consumed (and q, dO written)
    load_tile<T, D, kLd>(ks, kg, a.k_st, n0, a.tk);
    load_tile<T, D, kLd>(vs, vg, a.v_st, n0, a.tk);
    __syncthreads();

    float s[kRowsPerWarp][2], dp[kRowsPerWarp][2];
    product_nt_fma<T, D, kLd>(qs + row0 * kLd, ks, lane, s);
    product_nt_fma<T, D, kLd>(dos + row0 * kLd, vs, lane, dp);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int lr = row0 + r, qi = m0 + lr;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kj = n0 + lane + 32 * j;
        const bool ok = kj < a.tk && (!a.causal || qi >= kj);
        const float p = ok ? expf(s[r][j] * a.scale - lse_s[lr]) : 0.f;
        ss[r * kLdS + lane + 32 * j] = p * (dp[r][j] - dl_s[lr]) * a.scale;
      }
    }
    __syncwarp();
    product_nn_fma<T, D, kLd>(ss, ks, lane, acc);
  }

  T* dqg = static_cast<T*>(a.dq) + b * a.dq_sb + h * a.dq_sh;
  store_rows_fma<T, D>(acc, dqg, a.dq_st, m0 + row0, a.tq, lane);
}

// dK/dV pass: one block per (batch*head, 64-key tile), looping over the
// query tiles at or below the diagonal. Each warp owns 16 keys and works
// on the transposed tiles S^T = K.Q^T and dP^T = V.dO^T.
template <typename T, int D, bool kTensorCores>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(const Args a) {
  using L = Layout<T, D, kTensorCores>;
  constexpr int kLd = L::kLdX;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem + L::kQ);
  T* dos = reinterpret_cast<T*>(smem + L::kDO);
  T* ks = reinterpret_cast<T*>(smem + L::kK);
  T* vs = reinterpret_cast<T*>(smem + L::kV);
  float* lse_s = reinterpret_cast<float*>(smem + L::kStats);
  float* dl_s = lse_s + kTile;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // Key tile 0 meets the most causal query tiles: it starts first.
  const int kt = static_cast<int>(blockIdx.x % a.n_tiles);
  const int bh = static_cast<int>(blockIdx.x / a.n_tiles);
  const int b = bh / a.heads;
  const int h = bh % a.heads;
  const int n0 = kt * kTile;
  const int row0 = warp * kRowsPerWarp;  // the warp's first key in the tile
  const int kj0 = n0 + row0;

  const T* qg = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* dog = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
  load_tile<T, D, kLd>(ks, static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh, a.k_st, n0,
                       a.tk);
  load_tile<T, D, kLd>(vs, static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh, a.v_st, n0,
                       a.tk);

  float* ss = reinterpret_cast<float*>(smem + L::kS) + row0 * kLdS;
  float* sdp = reinterpret_cast<float*>(smem + L::kDP) + row0 * kLdS;
  T* pt = reinterpret_cast<T*>(ss);    // p^T in T, over S^T (tensor-core path)
  T* dst = reinterpret_cast<T*>(sdp);  // dS^T in T, over dP^T

  Acc fk[kTensorCores ? D / 16 : 1], fv[kTensorCores ? D / 16 : 1];
  float acc_k[kRowsPerWarp][kTensorCores ? 1 : D / 32];
  float acc_v[kRowsPerWarp][kTensorCores ? 1 : D / 32];
  if constexpr (kTensorCores) {
#pragma unroll
    for (int jn = 0; jn < D / 16; ++jn) {
      wmma::fill_fragment(fk[jn], 0.f);
      wmma::fill_fragment(fv[jn], 0.f);
    }
  } else {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int c = 0; c < D / 32; ++c) acc_k[r][c] = acc_v[r][c] = 0.f;
  }

  // Query tiles wholly above the diagonal hold no query that attends to
  // these keys. Past every query (Tq < Tk, causal) the loop is empty and
  // the zero accumulators are written.
  for (int m0 = a.causal ? n0 : 0; m0 < a.tq; m0 += kTile) {
    __syncthreads();  // the previous tiles are consumed (and k, v written)
    load_tile<T, D, kLd>(qs, qg, a.q_st, m0, a.tq);
    load_tile<T, D, kLd>(dos, dog, a.do_st, m0, a.tq);
    load_stats(lse_s, dl_s, a, bh, m0);
    __syncthreads();

    if constexpr (kTensorCores) {
      product_nt_tc<T, D, kLd>(ks + row0 * kLd, qs, ss);    // S^T
      product_nt_tc<T, D, kLd>(vs + row0 * kLd, dos, sdp);  // dP^T
      __syncwarp();
      // Row r of p^T / dS^T (in T) overlaps only rows <= r of S^T / dP^T.
#pragma unroll 1
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int kj = kj0 + r;
        float sv[2], dpv[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          sv[j] = ss[r * kLdS + lane + 32 * j];
          dpv[j] = sdp[r * kLdS + lane + 32 * j];
        }
        __syncwarp();
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int ql = lane + 32 * j, qi = m0 + ql;
          const bool ok = qi < a.tq && kj < a.tk && (!a.causal || qi >= kj);
          const float p = ok ? expf(sv[j] * a.scale - lse_s[ql]) : 0.f;
          pt[r * L::kLdP + ql] = Num<T>::from_f(p);
          dst[r * L::kLdP + ql] = Num<T>::from_f(p * (dpv[j] - dl_s[ql]) * a.scale);
        }
      }
      __syncwarp();
      product_nn_tc<T, D, kLd, L::kLdP>(pt, dos, fv);   // dV += p^T . dO
      product_nn_tc<T, D, kLd, L::kLdP>(dst, qs, fk);   // dK += dS^T . Q
    } else {
      float s[kRowsPerWarp][2], dp[kRowsPerWarp][2];
      product_nt_fma<T, D, kLd>(ks + row0 * kLd, qs, lane, s);
      product_nt_fma<T, D, kLd>(vs + row0 * kLd, dos, lane, dp);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int kj = kj0 + r;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int ql = lane + 32 * j, qi = m0 + ql;
          const bool ok = qi < a.tq && kj < a.tk && (!a.causal || qi >= kj);
          const float p = ok ? expf(s[r][j] * a.scale - lse_s[ql]) : 0.f;
          ss[r * kLdS + ql] = p;
          sdp[r * kLdS + ql] = p * (dp[r][j] - dl_s[ql]) * a.scale;
        }
      }
      __syncwarp();
      product_nn_fma<T, D, kLd>(ss, dos, lane, acc_v);
      product_nn_fma<T, D, kLd>(sdp, qs, lane, acc_k);
    }
  }

  T* dkg = static_cast<T*>(a.dk) + b * a.dk_sb + h * a.dk_sh;
  T* dvg = static_cast<T*>(a.dv) + b * a.dv_sb + h * a.dv_sh;
  if constexpr (kTensorCores) {
    store_rows_tc<T, D>(fk, ss, dkg, a.dk_st, kj0, a.tk, lane);
    store_rows_tc<T, D>(fv, ss, dvg, a.dv_st, kj0, a.tk, lane);
  } else {
    store_rows_fma<T, D>(acc_k, dkg, a.dk_st, kj0, a.tk, lane);
    store_rows_fma<T, D>(acc_v, dvg, a.dv_st, kj0, a.tk, lane);
  }
}

template <int D>
cudaError_t launch_dq_fp32(const Args& a, unsigned int n_blocks, cudaStream_t stream) {
  constexpr size_t smem = Layout<float, D, false>::kBytes;
  auto kernel = flash_bwd_dq_fp32_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<n_blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D, bool kTensorCores>
cudaError_t launch_dkv(const Args& a, unsigned int n_blocks, cudaStream_t stream) {
  constexpr size_t smem = Layout<T, D, kTensorCores>::kBytes;
  auto kernel = flash_bwd_dkv_kernel<T, D, kTensorCores>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<n_blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool kTensorCores>
cudaError_t launch_dkv_d(const Args& a, int head_dim, unsigned int n_blocks,
                         cudaStream_t stream) {
  if (head_dim == 64) return launch_dkv<T, 64, kTensorCores>(a, n_blocks, stream);
  if (head_dim == 128) return launch_dkv<T, 128, kTensorCores>(a, n_blocks, stream);
  return cudaErrorInvalidValue;
}

// Sets the tile count from the rows the blocks tile (Tq for dQ, Tk for
// dK/dV); returns the block count, or 0 if it does not fit a launch.
unsigned int tile_blocks(Args& a, int batch, int tile_rows) {
  a.n_tiles = (tile_rows + kTile - 1) / kTile;
  const long long n_blocks = static_cast<long long>(a.n_tiles) * batch * a.heads;
  return n_blocks <= 0 || n_blocks > INT_MAX ? 0u : static_cast<unsigned int>(n_blocks);
}

}  // namespace

// Strides are in elements; the head_dim axis of every tensor must be
// contiguous; lse and delta are contiguous [B*H, Tq] f32. Each returns a
// cudaError_t (0 on success).

// The dQ pass for float32 inputs.
extern "C" int ray_tpu_torch_flash_bwd_dq_fp32(
    const void* q, const void* k, const void* v, const void* dout, const float* lse,
    const float* delta, void* dq,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long do_sb, long long do_st, long long do_sh,
    long long dq_sb, long long dq_st, long long dq_sh,
    int batch, int heads, int tq, int tk, int head_dim, int causal,
    float scale, void* stream) {
  if (tk <= 0) return cudaErrorInvalidValue;
  Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr,
         q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, do_sb, do_st, do_sh,
         dq_sb, dq_st, dq_sh, 0, 0, 0, 0, 0, 0,
         heads, tq, tk, 0, causal, scale};
  const unsigned int nb = tile_blocks(a, batch, tq);
  if (nb == 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return launch_dq_fp32<64>(a, nb, s);
  if (head_dim == 128) return launch_dq_fp32<128>(a, nb, s);
  return cudaErrorInvalidValue;
}

// The dK/dV pass; dtype: 0 float32, 1 float16, 2 bfloat16.
extern "C" int ray_tpu_torch_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout, const float* lse,
    const float* delta, void* dk, void* dv,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long do_sb, long long do_st, long long do_sh,
    long long dk_sb, long long dk_st, long long dk_sh,
    long long dv_sb, long long dv_st, long long dv_sh,
    int batch, int heads, int tq, int tk, int head_dim, int dtype, int causal,
    float scale, void* stream) {
  if (tq < 0) return cudaErrorInvalidValue;
  Args a{q, k, v, dout, lse, delta, nullptr, dk, dv,
         q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, do_sb, do_st, do_sh,
         0, 0, 0, dk_sb, dk_st, dk_sh, dv_sb, dv_st, dv_sh,
         heads, tq, tk, 0, causal, scale};
  const unsigned int nb = tile_blocks(a, batch, tk);
  if (nb == 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_dkv_d<float, false>(a, head_dim, nb, s);
    case 1: return launch_dkv_d<__half, true>(a, head_dim, nb, s);
    case 2: return launch_dkv_d<__nv_bfloat16, true>(a, head_dim, nb, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* ray_tpu_torch_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
