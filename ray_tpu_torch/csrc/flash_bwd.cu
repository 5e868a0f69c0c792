// Flash-attention backward for float32 inputs, for Hopper (sm_90a): the
// dQ pass and the dK/dV pass on the FMA units. The bf16/fp16 passes are
// flash_bwd_dq.cu and flash_bwd_dkv.cu (wgmma, TMA).
//
// Counterparts of ray_tpu/ops/attention.py:_flash_bwd_dq_kernel and
// _flash_bwd_dkv_kernel (the Pallas TPU kernels launched by
// _flash_backward; shared math _bwd_block). Same function: with the
// forward's row log-sum-exp LSE and delta = rowsum(dO * O), for every
// attended (query, key) pair
//   p  = exp(s - LSE),  s = (q.k^T) * scale  (masked scores: p exactly 0)
//   dP = dO . v^T
//   dS = p * (dP - delta) * scale
//   dQ = sum_k dS . k,  dV = sum_q p^T . dO,  dK = sum_q dS^T . q
// in full fp32 throughout, as the reference computes it: a TF32 product
// would not match it, and wgmma has no fp32 form. delta is computed
// outside the kernels, as in the reference
// (ray_tpu_torch/ops/attention.py:_flash_backward).
//
// What bounds it on this card. Per attended (q, k) pair and (batch, head)
// the dQ pass does 3 products of length D (6*D operations), the dK/dV
// pass 4 (8*D), against q, k, v, dO read once and the gradients written
// once. At GPT-2 124M's training shape (B=8, T=1024, H=12, D=64, causal)
// in fp32 that is ~19 and ~26 GFLOP, 0.29 and 0.39 ms at the FMA units'
// 67 TFLOP/s, far above the bytes' ~40 us: the FMA units bound both.
//
// The design is the first port's. It keeps the O(T^2) p and dS out of
// device memory, reads q/k/v/dO in their public [B, T, H, D] layout
// through strides, skips the tiles the causal mask empties, and keeps the
// TPU kernels' two-pass split, so no atomics: gradients come out the same
// from run to run. The TPU grids carried the dQ accumulator across a
// sequential key axis and the dK/dV accumulators across a sequential
// query axis, in VMEM scratch; Hopper runs blocks in no order. So one
// block of 4 warps per (batch*head, 64-row query tile) loops over 64-key
// tiles for dQ, and one block per (batch*head, 64-key tile) loops over
// 64-row query tiles for dK and dV; each warp owns 16 rows of the block's
// tile and keeps its accumulators in registers. Tiles are loaded with
// scalar, synchronous loads into odd-pitched shared memory (the products
// read its columns); S and dP go through shared memory for the
// elementwise step. Ragged edges (T not a multiple of 64) are masked in
// the kernel; a causal key tile that lies beyond every query (Tq < Tk)
// runs no iteration and writes zeros.
//
// Built by ray_tpu_torch/ops/_kernels.py with nvcc into a shared library
// with a plain C interface; every launch returns cudaGetLastError().

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int kTile = 64;                      // rows of a block's tile and of the inner tiles
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = kTile / kWarps;   // 16 rows a warp
constexpr int kThreads = kWarps * 32;
constexpr int kLdS = kTile + 4;                // pitch of the f32 S and dP tiles

constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

// Shared-memory layout, the same for both passes: four input tiles
// (q, dO, k, v), the f32 S and dP tiles of the four warps, and the 64
// rows' LSE and delta. The products read columns of the input tiles, so
// their pitch is odd, which staggers rows across banks.
template <int D>
struct Layout {
  static constexpr int kLdX = D + 1;
  static constexpr size_t kTileBytes = align128(sizeof(float) * kTile * kLdX);
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
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* lse;    // [B*H, Tq]
  const float* delta;  // [B*H, Tq]
  float* dq;
  float* dk;
  float* dv;
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

// Rows [row0, row0 + 64) of one (batch, head) of a [B, T, H, D] tensor
// into a tile; rows at or past t_end are zero.
template <int D, int kLd>
__device__ __forceinline__ void load_tile(float* tile, const float* g, long long st, int row0,
                                          int t_end) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i % D, t = row0 + r;
    tile[r * kLd + c] = t < t_end ? g[t * st + c] : 0.f;
  }
}

// s[r][j] = A[r][:] . B[lane + 32 j][:] for the warp's 16 rows of A and
// the tile's 64 rows of B.
template <int D, int kLd>
__device__ __forceinline__ void product_nt(const float* a, const float* b, int lane,
                                           float (&s)[kRowsPerWarp][2]) {
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < D; ++kk) {
    const float b0 = b[lane * kLd + kk];
    const float b1 = b[(lane + 32) * kLd + kk];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float av = a[r * kLd + kk];
      s[r][0] = fmaf(av, b0, s[r][0]);
      s[r][1] = fmaf(av, b1, s[r][1]);
    }
  }
}

// acc[r][c] += sum_j A[r][j] * B[j][lane + 32 c], A with pitch kLdS.
template <int D, int kLd>
__device__ __forceinline__ void product_nn(const float* a, const float* b, int lane,
                                           float (&acc)[kRowsPerWarp][D / 32]) {
#pragma unroll 4
  for (int j = 0; j < kTile; ++j) {
    float bv[D / 32];
#pragma unroll
    for (int c = 0; c < D / 32; ++c) bv[c] = b[j * kLd + lane + 32 * c];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float aj = a[r * kLdS + j];
#pragma unroll
      for (int c = 0; c < D / 32; ++c) acc[r][c] = fmaf(aj, bv[c], acc[r][c]);
    }
  }
}

// A warp's 16 accumulated rows out to device memory; rows at or past
// t_end are not written.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[kRowsPerWarp][D / 32], float* g,
                                           long long st, int t0, int t_end, int lane) {
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int t = t0 + r;
    if (t >= t_end) continue;
#pragma unroll
    for (int c = 0; c < D / 32; ++c) g[t * st + lane + 32 * c] = acc[r][c];
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

// dQ pass: one block per (batch*head, 64-row query tile), looping over
// the key tiles at or below the diagonal.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_fp32_kernel(const Args a) {
  using L = Layout<D>;
  constexpr int kLd = L::kLdX;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + L::kQ);
  float* dos = reinterpret_cast<float*>(smem + L::kDO);
  float* ks = reinterpret_cast<float*>(smem + L::kK);
  float* vs = reinterpret_cast<float*>(smem + L::kV);
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

  const float* kg = a.k + b * a.k_sb + h * a.k_sh;
  const float* vg = a.v + b * a.v_sb + h * a.v_sh;
  load_tile<D, kLd>(qs, a.q + b * a.q_sb + h * a.q_sh, a.q_st, m0, a.tq);
  load_tile<D, kLd>(dos, a.dout + b * a.do_sb + h * a.do_sh, a.do_st, m0, a.tq);
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
    load_tile<D, kLd>(ks, kg, a.k_st, n0, a.tk);
    load_tile<D, kLd>(vs, vg, a.v_st, n0, a.tk);
    __syncthreads();

    float s[kRowsPerWarp][2], dp[kRowsPerWarp][2];
    product_nt<D, kLd>(qs + row0 * kLd, ks, lane, s);
    product_nt<D, kLd>(dos + row0 * kLd, vs, lane, dp);
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
    product_nn<D, kLd>(ss, ks, lane, acc);
  }

  store_rows<D>(acc, a.dq + b * a.dq_sb + h * a.dq_sh, a.dq_st, m0 + row0, a.tq, lane);
}

// dK/dV pass: one block per (batch*head, 64-key tile), looping over the
// query tiles at or below the diagonal. Each warp owns 16 keys and works
// on the transposed tiles S^T = K.Q^T and dP^T = V.dO^T.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_fp32_kernel(const Args a) {
  using L = Layout<D>;
  constexpr int kLd = L::kLdX;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + L::kQ);
  float* dos = reinterpret_cast<float*>(smem + L::kDO);
  float* ks = reinterpret_cast<float*>(smem + L::kK);
  float* vs = reinterpret_cast<float*>(smem + L::kV);
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

  const float* qg = a.q + b * a.q_sb + h * a.q_sh;
  const float* dog = a.dout + b * a.do_sb + h * a.do_sh;
  load_tile<D, kLd>(ks, a.k + b * a.k_sb + h * a.k_sh, a.k_st, n0, a.tk);
  load_tile<D, kLd>(vs, a.v + b * a.v_sb + h * a.v_sh, a.v_st, n0, a.tk);

  float* ss = reinterpret_cast<float*>(smem + L::kS) + row0 * kLdS;
  float* sdp = reinterpret_cast<float*>(smem + L::kDP) + row0 * kLdS;

  float acc_k[kRowsPerWarp][D / 32], acc_v[kRowsPerWarp][D / 32];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < D / 32; ++c) acc_k[r][c] = acc_v[r][c] = 0.f;

  // Query tiles wholly above the diagonal hold no query that attends to
  // these keys. Past every query (Tq < Tk, causal) the loop is empty and
  // the zero accumulators are written.
  for (int m0 = a.causal ? n0 : 0; m0 < a.tq; m0 += kTile) {
    __syncthreads();  // the previous tiles are consumed (and k, v written)
    load_tile<D, kLd>(qs, qg, a.q_st, m0, a.tq);
    load_tile<D, kLd>(dos, dog, a.do_st, m0, a.tq);
    load_stats(lse_s, dl_s, a, bh, m0);
    __syncthreads();

    float s[kRowsPerWarp][2], dp[kRowsPerWarp][2];
    product_nt<D, kLd>(ks + row0 * kLd, qs, lane, s);
    product_nt<D, kLd>(vs + row0 * kLd, dos, lane, dp);
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
    product_nn<D, kLd>(ss, dos, lane, acc_v);
    product_nn<D, kLd>(sdp, qs, lane, acc_k);
  }

  store_rows<D>(acc_k, a.dk + b * a.dk_sb + h * a.dk_sh, a.dk_st, kj0, a.tk, lane);
  store_rows<D>(acc_v, a.dv + b * a.dv_sb + h * a.dv_sh, a.dv_st, kj0, a.tk, lane);
}

template <int D, bool kDq>
cudaError_t launch(const Args& a, unsigned int n_blocks, cudaStream_t stream) {
  constexpr size_t smem = Layout<D>::kBytes;
  auto kernel = kDq ? flash_bwd_dq_fp32_kernel<D> : flash_bwd_dkv_fp32_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<n_blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// Sets the tile count from the rows the blocks tile (Tq for dQ, Tk for
// dK/dV) and launches a pass.
template <bool kDq>
cudaError_t launch_pass(Args& a, int batch, int tile_rows, int head_dim, cudaStream_t stream) {
  a.n_tiles = (tile_rows + kTile - 1) / kTile;
  const long long n_blocks = static_cast<long long>(a.n_tiles) * batch * a.heads;
  if (n_blocks <= 0 || n_blocks > INT_MAX) return cudaErrorInvalidValue;
  const auto nb = static_cast<unsigned int>(n_blocks);
  if (head_dim == 64) return launch<64, kDq>(a, nb, stream);
  if (head_dim == 128) return launch<128, kDq>(a, nb, stream);
  return cudaErrorInvalidValue;
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
  Args a{static_cast<const float*>(q), static_cast<const float*>(k),
         static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,
         static_cast<float*>(dq), nullptr, nullptr,
         q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, do_sb, do_st, do_sh,
         dq_sb, dq_st, dq_sh, 0, 0, 0, 0, 0, 0,
         heads, tq, tk, 0, causal, scale};
  return launch_pass<true>(a, batch, tq, head_dim, static_cast<cudaStream_t>(stream));
}

// The dK/dV pass for float32 inputs.
extern "C" int ray_tpu_torch_flash_bwd_dkv_fp32(
    const void* q, const void* k, const void* v, const void* dout, const float* lse,
    const float* delta, void* dk, void* dv,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long do_sb, long long do_st, long long do_sh,
    long long dk_sb, long long dk_st, long long dk_sh,
    long long dv_sb, long long dv_st, long long dv_sh,
    int batch, int heads, int tq, int tk, int head_dim, int causal,
    float scale, void* stream) {
  if (tq < 0) return cudaErrorInvalidValue;
  Args a{static_cast<const float*>(q), static_cast<const float*>(k),
         static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,
         nullptr, static_cast<float*>(dk), static_cast<float*>(dv),
         q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, do_sb, do_st, do_sh,
         0, 0, 0, dk_sb, dk_st, dk_sh, dv_sb, dv_st, dv_sh,
         heads, tq, tk, 0, causal, scale};
  return launch_pass<false>(a, batch, tk, head_dim, static_cast<cudaStream_t>(stream));
}

extern "C" const char* ray_tpu_torch_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
