// Flash-attention backward, dQ pass, for Hopper (sm_90a): bf16 and fp16.
//
// Counterpart of ray_tpu/ops/attention.py:_flash_bwd_dq_kernel (the Pallas
// TPU kernel launched by _flash_backward; shared math _bwd_block). Same
// function: with the forward's row log-sum-exp LSE and delta =
// rowsum(dO * O), for every attended (query, key) pair
//   p  = exp(s - LSE),  s = (q.k^T) * scale  (masked scores: p exactly 0)
//   dP = dO . v^T                             (f32)
//   dS = p * (dP - delta) * scale
//   dQ = sum_k dS . k    (dS rounded to k's type before the product)
// with the sum accumulated in f32 and dQ written in q's type; the scale
// is folded with log2(e) into one factor for exp2, which is one
// ex2.approx.ftz (hopper.cuh: a p below 2^-126 becomes 0). delta is
// computed outside the kernel, as in the reference
// (ray_tpu_torch/ops/attention.py:_flash_backward). The fp32 dQ pass and
// the dK/dV pass are in flash_bwd.cu.
//
// What bounds it on this card. Per attended (q, k) pair and (batch, head)
// the pass does 3 products of length D (S, dP, dQ: 6*D operations)
// against q, k, v, dO read once and dQ written once. At GPT-2 124M's
// training shape (B=8, T=1024, H=12, D=64, bf16, causal) it must move
// ~64 MB (19 us at 3.35 TB/s) and do ~19 GFLOP (20 us at 989 TFLOP/s):
// the tensor cores bound it, with the bytes close behind, so the products
// must run on wgmma and p, dS must never leave the SM.
//
// The design. One warpgroup (128 threads) per (batch*head, 64-row query
// tile), heaviest causal tiles first, looping over the key tiles at or
// below the diagonal: the TPU's two-pass split, so no atomics and the same
// gradients from run to run. q and dO are loaded once by TMA; each thread
// keeps the LSE and delta of its two rows in registers. 64-key tiles of K
// and V come through a ring of kStages shared-memory stages by TMA (one
// thread issues the copies, an mbarrier per stage reports them), so the
// next tile's copy runs under this tile's products. S = Q.K^T and
// dP = dO.V^T are wgmma from shared memory into registers; p and dS are
// formed on those accumulator fragments in registers (the mask only on
// diagonal and ragged tiles); dS, rounded to 16 bits in registers, is the
// A operand of dQ += dS.K (wgmma, K MN-major from shared memory), and dQ
// stays in registers across the key loop until the epilogue writes it
// with 16-byte stores. TMA reads q, k, v and dO in their public
// [B, T, H, D] layout through strides and fills rows past T with zeros.
//
// Built by ray_tpu_torch/ops/_kernels.py with nvcc into a shared library
// with a plain C interface; every launch returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>

#include "hopper.cuh"

namespace {

constexpr int kTile = 64;      // query rows per block; keys per tile
constexpr int kThreads = 128;  // one warpgroup; four warps
constexpr int kStages = 2;
static_assert(kTile == hopper::kRows, "64-row tiles");

struct Args {
  const float* lse;    // [B*H, Tq]
  const float* delta;  // [B*H, Tq]
  void* dq;
  long long dq_sb, dq_st, dq_sh;  // strides in elements: batch, position, head
  int heads, tq, tk, n_qtiles, causal;
  float scale;
};

// Shared memory: the q and dO tiles, kStages (K, V) pairs, the barriers;
// every tile 1024-byte aligned (the 128-byte swizzle's period).
template <int D>
struct Smem {
  static constexpr int kTileBytes = kTile * D * 2;
  static constexpr int kQ = 0;
  static constexpr int kDO = kTileBytes;
  static constexpr int kK = 2 * kTileBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBars = kV + kStages * kTileBytes;  // q/dO barrier, one per stage
  static constexpr int kBytes = kBars + 8 * (1 + kStages);
  static constexpr int kAlloc = kBytes + 1024;  // slack to align the base
};

// S and dP of one tile (this thread's rows r0 and r0 + 8, columns
// c0 + 8 j + {0, 1}) into dS, in place of dP.
template <bool kMask>
__device__ __forceinline__ void ds_tile(const float (&s)[32], float (&dp)[32],
                                        const float (&lse_log2)[2], const float (&delta)[2],
                                        int r0, int c0, int tk, bool causal, float scale,
                                        float scale_log2) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int half = (i >> 1) & 1;
    float p = hopper::ex2(fmaf(s[i], scale_log2, -lse_log2[half]));
    if constexpr (kMask) {
      const int col = c0 + 8 * (i >> 2) + (i & 1), row = r0 + 8 * half;
      if (col >= tk || (causal && row < col)) p = 0.f;
    }
    dp[i] = p * (dp[i] - delta[half]) * scale;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        const __grid_constant__ CUtensorMap do_map, const Args a) {
  using L = Smem<D>;
  constexpr int kAtoms = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = hopper::smem_addr(smem);
  const uint32_t q_s = base + L::kQ, do_s = base + L::kDO;
  const uint32_t q_bar = base + L::kBars;
  auto k_s = [&](int st) { return base + L::kK + st * L::kTileBytes; };
  auto v_s = [&](int st) { return base + L::kV + st * L::kTileBytes; };
  auto full = [&](int st) { return base + L::kBars + 8 * (1 + st); };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // Longest causal rows first, so the heaviest blocks start earliest.
  const int qt = a.n_qtiles - 1 - static_cast<int>(blockIdx.x % a.n_qtiles);
  const int bh = static_cast<int>(blockIdx.x / a.n_qtiles);
  const int b = bh / a.heads, h = bh % a.heads;
  const int m0 = qt * kTile;
  const int n_end = a.causal ? min(a.tk, m0 + kTile) : a.tk;
  const int n_tiles = (n_end + kTile - 1) / kTile;

  // Thread 0 copies key tile ``tile`` (K and V) into stage st, if it exists.
  auto load_kv = [&](int st, int tile) {
    if (tid == 0 && tile < n_tiles) {
      hopper::mbar_expect_tx(full(st), 2 * L::kTileBytes);
      hopper::tma_load_tile<D>(k_s(st), &k_map, full(st), b, h, tile * kTile);
      hopper::tma_load_tile<D>(v_s(st), &v_map, full(st), b, h, tile * kTile);
    }
  };
  if (tid == 0) {
    hopper::mbar_init(q_bar, 1);
    for (int st = 0; st < kStages; ++st) hopper::mbar_init(full(st), 1);
    hopper::mbar_fence_init();
    hopper::mbar_expect_tx(q_bar, 2 * L::kTileBytes);
    hopper::tma_load_tile<D>(q_s, &q_map, q_bar, b, h, m0);
    hopper::tma_load_tile<D>(do_s, &do_map, q_bar, b, h, m0);
  }
  for (int st = 0; st < kStages; ++st) load_kv(st, st);

  // This thread's rows r0 and r0 + 8: LSE (scaled by log2(e)) and delta;
  // rows past Tq get 0 (their q and dO are zero, so their dS is too).
  const int r0 = m0 + 16 * warp + lane / 4;
  float lse_log2[2], delta[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = r0 + 8 * half;
    const long long i = static_cast<long long>(bh) * a.tq + t;
    lse_log2[half] = t < a.tq ? a.lse[i] * hopper::kLog2e : 0.f;
    delta[half] = t < a.tq ? a.delta[i] : 0.f;
  }
  const float scale_log2 = a.scale * hopper::kLog2e;
  float dq[kAtoms][32];
#pragma unroll
  for (int atom = 0; atom < kAtoms; ++atom)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[atom][i] = 0.f;
  __syncthreads();  // the barriers are initialised

  hopper::mbar_wait(q_bar, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages, n0 = it * kTile;
    hopper::mbar_wait(full(st), (it / kStages) & 1);

    float s[32], dp[32];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::Wgmma<T>::ss(s, hopper::desc_k_major(q_s, kk),
                           hopper::desc_k_major(k_s(st), kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::Wgmma<T>::ss(dp, hopper::desc_k_major(do_s, kk),
                           hopper::desc_k_major(v_s(st), kk), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    hopper::fence_regs(dp);

    const int c0 = n0 + 2 * (lane % 4);
    if ((a.causal && n0 + kTile - 1 > m0) || n0 + kTile > a.tk) {
      ds_tile<true>(s, dp, lse_log2, delta, r0, c0, a.tk, a.causal, a.scale, scale_log2);
    } else {
      ds_tile<false>(s, dp, lse_log2, delta, r0, c0, a.tk, a.causal, a.scale, scale_log2);
    }
    uint32_t ds[16];
    hopper::acc_to_a<T>(dp, ds);

    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
      for (int atom = 0; atom < kAtoms; ++atom)
        hopper::Wgmma<T>::rs(dq[atom], ds + 4 * kk,
                             hopper::desc_mn_major(k_s(st), atom, kk), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int atom = 0; atom < kAtoms; ++atom) hopper::fence_regs(dq[atom]);
    hopper::fence_regs(ds);

    __syncthreads();  // every warp is done with this stage: refill it
    load_kv(st, it + kStages);
  }

  const float one[2] = {1.f, 1.f};
  T* dqg = static_cast<T*>(a.dq) + b * a.dq_sb + h * a.dq_sh;
  hopper::store_tile<T, D>(dq, one, smem + L::kQ, dqg, a.dq_st, m0, a.tq);
}

template <typename T, int D>
cudaError_t launch(const Args& a, const void* const (&ptrs)[4],
                   const long long (&strides)[4][3], int batch, int dtype,
                   unsigned int n_blocks, cudaStream_t stream) {
  CUtensorMap maps[4];
  const int seq[4] = {a.tq, a.tk, a.tk, a.tq};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err = hopper::make_map(&maps[i], ptrs[i], dtype, batch, seq[i], a.heads, D,
                                             strides[i][0], strides[i][1], strides[i][2]);
    if (err != cudaSuccess) return err;
  }
  constexpr int smem = Smem<D>::kAlloc;
  auto kernel = flash_bwd_dq_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<n_blocks, kThreads, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 1 float16, 2 bfloat16 (fp32 takes ray_tpu_torch_flash_bwd_dq_fp32
// in flash_bwd.cu). Strides are in elements; q, k, v and dout must have a
// 16-byte aligned base, a contiguous head_dim axis and strides that are
// multiples of 16 bytes (TMA); dq must be contiguous (16-byte stores); lse
// and delta are contiguous [B*H, Tq] f32. Returns a cudaError_t (0 on
// success).
extern "C" int ray_tpu_torch_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout, const float* lse,
    const float* delta, void* dq,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long do_sb, long long do_st, long long do_sh,
    long long dq_sb, long long dq_st, long long dq_sh,
    int batch, int heads, int tq, int tk, int head_dim, int dtype, int causal,
    float scale, void* stream) {
  const int n_qtiles = (tq + kTile - 1) / kTile;
  const long long n_blocks = static_cast<long long>(n_qtiles) * batch * heads;
  if (n_blocks <= 0 || n_blocks > INT_MAX || tk <= 0) return cudaErrorInvalidValue;
  const Args a{lse, delta, dq, dq_sb, dq_st, dq_sh, heads, tq, tk, n_qtiles, causal, scale};
  const void* const ptrs[4] = {q, k, v, dout};
  const long long strides[4][3] = {
      {q_sb, q_st, q_sh}, {k_sb, k_st, k_sh}, {v_sb, v_st, v_sh}, {do_sb, do_st, do_sh}};
  const auto s = static_cast<cudaStream_t>(stream);
  const auto nb = static_cast<unsigned int>(n_blocks);
  const bool fp16 = dtype == 1;
  if (dtype != 1 && dtype != 2) return cudaErrorInvalidValue;
  if (head_dim == 64)
    return fp16 ? launch<__half, 64>(a, ptrs, strides, batch, dtype, nb, s)
                : launch<__nv_bfloat16, 64>(a, ptrs, strides, batch, dtype, nb, s);
  if (head_dim == 128)
    return fp16 ? launch<__half, 128>(a, ptrs, strides, batch, dtype, nb, s)
                : launch<__nv_bfloat16, 128>(a, ptrs, strides, batch, dtype, nb, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* ray_tpu_torch_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
