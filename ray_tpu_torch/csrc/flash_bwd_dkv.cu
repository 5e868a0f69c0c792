// Flash-attention backward, dK/dV pass, for Hopper (sm_90a): bf16 and fp16.
//
// Counterpart of ray_tpu/ops/attention.py:_flash_bwd_dkv_kernel (the
// Pallas TPU kernel launched by _flash_backward; shared math _bwd_block).
// Same function: with the forward's row log-sum-exp LSE and delta =
// rowsum(dO * O), for every attended (query, key) pair
//   p  = exp(s - LSE),  s = (q.k^T) * scale  (masked pairs: p exactly 0)
//   dP = dO . v^T                             (f32)
//   dS = p * (dP - delta) * scale
//   dV = sum_q p^T . dO,  dK = sum_q dS^T . q
// with both sums accumulated in f32 and written in k's and v's type. The
// tensor cores take 16-bit operands, so p and dS are rounded to the input
// type before the dV and dK products, where the TPU kernel keeps them in
// f32; dS is formed from the unrounded p. The scale is folded with
// log2(e) into one factor for exp2, which is one ex2.approx.ftz
// (hopper.cuh: a p below 2^-126 becomes 0); LSE stays in natural log.
// delta is computed outside the kernel, as in the reference
// (ray_tpu_torch/ops/attention.py:_flash_backward). The fp32 pass is in
// flash_bwd.cu.
//
// What bounds it on this card. Per attended (q, k) pair and (batch, head)
// the pass does 4 products of length D (S, dP, dV, dK: 8*D operations)
// against q, k, v, dO read once and dK, dV written once. At GPT-2 124M's
// training shape (B=8, T=1024, H=12, D=64, bf16, causal) it must move
// ~76 MB (23 us at 3.35 TB/s) and do ~26 GFLOP (26 us at 989 TFLOP/s):
// the tensor cores bound it, with the bytes close behind, so all four
// products run on wgmma and p, dS never leave the registers.
//
// The design. One warpgroup (128 threads) per (batch*head, 64-key tile),
// key tile 0 (the heaviest under the causal mask) first in each
// (batch, head), looping over the query tiles at or below the diagonal:
// the TPU's two-pass split, so no atomics and the same gradients from run
// to run. The K and V tiles are loaded once by TMA; 64-query tiles of Q
// and dO come through a ring of kStages shared-memory stages by TMA (one
// thread issues the copies, an mbarrier per stage reports them), so the
// next tile's copy runs under this tile's products. The products work on
// the transposed tiles, keys as the accumulator's rows:
//   S^T  = K . Q^T    wgmma, K and Q K-major from shared memory
//   dP^T = V . dO^T   wgmma, V and dO K-major from shared memory
//   dV  += p^T . dO   wgmma, p^T from registers, dO MN-major
//   dK  += dS^T . Q   wgmma, dS^T from registers, Q MN-major
// so LSE and delta belong to the accumulator's columns: each stage holds
// its 64 queries' LSE * log2(e) and delta in shared memory, filled with
// plain loads (a [B*H, Tq] row is no TMA source unless Tq % 4 == 0) and
// read as broadcasts. S^T and dP^T run as one wgmma group; p^T is formed
// in place of S^T and dS^T (from the f32 p^T) in place of dP^T, both
// packed to 16-bit A fragments in registers, and dV and dK run as a
// second group. Three blocks share an SM at D=64 and two at D=128 (by
// registers and shared memory), so one block's products run under
// another's elementwise work. The mask runs only on the diagonal tile
// and the ragged last query tile. dK and dV stay in registers across the
// query loop until the epilogue writes them with 16-byte stores. TMA reads q,
// k, v and dO in their public [B, T, H, D] layout through strides and
// fills rows past T with zeros. A causal key tile that lies beyond every
// query (Tq < Tk) issues no copy and writes zeros.
//
// Built by ray_tpu_torch/ops/_kernels.py with nvcc into a shared library
// with a plain C interface; every launch returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>

#include "hopper.cuh"

namespace {

constexpr int kTile = 64;      // keys per block; queries per tile
constexpr int kThreads = 128;  // one warpgroup; four warps
constexpr int kStages = 2;
static_assert(kTile == hopper::kRows, "64-row tiles");
static_assert(kThreads == 2 * kTile, "one thread per LSE and per delta of a tile");

struct Args {
  const float* lse;    // [B*H, Tq]
  const float* delta;  // [B*H, Tq]
  void* dk;
  void* dv;
  long long dk_sb, dk_st, dk_sh;  // strides in elements: batch, position, head
  long long dv_sb, dv_st, dv_sh;
  int heads, tq, tk, n_ktiles, causal;
  float scale;
};

// Shared memory: the K and V tiles, kStages (Q, dO) pairs, each stage's
// LSE * log2(e) and delta (64 floats each), the barriers; every tile
// 1024-byte aligned (the 128-byte swizzle's period).
template <int D>
struct Smem {
  static constexpr int kTileBytes = kTile * D * 2;
  static constexpr int kStatBytes = 2 * kTile * 4;
  static constexpr int kK = 0;
  static constexpr int kV = kTileBytes;
  static constexpr int kQ = 2 * kTileBytes;
  static constexpr int kDO = kQ + kStages * kTileBytes;
  static constexpr int kStats = kDO + kStages * kTileBytes;
  static constexpr int kBars = kStats + kStages * kStatBytes;  // K/V barrier, one per stage
  static constexpr int kBytes = kBars + 8 * (1 + kStages);
  static constexpr int kAlloc = kBytes + 1024;  // slack to align the base
};

// S^T of one tile into p^T, in place. This thread holds keys key0 and
// key0 + 8 (global) and the tile's queries 8 j + 2 t + {0, 1} (local;
// global from q0); ``lse_log2`` is the tile's LSE * log2(e).
template <bool kMask>
__device__ __forceinline__ void p_tile(float (&s)[32], const float* lse_log2, int key0, int q0,
                                       int tq, bool causal, float scale_log2) {
  const int t4 = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(lse_log2 + 8 * j + 2 * t4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      float p = hopper::ex2(fmaf(s[i], scale_log2, -((e & 1) ? l.y : l.x)));
      if constexpr (kMask) {
        const int q = q0 + 8 * j + 2 * t4 + (e & 1), key = key0 + 8 * (e >> 1);
        if (q >= tq || (causal && q < key)) p = 0.f;
      }
      s[i] = p;
    }
  }
}

// dP^T into dS^T, in place, from the f32 p^T of the same tile.
__device__ __forceinline__ void ds_tile(const float (&p)[32], float (&dp)[32],
                                        const float* delta, float scale) {
  const int t4 = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 d = *reinterpret_cast<const float2*>(delta + 8 * j + 2 * t4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      dp[i] = p[i] * (dp[i] - ((e & 1) ? d.y : d.x)) * scale;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap do_map, const Args a) {
  using L = Smem<D>;
  constexpr int kAtoms = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = hopper::smem_addr(smem);
  const uint32_t k_s = base + L::kK, v_s = base + L::kV;
  const uint32_t kv_bar = base + L::kBars;
  auto q_s = [&](int st) { return base + L::kQ + st * L::kTileBytes; };
  auto do_s = [&](int st) { return base + L::kDO + st * L::kTileBytes; };
  auto full = [&](int st) { return base + L::kBars + 8 * (1 + st); };
  auto stats = [&](int st) {  // LSE * log2(e) [64], then delta [64]
    return reinterpret_cast<float*>(smem + L::kStats + st * L::kStatBytes);
  };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // Key tile 0 meets the most causal query tiles: it starts first.
  const int kt = static_cast<int>(blockIdx.x % a.n_ktiles);
  const int bh = static_cast<int>(blockIdx.x / a.n_ktiles);
  const int b = bh / a.heads, h = bh % a.heads;
  const int n0 = kt * kTile;
  // Query tiles wholly above the diagonal hold no query that attends to
  // these keys; past every query (causal, Tq < Tk) there is no tile.
  const int m_begin = a.causal ? n0 : 0;
  const int n_tiles = a.tq > m_begin ? (a.tq - m_begin + kTile - 1) / kTile : 0;

  // Query tile ``tile`` into stage st, if it exists: thread 0 copies Q
  // and dO; threads 0-63 load its LSE (times log2(e)), 64-127 its delta,
  // 0 past Tq (those queries' q and dO are zero and their p is masked).
  auto load_q = [&](int st, int tile) {
    if (tile >= n_tiles) return;
    const int m0 = m_begin + tile * kTile;
    if (tid == 0) {
      hopper::mbar_expect_tx(full(st), 2 * L::kTileBytes);
      hopper::tma_load_tile<D>(q_s(st), &q_map, full(st), b, h, m0);
      hopper::tma_load_tile<D>(do_s(st), &do_map, full(st), b, h, m0);
    }
    const int t = m0 + tid % kTile;
    const long long i = static_cast<long long>(bh) * a.tq + t;
    stats(st)[tid] = t >= a.tq ? 0.f : tid < kTile ? a.lse[i] * hopper::kLog2e : a.delta[i];
  };
  if (tid == 0) {
    hopper::mbar_init(kv_bar, 1);
    for (int st = 0; st < kStages; ++st) hopper::mbar_init(full(st), 1);
    hopper::mbar_fence_init();
    if (n_tiles > 0) {
      hopper::mbar_expect_tx(kv_bar, 2 * L::kTileBytes);
      hopper::tma_load_tile<D>(k_s, &k_map, kv_bar, b, h, n0);
      hopper::tma_load_tile<D>(v_s, &v_map, kv_bar, b, h, n0);
    }
  }
  for (int st = 0; st < kStages; ++st) load_q(st, st);

  const int key0 = n0 + 16 * warp + lane / 4;  // this thread's keys: key0, key0 + 8
  const float scale_log2 = a.scale * hopper::kLog2e;
  float dk[kAtoms][32], dv[kAtoms][32];
#pragma unroll
  for (int atom = 0; atom < kAtoms; ++atom)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[atom][i] = dv[atom][i] = 0.f;
  __syncthreads();  // the barriers are initialised, the first stats loaded

  if (n_tiles > 0) hopper::mbar_wait(kv_bar, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages, m0 = m_begin + it * kTile;
    hopper::mbar_wait(full(st), (it / kStages) & 1);
    const float* lse_log2 = stats(st);

    float s[32], dp[32];  // S^T, dP^T: keys x queries
    uint32_t pt[16], ds[16];  // p^T, dS^T as 16-bit A fragments
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::Wgmma<T>::ss(s, hopper::desc_k_major(k_s, kk),
                           hopper::desc_k_major(q_s(st), kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::Wgmma<T>::ss(dp, hopper::desc_k_major(v_s, kk),
                           hopper::desc_k_major(do_s(st), kk), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    hopper::fence_regs(dp);

    if ((a.causal && m0 == n0) || m0 + kTile > a.tq) {
      p_tile<true>(s, lse_log2, key0, m0, a.tq, a.causal, scale_log2);
    } else {
      p_tile<false>(s, lse_log2, key0, m0, a.tq, a.causal, scale_log2);
    }
    hopper::acc_to_a<T>(s, pt);
    ds_tile(s, dp, lse_log2 + kTile, a.scale);
    hopper::acc_to_a<T>(dp, ds);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)  // dV += p^T . dO
#pragma unroll
      for (int atom = 0; atom < kAtoms; ++atom)
        hopper::Wgmma<T>::rs(dv[atom], pt + 4 * kk, hopper::desc_mn_major(do_s(st), atom, kk), 1);
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)  // dK += dS^T . Q
#pragma unroll
      for (int atom = 0; atom < kAtoms; ++atom)
        hopper::Wgmma<T>::rs(dk[atom], ds + 4 * kk, hopper::desc_mn_major(q_s(st), atom, kk), 1);
    hopper::wgmma_commit();

    hopper::wgmma_wait<0>();
#pragma unroll
    for (int atom = 0; atom < kAtoms; ++atom) {
      hopper::fence_regs(dk[atom]);
      hopper::fence_regs(dv[atom]);
    }
    hopper::fence_regs(pt);
    hopper::fence_regs(ds);

    __syncthreads();  // every warp is done with this stage: refill it
    load_q(st, it + kStages);
  }

  // The loop's last barrier (or, with no tile, the one above it) follows
  // the last product; no copy is in flight, so the K and V tiles stage
  // dK and dV.
  const float one[2] = {1.f, 1.f};
  T* dkg = static_cast<T*>(a.dk) + b * a.dk_sb + h * a.dk_sh;
  T* dvg = static_cast<T*>(a.dv) + b * a.dv_sb + h * a.dv_sh;
  hopper::store_tile<T, D>(dk, one, smem + L::kK, dkg, a.dk_st, n0, a.tk);
  hopper::store_tile<T, D>(dv, one, smem + L::kV, dvg, a.dv_st, n0, a.tk);
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
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<n_blocks, kThreads, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 1 float16, 2 bfloat16 (fp32 takes ray_tpu_torch_flash_bwd_dkv_fp32
// in flash_bwd.cu). Strides are in elements; q, k, v and dout must have a
// 16-byte aligned base, a contiguous head_dim axis and strides that are
// multiples of 16 bytes (TMA); dk and dv must be contiguous (16-byte
// stores); lse and delta are contiguous [B*H, Tq] f32. Needs Tq > 0 and
// Tk > 0. Returns a cudaError_t (0 on success).
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
  const int n_ktiles = (tk + kTile - 1) / kTile;
  const long long n_blocks = static_cast<long long>(n_ktiles) * batch * heads;
  if (n_blocks <= 0 || n_blocks > INT_MAX || tq <= 0) return cudaErrorInvalidValue;
  const Args a{lse, delta, dk, dv, dk_sb, dk_st, dk_sh, dv_sb, dv_st, dv_sh,
               heads, tq, tk, n_ktiles, causal, scale};
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
