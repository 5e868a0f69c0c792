// Flash-attention forward for Hopper (sm_90a).
//
// Counterpart of ray_tpu/ops/attention.py:_flash_fwd_kernel (the Pallas TPU
// kernel launched by _flash_forward). Same function: for each (batch, head)
// and query row, O = softmax(q.k^T * scale) . v with an online softmax over
// key tiles, the causal mask on global positions, and the row log-sum-exp
// LSE = m + log(l) as a second output. Same numerics as the reference:
//   - S = (q.k^T) * scale, the scale applied to the f32 product (folded
//     with log2(e) into one factor for exp2; LSE stays in natural log);
//   - masked scores are -1e30 (never -inf) and their probabilities exactly 0;
//   - the running max m, denominator l and accumulator stay in f32;
//   - p is rounded to v's type before the p.v product (the sum l uses the
//     unrounded p), and O = acc / max(l, 1e-30).
// On the wgmma path exp2 is one ex2.approx.ftz (hopper.cuh): a p below
// 2^-126 becomes 0 where the reference keeps a denormal.
//
// What bounds it on this card. At GPT-2 124M's shape (B=4, T=1024, H=12,
// D=64, bf16, causal) the function must move ~25 MB (q, k, v read once, O
// and LSE written once): ~7.6 us at 3.35 TB/s; its ~6.4 GFLOP take ~6.5 us
// at 989 TFLOP/s. So the bytes bound it, with the tensor-core work close
// behind; only wgmma reaches the tensor cores' full rate, and the O(T^2)
// scores must never leave the SM.
//
// bf16/fp16: flash_fwd_kernel. One warpgroup (128 threads) per
// (batch*head, 64-row query tile), heaviest causal tiles first. The q tile
// is loaded once; 64-key tiles of K and V come through a ring of kStages
// shared-memory stages by TMA (one thread issues the copies, an mbarrier
// per stage reports them), so the next tile's copy runs under this tile's
// products. S = Q.K^T is wgmma from shared memory into registers; the
// online softmax runs on that accumulator fragment in registers (a row's
// max and sum reduce across the 4 lanes that hold it), the mask only on
// the diagonal and ragged tiles; p, rounded to 16 bits in registers, is
// the A operand of O += P.V (wgmma, V MN-major from shared memory), and O
// stays in registers until the epilogue writes O / l with 16-byte stores.
// TMA reads q, k and v in their public [B, T, H, D] layout through
// strides (no transposed copies) and fills rows past T with zeros. Tiles
// wholly above the diagonal are skipped.
//
// fp32: flash_fwd_fp32_kernel keeps full fp32 math on the FMA units (a TF32
// product would not match the reference; wgmma has no fp32 form): scalar
// tile loads, one warp per 16 rows, the softmax one row at a time.
//
// Built by ray_tpu_torch/ops/_kernels.py with nvcc into a shared library
// with a plain C interface; every launch returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

#include "hopper.cuh"

namespace {

constexpr int kBlockM = 64;    // query rows per block
constexpr int kBlockN = 64;    // keys per tile
constexpr int kThreads = 128;  // four warps; one warpgroup on the wgmma path
constexpr float kMaskValue = -1e30f;  // the reference's _NEG_INF

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [B*H, Tq] or null
  long long q_sb, q_st, q_sh;  // strides in elements: batch, position, head
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long o_sb, o_st, o_sh;
  int heads, tq, tk, n_qtiles, causal;
  float scale;
};

// ---------------------------------------------------------------------------
// bf16 / fp16: wgmma, TMA, softmax in registers
// ---------------------------------------------------------------------------

constexpr int kStages = 2;
static_assert(kBlockM == hopper::kRows && kBlockN == hopper::kRows, "64-row tiles");

// Shared memory: the q tile, then kStages (K, V) pairs, then the barriers;
// every tile 1024-byte aligned (the 128-byte swizzle's period).
template <int D>
struct Smem {
  static constexpr int kTile = kBlockN * D * 2;  // bytes of one 64-row 16-bit tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBars = kV + kStages * kTile;  // q barrier, then one per stage
  static constexpr int kBytes = kBars + 8 * (1 + kStages);
  static constexpr int kAlloc = kBytes + 1024;  // slack to align the base
};

// One tile's online-softmax step on the S accumulator ``s`` of this
// thread (rows r0 and r0 + 8, columns c0 + 8 j + {0, 1}): s becomes p,
// the row max m (scaled by log2(e)) and this thread's share of the row
// sum l are updated, and corr receives each row's rescale factor.
template <bool kMask>
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], int r0, int c0, int tk,
                                             bool causal, float scale_log2) {
  constexpr float kMask2 = kMaskValue * hopper::kLog2e;
  float mx[2] = {kMask2, kMask2};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int half = (i >> 1) & 1;
    float x = s[i] * scale_log2;
    if constexpr (kMask) {
      const int col = c0 + 8 * (i >> 2) + (i & 1), row = r0 + 8 * half;
      if (col >= tk || (causal && row < col)) x = kMask2;
    }
    s[i] = x;
    mx[half] = fmaxf(mx[half], x);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
    mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
    const float m_new = fmaxf(m[half], mx[half]);
    corr[half] = hopper::ex2(m[half] - m_new);
    m[half] = m_new;
    l[half] *= corr[half];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int half = (i >> 1) & 1;
    float p = hopper::ex2(s[i] - m[half]);
    if constexpr (kMask) {
      const int col = c0 + 8 * (i >> 2) + (i & 1), row = r0 + 8 * half;
      if (col >= tk || (causal && row < col)) p = 0.f;
    }
    s[i] = p;
    l[half] += p;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map, const Args a) {
  using L = Smem<D>;
  constexpr int kAtoms = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = hopper::smem_addr(smem);
  const uint32_t q_s = base + L::kQ;
  const uint32_t q_bar = base + L::kBars;
  auto k_s = [&](int st) { return base + L::kK + st * L::kTile; };
  auto v_s = [&](int st) { return base + L::kV + st * L::kTile; };
  auto full = [&](int st) { return base + L::kBars + 8 * (1 + st); };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // Longest causal rows first, so the heaviest blocks start earliest.
  const int qt = a.n_qtiles - 1 - static_cast<int>(blockIdx.x % a.n_qtiles);
  const int bh = static_cast<int>(blockIdx.x / a.n_qtiles);
  const int b = bh / a.heads, h = bh % a.heads;
  const int m0 = qt * kBlockM;
  const int n_end = a.causal ? min(a.tk, m0 + kBlockM) : a.tk;
  const int n_tiles = (n_end + kBlockN - 1) / kBlockN;

  // Thread 0 copies key tile ``tile`` (K and V) into stage st, if it exists.
  auto load_kv = [&](int st, int tile) {
    if (tid == 0 && tile < n_tiles) {
      hopper::mbar_expect_tx(full(st), 2 * L::kTile);
      hopper::tma_load_tile<D>(k_s(st), &k_map, full(st), b, h, tile * kBlockN);
      hopper::tma_load_tile<D>(v_s(st), &v_map, full(st), b, h, tile * kBlockN);
    }
  };
  if (tid == 0) {
    hopper::mbar_init(q_bar, 1);
    for (int st = 0; st < kStages; ++st) hopper::mbar_init(full(st), 1);
    hopper::mbar_fence_init();
    hopper::mbar_expect_tx(q_bar, L::kTile);
    hopper::tma_load_tile<D>(q_s, &q_map, q_bar, b, h, m0);
  }
  for (int st = 0; st < kStages; ++st) load_kv(st, st);
  __syncthreads();

  const int r0 = m0 + 16 * warp + lane / 4;  // this thread's rows: r0, r0 + 8
  const float scale_log2 = a.scale * hopper::kLog2e;
  constexpr float kMask2 = kMaskValue * hopper::kLog2e;
  float o[kAtoms][32];
#pragma unroll
  for (int atom = 0; atom < kAtoms; ++atom)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[atom][i] = 0.f;
  float m[2] = {kMask2, kMask2}, l[2] = {0.f, 0.f};

  hopper::mbar_wait(q_bar, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages, n0 = it * kBlockN;
    hopper::mbar_wait(full(st), (it / kStages) & 1);

    float s[32];  // S = Q.K^T
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::Wgmma<T>::ss(s, hopper::desc_k_major(q_s, kk),
                           hopper::desc_k_major(k_s(st), kk), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);

    float corr[2];
    const int c0 = n0 + 2 * (lane % 4);
    if ((a.causal && n0 + kBlockN - 1 > m0) || n0 + kBlockN > a.tk) {
      softmax_tile<true>(s, m, l, corr, r0, c0, a.tk, a.causal, scale_log2);
    } else {
      softmax_tile<false>(s, m, l, corr, r0, c0, a.tk, a.causal, scale_log2);
    }
    uint32_t p[16];
    hopper::acc_to_a<T>(s, p);
#pragma unroll
    for (int atom = 0; atom < kAtoms; ++atom)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[atom][i] *= corr[(i >> 1) & 1];

    hopper::wgmma_fence();  // O += P.V
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk)
#pragma unroll
      for (int atom = 0; atom < kAtoms; ++atom)
        hopper::Wgmma<T>::rs(o[atom], p + 4 * kk,
                             hopper::desc_mn_major(v_s(st), atom, kk), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int atom = 0; atom < kAtoms; ++atom) hopper::fence_regs(o[atom]);
    hopper::fence_regs(p);

    __syncthreads();  // every warp is done with this stage: refill it
    load_kv(st, it + kStages);
  }

  float denom[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
    denom[half] = fmaxf(l[half], 1e-30f);
  }
  if (a.lse != nullptr && lane % 4 == 0) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = r0 + 8 * half;
      if (t < a.tq)
        a.lse[static_cast<long long>(bh) * a.tq + t] = m[half] * hopper::kLn2 + logf(denom[half]);
    }
  }
  T* og = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;
  hopper::store_tile<T, D>(o, denom, smem + L::kQ, og, a.o_st, m0, a.tq);
}

template <typename T, int D>
cudaError_t launch_tc(const Args& a, int batch, int dtype, unsigned int n_blocks,
                      cudaStream_t stream) {
  CUtensorMap maps[3];
  const void* ptrs[3] = {a.q, a.k, a.v};
  const long long strides[3][3] = {{a.q_sb, a.q_st, a.q_sh},
                                   {a.k_sb, a.k_st, a.k_sh},
                                   {a.v_sb, a.v_st, a.v_sh}};
  const int seq[3] = {a.tq, a.tk, a.tk};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err = hopper::make_map(&maps[i], ptrs[i], dtype, batch, seq[i], a.heads, D,
                                             strides[i][0], strides[i][1], strides[i][2]);
    if (err != cudaSuccess) return err;
  }
  constexpr int smem = Smem<D>::kAlloc;
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<n_blocks, kThreads, smem, stream>>>(maps[0], maps[1], maps[2], a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: the FMA units
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = kBlockM / kWarps;  // 16

constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

// Shared memory: q, k, v and p tiles; the odd pitch of the q and k tiles
// staggers the column reads across banks.
template <int D>
struct Fp32Layout {
  static constexpr int kLdQK = D + 1;
  static constexpr int kLdV = D;
  static constexpr int kLdP = kBlockN;
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = align128(kQ + sizeof(float) * kBlockM * kLdQK);
  static constexpr size_t kV = align128(kK + sizeof(float) * kBlockN * kLdQK);
  static constexpr size_t kP = align128(kV + sizeof(float) * kBlockN * kLdV);
  static constexpr size_t kBytes = align128(kP + sizeof(float) * kBlockM * kLdP);
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_fp32_kernel(const Args a) {
  using L = Fp32Layout<D>;
  constexpr int kCols = D / 32;  // accumulator columns each lane owns
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + L::kQ);
  float* ks = reinterpret_cast<float*>(smem + L::kK);
  float* vs = reinterpret_cast<float*>(smem + L::kV);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // Longest causal rows first, so the heaviest blocks start earliest.
  const int qt = a.n_qtiles - 1 - static_cast<int>(blockIdx.x % a.n_qtiles);
  const int bh = static_cast<int>(blockIdx.x / a.n_qtiles);
  const int b = bh / a.heads;
  const int h = bh % a.heads;
  const int m0 = qt * kBlockM;

  const float* qg = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kg = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* vg = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;
  float* og = static_cast<float*>(a.o) + b * a.o_sb + h * a.o_sh;

  for (int i = tid; i < kBlockM * D; i += kThreads) {
    const int r = i / D, c = i % D, t = m0 + r;
    qs[r * L::kLdQK + c] = t < a.tq ? qg[t * a.q_st + c] : 0.f;
  }

  float* ps = reinterpret_cast<float*>(smem + L::kP) + warp * kRowsPerWarp * L::kLdP;
  const int row0 = m0 + warp * kRowsPerWarp;

  float acc[kRowsPerWarp][kCols];
  float m_i[kRowsPerWarp];
  float l_i[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m_i[r] = kMaskValue;
    l_i[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  const int n_end = a.causal ? min(a.tk, m0 + kBlockM) : a.tk;
  for (int n0 = 0; n0 < n_end; n0 += kBlockN) {
    __syncthreads();  // the previous tile is consumed (and the q tile written)
    for (int i = tid; i < kBlockN * D; i += kThreads) {
      const int r = i / D, c = i % D, t = n0 + r;
      const bool in = t < a.tk;
      ks[r * L::kLdQK + c] = in ? kg[t * a.k_st + c] : 0.f;
      vs[r * L::kLdV + c] = in ? vg[t * a.v_st + c] : 0.f;
    }
    __syncthreads();

    // Scores of this warp's 16 rows against the tile's 64 keys; lane j
    // holds keys j and j + 32 of every row.
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r][0] = s[r][1] = 0.f;
    const float* qw = qs + warp * kRowsPerWarp * L::kLdQK;
#pragma unroll 4
    for (int kk = 0; kk < D; ++kk) {
      const float k0 = ks[lane * L::kLdQK + kk];
      const float k1 = ks[(lane + 32) * L::kLdQK + kk];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float qv = qw[r * L::kLdQK + kk];
        s[r][0] = fmaf(qv, k0, s[r][0]);
        s[r][1] = fmaf(qv, k1, s[r][1]);
      }
    }

    // Online softmax, one row at a time across the warp.
    float corr[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qi = row0 + r;
      float x[2];
      bool ok[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kj = n0 + lane + 32 * j;
        ok[j] = kj < a.tk && (!a.causal || qi >= kj);
        x[j] = ok[j] ? s[r][j] * a.scale : kMaskValue;
      }
      float mx = fmaxf(x[0], x[1]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[r], mx);
      const float p0 = ok[0] ? expf(x[0] - m_new) : 0.f;
      const float p1 = ok[1] ? expf(x[1] - m_new) : 0.f;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      corr[r] = expf(m_i[r] - m_new);
      l_i[r] = l_i[r] * corr[r] + sum;
      m_i[r] = m_new;
      ps[r * L::kLdP + lane] = p0;
      ps[r * L::kLdP + lane + 32] = p1;
    }
    __syncwarp();

    // acc = acc * corr + p . v
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= corr[r];
    }
#pragma unroll 4
    for (int j = 0; j < kBlockN; ++j) {
      float vv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = vs[j * L::kLdV + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float pj = ps[r * L::kLdP + j];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(pj, vv[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int t = row0 + r;
    if (t >= a.tq) continue;
    const float denom = fmaxf(l_i[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) og[t * a.o_st + lane + 32 * c] = acc[r][c] / denom;
    if (a.lse != nullptr && lane == 0)
      a.lse[static_cast<long long>(bh) * a.tq + t] = m_i[r] + logf(denom);
  }
}

template <int D>
cudaError_t launch_fp32(const Args& a, unsigned int n_blocks, cudaStream_t stream) {
  constexpr size_t smem = Fp32Layout<D>::kBytes;
  auto kernel = flash_fwd_fp32_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<n_blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const Args& a, int batch, int dtype, unsigned int n_blocks,
                     cudaStream_t stream) {
  switch (dtype) {
    case 0: return launch_fp32<D>(a, n_blocks, stream);
    case 1: return launch_tc<__half, D>(a, batch, dtype, n_blocks, stream);
    case 2: return launch_tc<__nv_bfloat16, D>(a, batch, dtype, n_blocks, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16. Strides are in elements; the
// head_dim axis must be contiguous. For fp16/bf16 q, k and v must have a
// 16-byte aligned base and strides that are multiples of 16 bytes (TMA),
// and o must be contiguous (16-byte stores). Returns a cudaError_t (0 on
// success).
extern "C" int ray_tpu_torch_flash_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long o_sb, long long o_st, long long o_sh,
    int batch, int heads, int tq, int tk, int head_dim, int dtype, int causal,
    float scale, void* stream) {
  const int n_qtiles = (tq + kBlockM - 1) / kBlockM;
  const long long n_blocks = static_cast<long long>(n_qtiles) * batch * heads;
  if (n_blocks <= 0 || n_blocks > INT_MAX || tk <= 0) return cudaErrorInvalidValue;
  const Args a{q, k, v, o, lse,
               q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_st, o_sh,
               heads, tq, tk, n_qtiles, causal, scale};
  const auto s = static_cast<cudaStream_t>(stream);
  const auto nb = static_cast<unsigned int>(n_blocks);
  if (head_dim == 64) return launch_d<64>(a, batch, dtype, nb, s);
  if (head_dim == 128) return launch_d<128>(a, batch, dtype, nb, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* ray_tpu_torch_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
