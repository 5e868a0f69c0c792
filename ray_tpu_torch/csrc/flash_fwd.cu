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
// fp32: flash_fwd_fp32_kernel, every product on the tensor cores in
// 3xTF32 (mma.sync.m16n8k8 TF32; hi.lo + lo.hi + hi.hi of the operands'
// TF32 halves, in chains of two 8-deep steps promoted by f32 adds), with
// the building blocks and tile layout of tf32x3.cuh, which the fp32
// backward (flash_bwd.cu) shares. Its bound at GPT-2 124M's shape is
// 3 x 6.4e9 operations at the 495 TFLOP/s dense TF32 peak, 0.039 ms, above
// the bytes' 0.015 ms. One block of 8 warps per (batch*head, query tile),
// heaviest causal tiles first; key tiles wholly above the diagonal are
// skipped, masks apply only on diagonal and ragged tiles.
//  - Copies. One thread issues TMA loads (4-D fp32 maps over the public
//    [B, T, H, D] layout, 32-column boxes, 128-byte swizzle, zeros past
//    T). The q tile lands once; K and V tiles come through a ring of 2
//    stages, one mbarrier a stage and one __syncthreads a tile. Each tile
//    is split once into hi and lo planes as it lands; the next tile by
//    each warp as it finishes its products on this one.
//  - Products. S = Q.K^T reads both tiles along rows (product_rows, its
//    loop over the chains rolled: unrolled, it spills); O += P.V takes p,
//    split in registers, as the A operand and reads V along columns, rows
//    in the order 2t, 2t + 1 (product_cols).
//  - Softmax. Each warp owns 16 query rows and keeps its own running max
//    m, sum l and O over the keys it takes; p = expf(s * scale - m)
//    (natural exp as the reference has it, no ex2.approx), masked p
//    exactly 0, a row's max and sum reduced across the 4 lanes that hold
//    it; O leaves with 16-byte stores.
//  - Tiling (Fp32Smem). D = 64: 128 query rows a block, one warp each 16,
//    over whole 64-key tiles; 192 KB of shared memory. D = 128: 64 rows,
//    warps w and w + 4 sharing 16 and taking one half each of every 32-key
//    tile, the two halves of a row merged in a fixed order at the end (so
//    two launches give the same bits); 192 KB. On an H100 the 128-row
//    tiling was the faster of the two at D = 64; at D = 128 it leaves room
//    for 16-key tiles only and was the slower (PERF.md).
//
// Built by ray_tpu_torch/ops/_kernels.py with nvcc into a shared library
// with a plain C interface; every launch returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <type_traits>

#include "hopper.cuh"
#include "tf32x3.cuh"

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
// fp32: 3xTF32 on mma.sync (tf32x3.cuh), TMA, softmax in registers
// ---------------------------------------------------------------------------

// The fp32 tiling and key tiles by head_dim, and the shared memory: every
// plane 1024-byte aligned (the swizzle's period), q hi, q lo; kStages
// stages of K hi, K lo, V hi, V lo; the barriers (q, then one per stage).
//  D = 64: 128 query rows a block, each warp owning 16 of them over whole
//    64-key tiles; 2 x 32 KB + 2 stages x 4 x 16 KB = 192 KB.
//  D = 128: 64 query rows, warps w and w + 4 owning the same 16 and taking
//    one half each of every 32-key tile (128 rows would leave room for
//    16-key tiles only); 2 x 32 KB + 2 stages x 4 x 16 KB = 192 KB.
// After the loop the planes hold the epilogue: each part's O
// [kSplit][kOuter][D + 8] f32, its row max and sum [kSplit][kOuter] (m, l),
// and the rows' denominators [kOuter].
template <int D>
struct Fp32Smem {
  using Tile = std::conditional_t<D == 64, tf32x3::Tiling<128, 1>, tf32x3::Tiling<64, 2>>;
  static constexpr int kKeys = D == 64 ? 64 : 32;
  static constexpr int kQPlane = Tile::kOuter * D * 4;
  static constexpr int kKvPlane = kKeys * D * 4;
  static constexpr int kStage0 = 2 * kQPlane;
  static constexpr int kStageBytes = 4 * kKvPlane;
  static constexpr int kBars = kStage0 + kStages * kStageBytes;
  static constexpr int kBytes = kBars + 8 * (1 + kStages);
  static constexpr int kAlloc = kBytes + 1024;  // slack to align the base
  static constexpr int kPitch = D + 8;
  static constexpr int kStats = Tile::kSplit * Tile::kOuter * kPitch * 4;
  static constexpr int kDenom = kStats + Tile::kSplit * Tile::kOuter * 8;
  static_assert(kDenom + Tile::kOuter * 4 <= kBars, "the epilogue fits in the tile planes");
};

// One block of 8 warps per (batch*head, query tile), looping over the key
// tiles at or below the diagonal. Each warp owns 16 query rows and takes
// 1/kSplit of every key tile, with its own running max, sum and O; the
// parts of a row meet in the epilogue.
template <int D>
__global__ void __launch_bounds__(tf32x3::kThreads, 1)
    flash_fwd_fp32_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map, const Args a) {
  using L = Fp32Smem<D>;
  using Tile = typename L::Tile;
  constexpr int R = L::kKeys, kOuter = Tile::kOuter, kSplit = Tile::kSplit;
  constexpr int kBlocks = R / 8 / kSplit;  // 8-key blocks of S a warp holds
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = tf32x3::aligned_smem(smem_raw);
  const uint32_t base = hopper::smem_addr(smem);
  const uint32_t q_s = base, q_bar = base + L::kBars;
  auto stage = [&](int st) { return L::kStage0 + st * L::kStageBytes; };  // K; V 2 planes on
  auto full = [&](int st) { return base + L::kBars + 8 * (1 + st); };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int part = warp / Tile::kGroups;  // which 1/kSplit of each key tile
  const int col0 = part * (R / kSplit);   // the warp's first key in a tile
  // Longest causal rows first, so the heaviest blocks start earliest.
  const int qt = a.n_qtiles - 1 - static_cast<int>(blockIdx.x % a.n_qtiles);
  const int bh = static_cast<int>(blockIdx.x / a.n_qtiles);
  const int b = bh / a.heads, h = bh % a.heads;
  const int m0 = qt * kOuter;
  const int n_end = a.causal ? min(a.tk, m0 + kOuter) : a.tk;
  const int n_tiles = (n_end + R - 1) / R;

  // Thread 0 copies key tile ``tile`` (K and V) into stage st, if it exists.
  auto load_kv = [&](int st, int tile) {
    if (tid == 0 && tile < n_tiles) {
      const uint32_t dst = base + stage(st);
      hopper::mbar_expect_tx(full(st), 2 * L::kKvPlane);
      tf32x3::tma_tile<D, R>(dst, &k_map, full(st), b, h, tile * R);
      tf32x3::tma_tile<D, R>(dst + 2 * L::kKvPlane, &v_map, full(st), b, h, tile * R);
    }
  };
  if (tid == 0) {
    hopper::mbar_init(q_bar, 1);
    for (int st = 0; st < kStages; ++st) hopper::mbar_init(full(st), 1);
    hopper::mbar_fence_init();
    hopper::mbar_expect_tx(q_bar, L::kQPlane);
    tf32x3::tma_tile<D, kOuter>(q_s, &q_map, q_bar, b, h, m0);
  }
  for (int st = 0; st < kStages; ++st) load_kv(st, st);

  // This thread's rows of the tile: row_in and row_in + 8.
  const int row_in = 16 * (warp & (Tile::kGroups - 1)) + g;
  const tf32x3::LaneOffsets<Tile> off(warp, lane);
  float o[D / 8][4];
  tf32x3::zero(o);
  float m[2] = {kMaskValue, kMaskValue}, l[2] = {0.f, 0.f};
  __syncthreads();  // the barriers are initialised

  hopper::mbar_wait(q_bar, 0);
  tf32x3::split_tile<L::kQPlane>(smem);
  hopper::mbar_wait(full(0), 0);
  tf32x3::split_tile<L::kKvPlane>(smem + stage(0));
  tf32x3::split_tile<L::kKvPlane>(smem + stage(0) + 2 * L::kKvPlane);
  __syncthreads();

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages, n0 = it * R;
    const uint32_t k_s = base + stage(st) + col0 * 128, v_s = k_s + 2 * L::kKvPlane;

    float s[kBlocks][4];  // S = Q.K^T over the warp's keys of this tile
    tf32x3::product_rows<D, R, L::kQPlane, L::kKvPlane, true>(s, q_s, k_s, off);

    // The online softmax in registers: the scores scaled and masked, the
    // row max over the 4 lanes that hold the row, s becomes p, this
    // thread's share of the row sum and the O accumulator are rescaled.
    const bool edge = (a.causal && n0 + R - 1 > m0) || n0 + R > a.tk;
    auto masked = [&](int kb, int i) {
      const int col = n0 + col0 + 8 * kb + 2 * t + (i & 1), row = m0 + row_in + 8 * (i >> 1);
      return col >= a.tk || (a.causal && row < col);
    };
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int kb = 0; kb < kBlocks; ++kb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[kb][i] * a.scale;
        if (edge && masked(kb, i)) x = kMaskValue;
        s[kb][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
      corr[half] = expf(m[half] - mx[half]);
      m[half] = mx[half];
      l[half] *= corr[half];
    }
#pragma unroll
    for (int kb = 0; kb < kBlocks; ++kb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p = expf(s[kb][i] - m[i >> 1]);
        if (edge && masked(kb, i)) p = 0.f;
        s[kb][i] = p;
        l[i >> 1] += p;
      }
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[nb][i] *= corr[i >> 1];

    tf32x3::product_cols<D, R, L::kKvPlane>(o, s, v_s, off);  // O += P.V

    // The next key tile, once it lands, is split by each warp as it
    // finishes this one's products; the barrier then frees this stage.
    if (it + 1 < n_tiles) {
      const int nx = (it + 1) % kStages;
      hopper::mbar_wait(full(nx), ((it + 1) / kStages) & 1);
      tf32x3::split_tile<L::kKvPlane>(smem + stage(nx));
      tf32x3::split_tile<L::kKvPlane>(smem + stage(nx) + 2 * L::kKvPlane);
      tf32x3::fence_proxy_async();
    }
    __syncthreads();
    load_kv(st, it + kStages);
  }

  // The parts of each row meet in shared memory (the tiles are consumed)
  // and merge in a fixed order, part 0 first:
  //   m = max_i m_i, l = sum_i l_i e^(m_i - m),
  //   O = (sum_i O_i e^(m_i - m)) / max(l, 1e-30), LSE = m + log(max(l, 1e-30)).
  // With one part (D = 64) the factor e^(m - m) is exactly 1.
  float2* stats = reinterpret_cast<float2*>(smem + L::kStats);  // [kSplit][kOuter]
  float* denom = reinterpret_cast<float*>(smem + L::kDenom);    // [kOuter]
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
    if (t == 0) stats[part * kOuter + row_in + 8 * half] = make_float2(m[half], l[half]);
  }
  __syncthreads();
  float factor[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_in + 8 * half;
    float m_row = stats[row].x;
#pragma unroll
    for (int i = 1; i < kSplit; ++i) m_row = fmaxf(m_row, stats[i * kOuter + row].x);
    float l_row = 0.f;
#pragma unroll
    for (int i = 0; i < kSplit; ++i) {
      const float2 mi = stats[i * kOuter + row];
      const float e = expf(mi.x - m_row);
      l_row += mi.y * e;
      if (i == part) factor[half] = e;
    }
    if (part == 0 && t == 0) {
      const float den = fmaxf(l_row, 1e-30f);
      denom[row] = den;
      if (a.lse != nullptr && m0 + row < a.tq)
        a.lse[static_cast<long long>(bh) * a.tq + m0 + row] = m_row + logf(den);
    }
  }
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[nb][i] *= factor[i >> 1];
  float* red = reinterpret_cast<float*>(smem);
  tf32x3::stage_partial<Tile, D>(o, red, warp, lane);
  __syncthreads();
  float* og = static_cast<float*>(a.o) + b * a.o_sb + h * a.o_sh;
  for (int i = tid; i < kOuter * D / 4; i += tf32x3::kThreads) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    if (m0 + r >= a.tq) continue;
    float4 sum = *reinterpret_cast<const float4*>(red + r * L::kPitch + c);
#pragma unroll
    for (int j = 1; j < kSplit; ++j) {
      const float4 y = *reinterpret_cast<const float4*>(red + (j * kOuter + r) * L::kPitch + c);
      sum = make_float4(sum.x + y.x, sum.y + y.y, sum.z + y.z, sum.w + y.w);
    }
    const float den = denom[r];
    *reinterpret_cast<float4*>(og + (m0 + r) * a.o_st + c) =
        make_float4(sum.x / den, sum.y / den, sum.z / den, sum.w / den);
  }
}

// Builds the q, k, v maps (boxes of the query tile's and the key tile's
// rows) and launches one block per (batch*head, query tile).
template <int D>
cudaError_t launch_fp32(Args a, int batch, cudaStream_t stream) {
  using L = Fp32Smem<D>;
  constexpr int kRows = L::Tile::kOuter;
  a.n_qtiles = (a.tq + kRows - 1) / kRows;
  const long long n_blocks = static_cast<long long>(a.n_qtiles) * batch * a.heads;
  if (n_blocks > INT_MAX) return cudaErrorInvalidValue;
  CUtensorMap maps[3];
  const void* ptrs[3] = {a.q, a.k, a.v};
  const long long strides[3][3] = {{a.q_sb, a.q_st, a.q_sh},
                                   {a.k_sb, a.k_st, a.k_sh},
                                   {a.v_sb, a.v_st, a.v_sh}};
  const int seq[3] = {a.tq, a.tk, a.tk};
  const int rows[3] = {kRows, L::kKeys, L::kKeys};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err = tf32x3::make_map(&maps[i], ptrs[i], batch, seq[i], a.heads, D,
                                             strides[i][0], strides[i][1], strides[i][2],
                                             rows[i]);
    if (err != cudaSuccess) return err;
  }
  constexpr int smem = L::kAlloc;
  auto kernel = flash_fwd_fp32_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned int>(n_blocks), tf32x3::kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const Args& a, int batch, int dtype, unsigned int n_blocks,
                     cudaStream_t stream) {
  switch (dtype) {
    case 0: return launch_fp32<D>(a, batch, stream);
    case 1: return launch_tc<__half, D>(a, batch, dtype, n_blocks, stream);
    case 2: return launch_tc<__nv_bfloat16, D>(a, batch, dtype, n_blocks, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16. Strides are in elements; the
// head_dim axis must be contiguous. q, k and v must have a 16-byte aligned
// base and strides that are multiples of 16 bytes (TMA), and o must be
// contiguous (16-byte stores). Returns a cudaError_t (0 on
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
