// Flash-attention backward for float32 inputs, for Hopper (sm_90a): the
// dQ pass and the dK/dV pass, every product on the tensor cores in
// 3xTF32. The bf16/fp16 passes are flash_bwd_dq.cu and flash_bwd_dkv.cu.
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
// in fp32, with p and dS unrounded as in the reference and exp as expf
// (no ex2.approx). delta is computed outside the kernels, as in the
// reference (ray_tpu_torch/ops/attention.py:_flash_backward).
//
// fp32 on the tensor cores: every product in 3xTF32 (hi.lo + lo.hi +
// hi.hi of the operands' TF32 halves, in chains of kChain = 2 eight-deep
// steps promoted by f32 adds), with the building blocks, the tiling and
// the tile layout of tf32x3.cuh, which the fp32 forward (flash_fwd.cu)
// shares. One chain over a whole 64-deep product with the three products
// of each step in turn missed the fp32 tile limit on an H100: the tensor
// cores' f32 accumulation truncates, each product at an ulp of the sum it
// adds to.
//
// What bounds it on this card. Per attended (q, k) pair and (batch, head)
// the dQ pass does 3 products of length D (6*D operations), the dK/dV
// pass 4 (8*D), each three times in 3xTF32, against q, k, v, dO read once
// and the gradients written once. At GPT-2 124M's training shape (B=8,
// T=1024, H=12, D=64, causal) that is 3 x 1.93e10 and 3 x 2.58e10
// operations, 0.117 and 0.156 ms at the 495 TFLOP/s dense TF32 peak, above
// the bytes' ~0.04 ms: the tensor cores bound both.
//
// The design. The TPU kernels' two-pass split, so no atomics and the same
// gradients from run to run: one block of 8 warps per (batch*head, 64-row
// tile of its own axis), looping over tiles of the other axis at or below
// the causal diagonal; the dQ pass owns query rows and loops over key
// tiles (heaviest causal rows first), the dK/dV pass owns keys and loops
// over query tiles (key tile 0 first). Warps w and w + 4 own the same 16
// rows and take one half each of every inner tile, each summing its own
// part of the gradient in registers; at the end the two parts meet in
// shared memory and are added in a fixed order (half 0 + half 1) before
// 16-byte stores. Two warps a scheduler hide each other's latencies.
//  - Copies. One thread issues TMA loads (4-D maps over the public
//    [B, T, H, D] layout, 128-byte swizzle, 32-column boxes, zeros past
//    T); an mbarrier per stage reports each. The block's own two tiles
//    land once; the inner tiles (k, v for dQ; q, dO and their LSE, delta
//    for dK/dV) come through a ring of 2 stages, so the next tile's copy
//    runs under this tile's products. One __syncthreads a tile.
//  - Split once. A tile lands raw in its hi plane; the threads split it in
//    place, hi over the raw value and lo into the plane beside it. The
//    next inner tile is split by each warp as it finishes its products on
//    the current one, before the tile's one barrier.
//  - Layout and operands as tf32x3.cuh sets them out: S = q.k^T and
//    dP = dO.v^T read both tiles along rows; the B operands of dQ = dS.k,
//    dV = p^T.dO and dK = dS^T.q are read along columns; the S (or dP)
//    accumulator is the next product's A fragment as it lies, so p and dS
//    are split once per element in registers.
//  - Masks only on diagonal and ragged tiles; a causal key tile past
//    every query (Tq < Tk) runs no iteration and writes zeros.
//
// Sizes (python3 -m ray_tpu_torch.kernel_report gives registers and
// spills). D = 64: own tile 64 rows, inner tiles 64 rows (32 a warp);
// shared memory 4 planes of 16 KB for the own tiles + 2 stages x 4 planes
// of 16 KB = 192 KB, so one block of 8 warps on an SM. D = 128: own tile
// 64 rows (4 planes of 32 KB), inner tiles 16 rows (8 a warp; 2 stages x
// 4 planes of 8 KB), 192 KB, one block of 8 warps on an SM. The bound at
// D = 128 is the same max(bytes, 3 x operations / 495 TFLOP/s).
//
// Built by ray_tpu_torch/ops/_kernels.py with nvcc into a shared library
// with a plain C interface; every launch returns cudaGetLastError().

#include <cuda.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

using Tile = Tiling<64, 2>;  // 64 rows a block; warps w and w + 4 share 16
constexpr int kOuter = Tile::kOuter;
constexpr int kSplit = Tile::kSplit;
constexpr int kStages = 2;  // the ring of inner tiles

// Rows of an inner tile by head_dim: two stages of four planes must fit
// beside the own tiles' four planes in a block's 227 KB.
template <int D>
constexpr int inner_rows() {
  return D == 64 ? 64 : 16;
}

// Shared memory, every plane 1024-byte aligned (the swizzle's period):
// the own tiles (q, dO for dQ; k, v for dK/dV) as X hi, X lo, Y hi, Y lo;
// kStages stages of the inner tiles in the same four planes; per stage
// the inner rows' LSE and delta (dK/dV); the barriers (own tiles, then
// one per stage). After the loop the planes hold the epilogue's partial
// sums: per output [kSplit][kOuter][D + 8] f32 (a pitch of D + 8 keeps
// the warps' 8-byte stores free of bank conflicts).
template <int D>
struct Smem {
  static constexpr int kInner = inner_rows<D>();
  static constexpr int kOuterPlane = kOuter * D * 4;
  static constexpr int kInnerPlane = kInner * D * 4;
  static constexpr int kStage0 = 4 * kOuterPlane;
  static constexpr int kStageBytes = 4 * kInnerPlane;
  static constexpr int kStats = kStage0 + kStages * kStageBytes;
  static constexpr int kBars = kStats + kStages * 2 * kInner * 4;
  static constexpr int kBytes = kBars + 8 * (1 + kStages);
  static constexpr int kAlloc = kBytes + 1024;  // slack to align the base
  static constexpr int kRedPitch = D + 8;
  static constexpr int kRedBytes = kSplit * kOuter * kRedPitch * 4;
  static_assert(2 * kRedBytes <= kStats, "the partial sums fit in the tile planes");
};

struct Args {
  const float* lse;    // [B*H, Tq]
  const float* delta;  // [B*H, Tq]
  float* out0;         // dQ (dQ pass) or dK (dK/dV pass)
  float* out1;         // dV (dK/dV pass)
  long long o0_sb, o0_st, o0_sh;  // strides in elements: batch, position, head
  long long o1_sb, o1_st, o1_sh;
  int heads, tq, tk, n_tiles, causal;
  float scale;
};

// The block's 64 x D output tile, the sum of the kSplit parts of ``red``
// (in order, the same every run; ``red`` null: zeros), out to rows
// [row0, min(row0 + 64, t_end)) of ``g`` with 16-byte stores.
template <int D>
__device__ __forceinline__ void store_tile(const float* red, float* g, long long st, int row0,
                                           int t_end) {
  constexpr int kPitch = D + 8;
  for (int i = threadIdx.x; i < kOuter * D / 4; i += kThreads) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    if (row0 + r >= t_end) continue;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    if (red != nullptr) {
      sum = *reinterpret_cast<const float4*>(red + r * kPitch + c);
#pragma unroll
      for (int part = 1; part < kSplit; ++part) {
        const float4 y = *reinterpret_cast<const float4*>(red + (part * kOuter + r) * kPitch + c);
        sum = make_float4(sum.x + y.x, sum.y + y.y, sum.z + y.z, sum.w + y.w);
      }
    }
    *reinterpret_cast<float4*>(g + (row0 + r) * st + c) = sum;
  }
}

// ---------------------------------------------------------------------------
// dQ pass: one block per (batch*head, 64-row query tile), looping over the
// key tiles at or below the diagonal. Warps w and w + 4 own query rows
// 16 (w % 4).., and take keys [0, R/2) and [R/2, R) of each key tile.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_fp32_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             const __grid_constant__ CUtensorMap do_map, const Args a) {
  using L = Smem<D>;
  constexpr int R = L::kInner;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t base = hopper::smem_addr(smem);
  const uint32_t q_s = base, do_s = base + 2 * L::kOuterPlane;
  const uint32_t own_bar = base + L::kBars;
  auto stage = [&](int st) { return L::kStage0 + st * L::kStageBytes; };  // k; v 2 planes on
  auto full = [&](int st) { return base + L::kBars + 8 * (1 + st); };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int col0 = (warp >> 2) * (R / kSplit);  // the warp's first key in a tile
  // Longest causal rows first, so the heaviest blocks start earliest.
  const int qt = a.n_tiles - 1 - static_cast<int>(blockIdx.x % a.n_tiles);
  const int bh = static_cast<int>(blockIdx.x / a.n_tiles);
  const int b = bh / a.heads, h = bh % a.heads;
  const int m0 = qt * kOuter;
  const int n_end = a.causal ? min(a.tk, m0 + kOuter) : a.tk;
  const int n_tiles = (n_end + R - 1) / R;

  // Thread 0 copies key tile ``tile`` (k and v) into stage st, if it exists.
  auto load_kv = [&](int st, int tile) {
    if (tid == 0 && tile < n_tiles) {
      const uint32_t dst = base + stage(st);
      hopper::mbar_expect_tx(full(st), 2 * L::kInnerPlane);
      tma_tile<D, R>(dst, &k_map, full(st), b, h, tile * R);
      tma_tile<D, R>(dst + 2 * L::kInnerPlane, &v_map, full(st), b, h, tile * R);
    }
  };
  if (tid == 0) {
    hopper::mbar_init(own_bar, 1);
    for (int st = 0; st < kStages; ++st) hopper::mbar_init(full(st), 1);
    hopper::mbar_fence_init();
    hopper::mbar_expect_tx(own_bar, 2 * L::kOuterPlane);
    tma_tile<D, kOuter>(q_s, &q_map, own_bar, b, h, m0);
    tma_tile<D, kOuter>(do_s, &do_map, own_bar, b, h, m0);
  }
  for (int st = 0; st < kStages; ++st) load_kv(st, st);

  // This thread's rows r0 and r0 + 8: LSE and delta; rows past Tq get 0
  // (their q and dO are zero, so their dS is too).
  const int r0 = m0 + 16 * (warp & 3) + g;
  float lse[2], delta[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + 8 * half;
    const long long i = static_cast<long long>(bh) * a.tq + row;
    lse[half] = row < a.tq ? a.lse[i] : 0.f;
    delta[half] = row < a.tq ? a.delta[i] : 0.f;
  }
  const LaneOffsets<Tile> off(warp, lane);
  float dq[D / 8][4];
  zero(dq);
  __syncthreads();  // the barriers are initialised

  hopper::mbar_wait(own_bar, 0);
  split_tile<L::kOuterPlane>(smem);
  split_tile<L::kOuterPlane>(smem + 2 * L::kOuterPlane);
  hopper::mbar_wait(full(0), 0);
  split_tile<L::kInnerPlane>(smem + stage(0));
  split_tile<L::kInnerPlane>(smem + stage(0) + 2 * L::kInnerPlane);
  __syncthreads();

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages, n0 = it * R;
    const uint32_t k_s = base + stage(st) + col0 * 128, v_s = k_s + 2 * L::kInnerPlane;

    float s[R / 8 / kSplit][4], dp[R / 8 / kSplit][4];
    product_rows<D, R, L::kOuterPlane, L::kInnerPlane>(s, q_s, k_s, off);
    product_rows<D, R, L::kOuterPlane, L::kInnerPlane>(dp, do_s, v_s, off);

    // dS into dp, in place.
    const bool edge = (a.causal && n0 + R - 1 > m0) || n0 + R > a.tk;
#pragma unroll
    for (int kb = 0; kb < R / 8 / kSplit; ++kb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int half = i >> 1;
        float p = expf(s[kb][i] * a.scale - lse[half]);
        if (edge) {
          const int col = n0 + col0 + 8 * kb + 2 * t + (i & 1), row = r0 + 8 * half;
          if (col >= a.tk || (a.causal && row < col)) p = 0.f;
        }
        dp[kb][i] = p * (dp[kb][i] - delta[half]) * a.scale;
      }

    product_cols<D, R, L::kInnerPlane>(dq, dp, k_s, off);

    // The next key tile, once it lands, is split by each warp as it
    // finishes this one's products; the barrier then frees this stage.
    if (it + 1 < n_tiles) {
      const int nx = (it + 1) % kStages;
      hopper::mbar_wait(full(nx), ((it + 1) / kStages) & 1);
      split_tile<L::kInnerPlane>(smem + stage(nx));
      split_tile<L::kInnerPlane>(smem + stage(nx) + 2 * L::kInnerPlane);
      fence_proxy_async();
    }
    __syncthreads();
    load_kv(st, it + kStages);
  }

  float* red = reinterpret_cast<float*>(smem);  // the tiles are consumed
  stage_partial<Tile, D>(dq, red, warp, lane);
  __syncthreads();
  store_tile<D>(red, a.out0 + b * a.o0_sb + h * a.o0_sh, a.o0_st, m0, a.tq);
}

// ---------------------------------------------------------------------------
// dK/dV pass: one block per (batch*head, 64-key tile), looping over the
// query tiles at or below the diagonal. Warps w and w + 4 own keys
// 16 (w % 4).. and take queries [0, R/2) and [R/2, R) of each query tile;
// they work on the transposed tiles S^T = K.Q^T and dP^T = V.dO^T.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_fp32_kernel(const __grid_constant__ CUtensorMap q_map,
                              const __grid_constant__ CUtensorMap k_map,
                              const __grid_constant__ CUtensorMap v_map,
                              const __grid_constant__ CUtensorMap do_map, const Args a) {
  using L = Smem<D>;
  constexpr int R = L::kInner;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t base = hopper::smem_addr(smem);
  const uint32_t k_s = base, v_s = base + 2 * L::kOuterPlane;
  const uint32_t own_bar = base + L::kBars;
  auto stage = [&](int st) { return L::kStage0 + st * L::kStageBytes; };  // q; dO 2 planes on
  auto stats = [&](int st) { return reinterpret_cast<float*>(smem + L::kStats) + st * 2 * R; };
  auto full = [&](int st) { return base + L::kBars + 8 * (1 + st); };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int col0 = (warp >> 2) * (R / kSplit);  // the warp's first query in a tile
  // Key tile 0 meets the most causal query tiles: it starts first.
  const int kt = static_cast<int>(blockIdx.x % a.n_tiles);
  const int bh = static_cast<int>(blockIdx.x / a.n_tiles);
  const int b = bh / a.heads, h = bh % a.heads;
  const int n0 = kt * kOuter;
  const int kj0 = n0 + 16 * (warp & 3) + g;  // this thread's keys kj0 and kj0 + 8
  // Query tiles wholly above the diagonal hold no query that attends to
  // these keys (R divides 64, so the first one left starts at n0).
  const int m_start = a.causal ? n0 : 0;
  const int n_tiles = m_start < a.tq ? (a.tq - m_start + R - 1) / R : 0;
  float* dkg = a.out0 + b * a.o0_sb + h * a.o0_sh;
  float* dvg = a.out1 + b * a.o1_sb + h * a.o1_sh;
  if (n_tiles == 0) {  // past every query (causal, Tq < Tk): zeros
    store_tile<D>(nullptr, dkg, a.o0_st, n0, a.tk);
    store_tile<D>(nullptr, dvg, a.o1_st, n0, a.tk);
    return;
  }

  // Thread 0 copies query tile ``tile`` (q and dO) into stage st, if it exists.
  auto load_q = [&](int st, int tile) {
    if (tid == 0 && tile < n_tiles) {
      const uint32_t dst = base + stage(st);
      hopper::mbar_expect_tx(full(st), 2 * L::kInnerPlane);
      tma_tile<D, R>(dst, &q_map, full(st), b, h, m_start + tile * R);
      tma_tile<D, R>(dst + 2 * L::kInnerPlane, &do_map, full(st), b, h, m_start + tile * R);
    }
  };
  // The LSE and delta of query tile ``tile``'s row ``tid`` (0 past Tq).
  auto row_stats = [&](int tile, float& l, float& d) {
    const int m = m_start + tile * R + tid;
    const long long i = static_cast<long long>(bh) * a.tq + m;
    const bool ok = tid < R && tile < n_tiles && m < a.tq;
    l = ok ? a.lse[i] : 0.f;
    d = ok ? a.delta[i] : 0.f;
  };
  if (tid == 0) {
    hopper::mbar_init(own_bar, 1);
    for (int st = 0; st < kStages; ++st) hopper::mbar_init(full(st), 1);
    hopper::mbar_fence_init();
    hopper::mbar_expect_tx(own_bar, 2 * L::kOuterPlane);
    tma_tile<D, kOuter>(k_s, &k_map, own_bar, b, h, n0);
    tma_tile<D, kOuter>(v_s, &v_map, own_bar, b, h, n0);
  }
  for (int st = 0; st < kStages; ++st) load_q(st, st);
  if (tid < R) row_stats(0, stats(0)[tid], stats(0)[R + tid]);

  const LaneOffsets<Tile> off(warp, lane);
  float dk[D / 8][4], dv[D / 8][4];
  zero(dk);
  zero(dv);
  __syncthreads();  // the barriers are initialised

  hopper::mbar_wait(own_bar, 0);
  split_tile<L::kOuterPlane>(smem);
  split_tile<L::kOuterPlane>(smem + 2 * L::kOuterPlane);
  hopper::mbar_wait(full(0), 0);
  split_tile<L::kInnerPlane>(smem + stage(0));
  split_tile<L::kInnerPlane>(smem + stage(0) + 2 * L::kInnerPlane);
  __syncthreads();

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages, m0 = m_start + it * R;
    const uint32_t q_s = base + stage(st) + col0 * 128, do_s = q_s + 2 * L::kInnerPlane;
    float next_lse, next_delta;  // the next tile's, stored when it is split
    row_stats(it + 1, next_lse, next_delta);

    float s[R / 8 / kSplit][4], dp[R / 8 / kSplit][4];
    product_rows<D, R, L::kOuterPlane, L::kInnerPlane>(s, k_s, q_s, off);
    product_rows<D, R, L::kOuterPlane, L::kInnerPlane>(dp, v_s, do_s, off);

    // p into s and dS into dp, in place; columns are queries.
    const float* lse_s = stats(st) + col0;
    const float* dl_s = lse_s + R;
    const bool edge = (a.causal && m0 < n0 + kOuter - 1) || m0 + R > a.tq || n0 + kOuter > a.tk;
#pragma unroll
    for (int kb = 0; kb < R / 8 / kSplit; ++kb) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * kb + 2 * t);
      const float2 d2 = *reinterpret_cast<const float2*>(dl_s + 8 * kb + 2 * t);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = i & 1;
        float p = expf(s[kb][i] * a.scale - (c ? l2.y : l2.x));
        if (edge) {
          const int qi = m0 + col0 + 8 * kb + 2 * t + c, kj = kj0 + 8 * (i >> 1);
          if (qi >= a.tq || kj >= a.tk || (a.causal && qi < kj)) p = 0.f;
        }
        s[kb][i] = p;
        dp[kb][i] = p * (dp[kb][i] - (c ? d2.y : d2.x)) * a.scale;
      }
    }

    product_cols<D, R, L::kInnerPlane>(dv, s, do_s, off);
    product_cols<D, R, L::kInnerPlane>(dk, dp, q_s, off);

    // The next query tile, once it lands, is split by each warp as it
    // finishes this one's products; the barrier then frees this stage.
    if (it + 1 < n_tiles) {
      const int nx = (it + 1) % kStages;
      hopper::mbar_wait(full(nx), ((it + 1) / kStages) & 1);
      split_tile<L::kInnerPlane>(smem + stage(nx));
      split_tile<L::kInnerPlane>(smem + stage(nx) + 2 * L::kInnerPlane);
      if (tid < R) {
        stats(nx)[tid] = next_lse;
        stats(nx)[R + tid] = next_delta;
      }
      fence_proxy_async();
    }
    __syncthreads();
    load_q(st, it + kStages);
  }

  float* red = reinterpret_cast<float*>(smem);  // the tiles are consumed
  stage_partial<Tile, D>(dk, red, warp, lane);
  stage_partial<Tile, D>(dv, red + L::kRedBytes / 4, warp, lane);
  __syncthreads();
  store_tile<D>(red, dkg, a.o0_st, n0, a.tk);
  store_tile<D>(red + L::kRedBytes / 4, dvg, a.o1_st, n0, a.tk);
}

// Builds the four maps (q, k, v, dO; the pass's own two tensors in boxes
// of 64 rows, the inner two in boxes of the inner tile's rows), sets the
// tile count from the rows the blocks tile (Tq for dQ, Tk for dK/dV) and
// launches a pass.
template <int D, bool kDq>
cudaError_t launch(Args& a, const void* const (&ptrs)[4], const long long (&strides)[4][3],
                   int batch, cudaStream_t stream) {
  constexpr int kInner = inner_rows<D>();
  const int seq[4] = {a.tq, a.tk, a.tk, a.tq};
  const bool own[4] = {kDq, !kDq, !kDq, kDq};
  CUtensorMap maps[4];
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err = make_map(&maps[i], ptrs[i], batch, seq[i], a.heads, D, strides[i][0],
                                     strides[i][1], strides[i][2], own[i] ? kOuter : kInner);
    if (err != cudaSuccess) return err;
  }
  a.n_tiles = ((kDq ? a.tq : a.tk) + kOuter - 1) / kOuter;
  const long long n_blocks = static_cast<long long>(a.n_tiles) * batch * a.heads;
  if (n_blocks <= 0 || n_blocks > INT_MAX) return cudaErrorInvalidValue;
  constexpr int smem = Smem<D>::kAlloc;
  auto kernel = kDq ? flash_bwd_dq_fp32_kernel<D> : flash_bwd_dkv_fp32_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned int>(n_blocks), kThreads, smem, stream>>>(maps[0], maps[1],
                                                                          maps[2], maps[3], a);
  return cudaGetLastError();
}

template <bool kDq>
cudaError_t launch_pass(Args& a, const void* const (&ptrs)[4], const long long (&strides)[4][3],
                        int batch, int head_dim, cudaStream_t stream) {
  if (head_dim == 64) return launch<64, kDq>(a, ptrs, strides, batch, stream);
  if (head_dim == 128) return launch<128, kDq>(a, ptrs, strides, batch, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Strides are in elements. q, k, v and dout must have a 16-byte aligned
// base, a contiguous head_dim axis and strides that are multiples of 16
// bytes (TMA); the gradients 16-byte aligned rows with a contiguous
// head_dim axis; lse and delta are contiguous [B*H, Tq] f32; Tq, Tk > 0.
// Each returns a cudaError_t (0 on success).

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
  if (tq <= 0 || tk <= 0) return cudaErrorInvalidValue;
  Args a{lse, delta, static_cast<float*>(dq), nullptr, dq_sb, dq_st, dq_sh, 0, 0, 0,
         heads, tq, tk, 0, causal, scale};
  const void* const ptrs[4] = {q, k, v, dout};
  const long long strides[4][3] = {
      {q_sb, q_st, q_sh}, {k_sb, k_st, k_sh}, {v_sb, v_st, v_sh}, {do_sb, do_st, do_sh}};
  return launch_pass<true>(a, ptrs, strides, batch, head_dim, static_cast<cudaStream_t>(stream));
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
  if (tq <= 0 || tk <= 0) return cudaErrorInvalidValue;
  Args a{lse, delta, static_cast<float*>(dk), static_cast<float*>(dv),
         dk_sb, dk_st, dk_sh, dv_sb, dv_st, dv_sh, heads, tq, tk, 0, causal, scale};
  const void* const ptrs[4] = {q, k, v, dout};
  const long long strides[4][3] = {
      {q_sb, q_st, q_sh}, {k_sb, k_st, k_sh}, {v_sb, v_st, v_sh}, {do_sb, do_st, do_sh}};
  return launch_pass<false>(a, ptrs, strides, batch, head_dim, static_cast<cudaStream_t>(stream));
}

extern "C" const char* ray_tpu_torch_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
