// Flash-attention forward for Hopper (sm_90a).
//
// Counterpart of ray_tpu/ops/attention.py:_flash_fwd_kernel (the Pallas TPU
// kernel launched by _flash_forward). Same function: for each (batch, head)
// and query row, O = softmax(q.k^T * scale) . v with an online softmax over
// key tiles, the causal mask on global positions, and the row log-sum-exp
// LSE = m + log(l) as a second output. Same numerics as the reference:
//   - S = (q.k^T) * scale, the scale applied to the f32 product;
//   - masked scores are -1e30 (never -inf) and their probabilities exactly 0;
//   - the running max m, denominator l and accumulator stay in f32;
//   - p is rounded to v's type before the p.v product (the sum l uses the
//     unrounded p), and O = acc / max(l, 1e-30).
//
// What bounds it on this card. At GPT-2 124M's shape (B=4, T=1024, H=12,
// D=64, bf16, causal) the function must move ~25 MB (q, k, v read once, O
// and LSE written once): ~7.6 us at 3.35 TB/s; its ~6.4 GFLOP take ~6.5 us
// at 989 TFLOP/s. So the bytes bound it, with the tensor-core work close
// behind. The design keeps the O(T^2) scores out of device memory (each
// score tile lives in shared memory and registers only), reads q/k/v in
// their public [B, T, H, D] layout through strides (no transposed copies),
// and skips key tiles wholly above the diagonal. bf16/fp16 products run on
// the tensor cores (WMMA, f32 accumulation); fp32 inputs keep full fp32
// math on the FMA units, since a TF32 product would not match the
// reference. This first version is simple rather than fast: scalar tile
// loads with no copy/compute overlap, and the softmax and the rescale of
// the accumulator go through shared memory. TMA, wgmma and warp
// specialisation are later work.
//
// Blocking: one thread block of 4 warps per (batch*head, 64-row query
// tile); each warp owns 16 query rows. The block loops over 64-key tiles
// of K and V staged in shared memory, which takes the place of the TPU
// grid's sequential key axis. Ragged edges (T not a multiple of 64) are
// masked in the kernel.
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

constexpr int kBlockM = 64;                      // query rows per block
constexpr int kBlockN = 64;                      // keys per tile
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = kBlockM / kWarps;   // 16: one WMMA row tile
constexpr int kThreads = kWarps * 32;
constexpr float kMaskValue = -1e30f;             // the reference's _NEG_INF

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

// Shared-memory layout. Pitches keep WMMA's rules (a multiple of 8
// elements for 16-bit types, of 4 for float; every tile start 32-byte
// aligned) and stagger rows across banks.
template <typename T, int D, bool kTensorCores>
struct Layout {
  static constexpr int kLdQK = kTensorCores ? D + 8 : D + 1;   // q and k tiles
  static constexpr int kLdV = kTensorCores ? D + 8 : D;
  static constexpr int kLdP = kTensorCores ? kBlockN + 8 : kBlockN;
  // f32 scratch for one warp's WMMA results (scores, then p.v)
  static constexpr int kLdS = (D > kBlockN ? D : kBlockN) + 4;
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = align128(kQ + sizeof(T) * kBlockM * kLdQK);
  static constexpr size_t kV = align128(kK + sizeof(T) * kBlockN * kLdQK);
  static constexpr size_t kP = align128(kV + sizeof(T) * kBlockN * kLdV);
  static constexpr size_t kS = align128(kP + sizeof(T) * kBlockM * kLdP);
  static constexpr size_t kBytes =
      kTensorCores ? align128(kS + sizeof(float) * kBlockM * kLdS) : kS;
};

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

template <typename T, int D, bool kTensorCores>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Args a) {
  using L = Layout<T, D, kTensorCores>;
  constexpr int kCols = D / 32;  // accumulator columns each lane owns
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem + L::kQ);
  T* ks = reinterpret_cast<T*>(smem + L::kK);
  T* vs = reinterpret_cast<T*>(smem + L::kV);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // Longest causal rows first, so the heaviest blocks start earliest.
  const int qt = a.n_qtiles - 1 - static_cast<int>(blockIdx.x % a.n_qtiles);
  const int bh = static_cast<int>(blockIdx.x / a.n_qtiles);
  const int b = bh / a.heads;
  const int h = bh % a.heads;
  const int m0 = qt * kBlockM;
  const T zero = Num<T>::from_f(0.f);

  const T* qg = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kg = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  T* og = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;

  for (int i = tid; i < kBlockM * D; i += kThreads) {
    const int r = i / D, c = i % D, t = m0 + r;
    qs[r * L::kLdQK + c] = t < a.tq ? qg[t * a.q_st + c] : zero;
  }

  T* ps = reinterpret_cast<T*>(smem + L::kP) + warp * kRowsPerWarp * L::kLdP;
  float* ss = reinterpret_cast<float*>(smem + L::kS) + warp * kRowsPerWarp * L::kLdS;
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
      ks[r * L::kLdQK + c] = in ? kg[t * a.k_st + c] : zero;
      vs[r * L::kLdV + c] = in ? vg[t * a.v_st + c] : zero;
    }
    __syncthreads();

    // Scores of this warp's 16 rows against the tile's 64 keys; lane j
    // holds keys j and j + 32 of every row.
    float s[kRowsPerWarp][2];
    if constexpr (kTensorCores) {
#pragma unroll
      for (int jn = 0; jn < kBlockN / 16; ++jn) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc;
        wmma::fill_fragment(fc, 0.f);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> fb;
          wmma::load_matrix_sync(fa, qs + warp * kRowsPerWarp * L::kLdQK + kk * 16, L::kLdQK);
          wmma::load_matrix_sync(fb, ks + jn * 16 * L::kLdQK + kk * 16, L::kLdQK);
          wmma::mma_sync(fc, fa, fb, fc);
        }
        wmma::store_matrix_sync(ss + jn * 16, fc, L::kLdS, wmma::mem_row_major);
      }
      __syncwarp();
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        s[r][0] = ss[r * L::kLdS + lane];
        s[r][1] = ss[r * L::kLdS + lane + 32];
      }
    } else {
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) s[r][0] = s[r][1] = 0.f;
      const T* qw = qs + warp * kRowsPerWarp * L::kLdQK;
#pragma unroll 4
      for (int kk = 0; kk < D; ++kk) {
        const float k0 = Num<T>::to_f(ks[lane * L::kLdQK + kk]);
        const float k1 = Num<T>::to_f(ks[(lane + 32) * L::kLdQK + kk]);
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const float qv = Num<T>::to_f(qw[r * L::kLdQK + kk]);
          s[r][0] = fmaf(qv, k0, s[r][0]);
          s[r][1] = fmaf(qv, k1, s[r][1]);
        }
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
      ps[r * L::kLdP + lane] = Num<T>::from_f(p0);
      ps[r * L::kLdP + lane + 32] = Num<T>::from_f(p1);
    }
    __syncwarp();

    // acc = acc * corr + p . v
    if constexpr (kTensorCores) {
#pragma unroll
      for (int jn = 0; jn < D / 16; ++jn) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc;
        wmma::fill_fragment(fc, 0.f);
#pragma unroll
        for (int kk = 0; kk < kBlockN / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, ps + kk * 16, L::kLdP);
          wmma::load_matrix_sync(fb, vs + kk * 16 * L::kLdV + jn * 16, L::kLdV);
          wmma::mma_sync(fc, fa, fb, fc);
        }
        wmma::store_matrix_sync(ss + jn * 16, fc, L::kLdS, wmma::mem_row_major);
      }
      __syncwarp();
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[r][c] = acc[r][c] * corr[r] + ss[r * L::kLdS + lane + 32 * c];
      }
    } else {
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] *= corr[r];
      }
#pragma unroll 4
      for (int j = 0; j < kBlockN; ++j) {
        float vv[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) vv[c] = Num<T>::to_f(vs[j * L::kLdV + lane + 32 * c]);
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const float pj = Num<T>::to_f(ps[r * L::kLdP + j]);
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(pj, vv[c], acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int t = row0 + r;
    if (t >= a.tq) continue;
    const float denom = fmaxf(l_i[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      og[t * a.o_st + lane + 32 * c] = Num<T>::from_f(acc[r][c] / denom);
    if (a.lse != nullptr && lane == 0)
      a.lse[static_cast<long long>(bh) * a.tq + t] = m_i[r] + logf(denom);
  }
}

template <typename T, int D, bool kTensorCores>
cudaError_t launch(const Args& a, unsigned int n_blocks, cudaStream_t stream) {
  constexpr size_t smem = Layout<T, D, kTensorCores>::kBytes;
  auto kernel = flash_fwd_kernel<T, D, kTensorCores>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<n_blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool kTensorCores>
cudaError_t launch_d(const Args& a, int head_dim, unsigned int n_blocks, cudaStream_t stream) {
  if (head_dim == 64) return launch<T, 64, kTensorCores>(a, n_blocks, stream);
  if (head_dim == 128) return launch<T, 128, kTensorCores>(a, n_blocks, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16. Strides are in elements; the
// head_dim axis must be contiguous. Returns a cudaError_t (0 on success).
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
  switch (dtype) {
    case 0: return launch_d<float, false>(a, head_dim, nb, s);
    case 1: return launch_d<__half, true>(a, head_dim, nb, s);
    case 2: return launch_d<__nv_bfloat16, true>(a, head_dim, nb, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* ray_tpu_torch_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
