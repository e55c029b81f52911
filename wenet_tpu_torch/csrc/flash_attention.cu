// Masked flash attention forward for Hopper (sm_90a), plain C entry points.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` (wenet_tpu/ops/
// flash_attention.py), reached there through `flash_attention` from
// `attention_core` for long sequences (whisper's 1500-frame encoder), in
// both its variants: inference (`flash_attention_fwd`) and training
// (`flash_attention_fwd_train`, has_lse), which also writes the row
// log-sum-exp lse = m + log l (NEG_INF on fully masked rows) that the
// backward kernels (flash_attention_bwd.cu) read.
// For every (batch, head) it computes
//
//   s   = (q . k^T + bias) * scale      bias added BEFORE the scale
//   s   = mask ? s : NEG_INF            mask: True (non-zero) == attend
//   out = softmax(s) . v
//
// without writing the (T1, T2) scores to device memory: one block owns
// BQ query rows of one (batch, head), walks the keys in BK-wide tiles
// staged in shared memory, and keeps the running max m, normalizer l and
// output accumulator in fp32 registers (online softmax).  The structure
// is K1's (relpos_attention.cu) with one score product instead of two and
// an additive bias tile read from device memory.
//
// Kernel contract, shared with the TPU kernel:
//   * NEG_INF is the finite sentinel -1e30, and a probability is zeroed
//     where s <= NEG_INF / 2, so l counts only attendable keys;
//   * a fully masked row writes zeros (and lse = NEG_INF);
//   * fp32 and bf16 inputs are upcast on load, all math is fp32, and the
//     output has v's type.
// Ragged T1 / T2 edges are bounds-checked, not padded.  q, k, v and out
// are read and written through (batch, head, time) strides with a
// unit-stride feature dim, so the attention module's (B, T, h, d) buffers
// are used in place.  The mask (B|1, 1|h, 1|T1, T2) and the fp32 bias
// (B|1, 1|h, 1|T1, T2) are read through their own strides, 0 on a
// broadcast dim: neither broadcast is materialized.  lse is a contiguous
// (B, h, T1) fp32 array (the TPU kernel's 128-lane copy of it is a TPU
// tiling artefact).
//
// What bounds it on an H100: the two products run on the CUDA cores in
// fp32 (67 TFLOP/s peak), not on the tensor cores.  At whisper's encoder
// shape (T = 1500, d = 64) the kernel does 4 * T1 * T2 * d FLOPs per
// (batch, head) against about (T1 + 2 * T2) * d * 4 bytes read, so it is
// bound by FMA issue and the shared-memory reads feeding it, far from the
// 3.35 TB/s memory line.  Register tiling answers that: each thread owns
// a 4x4 block of scores and a 4 x (D/16) block of the output, so every
// shared-memory read feeds 2 FMAs; rows are padded by one float so the
// column walks hit distinct banks.  wgmma on bf16 tiles and TMA loads are
// the later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16 threads, each a 4 x 4 score block
constexpr float NEG_INF = -1.0e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Element strides: (batch, head, time) for q, k, v and out, whose feature
// dim is unit-stride; (batch, head, row, column) for the mask and bias.
struct Strides {
  long long q[3], k[3], v[3], out[3];
  long long mask[4], bias[4];
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((BQ + 2 * BK) * (D + 1) + BQ * (BK + 1));
}

template <typename T, int D, bool LSE>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const uint8_t* __restrict__ mask,
                     const float* __restrict__ bias, T* __restrict__ out,
                     float* __restrict__ lse, Strides st, int H, int T1,
                     int T2, float scale) {
  constexpr int LD = D + 1;   // padded feature row
  constexpr int LDS = BK + 1; // padded probability row
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + BQ * LD;
  float* sv = sk + BK * LD;
  float* ss = sv + BK * LD;

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // key / feature column group
  const int ty = tid >> 4;  // owns query rows ty*4 .. ty*4+3
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;

  const T* qb = q + b * st.q[0] + h * st.q[1];
  const T* kb = k + b * st.k[0] + h * st.k[1];
  const T* vb = v + b * st.v[0] + h * st.v[1];
  const uint8_t* mb =
      mask == nullptr ? nullptr : mask + b * st.mask[0] + h * st.mask[1];
  const float* bb =
      bias == nullptr ? nullptr : bias + b * st.bias[0] + h * st.bias[1];

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D, t = q0 + r;
    sq[r * LD + c] = t < T1 ? to_float(qb[t * st.q[2] + c]) : 0.f;
  }

  float acc[4][DC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < T2; k0 += BK) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D, t = k0 + r;
      float a = 0.f, x = 0.f;
      if (t < T2) {
        a = to_float(kb[t * st.k[2] + c]);
        x = to_float(vb[t * st.v[2] + c]);
      }
      sk[r * LD + c] = a;
      sv[r * LD + c] = x;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sq[(ty * 4 + i) * LD + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = sk[(tx + 16 * j) * LD + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
      float row_max = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = k0 + tx + 16 * j;
        const bool inside = r < T1 && t < T2;
        bool keep = inside;
        if (keep && mb != nullptr)
          keep = mb[r * st.mask[2] + t * st.mask[3]] != 0;
        float x = s[i][j];
        if (inside && bb != nullptr) x += bb[r * st.bias[2] + t * st.bias[3]];
        s[i][j] = keep ? x * scale : NEG_INF;
        row_max = fmaxf(row_max, s[i][j]);
      }
      // the 16 threads of a row are one half-warp
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, o));
      const float m_new = fmaxf(m[i], row_max);
      const float corr = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pr =
            s[i][j] <= NEG_INF * 0.5f ? 0.f : expf(s[i][j] - m_new);
        ss[(ty * 4 + i) * LDS + tx + 16 * j] = pr;
        row_sum += pr;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, o);
      l[i] = l[i] * corr + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pr[4], x[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = ss[(ty * 4 + i) * LDS + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) x[c] = sv[j * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pr[i], x[c], acc[i][c]);
    }
  }

  T* ob = out + b * st.out[0] + h * st.out[1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= T1) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const float y = l[i] > 0.f ? acc[i][c] / l[i] : 0.f;
      ob[r * st.out[2] + tx + 16 * c] = from_float<T>(y);
    }
    if constexpr (LSE) {
      if (tx == 0)
        lse[static_cast<long long>(blockIdx.y) * T1 + r] =
            l[i] > 0.f ? m[i] + logf(l[i]) : NEG_INF;
    }
  }
}

struct Args {
  const void *q, *k, *v, *mask;
  const float* bias;
  void* out;
  float* lse;  // training only
  Strides st;
  int B, H, T1, T2;
  float scale;
};

template <typename T, int D, bool LSE>
int launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_fwd_kernel<T, D, LSE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.T1 + BQ - 1) / BQ, a.B * a.H);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const uint8_t*>(a.mask),
      a.bias, static_cast<T*>(a.out), a.lse, a.st, a.H, a.T1, a.T2, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool LSE>
int launch_d(int D, const Args& a, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32, LSE>(a, stream);
    case 64:
      return launch<T, 64, LSE>(a, stream);
    case 128:
      return launch<T, 128, LSE>(a, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool LSE>
int dispatch(const void* q, const void* k, const void* v, const void* mask,
             const void* bias, void* out, float* lse,
             const long long* strides, int B, int H, int T1, int T2, int D,
             int dtype, float scale, void* stream) {
  Args a{q, k, v, mask, static_cast<const float*>(bias), out, lse, {},
         B, H, T1, T2, scale};
  long long* dst[] = {a.st.q, a.st.k, a.st.v, a.st.out};
  for (int t = 0; t < 4; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  for (int i = 0; i < 4; ++i) {
    a.st.mask[i] = strides[12 + i];
    a.st.bias[i] = strides[16 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float, LSE>(D, a, s);
  if (dtype == 1) return launch_d<__nv_bfloat16, LSE>(D, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// strides: 20 element strides, (batch, head, time) for q, k, v and out,
// then (batch, head, row, column) for the mask and for the bias.  mask
// (uint8, non-zero == attend) and bias (float32) may be null.
// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out).  Each returns a
// cudaError_t code (0 = ok).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, const void* mask,
                                   const void* bias, void* out,
                                   const long long* strides, int B, int H,
                                   int T1, int T2, int D, int dtype,
                                   float scale, void* stream) {
  return dispatch<false>(q, k, v, mask, bias, out, nullptr, strides, B, H,
                         T1, T2, D, dtype, scale, stream);
}

// The train variant: also writes lse, contiguous (B, H, T1) fp32.
extern "C" int flash_attention_fwd_train(const void* q, const void* k,
                                         const void* v, const void* mask,
                                         const void* bias, void* out,
                                         void* lse, const long long* strides,
                                         int B, int H, int T1, int T2, int D,
                                         int dtype, float scale,
                                         void* stream) {
  return dispatch<true>(q, k, v, mask, bias, out, static_cast<float*>(lse),
                        strides, B, H, T1, T2, D, dtype, scale, stream);
}
