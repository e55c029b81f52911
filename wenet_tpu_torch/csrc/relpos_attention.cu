// Fused rel-pos attention forward for Hopper (sm_90a), plain C entry point.
//
// Replaces the Pallas TPU kernel `_relpos_fwd_kernel`
// (wenet_tpu/ops/flash_attention.py), reached there through
// `flash_attention_relpos`.  It computes, for every (batch, head):
//
//   s   = (q1 . k^T + q2 . p^T) * scale        q1 = q + pos_bias_u
//   s   = mask ? s : NEG_INF                    q2 = q + pos_bias_v
//   out = softmax(s) . v                        p  = projected pos_emb
//
// without ever writing the (T1, T2) scores or the rel-pos bias to device
// memory: one block owns BQ query rows of one (batch, head), walks the
// keys in BK-wide tiles staged in shared memory, and keeps the running
// max m, normalizer l and output accumulator in fp32 registers (online
// softmax).
//
// The training variant (`relpos_attention_fwd_train`, template flags
// WITH_LSE and DROPOUT) also writes lse = m + log(l) for the backward
// kernels (relpos_attention_bwd.cu) and applies attention-weight dropout
// with the counter hash of dropout_hash.cuh to the v-accumulator only:
// l stays the full normalizer, as in the TPU kernel.  The inference
// instantiation <false, false> compiles to the same code as before those
// flags existed.
//
// Kernel contract, shared with the TPU kernel:
//   * NEG_INF is the finite sentinel -1e30, and a probability is zeroed
//     where s <= NEG_INF / 2, so l counts only attendable keys;
//   * a fully masked row writes zeros;
//   * fp32 and bf16 inputs are upcast on load, all math is fp32, and the
//     output has the input type.
// Ragged T1 / T2 edges are bounds-checked, not padded.  p may be shared
// by the whole batch (batch stride 0) and the mask may be one row for all
// queries (row stride 0); neither broadcast is materialized.
//
// What bounds it on an H100: the three products run on the CUDA cores in
// fp32 (67 TFLOP/s peak), not on the tensor cores, so at the conformer's
// shapes (T ~ 375, d = 64) the kernel is bound by FMA issue and by the
// shared-memory reads that feed it; device-memory traffic (each q, k, p, v
// element read once per query tile) is well below the 3.35 TB/s line.
// The simple design answers with register tiling: each thread owns a 4x4
// block of scores and a 4 x (D/16) block of the output, so every
// shared-memory read feeds 2 FMAs, and rows are padded by one float so
// the column walks hit 16 distinct banks.  wgmma on bf16 tiles and TMA
// loads are the later step.

#include "dropout_hash.cuh"
#include "relpos_common.cuh"

namespace {

using relpos::BK;
using relpos::BQ;
using relpos::from_float;
using relpos::NEG_INF;
using relpos::THREADS;
using relpos::to_float;

// Element strides of (batch, head, time) for each (B, H, T, D) operand;
// the feature dim is unit-stride.  The mask has (batch, row, column).
struct Strides {
  long long q1[3], q2[3], k[3], p[3], v[3], out[3];
  long long mask[3];
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((2 * BQ + 3 * BK) * (D + 1) + BQ * (BK + 1));
}

// WITH_LSE: also write lse = m + log(l) per row, (B, H, T1) fp32 (NEG_INF
// for a fully masked row).  DROPOUT: multiply the weights that feed the
// v-accumulator by the hash mask; l stays the full softmax normalizer, so
// out = (D . softmax(s)) . v.  <false, false> is the inference kernel.
template <typename T, int D, bool WITH_LSE, bool DROPOUT>
__global__ void __launch_bounds__(THREADS)
    relpos_fwd_kernel(const T* __restrict__ q1, const T* __restrict__ q2,
                      const T* __restrict__ k, const T* __restrict__ p,
                      const T* __restrict__ v,
                      const uint8_t* __restrict__ mask, T* __restrict__ out,
                      float* __restrict__ lse, Strides st, int H, int T1,
                      int T2, float scale, DropoutParams dp) {
  constexpr int LD = D + 1;   // padded feature row
  constexpr int LDS = BK + 1; // padded probability row
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sq1 = smem;
  float* sq2 = sq1 + BQ * LD;
  float* sk = sq2 + BQ * LD;
  float* sp = sk + BK * LD;
  float* sv = sp + BK * LD;
  float* ss = sv + BK * LD;

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // key / feature column group
  const int ty = tid >> 4;  // owns query rows ty*4 .. ty*4+3
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;

  const T* q1b = q1 + b * st.q1[0] + h * st.q1[1];
  const T* q2b = q2 + b * st.q2[0] + h * st.q2[1];
  const T* kb = k + b * st.k[0] + h * st.k[1];
  const T* pb = p + b * st.p[0] + h * st.p[1];
  const T* vb = v + b * st.v[0] + h * st.v[1];
  const uint8_t* mb = mask == nullptr ? nullptr : mask + b * st.mask[0];

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D, t = q0 + r;
    float a = 0.f, w = 0.f;
    if (t < T1) {
      a = to_float(q1b[t * st.q1[2] + c]);
      w = to_float(q2b[t * st.q2[2] + c]);
    }
    sq1[r * LD + c] = a;
    sq2[r * LD + c] = w;
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
      float a = 0.f, w = 0.f, x = 0.f;
      if (t < T2) {
        a = to_float(kb[t * st.k[2] + c]);
        w = to_float(pb[t * st.p[2] + c]);
        x = to_float(vb[t * st.v[2] + c]);
      }
      sk[r * LD + c] = a;
      sp[r * LD + c] = w;
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
      float a1[4], a2[4], bk[4], bp[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a1[i] = sq1[(ty * 4 + i) * LD + c];
        a2[i] = sq2[(ty * 4 + i) * LD + c];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bk[j] = sk[(tx + 16 * j) * LD + c];
        bp[j] = sp[(tx + 16 * j) * LD + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] = fmaf(a1[i], bk[j], fmaf(a2[i], bp[j], s[i][j]));
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
      float row_max = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = k0 + tx + 16 * j;
        bool keep = r < T1 && t < T2;
        if (keep && mb != nullptr)
          keep = mb[r * st.mask[1] + t * st.mask[2]] != 0;
        s[i][j] = keep ? s[i][j] * scale : NEG_INF;
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
        if constexpr (DROPOUT)
          ss[(ty * 4 + i) * LDS + tx + 16 * j] =
              pr * dropout_mult(dp, blockIdx.y, r, k0 + tx + 16 * j);
        else
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
    if constexpr (WITH_LSE) {
      if (tx == 0)
        lse[static_cast<long long>(blockIdx.y) * T1 + r] =
            l[i] > 0.f ? m[i] + logf(l[i]) : NEG_INF;
    }
  }
}

struct Args {
  const void *q1, *q2, *k, *p, *v, *mask;
  void* out;
  float* lse;
  Strides st;
  int B, H, T1, T2;
  float scale;
  DropoutParams dp;
};

template <typename T, int D, bool WITH_LSE, bool DROPOUT>
int launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = relpos_fwd_kernel<T, D, WITH_LSE, DROPOUT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.T1 + BQ - 1) / BQ, a.B * a.H);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(a.q1), static_cast<const T*>(a.q2),
      static_cast<const T*>(a.k), static_cast<const T*>(a.p),
      static_cast<const T*>(a.v), static_cast<const uint8_t*>(a.mask),
      static_cast<T*>(a.out), a.lse, a.st, a.H, a.T1, a.T2, a.scale, a.dp);
  return static_cast<int>(cudaGetLastError());
}

// the inference kernel for d in {32, 64, 128}
template <typename T>
int launch_eval(int D, const Args& a, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32, false, false>(a, stream);
    case 64:
      return launch<T, 64, false, false>(a, stream);
    case 128:
      return launch<T, 128, false, false>(a, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the training kernel (lse, optional dropout) for d in {32, 64}, the head
// dims the backward kernels take
template <typename T>
int launch_train(int D, bool dropout, const Args& a, cudaStream_t stream) {
  switch (D) {
    case 32:
      return dropout ? launch<T, 32, true, true>(a, stream)
                     : launch<T, 32, true, false>(a, stream);
    case 64:
      return dropout ? launch<T, 64, true, true>(a, stream)
                     : launch<T, 64, true, false>(a, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

Args make_args(const void* q1, const void* q2, const void* k, const void* p,
               const void* v, const void* mask, void* out, float* lse,
               const long long* strides, int B, int H, int T1, int T2,
               float scale, DropoutParams dp) {
  Args a{q1, q2, k, p, v, mask, out, lse, {}, B, H, T1, T2, scale, dp};
  long long* dst[] = {a.st.q1, a.st.q2, a.st.k, a.st.p,
                      a.st.v,  a.st.out, a.st.mask};
  for (int t = 0; t < 7; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  return a;
}

}  // namespace

// strides: 21 element strides, (batch, head, time) for q1, q2, k, p, v and
// out, then (batch, row, column) for the mask.  mask may be null.
// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t code (0 = ok).
extern "C" int relpos_attention_fwd(const void* q1, const void* q2,
                                    const void* k, const void* p,
                                    const void* v, const void* mask,
                                    void* out, const long long* strides,
                                    int B, int H, int T1, int T2, int D,
                                    int dtype, float scale, void* stream) {
  const Args a = make_args(q1, q2, k, p, v, mask, out, nullptr, strides, B,
                           H, T1, T2, scale, DropoutParams{0, 0, 0.f});
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_eval<float>(D, a, s);
  if (dtype == 1) return launch_eval<__nv_bfloat16>(D, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The training forward: as above, plus lse (B, H, T1) fp32, contiguous,
// and, when `dropout` is non-zero, the hash dropout with (seed, thr,
// keep_scale) computed on the host.
extern "C" int relpos_attention_fwd_train(
    const void* q1, const void* q2, const void* k, const void* p,
    const void* v, const void* mask, void* out, float* lse,
    const long long* strides, int B, int H, int T1, int T2, int D,
    int dtype, float scale, int dropout, unsigned seed, unsigned thr,
    float keep_scale, void* stream) {
  const Args a = make_args(q1, q2, k, p, v, mask, out, lse, strides, B, H,
                           T1, T2, scale,
                           DropoutParams{seed, thr, keep_scale});
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_train<float>(D, dropout != 0, a, s);
  if (dtype == 1) return launch_train<__nv_bfloat16>(D, dropout != 0, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
