// Masked flash attention backward for Hopper (sm_90a), plain C entry
// points.  Two kernels, as in the TPU version:
//
//   K5 flash_bwd_dq_kernel   replaces `_bwd_dq_kernel`
//   K6 flash_bwd_dkv_kernel  replaces `_bwd_dkv_kernel`
//
// (wenet_tpu/ops/flash_attention.py, reached there through the custom VJP
// of `flash_attention`, which `attention_core` calls for long sequences:
// whisper's 1500-frame encoder in training).  Both recompute, tile by
// tile, what the forward kernel (flash_attention.cu, train variant)
// computed, from the saved row log-sum-exp instead of the (T1, T2)
// probabilities:
//
//   s  = (q . k^T + bias) * scale, NEG_INF where masked
//   P  = exp(s - lse), 0 where s <= NEG_INF / 2
//   ds = P . (do . v^T - delta) * scale    delta = rowsum(do . out), given
//
//   K5:  dq = ds . k, and dbias = ds (only when there is a bias)
//   K6:  dv = P^T . do,  dk = ds^T . q
//
// K5 gives one block to (64 query rows, b*h): q and do are staged once,
// 64-key tiles of k and v stream through shared memory, dq accumulates in
// fp32 registers.  K6 gives one block to (64 keys, b*h): k and v are
// staged once, 64-row tiles of q, do, lse and delta stream through, and
// dk, dv accumulate in fp32 registers.  Neither needs a reduction across
// blocks (no atomics), so the results do not depend on the schedule.
// dbias is written per (b, h) as a contiguous (B, h, T1, T2) fp32 array;
// the caller sums it over the dims the bias broadcast over.
//
// Contract (as the forward): NEG_INF = -1e30; fully masked rows have
// lse = NEG_INF, so P = 0: zero dq and dbias, nothing added to dk and dv;
// fp32 and bf16 inputs are upcast on load and all math is fp32; ragged
// T1 / T2 edges are bounds-checked, not padded.  q, k, v, do and the
// gradients are read and written through (batch, head, time) strides with
// a unit-stride feature dim (the attention module's (B, T, h, d)
// buffers), the mask (B|1, 1|h, 1|T1, T2) and the fp32 bias through their
// own strides, 0 on a broadcast dim.
//
// What bounds it on an H100: as the forward, fp32 products of 64x64 tiles
// on the CUDA cores (67 TFLOP/s FFMA), fed from shared memory: K5 does
// three (q.k^T, do.v^T, ds.k: 6 d FLOPs per attended pair), K6 four
// (q.k^T, do.v^T, ds^T.q, P^T.do: 8 d), against a few bytes per pair of
// device traffic, so FMA issue bounds both, far from the 3.35 TB/s memory
// line (except K5's dbias write, 4 bytes per pair, which only small
// shapes have).  Each thread owns a 4x4 block of the score tile, so each
// shared-memory read of the score phase feeds 2 FMAs; rows are padded by
// one float.  Shared memory at d = 64: K5 83,200 bytes, K6 100,352; at
// d = 128: K5 148,736, K6 165,888 (under the 227 KB a block may take).
// wgmma on bf16 tiles and TMA loads are the later step.

#include "relpos_common.cuh"

namespace {

using relpos::BK;
using relpos::BQ;
using relpos::from_float;
using relpos::NEG_INF;
using relpos::THREADS;
using relpos::to_float;

// Element strides: (batch, head, time) for q, k, v, do and the two
// gradient slots g0, g1 (K5: dq, unused; K6: dk, dv), each with a
// unit-stride feature dim; (batch, head, row, column) for mask and bias.
struct Strides {
  long long q[3], k[3], v[3], dout[3], g0[3], g1[3];
  long long mask[4], bias[4];
};

struct Args {
  const void *q, *k, *v, *mask;
  const float* bias;
  const void* dout;
  const float *lse, *delta;
  void *g0, *g1;  // K5: dq, dbias (fp32, null without a bias); K6: dk, dv
  Strides st;
  int B, H, T1, T2;
  float scale;
};

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * ((2 * BQ + 2 * BK) * (D + 1) + BQ * (BK + 1));
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) *
         ((2 * BK + 2 * BQ) * (D + 1) + 2 * BK * (BQ + 1) + 2 * BQ);
}

// Stage `rows` rows of a (T, D) operand, starting at row t0, into a
// shared-memory tile with padded row length D + 1, upcast to fp32; rows
// past T are zero.  `ts` is the operand's time stride.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(float* dst, const T* src,
                                           long long ts, int t0, int T_len,
                                           int rows) {
  for (int i = threadIdx.x; i < rows * D; i += THREADS) {
    const int r = i / D, c = i % D, t = t0 + r;
    dst[r * (D + 1) + c] = t < T_len ? to_float(src[t * ts + c]) : 0.f;
  }
}

// The score of (query row r, key t) from the product x = q_r . k_t, as
// the forward computes it: (x + bias) * scale, NEG_INF where masked or
// out of range.  mb and bb point at this (batch, head)'s mask and bias.
__device__ __forceinline__ float score(float x, const uint8_t* mb,
                                       const float* bb, const Strides& st,
                                       int r, int t, int T1, int T2,
                                       float scale) {
  if (r >= T1 || t >= T2) return NEG_INF;
  if (mb != nullptr && mb[r * st.mask[2] + t * st.mask[3]] == 0)
    return NEG_INF;
  if (bb != nullptr) x += bb[r * st.bias[2] + t * st.bias[3]];
  return x * scale;
}

// ---------------------------------------------------------------------------
// K5: dq (and dbias).  Thread (ty, tx) owns query rows ty*4+i, score
// columns tx+16j and output columns tx+16c.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const uint8_t* __restrict__ mask,
                        const float* __restrict__ bias,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        float* __restrict__ dbias, Strides st, int H, int T1,
                        int T2, float scale) {
  constexpr int LD = D + 1;
  constexpr int LDS = BK + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* sq = smem;
  float* sdo = sq + BQ * LD;
  float* sk = sdo + BQ * LD;
  float* sv = sk + BK * LD;
  float* sds = sv + BK * LD;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const uint8_t* mb =
      mask == nullptr ? nullptr : mask + b * st.mask[0] + h * st.mask[1];
  const float* bb =
      bias == nullptr ? nullptr : bias + b * st.bias[0] + h * st.bias[1];
  float* db = dbias == nullptr
                  ? nullptr
                  : dbias + static_cast<long long>(bh) * T1 * T2;
  const T* kb = k + b * st.k[0] + h * st.k[1];
  const T* vb = v + b * st.v[0] + h * st.v[1];

  stage_rows<T, D>(sq, q + b * st.q[0] + h * st.q[1], st.q[2], q0, T1, BQ);
  stage_rows<T, D>(sdo, dout + b * st.dout[0] + h * st.dout[1], st.dout[2],
                   q0, T1, BQ);
  float row_lse[4], row_delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    row_lse[i] = r < T1 ? lse[static_cast<long long>(bh) * T1 + r] : 0.f;
    row_delta[i] = r < T1 ? delta[static_cast<long long>(bh) * T1 + r] : 0.f;
  }

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < T2; k0 += BK) {
    __syncthreads();  // the previous tiles are no longer read
    stage_rows<T, D>(sk, kb, st.k[2], k0, T2, BK);
    stage_rows<T, D>(sv, vb, st.v[2], k0, T2, BK);
    __syncthreads();

    float s[4][4], g[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = g[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float aq[4], ad[4], bk[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        aq[i] = sq[(ty * 4 + i) * LD + c];
        ad[i] = sdo[(ty * 4 + i) * LD + c];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bk[j] = sk[(tx + 16 * j) * LD + c];
        bv[j] = sv[(tx + 16 * j) * LD + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(aq[i], bk[j], s[i][j]);
          g[i][j] = fmaf(ad[i], bv[j], g[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = k0 + tx + 16 * j;
        const float sc = score(s[i][j], mb, bb, st, r, t, T1, T2, scale);
        const float pr =
            sc <= NEG_INF * 0.5f ? 0.f : expf(sc - row_lse[i]);
        const float ds = pr * (g[i][j] - row_delta[i]) * scale;
        sds[(ty * 4 + i) * LDS + tx + 16 * j] = ds;
        if (db != nullptr && r < T1 && t < T2)
          db[static_cast<long long>(r) * T2 + t] = ds;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float d[4], xk[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) d[i] = sds[(ty * 4 + i) * LDS + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) xk[c] = sk[j * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(d[i], xk[c], acc[i][c]);
    }
  }

  T* o = dq + b * st.g0[0] + h * st.g0[1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= T1) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      o[r * st.g0[2] + tx + 16 * c] = from_float<T>(acc[i][c]);
  }
}

// ---------------------------------------------------------------------------
// K6: dk, dv.  Thread (ty, tx) owns keys ty*4+i, score columns (query rows
// of the tile) tx+16j and output columns tx+16c.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const uint8_t* __restrict__ mask,
                         const float* __restrict__ bias,
                         const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, Strides st,
                         int H, int T1, int T2, float scale) {
  constexpr int LD = D + 1;
  constexpr int LDS = BQ + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* sk = smem;
  float* sv = sk + BK * LD;
  float* sq = sv + BK * LD;
  float* sdo = sq + BQ * LD;
  float* sp = sdo + BQ * LD;    // P^T, keys x query rows
  float* sds = sp + BK * LDS;   // ds^T
  float* slse = sds + BK * LDS;
  float* sdelta = slse + BQ;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.x * BK;
  const uint8_t* mb =
      mask == nullptr ? nullptr : mask + b * st.mask[0] + h * st.mask[1];
  const float* bb =
      bias == nullptr ? nullptr : bias + b * st.bias[0] + h * st.bias[1];
  const T* qb = q + b * st.q[0] + h * st.q[1];
  const T* dob = dout + b * st.dout[0] + h * st.dout[1];

  stage_rows<T, D>(sk, k + b * st.k[0] + h * st.k[1], st.k[2], k0, T2, BK);
  stage_rows<T, D>(sv, v + b * st.v[0] + h * st.v[1], st.v[2], k0, T2, BK);

  float acc_k[4][DC], acc_v[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  for (int q0 = 0; q0 < T1; q0 += BQ) {
    __syncthreads();  // the previous tiles are no longer read
    stage_rows<T, D>(sq, qb, st.q[2], q0, T1, BQ);
    stage_rows<T, D>(sdo, dob, st.dout[2], q0, T1, BQ);
    if (threadIdx.x < BQ) {
      const int r = q0 + threadIdx.x;
      const long long o = static_cast<long long>(bh) * T1 + r;
      slse[threadIdx.x] = r < T1 ? lse[o] : 0.f;
      sdelta[threadIdx.x] = r < T1 ? delta[o] : 0.f;
    }
    __syncthreads();

    float s[4][4], g[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = g[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float ak[4], av[4], bq[4], bd[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ak[i] = sk[(ty * 4 + i) * LD + c];
        av[i] = sv[(ty * 4 + i) * LD + c];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bq[j] = sq[(tx + 16 * j) * LD + c];
        bd[j] = sdo[(tx + 16 * j) * LD + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(bq[j], ak[i], s[i][j]);
          g[i][j] = fmaf(bd[j], av[i], g[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = k0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int rr = tx + 16 * j;
        const float sc = score(s[i][j], mb, bb, st, q0 + rr, t, T1, T2,
                               scale);
        const float pr = sc <= NEG_INF * 0.5f ? 0.f : expf(sc - slse[rr]);
        sp[(ty * 4 + i) * LDS + rr] = pr;
        sds[(ty * 4 + i) * LDS + rr] = pr * (g[i][j] - sdelta[rr]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int rr = 0; rr < BQ; ++rr) {
      float a_p[4], a_ds[4], xq[DC], xd[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a_p[i] = sp[(ty * 4 + i) * LDS + rr];
        a_ds[i] = sds[(ty * 4 + i) * LDS + rr];
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        xq[c] = sq[rr * LD + tx + 16 * c];
        xd[c] = sdo[rr * LD + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          acc_v[i][c] = fmaf(a_p[i], xd[c], acc_v[i][c]);
          acc_k[i][c] = fmaf(a_ds[i], xq[c], acc_k[i][c]);
        }
    }
  }

  T* ok = dk + b * st.g0[0] + h * st.g0[1];
  T* ov = dv + b * st.g1[0] + h * st.g1[1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = k0 + ty * 4 + i;
    if (t >= T2) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      ok[t * st.g0[2] + col] = from_float<T>(acc_k[i][c]);
      ov[t * st.g1[2] + col] = from_float<T>(acc_v[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
template <typename T, int D>
int launch_dq(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  auto kernel = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.T1 + BQ - 1) / BQ, a.B * a.H);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const uint8_t*>(a.mask),
      a.bias, static_cast<const T*>(a.dout), a.lse, a.delta,
      static_cast<T*>(a.g0), static_cast<float*>(a.g1), a.st, a.H, a.T1,
      a.T2, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.T2 + BK - 1) / BK, a.B * a.H);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const uint8_t*>(a.mask),
      a.bias, static_cast<const T*>(a.dout), a.lse, a.delta,
      static_cast<T*>(a.g0), static_cast<T*>(a.g1), a.st, a.H, a.T1, a.T2,
      a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool DQ, typename T, int D>
int launch_one(const Args& a, cudaStream_t s) {
  if constexpr (DQ)
    return launch_dq<T, D>(a, s);
  else
    return launch_dkv<T, D>(a, s);
}

template <bool DQ, typename T>
int launch_d(int D, const Args& a, cudaStream_t s) {
  switch (D) {
    case 32:
      return launch_one<DQ, T, 32>(a, s);
    case 64:
      return launch_one<DQ, T, 64>(a, s);
    case 128:
      return launch_one<DQ, T, 128>(a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool DQ>
int dispatch(const void* q, const void* k, const void* v, const void* mask,
             const void* bias, const void* dout, const void* lse,
             const void* delta, void* g0, void* g1,
             const long long* strides, int B, int H, int T1, int T2, int D,
             int dtype, float scale, void* stream) {
  Args a{q, k, v, mask, static_cast<const float*>(bias), dout,
         static_cast<const float*>(lse), static_cast<const float*>(delta),
         g0, g1, {}, B, H, T1, T2, scale};
  long long* dst[] = {a.st.q, a.st.k, a.st.v, a.st.dout, a.st.g0, a.st.g1};
  for (int t = 0; t < 6; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  for (int i = 0; i < 4; ++i) {
    a.st.mask[i] = strides[18 + i];
    a.st.bias[i] = strides[22 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<DQ, float>(D, a, s);
  if (dtype == 1) return launch_d<DQ, __nv_bfloat16>(D, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// strides: 26 element strides, (batch, head, time) for q, k, v, do and the
// two gradient slots (K5: dq, then 0s; K6: dk, dv), then (batch, head,
// row, column) for the mask and for the bias.  mask (uint8, non-zero ==
// attend) and bias (float32) may be null; K5 writes dbias, contiguous
// (B, H, T1, T2) fp32, only when it is not null.  lse and delta:
// contiguous (B, H, T1) fp32.  dtype: 0 = float32, 1 = bfloat16 (q, k, v,
// do and the gradients); D in {32, 64, 128}.  Each returns a cudaError_t
// code (0 = ok).
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* mask,
                                      const void* bias, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, void* dbias,
                                      const long long* strides, int B, int H,
                                      int T1, int T2, int D, int dtype,
                                      float scale, void* stream) {
  return dispatch<true>(q, k, v, mask, bias, dout, lse, delta, dq, dbias,
                        strides, B, H, T1, T2, D, dtype, scale, stream);
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* mask,
                                       const void* bias, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv,
                                       const long long* strides, int B,
                                       int H, int T1, int T2, int D,
                                       int dtype, float scale,
                                       void* stream) {
  return dispatch<false>(q, k, v, mask, bias, dout, lse, delta, dk, dv,
                         strides, B, H, T1, T2, D, dtype, scale, stream);
}
