// Fused rel-pos attention backward for Hopper (sm_90a), plain C entry
// points.  Two kernels, as in the TPU version:
//
//   K2 relpos_bwd_dq_kernel    replaces `_relpos_bwd_dq_kernel`
//   K3 relpos_bwd_dkpv_kernel  replaces `_relpos_bwd_dkpv_kernel`
//
// (wenet_tpu/ops/flash_attention.py, reached there through the custom VJP
// of `flash_attention_relpos`).  Both recompute, tile by tile, what the
// forward kernel (relpos_attention.cu) computed, from the saved row
// log-sum-exp instead of the (T1, T2) probabilities:
//
//   s  = (q1 . k^T + q2 . p^T) * scale, NEG_INF where masked
//   P  = exp(s - lse), 0 where s <= NEG_INF / 2
//   dP = D . (do . v^T)                  D: the dropout hash multiplier
//   ds = P . (dP - delta) * scale        delta = rowsum(do . out), given
//
//   K2:  dq1 = ds . k,  dq2 = ds . p
//   K3:  dv = (P . D)^T . do,  dk = ds^T . q1,  dp = ds^T . q2
//
// Neither writes a (T1, T2) tensor to device memory.  K2 gives one block
// to (64 query rows, b*h): q1, q2, do are staged once, 64-key tiles of k,
// p, v stream through shared memory, dq1/dq2 accumulate in fp32
// registers.  K3 gives one block to (64 keys, b*h): k, p, v are staged
// once, 64-row tiles of q1, q2, do, lse and delta stream through, and
// dk, dp, dv accumulate in fp32 registers.  Neither needs a reduction
// across blocks.  The dropout hash is evaluated at the GLOBAL (query, key)
// position, so both kernels regenerate the forward's mask exactly.
//
// Contract (as the forward): NEG_INF = -1e30; fully masked rows have
// lse = NEG_INF, so P = 0: zero dq, nothing added to dk/dp/dv; fp32 and
// bf16 inputs are upcast on load and all math is fp32; ragged T1 / T2
// edges are bounds-checked, not padded; p may be shared by the batch
// (batch stride 0) and the mask may be one row for all queries (row
// stride 0).  Gradients are written per (b, h): dp in fp32, summed over
// the batch by the caller when p was shared.
//
// What bounds it on an H100: as the forward, five fp32 products of 64x64
// tiles on the CUDA cores (FMA issue and the shared-memory reads feeding
// it).  Each thread owns a 4x4 block of the score tile, so each
// shared-memory read of the score phase feeds 2 FMAs.  Shared memory at
// d = 64: K2 116,480 bytes, K3 133,632 bytes (one block per SM); d = 128
// does not fit K3's tiles, so training takes d in {32, 64}.

#include "dropout_hash.cuh"
#include "relpos_common.cuh"

namespace {

using relpos::BK;
using relpos::BQ;
using relpos::from_float;
using relpos::NEG_INF;
using relpos::THREADS;
using relpos::to_float;

// Element strides of (batch, head, time) per operand (unit feature
// stride); the mask has (batch, row, column).
struct Strides {
  long long q1[3], q2[3], k[3], p[3], v[3], dout[3];
  long long dq1[3], dq2[3], dk[3], dp[3], dv[3];
  long long mask[3];
};

struct Args {
  const void *q1, *q2, *k, *p, *v, *mask, *dout;
  const float *lse, *delta;
  void *g0, *g1, *g2;  // K2: dq1, dq2; K3: dk, dp (fp32), dv
  Strides st;
  int B, H, T1, T2;
  float scale;
  DropoutParams dp;
};

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * ((3 * BQ + 3 * BK) * (D + 1) + BQ * (BK + 1));
}

template <int D>
constexpr size_t dkpv_smem_bytes() {
  return sizeof(float) *
         ((3 * BK + 3 * BQ) * (D + 1) + 2 * BK * (BQ + 1) + 2 * BQ);
}

// Stage `rows` rows of a (T, D) operand, starting at row t0, into a
// shared-memory tile with padded row length D + 1, upcast to fp32; rows
// past T are zero.  `ts` is the operand's time stride (unit feature stride).
template <typename T, int D>
__device__ __forceinline__ void stage_rows(float* dst, const T* src,
                                           long long ts, int t0, int T_len,
                                           int rows) {
  for (int i = threadIdx.x; i < rows * D; i += THREADS) {
    const int r = i / D, c = i % D, t = t0 + r;
    dst[r * (D + 1) + c] = t < T_len ? to_float(src[t * ts + c]) : 0.f;
  }
}

// the mask bit for (row r, column t), both in range
__device__ __forceinline__ bool attend(const uint8_t* mb, const Strides& st,
                                       int r, int t) {
  return mb == nullptr || mb[r * st.mask[1] + t * st.mask[2]] != 0;
}

// ---------------------------------------------------------------------------
// K2: dq1, dq2.  Thread (ty, tx) owns query rows ty*4+i, score columns
// tx+16j and output columns tx+16c.
// ---------------------------------------------------------------------------
template <typename T, int D, bool DROPOUT>
__global__ void __launch_bounds__(THREADS)
    relpos_bwd_dq_kernel(const T* __restrict__ q1, const T* __restrict__ q2,
                         const T* __restrict__ k, const T* __restrict__ p,
                         const T* __restrict__ v,
                         const uint8_t* __restrict__ mask,
                         const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         T* __restrict__ dq1, T* __restrict__ dq2, Strides st,
                         int H, int T1, int T2, float scale,
                         DropoutParams dp) {
  constexpr int LD = D + 1;
  constexpr int LDS = BK + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* sq1 = smem;
  float* sq2 = sq1 + BQ * LD;
  float* sdo = sq2 + BQ * LD;
  float* sk = sdo + BQ * LD;
  float* sp = sk + BK * LD;
  float* sv = sp + BK * LD;
  float* sds = sv + BK * LD;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const uint8_t* mb = mask == nullptr ? nullptr : mask + b * st.mask[0];
  const T* kb = k + b * st.k[0] + h * st.k[1];
  const T* pb = p + b * st.p[0] + h * st.p[1];
  const T* vb = v + b * st.v[0] + h * st.v[1];

  stage_rows<T, D>(sq1, q1 + b * st.q1[0] + h * st.q1[1], st.q1[2], q0, T1,
                   BQ);
  stage_rows<T, D>(sq2, q2 + b * st.q2[0] + h * st.q2[1], st.q2[2], q0, T1,
                   BQ);
  stage_rows<T, D>(sdo, dout + b * st.dout[0] + h * st.dout[1], st.dout[2],
                   q0, T1, BQ);
  float row_lse[4], row_delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    row_lse[i] = r < T1 ? lse[static_cast<long long>(bh) * T1 + r] : 0.f;
    row_delta[i] = r < T1 ? delta[static_cast<long long>(bh) * T1 + r] : 0.f;
  }

  float acc1[4][DC], acc2[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc1[i][c] = acc2[i][c] = 0.f;

  for (int k0 = 0; k0 < T2; k0 += BK) {
    __syncthreads();  // the previous tiles are no longer read
    stage_rows<T, D>(sk, kb, st.k[2], k0, T2, BK);
    stage_rows<T, D>(sp, pb, st.p[2], k0, T2, BK);
    stage_rows<T, D>(sv, vb, st.v[2], k0, T2, BK);
    __syncthreads();

    float s[4][4], g[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = g[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float a1[4], a2[4], ad[4], bk[4], bp[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a1[i] = sq1[(ty * 4 + i) * LD + c];
        a2[i] = sq2[(ty * 4 + i) * LD + c];
        ad[i] = sdo[(ty * 4 + i) * LD + c];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bk[j] = sk[(tx + 16 * j) * LD + c];
        bp[j] = sp[(tx + 16 * j) * LD + c];
        bv[j] = sv[(tx + 16 * j) * LD + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a1[i], bk[j], fmaf(a2[i], bp[j], s[i][j]));
          g[i][j] = fmaf(ad[i], bv[j], g[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = k0 + tx + 16 * j;
        const bool keep = r < T1 && t < T2 && attend(mb, st, r, t);
        const float sc = keep ? s[i][j] * scale : NEG_INF;
        const float pr =
            sc <= NEG_INF * 0.5f ? 0.f : expf(sc - row_lse[i]);
        float dpv = g[i][j];
        if constexpr (DROPOUT) dpv *= dropout_mult(dp, bh, r, t);
        sds[(ty * 4 + i) * LDS + tx + 16 * j] =
            pr * (dpv - row_delta[i]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float d[4], xk[DC], xp[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) d[i] = sds[(ty * 4 + i) * LDS + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        xk[c] = sk[j * LD + tx + 16 * c];
        xp[c] = sp[j * LD + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          acc1[i][c] = fmaf(d[i], xk[c], acc1[i][c]);
          acc2[i][c] = fmaf(d[i], xp[c], acc2[i][c]);
        }
    }
  }

  T* o1 = dq1 + b * st.dq1[0] + h * st.dq1[1];
  T* o2 = dq2 + b * st.dq2[0] + h * st.dq2[1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= T1) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      o1[r * st.dq1[2] + tx + 16 * c] = from_float<T>(acc1[i][c]);
      o2[r * st.dq2[2] + tx + 16 * c] = from_float<T>(acc2[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// K3: dk, dp, dv.  Thread (ty, tx) owns keys ty*4+i, score columns (query
// rows of the tile) tx+16j and output columns tx+16c.
// ---------------------------------------------------------------------------
template <typename T, int D, bool DROPOUT>
__global__ void __launch_bounds__(THREADS)
    relpos_bwd_dkpv_kernel(const T* __restrict__ q1,
                           const T* __restrict__ q2, const T* __restrict__ k,
                           const T* __restrict__ p, const T* __restrict__ v,
                           const uint8_t* __restrict__ mask,
                           const T* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           T* __restrict__ dk, float* __restrict__ dpos,
                           T* __restrict__ dv, Strides st, int H, int T1,
                           int T2, float scale, DropoutParams dp) {
  constexpr int LD = D + 1;
  constexpr int LDS = BQ + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* sk = smem;
  float* sp = sk + BK * LD;
  float* sv = sp + BK * LD;
  float* sq1 = sv + BK * LD;
  float* sq2 = sq1 + BQ * LD;
  float* sdo = sq2 + BQ * LD;
  float* spv = sdo + BQ * LD;  // (P . D)^T, keys x query rows
  float* sds = spv + BK * LDS; // ds^T
  float* slse = sds + BK * LDS;
  float* sdelta = slse + BQ;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.x * BK;
  const uint8_t* mb = mask == nullptr ? nullptr : mask + b * st.mask[0];
  const T* q1b = q1 + b * st.q1[0] + h * st.q1[1];
  const T* q2b = q2 + b * st.q2[0] + h * st.q2[1];
  const T* dob = dout + b * st.dout[0] + h * st.dout[1];

  stage_rows<T, D>(sk, k + b * st.k[0] + h * st.k[1], st.k[2], k0, T2, BK);
  stage_rows<T, D>(sp, p + b * st.p[0] + h * st.p[1], st.p[2], k0, T2, BK);
  stage_rows<T, D>(sv, v + b * st.v[0] + h * st.v[1], st.v[2], k0, T2, BK);

  float acc_k[4][DC], acc_p[4][DC], acc_v[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc_k[i][c] = acc_p[i][c] = acc_v[i][c] = 0.f;

  for (int q0 = 0; q0 < T1; q0 += BQ) {
    __syncthreads();  // the previous tiles are no longer read
    stage_rows<T, D>(sq1, q1b, st.q1[2], q0, T1, BQ);
    stage_rows<T, D>(sq2, q2b, st.q2[2], q0, T1, BQ);
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
      float ak[4], ap[4], av[4], b1[4], b2[4], bd[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ak[i] = sk[(ty * 4 + i) * LD + c];
        ap[i] = sp[(ty * 4 + i) * LD + c];
        av[i] = sv[(ty * 4 + i) * LD + c];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b1[j] = sq1[(tx + 16 * j) * LD + c];
        b2[j] = sq2[(tx + 16 * j) * LD + c];
        bd[j] = sdo[(tx + 16 * j) * LD + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(b1[j], ak[i], fmaf(b2[j], ap[i], s[i][j]));
          g[i][j] = fmaf(bd[j], av[i], g[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = k0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int rr = tx + 16 * j;
        const int r = q0 + rr;
        const bool keep = r < T1 && t < T2 && attend(mb, st, r, t);
        const float sc = keep ? s[i][j] * scale : NEG_INF;
        const float pr = sc <= NEG_INF * 0.5f ? 0.f : expf(sc - slse[rr]);
        float pv = pr, dpv = g[i][j];
        if constexpr (DROPOUT) {
          const float dm = dropout_mult(dp, bh, r, t);
          pv = pr * dm;
          dpv *= dm;
        }
        spv[(ty * 4 + i) * LDS + rr] = pv;
        sds[(ty * 4 + i) * LDS + rr] = pr * (dpv - sdelta[rr]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int rr = 0; rr < BQ; ++rr) {
      float a_pv[4], a_ds[4], x1[DC], x2[DC], xd[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a_pv[i] = spv[(ty * 4 + i) * LDS + rr];
        a_ds[i] = sds[(ty * 4 + i) * LDS + rr];
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        x1[c] = sq1[rr * LD + tx + 16 * c];
        x2[c] = sq2[rr * LD + tx + 16 * c];
        xd[c] = sdo[rr * LD + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          acc_v[i][c] = fmaf(a_pv[i], xd[c], acc_v[i][c]);
          acc_k[i][c] = fmaf(a_ds[i], x1[c], acc_k[i][c]);
          acc_p[i][c] = fmaf(a_ds[i], x2[c], acc_p[i][c]);
        }
    }
  }

  T* ok = dk + b * st.dk[0] + h * st.dk[1];
  float* op = dpos + b * st.dp[0] + h * st.dp[1];
  T* ov = dv + b * st.dv[0] + h * st.dv[1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = k0 + ty * 4 + i;
    if (t >= T2) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      ok[t * st.dk[2] + col] = from_float<T>(acc_k[i][c]);
      op[t * st.dp[2] + col] = acc_p[i][c];
      ov[t * st.dv[2] + col] = from_float<T>(acc_v[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
template <typename T, int D, bool DROPOUT>
int launch_dq(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  auto kernel = relpos_bwd_dq_kernel<T, D, DROPOUT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.T1 + BQ - 1) / BQ, a.B * a.H);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(a.q1), static_cast<const T*>(a.q2),
      static_cast<const T*>(a.k), static_cast<const T*>(a.p),
      static_cast<const T*>(a.v), static_cast<const uint8_t*>(a.mask),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.g0),
      static_cast<T*>(a.g1), a.st, a.H, a.T1, a.T2, a.scale, a.dp);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, bool DROPOUT>
int launch_dkpv(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = dkpv_smem_bytes<D>();
  auto kernel = relpos_bwd_dkpv_kernel<T, D, DROPOUT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.T2 + BK - 1) / BK, a.B * a.H);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(a.q1), static_cast<const T*>(a.q2),
      static_cast<const T*>(a.k), static_cast<const T*>(a.p),
      static_cast<const T*>(a.v), static_cast<const uint8_t*>(a.mask),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.g0),
      static_cast<float*>(a.g1), static_cast<T*>(a.g2), a.st, a.H, a.T1,
      a.T2, a.scale, a.dp);
  return static_cast<int>(cudaGetLastError());
}

// dispatch on (dtype, head dim, dropout) to launch_dq or launch_dkpv
template <bool DQ, typename T, int D>
int launch_one(bool dropout, const Args& a, cudaStream_t s) {
  if constexpr (DQ)
    return dropout ? launch_dq<T, D, true>(a, s) : launch_dq<T, D, false>(a, s);
  else
    return dropout ? launch_dkpv<T, D, true>(a, s)
                   : launch_dkpv<T, D, false>(a, s);
}

template <bool DQ>
int dispatch(int dtype, int D, bool dropout, const Args& a, cudaStream_t s) {
  if (dtype == 0 && D == 32) return launch_one<DQ, float, 32>(dropout, a, s);
  if (dtype == 0 && D == 64) return launch_one<DQ, float, 64>(dropout, a, s);
  if (dtype == 1 && D == 32)
    return launch_one<DQ, __nv_bfloat16, 32>(dropout, a, s);
  if (dtype == 1 && D == 64)
    return launch_one<DQ, __nv_bfloat16, 64>(dropout, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

Args make_args(const void* q1, const void* q2, const void* k, const void* p,
               const void* v, const void* mask, const void* dout,
               const float* lse, const float* delta, void* g0, void* g1,
               void* g2, const long long* strides, int B, int H, int T1,
               int T2, float scale, DropoutParams dp) {
  Args a{q1, q2, k, p, v, mask, dout, lse, delta, g0, g1, g2, {},
         B,  H,  T1, T2, scale, dp};
  long long* dst[] = {a.st.q1,  a.st.q2,  a.st.k,  a.st.p,
                      a.st.v,   a.st.dout, a.st.dq1, a.st.dq2,
                      a.st.dk,  a.st.dp,  a.st.dv, a.st.mask};
  for (int t = 0; t < 12; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  return a;
}

}  // namespace

// strides: 36 element strides, (batch, head, time) for q1, q2, k, p, v, do,
// dq1, dq2, dk, dp, dv (the slots a kernel does not write may be 0), then
// (batch, row, column) for the mask.  mask may be null.  lse and delta:
// contiguous (B, H, T1) fp32.  dtype: 0 = float32, 1 = bfloat16; D in
// {32, 64}.  dropout != 0 turns on the hash dropout with (seed, thr,
// keep_scale) from the host.  Each returns a cudaError_t code (0 = ok).
extern "C" int relpos_attention_bwd_dq(
    const void* q1, const void* q2, const void* k, const void* p,
    const void* v, const void* mask, const void* dout, const float* lse,
    const float* delta, void* dq1, void* dq2, const long long* strides,
    int B, int H, int T1, int T2, int D, int dtype, float scale, int dropout,
    unsigned seed, unsigned thr, float keep_scale, void* stream) {
  const Args a = make_args(q1, q2, k, p, v, mask, dout, lse, delta, dq1, dq2,
                           nullptr, strides, B, H, T1, T2, scale,
                           DropoutParams{seed, thr, keep_scale});
  return dispatch<true>(dtype, D, dropout != 0, a,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int relpos_attention_bwd_dkpv(
    const void* q1, const void* q2, const void* k, const void* p,
    const void* v, const void* mask, const void* dout, const float* lse,
    const float* delta, void* dk, void* dp, void* dv,
    const long long* strides, int B, int H, int T1, int T2, int D, int dtype,
    float scale, int dropout, unsigned seed, unsigned thr, float keep_scale,
    void* stream) {
  const Args a = make_args(q1, q2, k, p, v, mask, dout, lse, delta, dk, dp,
                           dv, strides, B, H, T1, T2, scale,
                           DropoutParams{seed, thr, keep_scale});
  return dispatch<false>(dtype, D, dropout != 0, a,
                         static_cast<cudaStream_t>(stream));
}
