// Masked flash attention forward for Hopper (sm_90a), plain C entry points.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` (wenet_tpu/ops/
// flash_attention.py:68, called at :222), reached there through
// `flash_attention` from `attention_core` for long sequences (whisper's
// 1500-frame encoder), in both its variants: inference
// (`flash_attention_fwd`) and training (`flash_attention_fwd_train`,
// has_lse), which also writes the row log-sum-exp lse = m + log l
// (NEG_INF on fully masked rows) that the backward kernels
// (flash_attention_bwd.cu) read.  For every (batch, head) it computes
//
//   s   = (q . k^T + bias) * scale      bias added BEFORE the scale
//   s   = mask ? s : NEG_INF            mask: True (non-zero) == attend
//   out = softmax(s) . v
//
// without writing the (T1, T2) scores to device memory: one block, one
// warpgroup of 128 threads, owns BQ = 64 query rows of one (batch, head),
// walks the keys in BK = 64-wide tiles staged in shared memory, and keeps
// the running max m, normalizer l and output accumulator in fp32
// registers (online softmax), in wgmma's accumulator layout.
//
// Kernel contract, shared with the TPU kernel:
//   * NEG_INF is the finite sentinel -1e30, and a probability is zeroed
//     where s <= NEG_INF / 2, so l counts only attendable keys;
//   * a fully masked row writes zeros (and lse = NEG_INF);
//   * the products are exact or split to fp32 accuracy (below), softmax
//     and accumulation are fp32, and the output has v's type.
// Ragged T1 / T2 edges are zero-filled on load and masked.  q, k, v and
// out are read and written through (batch, head, time) strides with a
// unit-stride feature dim, so the attention module's (B, T, h, d) buffers
// are used in place; their base and strides must be 16-byte aligned (the
// wrapper checks).  The mask (B|1, 1|h, 1|T1, T2) and the fp32 bias
// (B|1, 1|h, 1|T1, T2) are read through their own strides, 0 on a
// broadcast dim: neither broadcast is materialized.  lse is a contiguous
// (B, h, T1) fp32 array (the TPU kernel's 128-lane copy of it is a TPU
// tiling artefact).
//
// What bounds it on an H100: 4 * d FLOPs per attended (query, key) pair
// against (T1 + 2 * T2) * d elements read, so the tensor cores, not the
// 3.35 TB/s memory: 989 TFLOP/s in bf16, and in fp32, which runs as
// three tf32 products, 495 / 3 TFLOP/s (67 TFLOP/s on the CUDA cores).
// The design:
//   * bf16: S = Q . K^T is wgmma m64n64k16 with Q and K read from shared
//     memory, both K-major as stored; O += P . V takes P from registers
//     (the accumulator layout of S is the register layout of wgmma's A)
//     and V as stored, MN-major, through the transpose bit.  P is split
//     into hi = bf16(P) and lo = bf16(P - hi) and both products go into
//     O, so P keeps 16 bits instead of bf16's 8: rounding P alone costs
//     2^-9 per probability, and on a peaked softmax (q scaled by 8, at
//     (2,2,100,150,64)) takes the output to 174% of the bf16 bar (atol
//     1e-3, rtol 8e-3 against fp32 on the same rounded inputs), where
//     hi + lo keeps it at 43%.
//   * fp32 (no plain tf32, which keeps 3 digits): 3xTF32.  Each operand
//     is split x = hi + lo, both rounded to tf32, and hi.hi + hi.lo +
//     lo.hi is accumulated in fp32 by wgmma m64nNk8.  wgmma does not
//     round its fp32 sums to nearest, so an O added to over the whole key
//     loop drifts from float64 several times further than cuBLAS's fp32
//     (chip_smoke 2b).  Each key tile's P . V therefore goes into a
//     zeroed fragment that FFMA adds to O; at d = 128, whose registers do
//     not hold a whole fragment beside O, 64 output columns at a time.
//     tf32 takes both operands K-major, so V is stored transposed as it
//     lands, with its keys permuted within each group of 8 so that S's
//     accumulator is P's A fragment without shuffles.
//   * loads: bf16 tiles come by cp.async into a ring of two stages, the
//     next tile's copy in flight while this one computes; fp32 tiles go
//     through registers to be split.  Tiles use wgmma's 128-byte swizzle
//     (hopper_mma.cuh).
//   * a key tile that the mask closes for every row of the block is
//     skipped: m, l and O would not change on it (the pad mask closes
//     about a fifth of whisper's padded batch).  A mask with one row (the
//     pad mask) is read one byte per key a tile ahead and voted by ballot,
//     so its loads stay off the tile's critical path (Walker).
// The softmax runs on the accumulator fragment: a thread holds two rows
// and sixteen columns of each tile, the row max is reduced over the four
// threads of a quad, and each thread keeps its own share of the row sum
// until the end.  The time goes to the per-element softmax and the
// mask, not to the tensor cores (timed with each part taken out in turn,
// PERF.md), so the softmax is one FMUL, FMNMX, FFMA and ex2.approx per
// element, with the mask select only on tiles the mask cuts.

#include "flash_tiles.cuh"

namespace {

using namespace flash;

// Element strides: (batch, head, time) for q, k, v and out, whose feature
// dim is unit-stride; (batch, head, row, column) for the mask and bias.
struct Strides {
  long long q[3], k[3], v[3], out[3];
  long long mask[4], bias[4];
};

// The bias of the open elements of a tile, added to its scores s (the
// product q . k^T in the accumulator layout of flash_tiles.cuh) before
// the softmax step.  bb: the bias of this (batch, head); c0: the tile's
// first key plus 2 tq.
__device__ __forceinline__ void add_bias(float (&s)[32], uint32_t bits,
                                         const float* bb, const Strides& st,
                                         int r0, int c0) {
#pragma unroll
  for (int i = 0; i < 32; ++i)
    if ((bits >> i) & 1u)
      s[i] += bb[(r0 + 8 * ((i >> 1) & 1)) * st.bias[2] +
                 (c0 + 8 * (i >> 2) + (i & 1)) * st.bias[3]];
}

// ---------------------------------------------------------------------------
// bf16: wgmma on bf16 tiles, cp.async into two stages
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t bf16_smem() {
  return 1024 + 2 * bf16_width<D>() * (BQ + 4 * BK);  // Q, 2 x (K, V)
}

// Four blocks an SM (at most 128 registers a thread) where the output
// fits: the tile loop is latency-bound, and a fourth block hides more of
// it than the registers it gives up.
template <int D, bool LSE>
__global__ void __launch_bounds__(THREADS, D < 128 ? 4 : 1)
    flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const uint8_t* __restrict__ mask,
                   const float* __restrict__ bias,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                   Strides st, int H, int T1, int T2, float scale) {
  constexpr int W = bf16_width<D>();
  constexpr int TILE_Q = BQ * W * 2, TILE_KV = BK * W * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u;
  auto stage_k = [&](int stage) { return sq + TILE_Q + 2 * stage * TILE_KV; };

  const int tid = threadIdx.x;
  const int tq = tid & 3;
  const int b = blockIdx.y / H, h = blockIdx.y % H, q0 = blockIdx.x * BQ;
  const int r0 = q0 + 16 * (tid >> 5) + ((tid & 31) >> 2);

  const __nv_bfloat16* kb = k + b * st.k[0] + h * st.k[1];
  const __nv_bfloat16* vb = v + b * st.v[0] + h * st.v[1];
  const uint8_t* mb =
      mask == nullptr ? nullptr : mask + b * st.mask[0] + h * st.mask[1];
  const float* bb =
      bias == nullptr ? nullptr : bias + b * st.bias[0] + h * st.bias[1];

  load_rows<D, BQ>(sq, q + b * st.q[0] + h * st.q[1], st.q[2], q0, T1, tid);
  cp_async_commit();
  __shared__ uint32_t votes[4];
  Walker walk{mb, st.mask[2], st.mask[3], T1, T2, r0, tq, tid >> 5, tid & 31,
              votes, mb == nullptr || st.mask[2] == 0};
  if (walk.cols) walk.prefetch();
  uint32_t bits;
  int kt = walk.next(bits);
  if (kt < T2) {
    load_rows<D, BK>(stage_k(0), kb, st.k[2], kt, T2, tid);
    load_rows<D, BK>(stage_k(0) + TILE_KV, vb, st.v[2], kt, T2, tid);
  }
  cp_async_commit();

  float o[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  int stage = 0;
  while (kt < T2) {
    // the vote is a barrier: every warp is done with the stage refilled
    uint32_t bits_next;
    const int kn = walk.next(bits_next);
    if (kn < T2) {
      load_rows<D, BK>(stage_k(stage ^ 1), kb, st.k[2], kn, T2, tid);
      load_rows<D, BK>(stage_k(stage ^ 1) + TILE_KV, vb, st.v[2], kn, T2,
                       tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // Q and this tile have landed
    fence_async_smem();
    __syncthreads();
    const uint32_t sk = stage_k(stage), sv = sk + TILE_KV;

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      mma_bf16_ss(s, desc_k(sq, BQ, ks), desc_k(sk, BK, ks));
    wgmma_commit();
    wgmma_wait_all();
    pin(s);

    if (bb != nullptr) add_bias(s, bits, bb, st, r0, kt + 2 * tq);
    online_softmax(s, o, m, l, bits, scale);

    uint32_t ph[4][4], pl[4][4];  // P's A fragments, hi and lo halves
    frag_bf16_split(s, ph, pl);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      // V's k-step: 16 key rows of 128 bytes; 64-wide column blocks are
      // BK rows apart
      const uint64_t dv = desc(sv + ks * 16 * 128, BK * 128);
      mma_bf16_rs(o, pl[ks], dv);
      mma_bf16_rs(o, ph[ks], dv);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(o);
    pin(ph);
    pin(pl);
    kt = kn;
    bits = bits_next;
    stage ^= 1;
  }
  cp_async_wait<0>();
  store_rows<D>(o, m, l, out + b * st.out[0] + h * st.out[1], st.out[2],
                LSE ? lse + static_cast<long long>(blockIdx.y) * T1 : nullptr,
                r0, tq, T1);
}

// ---------------------------------------------------------------------------
// fp32: 3xTF32 wgmma
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t tf32_smem() {
  return 1024 + 2 * 4 * D * (BQ + 2 * BK);  // hi and lo of Q, K, V^T
}

// acc += P . V in 3xTF32 over N / 2 output columns (all of them at
// d <= 64), P's hi and lo fragments from registers, V's from shared
// memory: svh, svl address the split V^T tile's row of the first column.
template <int D, int N>
__device__ __forceinline__ void pv_tf32(float (&acc)[N],
                                        const uint32_t (&ph)[8][4],
                                        const uint32_t (&pl)[8][4],
                                        uint32_t svh, uint32_t svl) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {  // the small terms first
    mma_tf32_rs(acc, pl[ks], desc_k(svh, D, ks));
    mma_tf32_rs(acc, ph[ks], desc_k(svl, D, ks));
  }
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) mma_tf32_rs(acc, ph[ks], desc_k(svh, D, ks));
  wgmma_commit();
  wgmma_wait_all();
  pin(acc);
}

template <int D, bool LSE>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_tf32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const uint8_t* __restrict__ mask,
                   const float* __restrict__ bias, float* __restrict__ out,
                   float* __restrict__ lse, Strides st, int H, int T1, int T2,
                   float scale) {
  constexpr int TILE_Q = BQ * D * 4, TILE_K = BK * D * 4;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qh = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ql = qh + TILE_Q;
  uint8_t* kh = ql + TILE_Q;
  uint8_t* kl = kh + TILE_K;
  uint8_t* vh = kl + TILE_K;
  uint8_t* vl = vh + TILE_K;
  const uint32_t sqh = smem_u32(qh), sql = smem_u32(ql);
  const uint32_t skh = smem_u32(kh), skl = smem_u32(kl);
  const uint32_t svh = smem_u32(vh), svl = smem_u32(vl);

  const int tid = threadIdx.x;
  const int tq = tid & 3;
  const int b = blockIdx.y / H, h = blockIdx.y % H, q0 = blockIdx.x * BQ;
  const int r0 = q0 + 16 * (tid >> 5) + ((tid & 31) >> 2);

  const float* kb = k + b * st.k[0] + h * st.k[1];
  const float* vb = v + b * st.v[0] + h * st.v[1];
  const uint8_t* mb =
      mask == nullptr ? nullptr : mask + b * st.mask[0] + h * st.mask[1];
  const float* bb =
      bias == nullptr ? nullptr : bias + b * st.bias[0] + h * st.bias[1];

  split_rows<D, BQ>(qh, ql,
                    GlobalRows{q + b * st.q[0] + h * st.q[1], st.q[2], q0, T1},
                    tid);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  __shared__ uint32_t votes[4];
  Walker walk{mb, st.mask[2], st.mask[3], T1, T2, r0, tq, tid >> 5, tid & 31,
              votes, mb == nullptr || st.mask[2] == 0};
  if (walk.cols) walk.prefetch();
  uint32_t bits;
  // each vote is a barrier: the previous tile's products are done before
  // its buffers are overwritten
  int kt = walk.next(bits);
  while (kt < T2) {
    split_rows<D, BK>(kh, kl, GlobalRows{kb, st.k[2], kt, T2}, tid);
    split_cols<D>(vh, vl, GlobalRows{vb, st.v[2], kt, T2}, tid);
    fence_async_smem();
    __syncthreads();

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {  // the small terms first
      mma_tf32_ss(s, desc_k(sql, BQ, ks), desc_k(skh, BK, ks));
      mma_tf32_ss(s, desc_k(sqh, BQ, ks), desc_k(skl, BK, ks));
    }
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks)
      mma_tf32_ss(s, desc_k(sqh, BQ, ks), desc_k(skh, BK, ks));
    wgmma_commit();
    wgmma_wait_all();
    pin(s);

    if (bb != nullptr) add_bias(s, bits, bb, st, r0, kt + 2 * tq);
    online_softmax(s, o, m, l, bits, scale);

    uint32_t ph[8][4], pl[8][4];  // P's A fragments in split_cols's order
    frag_tf32(s, ph, pl);
    // the tile's P . V into a zeroed fragment of 64 output columns at a
    // time (d = 128 has no registers for a whole one), added to O in FFMA
#pragma unroll
    for (int c = 0; c < (D + 63) / 64; ++c) {
      float po[D > 64 ? 32 : D / 2];
      zero(po);
      pv_tf32<D>(po, ph, pl, svh + c * 64 * 128, svl + c * 64 * 128);
      add_frag(o + 32 * c, po);
    }
    pin(ph);
    pin(pl);
    kt = walk.next(bits);
  }
  store_rows<D>(o, m, l, out + b * st.out[0] + h * st.out[1], st.out[2],
                LSE ? lse + static_cast<long long>(blockIdx.y) * T1 : nullptr,
                r0, tq, T1);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *mask;
  const float* bias;
  void* out;
  float* lse;  // training only
  Strides st;
  int B, H, T1, T2;
  float scale;
};

template <typename Kernel, typename T>
int launch_kernel(Kernel kernel, size_t smem, const Args& a,
                  cudaStream_t stream) {
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

template <int D, bool LSE>
int launch(int dtype, const Args& a, cudaStream_t stream) {
  if (dtype == 0)
    return launch_kernel<decltype(&flash_fwd_tf32<D, LSE>), float>(
        flash_fwd_tf32<D, LSE>, tf32_smem<D>(), a, stream);
  if (dtype == 1)
    return launch_kernel<decltype(&flash_fwd_bf16<D, LSE>), __nv_bfloat16>(
        flash_fwd_bf16<D, LSE>, bf16_smem<D>(), a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
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
  switch (D) {
    case 32:
      return launch<32, LSE>(dtype, a, s);
    case 64:
      return launch<64, LSE>(dtype, a, s);
    case 128:
      return launch<128, LSE>(dtype, a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
