// Masked flash attention backward for Hopper (sm_90a), plain C entry
// points.  Two kernels, as in the TPU version:
//
//   K5 flash_bwd_dq_*   replaces `_bwd_dq_kernel`  (wenet_tpu/ops/
//                       flash_attention.py:237, called at :418)
//   K6 flash_bwd_dkv_*  replaces `_bwd_dkv_kernel` (:288, called at :472)
//
// reached there through the custom VJP of `flash_attention`, which
// `attention_core` calls for long sequences (whisper's 1500-frame encoder
// in training).  Both recompute, tile by tile, what the forward kernel
// (flash_attention.cu, train variant) computed, from the saved row
// log-sum-exp instead of the (T1, T2) probabilities:
//
//   S  = (Q . K^T + bias) * scale, masked   bias added BEFORE the scale
//   P  = exp(S - lse), 0 where masked (where S <= NEG_INF / 2)
//   dS = P (dO . V^T - delta) * scale        delta = rowsum(dO . out), given
//
//   K5:  dQ = dS . K, and dbias = dS (only when there is a bias)
//   K6:  dV = P^T . dO,  dK = dS^T . Q
//
// K5 gives one block (one warpgroup, 128 threads) to 64 query rows of one
// (batch, head): Q and dO are staged once, 64-key tiles of K and V stream
// through shared memory, dQ accumulates in fp32 registers.  K6 gives one
// block to 64 keys: K and V are staged once, 64-row tiles of Q, dO, lse
// and delta stream through, dK and dV accumulate in fp32 registers.
// Neither needs a reduction across blocks (no atomics), so the results do
// not depend on the schedule.  dbias is written per (batch, head) as a
// contiguous (B, H, T1, T2) fp32 array; the caller sums it over the dims
// the bias broadcast over.
//
// Contract (as the forward): NEG_INF = -1e30; fully masked rows have
// lse = NEG_INF and P = 0: zero dQ and dbias, nothing added to dK and dV;
// softmax and accumulation are fp32; ragged T1 / T2 edges are
// zero-filled on load and masked.  q, k, v, do and the gradients are read
// and written through (batch, head, time) strides with a unit-stride
// feature dim (the attention module's (B, T, h, d) buffers), with bases
// and strides 16-byte aligned (the wrapper checks); the mask
// (B|1, 1|h, 1|T1, T2) and the fp32 bias through their own strides, 0 on
// a broadcast dim.  Only elements inside T1 x T2 whose mask bit is set
// read the bias.
//
// The seven products (d <= 64), each a wgmma m64nNk16 (bf16) or m64nNk8
// (tf32) over 64 x 64 tiles in hopper_mma.cuh's 128-byte swizzled layout:
//   K5  S   = Q . K^T    A = Q, B = K: both from shared memory, K-major
//       dP  = dO . V^T   A = dO, B = V: the same
//       dQ += dS . K     A = dS from registers: the accumulator layout of
//                        dP is the A fragment (as K4's P); B = K as
//                        stored, MN-major through the transpose bit
//   K6  S^T  = K . Q^T   A = K, B = Q: both K-major
//       dP^T = V . dO^T  A = V, B = dO: both K-major
//       dV  += P^T . dO  A = P^T from registers; B = dO, MN-major
//       dK  += dS^T . Q  A = dS^T from registers; B = Q, MN-major
// K6 computes the transposed tiles so that P^T and dS^T come out of the
// accumulators already in the A-fragment layout of its two output
// products, with its own 64 keys as the rows: no shuffle, no trip through
// shared memory.  lse and delta are then per column: each tile's values
// come with Q and dO into shared memory, and each thread reads its 16
// columns there.
//
// bf16: Q, K, V and dO are exact bf16 tiles, which arrive by cp.async into
// a ring of two stages (the next tile's copy in flight while this one
// computes).  P and dS are rounded to bf16 for the products that take
// them, once, except dS in K6's dK = dS^T . Q, which goes in as two bf16
// halves hi = bf16(dS) and lo = bf16(dS - hi), as K4's P does: one more
// wgmma per k-step.  A rounding costs 2^-9 relative per element; the
// gradient bars (atol 5e-2, rtol 2e-2 against fp32 on the same rounded
// inputs) are about 50 times looser than K4's output bar, and a single
// rounding stays within 20% of them on 8a's shapes except in dK on the
// peaked shape (q scaled by 8, which dK's product multiplies back in):
// there it takes 52-60% of the bar (emulated in fp32 by
// tests/test_torch_flash_bwd_precision.py), and with the halves 19%
// (8a).  The other roundings stay single (15-20% on that shape).
// fp32: 3xTF32, as K4.  Each operand is split x = hi + lo, both rounded to
// tf32, and hi.hi + hi.lo + lo.hi is accumulated in fp32.  wgmma does
// not round its fp32 sums to nearest, so dQ, dK and dV added to over the
// whole tile loop drifted from float64 (chip_smoke 2b on an H100: 12-14x
// the plain version's rms error); each tile's product goes into a zeroed
// fragment that FFMA adds to the sum (K6: dV's, then dK's, one fragment
// for both), 0.8-1.0x after.  tf32 takes both operands K-major, so the
// MN-major operands (K in K5, Q and dO in K6) get a second, transposed
// copy, with rows permuted within each group of 8 so that the
// accumulator is the A fragment without shuffles (split_cols,
// flash_tiles.cuh).  The streamed fp32 tiles arrive raw by
// cp.async a tile ahead and are split from shared memory, so no global
// load waits on the tile's critical path.  One block fills an SM's
// shared memory (K5 193 KB, K6 226 KB at d = 64), so nothing else hides
// a block's latency: registers decide, and two things starved them:
// every wgmma descriptor of a tile computed up front (kstep orders
// them), and the bias code even where there is no bias (each kernel has
// an instance with the bias and one without).  Removing both took 8a's
// fp32 K5 + K6 from 2.45 to 1.59 ms on an H100.
//
// Skipped tiles.  K5 walks its key tiles with K4's Walker and skips those
// the mask closes for every row of the block; dQ is unchanged by them,
// but dbias (allocated empty) gets zeros on them.  K6 skips query tiles
// closed for every (query, key) pair of its block: a mask with one row
// (the pad mask) is read once per thread, for its two keys, so a key
// block in the padded tail skips every tile and writes zeros to dK and
// dV (allocated empty); other masks are read per element, transposed.
//
// What bounds them on an H100: 6 d (K5) and 8 d (K6) FLOPs per attended
// pair against a few bytes of device traffic per pair (K5's dbias, 4
// bytes per pair, only with a bias), so the tensor cores: 989 TFLOP/s in
// bf16, and in fp32, as three tf32 products, 495 / 3 TFLOP/s.  In
// practice latency: the per-element exp2 and mask between the products,
// and in fp32 the register path that splits the tiles.
//
// d = 128 (the paraformer's 512-wide, 4-head attention) runs on wgmma
// too, with the seven products above; what d = 128 changes is what no
// longer fits:
//   * bf16 K5: as at d <= 64, its tiles 128 wide (two 128-byte column
//     blocks) and dQ a 64 x 128 accumulator (m64n128k16): 97 KB of
//     shared memory, two blocks an SM.
//   * bf16 K6: dK and dV are two 64 x 128 fp32 accumulators, 128
//     registers a thread; beside them 64-wide S^T and dP^T tiles and their
//     fragments passed the 255 a thread may have.  So the walked 64-row
//     query tiles stream as 32-row halves (as K3 does in fp32): S^T and
//     dP^T are m64n32k16 (16 registers each) and the output products take
//     two k-steps of 16 query rows a half.  65 KB of shared memory.
//   * fp32: the split tiles of K5 and K6 as at d = 64 would need 385 and
//     450 KB.  The resident operands (K5: Q, dO; K6: K, V) stay split,
//     128 KB; the streamed one moves in 32-wide halves (32 keys in K5,
//     32 query rows in K6, wgmma N = 32 for S and dP), staged raw by
//     cp.async a half ahead, and its transposed split copy (K^T in K5,
//     Q^T and dO^T in K6) is written over its row split once the score
//     products have read it: 224 KB in all.  K6 takes dV's and dK's
//     products 64 output columns at a time into one zeroed fragment.
//     K5 keeps the hi . hi products of the second half of each score
//     chain (16 k-steps) in a fragment of its own, as K1-K3 do; K6 does
//     not.  With that fragment and 32 output columns a product, K6 took
//     0.192 ms at (2,4,534,534,128) and read 0.8-1.0x the plain version's
//     rms error from float64; as here, 0.128 ms and 1.3-1.6x (chip_smoke
//     16a and 2b on an H100, both in one call).  The fewer waits between
//     products pay; the two 64 x 128 sums still spill 228-260 bytes.
// Registers and spills of every instance: build/flash_attention_bwd.log
// (PERF.md has them).

#include <type_traits>

#include "flash_tiles.cuh"

namespace {

using namespace flash;

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

// ---------------------------------------------------------------------------
// the tile's gradient, on the accumulator fragment (grad, Rows and
// QueryWalker: flash_tiles.cuh)
// ---------------------------------------------------------------------------

// The bias of the open elements of a fragment whose rows r0, r0 + 8 and
// columns c0 + 8 j + {0, 1} lie rs and cs elements apart in b, added to
// s.  The strides pass through an empty asm, so that the 32 addresses
// are computed here, per tile, and not hoisted out of the tile loop into
// registers that the fp32 kernels cannot spare.
template <int N>
__device__ __forceinline__ void add_bias(float (&s)[N], uint32_t bits,
                                         const float* b, long long rs,
                                         long long cs, int r0, int c0) {
  asm volatile("" : "+l"(rs), "+l"(cs));
  const float* p = b + r0 * rs + c0 * cs;
#pragma unroll
  for (int i = 0; i < N; ++i)
    if ((bits >> i) & 1u)
      s[i] += p[8 * ((i >> 1) & 1) * rs + (8 * (i >> 2) + (i & 1)) * cs];
}

// ---------------------------------------------------------------------------
// K5: dbias
// ---------------------------------------------------------------------------

// K5's gradient of one key tile (first key kt; 64 or, with N = 16, 32
// keys) on the fragment, and dS into dbias (db: this (batch, head)'s
// (T1, T2) array, or null).
template <int N>
__device__ __forceinline__ void grad_rows(float (&s)[N], float (&dp)[N],
                                          uint32_t bits, const Rows& rows,
                                          const float* bb, float* db,
                                          const Strides& st, int r0, int tq,
                                          int kt, int T1, int T2,
                                          float scale) {
  if (bb != nullptr)
    add_bias(s, bits, bb, st.bias[2], st.bias[3], r0, kt + 2 * tq);
  const float sl2 = scale * LOG2E;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int row = (i >> 1) & 1;
    grad(s[i], dp[i], (bits >> i) & 1u, rows.lse2[row], rows.delta[row],
         sl2, scale);
  }
  if (db == nullptr) return;
  long long ld = T2;  // as add_bias: addresses computed here, per tile
  asm volatile("" : "+l"(ld));
  float* p = db + r0 * ld + kt + 2 * tq;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int r = r0 + 8 * ((i >> 1) & 1), c = 8 * (i >> 2) + (i & 1);
    if (r < T1 && kt + 2 * tq + c < T2) p[8 * ((i >> 1) & 1) * ld + c] = dp[i];
  }
}

// Zeros into dbias columns [c0, c1) of the block's rows: the key tiles
// the walk skipped.
__device__ __forceinline__ void zero_cols(float* db, int q0, int T1, int T2,
                                          int c0, int c1, int tid) {
  if (db == nullptr) return;
  const int n = min(c1, T2) - c0, rows = min(BQ, T1 - q0);
  for (int i = tid; i < rows * n; i += THREADS)
    db[static_cast<long long>(q0 + i / n) * T2 + c0 + i % n] = 0.f;
}

// ---------------------------------------------------------------------------
// K5, bf16: wgmma on bf16 tiles, cp.async into two stages
// ---------------------------------------------------------------------------

// Q, dO, 2 x (K, V): 64-row tiles of bf16_width<D> values
template <int D>
constexpr size_t dq_bf16_smem() {
  return 1024 + 6 * 64 * bf16_width<D>() * 2;
}

template <int D, bool BIAS>
__global__ void __launch_bounds__(THREADS, D < 128 ? 3 : 2)
    flash_bwd_dq_bf16(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const uint8_t* __restrict__ mask,
                      const float* __restrict__ bias,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dq,
                      float* __restrict__ dbias, Strides st, int H, int T1,
                      int T2, float scale) {
  constexpr int W = bf16_width<D>();
  constexpr int TILE = 64 * W * 2;  // 64 rows (BQ = BK) of W bf16 values
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u, sdo = sq + TILE;
  auto stage_k = [&](int stage) {  // K, then V
    return sq + 2 * TILE + 2 * stage * TILE;
  };

  const int tid = threadIdx.x, tq = tid & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, q0 = blockIdx.x * BQ;
  const int r0 = q0 + 16 * (tid >> 5) + ((tid & 31) >> 2);
  const __nv_bfloat16* kb = k + b * st.k[0] + h * st.k[1];
  const __nv_bfloat16* vb = v + b * st.v[0] + h * st.v[1];
  const uint8_t* mb =
      mask == nullptr ? nullptr : mask + b * st.mask[0] + h * st.mask[1];
  const float* bb = BIAS ? bias + b * st.bias[0] + h * st.bias[1] : nullptr;
  float* db = BIAS ? dbias + static_cast<long long>(bh) * T1 * T2 : nullptr;

  load_rows<D, BQ>(sq, q + b * st.q[0] + h * st.q[1], st.q[2], q0, T1, tid);
  load_rows<D, BQ>(sdo, dout + b * st.dout[0] + h * st.dout[1], st.dout[2],
                   q0, T1, tid);
  cp_async_commit();
  const Rows rows(lse + static_cast<long long>(bh) * T1,
                  delta + static_cast<long long>(bh) * T1, r0, T1);
  __shared__ uint32_t votes[4];
  Walker walk{mb, st.mask[2], st.mask[3], T1, T2, r0, tq, tid >> 5, tid & 31,
              votes, mb == nullptr || st.mask[2] == 0};
  if (walk.cols) walk.prefetch();
  uint32_t bits;
  int kt = walk.next(bits);
  if (kt < T2) {
    load_rows<D, BK>(stage_k(0), kb, st.k[2], kt, T2, tid);
    load_rows<D, BK>(stage_k(0) + TILE, vb, st.v[2], kt, T2, tid);
  }
  cp_async_commit();

  float acc[W / 2];
  zero(acc);
  int stage = 0, done = 0;  // done: dbias columns written
  while (kt < T2) {
    // the vote is a barrier: every warp is done with the stage refilled
    uint32_t bits_next;
    const int kn = walk.next(bits_next);
    if (kn < T2) {
      load_rows<D, BK>(stage_k(stage ^ 1), kb, st.k[2], kn, T2, tid);
      load_rows<D, BK>(stage_k(stage ^ 1) + TILE, vb, st.v[2], kn, T2, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // Q, dO and this tile have landed
    fence_async_smem();
    __syncthreads();
    const uint32_t sk = stage_k(stage), sv = sk + TILE;

    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      mma_bf16_ss(s, desc_k(sq, BQ, ks), desc_k(sk, BK, ks));
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      mma_bf16_ss(dp, desc_k(sdo, BQ, ks), desc_k(sv, BK, ks));
    wgmma_commit();
    wgmma_wait_all();
    pin(s);
    pin(dp);

    zero_cols(db, q0, T1, T2, done, kt, tid);
    done = kt + BK;
    grad_rows(s, dp, bits, rows, bb, db, st, r0, tq, kt, T1, T2, scale);
    uint32_t ds[4][4];
    frag_bf16(dp, ds);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)  // K's k-step: 16 key rows of 128 bytes;
      // its 64-wide column blocks are BK rows apart
      mma_bf16_rs(acc, ds[ks], desc(sk + ks * 16 * 128, BK * 128));
    wgmma_commit();
    wgmma_wait_all();
    pin(acc);
    pin(ds);
    kt = kn;
    bits = bits_next;
    stage ^= 1;
  }
  cp_async_wait<0>();
  zero_cols(db, q0, T1, T2, done, T2, tid);
  store_tile<D>(acc, dq + b * st.g0[0] + h * st.g0[1], st.g0[2], r0, tq, T1);
}

// ---------------------------------------------------------------------------
// K5, fp32: 3xTF32
// ---------------------------------------------------------------------------

// fp32 shared memory: 64 x D tiles (TILE32), hi and lo of each split
// operand, then the raw tiles that stage the next streamed operands by
// cp.async while this tile computes (split from there: no global load on
// the tile's critical path).
// Q, dO, K, V, K^T (hi, lo each); raw K, V
template <int D>
constexpr size_t dq_tf32_smem() {
  return 1024 + 12 * TILE32<D>;
}

template <int D, bool BIAS>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_tf32(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const uint8_t* __restrict__ mask,
                      const float* __restrict__ bias,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dq,
                      float* __restrict__ dbias, Strides st, int H, int T1,
                      int T2, float scale) {
  constexpr int TILE = TILE32<D>;
  enum { QH, QL, DOH, DOL, KH, KL, VH, VL, KTH, KTL, RK, RV };
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  auto tile = [&](int i) { return base + i * TILE; };

  const int tid = threadIdx.x, tq = tid & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, q0 = blockIdx.x * BQ;
  const int r0 = q0 + 16 * (tid >> 5) + ((tid & 31) >> 2);
  const float* kb = k + b * st.k[0] + h * st.k[1];
  const float* vb = v + b * st.v[0] + h * st.v[1];
  const uint8_t* mb =
      mask == nullptr ? nullptr : mask + b * st.mask[0] + h * st.mask[1];
  const float* bb = BIAS ? bias + b * st.bias[0] + h * st.bias[1] : nullptr;
  float* db = BIAS ? dbias + static_cast<long long>(bh) * T1 * T2 : nullptr;
  auto stage = [&](int kt) {
    stage_raw<D>(smem_u32(tile(RK)), kb, st.k[2], kt, T2, tid);
    stage_raw<D>(smem_u32(tile(RV)), vb, st.v[2], kt, T2, tid);
  };

  split_rows<D, BQ>(tile(QH), tile(QL),
                    GlobalRows{q + b * st.q[0] + h * st.q[1], st.q[2], q0,
                               T1},
                    tid);
  split_rows<D, BQ>(tile(DOH), tile(DOL),
                    GlobalRows{dout + b * st.dout[0] + h * st.dout[1],
                               st.dout[2], q0, T1},
                    tid);
  const Rows rows(lse + static_cast<long long>(bh) * T1,
                  delta + static_cast<long long>(bh) * T1, r0, T1);
  __shared__ uint32_t votes[4];
  Walker walk{mb, st.mask[2], st.mask[3], T1, T2, r0, tq, tid >> 5, tid & 31,
              votes, mb == nullptr || st.mask[2] == 0};
  if (walk.cols) walk.prefetch();
  uint32_t bits;
  int kt = walk.next(bits);
  if (kt < T2) stage(kt);
  cp_async_commit();

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  int done = 0;
  while (kt < T2) {
    cp_async_wait<0>();
    __syncthreads();  // the raw tiles have landed; the last products are done
    split_rows<D, BK>(tile(KH), tile(KL), RawTile<D>{tile(RK)}, tid);
    split_rows<D, BK>(tile(VH), tile(VL), RawTile<D>{tile(RV)}, tid);
    split_cols<D>(tile(KTH), tile(KTL), RawTile<D>{tile(RK)}, tid);
    fence_async_smem();
    __syncthreads();  // the split tiles are published, the raw ones free
    uint32_t bits_next;
    const int kn = walk.next(bits_next);
    if (kn < T2) stage(kn);
    cp_async_commit();

    const uint64_t d0 = desc(smem_u32(base));
    auto kmaj = [&](int i, int rows, int ks) {  // k-step ks of tile i
      return kstep(d0, i * TILE, rows, ks);
    };
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {  // the small terms first
      mma_tf32_ss(s, kmaj(QL, BQ, ks), kmaj(KH, BK, ks));
      mma_tf32_ss(s, kmaj(QH, BQ, ks), kmaj(KL, BK, ks));
      mma_tf32_ss(dp, kmaj(DOL, BQ, ks), kmaj(VH, BK, ks));
      mma_tf32_ss(dp, kmaj(DOH, BQ, ks), kmaj(VL, BK, ks));
    }
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {
      mma_tf32_ss(s, kmaj(QH, BQ, ks), kmaj(KH, BK, ks));
      mma_tf32_ss(dp, kmaj(DOH, BQ, ks), kmaj(VH, BK, ks));
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(s);
    pin(dp);

    zero_cols(db, q0, T1, T2, done, kt, tid);
    done = kt + BK;
    grad_rows(s, dp, bits, rows, bb, db, st, r0, tq, kt, T1, T2, scale);
    uint32_t dsh[8][4], dsl[8][4];
    frag_tf32(dp, dsh, dsl);
    float f[D / 2];  // the tile's dS . K, added to dQ in FFMA
    zero(f);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      mma_tf32_rs(f, dsl[ks], kmaj(KTH, D, ks));
      mma_tf32_rs(f, dsh[ks], kmaj(KTL, D, ks));
    }
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) mma_tf32_rs(f, dsh[ks], kmaj(KTH, D, ks));
    wgmma_commit();
    wgmma_wait_all();
    pin(f);
    pin(dsh);
    pin(dsl);
    add_frag(acc, f);
    kt = kn;
    bits = bits_next;
  }
  cp_async_wait<0>();
  zero_cols(db, q0, T1, T2, done, T2, tid);
  store_tile<D>(acc, dq + b * st.g0[0] + h * st.g0[1], st.g0[2], r0, tq, T1);
}

// ---------------------------------------------------------------------------
// K6: the per-column gradient
// ---------------------------------------------------------------------------

// K6's gradient of one query tile (first query qt; 64 or, with N = 16,
// 32 queries) on the transposed fragment: rows are keys, columns queries,
// whose lse and delta are in shared memory (ls, dl: the tile's values).
template <int N>
__device__ __forceinline__ void grad_cols(float (&s)[N], float (&dp)[N],
                                          uint32_t bits, const float* ls,
                                          const float* dl, const float* bb,
                                          const Strides& st, int kr0, int tq,
                                          int qt, float scale) {
  if (bb != nullptr)  // rows are keys, columns queries
    add_bias(s, bits, bb, st.bias[3], st.bias[2], kr0, qt + 2 * tq);
  const float sl2 = scale * LOG2E;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = 8 * (i >> 2) + 2 * tq + (i & 1);
    grad(s[i], dp[i], (bits >> i) & 1u, ls[c] * LOG2E, dl[c], sl2, scale);
  }
}

// ---------------------------------------------------------------------------
// K6, bf16
// ---------------------------------------------------------------------------

// K, V, 2 x (Q, dO): 64-row tiles of 64 bf16 values (d <= 64)
constexpr size_t BF16_SMEM = 1024 + 6 * TILE16;

template <int D, bool BIAS>
__global__ void __launch_bounds__(THREADS, 2)
    flash_bwd_dkv_bf16(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const uint8_t* __restrict__ mask,
                       const float* __restrict__ bias,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, Strides st, int H,
                       int T1, int T2, float scale) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ float cols_s[2][2][BQ];  // per stage: the tile's lse, delta
  const uint32_t sk = (smem_u32(smem_raw) + 1023) & ~1023u, sv = sk + TILE16;
  auto stage_q = [&](int stage) {  // Q, then dO
    return sk + 2 * TILE16 + 2 * stage * TILE16;
  };

  const int tid = threadIdx.x, tq = tid & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, k0 = blockIdx.x * BK;
  const int kr0 = k0 + 16 * (tid >> 5) + ((tid & 31) >> 2);
  const __nv_bfloat16* qb = q + b * st.q[0] + h * st.q[1];
  const __nv_bfloat16* dob = dout + b * st.dout[0] + h * st.dout[1];
  const float* lb = lse + static_cast<long long>(bh) * T1;
  const float* dlb = delta + static_cast<long long>(bh) * T1;
  const uint8_t* mb =
      mask == nullptr ? nullptr : mask + b * st.mask[0] + h * st.mask[1];
  const float* bb = BIAS ? bias + b * st.bias[0] + h * st.bias[1] : nullptr;

  load_rows<D, BK>(sk, k + b * st.k[0] + h * st.k[1], st.k[2], k0, T2, tid);
  load_rows<D, BK>(sv, v + b * st.v[0] + h * st.v[1], st.v[2], k0, T2, tid);
  auto load_tile = [&](int stage, int qt) {
    load_rows<D, BQ>(stage_q(stage), qb, st.q[2], qt, T1, tid);
    load_rows<D, BQ>(stage_q(stage) + TILE16, dob, st.dout[2], qt, T1, tid);
    const int i = tid % BQ;
    const float* src = tid < BQ ? lb : dlb;
    const bool ok = qt + i < T1;
    cp_async4(smem_u32(&cols_s[stage][tid / BQ][i]), ok ? src + qt + i : src,
              ok ? 4 : 0);
  };
  QueryWalker walk{mb, st.mask[2], st.mask[3], T1, T2, kr0, tq,
                   mb == nullptr || st.mask[2] == 0};
  walk.init();
  uint32_t bits;
  int qt = walk.next(0, bits);
  if (qt < T1) load_tile(0, qt);
  cp_async_commit();  // K, V and the first tile

  float dka[32], dva[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dka[i] = dva[i] = 0.f;
  int stage = 0;
  while (qt < T1) {
    // the vote is a barrier: every warp is done with the stage refilled
    uint32_t bits_next;
    const int qn = walk.next(qt + BQ, bits_next);
    if (qn < T1) load_tile(stage ^ 1, qn);
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_smem();
    __syncthreads();
    const uint32_t sq = stage_q(stage), sdo = sq + TILE16;

    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      mma_bf16_ss(s, desc_k(sk, BK, ks), desc_k(sq, BQ, ks));
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      mma_bf16_ss(dp, desc_k(sv, BK, ks), desc_k(sdo, BQ, ks));
    wgmma_commit();
    wgmma_wait_all();
    pin(s);
    pin(dp);

    grad_cols(s, dp, bits, cols_s[stage][0], cols_s[stage][1], bb, st, kr0,
              tq, qt, scale);
    // dS^T as hi + lo halves for dK (dS^T . Q, q as large as it comes)
    uint32_t pf[4][4], dsh[4][4], dsl[4][4];
    frag_bf16(s, pf);
    frag_bf16_split(dp, dsh, dsl);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {  // 16 query rows of 128 bytes
      const uint64_t bq = desc(sq + ks * 16 * 128, BQ * 128);
      mma_bf16_rs(dva, pf[ks], desc(sdo + ks * 16 * 128, BQ * 128));
      mma_bf16_rs(dka, dsl[ks], bq);
      mma_bf16_rs(dka, dsh[ks], bq);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(dva);
    pin(dka);
    pin(pf);
    pin(dsh);
    pin(dsl);
    qt = qn;
    bits = bits_next;
    stage ^= 1;
  }
  cp_async_wait<0>();
  store_tile<D>(dka, dk + b * st.g0[0] + h * st.g0[1], st.g0[2], kr0, tq, T2);
  store_tile<D>(dva, dv + b * st.g1[0] + h * st.g1[1], st.g1[2], kr0, tq, T2);
}

// ---------------------------------------------------------------------------
// K6, fp32: 3xTF32
// ---------------------------------------------------------------------------

// K, V, Q, dO, Q^T, dO^T (hi, lo each); raw Q, dO; raw lse, delta
template <int D>
constexpr size_t dkv_tf32_smem() {
  return 1024 + 14 * TILE32<D> + 2 * BQ * 4;
}

template <int D, bool BIAS>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_tf32(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const uint8_t* __restrict__ mask,
                       const float* __restrict__ bias,
                       const float* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, float* __restrict__ dk,
                       float* __restrict__ dv, Strides st, int H, int T1,
                       int T2, float scale) {
  constexpr int TILE = TILE32<D>;
  enum { KH, KL, VH, VL, QH, QL, DOH, DOL, QTH, QTL, DOTH, DOTL, RQ, RDO,
         RLSE };
  extern __shared__ uint8_t smem_raw[];
  __shared__ float cols_s[2][BQ];  // the tile's lse, delta
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  auto tile = [&](int i) { return base + i * TILE; };
  const float* raw_cols = reinterpret_cast<const float*>(tile(RLSE));

  const int tid = threadIdx.x, tq = tid & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, k0 = blockIdx.x * BK;
  const int kr0 = k0 + 16 * (tid >> 5) + ((tid & 31) >> 2);
  const float* qb = q + b * st.q[0] + h * st.q[1];
  const float* dob = dout + b * st.dout[0] + h * st.dout[1];
  const float* lb = lse + static_cast<long long>(bh) * T1;
  const float* dlb = delta + static_cast<long long>(bh) * T1;
  const uint8_t* mb =
      mask == nullptr ? nullptr : mask + b * st.mask[0] + h * st.mask[1];
  const float* bb = BIAS ? bias + b * st.bias[0] + h * st.bias[1] : nullptr;
  auto stage = [&](int qt) {
    stage_raw<D>(smem_u32(tile(RQ)), qb, st.q[2], qt, T1, tid);
    stage_raw<D>(smem_u32(tile(RDO)), dob, st.dout[2], qt, T1, tid);
    const int i = tid % BQ;  // threads 0-63: lse, 64-127: delta
    const float* src = tid < BQ ? lb : dlb;
    const bool ok = qt + i < T1;
    cp_async4(smem_u32(raw_cols + tid), ok ? src + qt + i : src, ok ? 4 : 0);
  };

  split_rows<D, BK>(tile(KH), tile(KL),
                    GlobalRows{k + b * st.k[0] + h * st.k[1], st.k[2], k0,
                               T2},
                    tid);
  split_rows<D, BK>(tile(VH), tile(VL),
                    GlobalRows{v + b * st.v[0] + h * st.v[1], st.v[2], k0,
                               T2},
                    tid);
  QueryWalker walk{mb, st.mask[2], st.mask[3], T1, T2, kr0, tq,
                   mb == nullptr || st.mask[2] == 0};
  walk.init();
  uint32_t bits;
  int qt = walk.next(0, bits);
  if (qt < T1) stage(qt);
  cp_async_commit();

  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  while (qt < T1) {
    cp_async_wait<0>();
    __syncthreads();  // the raw tiles have landed; the last products are done
    split_rows<D, BQ>(tile(QH), tile(QL), RawTile<D>{tile(RQ)}, tid);
    split_rows<D, BQ>(tile(DOH), tile(DOL), RawTile<D>{tile(RDO)}, tid);
    split_cols<D>(tile(QTH), tile(QTL), RawTile<D>{tile(RQ)}, tid);
    split_cols<D>(tile(DOTH), tile(DOTL), RawTile<D>{tile(RDO)}, tid);
    cols_s[tid / BQ][tid % BQ] = raw_cols[tid];
    fence_async_smem();
    __syncthreads();  // the split tiles are published, the raw ones free
    uint32_t bits_next;
    const int qn = walk.next(qt + BQ, bits_next);
    if (qn < T1) stage(qn);
    cp_async_commit();

    const uint64_t d0 = desc(smem_u32(base));
    auto kmaj = [&](int i, int rows, int ks) {  // k-step ks of tile i
      return kstep(d0, i * TILE, rows, ks);
    };
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {  // the small terms first
      mma_tf32_ss(s, kmaj(KL, BK, ks), kmaj(QH, BQ, ks));
      mma_tf32_ss(s, kmaj(KH, BK, ks), kmaj(QL, BQ, ks));
      mma_tf32_ss(dp, kmaj(VL, BK, ks), kmaj(DOH, BQ, ks));
      mma_tf32_ss(dp, kmaj(VH, BK, ks), kmaj(DOL, BQ, ks));
    }
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {
      mma_tf32_ss(s, kmaj(KH, BK, ks), kmaj(QH, BQ, ks));
      mma_tf32_ss(dp, kmaj(VH, BK, ks), kmaj(DOH, BQ, ks));
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(s);
    pin(dp);

    grad_cols(s, dp, bits, cols_s[0], cols_s[1], bb, st, kr0, tq, qt, scale);
    // P^T . dO, then dS^T . Q, each into the zeroed fragment f that FFMA
    // adds to dV, dK (dS^T is split only after dV's product, so the two
    // take no more registers than one product into dV and dK in place)
    float f[D / 2];
    auto product = [&](const uint32_t (&hi)[8][4], const uint32_t (&lo)[8][4],
                       int th, int tl) {
      zero(f);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        mma_tf32_rs(f, lo[ks], kmaj(th, D, ks));
        mma_tf32_rs(f, hi[ks], kmaj(tl, D, ks));
      }
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) mma_tf32_rs(f, hi[ks], kmaj(th, D, ks));
      wgmma_commit();
      wgmma_wait_all();
      pin(f);
    };
    {
      uint32_t ph[8][4], pl[8][4];
      frag_tf32(s, ph, pl);
      product(ph, pl, DOTH, DOTL);
      pin(ph);
      pin(pl);
    }
    add_frag(dva, f);
    {
      uint32_t dsh[8][4], dsl[8][4];
      frag_tf32(dp, dsh, dsl);
      product(dsh, dsl, QTH, QTL);
      pin(dsh);
      pin(dsl);
    }
    add_frag(dka, f);
    qt = qn;
    bits = bits_next;
  }
  cp_async_wait<0>();
  store_tile<D>(dka, dk + b * st.g0[0] + h * st.g0[1], st.g0[2], kr0, tq, T2);
  store_tile<D>(dva, dv + b * st.g1[0] + h * st.g1[1], st.g1[2], kr0, tq, T2);
}

// ---------------------------------------------------------------------------
// d = 128
// ---------------------------------------------------------------------------

// K6, bf16 at d = 128: K and V resident (64 keys of 128 bf16 values), the
// walked 64-row query tiles streamed as 32-row halves of Q and dO with
// their lse and delta, in a ring of two stages.
constexpr int QHALF = 32;  // query rows (K6) or keys (K5, fp32) a step
constexpr size_t DKV_BF16_WIDE_SMEM = 1024 + 2 * BK * 256 + 4 * QHALF * 256;

template <bool BIAS>
__global__ void __launch_bounds__(THREADS, 2)
    flash_bwd_dkv_bf16_wide(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const uint8_t* __restrict__ mask,
                            const float* __restrict__ bias,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, Strides st, int H,
                            int T1, int T2, float scale) {
  constexpr int D = 128, TK = BK * D * 2, TQ = QHALF * D * 2;
  extern __shared__ uint8_t smem_raw[];
  __shared__ float cols_s[2][2][QHALF];  // per stage: the half's lse, delta
  const uint32_t sk = (smem_u32(smem_raw) + 1023) & ~1023u, sv = sk + TK;
  auto stage_q = [&](int stage) {  // Q, then dO
    return sk + 2 * TK + 2 * stage * TQ;
  };

  const int tid = threadIdx.x, tq = tid & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, k0 = blockIdx.x * BK;
  const int kr0 = k0 + 16 * (tid >> 5) + ((tid & 31) >> 2);
  const __nv_bfloat16* qb = q + b * st.q[0] + h * st.q[1];
  const __nv_bfloat16* dob = dout + b * st.dout[0] + h * st.dout[1];
  const float* lb = lse + static_cast<long long>(bh) * T1;
  const float* dlb = delta + static_cast<long long>(bh) * T1;
  const uint8_t* mb =
      mask == nullptr ? nullptr : mask + b * st.mask[0] + h * st.mask[1];
  const float* bb = BIAS ? bias + b * st.bias[0] + h * st.bias[1] : nullptr;

  load_rows<D, BK>(sk, k + b * st.k[0] + h * st.k[1], st.k[2], k0, T2, tid);
  load_rows<D, BK>(sv, v + b * st.v[0] + h * st.v[1], st.v[2], k0, T2, tid);
  auto load_half = [&](int stage, int q0) {  // 32 query rows from q0
    load_rows<D, QHALF>(stage_q(stage), qb, st.q[2], q0, T1, tid);
    load_rows<D, QHALF>(stage_q(stage) + TQ, dob, st.dout[2], q0, T1, tid);
    if (tid < 2 * QHALF) {  // threads 0-31: lse, 32-63: delta
      const int i = tid % QHALF;
      const float* src = tid < QHALF ? lb : dlb;
      const bool ok = q0 + i < T1;
      cp_async4(smem_u32(&cols_s[stage][tid / QHALF][i]),
                ok ? src + q0 + i : src, ok ? 4 : 0);
    }
  };
  QueryWalker walk{mb, st.mask[2], st.mask[3], T1, T2, kr0, tq,
                   mb == nullptr || st.mask[2] == 0};
  walk.init();
  uint32_t bits;
  int qt = walk.next(0, bits), half = 0;
  if (qt < T1) load_half(0, qt);
  cp_async_commit();  // K, V and the first half

  float dka[64], dva[64];
  zero(dka);
  zero(dva);
  int stage = 0;
  while (qt < T1) {
    __syncthreads();  // every warp is done with the stage refilled here
    int hn = half;
    uint32_t bits_next = bits;
    const int qn = next_half(qt, hn, bits_next, T1, [&](uint32_t& bn) {
      return walk.next(qt + BQ, bn);
    });
    if (qn < T1) load_half(stage ^ 1, qn + QHALF * hn);
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_smem();
    __syncthreads();
    const int q0 = qt + QHALF * half;  // this half's first query
    const uint32_t hbits = (bits >> (16 * half)) & 0xffffu;
    const uint32_t sq = stage_q(stage), sdo = sq + TQ;

    float s[16], g[16];  // S^T, dP^T: 64 keys x 32 queries
    zero(s);
    zero(g);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      mma_bf16_ss(s, desc_k(sk, BK, ks), desc_k(sq, QHALF, ks));
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      mma_bf16_ss(g, desc_k(sv, BK, ks), desc_k(sdo, QHALF, ks));
    wgmma_commit();
    wgmma_wait_all();
    pin(s);
    pin(g);

    grad_cols(s, g, hbits, cols_s[stage][0], cols_s[stage][1], bb, st, kr0,
              tq, q0, scale);
    // dS^T as hi + lo halves for dK, as at d <= 64
    uint32_t pf[2][4], dsh[2][4], dsl[2][4];
    frag_bf16(s, pf);
    frag_bf16_split(g, dsh, dsl);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      // 16 query rows of 128 bytes; 64-wide column blocks 32 rows apart
      const uint64_t bq = desc(sq + ks * 16 * 128, QHALF * 128);
      mma_bf16_rs(dva, pf[ks], desc(sdo + ks * 16 * 128, QHALF * 128));
      mma_bf16_rs(dka, dsl[ks], bq);
      mma_bf16_rs(dka, dsh[ks], bq);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(dva);
    pin(dka);
    pin(pf);
    pin(dsh);
    pin(dsl);
    qt = qn;
    half = hn;
    bits = bits_next;
    stage ^= 1;
  }
  cp_async_wait<0>();
  store_tile<D>(dka, dk + b * st.g0[0] + h * st.g0[1], st.g0[2], kr0, tq, T2);
  store_tile<D>(dva, dv + b * st.g1[0] + h * st.g1[1], st.g1[2], kr0, tq, T2);
}

// fp32 at d = 128: the split halves of the streamed operand (16 KB
// each: 32 rows of 128 values, or the transpose, 128 rows of 32).
constexpr int D128 = 128;
constexpr int TILE128 = TILE32<D128>;  // 64 rows: 32 KB
constexpr int HALF128 = TILE128 / 2;

// Q, dO split (64 rows); K, V split, 32 keys (K's split rows then K^T);
// raw K, V
constexpr size_t DQ_TF32_WIDE_SMEM = 1024 + 4 * TILE128 + 6 * HALF128;

template <bool BIAS>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_tf32_wide(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const uint8_t* __restrict__ mask,
                           const float* __restrict__ bias,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dq, float* __restrict__ dbias,
                           Strides st, int H, int T1, int T2, float scale) {
  constexpr int D = D128;
  // byte offsets of the tiles
  constexpr int QH = 0, QL = TILE128, DOH = 2 * TILE128, DOL = 3 * TILE128,
                KH = 4 * TILE128, KL = KH + HALF128, VH = KL + HALF128,
                VL = VH + HALF128, RK = VL + HALF128, RV = RK + HALF128;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int tid = threadIdx.x, tq = tid & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, q0 = blockIdx.x * BQ;
  const int r0 = q0 + 16 * (tid >> 5) + ((tid & 31) >> 2);
  const float* kb = k + b * st.k[0] + h * st.k[1];
  const float* vb = v + b * st.v[0] + h * st.v[1];
  const uint8_t* mb =
      mask == nullptr ? nullptr : mask + b * st.mask[0] + h * st.mask[1];
  const float* bb = BIAS ? bias + b * st.bias[0] + h * st.bias[1] : nullptr;
  float* db = BIAS ? dbias + static_cast<long long>(bh) * T1 * T2 : nullptr;
  auto stage = [&](int k0) {  // 32 keys from k0
    stage_raw<D, QHALF>(smem_u32(base + RK), kb, st.k[2], k0, T2, tid);
    stage_raw<D, QHALF>(smem_u32(base + RV), vb, st.v[2], k0, T2, tid);
  };

  split_rows<D, BQ>(base + QH, base + QL,
                    GlobalRows{q + b * st.q[0] + h * st.q[1], st.q[2], q0,
                               T1},
                    tid);
  split_rows<D, BQ>(base + DOH, base + DOL,
                    GlobalRows{dout + b * st.dout[0] + h * st.dout[1],
                               st.dout[2], q0, T1},
                    tid);
  const Rows rows(lse + static_cast<long long>(bh) * T1,
                  delta + static_cast<long long>(bh) * T1, r0, T1);
  __shared__ uint32_t votes[4];
  Walker walk{mb, st.mask[2], st.mask[3], T1, T2, r0, tq, tid >> 5, tid & 31,
              votes, mb == nullptr || st.mask[2] == 0};
  if (walk.cols) walk.prefetch();
  uint32_t bits;
  int kt = walk.next(bits), half = 0;
  if (kt < T2) stage(kt);
  cp_async_commit();

  float acc[D / 2];
  zero(acc);
  int done = 0;  // dbias columns written
  while (kt < T2) {
    cp_async_wait<0>();
    __syncthreads();  // the raw half has landed; the last products are done
    split_rows<D, QHALF>(base + KH, base + KL, RawTile<D>{base + RK}, tid);
    split_rows<D, QHALF>(base + VH, base + VL, RawTile<D>{base + RV}, tid);
    fence_async_smem();
    __syncthreads();  // the split halves are published
    const int k0 = kt + QHALF * half;  // this half's first key
    const uint32_t hbits = (bits >> (16 * half)) & 0xffffu;

    const uint64_t d0 = desc(smem_u32(base));
    auto kmaj = [&](int off, int rows_, int ks) {  // k-step ks of a tile
      return kstep(d0, off, rows_, ks);
    };
    // 64 query rows x 32 keys: S and dP, each chain's hi . hi products of
    // its second half of k-steps in a fragment of its own, summed in FFMA
    float s[16], g[16], sb[16], gb[16];
    zero(s);
    zero(g);
    zero(sb);
    zero(gb);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {  // the small terms first
      mma_tf32_ss(s, kmaj(QL, BQ, ks), kmaj(KH, QHALF, ks));
      mma_tf32_ss(s, kmaj(QH, BQ, ks), kmaj(KL, QHALF, ks));
      mma_tf32_ss(g, kmaj(DOL, BQ, ks), kmaj(VH, QHALF, ks));
      mma_tf32_ss(g, kmaj(DOH, BQ, ks), kmaj(VL, QHALF, ks));
    }
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      mma_tf32_ss(s, kmaj(QH, BQ, ks), kmaj(KH, QHALF, ks));
      mma_tf32_ss(g, kmaj(DOH, BQ, ks), kmaj(VH, QHALF, ks));
    }
#pragma unroll
    for (int ks = D / 16; ks < D / 8; ++ks) {
      mma_tf32_ss(sb, kmaj(QH, BQ, ks), kmaj(KH, QHALF, ks));
      mma_tf32_ss(gb, kmaj(DOH, BQ, ks), kmaj(VH, QHALF, ks));
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(s);
    pin(g);
    pin(sb);
    pin(gb);
    add_frag(s, sb);
    add_frag(g, gb);

    __syncthreads();  // every warp's products have read K's split rows
    // K^T (128 rows of 32 keys) over K's split rows
    split_cols<D, QHALF>(base + KH, base + KL, RawTile<D>{base + RK}, tid);
    fence_async_smem();
    __syncthreads();  // K^T is published, the raw half free
    int hn = half;
    uint32_t bits_next = bits;
    const int kn = next_half(kt, hn, bits_next, T2,
                             [&](uint32_t& bn) { return walk.next(bn); });
    if (kn < T2) stage(kn + QHALF * hn);
    cp_async_commit();

    zero_cols(db, q0, T1, T2, done, k0, tid);
    done = k0 + QHALF;
    grad_rows(s, g, hbits, rows, bb, db, st, r0, tq, k0, T1, T2, scale);
    uint32_t dsh[4][4], dsl[4][4];  // dS in split_cols's order
    frag_tf32(g, dsh, dsl);
    float f[D / 2];  // the half's dS . K, added to dQ in FFMA
    zero(f);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      mma_tf32_rs(f, dsl[ks], kmaj(KH, D, ks));
      mma_tf32_rs(f, dsh[ks], kmaj(KL, D, ks));
    }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) mma_tf32_rs(f, dsh[ks], kmaj(KH, D, ks));
    wgmma_commit();
    wgmma_wait_all();
    pin(f);
    pin(dsh);
    pin(dsl);
    add_frag(acc, f);
    kt = kn;
    half = hn;
    bits = bits_next;
  }
  cp_async_wait<0>();
  zero_cols(db, q0, T1, T2, done, T2, tid);
  store_tile<D>(acc, dq + b * st.g0[0] + h * st.g0[1], st.g0[2], r0, tq, T1);
}

// K, V split (64 rows); Q, dO split, 32 query rows (their split rows,
// then Q^T and dO^T); raw Q, dO; raw lse, delta
constexpr size_t DKV_TF32_WIDE_SMEM =
    1024 + 4 * TILE128 + 6 * HALF128 + 2 * QHALF * 4;

template <bool BIAS>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_tf32_wide(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const uint8_t* __restrict__ mask,
                            const float* __restrict__ bias,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dk, float* __restrict__ dv,
                            Strides st, int H, int T1, int T2, float scale) {
  constexpr int D = D128;
  constexpr int KH = 0, KL = TILE128, VH = 2 * TILE128, VL = 3 * TILE128,
                QH = 4 * TILE128, QL = QH + HALF128, DOH = QL + HALF128,
                DOL = DOH + HALF128, RQ = DOL + HALF128, RDO = RQ + HALF128,
                RLSE = RDO + HALF128;
  extern __shared__ uint8_t smem_raw[];
  __shared__ float cols_s[2][QHALF];  // the half's lse, delta
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const float* raw_cols = reinterpret_cast<const float*>(base + RLSE);

  const int tid = threadIdx.x, tq = tid & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, k0 = blockIdx.x * BK;
  const int kr0 = k0 + 16 * (tid >> 5) + ((tid & 31) >> 2);
  const float* qb = q + b * st.q[0] + h * st.q[1];
  const float* dob = dout + b * st.dout[0] + h * st.dout[1];
  const float* lb = lse + static_cast<long long>(bh) * T1;
  const float* dlb = delta + static_cast<long long>(bh) * T1;
  const uint8_t* mb =
      mask == nullptr ? nullptr : mask + b * st.mask[0] + h * st.mask[1];
  const float* bb = BIAS ? bias + b * st.bias[0] + h * st.bias[1] : nullptr;
  auto stage = [&](int q0) {  // 32 query rows from q0
    stage_raw<D, QHALF>(smem_u32(base + RQ), qb, st.q[2], q0, T1, tid);
    stage_raw<D, QHALF>(smem_u32(base + RDO), dob, st.dout[2], q0, T1, tid);
    if (tid < 2 * QHALF) {  // threads 0-31: lse, 32-63: delta
      const int i = tid % QHALF;
      const float* src = tid < QHALF ? lb : dlb;
      const bool ok = q0 + i < T1;
      cp_async4(smem_u32(raw_cols + tid), ok ? src + q0 + i : src,
                ok ? 4 : 0);
    }
  };

  split_rows<D, BK>(base + KH, base + KL,
                    GlobalRows{k + b * st.k[0] + h * st.k[1], st.k[2], k0,
                               T2},
                    tid);
  split_rows<D, BK>(base + VH, base + VL,
                    GlobalRows{v + b * st.v[0] + h * st.v[1], st.v[2], k0,
                               T2},
                    tid);
  QueryWalker walk{mb, st.mask[2], st.mask[3], T1, T2, kr0, tq,
                   mb == nullptr || st.mask[2] == 0};
  walk.init();
  uint32_t bits;
  int qt = walk.next(0, bits), half = 0;
  if (qt < T1) stage(qt);
  cp_async_commit();

  float dka[D / 2], dva[D / 2];
  zero(dka);
  zero(dva);
  while (qt < T1) {
    cp_async_wait<0>();
    __syncthreads();  // the raw half has landed; the last products are done
    split_rows<D, QHALF>(base + QH, base + QL, RawTile<D>{base + RQ}, tid);
    split_rows<D, QHALF>(base + DOH, base + DOL, RawTile<D>{base + RDO},
                         tid);
    if (tid < 2 * QHALF) cols_s[tid / QHALF][tid % QHALF] = raw_cols[tid];
    fence_async_smem();
    __syncthreads();  // the split halves are published
    const int q0 = qt + QHALF * half;  // this half's first query
    const uint32_t hbits = (bits >> (16 * half)) & 0xffffu;

    const uint64_t d0 = desc(smem_u32(base));
    auto kmaj = [&](int off, int rows_, int ks) {  // k-step ks of a tile
      return kstep(d0, off, rows_, ks);
    };
    // S^T, dP^T: 64 keys x 32 query rows
    float s[16], g[16];
    zero(s);
    zero(g);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {  // the small terms first
      mma_tf32_ss(s, kmaj(KL, BK, ks), kmaj(QH, QHALF, ks));
      mma_tf32_ss(s, kmaj(KH, BK, ks), kmaj(QL, QHALF, ks));
      mma_tf32_ss(g, kmaj(VL, BK, ks), kmaj(DOH, QHALF, ks));
      mma_tf32_ss(g, kmaj(VH, BK, ks), kmaj(DOL, QHALF, ks));
    }
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {
      mma_tf32_ss(s, kmaj(KH, BK, ks), kmaj(QH, QHALF, ks));
      mma_tf32_ss(g, kmaj(VH, BK, ks), kmaj(DOH, QHALF, ks));
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(s);
    pin(g);

    __syncthreads();  // every warp's products have read the split rows
    // Q^T and dO^T (128 rows of 32 queries) over their split rows
    split_cols<D, QHALF>(base + QH, base + QL, RawTile<D>{base + RQ}, tid);
    split_cols<D, QHALF>(base + DOH, base + DOL, RawTile<D>{base + RDO},
                         tid);
    fence_async_smem();
    __syncthreads();  // Q^T and dO^T are published, the raw halves free
    int hn = half;
    uint32_t bits_next = bits;
    const int qn = next_half(qt, hn, bits_next, T1, [&](uint32_t& bn) {
      return walk.next(qt + BQ, bn);
    });
    if (qn < T1) stage(qn + QHALF * hn);
    cp_async_commit();

    grad_cols(s, g, hbits, cols_s[0], cols_s[1], bb, st, kr0, tq, q0,
              scale);
    // P^T . dO, then dS^T . Q, 64 of the 128 output columns at a time,
    // each into the zeroed fragment f that FFMA adds to dV, dK
    float f[32];
    auto product = [&](float* acc, const uint32_t (&hi)[4][4],
                       const uint32_t (&lo)[4][4], int th, int tl) {
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {  // the B tile's rows 64 c ..
        zero(f);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          mma_tf32_rs(f, lo[ks], kmaj(th, D, ks) + 512 * c);
          mma_tf32_rs(f, hi[ks], kmaj(tl, D, ks) + 512 * c);
        }
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          mma_tf32_rs(f, hi[ks], kmaj(th, D, ks) + 512 * c);
        wgmma_commit();
        wgmma_wait_all();
        pin(f);
        add_frag(acc + 32 * c, f);
      }
    };
    {
      uint32_t ph[4][4], pl[4][4];
      frag_tf32(s, ph, pl);
      product(dva, ph, pl, DOH, DOL);
      pin(ph);
      pin(pl);
    }
    uint32_t dsh[4][4], dsl[4][4];
    frag_tf32(g, dsh, dsl);
    product(dka, dsh, dsl, QH, QL);
    pin(dsh);
    pin(dsl);
    qt = qn;
    half = hn;
    bits = bits_next;
  }
  cp_async_wait<0>();
  store_tile<D>(dka, dk + b * st.g0[0] + h * st.g0[1], st.g0[2], kr0, tq, T2);
  store_tile<D>(dva, dv + b * st.g1[0] + h * st.g1[1], st.g1[2], kr0, tq, T2);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// One block per 64 rows of `rows` (K5: T1, K6: T2) and per (batch, head).
template <typename T, typename G, typename Kernel>
int launch_kernel(Kernel kernel, size_t smem, int threads, int rows,
                  const Args& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((rows + 63) / 64, a.B * a.H);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const uint8_t*>(a.mask),
      a.bias, static_cast<const T*>(a.dout), a.lse, a.delta,
      static_cast<T*>(a.g0), static_cast<G*>(a.g1), a.st, a.H, a.T1, a.T2,
      a.scale);
  return static_cast<int>(cudaGetLastError());
}

// K5 (DQ) or K6 in T at head dim D, an instance without the bias and one
// with it (the bias's code, unused, still cost the kernel without a bias
// a fifth of its time in registers); at d = 128 the fp32 kernels and the
// bf16 K6 stream 32-wide halves (the note at the top).
template <bool DQ, typename T, int D>
int launch_one(const Args& a, cudaStream_t s) {
  using G = std::conditional_t<DQ, float, T>;  // K5: dbias, K6: dv
  const int rows = DQ ? a.T1 : a.T2;
  const bool bias = a.bias != nullptr;
  if constexpr (D == 128 && std::is_same_v<T, float>) {
    if constexpr (DQ)
      return launch_kernel<T, G>(bias ? flash_bwd_dq_tf32_wide<true>
                                      : flash_bwd_dq_tf32_wide<false>,
                                 DQ_TF32_WIDE_SMEM, THREADS, rows, a, s);
    else
      return launch_kernel<T, G>(bias ? flash_bwd_dkv_tf32_wide<true>
                                      : flash_bwd_dkv_tf32_wide<false>,
                                 DKV_TF32_WIDE_SMEM, THREADS, rows, a, s);
  } else if constexpr (D == 128 && !DQ) {
    return launch_kernel<T, G>(bias ? flash_bwd_dkv_bf16_wide<true>
                                    : flash_bwd_dkv_bf16_wide<false>,
                               DKV_BF16_WIDE_SMEM, THREADS, rows, a, s);
  } else if constexpr (std::is_same_v<T, float>) {
    constexpr size_t smem = DQ ? dq_tf32_smem<D>() : dkv_tf32_smem<D>();
    if constexpr (DQ)
      return launch_kernel<T, G>(bias ? flash_bwd_dq_tf32<D, true>
                                      : flash_bwd_dq_tf32<D, false>,
                                 smem, THREADS, rows, a, s);
    else
      return launch_kernel<T, G>(bias ? flash_bwd_dkv_tf32<D, true>
                                      : flash_bwd_dkv_tf32<D, false>,
                                 smem, THREADS, rows, a, s);
  } else {
    if constexpr (DQ)
      return launch_kernel<T, G>(bias ? flash_bwd_dq_bf16<D, true>
                                      : flash_bwd_dq_bf16<D, false>,
                                 dq_bf16_smem<D>(), THREADS, rows, a, s);
    else
      return launch_kernel<T, G>(bias ? flash_bwd_dkv_bf16<D, true>
                                      : flash_bwd_dkv_bf16<D, false>,
                                 BF16_SMEM, THREADS, rows, a, s);
  }
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
