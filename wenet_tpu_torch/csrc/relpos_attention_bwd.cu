// Fused rel-pos attention backward for Hopper (sm_90a), plain C entry
// points.  Two kernels, as in the TPU version:
//
//   K2 relpos_bwd_dq_*    replaces `_relpos_bwd_dq_kernel`   (wenet_tpu/ops/
//                         flash_attention.py:719, called at :915)
//   K3 relpos_bwd_dkpv_*  replaces `_relpos_bwd_dkpv_kernel` (:784, called
//                         at :944)
//
// reached there through the custom VJP of `flash_attention_relpos`.  Both
// recompute, tile by tile, what the forward kernel (relpos_attention.cu)
// computed, from the saved row log-sum-exp instead of the (T1, T2)
// probabilities:
//
//   s  = (q1 . k^T + q2 . p^T) * scale, closed where masked
//   P  = exp(s - lse), 0 where closed (s <= NEG_INF / 2)
//   dS = P (D dP - delta) scale,  dP = do . v^T,  D the dropout multiplier,
//                                 delta = rowsum(do . out), given
//
//   K2:  dq1 = dS . k,  dq2 = dS . p
//   K3:  dv = (P D)^T . do,  dk = dS^T . q1,  dp = dS^T . q2
//
// Contract (as the forward): NEG_INF = -1e30; a fully masked row has lse =
// NEG_INF and no open element, so P = 0: zero dq, nothing added to dk, dp
// or dv.  Ragged T1 / T2 edges are zero-filled on load and masked.  q1,
// q2, k, p, v, do and the gradients are read and written through (batch,
// head, time) strides with a unit-stride feature dim, with bases and
// strides 16-byte aligned (the wrapper checks); p may be shared by the
// batch (batch stride 0) and the mask may be one row for all queries (row
// stride 0).  dp is written per (b, h) in fp32; the caller sums it over
// the batch when p was shared.  Dropout is the counter hash of
// dropout_hash.cuh at each element's global (query, key), so the mask is
// the forward's, regenerated on the fragment; no (T1, T2) tensor reaches
// device memory.  Neither kernel needs a reduction across blocks.
//
// The products, each a wgmma m64nNk16 (bf16) or m64nNk8 (tf32) in
// hopper_mma.cuh's 128-byte swizzled layout (flash_tiles.cuh has the
// fragment layout):
//   K2, one warpgroup per 64 query rows of one (b, h), walking key tiles:
//       S  = [Q1|Q2] . [K|P]^T  one accumulator of depth 2d, fed by the
//                               k-steps of both products (as K1); A = Q1,
//                               Q2 resident, B = K, P: K-major as stored
//       dP = dO . V^T           A = dO resident, B = V, K-major
//       [dQ1|dQ2] += dS . [K|P] A = dS from registers (dP's accumulator is
//                               the A fragment); B = K, P as stored
//                               (bf16: MN-major through the transpose bit)
//   K3, one warpgroup per 64 keys, walking query tiles (K6's transposed
//   design, flash_attention_bwd.cu):
//       S^T  = [K|P] . [Q1|Q2]^T, dP^T = V . dO^T: A = K, P, V resident,
//              B = the query tile, K-major; P^T and dS^T come out of the
//              accumulators already as A fragments, with the block's keys
//              as rows
//       dV += (P D)^T . dO, [dK|dP] += dS^T . [Q1|Q2]
//   lse and delta are per row in K2 (registers) and per column in K3
//   (shared memory, with each query tile).
//
// bf16: Q1, Q2, K, P, V and dO are exact bf16 tiles, by cp.async into a
// ring of two stages (the next tile's copies in flight while this one
// computes).  P D and dS are rounded to bf16 for the products that take
// them, once, except dS in K3's [dK|dP] = dS^T . [Q1|Q2], which goes in as
// two halves hi = bf16(dS) and lo = bf16(dS - hi): one more wgmma per
// k-step for each of dK and dP.  Emulated in fp32 on chip_smoke 6a's
// peaked shape (q1, q2 scaled by 8; tests/test_torch_relpos_bwd_precision.py)
// against float64 with the reference's delta: one rounding of dS puts dk
// and dp at 44% and 68% of TRAIN_TOL (bf16: atol 5e-2, rtol 2e-2), the
// halves at 17% and 16%; dq (dS rounded once) reads 21% and dv (P D
// once) 36%.  What 6a reads on that shape (dk 71%, dp 93% on an H100,
// as with the exact FFMA kernel before) is not K3's rounding: it is
// delta, which the Function takes from K1's bf16 output, where a few
// outputs round the other way from the reference's; with exact K2 and K3
// the emulation puts that alone at 99% and 105% on its own inputs, and
// the halves add nothing to it.
// fp32: 3xTF32.  Each operand is split x = hi + lo, both rounded to tf32,
// and hi.hi + hi.lo + lo.hi is accumulated in fp32 (the small terms
// first).  tf32 takes both operands K-major, so the operands that bf16
// reads MN-major (K, P in K2; Q1, Q2, dO in K3) get a second, transposed
// split copy with rows permuted within each group of 8 (split_cols), so
// that the accumulator is the A fragment without shuffles.  The split
// tiles do not fit 227 KB at 64 wide (K2 304 KB, K3 336 KB at d = 64), so
// the streamed operand moves in 32-wide halves of the walked 64-wide
// tiles: 32 keys in K2, 32 query rows in K3 (wgmma N = 32 for S and dP),
// staged raw by cp.async a half ahead and split from shared memory.
// Shared memory at d = 64 (d = 32: half):
//   K2 bf16  Q1, Q2, dO + 2 x (K, P, V) bf16 tiles        74,752 bytes
//   K3 bf16  K, P, V + 2 x (Q1, Q2, dO), + lse, delta     74,752 + 1,024
//   K2 fp32  Q1, Q2, dO split (96 KB); K, P, V, K^T, P^T
//            split and K, P, V raw, 32 keys (104 KB)     205,824 bytes
//   K3 fp32  K, P, V split (96 KB); Q1, Q2, dO and their
//            transposes split and raw, 32 rows (120 KB) 222,464 + 256
// Registers (fp32 accumulator values a thread at d = 64): K2 bf16 dQ1,
// dQ2 64 + S, dP 64; K3 bf16 dK, dP, dV 96 + S^T, dP^T 64 + fragments 48
// (two blocks an SM each); K2 fp32 64 + 32 + fragments 32; K3 fp32 96 +
// 32 + fragments 64 (one block an SM).  Each dropout setting is its own
// instance, its mask drawn into one register of keep bits while the
// score products run, and the wgmma descriptors are derived per product
// (kstep), so that nothing holds registers where it is not used: ptxas
// gives 139-255 registers (build/relpos_attention_bwd.log; drawing the
// mask per element after the products spilled 24 bytes in K3 bf16 with
// dropout).
// fp32 sums: wgmma does not round its fp32 sums to nearest, so a sum left
// in its accumulator over the whole tile loop drifts from float64
// (chip_smoke 2b on an H100: dq 4.1-5.2x, dk, dp, dv 6.0-6.9x the plain
// version's rms error).  S's two products go into two fragments that
// FFMA adds, and each half's dQ1 and dQ2 (K2) and dV, dK and dP (K3, 32
// output columns at a time) into a zeroed fragment that FFMA adds to the
// sum, one product after the other: 1.4-1.9x.  K3 fp32 at d = 64 then
// spills 80 bytes and takes 12-15% longer (PERF.md).
//
// Skipped tiles.  K2 walks its key tiles with K1's Walker: a one-row mask
// is voted a tile ahead by ballot, a per-row mask read per element.  K3
// skips the query tiles that the mask closes for its whole key block
// (QueryWalker, as K6): a one-row mask is read once per thread, for its
// two keys, so a key block in the padded tail skips every tile and writes
// zeros to dk, dp and dv (allocated empty); the train step's per-row
// dynamic-chunk mask is read per element, transposed, and closes many
// query tiles of the late key blocks.  K2 writes every row of dq1, dq2.
//
// d = 128 (in both types) takes the first port's bodies, FFMA on the
// CUDA cores in fp32 with bf16 upcast on load (namespace ffma; 256
// threads, each a 4x4 block of the score tile): on wgmma K2 would hold
// dQ1 and dQ2, 128 fp32 registers a thread, beside S and dP, and K3 three
// such sums.  Shared memory (padded fp32 rows of 129 values): K2 64-row
// query and 64-key tiles, 214,784 bytes; K3 64 keys and 32-row query
// tiles, 165,760 bytes (64-row ones would need 231,936, 512 bytes short of
// the 232,448 a block may have with any static shared memory beside).
//
// What bounds them on an H100: 10 d (K2) and 12 d (K3) FLOPs per attended
// (query, key) pair, on the tensor cores (989 TFLOP/s in bf16; fp32 as
// three tf32 products, 495 / 3 TFLOP/s), against each input read once
// and each gradient written once at 3.35 TB/s.  At the train step's
// short utterances (B = 16 x 299 frames, 2.7M attended pairs with the
// chunk mask) the bytes bound bf16 (K2 5.6 us, against 1.8 us on the
// tensor cores) and match the 3xTF32 time in fp32 (K2 10.8 and 10.5 us),
// but the kernels take 5-10 times that: 320 blocks, each a chain of a few
// tiles whose exp2, dropout hash and mask sit between the products, and in
// fp32 the splitting of each streamed half (PERF.md has the times).

#include <type_traits>

#include "flash_tiles.cuh"
#include "relpos_common.cuh"

namespace {

using namespace flash;

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

// ---------------------------------------------------------------------------
// the gradient of a tile, on the fragment
// ---------------------------------------------------------------------------

// K2 (rows are queries r0, r0 + 8, with their lse and delta in `rows`;
// columns are keys): dP times the dropout multiplier (keep: keep_bits),
// then P into s and dS into g.
template <bool DROPOUT, int N>
__device__ __forceinline__ void dq_grad(float (&s)[N], float (&g)[N],
                                        uint32_t bits, const Rows& rows,
                                        uint32_t keep,
                                        const DropoutParams& dp,
                                        float scale) {
  const float sl2 = scale * LOG2E;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int row = (i >> 1) & 1;
    if constexpr (DROPOUT) g[i] = dropped(g[i], keep, i, dp);
    grad(s[i], g[i], (bits >> i) & 1u, rows.lse2[row], rows.delta[row], sl2,
         scale);
  }
}

// K3, on the transposed fragment: rows are keys, columns queries
// 8 j + 2 tq + {0, 1} of the tile, whose lse and delta are in shared
// memory (ls, dl: the tile's values).  The dropout multiplier (keep:
// keep_bits) scales dP^T before dS and P after it: s leaves as P D (for
// dV), g as dS^T (for dK and dP).
template <bool DROPOUT, int N>
__device__ __forceinline__ void dkpv_grad(float (&s)[N], float (&g)[N],
                                          uint32_t bits, const float* ls,
                                          const float* dl, uint32_t keep,
                                          const DropoutParams& dp, int tq,
                                          float scale) {
  const float sl2 = scale * LOG2E;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = 8 * (i >> 2) + 2 * tq + (i & 1);
    if constexpr (DROPOUT) g[i] = dropped(g[i], keep, i, dp);
    grad(s[i], g[i], (bits >> i) & 1u, ls[c] * LOG2E, dl[c], sl2, scale);
    if constexpr (DROPOUT) s[i] = dropped(s[i], keep, i, dp);
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma on bf16 tiles, cp.async into two stages
// ---------------------------------------------------------------------------

constexpr size_t BF16_SMEM = 1024 + 9 * TILE16;  // 3 resident, 2 x 3 streamed

template <int D, bool DROPOUT>
__global__ void __launch_bounds__(THREADS, 2)
    relpos_bwd_dq_bf16(const __nv_bfloat16* __restrict__ q1,
                       const __nv_bfloat16* __restrict__ q2,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ p,
                       const __nv_bfloat16* __restrict__ v,
                       const uint8_t* __restrict__ mask,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq1,
                       __nv_bfloat16* __restrict__ dq2, Strides st, int H,
                       int T1, int T2, float scale, DropoutParams dp) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq1 = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sq2 = sq1 + TILE16, sdo = sq2 + TILE16;
  auto stage_k = [&](int stage) {  // K, then P, then V
    return sq1 + 3 * TILE16 + 3 * stage * TILE16;
  };

  const int tid = threadIdx.x, tq = tid & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, q0 = blockIdx.x * BQ;
  const int r0 = q0 + 16 * (tid >> 5) + ((tid & 31) >> 2);
  const __nv_bfloat16* kb = k + b * st.k[0] + h * st.k[1];
  const __nv_bfloat16* pb = p + b * st.p[0] + h * st.p[1];
  const __nv_bfloat16* vb = v + b * st.v[0] + h * st.v[1];
  const uint8_t* mb = mask == nullptr ? nullptr : mask + b * st.mask[0];
  auto load = [&](int stage, int kt) {
    const uint32_t t = stage_k(stage);
    load_rows<D, BK>(t, kb, st.k[2], kt, T2, tid);
    load_rows<D, BK>(t + TILE16, pb, st.p[2], kt, T2, tid);
    load_rows<D, BK>(t + 2 * TILE16, vb, st.v[2], kt, T2, tid);
  };

  load_rows<D, BQ>(sq1, q1 + b * st.q1[0] + h * st.q1[1], st.q1[2], q0, T1,
                   tid);
  load_rows<D, BQ>(sq2, q2 + b * st.q2[0] + h * st.q2[1], st.q2[2], q0, T1,
                   tid);
  load_rows<D, BQ>(sdo, dout + b * st.dout[0] + h * st.dout[1], st.dout[2],
                   q0, T1, tid);
  cp_async_commit();
  const Rows rows(lse + static_cast<long long>(bh) * T1,
                  delta + static_cast<long long>(bh) * T1, r0, T1);
  __shared__ uint32_t votes[4];
  Walker walk{mb, st.mask[1], st.mask[2], T1, T2, r0, tq, tid >> 5, tid & 31,
              votes, mb == nullptr || st.mask[1] == 0};
  if (walk.cols) walk.prefetch();
  uint32_t bits;
  int kt = walk.next(bits);
  if (kt < T2) load(0, kt);
  cp_async_commit();

  float a1[32], a2[32];  // dQ1, dQ2
#pragma unroll
  for (int i = 0; i < 32; ++i) a1[i] = a2[i] = 0.f;
  int stage = 0;
  while (kt < T2) {
    // the vote is a barrier: every warp is done with the stage refilled
    uint32_t bits_next;
    const int kn = walk.next(bits_next);
    if (kn < T2) load(stage ^ 1, kn);
    cp_async_commit();
    cp_async_wait<1>();  // Q1, Q2, dO and this tile have landed
    fence_async_smem();
    __syncthreads();
    const uint32_t sk = stage_k(stage), sp = sk + TILE16, sv = sp + TILE16;

    float s[32], g[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = g[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      mma_bf16_ss(s, desc_k(sq1, BQ, ks), desc_k(sk, BK, ks));
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      mma_bf16_ss(s, desc_k(sq2, BQ, ks), desc_k(sp, BK, ks));
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      mma_bf16_ss(g, desc_k(sdo, BQ, ks), desc_k(sv, BK, ks));
    wgmma_commit();
    // the dropout mask, drawn while the products run
    const uint32_t keep =
        DROPOUT ? keep_bits<32>(dp, bh, r0, kt + 2 * tq) : 0u;
    wgmma_wait_all();
    pin(s);
    pin(g);

    dq_grad<DROPOUT>(s, g, bits, rows, keep, dp, scale);
    uint32_t ds[4][4];
    frag_bf16(g, ds);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {  // 16 key rows of 128 bytes
      mma_bf16_rs(a1, ds[ks], desc(sk + ks * 16 * 128, BK * 128));
      mma_bf16_rs(a2, ds[ks], desc(sp + ks * 16 * 128, BK * 128));
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(a1);
    pin(a2);
    pin(ds);
    kt = kn;
    bits = bits_next;
    stage ^= 1;
  }
  cp_async_wait<0>();
  store_tile<D>(a1, dq1 + b * st.dq1[0] + h * st.dq1[1], st.dq1[2], r0, tq,
                T1);
  store_tile<D>(a2, dq2 + b * st.dq2[0] + h * st.dq2[1], st.dq2[2], r0, tq,
                T1);
}

template <int D, bool DROPOUT>
__global__ void __launch_bounds__(THREADS, 2)
    relpos_bwd_dkpv_bf16(const __nv_bfloat16* __restrict__ q1,
                         const __nv_bfloat16* __restrict__ q2,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ p,
                         const __nv_bfloat16* __restrict__ v,
                         const uint8_t* __restrict__ mask,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         float* __restrict__ dpos,
                         __nv_bfloat16* __restrict__ dv, Strides st, int H,
                         int T1, int T2, float scale, DropoutParams dp) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ float cols_s[2][2][BQ];  // per stage: the tile's lse, delta
  const uint32_t sk = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sp = sk + TILE16, sv = sp + TILE16;
  auto stage_q = [&](int stage) {  // Q1, then Q2, then dO
    return sk + 3 * TILE16 + 3 * stage * TILE16;
  };

  const int tid = threadIdx.x, tq = tid & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, k0 = blockIdx.x * BK;
  const int kr0 = k0 + 16 * (tid >> 5) + ((tid & 31) >> 2);
  const __nv_bfloat16* q1b = q1 + b * st.q1[0] + h * st.q1[1];
  const __nv_bfloat16* q2b = q2 + b * st.q2[0] + h * st.q2[1];
  const __nv_bfloat16* dob = dout + b * st.dout[0] + h * st.dout[1];
  const float* lb = lse + static_cast<long long>(bh) * T1;
  const float* dlb = delta + static_cast<long long>(bh) * T1;
  const uint8_t* mb = mask == nullptr ? nullptr : mask + b * st.mask[0];

  load_rows<D, BK>(sk, k + b * st.k[0] + h * st.k[1], st.k[2], k0, T2, tid);
  load_rows<D, BK>(sp, p + b * st.p[0] + h * st.p[1], st.p[2], k0, T2, tid);
  load_rows<D, BK>(sv, v + b * st.v[0] + h * st.v[1], st.v[2], k0, T2, tid);
  auto load_tile = [&](int stage, int qt) {
    const uint32_t t = stage_q(stage);
    load_rows<D, BQ>(t, q1b, st.q1[2], qt, T1, tid);
    load_rows<D, BQ>(t + TILE16, q2b, st.q2[2], qt, T1, tid);
    load_rows<D, BQ>(t + 2 * TILE16, dob, st.dout[2], qt, T1, tid);
    const int i = tid % BQ;  // threads 0-63: lse, 64-127: delta
    const float* src = tid < BQ ? lb : dlb;
    const bool ok = qt + i < T1;
    cp_async4(smem_u32(&cols_s[stage][tid / BQ][i]), ok ? src + qt + i : src,
              ok ? 4 : 0);
  };
  QueryWalker walk{mb, st.mask[1], st.mask[2], T1, T2, kr0, tq,
                   mb == nullptr || st.mask[1] == 0};
  walk.init();
  uint32_t bits;
  int qt = walk.next(0, bits);
  if (qt < T1) load_tile(0, qt);
  cp_async_commit();  // K, P, V and the first tile

  float dka[32], dpa[32], dva[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dka[i] = dpa[i] = dva[i] = 0.f;
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
    const uint32_t sq1 = stage_q(stage), sq2 = sq1 + TILE16,
                   sdo = sq2 + TILE16;

    float s[32], g[32];  // S^T, dP^T: rows are keys, columns queries
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = g[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      mma_bf16_ss(s, desc_k(sk, BK, ks), desc_k(sq1, BQ, ks));
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      mma_bf16_ss(s, desc_k(sp, BK, ks), desc_k(sq2, BQ, ks));
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      mma_bf16_ss(g, desc_k(sv, BK, ks), desc_k(sdo, BQ, ks));
    wgmma_commit();
    const uint32_t keep =
        DROPOUT ? keep_bits<32, true>(dp, bh, kr0, qt + 2 * tq) : 0u;
    wgmma_wait_all();
    pin(s);
    pin(g);

    dkpv_grad<DROPOUT>(s, g, bits, cols_s[stage][0], cols_s[stage][1], keep,
                       dp, tq, scale);
    // dS^T as hi + lo halves for [dK|dP] (q1, q2 as large as they come)
    uint32_t pf[4][4], dsh[4][4], dsl[4][4];
    frag_bf16(s, pf);
    frag_bf16_split(g, dsh, dsl);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {  // 16 query rows of 128 bytes
      const uint64_t b1 = desc(sq1 + ks * 16 * 128, BQ * 128);
      const uint64_t b2 = desc(sq2 + ks * 16 * 128, BQ * 128);
      mma_bf16_rs(dva, pf[ks], desc(sdo + ks * 16 * 128, BQ * 128));
      mma_bf16_rs(dka, dsl[ks], b1);
      mma_bf16_rs(dka, dsh[ks], b1);
      mma_bf16_rs(dpa, dsl[ks], b2);
      mma_bf16_rs(dpa, dsh[ks], b2);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(dva);
    pin(dka);
    pin(dpa);
    pin(pf);
    pin(dsh);
    pin(dsl);
    qt = qn;
    bits = bits_next;
    stage ^= 1;
  }
  cp_async_wait<0>();
  store_tile<D>(dka, dk + b * st.dk[0] + h * st.dk[1], st.dk[2], kr0, tq, T2);
  store_tile<D>(dpa, dpos + b * st.dp[0] + h * st.dp[1], st.dp[2], kr0, tq,
                T2);
  store_tile<D>(dva, dv + b * st.dv[0] + h * st.dv[1], st.dv[2], kr0, tq, T2);
}

// ---------------------------------------------------------------------------
// fp32: 3xTF32, the streamed operand in 32-wide halves
// ---------------------------------------------------------------------------

// One 32-row half of a 64 x D fp32 tile (and the 32-wide transpose of
// one: D rows of 32 values).
template <int D>
constexpr int HALF32 = 32 * D * 4;

// Q1, Q2, dO split (64 rows); K, P, V, K^T, P^T split and raw K, P, V (32
// keys)
template <int D>
constexpr size_t dq_tf32_smem() {
  return 1024 + 6 * TILE32<D> + 13 * HALF32<D>;
}

// K, P, V split (64 rows); Q1, Q2, dO, their transposes split and raw Q1,
// Q2, dO (32 query rows); raw lse, delta
template <int D>
constexpr size_t dkpv_tf32_smem() {
  return 1024 + 6 * TILE32<D> + 15 * HALF32<D> + 2 * 32 * 4;
}

template <int D, bool DROPOUT>
__global__ void __launch_bounds__(THREADS)
    relpos_bwd_dq_tf32(const float* __restrict__ q1,
                       const float* __restrict__ q2,
                       const float* __restrict__ k,
                       const float* __restrict__ p,
                       const float* __restrict__ v,
                       const uint8_t* __restrict__ mask,
                       const float* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       float* __restrict__ dq1, float* __restrict__ dq2,
                       Strides st, int H, int T1, int T2, float scale,
                       DropoutParams dp) {
  constexpr int HALF = HALF32<D>;
  enum { Q1H = 0, Q1L = 2, Q2H = 4, Q2L = 6, DOH = 8, DOL = 10,  // 64 rows
         KH = 12, KL, PH, PL, VH, VL, KTH, KTL, PTH, PTL, RK, RP, RV };
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  auto tile = [&](int i) { return base + i * HALF; };

  const int tid = threadIdx.x, tq = tid & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, q0 = blockIdx.x * BQ;
  const int r0 = q0 + 16 * (tid >> 5) + ((tid & 31) >> 2);
  const float* kb = k + b * st.k[0] + h * st.k[1];
  const float* pb = p + b * st.p[0] + h * st.p[1];
  const float* vb = v + b * st.v[0] + h * st.v[1];
  const uint8_t* mb = mask == nullptr ? nullptr : mask + b * st.mask[0];
  auto stage = [&](int kt) {  // 32 keys from kt
    stage_raw<D, 32>(smem_u32(tile(RK)), kb, st.k[2], kt, T2, tid);
    stage_raw<D, 32>(smem_u32(tile(RP)), pb, st.p[2], kt, T2, tid);
    stage_raw<D, 32>(smem_u32(tile(RV)), vb, st.v[2], kt, T2, tid);
  };

  split_rows<D, BQ>(
      tile(Q1H), tile(Q1L),
      GlobalRows{q1 + b * st.q1[0] + h * st.q1[1], st.q1[2], q0, T1}, tid);
  split_rows<D, BQ>(
      tile(Q2H), tile(Q2L),
      GlobalRows{q2 + b * st.q2[0] + h * st.q2[1], st.q2[2], q0, T1}, tid);
  split_rows<D, BQ>(tile(DOH), tile(DOL),
                    GlobalRows{dout + b * st.dout[0] + h * st.dout[1],
                               st.dout[2], q0, T1},
                    tid);
  const Rows rows(lse + static_cast<long long>(bh) * T1,
                  delta + static_cast<long long>(bh) * T1, r0, T1);
  __shared__ uint32_t votes[4];
  Walker walk{mb, st.mask[1], st.mask[2], T1, T2, r0, tq, tid >> 5, tid & 31,
              votes, mb == nullptr || st.mask[1] == 0};
  if (walk.cols) walk.prefetch();
  uint32_t bits;
  int kt = walk.next(bits), half = 0;
  if (kt < T2) stage(kt);
  cp_async_commit();

  float a1[D / 2], a2[D / 2];  // dQ1, dQ2
#pragma unroll
  for (int i = 0; i < D / 2; ++i) a1[i] = a2[i] = 0.f;
  while (kt < T2) {
    cp_async_wait<0>();
    __syncthreads();  // the raw half has landed; the last products are done
    split_rows<D, 32>(tile(KH), tile(KL), RawTile<D>{tile(RK)}, tid);
    split_rows<D, 32>(tile(PH), tile(PL), RawTile<D>{tile(RP)}, tid);
    split_rows<D, 32>(tile(VH), tile(VL), RawTile<D>{tile(RV)}, tid);
    split_cols<D, 32>(tile(KTH), tile(KTL), RawTile<D>{tile(RK)}, tid);
    split_cols<D, 32>(tile(PTH), tile(PTL), RawTile<D>{tile(RP)}, tid);
    fence_async_smem();
    __syncthreads();  // the split tiles are published, the raw ones free
    const int k0 = kt + 32 * half;  // this half's first key
    const uint32_t hbits = (bits >> (16 * half)) & 0xffffu;
    int hn = half;
    uint32_t bits_next = bits;
    const int kn = next_half(kt, hn, bits_next, T2,
                             [&](uint32_t& bn) { return walk.next(bn); });
    if (kn < T2) stage(kn + 32 * hn);
    cp_async_commit();

    const uint64_t d0 = desc(smem_u32(base));
    auto kmaj = [&](int i, int rows, int ks) {  // k-step ks of tile i
      return kstep(d0, i * HALF, rows, ks);
    };
    // 64 query rows x 32 keys: q1 . k^T and q2 . p^T, and dP, each in two
    // fragments as K1's scores (the second half of the k-steps' hi . hi
    // products in their own), summed in FFMA
    float s[16], s2[16], g[16], sb[16], s2b[16], gb[16];
    zero(s);
    zero(s2);
    zero(g);
    zero(sb);
    zero(s2b);
    zero(gb);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {  // the small terms first
      mma_tf32_ss(s, kmaj(Q1L, BQ, ks), kmaj(KH, 32, ks));
      mma_tf32_ss(s, kmaj(Q1H, BQ, ks), kmaj(KL, 32, ks));
      mma_tf32_ss(s2, kmaj(Q2L, BQ, ks), kmaj(PH, 32, ks));
      mma_tf32_ss(s2, kmaj(Q2H, BQ, ks), kmaj(PL, 32, ks));
      mma_tf32_ss(g, kmaj(DOL, BQ, ks), kmaj(VH, 32, ks));
      mma_tf32_ss(g, kmaj(DOH, BQ, ks), kmaj(VL, 32, ks));
    }
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      mma_tf32_ss(s, kmaj(Q1H, BQ, ks), kmaj(KH, 32, ks));
      mma_tf32_ss(s2, kmaj(Q2H, BQ, ks), kmaj(PH, 32, ks));
      mma_tf32_ss(g, kmaj(DOH, BQ, ks), kmaj(VH, 32, ks));
    }
#pragma unroll
    for (int ks = D / 16; ks < D / 8; ++ks) {
      mma_tf32_ss(sb, kmaj(Q1H, BQ, ks), kmaj(KH, 32, ks));
      mma_tf32_ss(s2b, kmaj(Q2H, BQ, ks), kmaj(PH, 32, ks));
      mma_tf32_ss(gb, kmaj(DOH, BQ, ks), kmaj(VH, 32, ks));
    }
    wgmma_commit();
    const uint32_t keep =
        DROPOUT ? keep_bits<16>(dp, bh, r0, k0 + 2 * tq) : 0u;
    wgmma_wait_all();
    pin(s);
    pin(s2);
    pin(g);
    pin(sb);
    pin(s2b);
    pin(gb);
    add_frag(s, sb);
    add_frag(s2, s2b);
    add_frag(g, gb);
    add_frag(s, s2);

    dq_grad<DROPOUT>(s, g, hbits, rows, keep, dp, scale);
    uint32_t dsh[4][4], dsl[4][4];  // dS in split_cols's order
    frag_tf32(g, dsh, dsl);
    // dS . K, then dS . P, each into the zeroed fragment f that FFMA adds
    // to dQ1, dQ2 (one fragment for both keeps the registers K2 had)
    float f[D / 2];
    auto product = [&](int th, int tl) {
      zero(f);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        mma_tf32_rs(f, dsl[ks], kmaj(th, D, ks));
        mma_tf32_rs(f, dsh[ks], kmaj(tl, D, ks));
      }
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) mma_tf32_rs(f, dsh[ks], kmaj(th, D, ks));
      wgmma_commit();
      wgmma_wait_all();
      pin(f);
      pin(dsh);
      pin(dsl);
    };
    product(KTH, KTL);
    add_frag(a1, f);
    product(PTH, PTL);
    add_frag(a2, f);
    kt = kn;
    half = hn;
    bits = bits_next;
  }
  cp_async_wait<0>();
  store_tile<D>(a1, dq1 + b * st.dq1[0] + h * st.dq1[1], st.dq1[2], r0, tq,
                T1);
  store_tile<D>(a2, dq2 + b * st.dq2[0] + h * st.dq2[1], st.dq2[2], r0, tq,
                T1);
}

template <int D, bool DROPOUT>
__global__ void __launch_bounds__(THREADS)
    relpos_bwd_dkpv_tf32(const float* __restrict__ q1,
                         const float* __restrict__ q2,
                         const float* __restrict__ k,
                         const float* __restrict__ p,
                         const float* __restrict__ v,
                         const uint8_t* __restrict__ mask,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dpos,
                         float* __restrict__ dv, Strides st, int H, int T1,
                         int T2, float scale, DropoutParams dp) {
  constexpr int HALF = HALF32<D>;
  enum { KH = 0, KL = 2, PH = 4, PL = 6, VH = 8, VL = 10,  // 64 rows
         Q1H = 12, Q1L, Q2H, Q2L, DOH, DOL, Q1TH, Q1TL, Q2TH, Q2TL, DOTH,
         DOTL, RQ1, RQ2, RDO, RLSE };
  extern __shared__ uint8_t smem_raw[];
  __shared__ float cols_s[2][32];  // the half's lse, delta
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  auto tile = [&](int i) { return base + i * HALF; };
  const float* raw_cols = reinterpret_cast<const float*>(tile(RLSE));

  const int tid = threadIdx.x, tq = tid & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, k0 = blockIdx.x * BK;
  const int kr0 = k0 + 16 * (tid >> 5) + ((tid & 31) >> 2);
  const float* q1b = q1 + b * st.q1[0] + h * st.q1[1];
  const float* q2b = q2 + b * st.q2[0] + h * st.q2[1];
  const float* dob = dout + b * st.dout[0] + h * st.dout[1];
  const float* lb = lse + static_cast<long long>(bh) * T1;
  const float* dlb = delta + static_cast<long long>(bh) * T1;
  const uint8_t* mb = mask == nullptr ? nullptr : mask + b * st.mask[0];
  auto stage = [&](int qt) {  // 32 query rows from qt
    stage_raw<D, 32>(smem_u32(tile(RQ1)), q1b, st.q1[2], qt, T1, tid);
    stage_raw<D, 32>(smem_u32(tile(RQ2)), q2b, st.q2[2], qt, T1, tid);
    stage_raw<D, 32>(smem_u32(tile(RDO)), dob, st.dout[2], qt, T1, tid);
    if (tid < 64) {  // threads 0-31: lse, 32-63: delta
      const int i = tid % 32;
      const float* src = tid < 32 ? lb : dlb;
      const bool ok = qt + i < T1;
      cp_async4(smem_u32(raw_cols + tid), ok ? src + qt + i : src,
                ok ? 4 : 0);
    }
  };

  split_rows<D, BK>(
      tile(KH), tile(KL),
      GlobalRows{k + b * st.k[0] + h * st.k[1], st.k[2], k0, T2}, tid);
  split_rows<D, BK>(
      tile(PH), tile(PL),
      GlobalRows{p + b * st.p[0] + h * st.p[1], st.p[2], k0, T2}, tid);
  split_rows<D, BK>(
      tile(VH), tile(VL),
      GlobalRows{v + b * st.v[0] + h * st.v[1], st.v[2], k0, T2}, tid);
  QueryWalker walk{mb, st.mask[1], st.mask[2], T1, T2, kr0, tq,
                   mb == nullptr || st.mask[1] == 0};
  walk.init();
  uint32_t bits;
  int qt = walk.next(0, bits), half = 0;
  if (qt < T1) stage(qt);
  cp_async_commit();

  float dka[D / 2], dpa[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dpa[i] = dva[i] = 0.f;
  while (qt < T1) {
    cp_async_wait<0>();
    __syncthreads();  // the raw half has landed; the last products are done
    split_rows<D, 32>(tile(Q1H), tile(Q1L), RawTile<D>{tile(RQ1)}, tid);
    split_rows<D, 32>(tile(Q2H), tile(Q2L), RawTile<D>{tile(RQ2)}, tid);
    split_rows<D, 32>(tile(DOH), tile(DOL), RawTile<D>{tile(RDO)}, tid);
    split_cols<D, 32>(tile(Q1TH), tile(Q1TL), RawTile<D>{tile(RQ1)}, tid);
    split_cols<D, 32>(tile(Q2TH), tile(Q2TL), RawTile<D>{tile(RQ2)}, tid);
    split_cols<D, 32>(tile(DOTH), tile(DOTL), RawTile<D>{tile(RDO)}, tid);
    if (tid < 64) cols_s[tid / 32][tid % 32] = raw_cols[tid];
    fence_async_smem();
    __syncthreads();  // the split tiles are published, the raw ones free
    const int q0 = qt + 32 * half;  // this half's first query
    const uint32_t hbits = (bits >> (16 * half)) & 0xffffu;
    int hn = half;
    uint32_t bits_next = bits;
    const int qn = next_half(qt, hn, bits_next, T1, [&](uint32_t& bn) {
      return walk.next(qt + BQ, bn);
    });
    if (qn < T1) stage(qn + 32 * hn);
    cp_async_commit();

    const uint64_t d0 = desc(smem_u32(base));
    auto kmaj = [&](int i, int rows, int ks) {  // k-step ks of tile i
      return kstep(d0, i * HALF, rows, ks);
    };
    // S^T, dP^T: 64 keys x 32 query rows; S^T's two products and dP^T,
    // each in two fragments as K2's, summed in FFMA
    float s[16], s2[16], g[16], sb[16], s2b[16], gb[16];
    zero(s);
    zero(s2);
    zero(g);
    zero(sb);
    zero(s2b);
    zero(gb);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {  // the small terms first
      mma_tf32_ss(s, kmaj(KL, BK, ks), kmaj(Q1H, 32, ks));
      mma_tf32_ss(s, kmaj(KH, BK, ks), kmaj(Q1L, 32, ks));
      mma_tf32_ss(s2, kmaj(PL, BK, ks), kmaj(Q2H, 32, ks));
      mma_tf32_ss(s2, kmaj(PH, BK, ks), kmaj(Q2L, 32, ks));
      mma_tf32_ss(g, kmaj(VL, BK, ks), kmaj(DOH, 32, ks));
      mma_tf32_ss(g, kmaj(VH, BK, ks), kmaj(DOL, 32, ks));
    }
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      mma_tf32_ss(s, kmaj(KH, BK, ks), kmaj(Q1H, 32, ks));
      mma_tf32_ss(s2, kmaj(PH, BK, ks), kmaj(Q2H, 32, ks));
      mma_tf32_ss(g, kmaj(VH, BK, ks), kmaj(DOH, 32, ks));
    }
#pragma unroll
    for (int ks = D / 16; ks < D / 8; ++ks) {
      mma_tf32_ss(sb, kmaj(KH, BK, ks), kmaj(Q1H, 32, ks));
      mma_tf32_ss(s2b, kmaj(PH, BK, ks), kmaj(Q2H, 32, ks));
      mma_tf32_ss(gb, kmaj(VH, BK, ks), kmaj(DOH, 32, ks));
    }
    wgmma_commit();
    const uint32_t keep =
        DROPOUT ? keep_bits<16, true>(dp, bh, kr0, q0 + 2 * tq) : 0u;
    wgmma_wait_all();
    pin(s);
    pin(s2);
    pin(g);
    pin(sb);
    pin(s2b);
    pin(gb);
    add_frag(s, sb);
    add_frag(s2, s2b);
    add_frag(g, gb);
    add_frag(s, s2);

    dkpv_grad<DROPOUT>(s, g, hbits, cols_s[0], cols_s[1], keep, dp, tq,
                       scale);
    // (P D)^T . dO, dS^T . Q1 and dS^T . Q2 in turn, 32 of the D output
    // columns at a time, each into the zeroed fragment f that FFMA adds
    // to dV, dK, dP: one fragment of 16 values beside the three sums
    // keeps the registers K3 had (dS^T is split only after dV's product)
    float f[16];
    auto product = [&](float* acc, const uint32_t (&hi)[4][4],
                       const uint32_t (&lo)[4][4], int th, int tl) {
#pragma unroll
      for (int c = 0; c < D / 32; ++c) {  // the B tile's rows 32c ..
        zero(f);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          mma_tf32_rs(f, lo[ks], kmaj(th, D, ks) + 256 * c);
          mma_tf32_rs(f, hi[ks], kmaj(tl, D, ks) + 256 * c);
        }
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          mma_tf32_rs(f, hi[ks], kmaj(th, D, ks) + 256 * c);
        wgmma_commit();
        wgmma_wait_all();
        pin(f);
        add_frag(acc + 16 * c, f);
      }
    };
    {
      uint32_t ph[4][4], pl[4][4];
      frag_tf32(s, ph, pl);
      product(dva, ph, pl, DOTH, DOTL);
      pin(ph);
      pin(pl);
    }
    uint32_t dsh[4][4], dsl[4][4];
    frag_tf32(g, dsh, dsl);
    product(dka, dsh, dsl, Q1TH, Q1TL);
    product(dpa, dsh, dsl, Q2TH, Q2TL);
    pin(dsh);
    pin(dsl);
    qt = qn;
    half = hn;
    bits = bits_next;
  }
  cp_async_wait<0>();
  store_tile<D>(dka, dk + b * st.dk[0] + h * st.dk[1], st.dk[2], kr0, tq, T2);
  store_tile<D>(dpa, dpos + b * st.dp[0] + h * st.dp[1], st.dp[2], kr0, tq,
                T2);
  store_tile<D>(dva, dv + b * st.dv[0] + h * st.dv[1], st.dv[2], kr0, tq, T2);
}

// ---------------------------------------------------------------------------
// d = 128: FFMA on the CUDA cores (the first port's bodies)
// ---------------------------------------------------------------------------

namespace ffma {

using relpos::from_float;
using relpos::to_float;
constexpr int THREADS = relpos::THREADS;  // 16 x 16, each a 4 x 4 block
constexpr int QR3 = 32;                   // K3's query rows a tile

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * ((3 * BQ + 3 * BK) * (D + 1) + BQ * (BK + 1));
}

template <int D>
constexpr size_t dkpv_smem_bytes() {
  return sizeof(float) *
         ((3 * BK + 3 * QR3) * (D + 1) + 2 * BK * (QR3 + 1) + 2 * QR3);
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

// (query r, key t) may attend: inside T1 x T2 and not masked
__device__ __forceinline__ bool attend(const uint8_t* mb, const Strides& st,
                                       int r, int t, int T1, int T2) {
  return r < T1 && t < T2 &&
         (mb == nullptr || mb[r * st.mask[1] + t * st.mask[2]] != 0);
}

// the dropout multiplier of (query r, key t): 0 or the keep scale
__device__ __forceinline__ float mult(const DropoutParams& dp, int bh, int r,
                                      int t) {
  return dropout_hash(dp.seed, bh, r, t) >= dp.thr ? dp.scale : 0.f;
}

// K2: dq1, dq2.  Thread (ty, tx) owns query rows ty*4+i, score columns
// tx+16j and output columns tx+16c.
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
  constexpr int LD = D + 1, LDS = BK + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* sq1 = smem;
  float* sq2 = sq1 + BQ * LD;
  float* sdo = sq2 + BQ * LD;
  float* sk = sdo + BQ * LD;
  float* sp = sk + BK * LD;
  float* sv = sp + BK * LD;
  float* sds = sv + BK * LD;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, q0 = blockIdx.x * BQ;
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

    // q1 . k^T and q2 . p^T in chains of their own, added after (K1's
    // FFMA body has the reason)
    float s[4][4], s2[4][4], g[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = s2[i][j] = g[i][j] = 0.f;
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
          s[i][j] = fmaf(a1[i], bk[j], s[i][j]);
          s2[i][j] = fmaf(a2[i], bp[j], s2[i][j]);
          g[i][j] = fmaf(ad[i], bv[j], g[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] += s2[i][j];

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = k0 + tx + 16 * j;
        const float sc = attend(mb, st, r, t, T1, T2) ? s[i][j] * scale
                                                      : NEG_INF;
        const float pr =
            sc <= NEG_INF * 0.5f ? 0.f : expf(sc - row_lse[i]);
        float dpv = g[i][j];
        if constexpr (DROPOUT) dpv *= mult(dp, bh, r, t);
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

// K3: dk, dp, dv.  Thread (ty, tx) owns keys ty*4+i, score columns (the
// tile's query rows) tx+16j, j < 2, and output columns tx+16c.  Every
// query tile is walked, so every key's gradients are written.
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
  constexpr int LD = D + 1, LDS = QR3 + 1, DC = D / 16, NJ = QR3 / 16;
  extern __shared__ float smem[];
  float* sk = smem;
  float* sp = sk + BK * LD;
  float* sv = sp + BK * LD;
  float* sq1 = sv + BK * LD;
  float* sq2 = sq1 + QR3 * LD;
  float* sdo = sq2 + QR3 * LD;
  float* spv = sdo + QR3 * LD;   // (P . D)^T, keys x query rows
  float* sds = spv + BK * LDS;   // ds^T
  float* slse = sds + BK * LDS;
  float* sdelta = slse + QR3;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, k0 = blockIdx.x * BK;
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

  for (int q0 = 0; q0 < T1; q0 += QR3) {
    __syncthreads();  // the previous tiles are no longer read
    stage_rows<T, D>(sq1, q1b, st.q1[2], q0, T1, QR3);
    stage_rows<T, D>(sq2, q2b, st.q2[2], q0, T1, QR3);
    stage_rows<T, D>(sdo, dob, st.dout[2], q0, T1, QR3);
    if (threadIdx.x < QR3) {
      const int r = q0 + threadIdx.x;
      const long long o = static_cast<long long>(bh) * T1 + r;
      slse[threadIdx.x] = r < T1 ? lse[o] : 0.f;
      sdelta[threadIdx.x] = r < T1 ? delta[o] : 0.f;
    }
    __syncthreads();

    float s[4][NJ], s2[4][NJ], g[4][NJ];  // s2: q2 . p^T, as in K2
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = s2[i][j] = g[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float ak[4], ap[4], av[4], b1[NJ], b2[NJ], bd[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ak[i] = sk[(ty * 4 + i) * LD + c];
        ap[i] = sp[(ty * 4 + i) * LD + c];
        av[i] = sv[(ty * 4 + i) * LD + c];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        b1[j] = sq1[(tx + 16 * j) * LD + c];
        b2[j] = sq2[(tx + 16 * j) * LD + c];
        bd[j] = sdo[(tx + 16 * j) * LD + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          s[i][j] = fmaf(b1[j], ak[i], s[i][j]);
          s2[i][j] = fmaf(b2[j], ap[i], s2[i][j]);
          g[i][j] = fmaf(bd[j], av[i], g[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] += s2[i][j];

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = k0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int rr = tx + 16 * j, r = q0 + rr;
        const float sc = attend(mb, st, r, t, T1, T2) ? s[i][j] * scale
                                                      : NEG_INF;
        const float pr = sc <= NEG_INF * 0.5f ? 0.f : expf(sc - slse[rr]);
        float pv = pr, dpv = g[i][j];
        if constexpr (DROPOUT) {
          const float dm = mult(dp, bh, r, t);
          pv = pr * dm;
          dpv *= dm;
        }
        spv[(ty * 4 + i) * LDS + rr] = pv;
        sds[(ty * 4 + i) * LDS + rr] = pr * (dpv - sdelta[rr]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int rr = 0; rr < QR3; ++rr) {
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

}  // namespace ffma

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// One block per 64 rows of `rows` (K2: T1, K3: T2) and per (batch, head);
// `out`: the gradients the kernel writes.
template <typename T, typename Kernel, typename... Out>
int start(Kernel kernel, size_t smem, int threads, int rows, const Args& a,
          cudaStream_t stream, Out... out) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((rows + 63) / 64, a.B * a.H);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(a.q1), static_cast<const T*>(a.q2),
      static_cast<const T*>(a.k), static_cast<const T*>(a.p),
      static_cast<const T*>(a.v), static_cast<const uint8_t*>(a.mask),
      static_cast<const T*>(a.dout), a.lse, a.delta, out..., a.st, a.H,
      a.T1, a.T2, a.scale, a.dp);
  return static_cast<int>(cudaGetLastError());
}

// K2 (DQ) or K3 in T at head dim D, one instance per dropout setting:
// wgmma at d <= 64, the FFMA bodies at d = 128.
template <bool DQ, typename T, int D, bool DROPOUT>
int launch(const Args& a, cudaStream_t s) {
  T* g0 = static_cast<T*>(a.g0);  // K2: dq1, K3: dk
  if constexpr (D == 128) {
    if constexpr (DQ)
      return start<T>(ffma::relpos_bwd_dq_kernel<T, D, DROPOUT>,
                      ffma::dq_smem_bytes<D>(), ffma::THREADS, a.T1, a, s,
                      g0, static_cast<T*>(a.g1));
    else
      return start<T>(ffma::relpos_bwd_dkpv_kernel<T, D, DROPOUT>,
                      ffma::dkpv_smem_bytes<D>(), ffma::THREADS, a.T2, a, s,
                      g0, static_cast<float*>(a.g1), static_cast<T*>(a.g2));
  } else if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if constexpr (DQ)
      return start<T>(relpos_bwd_dq_bf16<D, DROPOUT>, BF16_SMEM, THREADS,
                      a.T1, a, s, g0, static_cast<T*>(a.g1));
    else
      return start<T>(relpos_bwd_dkpv_bf16<D, DROPOUT>, BF16_SMEM, THREADS,
                      a.T2, a, s, g0, static_cast<float*>(a.g1),
                      static_cast<T*>(a.g2));
  } else {
    if constexpr (DQ)
      return start<T>(relpos_bwd_dq_tf32<D, DROPOUT>, dq_tf32_smem<D>(),
                      THREADS, a.T1, a, s, g0, static_cast<T*>(a.g1));
    else
      return start<T>(relpos_bwd_dkpv_tf32<D, DROPOUT>, dkpv_tf32_smem<D>(),
                      THREADS, a.T2, a, s, g0, static_cast<float*>(a.g1),
                      static_cast<T*>(a.g2));
  }
}

template <bool DQ, typename T, int D>
int launch_one(bool dropout, const Args& a, cudaStream_t s) {
  return dropout ? launch<DQ, T, D, true>(a, s)
                 : launch<DQ, T, D, false>(a, s);
}

template <bool DQ, typename T>
int dispatch_d(int D, bool dropout, const Args& a, cudaStream_t s) {
  switch (D) {
    case 32:
      return launch_one<DQ, T, 32>(dropout, a, s);
    case 64:
      return launch_one<DQ, T, 64>(dropout, a, s);
    case 128:
      return launch_one<DQ, T, 128>(dropout, a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool DQ>
int dispatch(int dtype, int D, bool dropout, const Args& a, cudaStream_t s) {
  if (dtype == 0) return dispatch_d<DQ, float>(D, dropout, a, s);
  if (dtype == 1) return dispatch_d<DQ, __nv_bfloat16>(D, dropout, a, s);
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
// {32, 64, 128}.  dropout != 0 turns on the hash dropout with (seed, thr,
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
