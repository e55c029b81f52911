// Fused rel-pos attention forward for Hopper (sm_90a), plain C entry points.
//
// Replaces the Pallas TPU kernel `_relpos_fwd_kernel`
// (wenet_tpu/ops/flash_attention.py:548, called at :698), reached there
// through `flash_attention_relpos`, in both its variants: inference
// (`relpos_attention_fwd`) and training (`relpos_attention_fwd_train`,
// has_lse and dropout_rate).  For every (batch, head) it computes
//
//   s   = (q1 . k^T + q2 . p^T) * scale        q1 = q + pos_bias_u
//   s   = mask ? s : NEG_INF                    q2 = q + pos_bias_v
//   out = softmax(s) . v                        p  = projected pos_emb
//
// without writing the (T1, T2) scores or the rel-pos bias to device
// memory: one block, one warpgroup of 128 threads, owns BQ = 64 query rows
// of one (batch, head), walks the keys in BK = 64-wide tiles staged in
// shared memory, and keeps the running max m, normalizer l and output
// accumulator in fp32 registers (online softmax), in wgmma's accumulator
// layout (flash_tiles.cuh).  The training variant also writes lse =
// m + log l, a contiguous (B, H, T1) fp32 array for the backward kernels
// (relpos_attention_bwd.cu), and applies attention-weight dropout with
// the counter hash of dropout_hash.cuh to the weights that feed the
// v-accumulator only: l stays the full normalizer, as in the TPU kernel.
//
// Kernel contract, shared with the TPU kernel:
//   * NEG_INF is the finite sentinel -1e30, and a probability is zeroed
//     where s <= NEG_INF / 2, so l counts only attendable keys;
//   * a fully masked row writes zeros (and lse = NEG_INF);
//   * the products are exact or split to fp32 accuracy (below), softmax
//     and accumulation are fp32, and the output has the input type.
// Ragged T1 / T2 edges are zero-filled on load and masked, and T1 != T2
// is allowed.  q1, q2, k, p, v and out are read and written through
// (batch, head, time) strides with a unit-stride feature dim, so the
// attention module's (B, T, h, d) buffers are used in place; their bases
// and strides must be 16-byte aligned (the wrapper checks).  p may be
// shared by the whole batch (batch stride 0) and the mask may be one row
// for all queries (row stride 0); neither broadcast is materialized.
//
// What bounds it on an H100: 6 d FLOPs per attended (query, key) pair
// (two score products and P . V) against (2 T1 + 3 T2) d elements read,
// so the tensor cores, not the 3.35 TB/s memory: 989 TFLOP/s in bf16,
// and in fp32, which runs as three tf32 products, 495 / 3 TFLOP/s (67
// TFLOP/s on the CUDA cores).  The design is K4's (flash_attention.cu),
// with the rel-pos term folded into the score product:
//   * q1 . k^T + q2 . p^T = [q1 | q2] . [k | p]^T, so S is one
//     accumulator fed by the k-steps of both products.  Q1 and Q2 stay in
//     shared memory for the whole block; K, P and V stream through it.
//   * bf16: the score k-steps are wgmma m64n64k16 with both operands
//     K-major as stored; O += P . V takes P from registers (S's
//     accumulator is wgmma's A fragment) as hi = bf16(P) and lo =
//     bf16(P - hi), two products, and V as stored, MN-major, through the
//     transpose bit.  K, P and V arrive by cp.async in a ring of two
//     stages, the next tile's copies in flight while this one computes.
//   * fp32: 3xTF32.  Q1, Q2, K and P are split x = hi + lo, both rounded
//     to tf32, and hi.hi + hi.lo + lo.hi is accumulated in fp32: six tf32
//     products per pair of k-steps for S.  wgmma does not round its fp32
//     sums to nearest, so a sum left in its accumulator drifts from
//     float64 (chip_smoke 2b on an H100 read K1's output at 4.9x, its
//     lse at 3.3x the plain version's rms error): q1 . k^T and q2 . p^T
//     go into two fragments that FFMA adds, and each key tile's P . V
//     into a zeroed fragment that FFMA adds to O, as in K4.  V is stored
//     transposed and split, with its keys permuted within each group of 8
//     so that S's accumulator is P's A fragment (split_cols).  The
//     streamed K, P and V tiles arrive raw by cp.async a tile ahead and
//     are split from shared memory (208 KB at d = 64: one block per SM),
//     and the wgmma descriptors are derived after each product issues
//     (kstep), as in K5.
//   * dropout multiplies the probabilities on the accumulator fragment,
//     after l took their undropped sum and before P is split; each
//     element's (global row, global key) comes from the fragment layout.
//   * a key tile that the mask closes for every row of the block is
//     skipped (Walker): the pad mask closes the padded tail of short
//     utterances, a dynamic-chunk mask most key tiles of the early query
//     blocks.  A block with no open tile still writes its zeros and lse.
// d = 128: bf16 on wgmma as above (one block per SM, 129 KB), inference
// and training; fp32 keeps the first port's body, FFMA on 4x4 register
// tiles fed from padded fp32 shared memory (namespace ffma), since its
// split tiles would need 320 KB of shared memory.  Its training instances
// add lse and the hash dropout as the tensor-core kernels apply them: l
// sums the undropped weights, the dropout multiplies those that feed the
// v-accumulator.

#include <type_traits>

#include "flash_tiles.cuh"
#include "relpos_common.cuh"

namespace {

using namespace flash;

// Element strides of (batch, head, time) for each (B, H, T, D) operand;
// the feature dim is unit-stride.  The mask has (batch, row, column).
struct Strides {
  long long q1[3], q2[3], k[3], p[3], v[3], out[3];
  long long mask[3];
};

// ---------------------------------------------------------------------------
// bf16: wgmma on bf16 tiles, cp.async into two stages
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t bf16_smem() {  // Q1, Q2, 2 x (K, P, V)
  return 1024 + 2 * bf16_width<D>() * (2 * BQ + 6 * BK);
}

// Three blocks an SM where the output fits in 32 registers a thread (66 KB
// of shared memory each), one at d = 128.
template <int D, bool LSE, bool DROPOUT>
__global__ void __launch_bounds__(THREADS, D < 128 ? 3 : 1)
    relpos_fwd_bf16(const __nv_bfloat16* __restrict__ q1,
                    const __nv_bfloat16* __restrict__ q2,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ p,
                    const __nv_bfloat16* __restrict__ v,
                    const uint8_t* __restrict__ mask,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                    Strides st, int H, int T1, int T2, float scale,
                    DropoutParams dp) {
  constexpr int W = bf16_width<D>();
  constexpr int TILE = 64 * W * 2;  // 64 rows (BQ = BK) of W bf16 values
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq1 = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sq2 = sq1 + TILE;
  auto stage_k = [&](int stage) {  // K, then P, then V
    return sq1 + 2 * TILE + 3 * stage * TILE;
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
    load_rows<D, BK>(t + TILE, pb, st.p[2], kt, T2, tid);
    load_rows<D, BK>(t + 2 * TILE, vb, st.v[2], kt, T2, tid);
  };

  load_rows<D, BQ>(sq1, q1 + b * st.q1[0] + h * st.q1[1], st.q1[2], q0, T1,
                   tid);
  load_rows<D, BQ>(sq2, q2 + b * st.q2[0] + h * st.q2[1], st.q2[2], q0, T1,
                   tid);
  cp_async_commit();
  __shared__ uint32_t votes[4];
  Walker walk{mb, st.mask[1], st.mask[2], T1, T2, r0, tq, tid >> 5, tid & 31,
              votes, mb == nullptr || st.mask[1] == 0};
  if (walk.cols) walk.prefetch();
  uint32_t bits;
  int kt = walk.next(bits);
  if (kt < T2) load(0, kt);
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
    if (kn < T2) load(stage ^ 1, kn);
    cp_async_commit();
    cp_async_wait<1>();  // Q1, Q2 and this tile have landed
    fence_async_smem();
    __syncthreads();
    const uint32_t sk = stage_k(stage), sp = sk + TILE, sv = sp + TILE;

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      mma_bf16_ss(s, desc_k(sq1, BQ, ks), desc_k(sk, BK, ks));
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      mma_bf16_ss(s, desc_k(sq2, BQ, ks), desc_k(sp, BK, ks));
    wgmma_commit();
    wgmma_wait_all();
    pin(s);

    online_softmax(s, o, m, l, bits, scale);
    if constexpr (DROPOUT) drop(s, dp, bh, r0, kt + 2 * tq);
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
                LSE ? lse + static_cast<long long>(bh) * T1 : nullptr, r0,
                tq, T1);
}

// ---------------------------------------------------------------------------
// fp32: 3xTF32 wgmma
// ---------------------------------------------------------------------------

template <int D>  // Q1, Q2, K, P, V^T (hi, lo each); raw K, P, V
constexpr size_t tf32_smem() {
  return 1024 + 13 * TILE32<D>;
}

template <int D, bool LSE, bool DROPOUT>
__global__ void __launch_bounds__(THREADS)
    relpos_fwd_tf32(const float* __restrict__ q1, const float* __restrict__ q2,
                    const float* __restrict__ k, const float* __restrict__ p,
                    const float* __restrict__ v,
                    const uint8_t* __restrict__ mask, float* __restrict__ out,
                    float* __restrict__ lse, Strides st, int H, int T1,
                    int T2, float scale, DropoutParams dp) {
  constexpr int TILE = TILE32<D>;
  enum { Q1H, Q1L, Q2H, Q2L, KH, KL, PH, PL, VH, VL, RK, RP, RV };
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  auto tile = [&](int i) { return base + i * TILE; };

  const int tid = threadIdx.x, tq = tid & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, q0 = blockIdx.x * BQ;
  const int r0 = q0 + 16 * (tid >> 5) + ((tid & 31) >> 2);
  const float* kb = k + b * st.k[0] + h * st.k[1];
  const float* pb = p + b * st.p[0] + h * st.p[1];
  const float* vb = v + b * st.v[0] + h * st.v[1];
  const uint8_t* mb = mask == nullptr ? nullptr : mask + b * st.mask[0];
  auto stage = [&](int kt) {
    stage_raw<D>(smem_u32(tile(RK)), kb, st.k[2], kt, T2, tid);
    stage_raw<D>(smem_u32(tile(RP)), pb, st.p[2], kt, T2, tid);
    stage_raw<D>(smem_u32(tile(RV)), vb, st.v[2], kt, T2, tid);
  };

  split_rows<D, BQ>(
      tile(Q1H), tile(Q1L),
      GlobalRows{q1 + b * st.q1[0] + h * st.q1[1], st.q1[2], q0, T1}, tid);
  split_rows<D, BQ>(
      tile(Q2H), tile(Q2L),
      GlobalRows{q2 + b * st.q2[0] + h * st.q2[1], st.q2[2], q0, T1}, tid);
  __shared__ uint32_t votes[4];
  Walker walk{mb, st.mask[1], st.mask[2], T1, T2, r0, tq, tid >> 5, tid & 31,
              votes, mb == nullptr || st.mask[1] == 0};
  if (walk.cols) walk.prefetch();
  uint32_t bits;
  int kt = walk.next(bits);
  if (kt < T2) stage(kt);
  cp_async_commit();

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  while (kt < T2) {
    cp_async_wait<0>();
    __syncthreads();  // the raw tiles have landed; the last products are done
    split_rows<D, BK>(tile(KH), tile(KL), RawTile<D>{tile(RK)}, tid);
    split_rows<D, BK>(tile(PH), tile(PL), RawTile<D>{tile(RP)}, tid);
    split_cols<D>(tile(VH), tile(VL), RawTile<D>{tile(RV)}, tid);
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
    // q1 . k^T and q2 . p^T, each in two fragments (the hi . hi products
    // of the second half of the k-steps in their own), summed in FFMA:
    // wgmma truncates its fp32 sums, so the fewer products a fragment
    // sums, the less its scores drift, and a softmax turns a drift of the
    // scores into one of lse and of every P of the row
    float s[32], s2[32], sb[32], s2b[32];
    zero(s);
    zero(s2);
    zero(sb);
    zero(s2b);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {  // the small terms first
      mma_tf32_ss(s, kmaj(Q1L, BQ, ks), kmaj(KH, BK, ks));
      mma_tf32_ss(s, kmaj(Q1H, BQ, ks), kmaj(KL, BK, ks));
      mma_tf32_ss(s2, kmaj(Q2L, BQ, ks), kmaj(PH, BK, ks));
      mma_tf32_ss(s2, kmaj(Q2H, BQ, ks), kmaj(PL, BK, ks));
    }
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      mma_tf32_ss(s, kmaj(Q1H, BQ, ks), kmaj(KH, BK, ks));
      mma_tf32_ss(s2, kmaj(Q2H, BQ, ks), kmaj(PH, BK, ks));
    }
#pragma unroll
    for (int ks = D / 16; ks < D / 8; ++ks) {
      mma_tf32_ss(sb, kmaj(Q1H, BQ, ks), kmaj(KH, BK, ks));
      mma_tf32_ss(s2b, kmaj(Q2H, BQ, ks), kmaj(PH, BK, ks));
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(s);
    pin(s2);
    pin(sb);
    pin(s2b);
    add_frag(s, sb);
    add_frag(s2, s2b);
    add_frag(s, s2);

    online_softmax(s, o, m, l, bits, scale);
    if constexpr (DROPOUT) drop(s, dp, bh, r0, kt + 2 * tq);
    uint32_t ph[8][4], pl[8][4];  // P's A fragments in split_cols's order
    frag_tf32(s, ph, pl);
    float po[D / 2];  // the tile's P . V, added to O in FFMA
    zero(po);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      mma_tf32_rs(po, pl[ks], kmaj(VH, D, ks));
      mma_tf32_rs(po, ph[ks], kmaj(VL, D, ks));
    }
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) mma_tf32_rs(po, ph[ks], kmaj(VH, D, ks));
    wgmma_commit();
    wgmma_wait_all();
    pin(po);
    pin(ph);
    pin(pl);
    add_frag(o, po);
    kt = kn;
    bits = bits_next;
  }
  cp_async_wait<0>();
  store_rows<D>(o, m, l, out + b * st.out[0] + h * st.out[1], st.out[2],
                LSE ? lse + static_cast<long long>(bh) * T1 : nullptr, r0,
                tq, T1);
}

// ---------------------------------------------------------------------------
// fp32 at d = 128 (inference): FFMA on the CUDA cores
// ---------------------------------------------------------------------------

namespace ffma {

using relpos::BK;
using relpos::BQ;
using relpos::NEG_INF;
using relpos::THREADS;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((2 * BQ + 3 * BK) * (D + 1) + BQ * (BK + 1));
}

// Each of the 256 threads owns a 4x4 block of scores and a 4 x (D/16)
// block of the output, so every shared-memory read feeds 2 FMAs; rows are
// padded by one float so that the column walks hit 16 distinct banks.
// The signature is the tensor-core kernels'; LSE writes lse, DROPOUT
// applies dp.
template <int D, bool LSE, bool DROPOUT>
__global__ void __launch_bounds__(THREADS)
    relpos_fwd_kernel(const float* __restrict__ q1,
                      const float* __restrict__ q2,
                      const float* __restrict__ k,
                      const float* __restrict__ p,
                      const float* __restrict__ v,
                      const uint8_t* __restrict__ mask,
                      float* __restrict__ out, float* __restrict__ lse,
                      Strides st, int H, int T1, int T2, float scale,
                      DropoutParams dp) {
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
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BQ;

  const float* q1b = q1 + b * st.q1[0] + h * st.q1[1];
  const float* q2b = q2 + b * st.q2[0] + h * st.q2[1];
  const float* kb = k + b * st.k[0] + h * st.k[1];
  const float* pb = p + b * st.p[0] + h * st.p[1];
  const float* vb = v + b * st.v[0] + h * st.v[1];
  const uint8_t* mb = mask == nullptr ? nullptr : mask + b * st.mask[0];

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D, t = q0 + r;
    sq1[r * LD + c] = t < T1 ? q1b[t * st.q1[2] + c] : 0.f;
    sq2[r * LD + c] = t < T1 ? q2b[t * st.q2[2] + c] : 0.f;
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
      sk[r * LD + c] = t < T2 ? kb[t * st.k[2] + c] : 0.f;
      sp[r * LD + c] = t < T2 ? pb[t * st.p[2] + c] : 0.f;
      sv[r * LD + c] = t < T2 ? vb[t * st.v[2] + c] : 0.f;
    }
    __syncthreads();

    // q1 . k^T and q2 . p^T in chains of their own, added after, as the
    // plain version adds its two products: one chain of 2 d terms rounds
    // worse, and on a peaked softmax (q1, q2 scaled by 8) the scores'
    // error, through exp, put K3's dp past TRAIN_TOL from the plain
    // version (tests/test_torch_head_dim_128.py, the peaked case)
    float s[4][4], s2[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = s2[i][j] = 0.f;
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
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a1[i], bk[j], s[i][j]);
          s2[i][j] = fmaf(a2[i], bp[j], s2[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] += s2[i][j];

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
        row_sum += pr;  // l: the undropped weights
        float pv = pr;
        if constexpr (DROPOUT) {
          const uint32_t u = dropout_hash(dp.seed, bh, r, k0 + tx + 16 * j);
          pv = u >= dp.thr ? pr * dp.scale : 0.f;
        }
        ss[(ty * 4 + i) * LDS + tx + 16 * j] = pv;
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

  float* ob = out + b * st.out[0] + h * st.out[1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= T1) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      ob[r * st.out[2] + tx + 16 * c] = l[i] > 0.f ? acc[i][c] / l[i] : 0.f;
    if (LSE && tx == 0)  // m and l are the row's in all 16 threads
      lse[static_cast<long long>(bh) * T1 + r] =
          l[i] > 0.f ? m[i] + logf(l[i]) : NEG_INF;
  }
}

}  // namespace ffma

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q1, *q2, *k, *p, *v, *mask;
  void* out;
  float* lse;  // training only
  Strides st;
  int B, H, T1, T2;
  float scale;
  DropoutParams dp;
};

template <typename T, typename Kernel>
int launch_kernel(Kernel kernel, size_t smem, int threads, const Args& a,
                  cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.T1 + BQ - 1) / BQ, a.B * a.H);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(a.q1), static_cast<const T*>(a.q2),
      static_cast<const T*>(a.k), static_cast<const T*>(a.p),
      static_cast<const T*>(a.v), static_cast<const uint8_t*>(a.mask),
      static_cast<T*>(a.out), a.lse, a.st, a.H, a.T1, a.T2, a.scale, a.dp);
  return static_cast<int>(cudaGetLastError());
}

// The kernel for T at head dim D: wgmma on bf16 tiles, 3xTF32 wgmma for
// fp32 at d <= 64, the FFMA body for fp32 at d = 128.
template <typename T, int D, bool LSE, bool DROPOUT>
int launch(const Args& a, cudaStream_t s) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return launch_kernel<T>(relpos_fwd_bf16<D, LSE, DROPOUT>, bf16_smem<D>(),
                            THREADS, a, s);
  } else if constexpr (D == 128) {
    return launch_kernel<T>(ffma::relpos_fwd_kernel<D, LSE, DROPOUT>,
                            ffma::smem_bytes<D>(), ffma::THREADS, a, s);
  } else {
    return launch_kernel<T>(relpos_fwd_tf32<D, LSE, DROPOUT>, tf32_smem<D>(),
                            THREADS, a, s);
  }
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

// the training kernel (lse, optional dropout) for d in {32, 64, 128}
template <typename T>
int launch_train(int D, bool dropout, const Args& a, cudaStream_t stream) {
  switch (D) {
    case 32:
      return dropout ? launch<T, 32, true, true>(a, stream)
                     : launch<T, 32, true, false>(a, stream);
    case 64:
      return dropout ? launch<T, 64, true, true>(a, stream)
                     : launch<T, 64, true, false>(a, stream);
    case 128:
      return dropout ? launch<T, 128, true, true>(a, stream)
                     : launch<T, 128, true, false>(a, stream);
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
