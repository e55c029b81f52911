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
//     lo.hi is accumulated in fp32 by wgmma m64nNk8.  tf32 takes both
//     operands K-major, so V is stored transposed as it lands, with its
//     keys permuted within each group of 8 so that S's accumulator is
//     P's A fragment without shuffles.
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

#include "hopper_mma.cuh"

namespace {

using namespace hopper;

constexpr int BQ = 64;        // query rows per block: one wgmma M
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 128;  // one warpgroup
constexpr float NEG_INF = -1.0e30f;
constexpr float LOG2E = 1.4426950408889634f;

// Element strides: (batch, head, time) for q, k, v and out, whose feature
// dim is unit-stride; (batch, head, row, column) for the mask and bias.
struct Strides {
  long long q[3], k[3], v[3], out[3];
  long long mask[4], bias[4];
};

// The thread's share of the block's 64 x 64 score tile, in wgmma's
// accumulator layout: rows r0 and r0 + 8, columns 8 j + 2 tq and
// 8 j + 2 tq + 1 for j < 8; element 4 j + 2 (row) + (column & 1).  A
// tile's mask reaches the softmax as 32 bits, bit i for element i.

// Row masks: bit i is set where element i may attend, inside T1 x T2
// and not masked, read per thread.  Only elements with their bit set read
// the bias, so a row past T1 reads none of it.
__device__ __forceinline__ uint32_t tile_bits(const uint8_t* mb,
                                              long long ms_row,
                                              long long ms_col, int r0,
                                              int tq, int k0, int T1,
                                              int T2) {
  uint32_t bits = 0;
  const bool in0 = r0 < T1, in1 = r0 + 8 < T1;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = k0 + 8 * j + 2 * tq + e;
      if (c >= T2) continue;
      const uint8_t* mc = mb + c * ms_col;
      const bool a0 = in0 && mc[r0 * ms_row] != 0;
      const bool a1 = in1 && mc[(r0 + 8) * ms_row] != 0;
      bits |= (static_cast<uint32_t>(a0) << (4 * j + e)) |
              (static_cast<uint32_t>(a1) << (4 * j + 2 + e));
    }
  return bits;
}

// Walks a block's key tiles, skipping those the mask closes for every row
// of the block.  A mask whose rows are one (the pad mask, or no mask:
// `cols`) is read one byte per column by warps 0 and 1, a tile ahead of
// its use, and voted by ballot into a 64-bit column mask in shared
// memory, the same for every row; other masks are read per thread where
// they are used (tile_bits) and voted with a barrier.  Every thread takes
// part: each vote is a block barrier.
struct Walker {
  const uint8_t* mb;  // the mask of this (batch, head), or null
  long long ms_row, ms_col;
  int T1, T2, r0, tq, warp, lane;
  uint32_t* votes;  // shared: two 64-bit column masks, used in turn
  bool cols;
  int parity = 0;
  int cand = 0;      // the next tile to vote on
  uint32_t pf = 0;   // cols: this thread's byte of it (warps 0 and 1)

  __device__ void prefetch() {
    const int c = cand + 32 * warp + lane;
    pf = 0;
    if (warp < 2 && c < T2) pf = mb == nullptr ? 1u : mb[c * ms_col];
  }

  // The first live tile from `cand` on (>= T2 if none) and this thread's
  // bits of it; `cand` moves past it.
  __device__ int next(uint32_t& bits) {
    int k = cand;
    if (cols) {
      uint64_t cm;
      for (;;) {
        if (warp < 2) {
          const uint32_t w = __ballot_sync(0xffffffffu, pf != 0u);
          if (lane == 0) votes[2 * parity + warp] = w;
        }
        __syncthreads();
        cm = votes[2 * parity] |
             static_cast<uint64_t>(votes[2 * parity + 1]) << 32;
        parity ^= 1;
        if (cm != 0 || k >= T2) break;
        cand = k += BK;
        prefetch();
      }
      const uint64_t ct = cm >> (2 * tq);
      bits = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t b2 = static_cast<uint32_t>(ct >> (8 * j)) & 3u;
        bits |= (b2 | b2 << 2) << (4 * j);
      }
      // the column mask holds for every row: clear the rows past T1 (in
      // the last block), so that the bias is not read beyond its last row
      bits &= (r0 < T1 ? 0x33333333u : 0u) | (r0 + 8 < T1 ? 0xccccccccu : 0u);
      cand = k + BK;
      prefetch();  // in flight while this tile computes
      return k;
    }
    for (; k < T2; k += BK) {
      bits = tile_bits(mb, ms_row, ms_col, r0, tq, k, T1, T2);
      if (__syncthreads_or(bits != 0u)) break;
    }
    cand = k + BK;
    return k;
  }
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One online-softmax step on a tile's scores s (the product q . k^T in
// the accumulator layout above; on return, the probabilities): bias,
// scale and mask (-inf where closed), the running max m of the thread's
// two rows, its share of their sums l (summed over the quad at the end),
// and the rescale of the output accumulator o.  A probability is zero
// where s <= NEG_INF / 2: a row whose max is that low keeps none, and
// below a higher max exp2 underflows to 0.  bb: the bias of this
// (batch, head) or null; c0: the tile's first key plus 2 tq.
template <int NO>
__device__ __forceinline__ void online_softmax(
    float (&s)[32], float (&o)[NO], float (&m)[2], float (&l)[2],
    uint32_t bits, const float* bb, const Strides& st, int r0, int c0,
    float scale) {
  if (bb != nullptr) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if ((bits >> i) & 1u)
        s[i] += bb[(r0 + 8 * ((i >> 1) & 1)) * st.bias[2] +
                   (c0 + 8 * (i >> 2) + (i & 1)) * st.bias[3]];
  }
  float mx[2] = {-INFINITY, -INFINITY};
  if (bits == 0xffffffffu) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] *= scale;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = (bits >> i) & 1u ? s[i] * scale : -INFINITY;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
  }
  float corr[2], ml[2];
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    mx[row] = fmaxf(mx[row], __shfl_xor_sync(0xffffffffu, mx[row], 1));
    mx[row] = fmaxf(mx[row], __shfl_xor_sync(0xffffffffu, mx[row], 2));
    const float m_new = fmaxf(m[row], mx[row]);
    corr[row] = ex2((m[row] - m_new) * LOG2E);
    m[row] = m_new;
    ml[row] = m_new <= NEG_INF * 0.5f ? INFINITY : m_new * LOG2E;
    l[row] *= corr[row];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int row = (i >> 1) & 1;
    s[i] = ex2(fmaf(s[i], LOG2E, -ml[row]));
    l[row] += s[i];
  }
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] *= corr[(i >> 1) & 1];
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// out = o / l on the thread's two rows (the first D columns of o; l
// summed over the quad first), and with lse, lse = m + log l; zeros and
// NEG_INF on fully masked rows.
template <int D, typename T, int NO>
__device__ __forceinline__ void store_rows(const float (&o)[NO],
                                           const float (&m)[2], float (&l)[2],
                                           T* ob, long long so, float* lse,
                                           int r0, int tq, int T1) {
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    l[row] += __shfl_xor_sync(0xffffffffu, l[row], 1);
    l[row] += __shfl_xor_sync(0xffffffffu, l[row], 2);
  }
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const int r = r0 + 8 * row;
    if (r >= T1) continue;
    const float lr = l[row];
    T* orow = ob + r * so + 2 * tq;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float y0 = lr > 0.f ? o[4 * j + 2 * row] / lr : 0.f;
      const float y1 = lr > 0.f ? o[4 * j + 2 * row + 1] / lr : 0.f;
      store2(orow + 8 * j, y0, y1);
    }
    if (lse != nullptr && tq == 0)
      lse[r] = lr > 0.f ? m[row] + logf(lr) : NEG_INF;
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma on bf16 tiles, cp.async into two stages
// ---------------------------------------------------------------------------

// ROWS rows of D bf16 values (row stride ld elements, rows row0.. of a
// tensor with `limit` rows; rows past it are zero-filled) into a swizzled
// tile of 128-byte column blocks.  For D = 32 the second half of each row
// is left unwritten: K's product never reads it, and V's reaches only
// output columns past D, which are not stored.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(uint32_t tile,
                                          const __nv_bfloat16* src,
                                          long long ld, int row0, int limit,
                                          int tid) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int n = 0; n < ROWS * CPR / THREADS; ++n) {
    const int i = tid + n * THREADS, r = i / CPR, c = i % CPR;
    const bool ok = row0 + r < limit;
    cp_async16(tile + swz(ROWS, r, c),
               ok ? src + (row0 + r) * ld + 8 * c : src, ok ? 16 : 0);
  }
}

template <int D>
__host__ __device__ constexpr int bf16_width() {
  return D < 64 ? 64 : D;  // whole 128-byte blocks: wgmma N of P . V
}

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

    online_softmax(s, o, m, l, bits, bb, st, r0, kt + 2 * tq, scale);

    // P as wgmma's A fragments, k-step ks = keys 16 ks .. 16 ks + 15:
    // register x holds s[8 ks + 2 x], s[8 ks + 2 x + 1]
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float p0 = s[8 * ks + 2 * x], p1 = s[8 * ks + 2 * x + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        const float2 hf = __bfloat1622float2(hi);
        ph[ks][x] = pack_bf16(hi);
        pl[ks][x] = pack_bf16(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
      }
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

__device__ __forceinline__ float4 split_hi(float4 x) {
  return make_float4(tf32(x.x), tf32(x.y), tf32(x.z), tf32(x.w));
}
__device__ __forceinline__ float4 split_lo(float4 x, float4 hi) {
  return make_float4(tf32(x.x - hi.x), tf32(x.y - hi.y), tf32(x.z - hi.z),
                     tf32(x.w - hi.w));
}

// ROWS rows of D fp32 values into K-major swizzled hi and lo tiles (32
// values per column block); rows past `limit` are zeros.
template <int D, int ROWS>
__device__ __forceinline__ void split_rows(uint8_t* hi, uint8_t* lo,
                                           const float* src, long long ld,
                                           int row0, int limit, int tid) {
  constexpr int CPR = D / 4;  // float4 chunks per row
  constexpr int N = ROWS * CPR / THREADS;
  float4 x[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int i = tid + n * THREADS, r = i / CPR, c = i % CPR;
    x[n] = row0 + r < limit
               ? __ldg(reinterpret_cast<const float4*>(src + (row0 + r) * ld +
                                                       4 * c))
               : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int i = tid + n * THREADS, r = i / CPR, c = i % CPR;
    const uint32_t off = swz(ROWS, r, c);
    const float4 h = split_hi(x[n]);
    *reinterpret_cast<float4*>(hi + off) = h;
    *reinterpret_cast<float4*>(lo + off) = split_lo(x[n], h);
  }
}

// A BK x D tile of V into hi and lo tiles of V^T (D rows of BK keys,
// K-major, 32 keys per column block).  Key 8 g + 2 t + e goes to
// position 8 g + t + 4 e: the A fragment of tf32 wgmma holds columns t
// and t + 4 of each 8-key step where S's accumulator holds 2 t and
// 2 t + 1, so P . V sums the same pairs without moving P.  A warp's lanes
// take 32 consecutive keys of one feature chunk, so their stores fall in
// distinct banks.
template <int D>
__device__ __forceinline__ void split_cols(uint8_t* hi, uint8_t* lo,
                                           const float* src, long long ld,
                                           int k0, int limit, int tid) {
  constexpr int CPR = D / 4;
  constexpr int N = BK * CPR / THREADS;
  const int key = tid % BK;
  const int pos = (key & ~7) | ((key & 7) >> 1) | ((key & 1) << 2);
  const bool ok = k0 + key < limit;
  float4 x[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int c = tid / BK + (THREADS / BK) * n;
    x[n] = ok ? __ldg(reinterpret_cast<const float4*>(src + (k0 + key) * ld +
                                                      4 * c))
              : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int c = tid / BK + (THREADS / BK) * n;
    const float4 h = split_hi(x[n]), w = split_lo(x[n], h);
    const float hv[4] = {h.x, h.y, h.z, h.w}, lv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t off = swz(D, 4 * c + e, pos >> 2) + (pos & 3) * 4;
      *reinterpret_cast<float*>(hi + off) = hv[e];
      *reinterpret_cast<float*>(lo + off) = lv[e];
    }
  }
}

template <int D>
constexpr size_t tf32_smem() {
  return 1024 + 2 * 4 * D * (BQ + 2 * BK);  // hi and lo of Q, K, V^T
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

  split_rows<D, BQ>(qh, ql, q + b * st.q[0] + h * st.q[1], st.q[2], q0, T1,
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
    split_rows<D, BK>(kh, kl, kb, st.k[2], kt, T2, tid);
    split_cols<D>(vh, vl, vb, st.v[2], kt, T2, tid);
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

    online_softmax(s, o, m, l, bits, bb, st, r0, kt + 2 * tq, scale);

    // P's A fragments, k-step ks = keys 8 ks .. 8 ks + 7 in split_cols's
    // order: (row g, position t) = key 2 t, (row g + 8, t), (row g,
    // t + 4) = key 2 t + 1, (row g + 8, t + 4)
    uint32_t ph[8][4], pl[8][4];
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      const float x[4] = {s[4 * ks], s[4 * ks + 2], s[4 * ks + 1],
                          s[4 * ks + 3]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float hi = tf32(x[e]);
        ph[ks][e] = __float_as_uint(hi);
        pl[ks][e] = __float_as_uint(tf32(x[e] - hi));
      }
    }
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      mma_tf32_rs(o, pl[ks], desc_k(svh, D, ks));
      mma_tf32_rs(o, ph[ks], desc_k(svl, D, ks));
    }
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) mma_tf32_rs(o, ph[ks], desc_k(svh, D, ks));
    wgmma_commit();
    wgmma_wait_all();
    pin(o);
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
