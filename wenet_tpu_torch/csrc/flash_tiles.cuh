// Tiles, the mask walks, the operand loaders, the softmax step and the
// gradient on the fragment shared by the tensor-core attention kernels:
// K1 (relpos_attention.cu), K2, K3 (relpos_attention_bwd.cu), K4
// (flash_attention.cu) and K5, K6 (flash_attention_bwd.cu).  One block is
// one warpgroup of 128 threads that owns 64 rows; tiles are 64 wide (the
// fp32 rel-pos backward streams 32-wide halves of them) and use
// hopper_mma.cuh's 128-byte swizzled layout.
//
// The accumulator layout of a 64 x N product (wgmma's, fp32): the thread
// holds rows r0 and r0 + 8 (r0 = 16 warp + lane / 4) and columns
// 8 j + 2 tq and 8 j + 2 tq + 1 for j < N / 8 (tq = lane % 4); element
// 4 j + 2 (row) + (column & 1).  A 64-wide tile's mask reaches a thread as
// 32 bits, bit i for element i; bits 16 h .. 16 h + 15 are those of its
// 32-wide half h.
#pragma once

#include "dropout_hash.cuh"
#include "hopper_mma.cuh"

namespace flash {

using namespace hopper;

constexpr int BQ = 64;        // query rows per block: one wgmma M
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 128;  // one warpgroup
constexpr float NEG_INF = -1.0e30f;
constexpr float LOG2E = 1.4426950408889634f;

// Row masks: bit i is set where element i may attend, inside T1 x T2
// and not masked, read per thread.  Only elements with their bit set read
// the bias, so a row past T1 reads none of it.  The 32 mask bytes are
// loaded unconditionally, from rows and columns clamped into T1 x T2, and
// what lies outside is cleared after: a load behind a bounds branch
// waits for the one before it, and 32 such loads in a row held K1 at
// (16,4,375,375,64) with a chunk mask at 1.6 times its time with the pad
// mask (fp32 on an H100; chip_smoke 3), where it now takes the same.
__device__ __forceinline__ uint32_t tile_bits(const uint8_t* mb,
                                              long long ms_row,
                                              long long ms_col, int r0,
                                              int tq, int k0, int T1,
                                              int T2) {
  uint32_t bits = 0;
  const uint32_t in0 = r0 < T1, in1 = r0 + 8 < T1;
  const uint8_t* m0 = mb + min(r0, T1 - 1) * ms_row;
  const uint8_t* m1 = mb + min(r0 + 8, T1 - 1) * ms_row;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = k0 + 8 * j + 2 * tq + e;
      const long long cc = min(c, T2 - 1) * ms_col;
      const uint32_t ok = c < T2;
      const uint32_t a0 = ok & in0 & (m0[cc] != 0);
      const uint32_t a1 = ok & in1 & (m1[cc] != 0);
      bits |= (a0 << (4 * j + e)) | (a1 << (4 * j + 2 + e));
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

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ---------------------------------------------------------------------------
// bf16 tiles: cp.async
// ---------------------------------------------------------------------------

// ROWS rows of D bf16 values (row stride ld elements, rows row0.. of a
// tensor with `limit` rows; rows past it are zero-filled) into a swizzled
// tile of 128-byte column blocks.  For D = 32 the second half of each row
// is left unwritten: a K-major product never reads it, and an MN-major
// one reaches only output columns past D, which are not stored.
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

// ---------------------------------------------------------------------------
// fp32 tiles for 3xTF32: split x = hi + lo, both rounded to tf32
// ---------------------------------------------------------------------------

__device__ __forceinline__ float4 split_hi(float4 x) {
  return make_float4(tf32(x.x), tf32(x.y), tf32(x.z), tf32(x.w));
}
__device__ __forceinline__ float4 split_lo(float4 x, float4 hi) {
  return make_float4(tf32(x.x - hi.x), tf32(x.y - hi.y), tf32(x.z - hi.z),
                     tf32(x.w - hi.w));
}

// Where the fp32 splitters read: element (row r, float4 chunk c) of the
// rows they split, zeros past the last row.
struct GlobalRows {  // rows row0.. of a tensor with `limit` rows
  const float* src;
  long long ld;
  int row0, limit;
  __device__ __forceinline__ float4 operator()(int r, int c) const {
    return row0 + r < limit
               ? __ldg(reinterpret_cast<const float4*>(src + (row0 + r) * ld +
                                                       4 * c))
               : make_float4(0.f, 0.f, 0.f, 0.f);
  }
};

// A raw fp32 tile in shared memory, 64 rows of D values as stage_raw
// leaves them: chunk c of row r at chunk c ^ (r % 8) of the row, so that
// both splitters read it without bank conflicts.
template <int D>
struct RawTile {
  const uint8_t* p;
  __device__ __forceinline__ float4 operator()(int r, int c) const {
    return *reinterpret_cast<const float4*>(p + r * D * 4 +
                                            ((c ^ (r & 7)) << 4));
  }
};

// ROWS rows row0.. of a tensor with `limit` rows (zeros past it) into a
// raw tile, by cp.async.
template <int D, int ROWS = 64>
__device__ __forceinline__ void stage_raw(uint32_t raw, const float* src,
                                          long long ld, int row0, int limit,
                                          int tid) {
  constexpr int CPR = D / 4;
#pragma unroll
  for (int n = 0; n < ROWS * CPR / THREADS; ++n) {
    const int i = tid + n * THREADS, r = i / CPR, c = i % CPR;
    const bool ok = row0 + r < limit;
    cp_async16(raw + r * D * 4 + ((c ^ (r & 7)) << 4),
               ok ? src + (row0 + r) * ld + 4 * c : src, ok ? 16 : 0);
  }
}

// ROWS rows of D fp32 values into K-major swizzled hi and lo tiles (32
// values per column block).
template <int D, int ROWS, typename Src>
__device__ __forceinline__ void split_rows(uint8_t* hi, uint8_t* lo,
                                           const Src& src, int tid) {
  constexpr int CPR = D / 4;  // float4 chunks per row
  constexpr int N = ROWS * CPR / THREADS;
  float4 x[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int i = tid + n * THREADS;
    x[n] = src(i / CPR, i % CPR);
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

// ROWS (64 or 32) rows of D fp32 values into hi and lo tiles of their
// transpose (D rows of ROWS values, K-major, 32 values per column block).
// Row 8 g + 2 t + e goes to position 8 g + t + 4 e: the A fragment of
// tf32 wgmma holds columns t and t + 4 of each 8-wide k-step where a
// product's accumulator holds 2 t and 2 t + 1, so an accumulator used as
// A meets this operand in the same order without moving.  A warp's lanes
// take 32 consecutive rows of one feature chunk, so their stores fall in
// distinct banks.
template <int D, int ROWS = BK, typename Src>
__device__ __forceinline__ void split_cols(uint8_t* hi, uint8_t* lo,
                                           const Src& src, int tid) {
  constexpr int CPR = D / 4;
  constexpr int N = ROWS * CPR / THREADS;
  const int key = tid % ROWS;
  const int pos = (key & ~7) | ((key & 7) >> 1) | ((key & 1) << 2);
  float4 x[N];
#pragma unroll
  for (int n = 0; n < N; ++n)
    x[n] = src(key, tid / ROWS + (THREADS / ROWS) * n);
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int c = tid / ROWS + (THREADS / ROWS) * n;
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

// The descriptor of k-step ks of a K-major tile of `rows` rows at byte
// offset `off` from the tile whose descriptor is `base`: an add to the
// address field (which holds the shared address / 16, far from carrying
// over).  `base` passes through an empty asm first, which orders the add
// after the products issued before it: otherwise the compiler computes
// every descriptor of the tile loop up front, and they hold some hundred
// registers (they starved the fp32 kernels).
__device__ __forceinline__ uint64_t kstep(uint64_t base, int off, int rows,
                                          int ks) {
  asm volatile("" : "+l"(base));
  return base + static_cast<uint64_t>(
                    (off + (ks >> 2) * rows * 128 + (ks & 3) * 32) >> 4);
}

// fp32 shared memory: a 64 x D tile, one split half of an operand or a
// raw staged one.
template <int D>
constexpr int TILE32 = 64 * D * 4;

// bf16 shared memory: a 64-row tile of 64 bf16 values (D = 32: half used).
constexpr int TILE16 = 64 * 128;

// ---------------------------------------------------------------------------
// the accumulator fragment: A fragments, the softmax step, the epilogue
// ---------------------------------------------------------------------------

// bf16 A fragments of a 64 x 2N accumulator tile (N = 32: 64 columns,
// N = 16: 32), each element split into hi = bf16(x) and lo = bf16(x -
// hi), so that hi . B + lo . B keeps 16 bits of x: k-step ks = columns
// 16 ks .. 16 ks + 15, register i holds elements 8 ks + 2 i and
// 8 ks + 2 i + 1.
template <int N>
__device__ __forceinline__ void frag_bf16_split(const float (&x)[N],
                                                uint32_t (&hi)[N / 8][4],
                                                uint32_t (&lo)[N / 8][4]) {
#pragma unroll
  for (int ks = 0; ks < N / 8; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x0 = x[8 * ks + 2 * i], x1 = x[8 * ks + 2 * i + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
      const float2 hf = __bfloat1622float2(h);
      hi[ks][i] = pack_bf16(h);
      lo[ks][i] = pack_bf16(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
    }
}

// bf16 A fragments of a 64 x 2N accumulator tile, each element rounded
// once: k-step ks = columns 16 ks .. 16 ks + 15, register i holds
// elements 8 ks + 2 i and 8 ks + 2 i + 1.
template <int N>
__device__ __forceinline__ void frag_bf16(const float (&x)[N],
                                          uint32_t (&f)[N / 8][4]) {
#pragma unroll
  for (int ks = 0; ks < N / 8; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[ks][i] = pack_bf16(
          __floats2bfloat162_rn(x[8 * ks + 2 * i], x[8 * ks + 2 * i + 1]));
}

// tf32 hi and lo A fragments of a 64 x 2N accumulator tile: k-step ks =
// columns 8 ks .. 8 ks + 7 in split_cols's order: (row g, position t) =
// column 2 t, (row g + 8, t), (row g, t + 4) = column 2 t + 1,
// (row g + 8, t + 4).
template <int N>
__device__ __forceinline__ void frag_tf32(const float (&x)[N],
                                          uint32_t (&hi)[N / 4][4],
                                          uint32_t (&lo)[N / 4][4]) {
#pragma unroll
  for (int ks = 0; ks < N / 4; ++ks) {
    const float y[4] = {x[4 * ks], x[4 * ks + 2], x[4 * ks + 1],
                        x[4 * ks + 3]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float h = tf32(y[e]);
      hi[ks][e] = __float_as_uint(h);
      lo[ks][e] = __float_as_uint(tf32(y[e] - h));
    }
  }
}

// A sum kept in wgmma's fp32 accumulator over a whole tile loop drifts:
// wgmma does not round its sums to nearest.  So each tile's product goes
// into a fragment that starts at zero (`zero`), and FFMA adds it to the
// running sum (`add_frag`), which rounds to nearest.
template <int N>
__device__ __forceinline__ void zero(float (&f)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) f[i] = 0.f;
}
template <int N>
__device__ __forceinline__ void add_frag(float* acc, const float (&f)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] += f[i];
}

// One online-softmax step on a tile's scores s (a product in the
// accumulator layout above, any bias added; on return, the
// probabilities): scale and mask (-inf where closed), the running max m
// of the thread's two rows, its share of their sums l (summed over the
// quad at the end), and the rescale of the output accumulator o.  A
// probability is zero where s <= NEG_INF / 2: a row whose max is that
// low keeps none, and below a higher max exp2 underflows to 0.
template <int NO>
__device__ __forceinline__ void online_softmax(float (&s)[32],
                                               float (&o)[NO], float (&m)[2],
                                               float (&l)[2], uint32_t bits,
                                               float scale) {
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

// The first D columns of an accumulator tile (rows r0, r0 + 8 of a
// tensor with `limit` rows, row stride ld) in T.
template <int D, typename T, int N>
__device__ __forceinline__ void store_tile(const float (&acc)[N], T* base,
                                           long long ld, int r0, int tq,
                                           int limit) {
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const int r = r0 + 8 * row;
    if (r >= limit) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(base + r * ld + 8 * j + 2 * tq, acc[4 * j + 2 * row],
             acc[4 * j + 2 * row + 1]);
  }
}

// The dropout's keep bits of an accumulator fragment of N elements: bit i
// is set where element i, at fragment row r0 + 8 ((i >> 1) & 1) and
// column c0 + 8 (i >> 2) + (i & 1) (c0 = the tile's first column + 2 tq),
// is kept.  The rows are queries and the columns keys, or with KEY_ROWS
// the other way round (K3's transposed tiles); bh = b * H + h, as the TPU
// kernel's.  One register holds the mask, so it can be drawn while the
// tile's products run.
template <int N, bool KEY_ROWS = false>
__device__ __forceinline__ uint32_t keep_bits(const DropoutParams& dp, int bh,
                                              int r0, int c0) {
  uint32_t keep = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint32_t r = r0 + 8 * ((i >> 1) & 1);
    const uint32_t c = c0 + 8 * (i >> 2) + (i & 1);
    const uint32_t u = KEY_ROWS ? dropout_hash(dp.seed, bh, c, r)
                                : dropout_hash(dp.seed, bh, r, c);
    keep |= static_cast<uint32_t>(u >= dp.thr) << i;
  }
  return keep;
}

// x times element i's dropout multiplier: 0 or the keep scale.
__device__ __forceinline__ float dropped(float x, uint32_t keep, int i,
                                         const DropoutParams& dp) {
  return (keep >> i) & 1u ? x * dp.scale : 0.f;
}

// The dropout mask on a fragment whose rows are queries (keep_bits).
template <int N>
__device__ __forceinline__ void drop(float (&s)[N], const DropoutParams& dp,
                                     int bh, int r0, int c0) {
  const uint32_t keep = keep_bits<N>(dp, bh, r0, c0);
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = dropped(s[i], keep, i, dp);
}

// ---------------------------------------------------------------------------
// the backward kernels: the gradient of a tile on the fragment
// ---------------------------------------------------------------------------

// One element: s (the score product, any bias added) -> P = 2^(s scale
// log2 e - lse log2 e), 0 where closed; dp (do . v, any dropout applied)
// -> dS = P (dp - delta) scale.
__device__ __forceinline__ void grad(float& s, float& dp, bool open,
                                     float lse2, float delta, float sl2,
                                     float scale) {
  const float p = open ? ex2(fmaf(s, sl2, -lse2)) : 0.f;
  s = p;
  dp = p * (dp - delta) * scale;
}

// lse (times log2 e) and delta of the thread's two query rows.
struct Rows {
  float lse2[2], delta[2];
  __device__ Rows(const float* lse, const float* delta_, int r0, int T1) {
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      const int r = r0 + 8 * row;
      lse2[row] = r < T1 ? lse[r] * LOG2E : 0.f;
      delta[row] = r < T1 ? delta_[r] : 0.f;
    }
  }
};

// Walks the query tiles of a block of keys (rows kr0, kr0 + 8 of the
// thread), skipping those the mask closes for every (query, key) pair of
// the block.  A mask whose rows are one (`cols`: the pad mask, or none)
// gives each thread the bits of its two keys once (kbits), cut per tile
// to the queries inside T1; it closes every tile of a block or none.
// Other masks are read per element, transposed.  Each vote is a block
// barrier.
struct QueryWalker {
  const uint8_t* mb;
  long long ms_row, ms_col;
  int T1, T2, kr0, tq;
  bool cols;
  uint32_t kbits = 0;

  __device__ void init() {
    if (!cols) return;
    const bool o0 = kr0 < T2 && (mb == nullptr || mb[kr0 * ms_col] != 0);
    const bool o1 =
        kr0 + 8 < T2 && (mb == nullptr || mb[(kr0 + 8) * ms_col] != 0);
    kbits = (o0 ? 0x33333333u : 0u) | (o1 ? 0xccccccccu : 0u);
  }

  __device__ uint32_t bits_at(int q) const {
    if (!cols) return tile_bits(mb, ms_col, ms_row, kr0, tq, q, T2, T1);
    const int n = T1 - q;  // query columns inside T1
    if (n >= BQ) return kbits;
    uint32_t in = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (8 * j + 2 * tq + e < n) in |= 5u << (4 * j + e);
    return kbits & in;
  }

  // The first live tile from q on (T1 if none) and this thread's bits.
  __device__ int next(int q, uint32_t& bits) const {
    for (; q < T1; q += BQ) {
      bits = bits_at(q);
      if (__syncthreads_or(cols ? kbits != 0u : bits != 0u)) return q;
      if (cols) break;
    }
    return T1;
  }
};

// The next half of a walk over 64-wide tiles in 32-wide halves: the
// second half of this tile (at t, half 0) when it lies inside `limit`,
// else the first of the next live tile, found by `walk_next` (a block
// barrier).  Returns its tile and sets its half and bits.
template <typename Next>
__device__ __forceinline__ int next_half(int t, int& half, uint32_t& bits,
                                         int limit, Next walk_next) {
  if (half == 0 && t + 32 < limit) {
    half = 1;
    return t;
  }
  half = 0;
  return walk_next(bits);
}

// The width of a bf16 tile of D values a row: whole 128-byte blocks, the
// N of the P . V product.
template <int D>
__host__ __device__ constexpr int bf16_width() {
  return D < 64 ? 64 : D;
}

}  // namespace flash
