// Tiles, the mask walk and the operand loaders shared by the masked
// flash attention kernels: K4 (flash_attention.cu) and K5, K6
// (flash_attention_bwd.cu).  One block is one warpgroup of 128 threads
// that owns 64 rows; tiles are 64 wide and use hopper_mma.cuh's 128-byte
// swizzled layout.
//
// The accumulator layout of a 64 x 64 product (wgmma's, fp32): the thread
// holds rows r0 and r0 + 8 (r0 = 16 warp + lane / 4) and columns
// 8 j + 2 tq and 8 j + 2 tq + 1 for j < 8 (tq = lane % 4); element
// 4 j + 2 (row) + (column & 1).  A tile's mask reaches a thread as 32
// bits, bit i for element i.
#pragma once

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

// Rows row0.. of a tensor with `limit` rows (zeros past it) into a raw
// tile, by cp.async.
template <int D>
__device__ __forceinline__ void stage_raw(uint32_t raw, const float* src,
                                          long long ld, int row0, int limit,
                                          int tid) {
  constexpr int CPR = D / 4;
#pragma unroll
  for (int n = 0; n < 64 * CPR / THREADS; ++n) {
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

// 64 rows of D fp32 values into hi and lo tiles of their transpose (D
// rows of 64 values, K-major, 32 values per column block).  Row
// 8 g + 2 t + e goes to position 8 g + t + 4 e: the A fragment of tf32
// wgmma holds columns t and t + 4 of each 8-wide k-step where a product's
// accumulator holds 2 t and 2 t + 1, so an accumulator used as A meets
// this operand in the same order without moving.  A warp's lanes take 32
// consecutive rows of one feature chunk, so their stores fall in distinct
// banks.
template <int D, typename Src>
__device__ __forceinline__ void split_cols(uint8_t* hi, uint8_t* lo,
                                           const Src& src, int tid) {
  constexpr int CPR = D / 4;
  constexpr int N = BK * CPR / THREADS;
  const int key = tid % BK;
  const int pos = (key & ~7) | ((key & 7) >> 1) | ((key & 1) << 2);
  float4 x[N];
#pragma unroll
  for (int n = 0; n < N; ++n) x[n] = src(key, tid / BK + (THREADS / BK) * n);
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

}  // namespace flash
