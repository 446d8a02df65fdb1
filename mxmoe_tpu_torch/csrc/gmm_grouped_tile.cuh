// Device code shared by the grouped-scale int8 grouped GEMMs over
// expert-sorted rows: K8 gmm_w8a8_grouped (gmm_w8a8_grouped.cu), the flex
// form K4f of gmm_mixed_packed (gmm_mixed_packed.cu) and the w x a experts of
// K10 gmm_mixed_wo_wxa (gmm_mixed_wo_wxa.cu). One device function computes a
// block's 32 x 128 output tile of one expert.
//
// Scales come per k-group of gsize codes: lhs_scale [M, G], rhs_scale and
// rhs_zp [E, G, N], G = K / gsize. For every row r of expert e, groups in
// ascending order, all in f32 with each product and sum rounded on its own:
//
//   acc   = 0
//   acc  += ((float)(sum_{k in g} a[r,k] * q[e,k,n]) * s_a[r,g]) * s_b[e,g,n]
//   acc  += ((float)(sum_{k in g} a[r,k]) * s_a[r,g]) * zp[e,g,n]   (with zp)
//   out[r, n] = OutT(acc)
//
// The per-group sums are exact int32 and the f32 steps are the plain torch
// version's steps in its order (__fmul_rn / __fadd_rn keep the compiler from
// contracting them into FMAs), so kernel and plain version agree bitwise,
// and so do the callers among themselves on the same codes. With G = 1 this
// is a per-channel product, `(acc * s_a) * s_b` added to zero.
//
// The walk over K is in logical k order, 64 codes a tile, whatever the
// storage. An int8-stored expert is a [K, N] block (in the ragged buffer of
// gmm_mixed_packed its two K/2-row units are adjacent, so it is one too). A
// nibble-packed expert (halves layout: byte row r holds code k = r in the low
// nibble and k = r + K/2 in the high nibble) gives code row k from byte row
// k, low nibble, for k < K/2 and from byte row k - K/2, high nibble, above.
// The mapping is made per 4-row unit, so a scale group may span the two
// halves (K/2 = 704 with gsize 128 puts k = 640..767 in group 5: 64 low
// nibbles' rows, then 64 high nibbles' rows) and nothing else changes.
//
// Tiles: the shared A / B layouts and the MMA step of gmm_int8_tile.cuh with
// a 32-row block tile (16 x 64 per warp): a thread carries 32 int32 group
// accumulators beside 32 f32 ones and nothing spills, and the routed rows of
// one expert (about one at decode, about 17 in a 256-token chunk) seldom fill
// more. Every gsize / 64 k-tiles the int32 accumulators are folded into the
// f32 ones and cleared; the row sums of the zp term come from the A fragments
// in registers (dp4a), summed over the quad at each fold.

#pragma once

#include "gmm_int8_tile.cuh"

namespace {

constexpr int GBM = 32;                     // rows of the block tile
constexpr int GA_TILE = GBM * A_STRIDE;     // bytes

// One block's tile of expert rows [row_lo, row_hi) starting at row m0,
// columns from n0. w: the expert's storage block ([K, N] int8, or [K/2, N]
// nibble-packed bytes when `packed`, which only kMayPack callers may set);
// sb / zb: the expert's [G, N] scales and zero points (zb read only with kZp).
// As: GA_TILE bytes, Bs: B_TILE words of shared memory, 16-byte aligned.
template <typename OutT, bool kZp, bool kMayPack>
__device__ __forceinline__ void grouped_tile_body(
    const int8_t* __restrict__ lhs, const float* __restrict__ s_a,
    const int8_t* __restrict__ w, bool packed, const float* __restrict__ sb_e,
    const float* __restrict__ zb_e, OutT* __restrict__ out, int K, int N,
    int gsize, int m0, int row_lo, int row_hi, int n0, int8_t* As, uint32_t* Bs) {
  const int tid = threadIdx.x;
  const int G = K / gsize, K2 = K / 2;

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 1) * 16, wn = (warp & 1) * 64;
  const int gr = lane >> 2, tq = lane & 3;

  int acc[1][8][4];
  int rsum[1][2] = {{0, 0}};
  float accf[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc[0][j][c] = 0;
      accf[j][c] = 0.0f;
    }

  // this thread's two output rows and whether they belong to the expert
  const int row0 = m0 + wm + gr, row1 = row0 + 8;
  const bool live0 = row0 >= row_lo && row0 < row_hi;
  const bool live1 = row1 >= row_lo && row1 < row_hi;

  // global -> registers for one k-tile (started a tile ahead of its use)
  int4 ra;
  uint32_t rb[4][4];
  auto load_tile = [&](int k0) {
    // A: 32 rows x 64 bytes, one 16-byte chunk a thread; other experts' rows 0
    {
      const int row = m0 + (tid >> 2), k = k0 + (tid & 3) * 16;
      ra = make_int4(0, 0, 0, 0);
      if (row >= row_lo && row < row_hi && k < K)
        ra = *reinterpret_cast<const int4*>(lhs + (size_t)row * K + k);
    }
    // B: 4(k) x 4(n) byte units; a packed expert's code row k lies in byte
    // row k (k < K/2) or k - K/2
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = tid + i * kThreads;
      const int k = k0 + (u >> 5) * 4, n = n0 + (u & 31) * 4;
      int r = k;
      if constexpr (kMayPack) {
        if (packed && k >= K2) r = k - K2;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        rb[i][j] = (n < N && k + j < K)
            ? *reinterpret_cast<const uint32_t*>(w + (size_t)(r + j) * N + n)
            : 0u;
    }
  };
  // registers -> shared (k0: the tile that load_tile fetched)
  auto store_tile = [&](int k0) {
    *reinterpret_cast<int4*>(As + (tid >> 2) * A_STRIDE + (tid & 3) * 16) = ra;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = tid + i * kThreads;
      if constexpr (kMayPack) {
        if (packed) {
          // the unit's four rows lie on one side of K/2 (K/2 % 4 == 0)
          const int shift = (k0 + (u >> 5) * 4 >= K2) ? 4 : 0;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            rb[i][j] = sext4((rb[i][j] >> shift) & 0x0F0F0F0Fu);
        }
      }
      store_b_unit(Bs + ((u & 31) * 4) * B_STRIDE + (u >> 5), rb[i]);
    }
  };
  // fold group g's int32 sums into the f32 accumulators, then clear them
  auto fold = [&](int g) {
    float rs0 = 0.0f, rs1 = 0.0f;
    const float sa0 = live0 ? s_a[(size_t)row0 * G + g] : 0.0f;
    const float sa1 = live1 ? s_a[(size_t)row1 * G + g] : 0.0f;
    if constexpr (kZp) {
      rs0 = __fmul_rn((float)quad_sum(rsum[0][0]), sa0);
      rs1 = __fmul_rn((float)quad_sum(rsum[0][1]), sa1);
      rsum[0][0] = rsum[0][1] = 0;
    }
    const size_t srow = (size_t)g * N;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + wn + j * 8 + tq * 2;
      float2 sb = make_float2(0.0f, 0.0f), zb = make_float2(0.0f, 0.0f);
      if (col < N) {
        sb = *reinterpret_cast<const float2*>(sb_e + srow + col);
        if constexpr (kZp) zb = *reinterpret_cast<const float2*>(zb_e + srow + col);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float sa = h ? sa1 : sa0;
        float x = accf[j][2 * h], y = accf[j][2 * h + 1];
        x = __fadd_rn(x, __fmul_rn(__fmul_rn((float)acc[0][j][2 * h], sa), sb.x));
        y = __fadd_rn(y, __fmul_rn(__fmul_rn((float)acc[0][j][2 * h + 1], sa), sb.y));
        if constexpr (kZp) {
          const float rs = h ? rs1 : rs0;
          x = __fadd_rn(x, __fmul_rn(rs, zb.x));
          y = __fadd_rn(y, __fmul_rn(rs, zb.y));
        }
        accf[j][2 * h] = x;
        accf[j][2 * h + 1] = y;
        acc[0][j][2 * h] = acc[0][j][2 * h + 1] = 0;
      }
    }
  };

  load_tile(0);
  int g = 0;
  for (int k0 = 0; k0 < K; k0 += BK) {
    store_tile(k0);
    __syncthreads();
    if (k0 + BK < K) load_tile(k0 + BK);   // in flight during the MMAs
    mma_k_tile_rs<1, kZp>(As, Bs, acc, rsum, wm, wn, gr, tq);
    // a group ends with this tile (gsize is a multiple of BK, or all of K)
    if ((k0 + BK) % gsize == 0 || k0 + BK >= K) fold(g++);
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + wn + j * 8 + tq * 2;
    if (col >= N) continue;
    if (live0) store2(out + (size_t)row0 * N + col, accf[j][0], accf[j][1]);
    if (live1) store2(out + (size_t)row1 * N + col, accf[j][2], accf[j][3]);
  }
}

}  // namespace
