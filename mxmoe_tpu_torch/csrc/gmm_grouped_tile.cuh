// Device code shared by the grouped-scale int8 grouped GEMMs over
// expert-sorted rows: K8 gmm_w8a8_grouped (gmm_w8a8_grouped.cu), the flex
// form K4f of gmm_mixed_packed (gmm_mixed_packed.cu) and the w x a experts of
// K10 gmm_mixed_wo_wxa (gmm_mixed_wo_wxa.cu). Two schedules, chosen by the
// wrapper from M (ops/gmm_w8a8_grouped.py::grouped_gmm_schedule, no sync):
// the prefill body grouped_tile_body (a block's 32 x 128 output tile of one
// expert; K10 takes only this one) and, for M <= DECODE_M, the decode kernel
// gmm_grouped_decode_kernel below.
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
// The prefill body walks K in logical k order, 64 codes a tile, whatever
// the storage, and so does the decode kernel unless its one-pass walk of a
// packed expert applies (below). An int8-stored expert is a [K, N] block (in
// the ragged buffer of gmm_mixed_packed its two K/2-row units are adjacent,
// so it is one too). A nibble-packed expert (halves layout: byte row r holds
// code k = r in the low nibble and k = r + K/2 in the high nibble) gives
// code row k from byte row k, low nibble, for k < K/2 and from byte row k -
// K/2, high nibble, above. The mapping is made per row (K/2 % 4 == 0, so the
// four rows of a B fragment register lie on one side of K/2), so a scale
// group may span the two halves (K/2 = 704 with gsize 128 puts k = 640..767
// in group 5: 64 low nibbles' rows, then 64 high nibbles' rows, summed into
// one int32 group sum) and nothing else changes; a packed expert's byte rows
// are read once a half.
//
// Prefill body: the shared A / B layouts and the MMA step of
// gmm_int8_tile.cuh with a 32-row block tile (16 x 64 per warp): a thread
// carries 32 int32 group accumulators beside 32 f32 ones and nothing spills.
// Every gsize / 64 k-tiles the int32 accumulators are folded into the f32
// ones and cleared; the row sums of the zp term come from the A fragments in
// registers (dp4a), summed over the quad at each fold.
//
// Decode body (the pieces of gmm_int8_tile.cuh's decode schedule): at decode
// 16 routed rows spread over ~15 experts, so the 32-row tile held about one
// real row and 1320 blocks, most of them empty, streamed 256 KB slabs with one
// 8 KB k-tile in flight. Here a block is one m16 row block x 64 columns (4
// warps x 16 columns; acc[2][4] int32 and accf[2][4] f32 a thread), the m
// tiles bounded by M. Raw [64, 64] weight tiles (16-byte pieces swizzled by
// d_swz, rows outside the expert and k past K zero-filled) and the A rows
// go through a DSTAGES-deep cp.async ring, and so do the fold's operands:
// the k-tile that closes a group also brings that group's 64-column s_b (and
// zp) row and the 16 rows' s_a[:, g] into its stage, so a fold reads shared
// memory only. A packed expert's block walks its byte rows once where its
// high half's group sums fit a hold in shared memory (the decode case: a
// tile holds a few live rows): each byte tile feeds two MMA k-steps (low
// nibbles against A columns [r0, r0 + 64), high against [K/2 + r0, ..)), the
// low groups fold as they close, the high groups' int32 sums wait in the
// hold and fold after the low half, in order; a block streams half the
// k-tiles of an int8-stored expert's. (Time a k-tile, not bytes, bounds this
// body: a logical walk over a packed expert, half the bytes, took as long
// as over an int8 one.) When the grid would put fewer than about two blocks
// on each SM, K is split at whole groups (G = 1: at whole k-tiles): each
// split writes the int32 sums of its groups (the tile's live rows, and the
// row sums) to a workspace, and the tile's last block, found by an atomic
// ticket, adds a group's parts in split order and folds the groups in
// ascending order, several parts a ring stage. The f32 fold is order-bound,
// so only int32 sums cross blocks, and that tail is one block's serial chain
// over G groups.

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

// ---------------------------------------------------------------------------
// The decode schedule
// ---------------------------------------------------------------------------

// one DBK-deep k-step of a warp's 16 x 16 tile over a raw weight tile; with
// kPacked the tile's rows from hi_from on are high nibbles and the rows
// before it low nibbles of packed bytes (sign-extended)
template <bool kPacked, bool kRowSum>
__device__ __forceinline__ void gd_mma_tile(const int8_t* At, const int8_t* Bt,
                                            int (&acc)[2][4], int (&rsum)[2],
                                            int wn, int gr, int tq, int hi_from) {
#pragma unroll
  for (int ks = 0; ks < DBK; ks += 32) {
    uint32_t a[4];
    d_afrag(At, A_STRIDE, ks, gr, tq, a);
    if constexpr (kRowSum) {
      rsum[0] = __dp4a((int)a[0], 0x01010101, rsum[0]);
      rsum[0] = __dp4a((int)a[2], 0x01010101, rsum[0]);
      rsum[1] = __dp4a((int)a[1], 0x01010101, rsum[1]);
      rsum[1] = __dp4a((int)a[3], 0x01010101, rsum[1]);
    }
    const int k0 = ks + tq * 4, k1 = ks + 16 + tq * 4;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = wn + j * 8 + gr;
      uint32_t b0 = d_bcol(Bt, k0, c), b1 = d_bcol(Bt, k1, c);
      if constexpr (kPacked) {
        b0 = sext4((b0 >> (k0 >= hi_from ? 4 : 0)) & 0x0F0F0F0Fu);
        b1 = sext4((b1 >> (k1 >= hi_from ? 4 : 0)) & 0x0F0F0F0Fu);
      }
      mma_s8(acc[j], a, b0, b1);
    }
  }
}

// One ring stage of the decode kernel: the A rows and the raw weight tile of
// one k-tile (kTwoA: and the A rows K/2 further on, for a packed expert's
// one-pass walk) and, when the k-tile closes a group, the fold's operands
// (the group's s_b and zp over the block's 64 columns, s_a of its 16 rows).
// In the split-K tail a stage's a and b hold one or more (split, group) parts
// of the workspace (the tile's live rows: at most D_PART int32 = 4160 of
// their 5376 bytes), each with its fold's operands.
template <bool kTwoA>
struct __align__(16) GdStage {
  int8_t a[DEC_A_TILE];
  int8_t b[DEC_B_TILE];
  float s[2][DBN];
  float sa[DBM];
};
template <>
struct __align__(16) GdStage<true> {
  int8_t a[DEC_A_TILE];
  int8_t b[DEC_B_TILE];
  int8_t a_hi[DEC_A_TILE];
  float s[2][DBN];
  float sa[DBM];
};
static_assert(D_PART * 4 + (2 * DBN + DBM) * 4 <= DEC_A_TILE + DEC_B_TILE &&
                  DEC_A_TILE % 16 == 0,
              "a split-K part and its fold's operands fit a stage's tiles");

// a packed expert's one-pass walk holds its high half's group sums (the
// tile's live rows, int32) in this many bytes of shared memory, at most
// GD_HOLD_GROUPS groups; a block whose rows or groups do not fit walks
// logical k instead
constexpr int GD_HOLD_BYTES = 8192;
constexpr int GD_HOLD_GROUPS = 8;

// One block: expert rows of one m16 tile x 64 columns, the k-tiles
// [kt0, kt0 + kt_per_split) of logical K. kMayPack: rhs is the ragged buffer
// of gmm_mixed_packed (pflags / blk_offsets per expert); else [E, K, N] int8.
// Split-K (gridDim.z > 1; kt_per_split a multiple of gsize / 64 when G > 1,
// so a group lies in one split): ws [tiles, splits, gmax, D_PART] int32,
// tickets [tiles] (zero), gmax the groups one split holds (1 when G = 1).
//
// Two walks over K. The logical walk (every int8-stored expert, and a packed
// one that the one-pass walk does not take): k-tiles of logical k, a packed
// expert's code rows taken from byte rows k or k - K/2 (its bytes read once
// for each half). The one-pass walk (a packed expert of an unsplit launch
// with K/2 % 64 == 0 whose high half's sums fit the hold): byte tiles r0 =
// 0, 64, .., K/2 - 64, each against the A columns [r0, r0 + 64) (low
// nibbles) and [K/2 + r0, ..) (high nibbles) into two int32 sums. Low groups
// are folded as they close; a closing high group's sums go to the hold; at
// the end the groups from floor(K/2 / gsize) on are folded in ascending
// order from the hold, the first (a group that straddles K/2, or all of K
// when G = 1) with the low part still in the low sums added.
//
// The body takes the block's tile (expert e, rows [row_lo, row_hi) from m0,
// columns from n0 = blockIdx.x * 64) and its shared memory as pointers: the
// DSTAGES ring stages `st`, the one-pass hold `held` / `held_rs` (read only
// with kMayPack; may be null otherwise) and the ticket flag `is_last`, so a
// kernel may lay them over memory it shares with another body (K10).
template <typename OutT, bool kZp, bool kMayPack>
__device__ __forceinline__ void grouped_decode_body(
    const int8_t* __restrict__ lhs, const float* __restrict__ s_a,
    const int8_t* __restrict__ rhs, const float* __restrict__ s_b,
    const float* __restrict__ zp, const int* __restrict__ pflags,
    const int* __restrict__ blk_offsets, OutT* __restrict__ out,
    int* __restrict__ ws, int* __restrict__ tickets, int K, int N, int gsize,
    int kt_per_split, int e, int m0, int row_lo, int row_hi,
    GdStage<kMayPack>* st, int* held, int (*held_rs)[DBM], int& is_last) {
  constexpr int kS = kZp ? 2 : 1;       // f32 rows a fold reads: s_b (and zp)
  using Stage = GdStage<kMayPack>;
  const int n0 = blockIdx.x * DBN;

  const int G = K / gsize, K2 = K / 2;
  bool packed = false;
  const int8_t* w;
  if constexpr (kMayPack) {
    packed = pflags[e] != 0;
    w = rhs + (size_t)blk_offsets[e] * K2 * N;
  } else {
    w = rhs + (size_t)e * K * N;
  }
  const float* sb_e = s_b + (size_t)e * G * N;
  const float* zb_e = kZp ? zp + (size_t)e * G * N : sb_e;
  const int kt = (K + DBK - 1) / DBK;
  const bool split = gridDim.z > 1;
  const int gmax = G == 1 ? 1 : kt_per_split * DBK / gsize;

  // the tile's live rows [rb, re) relative to m0; the one-pass walk's held
  // groups (from the group holding k = K/2 on)
  const int rb = max(row_lo, m0) - m0, re = min(row_hi, m0 + DBM) - m0;
  const int g_hold = K2 / gsize, n_hold = G - g_hold;
  bool one_pass = false;
  if constexpr (kMayPack) {
    one_pass = packed && !split && K2 % DBK == 0 && n_hold <= GD_HOLD_GROUPS &&
               (re - rb) * n_hold * DBN * 4 <= GD_HOLD_BYTES;
  }
  // this block's k-tiles: logical, or byte tiles of the one-pass walk
  const int kt0 = one_pass ? 0 : blockIdx.z * kt_per_split;
  const int nk = one_pass ? K2 / DBK
                          : max(min(kt0 + kt_per_split, kt) - kt0, 0);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3, wn = warp * 16;

  // logical k-tile t closes its group (gsize is a multiple of DBK, or K)
  auto closes = [&](int t) {
    return ((t + 1) * DBK) % gsize == 0 || t == kt - 1;
  };
  // group g's fold operands -> stage sg
  auto issue_operands = [&](Stage& sg, int g) {
    if (tid >= 64 && tid < 64 + 16 * kS) {
      const int which = (tid - 64) >> 4, c = tid & 15, col = n0 + c * 4;
      const bool ok = col < N;
      const float* src = (which ? zb_e : sb_e) + (size_t)g * N + col;
      cp_async16(&sg.s[which][c * 4], ok ? src : sb_e, ok ? 16 : 0);
    } else if (tid >= 96 && tid < 96 + DBM) {
      const int row = m0 + tid - 96;
      const bool live = row >= row_lo && row < row_hi;
      cp_async4_zfill(&sg.sa[tid - 96], live ? s_a + (size_t)row * G + g : s_a,
                      live ? 4 : 0);
    }
  };
  // A: 16 rows x 4 pieces of columns [k0, k0 + 64), one piece a thread of
  // the 64 from `first`
  auto issue_a = [&](int8_t* dst, int k0, int first) {
    const int c = tid - first;
    const int row = m0 + (c >> 2), k = k0 + (c & 3) * 16;
    const bool live = row >= row_lo && row < row_hi && k < K;
    cp_async16(dst + (c >> 2) * A_STRIDE + (c & 3) * 16,
               live ? lhs + (size_t)row * K + k : lhs, live ? 16 : 0);
  };

  // k-tile t of this block -> ring stage t % DSTAGES (one commit group)
  auto issue = [&](int t) {
    if (t < nk) {
      const int k0 = (kt0 + t) * DBK;     // logical k, or the byte row
      Stage& sg = st[t % DSTAGES];
      if (tid < 64) {
        issue_a(sg.a, k0, 0);
      } else if constexpr (kMayPack) {
        if (one_pass) issue_a(sg.a_hi, K2 + k0, 64);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {       // B: 64 rows x 4 pieces
        const int u = tid + i * kThreads, r = u >> 2, c = u & 3;
        const int k = k0 + r, col = n0 + c * 16;
        const bool ok = k < K && col < N;
        const int br = (kMayPack && packed && !one_pass && k >= K2) ? k - K2 : k;
        cp_async16(&sg.b[d_swz(r, c)], ok ? w + (size_t)br * N + col : w,
                   ok ? 16 : 0);
      }
      // the operands of a (low) group this tile closes
      const bool close = one_pass ? (k0 + DBK) % gsize == 0 : closes(kt0 + t);
      if (!split && close) issue_operands(sg, k0 / gsize);
    }
    cp_async_commit();
  };

  int acc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
  int rsum[2] = {0, 0};
  float accf[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};

  // one group's int32 sums a (and row sums r) into accf, in the plain
  // version's steps, with the group's operands in shared memory (s_b and zp
  // over the block's 64 columns, s_a of its 16 rows); a, r cleared
  auto fold = [&](int (&a)[2][4], int (&r)[2], const float* sb, const float* zb,
                  const float* sa16) {
    const float sa[2] = {sa16[gr], sa16[gr + 8]};
    float rs[2] = {0.0f, 0.0f};
    if constexpr (kZp) {
      rs[0] = __fmul_rn((float)quad_sum(r[0]), sa[0]);
      rs[1] = __fmul_rn((float)quad_sum(r[1]), sa[1]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = wn + j * 8 + tq * 2;
      const float2 b = *reinterpret_cast<const float2*>(sb + c);
      const float2 z = *reinterpret_cast<const float2*>(zb + c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float x = accf[j][2 * h], y = accf[j][2 * h + 1];
        x = __fadd_rn(x, __fmul_rn(__fmul_rn((float)a[j][2 * h], sa[h]), b.x));
        y = __fadd_rn(y, __fmul_rn(__fmul_rn((float)a[j][2 * h + 1], sa[h]), b.y));
        if constexpr (kZp) {
          x = __fadd_rn(x, __fmul_rn(rs[h], z.x));
          y = __fadd_rn(y, __fmul_rn(rs[h], z.y));
        }
        accf[j][2 * h] = x;
        accf[j][2 * h + 1] = y;
        a[j][2 * h] = a[j][2 * h + 1] = 0;
      }
    }
    r[0] = r[1] = 0;
  };
  auto fold_stage = [&](int (&a)[2][4], int (&r)[2], const Stage& sg) {
    fold(a, r, sg.s[0], sg.s[kS - 1], sg.sa);
  };

  const size_t tile = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  auto part_of = [&](int z, int g) {     // split z's part of group g
    const int j = g - z * kt_per_split * DBK / gsize;
    return ws + ((tile * gridDim.z + z) * gmax + j) * D_PART;
  };
  // split-K: this split's int32 sums of group g, cleared. A part holds the
  // tile's live rows [rb, re) ([re - rb][64]) and then the 16 row sums.
  auto write_part = [&](int g) {
    int* part = part_of(blockIdx.z, g);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = gr + 8 * h;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        if (r >= rb && r < re)
          *reinterpret_cast<int2*>(part + (r - rb) * DBN + wn + jj * 8 + tq * 2) =
              make_int2(acc[jj][2 * h], acc[jj][2 * h + 1]);
        acc[jj][2 * h] = acc[jj][2 * h + 1] = 0;
      }
    }
    if constexpr (kZp) {
      const int r0 = quad_sum(rsum[0]), r1 = quad_sum(rsum[1]);
      if (warp == 0 && tq == 0) {
        part[(re - rb) * DBN + gr] = r0;
        part[(re - rb) * DBN + gr + 8] = r1;
      }
      rsum[0] = rsum[1] = 0;
    }
  };

#pragma unroll
  for (int t = 0; t < DSTAGES - 1; ++t) issue(t);
  if (one_pass) {
    if constexpr (kMayPack) {
      int acc_hi[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
      int rsum_hi[2] = {0, 0};
      int q = 0;                          // high groups held so far
      for (int t = 0; t < nk; ++t) {
        cp_async_wait<DSTAGES - 2>();
        __syncthreads();
        issue(t + DSTAGES - 1);
        const Stage& sg = st[t % DSTAGES];
        gd_mma_tile<true, kZp>(sg.a, sg.b, acc, rsum, wn, gr, tq, DBK);
        gd_mma_tile<true, kZp>(sg.a_hi, sg.b, acc_hi, rsum_hi, wn, gr, tq, 0);
        if (((t + 1) * DBK) % gsize == 0) fold_stage(acc, rsum, sg);
        const int k_hi = K2 + (t + 1) * DBK;
        if (k_hi % gsize == 0 || k_hi == K) {
          // hold the closed high group: the live rows' sums, the row sums
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = gr + 8 * h;
            if (r >= rb && r < re) {
              int* dst = held + (q * (re - rb) + r - rb) * DBN + wn + tq * 2;
#pragma unroll
              for (int jj = 0; jj < 2; ++jj)
                *reinterpret_cast<int2*>(dst + jj * 8) =
                    make_int2(acc_hi[jj][2 * h], acc_hi[jj][2 * h + 1]);
            }
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) acc_hi[jj][2 * h] = acc_hi[jj][2 * h + 1] = 0;
          }
          if constexpr (kZp) {
            const int r0 = quad_sum(rsum_hi[0]), r1 = quad_sum(rsum_hi[1]);
            if (warp == 0 && tq == 0) {
              held_rs[q][gr] = r0;
              held_rs[q][gr + 8] = r1;
            }
            rsum_hi[0] = rsum_hi[1] = 0;
          }
          ++q;
        }
      }
      // the held groups in ascending order, their operands through the ring;
      // the first also takes the low part left in acc (zero unless it
      // straddles K/2)
      cp_async_wait<0>();
      __syncthreads();
      auto hold_issue = [&](int i) {
        if (i < n_hold) issue_operands(st[i % DSTAGES], g_hold + i);
        cp_async_commit();
      };
#pragma unroll
      for (int i = 0; i < DSTAGES - 1; ++i) hold_issue(i);
      for (int i = 0; i < n_hold; ++i) {
        cp_async_wait<DSTAGES - 2>();
        __syncthreads();
        hold_issue(i + DSTAGES - 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = gr + 8 * h;
          if (r >= rb && r < re) {
            const int* src = held + (i * (re - rb) + r - rb) * DBN + wn + tq * 2;
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              const int2 v = *reinterpret_cast<const int2*>(src + jj * 8);
              acc[jj][2 * h] += v.x;
              acc[jj][2 * h + 1] += v.y;
            }
            if (kZp && tq == 0) rsum[h] += held_rs[i][r];
          }
        }
        fold_stage(acc, rsum, st[i % DSTAGES]);
      }
    }
  } else {
    for (int t = 0; t < nk; ++t) {
      cp_async_wait<DSTAGES - 2>();
      __syncthreads();                    // tile t landed; stage t-1 is free
      issue(t + DSTAGES - 1);
      const Stage& sg = st[t % DSTAGES];
      const int tg = kt0 + t;
      if (packed) {
        // tile rows from here on are high nibbles (k >= K/2)
        const int hi_from = min(max(K2 - tg * DBK, 0), DBK);
        gd_mma_tile<true, kZp>(sg.a, sg.b, acc, rsum, wn, gr, tq, hi_from);
      } else {
        gd_mma_tile<false, kZp>(sg.a, sg.b, acc, rsum, wn, gr, tq, DBK);
      }
      if (split) {
        if (closes(tg) || t == nk - 1) write_part(tg * DBK / gsize);
      } else if (closes(tg)) {
        fold_stage(acc, rsum, sg);
      }
    }
  }
  cp_async_wait<0>();

  if (split) {
    // the tile's last block adds each group's parts in split order and folds
    // the groups in ascending order, the parts and operands streamed through
    // the ring
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      is_last = atomicAdd(tickets + tile, 1) == (int)gridDim.z - 1;
      if (is_last) tickets[tile] = 0;     // every split has its ticket
    }
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    // a slot of a stage's a + b bytes: one part (its live rows and row
    // sums), then the fold's operands (s_b, zp, s_a); as many slots a stage
    // as fit. Slot q of item i is part (group, split) = (i * per + q, the
    // split holding it) when G > 1, (0, i * per + q) when G = 1.
    const int rec = (re - rb) * DBN + DBM;                   // int32
    const int slot = rec * 4 + (2 * DBN + DBM) * 4;          // bytes
    const int per = (DEC_A_TILE + DEC_B_TILE) / slot;
    const int n_parts = G == 1 ? (int)gridDim.z : G;
    const int items = (n_parts + per - 1) / per;
    auto slot_ptr = [&](Stage& sg, int q) {
      return reinterpret_cast<int*>(sg.a + q * slot);
    };
    auto tail_issue = [&](int i) {
      if (i < items) {
        Stage& sg = st[i % DSTAGES];
        const int q_end = min(per, n_parts - i * per);
        for (int q = 0; q < q_end; ++q) {
          const int p = i * per + q;
          const int g = G == 1 ? 0 : p;
          const int z = G == 1 ? p : g * gsize / DBK / kt_per_split;
          const int* src = part_of(z, g);
          int* dst = slot_ptr(sg, q);
          for (int c = tid; c < rec / 4; c += kThreads)
            cp_async16(dst + 4 * c, src + 4 * c);
          if (G > 1 || p == n_parts - 1) {  // the operands of group g
            float* ops = reinterpret_cast<float*>(dst + rec);
            if (tid < 16 * kS) {
              const int which = tid >> 4, c = tid & 15, col = n0 + c * 4;
              const bool ok = col < N;
              const float* o = (which ? zb_e : sb_e) + (size_t)g * N + col;
              cp_async16(ops + which * DBN + c * 4, ok ? o : sb_e, ok ? 16 : 0);
            } else if (tid >= 32 && tid < 32 + DBM) {
              const int row = m0 + tid - 32;
              const bool live = row >= row_lo && row < row_hi;
              cp_async4_zfill(ops + 2 * DBN + tid - 32,
                              live ? s_a + (size_t)row * G + g : s_a, live ? 4 : 0);
            }
          }
        }
      }
      cp_async_commit();
    };
#pragma unroll
    for (int i = 0; i < DSTAGES - 1; ++i) tail_issue(i);
    for (int i = 0; i < items; ++i) {
      cp_async_wait<DSTAGES - 2>();
      __syncthreads();
      tail_issue(i + DSTAGES - 1);
      Stage& sg = st[i % DSTAGES];
      const int q_end = min(per, n_parts - i * per);
      for (int q = 0; q < q_end; ++q) {
        const int* ps = slot_ptr(sg, q);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = gr + 8 * h;
          if (r >= rb && r < re) {
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              const int2 v = *reinterpret_cast<const int2*>(
                  ps + (r - rb) * DBN + wn + jj * 8 + tq * 2);
              acc[jj][2 * h] += v.x;
              acc[jj][2 * h + 1] += v.y;
            }
            // every lane of a quad holds the row's whole sum: count it once
            if (kZp && tq == 0) rsum[h] += ps[(re - rb) * DBN + r];
          }
        }
        if (G > 1 || i * per + q == n_parts - 1) {
          const float* ops = reinterpret_cast<const float*>(ps + rec);
          fold(acc, rsum, ops, ops + (kS - 1) * DBN, ops + 2 * DBN);
        }
      }
    }
    cp_async_wait<0>();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + gr + h * 8;
    if (row < row_lo || row >= row_hi) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = n0 + wn + j * 8 + tq * 2;
      if (col >= N) continue;
      store2(out + (size_t)row * N + col, accf[j][2 * h], accf[j][2 * h + 1]);
    }
  }
}

// K8's and K4f's decode kernel: the block's tile, then the body over its
// own static shared memory.
template <typename OutT, bool kZp, bool kMayPack>
__global__ void __launch_bounds__(kThreads)
gmm_grouped_decode_kernel(const int8_t* __restrict__ lhs,
                          const float* __restrict__ s_a,
                          const int8_t* __restrict__ rhs,
                          const float* __restrict__ s_b,
                          const float* __restrict__ zp,
                          const int* __restrict__ group_sizes,
                          const int* __restrict__ pflags,
                          const int* __restrict__ blk_offsets,
                          OutT* __restrict__ out, int* __restrict__ ws,
                          int* __restrict__ tickets, int M, int K, int N, int E,
                          int gsize, int kt_per_split) {
  __shared__ GdStage<kMayPack> st[DSTAGES];
  // the one-pass walk's held high-half sums: [group][live row][64] and the
  // groups' row sums [group][16]
  __shared__ int held[kMayPack ? GD_HOLD_BYTES / 4 : 1];
  __shared__ int held_rs[kMayPack ? GD_HOLD_GROUPS : 1][DBM];
  __shared__ int sizes[kMaxExperts];
  __shared__ int tile_info[4];          // expert, first row, row begin, row end
  __shared__ int is_last;

  if (!block_tile<DBM>(group_sizes, E, M, sizes, tile_info)) return;
  grouped_decode_body<OutT, kZp, kMayPack>(
      lhs, s_a, rhs, s_b, zp, pflags, blk_offsets, out, ws, tickets, K, N, gsize,
      kt_per_split, tile_info[0], tile_info[1], tile_info[2], tile_info[3], st,
      held, held_rs, is_last);
}
}  // namespace
