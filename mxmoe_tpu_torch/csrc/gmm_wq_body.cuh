// The persistent wgmma bodies of the weight-quantized grouped GEMMs above
// the decode rows, over expert-sorted rows with group sizes read on the
// device:
//
// * body A, the weight-only product: K6 gmm_weight_only (codes [E, K, N]
//   int8), K7 gmm_weight_only_packed (4-bit codes nibble-packed [E, K/2, N],
//   halves layout) and the weight-only experts of K10 gmm_mixed_wo_wxa;
//     w[e,k,n]  = bf16( (float)q[e,k,n] * scale[e, k/gsize, n] + zp[e, k/gsize, n] )
//     out[r, n] = OutT( sum_k lhs[r,k] * w[e,k,n] )      (f32 accumulation)
// * body B, the grouped-scale int8 product: K8 gmm_w8a8_grouped, the
//   w x a experts of K10, K4f (the flex form of gmm_mixed_packed, over its
//   ragged storage) and K9 gmm_w8a8_asym (one group, zp); per k-group g in
//   ascending order, each step rounded on its own,
//     acc += ((float)(sum_{k in g} a[r,k] q[e,k,n]) * s_a[r,g]) * s_b[e,g,n]
//     acc += ((float)(sum_{k in g} a[r,k]) * s_a[r,g]) * zp[e,g,n]   (with zp)
//   which is the plain grouped_rows_plain's order; with one group and no
//   zp, K2's (acc * s_a) * s_b added to zero; with one group and zp, K9's
//   (acc * s_a) * s_b + (rsum * s_a) * zp, its first term added to zero.
//
// Bound on the H100: weight bytes at a 256-token prefill chunk (17-25 rows
// an expert: one byte a code, 0.11 ms for qwen2_moe's gate_up), operations
// from a few thousand rows an expert on. The 32 x 128 mma.sync bodies these
// replace above the decode rows ran at 17-26 % of the chunk's bound:
// mma.sync cannot reach the tensor cores' dense rate, every 32-row m-tile
// read and dequantized its expert's codes again, and the f32 -> bf16 weights
// were restaged through shared memory between two block barriers.
//
// Design: the walk of gmm_ws_body.cuh (K15, K2 / K5 and K11 above the decode
// rows). One CTA an SM takes every P-th work item in (group, n-tile,
// m-tile) order, so the m-tiles of one weight column run side by side and
// the codes come from L2 after their first read; a group's m-tiles start
// at its own first row, and rows of the next group or past M (TMA reads
// zeros there) are multiplied and not stored. An item is 128 rows x 256
// columns in body A, 128 x 128 in body B: in K10 each group's flag says
// which, the walk steps over the group's n-tiles at its own width, and the
// items are dealt so that every CTA gets the same k-tiles (WqWalk;
// ops/gmm_w8a8_grouped.py::wq_device_work_items / wq_cta_items are the same
// walk).
// 384 threads, three warpgroups:
// * one producer warpgroup, whose thread 0 alone loads by TMA, as far ahead
//   as the rings let it: for each k-tile the activations' [128 rows x 128
//   bytes] tile (bf16 lhs [128 x 64], or int8 lhs_q [128 x 128]: K-major,
//   128-byte swizzle, wgmma's A layout as it lands), the raw codes (body A:
//   64 code rows x 256 columns; body B: 128 x 128), 16 KB either way, and
//   the k-tile's group's scale (and zp) row over 256 columns. One ring
//   therefore serves both bodies, and K10's items follow each other in it.
// * two consumer warpgroups of 64 rows each. Their eight warps turn every
//   raw k-tile into its B stage, whichever warpgroup holds stored rows:
//   - body A dequantizes: warp cw the code rows cw + 8 i, lane l the columns
//     8 l .. 8 l + 7. A code becomes an f32 without I2F (its biased byte in
//     the mantissa of 2^23, less 2^23 + bias), then __fmul_rn, __fadd_rn and
//     cvt.rn.bf16x2.f32: the bits of dequantize_expert. The eight bf16 go to
//     the 16-byte chunk (l % 8) ^ cw of the row in box l / 8 of four [64 k x
//     64 columns] 128-byte-swizzled boxes, the layout TMA writes for K11's
//     bf16 weights, which K11's descriptors read MN-major. K is walked in
//     logical k order, 64 codes a k-tile: for packed codes k-tile t takes
//     byte rows 64 t and their low nibbles below K/2, byte rows 64 t - K/2
//     and their high nibbles above (K % 128 == 0, so no k-tile straddles
//     K/2). Both storages therefore feed the MMAs the same bf16 stage in the
//     same order, and K7 equals K6 bit for bit;
//   - body B transposes the raw [128 k x 128 n] bytes into wgmma's K-major
//     swizzled B stage (warp cw the codes 16 cw .. + 15, lane l the columns
//     4 l .. + 3) and keeps the group's s_b (and zp) row over the item's 128
//     columns with it for the fold.
//   A warpgroup whose 64 rows all lie past the group's end (a chunk's 17-25
//   rows an expert) then releases the stages and issues no MMA; the other
//   issues them and stores its rows straight from the accumulators.
//   Body A: wgmma m64n256k16 .f32.bf16.bf16, four a 64-deep k-tile, the
//   k-tile turned (its eight rows a warp unrolled: 4-5 % off K6 against
//   four) while the MMAs of the one before run. Dequantized by the
//   producer warpgroup alone, with its scale loads in its way, body A ran
//   at about a third of the chunk's bound; eight warps, two a scheduler,
//   and the rows by TMA hide the latencies one warp a scheduler could not.
//   - body B over K4f's ragged storage (rhs_cat [R, N]: expert e from byte
//     row blk_offsets[e] * K/2, K/2 rows nibble-packed when pflags[e], K
//     int8 rows else) reads a k-tile as two half boxes of [64 rows x 128
//     columns] through one 2D map: half h holds codes c = 128 t + 64 h, byte
//     rows c of an int8 expert; of a packed one byte rows c (low nibbles)
//     below K/2 and c - K/2 (high nibbles) above (K % 128 == 0, so no half
//     straddles K/2 and no box leaves the expert's block). Warp cw's codes
//     lie in half cw / 4: it sign-extends the nibble the group's flag and
//     the half say, by selects, before the transpose; both walks read the
//     flag and the first byte row of a group as they reach it. A packed
//     expert's bytes are read twice, in the low and the high k-tiles: the
//     second read comes from L2 (timed against K8 on the same codes), so
//     the walk, the MMAs and the folds stay K8's and K4f is bitwise K8.
//   Body B: wgmma m64n128k32 .s32.s8.s8, four a 128-deep k-tile (64 int32
//   and 64 f32 accumulators a thread: an n256 item would need 256
//   registers), a group's k-tiles (gsize a multiple of 128, or all of K) in
//   one inner loop, each k-tile's successor turned while its MMAs run
//   (5-7 % off K8 at the chunk and at 65536 rows against turning it after
//   the fold); then the warpgroup waits for its MMAs and folds the
//   int32 sums into the f32 ones with the group's s_a (two rows a thread,
//   read through L2) and s_b / zp; with zp the row sums of the group's
//   activations are added up from the A stages in shared memory (dp4a, 32
//   codes a lane a k-tile, summed over the quad at the fold). No branch on
//   the data sits between two MMAs, or ptxas serializes them (C7518).
// Rings: five A stages (16 KB), four raw stages (16 KB and 2 KB of scale
// rows), two B stages (32 KB and 1 KB of scale rows), 218 KB in all.
// mbarriers: a_full / raw_full (TMA bytes), b_full / raw_empty (the eight
// consumer warps, after their turn and a fence.proxy.async), a_empty /
// b_empty (the eight consumer warps after their wgmma wait). Every waiter of
// a barrier takes part in the phase after the one it waits for: a parity
// wait cannot tell a phase from the one two on, and a producer warpgroup
// that turned body B's codes while the consumers turned body A's ran two
// phases behind at K10's switches between the bodies and hung.
// setmaxnreg moves the producer's registers to the consumers.

#pragma once

#include "gmm_weight_only_tile.cuh"
#include "gmm_ws_body.cuh"

namespace {

constexpr int WQ_BM = 128;                   // rows of a work item
constexpr int WQ_BN_WO = 256, WQ_BK_WO = 64;  // body A: columns, codes of a k-tile
constexpr int WQ_BN_GQ = 128, WQ_BK_GQ = 128; // body B
constexpr int WQ_A_STAGES = 5, WQ_RAW = 4, WQ_B_STAGES = 2;
constexpr int WQ_A_BYTES = 16384;            // [128 rows][128 bytes], swizzled
constexpr int WQ_RAW_BYTES = 16384;          // [64 rows][256] or [128 rows][128] codes
constexpr int WQ_B_BYTES = 32768;            // body A: four bf16 boxes; body B: half
constexpr int WQ_BOX_BYTES = 8192;           // body A: one [64 k x 64 columns] bf16 box

// body A alone (K6 / K7), body B alone (K8, K9), both by the group's flag
// (K10), body B over ragged mixed storage (K4f)
enum WqMode { kWqWeightOnly = 0, kWqGrouped = 1, kWqMixed = 2, kWqGroupedRagged = 3 };

// whether a mode runs body A / body B
__host__ __device__ constexpr bool wq_has_a(int mode) { return mode == kWqWeightOnly || mode == kWqMixed; }
__host__ __device__ constexpr bool wq_has_b(int mode) { return mode != kWqWeightOnly; }

struct WqSmem {
  uint8_t a[WQ_A_STAGES][WQ_A_BYTES];
  uint8_t b[WQ_B_STAGES][WQ_B_BYTES];
  uint8_t raw[WQ_RAW][WQ_RAW_BYTES];
  float rs[WQ_RAW][2][WQ_BN_WO];             // scale and zp of the raw k-tile's group
  float s[WQ_B_STAGES][2][WQ_BN_GQ];         // body B: s_b and zp, kept for the fold
  uint64_t a_full[WQ_A_STAGES], a_empty[WQ_A_STAGES];
  uint64_t raw_full[WQ_RAW], raw_empty[WQ_RAW];
  uint64_t b_full[WQ_B_STAGES], b_empty[WQ_B_STAGES];
};
static_assert(sizeof(WqSmem) + 1024 <= 232448, "the rings");
constexpr int kWqSmemBytes = (int)sizeof(WqSmem) + 1024;

struct WqArgs {
  const float* s_a;          // [M, G]: body B
  const float* scale;        // [E, G, N]
  const float* zp;           // [E, G, N], or null (zero points 0)
  const int* flags;          // [E]: 1 body A, 0 body B (K10)
  const int* group_sizes;    // [E]
  const int* pflags;         // [E]: 1 nibble-packed (K4f)
  const int* blk;            // [E]: first K/2-row unit in rhs_cat (K4f)
  void* out;                 // [M, N]
  int M, K, N, E, gsize;
};

// the CTA's walk over work items in (group, n-tile, m-tile) order; group g
// stores rows [row0, row_end), row_end = min(row0 + size, M), in
// cdiv(row_end - row0, 128) m-tiles from row0 on, over n-tiles of its
// body's width. Each body numbers its own items, and the items are dealt so
// that every CTA of the grid (P CTAs) gets the same work: body A's item i
// goes to CTA i % P; a body A item is twice a body B item's k-tiles (K %
// 128 == 0), so the P - rA CTAs that got one body A item fewer (rA = nA % P
// of the nA body A items) first get two body B items each, items j < J1 =
// 2 (P - rA) going to CTA rA + j % (P - rA), and then body B's item j goes
// to CTA (j - J1) % P. (Dealt round the grid in one numbering over both
// bodies, K10's items fell on one body a CTA: with 11 body A n-tiles and 22
// body B n-tiles a group the pattern repeats every 33 items, 132 = 4 x 33,
// and CTAs ran body A's longer items only; dealt each on its own, a CTA
// with one body A item more than another held 20 % more work.)
template <int kMode>
struct WqWalk {
  int g = 0, row0 = 0, size = 0, mt = 0, nt = 0;
  int base[2] = {0, 0};                 // items of each body before group g
  int next_i[2] = {0, 0};               // the CTA's next item of each body
  int step1 = 0, j1 = 0;                // body B's first deal (CTAs rA ..)
  int m0 = 0, n0 = 0, row_end = 0;
  bool wo_ = kMode == kWqWeightOnly;  // the current group's body (K10)
  bool pk = false;                      // the current group nibble-packed (K4f)
  int cat_row0 = 0;                     // its first byte row in rhs_cat (K4f)

  // whether the current group takes body A (a constant but in K10)
  __device__ __forceinline__ bool wo() const {
    return kMode == kWqMixed ? wo_ : kMode == kWqWeightOnly;
  }
  __device__ __forceinline__ void enter(const WqArgs& p) {
    size = __ldg(p.group_sizes + g);
    mt = (max(min(size, p.M - row0), 0) + WQ_BM - 1) / WQ_BM;
    if constexpr (kMode == kWqMixed) wo_ = __ldg(p.flags + g) != 0;
    if constexpr (kMode == kWqGroupedRagged) {
      pk = __ldg(p.pflags + g) != 0;
      cat_row0 = __ldg(p.blk + g) * (p.K / 2);
    }
    const int bn = wo() ? WQ_BN_WO : WQ_BN_GQ;
    nt = (p.N + bn - 1) / bn;
  }
  __device__ __forceinline__ void begin(const WqArgs& p) {
    const int P = gridDim.x, c = blockIdx.x;
    next_i[0] = c;
    next_i[1] = c;
    if constexpr (kMode == kWqMixed) {
      int na = 0, r0 = 0;                                // the body A items
      for (int e = 0; e < p.E; ++e) {
        const int sz = __ldg(p.group_sizes + e);
        if (__ldg(p.flags + e) != 0)
          na += (max(min(sz, p.M - r0), 0) + WQ_BM - 1) / WQ_BM *
                ((p.N + WQ_BN_WO - 1) / WQ_BN_WO);
        r0 += sz;
      }
      const int ra = na % P;
      if (ra > 0) {
        j1 = 2 * (P - ra);
        step1 = P - ra;
        next_i[1] = c >= ra ? c - ra : j1 + c;
      }
    }
    enter(p);
  }
  // the CTA's next item -> true and m0 / n0 / row_end, false past the last
  __device__ __forceinline__ bool next(const WqArgs& p) {
    const int b = wo() ? 0 : 1;
    int r = next_i[b] - base[b];
    while (r >= mt * nt) {
      base[wo() ? 0 : 1] += mt * nt;
      row0 += size;
      if (++g >= p.E) return false;
      enter(p);
      r = next_i[wo() ? 0 : 1] - base[wo() ? 0 : 1];
    }
    n0 = (r / mt) * (wo() ? WQ_BN_WO : WQ_BN_GQ);
    m0 = row0 + (r % mt) * WQ_BM;
    row_end = min(row0 + size, p.M);
    int& i = next_i[wo() ? 0 : 1];
    if (!wo() && i < j1) {
      i += step1;
      if (i >= j1) i = j1 + (int)blockIdx.x;
    } else {
      i += gridDim.x;
    }
    return true;
  }
};

// body A's turn of the consumer warp cw's eight rows (cw + 8 i) of one raw
// k-tile (64 code rows x 256 columns) into the bf16 B stage; lane l takes
// the columns 8 l .. 8 l + 7, whose scale and zp (srow / zrow, the
// k-tile's group over the item's 256 columns) it reads first; hi: the high
// nibbles of packed bytes. Every row r has r % 8 == cw, so a lane's chunk
// sits at (l % 8) ^ cw of each row of box l / 8.
template <bool kPacked>
__device__ __forceinline__ void wq_dequant_rows(const uint8_t* raw, uint8_t* b,
                                                const float* srow, const float* zrow,
                                                bool has_zp, bool hi, int cw, int lane) {
  constexpr int kBias = kPacked ? 8 : 128;
  const float4 s0 = *reinterpret_cast<const float4*>(srow + 8 * lane);
  const float4 s1 = *reinterpret_cast<const float4*>(srow + 8 * lane + 4);
  float4 z0 = *reinterpret_cast<const float4*>(zrow + 8 * lane);
  float4 z1 = *reinterpret_cast<const float4*>(zrow + 8 * lane + 4);
  if (!has_zp) z0 = z1 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
  const float z[8] = {z0.x, z0.y, z0.z, z0.w, z1.x, z1.y, z1.z, z1.w};
  const uint8_t* src = raw + 8 * lane;
  uint8_t* dst = b + (lane >> 3) * WQ_BOX_BYTES + (((lane & 7) ^ cw) << 4);
  const int shift = hi ? 4 : 0;
#pragma unroll
  for (int i = 0; i < WQ_BK_WO / 8; ++i) {
    const int row = cw + 8 * i;
    const uint2 u = *reinterpret_cast<const uint2*>(src + row * WQ_BN_WO);
    uint32_t c[2] = {u.x, u.y};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if constexpr (kPacked)
        c[h] = ((c[h] >> shift) & 0x0F0F0F0Fu) ^ 0x08080808u;
      else
        c[h] ^= 0x80808080u;
    }
    float w[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      w[j] = __fadd_rn(__fmul_rn(biased_code<kBias>(c[j >> 2], j & 3), s[j]), z[j]);
    *reinterpret_cast<uint4*>(dst + row * 128) =
        make_uint4(bf16x2_bits(w[0], w[1]), bf16x2_bits(w[2], w[3]),
                   bf16x2_bits(w[4], w[5]), bf16x2_bits(w[6], w[7]));
  }
}

// body B's turn of the consumer warp cw's codes 16 cw .. 16 cw + 15 of one
// raw k-tile ([128 k][128 n] bytes) into the K-major swizzled B stage
// ([128 n][128 k]): lane l the columns 4 l .. 4 l + 3, one four-byte load
// of each code row (a warp reads a whole 128-byte row), 4 x 4 byte
// transposes, one 16-byte store a column, to chunk cw ^ (n % 8) of row n.
// kNib (K4f): with pk the bytes are nibble-packed and their low (high with
// hi) nibbles, sign-extended, are the codes; chosen by selects, no branch
template <bool kNib>
__device__ __forceinline__ void wq_transpose_rows(const uint8_t* raw, uint8_t* b, int cw,
                                                  int lane, bool pk, bool hi) {
  const uint8_t* src = raw + 16 * cw * WQ_BN_GQ + 4 * lane;
  uint32_t r[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) r[j] = *reinterpret_cast<const uint32_t*>(src + j * WQ_BN_GQ);
  if constexpr (kNib) {
    const int shift = hi ? 4 : 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uint32_t v = sext4((r[j] >> shift) & 0x0F0F0F0Fu);
      r[j] = pk ? v : r[j];
    }
  }
  uint32_t col[4][4];                                    // [column][code group]
#pragma unroll
  for (int kg = 0; kg < 4; ++kg) {
    const uint32_t t0 = __byte_perm(r[4 * kg], r[4 * kg + 1], 0x5140);
    const uint32_t t1 = __byte_perm(r[4 * kg + 2], r[4 * kg + 3], 0x5140);
    const uint32_t t2 = __byte_perm(r[4 * kg], r[4 * kg + 1], 0x7362);
    const uint32_t t3 = __byte_perm(r[4 * kg + 2], r[4 * kg + 3], 0x7362);
    col[0][kg] = __byte_perm(t0, t1, 0x5410);
    col[1][kg] = __byte_perm(t0, t1, 0x7632);
    col[2][kg] = __byte_perm(t2, t3, 0x5410);
    col[3][kg] = __byte_perm(t2, t3, 0x7632);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = 4 * lane + i;
    *reinterpret_cast<uint4*>(b + n * WQ_BK_GQ + ((cw ^ (n & 7)) << 4)) =
        make_uint4(col[i][0], col[i][1], col[i][2], col[i][3]);
  }
}

// One consumer warpgroup's part of one work item; both return the CTA's
// k-tile count after the item. q: the CTA's k-tile count before it; the
// item's rows [m0, m0 + 128) of which [.., row_end) are stored, its columns
// from n0; live: the warpgroup holds a stored row. The eight consumer
// warps turn every raw k-tile into its B stage, live or not; only a live
// warpgroup waits for the full stages and issues MMAs. Every waiter of a
// barrier takes part in the phase after the one it waits for (a parity
// wait cannot tell a phase from the one two on).

__device__ __forceinline__ void wq_release(WqSmem& sm, int k, int lane) {
  if (lane == 0) {                       // k-tile k's stages are read
    mbar_arrive(&sm.a_empty[k % WQ_A_STAGES]);
    mbar_arrive(&sm.b_empty[k % WQ_B_STAGES]);
  }
}

__device__ __forceinline__ void wq_wait_full(WqSmem& sm, int k) {
  mbar_wait(&sm.a_full[k % WQ_A_STAGES], (k / WQ_A_STAGES) & 1);
  mbar_wait(&sm.b_full[k % WQ_B_STAGES], (k / WQ_B_STAGES) & 1);
}

// the warp's share of k-tile k (the item's kt-th) into its B stage, once
// the stage's last readers are done; then the raw stage is free. kPacked:
// body A's codes nibble-packed; in body B the ragged storage, whose group is
// packed when pk
template <bool kWo, bool kPacked, bool kZp>
__device__ __forceinline__ void wq_turn(WqSmem& sm, const WqArgs& p, int k, int kt,
                                        bool pk = false) {
  const int tid = threadIdx.x, cw = tid >> 5, lane = tid & 31;
  const int r = k % WQ_RAW, sb = k % WQ_B_STAGES;
  mbar_wait(&sm.raw_full[r], (k / WQ_RAW) & 1);
  if (k >= WQ_B_STAGES) mbar_wait(&sm.b_empty[sb], ((k / WQ_B_STAGES) - 1) & 1);
  if constexpr (kWo) {
    wq_dequant_rows<kPacked>(sm.raw[r], sm.b[sb], sm.rs[r][0], sm.rs[r][1],
                             p.zp != nullptr, kPacked && kt * WQ_BK_WO >= p.K / 2, cw,
                             lane);
  } else {
    // warp cw's codes lie in half cw / 4 of the k-tile
    wq_transpose_rows<kPacked>(sm.raw[r], sm.b[sb], cw, lane, pk,
                               kt * WQ_BK_GQ + 64 * (cw >> 2) >= p.K / 2);
    // the group's s_b (threads 0-127) and zp (128-255) over the item's
    // columns, kept with the B stage for the fold
    const int which = tid >> 7, c = tid & 127;
    sm.s[sb][which][c] = (which == 0 || kZp) ? sm.rs[r][which][c] : 0.0f;
  }
  fence_proxy_async_smem();
  __syncwarp();
  if (lane == 0) {
    mbar_arrive(&sm.raw_empty[r]);
    mbar_arrive(&sm.b_full[sb]);
  }
}

// body A: bf16 x dequantized bf16, f32 over all of K; k-tile q is turned
// while the MMAs of q - 1 run
template <typename OutT, bool kPacked>
__device__ __forceinline__ int wq_item_wo(WqSmem& sm, const WqArgs& p, int q, int m0,
                                          int n0, int row_end, bool live) {
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int N = p.N, kt_n = p.K / WQ_BK_WO;
  // the branch stays outside the k-loops and warp-uniform, or ptxas
  // serializes every wgmma (C7518)
  if (!live) {
    for (int kt = 0; kt < kt_n; ++kt, ++q) {
      wq_turn<true, kPacked, false>(sm, p, q, kt);
      wq_release(sm, q, lane);
    }
    return q;
  }
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
  for (int kt = 0; kt < kt_n; ++kt, ++q) {
    const int sa = q % WQ_A_STAGES, sb = q % WQ_B_STAGES;
    wq_turn<true, kPacked, false>(sm, p, q, kt);
    wq_wait_full(sm, q);
    reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < WQ_BK_WO / 16; ++ks)
      wgmma_m64n256k16_bf16_tb(acc, smem_desc_sw128(sm.a[sa] + wg * 64 * 128 + ks * 32),
                               smem_desc_sw128_mn(sm.b[sb] + ks * 16 * 128, WQ_BOX_BYTES),
                               kt > 0 || ks > 0);
    wgmma_commit();
    reg_fence(acc);
    if (kt > 0) {                        // k-tile q - 1's reads are done
      wgmma_wait<1>();
      reg_fence(acc);
      wq_release(sm, q - 1, lane);
    }
  }
  wgmma_wait<0>();
  reg_fence(acc);
  wq_release(sm, q - 1, lane);
  OutT* out = static_cast<OutT*>(p.out);
  const int row0 = m0 + wg * 64 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= row_end) continue;
    OutT* orow = out + (size_t)row * N;
#pragma unroll
    for (int j = 0; j < WQ_BN_WO / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane & 3);
      if (col < N) store2(orow + col, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
  return q;
}

// body B: the int32 sums of a group over its k-tiles, then the fold into the
// f32 sums, groups in ascending order. kRagged: K4f's storage, the item's
// group packed when pk
template <typename OutT, bool kZp, bool kRagged>
__device__ __forceinline__ int wq_item_gq(WqSmem& sm, const WqArgs& p, int q, int m0,
                                          int n0, int row_end, bool live, bool pk) {
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int K = p.K, N = p.N, G = K / p.gsize;
  const int kt_n = (K + WQ_BK_GQ - 1) / WQ_BK_GQ;
  if (!live) {
    for (int kt = 0; kt < kt_n; ++kt, ++q) {
      wq_turn<false, kRagged, kZp>(sm, p, q, kt, pk);
      wq_release(sm, q, lane);
    }
    return q;
  }
  const int rl = wg * 64 + warp * 16 + (lane >> 2);      // the thread's row in the item
  const int row0 = m0 + rl, row1 = row0 + 8;
  const bool ok0 = row0 < row_end, ok1 = row1 < row_end;
  int acc[64];
  float accf[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    acc[i] = 0;
    accf[i] = 0.0f;
  }
  const int kpg = p.gsize >= K ? kt_n : p.gsize / WQ_BK_GQ;   // k-tiles a group
  // k-tile q + 1 is turned while the MMAs of q run, ahead of q's fold
  wq_turn<false, kRagged, kZp>(sm, p, q, 0, pk);
  for (int g0 = 0, grp = 0; g0 < kt_n; g0 += kpg, ++grp) {
    const int gn = min(kpg, kt_n - g0);
    int rs0 = 0, rs1 = 0;              // the zp term's row sums (32 codes a lane)
    for (int j = 0; j < gn; ++j, ++q) {
      const int sa = q % WQ_A_STAGES, sb = q % WQ_B_STAGES;
      wq_wait_full(sm, q);
      reg_fence(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < WQ_BK_GQ / 32; ++ks)
        wgmma_m64n128k32_s8(acc, smem_desc_sw128(sm.a[sa] + wg * 64 * 128 + ks * 32),
                            smem_desc_sw128(sm.b[sb] + ks * 32), j > 0 || ks > 0);
      wgmma_commit();
      reg_fence(acc);
      if constexpr (kZp) {
        // rows rl and rl + 8 of the A stage (same swizzle phase), the lane's
        // chunks 2 (lane % 4) and 2 (lane % 4) + 1
        const uint8_t* a0 = sm.a[sa] + rl * 128;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int off = ((2 * (lane & 3) + i) ^ (rl & 7)) << 4;
          const uint4 v0 = *reinterpret_cast<const uint4*>(a0 + off);
          const uint4 v1 = *reinterpret_cast<const uint4*>(a0 + 8 * 128 + off);
          rs0 = __dp4a((int)v0.x, 0x01010101, rs0);
          rs0 = __dp4a((int)v0.y, 0x01010101, rs0);
          rs0 = __dp4a((int)v0.z, 0x01010101, rs0);
          rs0 = __dp4a((int)v0.w, 0x01010101, rs0);
          rs1 = __dp4a((int)v1.x, 0x01010101, rs1);
          rs1 = __dp4a((int)v1.y, 0x01010101, rs1);
          rs1 = __dp4a((int)v1.z, 0x01010101, rs1);
          rs1 = __dp4a((int)v1.w, 0x01010101, rs1);
        }
      }
      if (j > 0) {                     // k-tile q - 1's reads are done
        wgmma_wait<1>();
        reg_fence(acc);
        wq_release(sm, q - 1, lane);
      }
      if (g0 + j + 1 < kt_n) wq_turn<false, kRagged, kZp>(sm, p, q + 1, g0 + j + 1, pk);
    }
    const float sa0 = ok0 ? __ldg(p.s_a + (size_t)row0 * G + grp) : 0.0f;
    const float sa1 = ok1 ? __ldg(p.s_a + (size_t)row1 * G + grp) : 0.0f;
    wgmma_wait<0>();
    reg_fence(acc);
    float zr0 = 0.0f, zr1 = 0.0f;
    if constexpr (kZp) {
      zr0 = __fmul_rn((float)quad_sum(rs0), sa0);
      zr1 = __fmul_rn((float)quad_sum(rs1), sa1);
    }
    // the group's s_b / zp rows ride in its last k-tile's B stage
    const float* sv = sm.s[(q - 1) % WQ_B_STAGES][0];
    const float* zv = sm.s[(q - 1) % WQ_B_STAGES][1];
#pragma unroll
    for (int j = 0; j < WQ_BN_GQ / 8; ++j) {
      const int c = 8 * j + 2 * (lane & 3);
      const float2 b = *reinterpret_cast<const float2*>(sv + c);
      float2 zb = make_float2(0.0f, 0.0f);
      if constexpr (kZp) zb = *reinterpret_cast<const float2*>(zv + c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * h;
        const float sa = h ? sa1 : sa0;
        float x = accf[i], y = accf[i + 1];
        x = __fadd_rn(x, __fmul_rn(__fmul_rn((float)acc[i], sa), b.x));
        y = __fadd_rn(y, __fmul_rn(__fmul_rn((float)acc[i + 1], sa), b.y));
        if constexpr (kZp) {
          const float zr = h ? zr1 : zr0;
          x = __fadd_rn(x, __fmul_rn(zr, zb.x));
          y = __fadd_rn(y, __fmul_rn(zr, zb.y));
        }
        accf[i] = x;
        accf[i + 1] = y;
      }
    }
    wq_release(sm, q - 1, lane);
  }
  OutT* out = static_cast<OutT*>(p.out);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h ? row1 : row0;
    if (!(h ? ok1 : ok0)) continue;
    OutT* orow = out + (size_t)row * N;
#pragma unroll
    for (int j = 0; j < WQ_BN_GQ / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane & 3);
      if (col < N) store2(orow + col, accf[4 * j + 2 * h], accf[4 * j + 2 * h + 1]);
    }
  }
  return q;
}

// The kernel. kMode: every group body A (K6 / K7), every group body B (K8,
// K9; K4f over its ragged storage), or by the group's flag (K10). Maps:
// map_a the bf16 lhs [M, K] in [128 x 64] boxes and map_wa the codes [E,
// kw, N] in [64 x 256] boxes (body A); map_aq the int8 lhs_q [M, K] in
// [128 x 128] boxes and map_wb the codes [E, K, N] in [128 x 128] boxes
// (body B; K4f: rhs_cat [R, N] in [64 x 128] boxes); map_s / map_z the scale
// / zp [E, G, N] in [256 x 1 x 1] boxes (both). kZp: body B adds the
// zero-point term (body A reads zp whenever it is not null).
template <typename OutT, int kMode, bool kPacked, bool kZp>
__global__ void __launch_bounds__(kWsThreads, 1)
gmm_wq_kernel(const __grid_constant__ CUtensorMap map_a,
              const __grid_constant__ CUtensorMap map_wa,
              const __grid_constant__ CUtensorMap map_s,
              const __grid_constant__ CUtensorMap map_z,
              const __grid_constant__ CUtensorMap map_aq,
              const __grid_constant__ CUtensorMap map_wb, const WqArgs p) {
  extern __shared__ uint8_t wq_smem_raw[];
  WqSmem& sm = *reinterpret_cast<WqSmem*>(
      (reinterpret_cast<uintptr_t>(wq_smem_raw) + 1023) & ~uintptr_t(1023));
  const int tid = threadIdx.x;
  const int K = p.K;
  const int kt_wo = K / WQ_BK_WO;                        // K % 128 == 0 (body A)
  const int kt_gq = (K + WQ_BK_GQ - 1) / WQ_BK_GQ;
  const bool has_zp = p.zp != nullptr;

  if (tid == 0) {
    for (int i = 0; i < WQ_A_STAGES; ++i) {
      mbar_init(&sm.a_full[i], 1);
      mbar_init(&sm.a_empty[i], 8);                      // the 8 consumer warps
    }
    for (int i = 0; i < WQ_RAW; ++i) {
      mbar_init(&sm.raw_full[i], 1);
      mbar_init(&sm.raw_empty[i], 8);
    }
    for (int i = 0; i < WQ_B_STAGES; ++i) {
      mbar_init(&sm.b_full[i], 8);
      mbar_init(&sm.b_empty[i], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 256) {
    // ---- producer warpgroup: its thread 0 loads by TMA, as far ahead as
    // the rings let it ----
    warpgroup_reg_dealloc<40>();
    if (tid != 256) return;
    if constexpr (wq_has_a(kMode)) {
      tma_prefetch_desc(&map_a);
      tma_prefetch_desc(&map_wa);
    }
    if constexpr (wq_has_b(kMode)) {
      tma_prefetch_desc(&map_aq);
      tma_prefetch_desc(&map_wb);
    }
    tma_prefetch_desc(&map_s);
    if (has_zp) tma_prefetch_desc(&map_z);
    const int half = K / 2;
    const uint32_t rows_bytes = (has_zp ? 2 : 1) * WQ_BN_WO * 4;
    WqWalk<kMode> ld;
    ld.begin(p);
    int q = 0;
    while (ld.next(p)) {
      const int kt_n = ld.wo() ? kt_wo : kt_gq;
      for (int kt = 0; kt < kt_n; ++kt, ++q) {
        const int sa = q % WQ_A_STAGES, r = q % WQ_RAW;
        if (q >= WQ_A_STAGES) mbar_wait(&sm.a_empty[sa], ((q / WQ_A_STAGES) - 1) & 1);
        if (q >= WQ_RAW) mbar_wait(&sm.raw_empty[r], ((q / WQ_RAW) - 1) & 1);
        mbar_arrive_expect_tx(&sm.a_full[sa], WQ_A_BYTES);
        mbar_arrive_expect_tx(&sm.raw_full[r], WQ_RAW_BYTES + rows_bytes);
        int k0;
        if (ld.wo()) {
          k0 = kt * WQ_BK_WO;
          tma_load_2d(sm.a[sa], &map_a, &sm.a_full[sa], k0, ld.m0);
          tma_load_3d(sm.raw[r], &map_wa, &sm.raw_full[r], ld.n0,
                      (kPacked && k0 >= half) ? k0 - half : k0, ld.g);
        } else {
          k0 = kt * WQ_BK_GQ;
          tma_load_2d(sm.a[sa], &map_aq, &sm.a_full[sa], k0, ld.m0);
          if constexpr (kMode == kWqGroupedRagged) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int c = k0 + h * (WQ_BK_GQ / 2);
              tma_load_2d(sm.raw[r] + h * (WQ_RAW_BYTES / 2), &map_wb, &sm.raw_full[r],
                          ld.n0, ld.cat_row0 + ((ld.pk && c >= half) ? c - half : c));
            }
          } else {
            tma_load_3d(sm.raw[r], &map_wb, &sm.raw_full[r], ld.n0, k0, ld.g);
          }
        }
        const int grp = k0 / p.gsize;
        tma_load_3d(sm.rs[r][0], &map_s, &sm.raw_full[r], ld.n0, grp, ld.g);
        if (has_zp) tma_load_3d(sm.rs[r][1], &map_z, &sm.raw_full[r], ld.n0, grp, ld.g);
      }
    }
  } else {
    // ---- consumer warpgroups: the turns, the MMAs, the folds and the
    // stores ----
    warpgroup_reg_alloc<232>();
    const int wg = tid >> 7;
    WqWalk<kMode> it;
    it.begin(p);
    int q = 0;
    while (it.next(p)) {
      const bool live = __shfl_sync(0xffffffffu, it.m0 + wg * 64 < it.row_end, 0);
      q = it.wo() ? wq_item_wo<OutT, kPacked>(sm, p, q, it.m0, it.n0, it.row_end, live)
                  : wq_item_gq<OutT, kZp, kMode == kWqGroupedRagged>(
                        sm, p, q, it.m0, it.n0, it.row_end, live, it.pk);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// body A's maps: lhs [M, K] bf16 in [128 rows x 64 k] boxes, 128-byte
// swizzle; the codes [E, kw, N] (kw = K/2 packed) in [64 rows x 256
// columns] boxes
cudaError_t wq_encode_wo(const void* lhs, const void* rhs, bool packed, int M, int K,
                         int N, int E, CUtensorMap* map_a, CUtensorMap* map_w) {
  const int kw = packed ? K / 2 : K;
  const cuuint64_t a_dim[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t a_stride[1] = {(cuuint64_t)K * 2};
  const cuuint32_t a_box[2] = {WQ_BK_WO, WQ_BM};
  const cuuint64_t w_dim[3] = {(cuuint64_t)N, (cuuint64_t)kw, (cuuint64_t)E};
  const cuuint64_t w_stride[2] = {(cuuint64_t)N, (cuuint64_t)kw * N};
  const cuuint32_t w_box[3] = {WQ_BN_WO, WQ_BK_WO, 1};
  cudaError_t e = encode_map(map_a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, lhs, a_dim,
                             a_stride, a_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return e;
  return encode_map(map_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, rhs, w_dim, w_stride, w_box,
                    CU_TENSOR_MAP_SWIZZLE_NONE);
}

// body B's maps: lhs_q [M, K] int8 in [128 x 128] boxes, 128-byte swizzle;
// the codes [E, K, N] in [128 rows x 128 columns] boxes
cudaError_t wq_encode_gq(const void* lhs_q, const void* rhs, int M, int K, int N, int E,
                         CUtensorMap* map_a, CUtensorMap* map_w) {
  const cuuint64_t a_dim[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t a_stride[1] = {(cuuint64_t)K};
  const cuuint32_t a_box[2] = {WQ_BK_GQ, WQ_BM};
  const cuuint64_t w_dim[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t w_stride[2] = {(cuuint64_t)N, (cuuint64_t)K * N};
  const cuuint32_t w_box[3] = {WQ_BN_GQ, WQ_BK_GQ, 1};
  cudaError_t e = encode_map(map_a, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, lhs_q, a_dim,
                             a_stride, a_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return e;
  return encode_map(map_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, rhs, w_dim, w_stride, w_box,
                    CU_TENSOR_MAP_SWIZZLE_NONE);
}

// body B's codes over K4f's ragged storage: rhs_cat [R, N] in [64 rows x
// 128 columns] half boxes
cudaError_t wq_encode_ragged(const void* rhs_cat, int N, int R, CUtensorMap* map_w) {
  const cuuint64_t dim[2] = {(cuuint64_t)N, (cuuint64_t)R};
  const cuuint64_t stride[1] = {(cuuint64_t)N};
  const cuuint32_t box[2] = {WQ_BN_GQ, WQ_BK_GQ / 2};
  return encode_map(map_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, rhs_cat, dim, stride, box,
                    CU_TENSOR_MAP_SWIZZLE_NONE);
}

// a [E, G, N] f32 row of scales or zero points in [256 x 1 x 1] boxes
cudaError_t wq_encode_rows(const void* rows, int N, int G, int E, CUtensorMap* map) {
  const cuuint64_t dim[3] = {(cuuint64_t)N, (cuuint64_t)G, (cuuint64_t)E};
  const cuuint64_t stride[2] = {(cuuint64_t)N * 4, (cuuint64_t)G * N * 4};
  const cuuint32_t box[3] = {WQ_BN_WO, 1, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, rows, dim, stride, box,
                    CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <typename OutT, int kMode, bool kPacked, bool kZp>
cudaError_t wq_launch_typed(const CUtensorMap* maps, const WqArgs& args, int grid,
                            cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(gmm_wq_kernel<OutT, kMode, kPacked, kZp>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       kWqSmemBytes);
  if (e != cudaSuccess) return e;
  gmm_wq_kernel<OutT, kMode, kPacked, kZp><<<grid, kWsThreads, kWqSmemBytes, st>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], args);
  return cudaGetLastError();
}

template <typename OutT, int kMode, bool kPacked>
cudaError_t wq_launch_zp(const CUtensorMap* maps, const WqArgs& args, int grid,
                         cudaStream_t st) {
  if (kMode != kWqWeightOnly && args.zp != nullptr)
    return wq_launch_typed<OutT, kMode, kPacked, kMode != kWqWeightOnly>(maps, args,
                                                                         grid, st);
  return wq_launch_typed<OutT, kMode, kPacked, false>(maps, args, grid, st);
}

// The C entry points' body at bm == WQ_BM (the schedule of
// ops/gmm_w8a8_grouped.py picks it inside the bodies' domain: N % 16 == 0,
// 16-byte aligned operands, gsize % 128 == 0 or gsize == K, and K % 128 ==
// 0 for body A and K4f). lhs (bf16) feeds body A, lhs_q / s_a body B;
// flags [E] (kWqMixed) say which body each group takes; pflags / blk and R,
// the rows of rhs_cat, K4f's storage. Every group's rows are covered by at
// most cdiv(M, 128) + E m-tiles, which bounds the grid.
template <int kMode, bool kPacked>
int gmm_wq_launch(const void* lhs, const void* lhs_q, const void* s_a, const void* rhs,
                  const void* scale, const void* zp, const void* flags,
                  const void* group_sizes, void* out, int out_is_bf16, int M, int K,
                  int N, int E, int gsize, void* stream, const void* pflags = nullptr,
                  const void* blk = nullptr, int R = 0) {
  if (E <= 0 || E > kMaxExperts || gsize <= 0 || K % gsize != 0 || N % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if ((wq_has_a(kMode) || kMode == kWqGroupedRagged) && K % (2 * WQ_BK_WO) != 0)
    return (int)cudaErrorInvalidValue;
  if (kMode == kWqGroupedRagged && R <= 0) return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaGetLastError();
  // a, wa (body A); s, z (both); aq, wb (body B); a map no body of this
  // launch reads is a copy of one it does
  CUtensorMap maps[6];
  cudaError_t e = cudaSuccess;
  e = wq_encode_rows(scale, N, K / gsize, E, &maps[2]);
  if (e == cudaSuccess && zp != nullptr) e = wq_encode_rows(zp, N, K / gsize, E, &maps[3]);
  if (e != cudaSuccess) return (int)e;
  if (zp == nullptr) maps[3] = maps[2];
  if (wq_has_a(kMode)) {
    e = wq_encode_wo(lhs, rhs, kPacked, M, K, N, E, &maps[0], &maps[1]);
    if (e != cudaSuccess) return (int)e;
  }
  if (wq_has_b(kMode)) {
    e = wq_encode_gq(lhs_q, rhs, M, K, N, kMode == kWqGroupedRagged ? 1 : E, &maps[4],
                     &maps[5]);
    if (e == cudaSuccess && kMode == kWqGroupedRagged) e = wq_encode_ragged(rhs, N, R, &maps[5]);
    if (e != cudaSuccess) return (int)e;
  }
  if (!wq_has_a(kMode)) maps[0] = maps[1] = maps[4];
  if (kMode == kWqWeightOnly) maps[4] = maps[5] = maps[0];
  const long long bn = kMode == kWqWeightOnly ? WQ_BN_WO : WQ_BN_GQ;
  const int grid = ws_grid(((long long)(M + WQ_BM - 1) / WQ_BM + E) * ((N + bn - 1) / bn));
  if (grid <= 0) return (int)cudaErrorInvalidValue;
  const WqArgs args{static_cast<const float*>(s_a), static_cast<const float*>(scale),
                    static_cast<const float*>(zp), static_cast<const int*>(flags),
                    static_cast<const int*>(group_sizes), static_cast<const int*>(pflags),
                    static_cast<const int*>(blk), out, M, K, N, E, gsize};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  e = out_is_bf16 ? wq_launch_zp<__nv_bfloat16, kMode, kPacked>(maps, args, grid, st)
                  : wq_launch_zp<float, kMode, kPacked>(maps, args, grid, st);
  return (int)e;
}

}  // namespace
