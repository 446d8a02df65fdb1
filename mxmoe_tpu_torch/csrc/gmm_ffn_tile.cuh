// The whole expert FFN in one launch, shared by K12 gmm_ffn_w8a8
// (gmm_ffn_w8a8.cu: int8 experts stacked [E, K, 2N] / [E, N, H]) and K13
// gmm_ffn_mixed_packed (gmm_ffn_mixed_packed.cu: K4's ragged buffers, each
// expert one nibble-packed K/2-row unit or two int8 units). It replaces the
// Pallas bodies of mxmoe_tpu/ops/pallas_gmm.py:gmm_ffn_w8a8 and
// gmm_ffn_mixed_packed. Per m-tile of FFN_BM = 32 expert-sorted rows of one
// expert e:
//
//   gu    = ((float)(lhs_q @ w_gu[e]) * s_a) * s_gu[e]        [32, 2N] f32
//   h     = (gate * sigmoid(gate)) * up,  sigmoid(x) = 1 / (1 + expf(-x))
//   scale = max(amax_n |h|, 1e-8) / upper,  upper = 2^(min(bits[e], 8)-1) - 1
//   hq    = rint(h / scale)                                   (int8)
//   out   = OutT( ((float)(hq @ w_d[e]) * scale) * s_d[e] )   [32, H]
//
// Every product and sum of the f32 steps is rounded on its own (__fmul_rn,
// __fdiv_rn: no FMA contraction, IEEE division), in the order the plain
// version (ops/gmm_ffn.py) writes them, and the int32 sums are exact, so
// any split of the columns, and packed or int8 storage of the same codes,
// give the same bits.
//
// Bound on the H100: the bytes of the live experts' weights (K * 2N + N * H
// int8 codes each, 8.65 MB at qwen2_moe widths; chip_smoke.py ffn_work); at
// decode ~15 experts hold the 16 routed rows, and each expert's weights are
// read by one cluster, once.
//
// Schedule: a thread block cluster of C CTAs per logical m-tile, C = 8
// (FFN_C) or, where 8 CTAs' slices do not fit, 16 (ffn_cluster below)
// (gmm_tile_walk.cuh's walk; a tile that straddles two experts is computed
// once per expert, rows masked). The grid holds the G clusters the card runs
// at once (cudaOccupancyMaxActiveClusters at this launch's shared memory;
// mxmoe_gmm_ffn_*_clusters reports it), and cluster c walks tiles c,
// c + G, ...; the live tiles come first, so the first dead one ends the
// walk (a grid of one cluster per tile slot, 118 at decode with ~13 live,
// spent a tenth of a launch queueing dead clusters). The walk reads
// blockIdx.y alone, so a cluster leaves as a whole, between its tiles.
//  1. gate_up, columns split: CTA r owns the h columns of the 16-column
//     units [r * N/16 / C, (r + 1) * N/16 / C): their gate and up
//     weight columns over all of K. Raw [64, 64] weight sub-tiles and the A rows
//     stream through a DSTAGES-deep ring of 16-byte cp.async pieces,
//     swizzled by k / 4 (d_swz, gmm_int8_tile.cuh). A warp holds up to two
//     quads; a quad is the gate and the up columns of one unit as four
//     interleaved n8 tiles: lane gr reads one 4-byte word of a weight row
//     (4 columns; lanes gr < 4 the gate unit, gr >= 4 the up unit, in
//     sub-tiles of unlike bank half), and a 4 x 4 byte transpose of four
//     rows gives the B registers of all four tiles (ffn_bquad: 4 LDS and 8
//     PRMT for four MMAs, where a per-tile gather takes 16 LDS). SwiGLU
//     pairs each gate value with its up value through one lane exchange
//     (lanes tq, tq ^ 2). A packed byte tile feeds two k-steps (A columns
//     r and K/2 + r). The CTA's h slice [32, <= 192] stays in its shared
//     memory in f32.
//  2. The down product's first weight k-tiles are put in flight, then the
//     row amax: each CTA's partial amax goes to shared memory, a cluster
//     barrier, and every CTA reads all C partials through distributed
//     shared memory (mapa + ld.shared::cluster), so every CTA forms the
//     same scale bits. Each quantizes its own slice into its copy of hq
//     [32, N] int8 and stores it into the other CTAs' copies (16-byte
//     st.shared::cluster); a second cluster barrier, after which hq is
//     whole in every CTA and no CTA touches another's shared memory (the
//     next tile's first barrier orders its stores after this tile's reads).
//     No device workspace: hq never leaves the cluster.
//  3. down, columns split: CTA r owns the output columns of the units
//     [r * H/16 / C, (r + 1) * H/16 / C), in passes of 256 (a quad a
//     warp: units a and a + 4), A = hq from its own shared memory, weights
//     through the same ring.
// Weight pieces ask the L2 for their whole 128-byte line (the CTAs of a
// cluster read neighbouring 176-byte strips of each weight row).
// A tile whose live rows fit 16 runs one m16 fragment (MI = 1), else two;
// the aligned layout's 32-row padding keeps decode tiles at two.
// Shared memory (ffn_layout): the ring region (gate_up stages, or down
// stages + hq) and the f32 h slice: 140 KB at N 1408, H 2048.
// Cluster size: 8 (the portable limit) wherever a CTA's h slice fits
// FFN_MAX_HU units (N <= 1536: qwen2_moe's and ds2's 1408 take it); 16 CTAs
// of smaller slices were slower at every shape timed there (PERF.md, "PR
// 8"). qwen2_moe_57b's N 2560 would give 8 CTAs 20 units each: the gate_up
// ring (4 x 46,720 B) and h (41,472 B) take 228,352 B of dynamic shared
// memory, and with the 4,368 B of static shared memory (sizes[kMaxExperts],
// the tile's info, partial amax and scales) a CTA would ask 232,720 B, past
// the 232,448 B a block may have; a warp would also hold three quads (a
// third acc[4][MI][4] beside the 229-235 registers a thread the body
// takes) and 10 gate_up pieces a thread instead of 6. So N past 1536 takes
// a non-portable cluster of 16 CTAs (FFN_C_WIDE), whose slices stay within
// FFN_MAX_HU (10 units at N 2560, 14 down units at H 3584: 169,984 B) and
// whose body is the same instance of every per-thread array. N past 3072
// (mixtral's 14336) is refused: the reference's VMEM check refuses it too.

#pragma once

#include "gmm_int8_tile.cuh"

namespace {

constexpr int FFN_BM = 32;                         // rows of an m-tile
constexpr int FFN_C = 8;                           // CTAs of a cluster, one m-tile
constexpr int FFN_C_WIDE = 16;                     // ... past FFN_MAX_HU units a CTA
constexpr int FFN_THREADS = 256;                   // 8 warps a CTA
constexpr int FFN_WARPS = FFN_THREADS / 32;
constexpr int FFN_UNIT = 16;                       // columns of a split unit
constexpr int FFN_GU_QUADS = 2;                    // h units (quads) a warp holds
constexpr int FFN_MAX_HU = 12;                     // h units a CTA: 192 columns
constexpr int FFN_DN_PASS = FFN_WARPS * 32;        // a down pass: 256 columns
constexpr int FFN_A_TILE = FFN_BM * A_STRIDE;      // bytes of a 32-row A k-tile
// a raw [64, 64] weight sub-tile and 64 bytes of pad: sub-tile s starts in
// bank half s & 1, so two sub-tiles of unlike parity are read conflict-free
// by the two halves of a warp
constexpr int FFN_SUB = DEC_B_TILE + 64;
constexpr int FFN_GU_PIECES =                      // gate_up B pieces a thread
    (2 * DBK * FFN_MAX_HU + FFN_THREADS - 1) / FFN_THREADS;
constexpr int FFN_DN_PIECES = DBK * (FFN_DN_PASS / FFN_UNIT) / FFN_THREADS;
constexpr int FFN_H_PAD = 4;                       // f32 pad of an h row

enum FfnStorage { kFfnStacked = 0, kFfnRagged = 1 };

// one GEMM's weights for the tile's expert: its storage block, the bytes
// of a storage row, and whether it is nibble-packed (K/2 rows, halves layout)
struct FfnWeights {
  const int8_t* w;
  int ld;
  bool packed;
};

// The cluster size of widths N: FFN_C while a CTA's h slice fits
// FFN_MAX_HU units, else FFN_C_WIDE if it fits there, else 0 (refused).
__host__ __device__ inline int ffn_cluster(int N) {
  const int nu = N / FFN_UNIT;
  if ((nu + FFN_C - 1) / FFN_C <= FFN_MAX_HU) return FFN_C;
  if ((nu + FFN_C_WIDE - 1) / FFN_C_WIDE <= FFN_MAX_HU) return FFN_C_WIDE;
  return 0;
}

// The dynamic shared memory of a launch over clusters of C CTAs, in bytes:
// the ring region holds DSTAGES gate_up stages (A low / high halves, then
// the gate and the up sub-tiles), or, from the end of gate_up on, DSTAGES
// down stages and hq [32, N + 16] behind them; h [32, hss] f32 follows.
// bytes = -1 when a CTA's h slice would exceed FFN_MAX_HU units.
struct FfnLayout {
  int gsub;       // sub-tiles of the gate part of a stage (= up part), odd
  int gu_stage;   // bytes of a gate_up stage
  int dn_stage;   // bytes of a down stage
  int hqs;        // row stride of hq
  int hq_off;     // offset of hq
  int hs_off;     // offset of h
  int hss;        // f32 row stride of h
  int bytes;
};

__host__ __device__ inline FfnLayout ffn_layout(int N, int H, int C) {
  FfnLayout L;
  if (C < 1) C = FFN_C_WIDE;                             // refused below
  const int hu = (N / FFN_UNIT + C - 1) / C;                           // most h units
  const int du = ((H + FFN_UNIT - 1) / FFN_UNIT + C - 1) / C;          // and down units
  const int dw = du * FFN_UNIT < FFN_DN_PASS ? du * FFN_UNIT : FFN_DN_PASS;
  L.gsub = (hu * FFN_UNIT + DBN - 1) / DBN | 1;          // odd: up unlike gate
  L.gu_stage = 2 * FFN_A_TILE + 2 * L.gsub * FFN_SUB;
  L.dn_stage = (dw + DBN - 1) / DBN * FFN_SUB;
  L.hqs = N + 16;
  L.hq_off = DSTAGES * L.dn_stage;
  const int dn_end = L.hq_off + FFN_BM * L.hqs, gu_end = DSTAGES * L.gu_stage;
  L.hs_off = ((dn_end > gu_end ? dn_end : gu_end) + 15) / 16 * 16;
  L.hss = hu * FFN_UNIT + FFN_H_PAD;
  L.bytes = hu > FFN_MAX_HU ? -1 : L.hs_off + FFN_BM * L.hss * 4;
  return L;
}

// --- thread block cluster: rank, barrier, distributed shared memory ---

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every CTA of the cluster arrives (release), then waits
// (acquire)
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n"
               "barrier.cluster.wait.aligned;\n" ::: "memory");
}

// the address of `p` (this CTA's shared memory) in CTA `rank`'s
__device__ __forceinline__ unsigned dsmem_addr(const void* p, unsigned rank) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}
__device__ __forceinline__ float dsmem_f32(unsigned a) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ void dsmem_st_v4(unsigned a, int4 v) {
  asm volatile("st.shared::cluster.v4.s32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(a), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}

__device__ __forceinline__ float sigmoid_rn(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// four k-rows of a lane's word (rows p, p + 64, p + 128, p + 192 of a raw
// sub-tile: 4 columns each) -> the B registers of the four interleaved n8
// tiles: b[m] holds column m of the word for the four rows (byte j = row j)
__device__ __forceinline__ void ffn_bquad(const int8_t* p, uint32_t (&b)[4]) {
  const uint32_t w0 = *reinterpret_cast<const uint32_t*>(p);
  const uint32_t w1 = *reinterpret_cast<const uint32_t*>(p + DBN);
  const uint32_t w2 = *reinterpret_cast<const uint32_t*>(p + 2 * DBN);
  const uint32_t w3 = *reinterpret_cast<const uint32_t*>(p + 3 * DBN);
  const uint32_t t0 = __byte_perm(w0, w1, 0x5140), t1 = __byte_perm(w2, w3, 0x5140);
  const uint32_t t2 = __byte_perm(w0, w1, 0x7362), t3 = __byte_perm(w2, w3, 0x7362);
  b[0] = __byte_perm(t0, t1, 0x5410);
  b[1] = __byte_perm(t0, t1, 0x7632);
  b[2] = __byte_perm(t2, t3, 0x5410);
  b[3] = __byte_perm(t2, t3, 0x7632);
}

__device__ __forceinline__ uint32_t nib_lo(uint32_t b) { return sext4(b & 0x0F0F0F0Fu); }
__device__ __forceinline__ uint32_t nib_hi(uint32_t b) {
  return sext4((b >> 4) & 0x0F0F0F0Fu);
}

// One k-tile of a warp's quads. A quad is four n8 tiles whose column n of
// tile m is, for n < 4, column 4 n + m of the 16-column unit the lanes
// gr < 4 read, else column 4 (n - 4) + m of the unit the lanes gr >= 4
// read; boff[q] is this lane's byte offset of quad q's word in row 4 tq of
// the stage's B area (rows + 16 and + 32 follow at fixed offsets). A from
// At (row stride lda; with kPacked the high-nibble k-step's A from AtHi),
// MI m16 fragments from row rb. Quads q < nq (warp-uniform) take part.
template <bool kPacked, int MI, int kQ>
__device__ __forceinline__ void ffn_quad_ktile(const int8_t* At, const int8_t* AtHi,
                                               int lda, const int8_t* Bst,
                                               const int (&boff)[kQ], int nq, int rb,
                                               int (&acc)[kQ][4][MI][4], int gr, int tq) {
#pragma unroll
  for (int ks = 0; ks < DBK; ks += 32) {
    uint32_t a[MI][4], ah[MI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      d_afrag(At + (rb + 16 * i) * lda, lda, ks, gr, tq, a[i]);
      if constexpr (kPacked) d_afrag(AtHi + (rb + 16 * i) * lda, lda, ks, gr, tq, ah[i]);
    }
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      if (q >= nq) break;
      uint32_t b0[4], b1[4];
      ffn_bquad(Bst + boff[q] + ks * DBN, b0);
      ffn_bquad(Bst + boff[q] + (ks + 16) * DBN, b1);
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          if constexpr (kPacked) {
            mma_s8(acc[q][m][i], a[i], nib_lo(b0[m]), nib_lo(b1[m]));
            mma_s8(acc[q][m][i], ah[i], nib_hi(b0[m]), nib_hi(b1[m]));
          } else {
            mma_s8(acc[q][m][i], a[i], b0[m], b1[m]);
          }
        }
    }
  }
}

// warp 0 of the CTA: logical tile t -> info (find_tile's result, info[1]
// the tile's first row), by prefix sums over 32 experts at a time: a cluster
// walks its tiles one after another, and the serial walk of one thread sat
// on that path once per tile
template <int kBM>
__device__ __forceinline__ void find_tile_warp(const int* sizes, int E, int M, int t,
                                               int* info, int lane) {
  int start = 0, tiles = 0;                // rows and tiles before this chunk
  if (lane == 0) info[0] = -1;
  __syncwarp();
  for (int g0 = 0; g0 < E; g0 += 32) {
    const int g = g0 + lane, s = g < E ? sizes[g] : 0;
    int ps = s;                            // inclusive scans: rows, tiles
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, ps, off);
      if (lane >= off) ps += v;
    }
    const int st = start + ps - s;
    const int n = s > 0 ? (st + s - 1) / kBM - st / kBM + 1 : 0;
    int pn = n;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, pn, off);
      if (lane >= off) pn += v;
    }
    const int t0 = tiles + pn - n;
    const bool hit = n > 0 && t >= t0 && t < t0 + n;
    if (hit) {
      info[0] = g;
      info[1] = (st / kBM + t - t0) * kBM;
      info[2] = st;
      info[3] = min(st + s, M);
    }
    if (__any_sync(0xffffffffu, hit)) break;
    start += __shfl_sync(0xffffffffu, ps, 31);
    tiles += __shfl_sync(0xffffffffu, pn, 31);
  }
}

// the FFN of one m-tile on one CTA of its cluster of kC; MI m16 fragments
// from tile row rb hold every live row. Every thread of the cluster calls it.
template <int MI, int kC, typename OutT>
__device__ __forceinline__ void ffn_tile(
    int8_t* smem, const FfnLayout& L, float* part_amax, float* row_scale,
    const int8_t* __restrict__ lhs, const float* __restrict__ s_a, FfnWeights wgu,
    const float* __restrict__ sgu, FfnWeights wd, const float* __restrict__ sd,
    float upper, OutT* __restrict__ out, int m0, int row_lo, int row_hi, int rb,
    int K, int N, int H) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const unsigned rank = cluster_rank();
  const int NU = N / FFN_UNIT, HU = (H + FFN_UNIT - 1) / FFN_UNIT;
  const int u0 = rank * NU / kC, hu = (rank + 1) * NU / kC - u0;
  const int hw = hu * FFN_UNIT, gc0 = u0 * FFN_UNIT;   // h columns [gc0, gc0 + hw)
  const int d0 = rank * HU / kC * FFN_UNIT;            // out columns [d0, d1)
  const int d1 = min((int)(rank + 1) * HU / kC * FFN_UNIT, H);
  int8_t* hq = smem + L.hq_off;
  float* hs = reinterpret_cast<float*>(smem + L.hs_off);

  // ---- 1. gate_up -> h[:, gc0 : gc0 + hw) ----
  const int K2 = K / 2, Kw = wgu.packed ? K2 : K;
  const int gk = (Kw + DBK - 1) / DBK;
  // this thread's weight pieces of a k-tile: row, stage offset, source offset
  int grow[FFN_GU_PIECES], gdst[FFN_GU_PIECES], gsrc[FFN_GU_PIECES];
#pragma unroll
  for (int i = 0; i < FFN_GU_PIECES; ++i) {
    const int u = tid + i * FFN_THREADS;
    grow[i] = -1;
    gdst[i] = gsrc[i] = 0;
    if (u < 2 * DBK * hu) {
      const int half = u / (DBK * hu), rem = u - half * DBK * hu;
      const int r = rem / hu, cc = rem - r * hu;
      grow[i] = r;
      gdst[i] = 2 * FFN_A_TILE + (half * L.gsub + (cc >> 2)) * FFN_SUB + d_swz(r, cc & 3);
      gsrc[i] = r * wgu.ld + half * N + gc0 + cc * FFN_UNIT;
    }
  }
  // k-tile t -> ring stage t % DSTAGES (one commit group)
  auto issue_gu = [&](int t) {
    if (t < gk) {
      int8_t* st = smem + (t % DSTAGES) * L.gu_stage;
      const int k0 = t * DBK;
      if (tid < (wgu.packed ? 2 : 1) * FFN_BM * 4) {   // A: 32 rows x 4 pieces (x 2)
        const int half = tid >> 7, c = tid & 127;
        const int row = m0 + (c >> 2), k = k0 + (c & 3) * 16;
        const bool live = row >= row_lo && row < row_hi && k < Kw;
        cp_async16(st + half * FFN_A_TILE + (c >> 2) * A_STRIDE + (c & 3) * 16,
                   live ? lhs + (size_t)row * K + half * K2 + k : lhs, live ? 16 : 0);
      }
      const int8_t* wk = wgu.w + (size_t)k0 * wgu.ld;
#pragma unroll
      for (int i = 0; i < FFN_GU_PIECES; ++i) {
        if (grow[i] >= 0) {
          const bool ok = k0 + grow[i] < Kw;
          cp_async16_l2(st + gdst[i], ok ? wk + gsrc[i] : wgu.w, ok ? 16 : 0);
        }
      }
    }
    cp_async_commit();
  };
  if (hw > 0) {
#pragma unroll
    for (int t = 0; t < DSTAGES - 1; ++t) issue_gu(t);
  }

  // the warp's quads: h units warp and warp + 8 (gate unit, lanes gr < 4;
  // the same unit of up, gr >= 4). After the exchange with lane tq ^ 2, lane
  // tq holds h column 16 u + 4 hn + m of tile m, hn = 2 (tq & 1) + (tq >> 1);
  // its scales and the rows' s_a are read now, ahead of their use
  const int gq = warp < hu ? (warp + FFN_WARPS < hu ? 2 : 1) : 0;
  const int hn = 2 * (tq & 1) + (tq >> 1);
  int gboff[FFN_GU_QUADS];
  float4 gsc[FFN_GU_QUADS], usc[FFN_GU_QUADS];
#pragma unroll
  for (int q = 0; q < FFN_GU_QUADS; ++q) {
    const int u = warp + FFN_WARPS * q;
    gboff[q] = ((gr < 4 ? 0 : L.gsub) + (u >> 2)) * FFN_SUB + d_swz(4 * tq, u & 3)
               + 4 * (gr & 3);
    const int c = gc0 + 16 * u + 4 * hn;
    gsc[q] = q < gq ? *reinterpret_cast<const float4*>(sgu + c) : make_float4(0, 0, 0, 0);
    usc[q] = q < gq ? *reinterpret_cast<const float4*>(sgu + N + c)
                    : make_float4(0, 0, 0, 0);
  }
  float sa[MI][2];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + rb + 16 * i + gr + 8 * hh;
      sa[i][hh] = (row >= row_lo && row < row_hi) ? s_a[row] : 0.f;
    }

  int acc[FFN_GU_QUADS][4][MI][4];
#pragma unroll
  for (int q = 0; q < FFN_GU_QUADS; ++q)
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[q][m][i][c] = 0;
  if (hw > 0) {
    for (int t = 0; t < gk; ++t) {
      cp_async_wait<DSTAGES - 2>();
      __syncthreads();                    // tile t landed; stage t-1 is free
      issue_gu(t + DSTAGES - 1);
      const int8_t* st = smem + (t % DSTAGES) * L.gu_stage;
      if (wgu.packed)
        ffn_quad_ktile<true, MI>(st, st + FFN_A_TILE, A_STRIDE, st + 2 * FFN_A_TILE,
                                 gboff, gq, rb, acc, gr, tq);
      else
        ffn_quad_ktile<false, MI>(st, st, A_STRIDE, st + 2 * FFN_A_TILE, gboff, gq, rb,
                                  acc, gr, tq);
    }
    cp_async_wait<0>();
    __syncthreads();                      // the ring is free
  }

  // ---- the down weights' first k-tiles, in flight from here on ----
  const int Nw = wd.packed ? N / 2 : N;
  const int dk = (Nw + DBK - 1) / DBK;
  const bool al16 = wd.ld % 16 == 0;      // H % 16: whole 16-byte pieces
  int drow[FFN_DN_PIECES], ddst[FFN_DN_PIECES], dcol[FFN_DN_PIECES];
  auto setup_dn = [&](int pc) {           // the pieces of the pass from column pc
    const int pu = (min(pc + FFN_DN_PASS, d1) - pc + FFN_UNIT - 1) / FFN_UNIT;
#pragma unroll
    for (int i = 0; i < FFN_DN_PIECES; ++i) {
      const int u = tid + i * FFN_THREADS;
      drow[i] = -1;
      ddst[i] = dcol[i] = 0;
      if (u < DBK * pu) {
        const int r = u / pu, cc = u - r * pu;
        drow[i] = r;
        ddst[i] = (cc >> 2) * FFN_SUB + d_swz(r, cc & 3);
        dcol[i] = pc + cc * FFN_UNIT;
      }
    }
  };
  auto issue_dn = [&](int t) {
    if (t < dk) {
      int8_t* st = smem + (t % DSTAGES) * L.dn_stage;
      const int k0 = t * DBK;
#pragma unroll
      for (int i = 0; i < FFN_DN_PIECES; ++i) {
        if (drow[i] >= 0) {
          const bool ok = k0 + drow[i] < Nw;
          const int8_t* src = wd.w + (size_t)(k0 + drow[i]) * wd.ld + dcol[i];
          if (al16) {
            cp_async16_l2(st + ddst[i], ok ? src : wd.w, ok ? 16 : 0);
          } else {                        // 4-byte pieces up to column d1
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const bool okj = ok && dcol[i] + 4 * j < d1;
              cp_async4_zfill(st + ddst[i] + 4 * j, okj ? src + 4 * j : wd.w,
                              okj ? 4 : 0);
            }
          }
        }
      }
    }
    cp_async_commit();
  };
  if (d0 < d1) {
    setup_dn(d0);
#pragma unroll
    for (int t = 0; t < DSTAGES - 1; ++t) issue_dn(t);
  }

  // ---- 2. SwiGLU, row amax over the cluster, hq ----
  // lane tq < 2 holds gate values, tq ^ 2 the up values of the same columns
  // (its value v = tq >> 1 of each pair is the one this lane turns into h)
#pragma unroll
  for (int q = 0; q < FFN_GU_QUADS; ++q) {
    if (q >= gq) break;
    const int col = 16 * (warp + FFN_WARPS * q) + 4 * hn;
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float hv[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int* a = acc[q][m][i];
          const int mine = tq < 2 ? a[2 * hh] : a[2 * hh + 1];
          const int theirs = __shfl_xor_sync(0xffffffffu, tq < 2 ? a[2 * hh + 1]
                                                                 : a[2 * hh], 2);
          const float sg = (&gsc[q].x)[m], su = (&usc[q].x)[m];
          const float gt = (float)(tq < 2 ? mine : theirs) * sa[i][hh] * sg;
          const float up = (float)(tq < 2 ? theirs : mine) * sa[i][hh] * su;
          hv[m] = __fmul_rn(__fmul_rn(gt, sigmoid_rn(gt)), up);
        }
        *reinterpret_cast<float4*>(hs + (rb + 16 * i + gr + 8 * hh) * L.hss + col) =
            make_float4(hv[0], hv[1], hv[2], hv[3]);
      }
  }
  __syncthreads();
  for (int r = rb + warp; r < rb + 16 * MI; r += FFN_WARPS) {
    float amax = 0.f;
    for (int c = lane; c < hw; c += 32) amax = fmaxf(amax, fabsf(hs[r * L.hss + c]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    if (lane == 0) part_amax[r] = amax;
  }
  cluster_sync();                         // 1: every CTA's partial amax is in place
  if (tid < 16 * MI) {
    const int r = rb + tid;
    float amax = 0.f;
#pragma unroll
    for (int q = 0; q < kC; ++q)
      amax = fmaxf(amax, dsmem_f32(dsmem_addr(part_amax + r, q)));
    row_scale[r] = __fdiv_rn(fmaxf(amax, 1e-8f), upper);
  }
  __syncthreads();
  {
    const int w4 = hw / 4;
    for (int idx = tid; idx < 16 * MI * w4; idx += FFN_THREADS) {
      const int rr = idx / w4, r = rb + rr, c = (idx - rr * w4) * 4;
      const float s = row_scale[r];
      const float4 x = *reinterpret_cast<const float4*>(hs + r * L.hss + c);
      const uint32_t wq = ((uint32_t)((int)rintf(__fdiv_rn(x.x, s)) & 0xFF))
                          | ((uint32_t)((int)rintf(__fdiv_rn(x.y, s)) & 0xFF) << 8)
                          | ((uint32_t)((int)rintf(__fdiv_rn(x.z, s)) & 0xFF) << 16)
                          | ((uint32_t)((int)rintf(__fdiv_rn(x.w, s)) & 0xFF) << 24);
      *reinterpret_cast<uint32_t*>(hq + r * L.hqs + gc0 + c) = wq;
    }
  }
  __syncthreads();                        // this CTA's codes in place
  // ... and into the other CTAs' hq: 16-byte stores to their shared memory
  {
    const int nl = 16 * MI * hu;          // 16-byte pieces of the slice
    for (int idx = tid; idx < nl * (kC - 1); idx += FFN_THREADS) {
      const int p = idx / nl, pi = idx - p * nl, rr = pi / hu;
      const int off = (rb + rr) * L.hqs + gc0 + (pi - rr * hu) * FFN_UNIT;
      dsmem_st_v4(dsmem_addr(hq + off, (rank + 1 + p) % kC),
                  *reinterpret_cast<const int4*>(hq + off));
    }
  }
  cluster_sync();                         // 2: hq whole in every CTA; from here
                                          // on no CTA touches another's memory

  // ---- 3. down -> out[:, d0 : d1), (acc * scale) * s_d ----
  // the warp's quad: units a (lanes gr < 4) and a + 4 (gr >= 4) of the pass,
  // a = (warp & 3) + 8 (warp >> 2); lane tq holds, for v = 0, 1, the output
  // columns 16 ua + 4 ((2 tq + v) & 3) + m of tile m, ua = tq < 2 ? a : a + 4
  const int da = (warp & 3) + 8 * (warp >> 2);
  const int dua = tq < 2 ? da : da + 4;
  int dboff[1] = {((da + (gr < 4 ? 0 : 4)) >> 2) * FFN_SUB + d_swz(4 * tq, da & 3)
                  + 4 * (gr & 3)};
  for (int pc = d0; pc < d1; pc += FFN_DN_PASS) {
    const int pw = min(FFN_DN_PASS, d1 - pc);
    const int dq = 16 * da < pw ? 1 : 0;
    float4 dsc[2];
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int c = pc + 16 * dua + 4 * ((2 * tq + v) & 3);
      dsc[v] = c < d1 ? *reinterpret_cast<const float4*>(sd + c) : make_float4(0, 0, 0, 0);
    }
    int acc2[1][4][MI][4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc2[0][m][i][c] = 0;
    for (int t = 0; t < dk; ++t) {
      cp_async_wait<DSTAGES - 2>();
      __syncthreads();
      issue_dn(t + DSTAGES - 1);
      const int8_t* st = smem + (t % DSTAGES) * L.dn_stage;
      if (wd.packed)
        ffn_quad_ktile<true, MI>(hq + t * DBK, hq + Nw + t * DBK, L.hqs, st, dboff, dq,
                                 rb, acc2, gr, tq);
      else
        ffn_quad_ktile<false, MI>(hq + t * DBK, hq, L.hqs, st, dboff, dq, rb, acc2, gr,
                                  tq);
    }
    cp_async_wait<0>();
    __syncthreads();                      // the ring is free: the next pass's loads
    if (pc + FFN_DN_PASS < d1) {
      setup_dn(pc + FFN_DN_PASS);
#pragma unroll
      for (int t = 0; t < DSTAGES - 1; ++t) issue_dn(t);
    }
    if (!dq) continue;
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int col = pc + 16 * dua + 4 * ((2 * tq + v) & 3);
      if (col >= d1) continue;
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = rb + 16 * i + gr + 8 * hh, row = m0 + r;
          if (row < row_lo || row >= row_hi) continue;
          const float sh = row_scale[r];
          float y[4];
#pragma unroll
          for (int m = 0; m < 4; ++m)
            y[m] = (float)acc2[0][m][i][2 * hh + v] * sh * (&dsc[v].x)[m];
          OutT* o = out + (size_t)row * H + col;
          store2(o, y[0], y[1]);
          store2(o + 2, y[2], y[3]);
        }
    }
  }
}

template <typename OutT, int kStorage, int kC>
__global__ void __launch_bounds__(FFN_THREADS, 1)
gmm_ffn_kernel(const int8_t* __restrict__ lhs, const float* __restrict__ s_a,
               const int8_t* __restrict__ gu, const float* __restrict__ s_gu,
               const int* __restrict__ gu_pf, const int* __restrict__ gu_blk,
               const int8_t* __restrict__ dn, const float* __restrict__ s_d,
               const int* __restrict__ d_pf, const int* __restrict__ d_blk,
               const int* __restrict__ group_sizes, const int* __restrict__ abits,
               OutT* __restrict__ out, int M, int K, int N, int H, int E) {
  extern __shared__ __align__(16) int8_t smem[];
  __shared__ int sizes[kMaxExperts];
  __shared__ int info[4];                  // expert, first row, row begin, end
  __shared__ float part_amax[FFN_BM];
  __shared__ float row_scale[FFN_BM];

  const int tid = threadIdx.x;
  const FfnLayout L = ffn_layout(N, H, kC);
  for (int e = tid; e < E; e += FFN_THREADS) sizes[e] = group_sizes[e];
  // the cluster's logical m-tiles blockIdx.y, + gridDim.y, ...: the live
  // tiles come first, so the first dead one ends the walk (of the whole
  // cluster: the walk reads blockIdx.y alone)
  for (int t = blockIdx.y;; t += gridDim.y) {
    __syncthreads();                       // sizes in place; info read by all
    if (tid < 32) find_tile_warp<FFN_BM>(sizes, E, M, t, info, tid);
    __syncthreads();
    const int g = info[0], m0 = info[1], row_lo = info[2], row_hi = info[3];
    if (g < 0 || m0 >= row_hi) return;

    FfnWeights wgu, wd;
    if constexpr (kStorage == kFfnStacked) {
      wgu = {gu + (size_t)g * K * 2 * N, 2 * N, false};
      wd = {dn + (size_t)g * N * H, H, false};
    } else {
      wgu = {gu + (size_t)gu_blk[g] * (K / 2) * 2 * N, 2 * N, gu_pf[g] != 0};
      wd = {dn + (size_t)d_blk[g] * (N / 2) * H, H, d_pf[g] != 0};
    }
    const float upper = (float)((1 << (min(abits[g], 8) - 1)) - 1);
    const float* sgu = s_gu + (size_t)g * 2 * N;
    const float* sd = s_d + (size_t)g * H;
    // the tile's live rows [lo, hi): one m16 fragment from row rb when they fit
    const int lo = max(row_lo, m0) - m0, hi = min(row_hi, m0 + FFN_BM) - m0;
    if (hi - lo <= 16)
      ffn_tile<1, kC>(smem, L, part_amax, row_scale, lhs, s_a, wgu, sgu, wd, sd, upper,
                      out, m0, row_lo, row_hi, min(lo, 16), K, N, H);
    else
      ffn_tile<2, kC>(smem, L, part_amax, row_scale, lhs, s_a, wgu, sgu, wd, sd, upper,
                      out, m0, row_lo, row_hi, 0, K, N, H);
  }
}

// The launch configuration of layout L (a cluster of kC CTAs, its shared
// memory) and G, the clusters the card runs at once at that shared memory
// (asked once per size). A cluster past 8 CTAs is non-portable: the kernel
// is allowed it first.
template <typename OutT, int kStorage, int kC>
cudaError_t ffn_config(const FfnLayout& L, cudaLaunchConfig_t& cfg,
                       cudaLaunchAttribute (&attr)[1], int& resident) {
  auto kernel = gmm_ffn_kernel<OutT, kStorage, kC>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       L.bytes);
  if (e != cudaSuccess) return e;
  if (kC > 8) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cfg = {};
  cfg.blockDim = dim3(FFN_THREADS, 1, 1);
  cfg.dynamicSmemBytes = L.bytes;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  static int cached = 0, cached_bytes = -1;
  if (cached_bytes != L.bytes) {
    cfg.gridDim = dim3(kC, 1, 1);
    e = cudaOccupancyMaxActiveClusters(&cached, kernel, &cfg);
    if (e != cudaSuccess) return e;
    if (cached < 1) return cudaErrorInvalidConfiguration;
    cached_bytes = L.bytes;
  }
  resident = cached;
  return cudaSuccess;
}

template <typename OutT, int kStorage, int kC>
cudaError_t launch_ffn(const int8_t* lhs, const float* s_a, const int8_t* gu,
                       const float* s_gu, const int* gu_pf, const int* gu_blk,
                       const int8_t* dn, const float* s_d, const int* d_pf,
                       const int* d_blk, const int* gs, const int* abits, void* out,
                       int M, int K, int N, int H, int E, cudaStream_t st) {
  const FfnLayout L = ffn_layout(N, H, kC);
  if (L.bytes < 0) return cudaErrorInvalidValue;
  if (M > 0) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    int resident = 0;
    cudaError_t e = ffn_config<OutT, kStorage, kC>(L, cfg, attr, resident);
    if (e != cudaSuccess) return e;
    // at most one cluster per logical m-tile
    const int tiles = (M + FFN_BM - 1) / FFN_BM + E - 1;
    cfg.gridDim = dim3(kC, tiles < resident ? tiles : resident, 1);
    cfg.stream = st;
    e = cudaLaunchKernelEx(&cfg, gmm_ffn_kernel<OutT, kStorage, kC>, lhs, s_a, gu, s_gu,
                           gu_pf, gu_blk, dn, s_d, d_pf, d_blk, gs, abits,
                           static_cast<OutT*>(out), M, K, N, H, E);
    if (e != cudaSuccess) return e;
  }
  return cudaGetLastError();
}

// dynamic shared bytes of a launch; -1 when the widths do not fit the layout
inline int ffn_smem_bytes(int N, int H) { return ffn_layout(N, H, ffn_cluster(N)).bytes; }

// G of a bf16-out launch at widths N, H (the grid's clusters), or -(the
// CUDA error)
template <int kStorage, int kC>
int gmm_ffn_clusters_c(int N, int H) {
  const FfnLayout L = ffn_layout(N, H, kC);
  if (L.bytes < 0) return -(int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int resident = 0;
  const cudaError_t e = ffn_config<__nv_bfloat16, kStorage, kC>(L, cfg, attr, resident);
  return e == cudaSuccess ? resident : -(int)e;
}

template <int kStorage>
int gmm_ffn_clusters(int N, int H) {
  const int C = ffn_cluster(N);
  if (C == FFN_C) return gmm_ffn_clusters_c<kStorage, FFN_C>(N, H);
  if (C == FFN_C_WIDE) return gmm_ffn_clusters_c<kStorage, FFN_C_WIDE>(N, H);
  return -(int)cudaErrorInvalidValue;
}

// the C entry points' common body; the pf / blk pointers are null for the
// stacked storage
template <int kStorage>
int gmm_ffn_launch(const void* lhs, const void* s_a, const void* gu,
                   const void* s_gu, const void* gu_pf, const void* gu_blk,
                   const void* dn, const void* s_d, const void* d_pf,
                   const void* d_blk, const void* group_sizes, const void* abits,
                   void* out, int out_is_bf16, int M, int K, int N, int H, int E,
                   void* stream) {
  auto i8 = [](const void* p) { return static_cast<const int8_t*>(p); };
  auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  auto i32 = [](const void* p) { return static_cast<const int*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FFN_LAUNCH(T, CS)                                                             \
  launch_ffn<T, kStorage, CS>(i8(lhs), f32(s_a), i8(gu), f32(s_gu), i32(gu_pf),        \
                              i32(gu_blk), i8(dn), f32(s_d), i32(d_pf), i32(d_blk),   \
                              i32(group_sizes), i32(abits), out, M, K, N, H, E, st)
  const int C = ffn_cluster(N);
  cudaError_t e = cudaErrorInvalidValue;
  if (C == FFN_C)
    e = out_is_bf16 ? FFN_LAUNCH(__nv_bfloat16, FFN_C) : FFN_LAUNCH(float, FFN_C);
  else if (C == FFN_C_WIDE)
    e = out_is_bf16 ? FFN_LAUNCH(__nv_bfloat16, FFN_C_WIDE)
                    : FFN_LAUNCH(float, FFN_C_WIDE);
#undef FFN_LAUNCH
  return (int)e;
}

}  // namespace
