// Device code shared by the int8 grouped GEMMs over expert-sorted rows:
// K2 gmm_w8a8 (gmm_w8a8.cu), K4 gmm_mixed_packed (gmm_mixed_packed.cu),
// K5 gmm_w4a8_packed (gmm_w4a8_packed.cu) and K9 gmm_w8a8_asym
// (gmm_w8a8_asym.cu). One templated kernel; a template parameter says how
// an expert's weights are stored:
//
//   kInt8Stacked    rhs [E, K, N] int8; expert g at g * K * N
//   kPackedStacked  rhs [E, K/2, N] bytes, every expert nibble-packed
//   kRaggedMixed    rhs [R, N] bytes; expert g starts at row
//                   blk_offsets[g] * K/2 and holds K/2 nibble-packed rows
//                   (pflags[g] != 0) or K int8 rows
//
// A nibble-packed block uses the halves layout: byte row r holds code k = r
// in the low nibble and code k = r + K/2 in the high nibble, both signed
// 4-bit. A loaded [BK, BN] byte tile therefore feeds TWO MMA k-steps,
// against lhs columns [r0, r0 + BK) and [K/2 + r0, K/2 + r0 + BK). The
// int32 accumulation is exact, so the order of the k-steps is free and all
// three storages give bitwise the same output for the same codes.
//
//   out[r, n] = OutT( (float)(sum_k lhs[r,k] * w[e,k,n]) * s_a[r] * s_b[e,n] )
//
// and with kAsym (asymmetric weights in re-centred signed storage, w = q *
// s_b + zp) the zero-point term from the int32 row sums of the activations:
//
//   out[r, n] = OutT( that + (float)(sum_k lhs[r,k]) * s_a[r] * zp[e,n] )
//
// The row sums come from the A fragments the MMAs already hold (dp4a
// against ones, then a sum over the four lanes that share a row). The
// grouped-scale GEMM K8 (gmm_w8a8_grouped.cu) reuses the tiles and
// mma_k_tile_rs below with its own kernel.
//
// Two schedules, chosen by the wrapper from M (ops/gmm_w8a8.py::
// int8_gmm_schedule, which the host knows without a sync); above the
// decode rows K2 and K5 take a third body instead, gmm_ws_body.cuh's:
//
// * Prefill (bm = 64; gmm_tile_walk.cuh). Rows outside the block's expert
//   are zero-filled on load and masked on store. mma.sync m16n8k32
//   s8.s8.s32: 4 warps, a 64 x 128 block tile, 32 x 64 per warp; K in steps
//   of 64. The [K, N] weight tile is transposed in registers (byte_perm 4x4)
//   into a K-contiguous shared layout that the col-major B fragment reads
//   conflict-free; the next k-tile's global loads are started into
//   registers before the current tile's MMAs.
// * Decode (bm = 16, small M). At decode 16 routed rows spread over ~15
//   experts, so a 64-row tile held 1-2 real rows, and the one-group shared
//   expert's 88 / 16 column blocks filled few of the 132 SMs, each with one
//   8 KB k-tile in flight. Here a block is one m16 row block x 64 columns
//   (4 warps x 16 columns); the grid's m dimension is bounded by M itself
//   (every live m-tile holds a row). Raw [64, 64] weight tiles and the A
//   rows go through a DSTAGES-deep ring with 16-byte cp.async (rows outside
//   the expert and k past the storage zero-filled), so three k-tiles are in
//   flight a block; the weight tile is stored with its 16-byte pieces
//   swizzled by k / 4, and the B fragment is gathered from it at the shared
//   -> register step (four 32-bit loads and three byte_perm a register),
//   conflict-free. When the grid would put fewer than about two blocks on
//   each SM, K is split (grid.z, whole k-tiles each): every split writes its
//   int32 partial (and the row sums) to a workspace and the last block of
//   the tile, found by an atomic ticket, adds them in split order and runs
//   the unchanged epilogue. int32 sums are exact, so the output is bitwise
//   that of one pass. K14's decode body is this kernel with bf16 / f32
//   activations (InT), quantized in the block.

#pragma once

#include <type_traits>

#include "cp_async.cuh"
#include "gmm_tile_walk.cuh"

namespace {

constexpr int BM = 64, BN = 128, BK = 64;
constexpr int A_STRIDE = BK + 16;       // bytes per A row in shared memory
constexpr int B_STRIDE = BK / 4 + 4;    // 32-bit words per B column
constexpr int A_TILE = BM * A_STRIDE;   // bytes
constexpr int B_TILE = BN * B_STRIDE;   // 32-bit words

enum Storage { kInt8Stacked = 0, kRaggedMixed = 1, kPackedStacked = 2 };

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 4(k) x 4(n) byte unit in registers -> four K-contiguous words of B
__device__ __forceinline__ void store_b_unit(uint32_t* bcol,
                                             const uint32_t (&r)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  bcol[0 * B_STRIDE] = __byte_perm(t0, t1, 0x5410);
  bcol[1 * B_STRIDE] = __byte_perm(t0, t1, 0x7632);
  bcol[2 * B_STRIDE] = __byte_perm(t2, t3, 0x5410);
  bcol[3 * B_STRIDE] = __byte_perm(t2, t3, 0x7632);
}

// one BK-deep k-step of a warp's tile: acc += As[16 * MI, BK] x Bs[BK, 64],
// the warp's rows starting at wm, its columns at wn. With kRowSum, rsum[i][h]
// also gathers this lane's share of sum_k As[row, k] for its rows wm + 16 i +
// gr + 8 h (the four lanes of a quad hold a row's 32 bytes between them;
// quad_sum adds them up).
template <int MI, bool kRowSum>
__device__ __forceinline__ void mma_k_tile_rs(const int8_t* As, const uint32_t* Bs,
                                              int (&acc)[MI][8][4],
                                              int (&rsum)[MI][2], int wm, int wn,
                                              int gr, int tq) {
#pragma unroll
  for (int ks = 0; ks < BK; ks += 32) {
    uint32_t a[MI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int8_t* p = As + (wm + i * 16 + gr) * A_STRIDE + ks + tq * 4;
      a[i][0] = *reinterpret_cast<const uint32_t*>(p);
      a[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * A_STRIDE);
      a[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
      a[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * A_STRIDE + 16);
      if constexpr (kRowSum) {
        rsum[i][0] = __dp4a((int)a[i][0], 0x01010101, rsum[i][0]);
        rsum[i][0] = __dp4a((int)a[i][2], 0x01010101, rsum[i][0]);
        rsum[i][1] = __dp4a((int)a[i][1], 0x01010101, rsum[i][1]);
        rsum[i][1] = __dp4a((int)a[i][3], 0x01010101, rsum[i][1]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t* q = Bs + (wn + j * 8 + gr) * B_STRIDE + ks / 4 + tq;
      const uint32_t b0 = q[0], b1 = q[4];
#pragma unroll
      for (int i = 0; i < MI; ++i) mma_s8(acc[i][j], a[i], b0, b1);
    }
  }
}

// a per-lane row-sum share -> the row's sum, in every lane of the quad; all
// 32 lanes must call it
__device__ __forceinline__ int quad_sum(int v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

template <typename OutT, int kStorage, bool kAsym>
__global__ void __launch_bounds__(kThreads)
gmm_int8_kernel(const int8_t* __restrict__ lhs, const float* __restrict__ s_a,
                const int8_t* __restrict__ rhs, const float* __restrict__ s_b,
                const float* __restrict__ zp,
                const int* __restrict__ group_sizes,
                const int* __restrict__ pflags,
                const int* __restrict__ blk_offsets, OutT* __restrict__ out,
                int M, int K, int N, int E) {
  // a packed expert needs a second A and B tile (its high-nibble k-step)
  constexpr int kTiles = kStorage == kInt8Stacked ? 1 : 2;
  __shared__ __align__(16) int8_t As[kTiles * A_TILE];
  __shared__ __align__(16) uint32_t Bs[kTiles * B_TILE];
  __shared__ int sizes[kMaxExperts];
  __shared__ int tile_info[4];            // expert, m-tile, row begin, row end

  const int tid = threadIdx.x;
  for (int e = tid; e < E; e += kThreads) sizes[e] = group_sizes[e];
  __syncthreads();
  if (tid == 0) find_tile<BM>(sizes, E, M, blockIdx.y, tile_info);
  __syncthreads();
  const int g = tile_info[0];
  if (g < 0) return;
  const int m0 = tile_info[1] * BM;
  const int row_lo = tile_info[2], row_hi = tile_info[3];
  if (m0 >= row_hi) return;
  const int n0 = blockIdx.x * BN;

  // this expert's storage block: where it starts, and whether it is packed
  const int K2 = K / 2;
  bool packed = false;
  const int8_t* w;
  if constexpr (kStorage == kInt8Stacked) {
    w = rhs + (size_t)g * K * N;
  } else if constexpr (kStorage == kPackedStacked) {
    packed = true;
    w = rhs + (size_t)g * K2 * N;
  } else {
    packed = pflags[g] != 0;
    w = rhs + (size_t)blk_offsets[g] * K2 * N;
  }
  const int Kw = packed ? K2 : K;         // rows of the storage block

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;
  const int gr = lane >> 2, tq = lane & 3;

  int acc[2][8][4];
  int rsum[2][2] = {{0, 0}, {0, 0}};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;

  // global -> registers for one k-tile (started a tile ahead of its use)
  int4 ra[2], ra_hi[2];
  uint32_t rb[4][4];
  auto load_tile = [&](int k0) {
    // A: 64 rows x 64 bytes, 16-byte chunks; rows of other experts -> 0.
    // A packed expert also takes the columns K/2 further on.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      const int row = m0 + (c >> 2), k = k0 + (c & 3) * 16;
      const bool live = row >= row_lo && row < row_hi && k < Kw;
      ra[i] = make_int4(0, 0, 0, 0);
      if (live)
        ra[i] = *reinterpret_cast<const int4*>(lhs + (size_t)row * K + k);
      if constexpr (kStorage != kInt8Stacked) {
        ra_hi[i] = make_int4(0, 0, 0, 0);
        if (packed && live)
          ra_hi[i] = *reinterpret_cast<const int4*>(lhs + (size_t)row * K + K2 + k);
      }
    }
    // B: 4(k) x 4(n) byte units
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = tid + i * kThreads;
      const int k = k0 + (u >> 5) * 4, n = n0 + (u & 31) * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        rb[i][j] = (n < N && k + j < Kw)
            ? *reinterpret_cast<const uint32_t*>(w + (size_t)(k + j) * N + n)
            : 0u;
    }
  };
  // registers -> shared; B transposed to K-contiguous words, a packed
  // tile split into its low-nibble and high-nibble int8 tiles
  auto store_tile = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      const int off = (c >> 2) * A_STRIDE + (c & 3) * 16;
      *reinterpret_cast<int4*>(As + off) = ra[i];
      if constexpr (kStorage != kInt8Stacked) {
        if (packed) *reinterpret_cast<int4*>(As + A_TILE + off) = ra_hi[i];
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = tid + i * kThreads;
      uint32_t* bcol = Bs + ((u & 31) * 4) * B_STRIDE + (u >> 5);
      if constexpr (kStorage != kInt8Stacked) {
        if (packed) {
          uint32_t lo[4], hi[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            lo[j] = sext4(rb[i][j] & 0x0F0F0F0Fu);
            hi[j] = sext4((rb[i][j] >> 4) & 0x0F0F0F0Fu);
          }
          store_b_unit(bcol, lo);
          store_b_unit(bcol + B_TILE, hi);
          continue;
        }
      }
      store_b_unit(bcol, rb[i]);
    }
  };

  load_tile(0);
  for (int k0 = 0; k0 < Kw; k0 += BK) {
    store_tile();
    __syncthreads();
    if (k0 + BK < Kw) load_tile(k0 + BK);   // in flight during the MMAs
    mma_k_tile_rs<2, kAsym>(As, Bs, acc, rsum, wm, wn, gr, tq);
    if constexpr (kStorage != kInt8Stacked) {
      if (packed)
        mma_k_tile_rs<2, kAsym>(As + A_TILE, Bs + B_TILE, acc, rsum, wm, wn, gr,
                                tq);
    }
    __syncthreads();
  }
  if constexpr (kAsym) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) rsum[i][h] = quad_sum(rsum[i][h]);
  }

  // epilogue: (acc * s_a) * s_b [+ (rsum * s_a) * zp], rounded once to the
  // output type; the intrinsics keep the sum of products from contracting
  // into an FMA, so the plain version's separate roundings are reproduced
  const float* sb = s_b + (size_t)g * N;
  const float* zb = kAsym ? zp + (size_t)g * N : nullptr;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + i * 16 + gr + h * 8;
      if (row < row_lo || row >= row_hi) continue;
      const float sa = s_a[row];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + wn + j * 8 + tq * 2;
        if (col >= N) continue;
        float x = (float)acc[i][j][2 * h] * sa * sb[col];
        float y = (float)acc[i][j][2 * h + 1] * sa * sb[col + 1];
        if constexpr (kAsym) {
          const float rs = __fmul_rn((float)rsum[i][h], sa);
          x = __fadd_rn(x, __fmul_rn(rs, zb[col]));
          y = __fadd_rn(y, __fmul_rn(rs, zb[col + 1]));
        }
        store2(out + (size_t)row * N + col, x, y);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The decode schedule
// ---------------------------------------------------------------------------

constexpr int DBM = 16, DBN = 64, DBK = 64, DSTAGES = 4;
constexpr int DEC_A_TILE = DBM * A_STRIDE;      // bytes of one A k-tile
constexpr int DEC_B_TILE = DBK * DBN;           // bytes of one raw weight k-tile
constexpr int D_PART = DBM * DBN + DBM;      // int32 of a split's partial

// byte offset of 16-byte piece `chunk` of weight row k in a raw tile: the
// pieces of rows 4i..4i+3 are rotated by i, so the four k-groups a warp's
// B fragments read at once fall in four different bank groups
__device__ __forceinline__ int d_swz(int k, int chunk) {
  return k * DBN + ((chunk ^ ((k >> 2) & 3)) << 4);
}

// the B fragment register of column c for codes k0..k0+3 (k0 % 4 == 0):
// byte j = Bt[k0 + j][c]
__device__ __forceinline__ uint32_t d_bcol(const int8_t* Bt, int k0, int c) {
  const int8_t* p = Bt + d_swz(k0, c >> 4) + (c & 12);
  const uint32_t w0 = *reinterpret_cast<const uint32_t*>(p);
  const uint32_t w1 = *reinterpret_cast<const uint32_t*>(p + DBN);
  const uint32_t w2 = *reinterpret_cast<const uint32_t*>(p + 2 * DBN);
  const uint32_t w3 = *reinterpret_cast<const uint32_t*>(p + 3 * DBN);
  const uint32_t sel = (c & 3) | (((c & 3) + 4) << 4);
  return __byte_perm(__byte_perm(w0, w1, sel), __byte_perm(w2, w3, sel), 0x5410);
}

// the m16 x k32 A fragment at k-step ks of a row-major int8 tile (row
// stride lda bytes) whose first row is the fragment's
__device__ __forceinline__ void d_afrag(const int8_t* At, int lda, int ks, int gr,
                                        int tq, uint32_t (&a)[4]) {
  const int8_t* p = At + gr * lda + ks + tq * 4;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * lda);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 16);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * lda + 16);
}

// one DBK-deep k-step of a warp's 16 x 16 tile; kNib: 0 int8 codes, 1 the
// low nibbles, 2 the high nibbles of packed bytes (sign-extended)
template <int kNib, bool kRowSum>
__device__ __forceinline__ void d_mma_tile(const int8_t* At, const int8_t* Bt,
                                           int (&acc)[2][4], int (&rsum)[2],
                                           int wn, int gr, int tq) {
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
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = wn + j * 8 + gr;
      uint32_t b0 = d_bcol(Bt, ks + tq * 4, c), b1 = d_bcol(Bt, ks + 16 + tq * 4, c);
      if constexpr (kNib == 1) {
        b0 = sext4(b0 & 0x0F0F0F0Fu);
        b1 = sext4(b1 & 0x0F0F0F0Fu);
      } else if constexpr (kNib == 2) {
        b0 = sext4((b0 >> 4) & 0x0F0F0F0Fu);
        b1 = sext4((b1 >> 4) & 0x0F0F0F0Fu);
      }
      mma_s8(acc[j], a, b0, b1);
    }
  }
}

// 8 consecutive activations (16-byte aligned) as loaded, and as f32 (bf16 ->
// f32 is exact); zero() stands for 8 zeros
template <typename T> struct Raw8;
template <> struct Raw8<__nv_bfloat16> {
  uint4 w;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    w = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void zero() { w = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ void values(float (&v)[8]) const {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(u[i] << 16);
      v[2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u);
    }
  }
};
template <> struct Raw8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void zero() { a = b = make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ __forceinline__ void values(float (&v)[8]) const {
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
};
// the int8 decode body's activations are codes: no Raw8 (never instantiated)
template <> struct Raw8<int8_t> {
  __device__ __forceinline__ void load(const int8_t*) {}
  __device__ __forceinline__ void zero() {}
  __device__ __forceinline__ void values(float (&v)[8]) const {}
};

// K1's arithmetic: the row scale, and 8 codes packed into 8 bytes
__device__ __forceinline__ float fq_scale(float amax, float upper) {
  return __fdiv_rn(fmaxf(amax, 1e-8f), upper);
}
__device__ __forceinline__ uint2 fq_codes8(const float (&v)[8], float s) {
  uint32_t lo = 0, hi = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lo |= (uint32_t)(__float2int_rn(__fdiv_rn(v[i], s)) & 0xFF) << (8 * i);
    hi |= (uint32_t)(__float2int_rn(__fdiv_rn(v[4 + i], s)) & 0xFF) << (8 * i);
  }
  return make_uint2(lo, hi);
}

// InT int8_t: the activations are codes (lhs, s_a). Otherwise (K14, int8
// stacked weights only) they are bf16 / f32 values x: the block first takes
// the amax of each of its 16 rows over all of K (a warp a row, every split
// the same, exact) while the first weight stages are in flight; then each
// k-tile's 16 x 64 activations are loaded into registers two k-tiles ahead
// (a thread 8 values), quantized beside the MMAs of the k-tile before and
// stored into their A stage after them. Only weight tiles go through the
// cp.async ring. upper = 2^(bits-1) - 1.
template <typename OutT, int kStorage, bool kAsym, typename InT = int8_t>
__global__ void __launch_bounds__(kThreads)
gmm_int8_decode_kernel(const int8_t* __restrict__ lhs, const float* __restrict__ s_a,
                       const int8_t* __restrict__ rhs, const float* __restrict__ s_b,
                       const float* __restrict__ zp,
                       const int* __restrict__ group_sizes,
                       const int* __restrict__ pflags,
                       const int* __restrict__ blk_offsets, OutT* __restrict__ out,
                       int* __restrict__ ws, int* __restrict__ tickets, int M, int K,
                       int N, int E, int kt_per_split, const InT* __restrict__ x,
                       float upper) {
  constexpr bool kQuant = !std::is_same<InT, int8_t>::value;
  static_assert(!kQuant || (kStorage == kInt8Stacked && !kAsym), "K14's decode body");
  // a packed expert also needs the A columns K/2 further on (its high nibbles)
  constexpr int kA = kStorage == kInt8Stacked ? 1 : 2;
  __shared__ __align__(16) int8_t As[DSTAGES][kA][DEC_A_TILE];
  __shared__ __align__(16) int8_t Bs[DSTAGES][DEC_B_TILE];
  __shared__ int sizes[kMaxExperts];
  __shared__ int tile_info[4];          // expert, first row, row begin, row end
  __shared__ int is_last;
  __shared__ float row_scale[kQuant ? DBM : 1];

  if (!block_tile<DBM>(group_sizes, E, M, sizes, tile_info)) return;
  const int g = tile_info[0], m0 = tile_info[1];
  const int row_lo = tile_info[2], row_hi = tile_info[3];
  const int n0 = blockIdx.x * DBN;

  const int K2 = K / 2;
  bool packed = false;
  const int8_t* w;
  if constexpr (kStorage == kInt8Stacked) {
    w = rhs + (size_t)g * K * N;
  } else if constexpr (kStorage == kPackedStacked) {
    packed = true;
    w = rhs + (size_t)g * K2 * N;
  } else {
    packed = pflags[g] != 0;
    w = rhs + (size_t)blk_offsets[g] * K2 * N;
  }
  const int Kw = packed ? K2 : K;         // rows of the storage block
  const int kt0 = blockIdx.z * kt_per_split;
  const int nk = max(min(kt0 + kt_per_split, (Kw + DBK - 1) / DBK) - kt0, 0);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3, wn = warp * 16;

  // k-tile t of this split -> ring stage t % DSTAGES (one commit group)
  auto issue = [&](int t) {
    if (t < nk) {
      const int k0 = (kt0 + t) * DBK, s = t % DSTAGES;
      if (!kQuant && tid < 64 * kA) {     // A: 16 rows x 4 pieces (x 2 halves)
        const int half = tid >> 6, c = tid & 63;
        const int row = m0 + (c >> 2), k = k0 + (c & 3) * 16;
        const bool live = row >= row_lo && row < row_hi && k < Kw && (half == 0 || packed);
        cp_async16(&As[s][half][(c >> 2) * A_STRIDE + (c & 3) * 16],
                   live ? lhs + (size_t)row * K + half * K2 + k : lhs, live ? 16 : 0);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {       // B: 64 rows x 4 pieces
        const int u = tid + i * kThreads, r = u >> 2, c = u & 3;
        const int k = k0 + r, col = n0 + c * 16;
        const bool ok = k < Kw && col < N;
        cp_async16(&Bs[s][d_swz(r, c)], ok ? w + (size_t)k * N + col : w, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  int acc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
  int rsum[2] = {0, 0};
#pragma unroll
  for (int t = 0; t < DSTAGES - 1; ++t) issue(t);
  // K14: thread tid quantizes row tid / 8, codes 8 (tid % 8) .. + 7 of a
  // k-tile. Two register sets take the k-tiles in turn, odd and even, so
  // each load is two k-tiles ahead of its use and no copy waits on one.
  const int q_row = m0 + (tid >> 3), q_col = (tid & 7) * 8;
  const bool q_live = kQuant && q_row >= row_lo && q_row < row_hi;
  Raw8<InT> odd, even;
  auto load_a = [&](Raw8<InT>& r, int t) {
    const int k = (kt0 + t) * DBK + q_col;
    if (q_live && t < nk && k < K) r.load(x + (size_t)q_row * K + k);
    else r.zero();
  };
  auto quant_a = [&](const Raw8<InT>& r) {   // rows outside the expert: zeros
    if (!q_live) return make_uint2(0u, 0u);
    float v[8];
    r.values(v);
    return fq_codes8(v, row_scale[tid >> 3]);
  };
  auto store_a = [&](uint2 codes, int t) {          // into k-tile t's stage
    *reinterpret_cast<uint2*>(&As[t % DSTAGES][0][(tid >> 3) * A_STRIDE + q_col]) = codes;
  };
  if constexpr (kQuant) {
    load_a(even, 0);
    load_a(odd, 1);
    // the scale of each row from its amax over all of K (a warp a row)
    for (int r = warp; r < DBM; r += kThreads / 32) {
      const int row = m0 + r;
      float amax = 0.f;
      if (row >= row_lo && row < row_hi) {
        // 8 chunks of 8 values a lane in flight at once
        const InT* xr = x + (size_t)row * K;
        for (int k0 = lane * 8; k0 < K; k0 += 2048) {
          Raw8<InT> c[8];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            if (k0 + 256 * i < K) c[i].load(xr + k0 + 256 * i);
#pragma unroll
          for (int i = 0; i < 8; ++i)
            if (k0 + 256 * i < K) {
              float v[8];
              c[i].values(v);
#pragma unroll
              for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(v[j]));
            }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      if (lane == 0) row_scale[r] = fq_scale(amax, upper);
    }
    __syncthreads();
    store_a(quant_a(even), 0);
    load_a(even, 2);
  }
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<DSTAGES - 2>();
    __syncthreads();                      // tile t landed; stage t-1 is free
    issue(t + DSTAGES - 1);
    const int s = t % DSTAGES;
    // K14: k-tile t + 1's codes, computed beside the MMAs of t
    uint2 codes;
    if constexpr (kQuant) codes = (t & 1) ? quant_a(even) : quant_a(odd);
    if (packed) {
      d_mma_tile<1, kAsym>(As[s][0], Bs[s], acc, rsum, wn, gr, tq);
      d_mma_tile<2, kAsym>(As[s][kA - 1], Bs[s], acc, rsum, wn, gr, tq);
    } else {
      d_mma_tile<0, kAsym>(As[s][0], Bs[s], acc, rsum, wn, gr, tq);
    }
    if constexpr (kQuant) {
      // k-tile t + 1's stage was last read by the MMAs of t - 3
      if (t + 1 < nk) store_a(codes, t + 1);
      if (t & 1) load_a(even, t + 3);
      else load_a(odd, t + 3);
    }
  }
  cp_async_wait<0>();
  if constexpr (kAsym) {
    rsum[0] = quad_sum(rsum[0]);
    rsum[1] = quad_sum(rsum[1]);
  }

  if (gridDim.z > 1) {
    // split-K: this split's partial, then the tile's last block adds them
    const size_t tile = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    int* part = ws + (tile * gridDim.z + blockIdx.z) * D_PART;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<int2*>(part + (gr + 8 * h) * DBN + wn + j * 8 + tq * 2) =
            make_int2(acc[j][2 * h], acc[j][2 * h + 1]);
    if (kAsym && warp == 0 && tq == 0) {
      part[DBM * DBN + gr] = rsum[0];
      part[DBM * DBN + gr + 8] = rsum[1];
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      is_last = atomicAdd(tickets + tile, 1) == (int)gridDim.z - 1;
      if (is_last) tickets[tile] = 0;     // every split has its ticket
    }
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    const int* part0 = ws + tile * gridDim.z * D_PART;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][c] = 0;
    rsum[0] = rsum[1] = 0;
    for (int z = 0; z < (int)gridDim.z; ++z) {
      const int* pz = part0 + (size_t)z * D_PART;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int2 v = __ldcg(reinterpret_cast<const int2*>(
              pz + (gr + 8 * h) * DBN + wn + j * 8 + tq * 2));
          acc[j][2 * h] += v.x;
          acc[j][2 * h + 1] += v.y;
        }
      if constexpr (kAsym) {
        rsum[0] += __ldcg(pz + DBM * DBN + gr);
        rsum[1] += __ldcg(pz + DBM * DBN + gr + 8);
      }
    }
  }

  // epilogue: K2's, (acc * s_a) * s_b [+ (rsum * s_a) * zp], rounded once
  const float* sb = s_b + (size_t)g * N;
  const float* zb = kAsym ? zp + (size_t)g * N : nullptr;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + gr + h * 8;
    if (row < row_lo || row >= row_hi) continue;
    const float sa = kQuant ? row_scale[gr + h * 8] : s_a[row];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = n0 + wn + j * 8 + tq * 2;
      if (col >= N) continue;
      float x = (float)acc[j][2 * h] * sa * sb[col];
      float y = (float)acc[j][2 * h + 1] * sa * sb[col + 1];
      if constexpr (kAsym) {
        const float rs = __fmul_rn((float)rsum[h], sa);
        x = __fadd_rn(x, __fmul_rn(rs, zb[col]));
        y = __fadd_rn(y, __fmul_rn(rs, zb[col + 1]));
      }
      store2(out + (size_t)row * N + col, x, y);
    }
  }
}

// The schedule a launch takes, as the wrapper computed it
// (ops/gmm_w8a8.py::int8_gmm_schedule): bm 64 (prefill body) or 16 (decode
// body), grid_m m-tiles, splits x kt_per_split k-tiles; ws [grid_n * grid_m
// * splits * D_PART] int32 and tickets [grid_n * grid_m] (zero) when splits
// > 1.
struct Int8Schedule {
  int bm, grid_m, splits, kt_per_split;
  int* ws;
  int* tickets;
};

template <typename OutT, int kStorage, bool kAsym>
cudaError_t launch_typed(const int8_t* lhs, const float* s_a, const int8_t* rhs,
                         const float* s_b, const float* zp, const int* gs,
                         const int* pflags,
                         const int* blk, void* out, int M, int K, int N, int E,
                         const Int8Schedule& sc, cudaStream_t st) {
  if (M > 0) {
    if (sc.bm == DBM) {
      dim3 grid((N + DBN - 1) / DBN, sc.grid_m, sc.splits);
      gmm_int8_decode_kernel<OutT, kStorage, kAsym><<<grid, kThreads, 0, st>>>(
          lhs, s_a, rhs, s_b, zp, gs, pflags, blk, static_cast<OutT*>(out), sc.ws,
          sc.tickets, M, K, N, E, sc.kt_per_split, static_cast<const int8_t*>(nullptr),
          0.f);
    } else if (sc.bm == BM) {
      dim3 grid((N + BN - 1) / BN, sc.grid_m);
      gmm_int8_kernel<OutT, kStorage, kAsym><<<grid, kThreads, 0, st>>>(
          lhs, s_a, rhs, s_b, zp, gs, pflags, blk, static_cast<OutT*>(out), M, K,
          N, E);
    } else {
      return cudaErrorInvalidValue;
    }
  }
  return cudaGetLastError();
}

// the C entry points' common body; pflags / blk_offsets may be null for the
// stacked storages, zp (read only with kAsym) for symmetric weights
template <int kStorage, bool kAsym = false>
int gmm_int8_launch(const void* lhs, const void* s_a, const void* rhs,
                    const void* s_b, const void* zp, const void* group_sizes,
                    const void* pflags, const void* blk_offsets, void* out,
                    int out_is_bf16, int M, int K, int N, int E, int bm,
                    int grid_m, int splits, int kt_per_split, void* ws,
                    void* tickets, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* a = static_cast<const int8_t*>(lhs);
  const int8_t* b = static_cast<const int8_t*>(rhs);
  const float* sa = static_cast<const float*>(s_a);
  const float* sb = static_cast<const float*>(s_b);
  const float* z = static_cast<const float*>(zp);
  const int* gs = static_cast<const int*>(group_sizes);
  const int* pf = static_cast<const int*>(pflags);
  const int* blk = static_cast<const int*>(blk_offsets);
  const Int8Schedule sc{bm, grid_m, splits, kt_per_split, static_cast<int*>(ws),
                        static_cast<int*>(tickets)};
  cudaError_t e = out_is_bf16
      ? launch_typed<__nv_bfloat16, kStorage, kAsym>(a, sa, b, sb, z, gs, pf, blk,
                                                     out, M, K, N, E, sc, st)
      : launch_typed<float, kStorage, kAsym>(a, sa, b, sb, z, gs, pf, blk, out,
                                             M, K, N, E, sc, st);
  return (int)e;
}

}  // namespace
