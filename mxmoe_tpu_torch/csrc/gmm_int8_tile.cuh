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
// Schedule (gmm_tile_walk.cuh, unchanged from the first K2). Rows outside the
// block's expert are zero-filled on load and masked on store. mma.sync
// m16n8k32 s8.s8.s32: 4 warps, a 64 x 128 block tile, 32 x 64 per warp; K in
// steps of 64. The [K, N] weight tile is transposed in registers
// (byte_perm 4x4) into a K-contiguous shared layout that the col-major B
// fragment reads conflict-free; the next k-tile's global loads are started
// into registers before the current tile's MMAs.

#pragma once

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

template <typename OutT, int kStorage, bool kAsym>
cudaError_t launch_typed(const int8_t* lhs, const float* s_a, const int8_t* rhs,
                         const float* s_b, const float* zp, const int* gs,
                         const int* pflags,
                         const int* blk, void* out, int M, int K, int N, int E,
                         cudaStream_t st) {
  if (M > 0) {
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM + E - 1);
    gmm_int8_kernel<OutT, kStorage, kAsym><<<grid, kThreads, 0, st>>>(
        lhs, s_a, rhs, s_b, zp, gs, pflags, blk, static_cast<OutT*>(out), M, K, N,
        E);
  }
  return cudaGetLastError();
}

// the C entry points' common body; pflags / blk_offsets may be null for the
// stacked storages, zp (read only with kAsym) for symmetric weights
template <int kStorage, bool kAsym = false>
int gmm_int8_launch(const void* lhs, const void* s_a, const void* rhs,
                    const void* s_b, const void* zp, const void* group_sizes,
                    const void* pflags, const void* blk_offsets, void* out,
                    int out_is_bf16, int M, int K, int N, int E, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* a = static_cast<const int8_t*>(lhs);
  const int8_t* b = static_cast<const int8_t*>(rhs);
  const float* sa = static_cast<const float*>(s_a);
  const float* sb = static_cast<const float*>(s_b);
  const float* z = static_cast<const float*>(zp);
  const int* gs = static_cast<const int*>(group_sizes);
  const int* pf = static_cast<const int*>(pflags);
  const int* blk = static_cast<const int*>(blk_offsets);
  cudaError_t e = out_is_bf16
      ? launch_typed<__nv_bfloat16, kStorage, kAsym>(a, sa, b, sb, z, gs, pf, blk,
                                                     out, M, K, N, E, st)
      : launch_typed<float, kStorage, kAsym>(a, sa, b, sb, z, gs, pf, blk, out,
                                             M, K, N, E, st);
  return (int)e;
}

}  // namespace
