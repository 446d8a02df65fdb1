// The whole expert FFN in one launch, shared by K12 gmm_ffn_w8a8
// (gmm_ffn_w8a8.cu: int8 experts stacked [E, K, 2N] / [E, N, H]) and K13
// gmm_ffn_mixed_packed (gmm_ffn_mixed_packed.cu: K4's ragged buffers, each
// expert one nibble-packed K/2-row unit or two int8 units). Per m-tile of
// FFN_BM = 32 expert-sorted rows of one expert e:
//
//   gu    = ((float)(lhs_q @ w_gu[e]) * s_a) * s_gu[e]        [32, 2N] f32
//   h     = (gate * sigmoid(gate)) * up,  sigmoid(x) = 1 / (1 + expf(-x))
//   scale = max(amax_n |h|, 1e-8) / upper,  upper = 2^(min(bits[e], 8)-1) - 1
//   hq    = rint(h / scale)                                   (int8)
//   out   = OutT( ((float)(hq @ w_d[e]) * scale) * s_d[e] )   [32, H]
//
// Every product and sum of the f32 steps is rounded on its own (__fmul_rn,
// __fadd_rn, __fdiv_rn: no FMA contraction, IEEE division), in the order
// the plain version (ops/gmm_ffn.py) writes them, and the int32 sums are
// exact, so packed and int8 storage of the same codes give the same bits.
//
// Schedule: one block per logical m-tile (gmm_tile_walk.cuh; on the aligned
// dispatch every tile belongs to one expert; a tile that straddles two is
// computed once per expert, rows masked). gate_up runs in passes of 64 gate
// and the 64 matching up columns (4 warps of 16 rows x 64 columns, mma.sync
// m16n8k32, K2's tiles and loaders, gmm_int8_tile.cuh); the gate warps park
// their f32 values in shared memory, the up warps turn them into h there.
// h [32, N] stays in shared memory in f32 (180 KB at N 1408: 2N = 2816 f32
// columns would not fit, so gu never exists whole). The row amax and the
// codes follow, hq goes to a device workspace [M, N] int8 that this block
// alone writes and reads back (from L2) as the A operand of the down GEMM,
// in passes of 128 columns. One block per m-tile gives ~14 blocks at decode
// (M 16, ~14 live experts) on 132 SMs; splitting an m-tile's columns over a
// thread block cluster that shares the row amax and hq through distributed
// shared memory is the redesign (ROADMAP queue B).

#pragma once

#include "gmm_int8_tile.cuh"

namespace {

constexpr int FFN_BM = 32;                     // rows of an m-tile
constexpr int FFN_A_TILE = FFN_BM * A_STRIDE;  // bytes of one A k-tile
constexpr int FFN_B_TILE = BN * B_STRIDE;      // words of one 128-column B k-tile
constexpr int FFN_H_PAD = 4;                   // f32 pad of an h row (banks)

enum FfnStorage { kFfnStacked = 0, kFfnRagged = 1 };

// one GEMM's weights for the block's expert: its storage block, the bytes
// of a storage row, and whether it is nibble-packed (K/2 rows, halves layout)
struct FfnWeights {
  const int8_t* w;
  int ld;
  bool packed;
};

// acc (each warp: 16 rows x 64 columns) = rows [m0, m0 + 32) of A (those in
// [row_lo, row_hi), the others zero) times the weight columns c0 + [0, 64)
// (warps 0, 1) and c1 + [0, 64) (warps 2, 3); columns >= ncols are zero.
// K2's k-loop: the next k-tile's loads in flight during the MMAs; a packed
// byte tile feeds two k-steps (A columns r0.. and K/2 + r0..), as K4.
// Every thread of the block calls it.
__device__ __forceinline__ void ffn_pass(const int8_t* A, int lda, int K, int m0,
                                         int row_lo, int row_hi, FfnWeights wt,
                                         int c0, int c1, int ncols, int8_t* As,
                                         uint32_t* Bs, int (&acc)[1][8][4]) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp & 1) * 16, wn = (warp >> 1) * 64;
  const int gr = lane >> 2, tq = lane & 3;
  const int K2 = K / 2;
  const int Kw = wt.packed ? K2 : K;
  int rsum[1][2] = {{0, 0}};                 // unused (no row sums)
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[0][j][c] = 0;

  int4 ra, ra_hi;
  uint32_t rb[4][4];
  auto load_tile = [&](int k0) {
    // A: 32 rows x 64 bytes, one 16-byte chunk a thread
    const int row = m0 + (tid >> 2), k = k0 + (tid & 3) * 16;
    const bool live = row >= row_lo && row < row_hi && k < Kw;
    ra = live ? *reinterpret_cast<const int4*>(A + (size_t)row * lda + k)
              : make_int4(0, 0, 0, 0);
    ra_hi = (live && wt.packed)
        ? *reinterpret_cast<const int4*>(A + (size_t)row * lda + K2 + k)
        : make_int4(0, 0, 0, 0);
    // B: 4(k) x 4(n) byte units, 16 across each of the two 64-column halves
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = tid + i * kThreads;
      const int nu = u & 31, kk = k0 + (u >> 5) * 4;
      const int col = nu < 16 ? c0 + nu * 4 : c1 + (nu - 16) * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        rb[i][j] = (col < ncols && kk + j < Kw)
            ? *reinterpret_cast<const uint32_t*>(wt.w + (size_t)(kk + j) * wt.ld + col)
            : 0u;
    }
  };
  auto store_tile = [&]() {
    const int off = (tid >> 2) * A_STRIDE + (tid & 3) * 16;
    *reinterpret_cast<int4*>(As + off) = ra;
    if (wt.packed) *reinterpret_cast<int4*>(As + FFN_A_TILE + off) = ra_hi;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = tid + i * kThreads;
      uint32_t* bcol = Bs + ((u & 31) * 4) * B_STRIDE + (u >> 5);
      if (wt.packed) {
        uint32_t lo[4], hi[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          lo[j] = sext4(rb[i][j] & 0x0F0F0F0Fu);
          hi[j] = sext4((rb[i][j] >> 4) & 0x0F0F0F0Fu);
        }
        store_b_unit(bcol, lo);
        store_b_unit(bcol + FFN_B_TILE, hi);
      } else {
        store_b_unit(bcol, rb[i]);
      }
    }
  };

  load_tile(0);
  for (int k0 = 0; k0 < Kw; k0 += BK) {
    store_tile();
    __syncthreads();
    if (k0 + BK < Kw) load_tile(k0 + BK);
    mma_k_tile_rs<1, false>(As, Bs, acc, rsum, wm, wn, gr, tq);
    if (wt.packed)
      mma_k_tile_rs<1, false>(As + FFN_A_TILE, Bs + FFN_B_TILE, acc, rsum, wm, wn,
                              gr, tq);
    __syncthreads();
  }
}

__device__ __forceinline__ float sigmoid_rn(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// dynamic shared bytes of a launch: h [32, N + pad] f32, then two A and two
// B k-tiles (the second of each for a packed expert's high nibbles)
__host__ __device__ inline size_t ffn_smem_bytes(int N) {
  return (size_t)FFN_BM * (N + FFN_H_PAD) * 4 + 2 * FFN_A_TILE + 2 * FFN_B_TILE * 4;
}

template <typename OutT, int kStorage>
__global__ void __launch_bounds__(kThreads)
gmm_ffn_kernel(const int8_t* __restrict__ lhs, const float* __restrict__ s_a,
               const int8_t* __restrict__ gu, const float* __restrict__ s_gu,
               const int* __restrict__ gu_pf, const int* __restrict__ gu_blk,
               const int8_t* __restrict__ dn, const float* __restrict__ s_d,
               const int* __restrict__ d_pf, const int* __restrict__ d_blk,
               const int* __restrict__ group_sizes, const int* __restrict__ abits,
               int8_t* hq, OutT* __restrict__ out, int M, int K, int N, int H,
               int E) {
  extern __shared__ __align__(16) float h_s[];      // [FFN_BM][N + pad]
  __shared__ int sizes[kMaxExperts];
  __shared__ int info[4];                  // expert, first row, row begin, end
  __shared__ float row_scale[FFN_BM];
  const int NP = N + FFN_H_PAD;
  int8_t* As = reinterpret_cast<int8_t*>(h_s + FFN_BM * NP);
  uint32_t* Bs = reinterpret_cast<uint32_t*>(As + 2 * FFN_A_TILE);

  if (!block_tile<FFN_BM>(group_sizes, E, M, sizes, info)) return;
  const int g = info[0], m0 = info[1], row_lo = info[2], row_hi = info[3];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp & 1) * 16, gr = lane >> 2, tq = lane & 3;
  const bool up_warp = (warp >> 1) != 0;

  FfnWeights wgu, wd;
  if constexpr (kStorage == kFfnStacked) {
    wgu = {gu + (size_t)g * K * 2 * N, 2 * N, false};
    wd = {dn + (size_t)g * N * H, H, false};
  } else {
    wgu = {gu + (size_t)gu_blk[g] * (K / 2) * 2 * N, 2 * N, gu_pf[g] != 0};
    wd = {dn + (size_t)d_blk[g] * (N / 2) * H, H, d_pf[g] != 0};
  }

  // 1. gate_up in pairs of 64 gate / 64 up columns -> h in shared memory
  int acc[1][8][4];
  const float* sgu = s_gu + (size_t)g * 2 * N;
  for (int c = 0; c < N; c += 64) {
    ffn_pass(lhs, K, K, m0, row_lo, row_hi, wgu, c, N + c, 2 * N, As, Bs, acc);
    const int base = up_warp ? N + c : c;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = wm + gr + hh * 8, row = m0 + r;
      const float sa = (row >= row_lo && row < row_hi) ? s_a[row] : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int lc = j * 8 + tq * 2;
        if (c + lc >= N) continue;
        const float v0 = (float)acc[0][j][2 * hh] * sa * sgu[base + lc];
        const float v1 = (float)acc[0][j][2 * hh + 1] * sa * sgu[base + lc + 1];
        float* hp = h_s + r * NP + c + lc;
        if (!up_warp) {
          hp[0] = v0;
          hp[1] = v1;
        }
        acc[0][j][2 * hh] = __float_as_int(v0);        // the up value, parked
        acc[0][j][2 * hh + 1] = __float_as_int(v1);
      }
    }
    __syncthreads();                       // the gate values are in h_s
    if (up_warp) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = wm + gr + hh * 8;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int lc = j * 8 + tq * 2;
          if (c + lc >= N) continue;
          float* hp = h_s + r * NP + c + lc;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float gt = hp[q];
            hp[q] = __fmul_rn(__fmul_rn(gt, sigmoid_rn(gt)),
                              __int_as_float(acc[0][j][2 * hh + q]));
          }
        }
      }
    }
  }
  __syncthreads();

  // 2. per-row requant at the expert's down bits; the codes to the workspace
  {
    const int b = min(abits[g], 8);
    const float upper = (float)((1 << (b - 1)) - 1);
    for (int r = warp; r < FFN_BM; r += kThreads / 32) {
      const float* hr = h_s + r * NP;
      float amax = 0.f;
      for (int k = lane; k < N; k += 32) amax = fmaxf(amax, fabsf(hr[k]));
      for (int off = 16; off > 0; off >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      const float s = __fdiv_rn(fmaxf(amax, 1e-8f), upper);
      if (lane == 0) row_scale[r] = s;
      const int row = m0 + r;
      if (row < row_lo || row >= row_hi) continue;
      for (int k = lane * 4; k < N; k += 128) {
        uint32_t wq = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wq |= (uint32_t)((int)rintf(__fdiv_rn(hr[k + j], s)) & 0xFF) << (8 * j);
        *reinterpret_cast<uint32_t*>(hq + (size_t)row * N + k) = wq;
      }
    }
  }
  __syncthreads();

  // 3. down in passes of 128 columns: (acc * scale) * s_d
  const float* sd = s_d + (size_t)g * H;
  const int wn = (warp >> 1) * 64;
  for (int n0 = 0; n0 < H; n0 += BN) {
    ffn_pass(hq, N, N, m0, row_lo, row_hi, wd, n0, n0 + 64, H, As, Bs, acc);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = wm + gr + hh * 8, row = m0 + r;
      if (row < row_lo || row >= row_hi) continue;
      const float sh = row_scale[r];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + wn + j * 8 + tq * 2;
        if (col >= H) continue;
        store2(out + (size_t)row * H + col, (float)acc[0][j][2 * hh] * sh * sd[col],
               (float)acc[0][j][2 * hh + 1] * sh * sd[col + 1]);
      }
    }
  }
}

template <typename OutT, int kStorage>
cudaError_t launch_ffn(const int8_t* lhs, const float* s_a, const int8_t* gu,
                       const float* s_gu, const int* gu_pf, const int* gu_blk,
                       const int8_t* dn, const float* s_d, const int* d_pf,
                       const int* d_blk, const int* gs, const int* abits, int8_t* hq,
                       void* out, int M, int K, int N, int H, int E, cudaStream_t st) {
  const size_t smem = ffn_smem_bytes(N);
  cudaError_t e = cudaFuncSetAttribute(gmm_ffn_kernel<OutT, kStorage>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  if (M > 0) {
    dim3 grid(1, (M + FFN_BM - 1) / FFN_BM + E - 1);
    gmm_ffn_kernel<OutT, kStorage><<<grid, kThreads, smem, st>>>(
        lhs, s_a, gu, s_gu, gu_pf, gu_blk, dn, s_d, d_pf, d_blk, gs, abits, hq,
        static_cast<OutT*>(out), M, K, N, H, E);
  }
  return cudaGetLastError();
}

// the C entry points' common body; the pf / blk pointers are null for the
// stacked storage
template <int kStorage>
int gmm_ffn_launch(const void* lhs, const void* s_a, const void* gu,
                   const void* s_gu, const void* gu_pf, const void* gu_blk,
                   const void* dn, const void* s_d, const void* d_pf,
                   const void* d_blk, const void* group_sizes, const void* abits,
                   void* hq, void* out, int out_is_bf16, int M, int K, int N, int H,
                   int E, void* stream) {
  auto i8 = [](const void* p) { return static_cast<const int8_t*>(p); };
  auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  auto i32 = [](const void* p) { return static_cast<const int*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* ws = static_cast<int8_t*>(hq);
  cudaError_t e = out_is_bf16
      ? launch_ffn<__nv_bfloat16, kStorage>(
            i8(lhs), f32(s_a), i8(gu), f32(s_gu), i32(gu_pf), i32(gu_blk), i8(dn),
            f32(s_d), i32(d_pf), i32(d_blk), i32(group_sizes), i32(abits), ws, out,
            M, K, N, H, E, st)
      : launch_ffn<float, kStorage>(
            i8(lhs), f32(s_a), i8(gu), f32(s_gu), i32(gu_pf), i32(gu_blk), i8(dn),
            f32(s_d), i32(d_pf), i32(d_blk), i32(group_sizes), i32(abits), ws, out,
            M, K, N, H, E, st);
  return (int)e;
}

}  // namespace
