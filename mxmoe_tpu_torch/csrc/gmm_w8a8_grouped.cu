// K8: grouped-scale (g128-class) int8 x int8 grouped GEMM over
// expert-sorted rows, with an optional asymmetric-weight zero-point term.
//
// Replaces the Pallas kernel mxmoe_tpu/ops/pallas_gmm.py:gmm_w8a8_grouped
// (_grouped_accum and its four bodies, with and without rhs_zp, k-blocked or
// not).
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
// contracting them into FMAs), so kernel and plain version agree bitwise.
// With E = 1 this is the dense product of a grouped / asymmetric shared
// expert; with G = 1 it is a per-channel product.
//
// Bound on the H100: weight bytes (codes; the f32 scales and zero points add
// 8 bytes per 128 codes). Design: the walk, the shared A / B layouts and the
// MMA step of gmm_int8_tile.cuh, with a 32-row block tile (16 x 64 per warp)
// instead of 64: a thread then carries 32 int32 group accumulators beside 32
// f32 ones and nothing spills, and the routed rows of one expert (about one
// at decode, about 17 in a 256-token chunk) seldom fill more. Every
// gsize / 64 k-tiles the int32 accumulators are folded into the f32 ones and
// cleared; the row sums of the zp term come from the A fragments in
// registers (dp4a), summed over the quad at each fold.

#include "gmm_int8_tile.cuh"

namespace {

constexpr int GBM = 32;                     // rows of the block tile
constexpr int GA_TILE = GBM * A_STRIDE;     // bytes

template <typename OutT, bool kZp>
__global__ void __launch_bounds__(kThreads)
gmm_grouped_kernel(const int8_t* __restrict__ lhs, const float* __restrict__ s_a,
                   const int8_t* __restrict__ rhs, const float* __restrict__ s_b,
                   const float* __restrict__ zp,
                   const int* __restrict__ group_sizes, OutT* __restrict__ out,
                   int M, int K, int N, int E, int gsize) {
  __shared__ __align__(16) int8_t As[GA_TILE];
  __shared__ __align__(16) uint32_t Bs[B_TILE];
  __shared__ int sizes[kMaxExperts];
  __shared__ int tile_info[4];            // expert, m-tile, row begin, row end

  const int tid = threadIdx.x;
  for (int e = tid; e < E; e += kThreads) sizes[e] = group_sizes[e];
  __syncthreads();
  if (tid == 0) find_tile<GBM>(sizes, E, M, blockIdx.y, tile_info);
  __syncthreads();
  const int e = tile_info[0];
  if (e < 0) return;
  const int m0 = tile_info[1] * GBM;
  const int row_lo = tile_info[2], row_hi = tile_info[3];
  if (m0 >= row_hi) return;
  const int n0 = blockIdx.x * BN;
  const int G = K / gsize;
  const int8_t* w = rhs + (size_t)e * K * N;

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
    // B: 4(k) x 4(n) byte units
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = tid + i * kThreads;
      const int k = k0 + (u >> 5) * 4, n = n0 + (u & 31) * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        rb[i][j] = (n < N && k + j < K)
            ? *reinterpret_cast<const uint32_t*>(w + (size_t)(k + j) * N + n)
            : 0u;
    }
  };
  auto store_tile = [&]() {
    *reinterpret_cast<int4*>(As + (tid >> 2) * A_STRIDE + (tid & 3) * 16) = ra;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = tid + i * kThreads;
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
    const size_t srow = ((size_t)e * G + g) * N;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + wn + j * 8 + tq * 2;
      float2 sb = make_float2(0.0f, 0.0f), zb = make_float2(0.0f, 0.0f);
      if (col < N) {
        sb = *reinterpret_cast<const float2*>(s_b + srow + col);
        if constexpr (kZp) zb = *reinterpret_cast<const float2*>(zp + srow + col);
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
    store_tile();
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

template <typename OutT>
cudaError_t launch_grouped(const int8_t* lhs, const float* s_a, const int8_t* rhs,
                           const float* s_b, const float* zp, const int* gs,
                           void* out, int M, int K, int N, int E, int gsize,
                           cudaStream_t st) {
  if (M > 0) {
    dim3 grid((N + BN - 1) / BN, (M + GBM - 1) / GBM + E - 1);
    OutT* o = static_cast<OutT*>(out);
    if (zp != nullptr)
      gmm_grouped_kernel<OutT, true><<<grid, kThreads, 0, st>>>(
          lhs, s_a, rhs, s_b, zp, gs, o, M, K, N, E, gsize);
    else
      gmm_grouped_kernel<OutT, false><<<grid, kThreads, 0, st>>>(
          lhs, s_a, rhs, s_b, zp, gs, o, M, K, N, E, gsize);
  }
  return cudaGetLastError();
}

}  // namespace

// zp may be null (symmetric weights: the row-sum term is compiled out)
extern "C" int mxmoe_gmm_w8a8_grouped(const void* lhs, const void* s_a,
                                      const void* rhs, const void* s_b,
                                      const void* zp, const void* group_sizes,
                                      void* out, int out_is_bf16, int M, int K,
                                      int N, int E, int gsize, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* a = static_cast<const int8_t*>(lhs);
  const int8_t* b = static_cast<const int8_t*>(rhs);
  const float* sa = static_cast<const float*>(s_a);
  const float* sb = static_cast<const float*>(s_b);
  const float* z = static_cast<const float*>(zp);
  const int* gs = static_cast<const int*>(group_sizes);
  cudaError_t err = out_is_bf16
      ? launch_grouped<__nv_bfloat16>(a, sa, b, sb, z, gs, out, M, K, N, E, gsize,
                                      st)
      : launch_grouped<float>(a, sa, b, sb, z, gs, out, M, K, N, E, gsize, st);
  return (int)err;
}
