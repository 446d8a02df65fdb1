// K14: int8 grouped GEMM with the per-token activation quant in the launch.
//
// Replaces the Pallas kernel mxmoe_tpu/ops/pallas_gmm.py:gmm_w8a8_fusedquant
// (body _gmm_q8_fused_kernel).
//
//   scale[r] = max(amax_k |x[r,k]|, 1e-8) / upper      (IEEE division, as K1)
//   q[r,k]   = rint(x[r,k] / scale[r])                 (half to even, int8)
//   out[r,n] = OutT( (float)(sum_k q[r,k] * w[e,k,n]) * scale[r] * s_b[e,n] )
//
// Bitwise K1 (act_quant.cu) followed by K2 (gmm_w8a8.cu): the same f32
// values, the same division and rounding, an exact int32 sum and K2's
// epilogue order. No --use_fast_math (the codes depend on IEEE division).
//
// Bound on the H100: weight bytes at decode (as K2); the activations are read
// once from device memory as bf16 instead of K1's read + int8 write + K2's
// read. Design: K2's schedule and tiles (gmm_int8_tile.cuh: 64 x 128 block
// tile, mma.sync m16n8k32, the walk of gmm_tile_walk.cuh). A block first
// reduces the amax of each of its 64 rows over all of K (one warp per row,
// 16-byte loads), then streams the rows again k-tile by k-tile, quantizing
// each value as it is stored into shared memory. Every n-tile block of an
// m-tile repeats that quantization (the rows come from L2): the simple form;
// a later design quantizes an m-tile once and shares it.

#include "gmm_int8_tile.cuh"

namespace {

// the 32-bit word i of a 16-byte vector (i a compile-time constant after
// unrolling, so the selection folds to a register)
__device__ __forceinline__ uint32_t word_of(const int4& v, int i) {
  return (uint32_t)(i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w);
}

// value j of a 16-byte vector of T, as f32 (bf16 -> f32 is exact)
template <typename T>
__device__ __forceinline__ float value_of(const int4& v, int j);
template <>
__device__ __forceinline__ float value_of<float>(const int4& v, int j) {
  return __uint_as_float(word_of(v, j));
}
template <>
__device__ __forceinline__ float value_of<__nv_bfloat16>(const int4& v, int j) {
  const uint32_t w = word_of(v, j >> 1);
  return __uint_as_float((j & 1) ? (w & 0xFFFF0000u) : (w << 16));
}

// 16 consecutive activations of one row (the A chunk a thread loads) ->
// their codes at scale s, four per word
template <typename T>
__device__ __forceinline__ int4 quant16(const int4 (&v)[16 * sizeof(T) / 16],
                                        float s) {
  constexpr int kPerVec = 16 / sizeof(T);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int q = (int)rintf(__fdiv_rn(value_of<T>(v[j / kPerVec], j % kPerVec), s));
    w[j >> 2] |= (uint32_t)(q & 0xFF) << (8 * (j & 3));
  }
  return make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
}

template <typename InT, typename OutT>
__global__ void __launch_bounds__(kThreads)
gmm_fusedquant_kernel(const InT* __restrict__ lhs, const int8_t* __restrict__ rhs,
                      const float* __restrict__ s_b,
                      const int* __restrict__ group_sizes, OutT* __restrict__ out,
                      float upper, int M, int K, int N, int E) {
  __shared__ __align__(16) int8_t As[A_TILE];
  __shared__ __align__(16) uint32_t Bs[B_TILE];
  __shared__ int sizes[kMaxExperts];
  __shared__ int tile_info[4];            // expert, m-tile, row begin, row end
  __shared__ float row_scale[BM];

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
  const int8_t* w = rhs + (size_t)g * K * N;

  const int warp = tid >> 5, lane = tid & 31;
  constexpr int kPerVec = 16 / sizeof(InT);

  // the scale of each row: amax over all of K, one warp per row
  for (int r = warp; r < BM; r += kThreads / 32) {
    const int row = m0 + r;
    float amax = 0.f;
    if (row >= row_lo && row < row_hi) {
      const InT* xr = lhs + (size_t)row * K;
      for (int k = lane * kPerVec; k < K; k += 32 * kPerVec) {
        const int4 v = *reinterpret_cast<const int4*>(xr + k);
#pragma unroll
        for (int j = 0; j < kPerVec; ++j)
          amax = fmaxf(amax, fabsf(value_of<InT>(v, j)));
      }
    }
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    if (lane == 0) row_scale[r] = __fdiv_rn(fmaxf(amax, 1e-8f), upper);
  }
  __syncthreads();

  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;
  const int gr = lane >> 2, tq = lane & 3;
  int acc[2][8][4];
  int rsum[2][2] = {{0, 0}, {0, 0}};      // unused (no row sums)
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;

  // global -> registers for one k-tile (started a tile ahead of its use)
  constexpr int kVecs = 16 * sizeof(InT) / 16;   // int4s per 16 activations
  int4 ra[2][kVecs];
  uint32_t rb[4][4];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      const int row = m0 + (c >> 2), k = k0 + (c & 3) * 16;
      const bool live = row >= row_lo && row < row_hi && k < K;
#pragma unroll
      for (int v = 0; v < kVecs; ++v)
        ra[i][v] = live ? reinterpret_cast<const int4*>(lhs + (size_t)row * K + k)[v]
                        : make_int4(0, 0, 0, 0);
    }
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
  // registers -> shared: A quantized with its row's scale, B transposed
  auto store_tile = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      *reinterpret_cast<int4*>(As + (c >> 2) * A_STRIDE + (c & 3) * 16) =
          quant16<InT>(ra[i], row_scale[c >> 2]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = tid + i * kThreads;
      store_b_unit(Bs + ((u & 31) * 4) * B_STRIDE + (u >> 5), rb[i]);
    }
  };

  load_tile(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    store_tile();
    __syncthreads();
    if (k0 + BK < K) load_tile(k0 + BK);
    mma_k_tile_rs<2, false>(As, Bs, acc, rsum, wm, wn, gr, tq);
    __syncthreads();
  }

  // K2's epilogue: (acc * s_a) * s_b, rounded once to the output type
  const float* sb = s_b + (size_t)g * N;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm + i * 16 + gr + h * 8;
      const int row = m0 + r;
      if (row < row_lo || row >= row_hi) continue;
      const float sa = row_scale[r];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + wn + j * 8 + tq * 2;
        if (col >= N) continue;
        store2(out + (size_t)row * N + col, (float)acc[i][j][2 * h] * sa * sb[col],
               (float)acc[i][j][2 * h + 1] * sa * sb[col + 1]);
      }
    }
  }
}

template <typename InT, typename OutT>
cudaError_t launch_fq(const void* lhs, const int8_t* rhs, const float* s_b,
                      const int* gs, void* out, float upper, int M, int K, int N,
                      int E, cudaStream_t st) {
  if (M > 0) {
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM + E - 1);
    gmm_fusedquant_kernel<InT, OutT><<<grid, kThreads, 0, st>>>(
        static_cast<const InT*>(lhs), rhs, s_b, gs, static_cast<OutT*>(out), upper,
        M, K, N, E);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int mxmoe_gmm_w8a8_fusedquant(const void* lhs, int lhs_is_bf16,
                                         const void* rhs, const void* s_b,
                                         const void* group_sizes, void* out,
                                         int out_is_bf16, float upper, int M,
                                         int K, int N, int E, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* b = static_cast<const int8_t*>(rhs);
  const float* sb = static_cast<const float*>(s_b);
  const int* gs = static_cast<const int*>(group_sizes);
  cudaError_t e;
  if (lhs_is_bf16)
    e = out_is_bf16
        ? launch_fq<__nv_bfloat16, __nv_bfloat16>(lhs, b, sb, gs, out, upper, M, K, N, E, st)
        : launch_fq<__nv_bfloat16, float>(lhs, b, sb, gs, out, upper, M, K, N, E, st);
  else
    e = out_is_bf16
        ? launch_fq<float, __nv_bfloat16>(lhs, b, sb, gs, out, upper, M, K, N, E, st)
        : launch_fq<float, float>(lhs, b, sb, gs, out, upper, M, K, N, E, st);
  return (int)e;
}
