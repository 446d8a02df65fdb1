// K11: grouped GEMM of float operands (bf16, or f32) over expert-sorted rows.
//
// Replaces the Pallas kernel mxmoe_tpu/ops/pallas_gmm.py:gmm (alias gmm_bf16;
// bodies _gmm_kernel_1 and the k-blocked _gmm_kernel with its f32 scratch).
//
//   out[r, n] = OutT( sum_k lhs[r,k] * rhs[e,k,n] )   for the rows r of expert e
//
// lhs [M, K], rhs [E, K, N], both bf16 or both f32; f32 accumulation over all
// of K in ascending k, one rounding to the output type. The TPU kernel's
// k-blocking exists for its VMEM; here a block loops over K.
//
// bf16: mma.sync m16n8k16 with f32 accumulators; 4 warps, a 32 x 128 block
// tile (16 x 64 per warp), K in steps of 64, the tile layouts and the MMA
// step of gmm_weight_only_tile.cuh. The [K, N] weight tile arrives as rows of
// n; each thread interleaves two rows of eight columns into the (k, k + 1)
// pairs per column that the col-major B fragment reads (byte_perm). The next
// step's global loads are started into registers before the current MMAs.
//
// f32: a plain FMA loop in full f32 outside the tensor cores (a thread owns
// one column of the 32 x 128 tile). The tensor cores' TF32 would round each
// operand to 10 mantissa bits, a different function than the f32 product the
// reference computes.
//
// Bound on the H100: weight bytes at decode (two bytes a weight for every
// routed expert); at prefill (M 1024 over 60 experts, ~17 rows each) still
// below the bf16 ridge.

#include "gmm_weight_only_tile.cuh"

namespace {

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
gmm_bf16_kernel(const __nv_bfloat16* __restrict__ lhs,
                const __nv_bfloat16* __restrict__ rhs,
                const int* __restrict__ group_sizes, OutT* __restrict__ out,
                int M, int K, int N, int E) {
  __shared__ __align__(16) __nv_bfloat16 As[WA_TILE];
  __shared__ __align__(16) uint32_t Bs[WB_TILE];
  __shared__ int sizes[kMaxExperts];
  __shared__ int tile_info[4];       // expert, first row, row begin, row end

  if (!block_tile<WBM>(group_sizes, E, M, sizes, tile_info)) return;
  const int e = tile_info[0];
  const int m0 = tile_info[1], row_lo = tile_info[2], row_hi = tile_info[3];
  const int n0 = blockIdx.x * WBN;
  const __nv_bfloat16* w = rhs + (size_t)e * K * N;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 1) * 16, wn = (warp & 1) * 64;
  const int gr = lane >> 2, tq = lane & 3;

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.0f;

  // global -> registers for one k-step (started a step ahead of its use)
  int4 ra[2];
  uint4 rb[4][2];
  auto load_step = [&](int k0) {
    // A: 32 rows x 64 bf16, 16-byte chunks; other experts' rows -> 0
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      const int row = m0 + (c >> 3), k = k0 + (c & 7) * 8;
      ra[i] = make_int4(0, 0, 0, 0);
      if (row >= row_lo && row < row_hi && k < K)
        ra[i] = *reinterpret_cast<const int4*>(lhs + (size_t)row * K + k);
    }
    // B: units of 2(k) x 8(n) bf16, one 16-byte chunk per k row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = tid + i * kThreads;
      const int k = k0 + (u >> 4) * 2, n = n0 + (u & 15) * 8;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        rb[i][j] = make_uint4(0u, 0u, 0u, 0u);
        if (n < N && k + j < K)
          rb[i][j] = *reinterpret_cast<const uint4*>(w + (size_t)(k + j) * N + n);
      }
    }
  };
  // registers -> shared; B as (k, k + 1) pairs per column, [k/2][n] words
  auto store_step = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      *reinterpret_cast<int4*>(As + (c >> 3) * WA_STRIDE + (c & 7) * 8) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = tid + i * kThreads;
      uint32_t* brow = Bs + (u >> 4) * WB_STRIDE + (u & 15) * 8;
      const uint4 r0 = rb[i][0], r1 = rb[i][1];
      // a word of r0 holds columns (n, n + 1) of row k; pair each column
      // with the same column of row k + 1
      *reinterpret_cast<uint4*>(brow) = make_uint4(
          __byte_perm(r0.x, r1.x, 0x5410), __byte_perm(r0.x, r1.x, 0x7632),
          __byte_perm(r0.y, r1.y, 0x5410), __byte_perm(r0.y, r1.y, 0x7632));
      *reinterpret_cast<uint4*>(brow + 4) = make_uint4(
          __byte_perm(r0.z, r1.z, 0x5410), __byte_perm(r0.z, r1.z, 0x7632),
          __byte_perm(r0.w, r1.w, 0x5410), __byte_perm(r0.w, r1.w, 0x7632));
    }
  };

  load_step(0);
  for (int k0 = 0; k0 < K; k0 += WBK) {
    store_step();
    __syncthreads();
    if (k0 + WBK < K) load_step(k0 + WBK);   // in flight during the MMAs
    mma_w_tile(As, Bs, acc, wm, wn, gr, tq);
    __syncthreads();
  }

  const int row0 = m0 + wm + gr, row1 = row0 + 8;
  const bool live0 = row0 >= row_lo && row0 < row_hi;
  const bool live1 = row1 >= row_lo && row1 < row_hi;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + wn + j * 8 + tq * 2;
    if (col >= N) continue;
    if (live0) store2(out + (size_t)row0 * N + col, acc[j][0], acc[j][1]);
    if (live1) store2(out + (size_t)row1 * N + col, acc[j][2], acc[j][3]);
  }
}

__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

constexpr int FBK = 32;   // k-step of the f32 kernel

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
gmm_f32_kernel(const float* __restrict__ lhs, const float* __restrict__ rhs,
               const int* __restrict__ group_sizes, OutT* __restrict__ out,
               int M, int K, int N, int E) {
  __shared__ float As[WBM][FBK];
  __shared__ int sizes[kMaxExperts];
  __shared__ int tile_info[4];       // expert, first row, row begin, row end

  if (!block_tile<WBM>(group_sizes, E, M, sizes, tile_info)) return;
  const int e = tile_info[0];
  const int m0 = tile_info[1], row_lo = tile_info[2], row_hi = tile_info[3];
  const int tid = threadIdx.x;
  const int col = blockIdx.x * WBN + tid;     // this thread's column
  const float* w = rhs + (size_t)e * K * N;

  float acc[WBM];
#pragma unroll
  for (int r = 0; r < WBM; ++r) acc[r] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += FBK) {
    // A: 32 rows x 32 floats; other experts' rows and the K edge -> 0
#pragma unroll
    for (int i = 0; i < WBM * FBK / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / FBK, kk = c % FBK;
      const int row = m0 + r, k = k0 + kk;
      As[r][kk] = (row >= row_lo && row < row_hi && k < K)
          ? lhs[(size_t)row * K + k] : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < FBK; ++kk) {
      const float b = (col < N && k0 + kk < K) ? w[(size_t)(k0 + kk) * N + col]
                                               : 0.0f;
#pragma unroll
      for (int r = 0; r < WBM; ++r) acc[r] = fmaf(As[r][kk], b, acc[r]);
    }
    __syncthreads();
  }

  if (col >= N) return;
#pragma unroll
  for (int r = 0; r < WBM; ++r) {
    const int row = m0 + r;
    if (row >= row_lo && row < row_hi) store1(out + (size_t)row * N + col, acc[r]);
  }
}

template <typename InT, typename OutT>
void launch(const void* lhs, const void* rhs, const int* gs, void* out, int M,
            int K, int N, int E, cudaStream_t st) {
  dim3 grid((N + WBN - 1) / WBN, (M + WBM - 1) / WBM + E - 1);
  const InT* a = static_cast<const InT*>(lhs);
  const InT* b = static_cast<const InT*>(rhs);
  OutT* o = static_cast<OutT*>(out);
  if constexpr (sizeof(InT) == 2)
    gmm_bf16_kernel<OutT><<<grid, kThreads, 0, st>>>(a, b, gs, o, M, K, N, E);
  else
    gmm_f32_kernel<OutT><<<grid, kThreads, 0, st>>>(a, b, gs, o, M, K, N, E);
}

}  // namespace

extern "C" int mxmoe_gmm_bf16(const void* lhs, const void* rhs,
                              const void* group_sizes, void* out, int in_is_bf16,
                              int out_is_bf16, int M, int K, int N, int E,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* gs = static_cast<const int*>(group_sizes);
  if (M > 0) {
    if (in_is_bf16 && out_is_bf16)
      launch<__nv_bfloat16, __nv_bfloat16>(lhs, rhs, gs, out, M, K, N, E, st);
    else if (in_is_bf16)
      launch<__nv_bfloat16, float>(lhs, rhs, gs, out, M, K, N, E, st);
    else if (out_is_bf16)
      launch<float, __nv_bfloat16>(lhs, rhs, gs, out, M, K, N, E, st);
    else
      launch<float, float>(lhs, rhs, gs, out, M, K, N, E, st);
  }
  return (int)cudaGetLastError();
}
