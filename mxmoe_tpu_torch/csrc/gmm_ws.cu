// K15: the weight-stationary schedule of the int8 grouped GEMMs K2 and K5.
//
// Replaces the Pallas kernel mxmoe_tpu/ops/pallas_gmm.py:_gmm_ws_launch
// (schedule _ws_schedule, body _gmm_ws_kernel), reached through gmm_w8a8_ws
// and gmm_w4a8_packed_ws.
//
//   out[r, n] = OutT( (float)(sum_k lhs[r,k] * w[e,k,n]) * s_a[r] * s_b[e,n] )
//
// K2's function (K5's for nibble-packed weights, halves layout) over sizes
// known when the launch is made, bitwise K2 / K5: an exact int32 sum and
// K2's epilogue order. What it adds is the schedule. The TPU kernel streams
// each expert's weight block into VMEM once, reuses it over all of the
// group's m-tiles and prefetches the next group's block a whole run ahead;
// K2 instead reads an expert's weights again for every m-tile of its group.
//
// Design (simple form): one block per work item (64-column slice, expert).
// The block copies the slice's full-K weights into shared memory once,
// unpacking packed experts and transposing into K2's K-contiguous B layout
// (k-tile after k-tile, 160 KB at K 2048), then walks every 128-row m-tile
// of its group: 8 warps of 16 rows x 64 columns, mma.sync m16n8k32 against
// the resident slice, the activations streamed k-tile by k-tile with the
// next tile's loads in flight during the current tile's MMAs. The sizes come
// by value in the kernel's parameters (no device copy, nothing read back):
// the counterpart of the TPU kernel's static sizes, so the host schedule
// (_ws_schedule's slots, waits and loads) has no counterpart. Rows of the
// group's last m-tile past its end are zero-filled and not stored, so the
// kernel needs no alignment; the wrapper keeps the reference's checks.
//
// Bound on the H100: at the headline shapes (8192 tokens, top-4) the
// operations (1.13 TOP a layer against ~0.2 GB of operands); each block
// reads its group's activations once per column slice, from L2 mostly.
// Later work: cp.async / TMA for the activations, wgmma, a persistent grid.

#include "gmm_int8_tile.cuh"

namespace {

constexpr int kWsThreads = 256;
constexpr int WS_BM = 128;                      // rows of an m-tile: 8 warps x 16
constexpr int WS_BN = 64;                       // columns of a work item
constexpr int WS_B_TILE = WS_BN * B_STRIDE;     // words of one resident k-tile
constexpr int WS_A_TILE = WS_BM * A_STRIDE;     // bytes
constexpr int kMaxWsGroups = 512;

struct WsSizes {
  int n[kMaxWsGroups];
};

template <typename OutT, bool kPacked>
__global__ void __launch_bounds__(kWsThreads)
gmm_ws_kernel(const int8_t* __restrict__ lhs, const float* __restrict__ s_a,
              const int8_t* __restrict__ rhs, const float* __restrict__ s_b,
              OutT* __restrict__ out, int M, int K, int N, const WsSizes sizes) {
  extern __shared__ __align__(16) uint32_t ws_smem[];
  uint32_t* Bs = ws_smem;                                   // K / BK k-tiles
  int8_t* As = reinterpret_cast<int8_t*>(Bs + (K / BK) * WS_B_TILE);

  const int g = blockIdx.y;
  const int rows = sizes.n[g];
  if (rows == 0) return;
  int start = 0;
  for (int i = 0; i < g; ++i) start += sizes.n[i];
  const int row_hi = min(start + rows, M);
  const int n0 = blockIdx.x * WS_BN;
  const int tid = threadIdx.x;
  const int Kw = kPacked ? K / 2 : K;                      // rows of the block
  const int8_t* w = rhs + (size_t)g * Kw * N;

  // the slice's weights, once: 4(k) x 4(n) byte units, 16 across the slice;
  // a packed byte row r holds code r (low nibble) and code K/2 + r (high)
  for (int u = tid; u < (Kw / 4) * (WS_BN / 4); u += kWsThreads) {
    const int k = (u / (WS_BN / 4)) * 4, nu = u % (WS_BN / 4), n = n0 + nu * 4;
    uint32_t r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      r[j] = n < N ? *reinterpret_cast<const uint32_t*>(w + (size_t)(k + j) * N + n)
                   : 0u;
    // code k's place in the resident slice: its k-tile, then its column
    // and 4-code word there
    auto at = [&](int code) {
      return Bs + (code / BK) * WS_B_TILE + nu * 4 * B_STRIDE + (code % BK) / 4;
    };
    if constexpr (kPacked) {
      uint32_t lo[4], hi[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        lo[j] = sext4(r[j] & 0x0F0F0F0Fu);
        hi[j] = sext4((r[j] >> 4) & 0x0F0F0F0Fu);
      }
      store_b_unit(at(k), lo);
      store_b_unit(at(K / 2 + k), hi);
    } else {
      store_b_unit(at(k), r);
    }
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp * 16, gr = lane >> 2, tq = lane & 3;
  int rsum[1][2] = {{0, 0}};                // unused (no row sums)
  const float* sb = s_b + (size_t)g * N;

  for (int m0 = start; m0 < row_hi; m0 += WS_BM) {
    int acc[1][8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[0][j][c] = 0;
    // A: 128 rows x 64 bytes a k-tile, 16-byte chunks, two per thread
    int4 ra[2];
    auto load_a = [&](int k0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = tid + i * kWsThreads;
        const int row = m0 + (c >> 2), k = k0 + (c & 3) * 16;
        ra[i] = (row < row_hi && k < K)
            ? *reinterpret_cast<const int4*>(lhs + (size_t)row * K + k)
            : make_int4(0, 0, 0, 0);
      }
    };
    load_a(0);
    for (int k0 = 0; k0 < K; k0 += BK) {
      __syncthreads();           // the weights are in; the last tile is read
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = tid + i * kWsThreads;
        *reinterpret_cast<int4*>(As + (c >> 2) * A_STRIDE + (c & 3) * 16) = ra[i];
      }
      __syncthreads();
      if (k0 + BK < K) load_a(k0 + BK);     // in flight during the MMAs
      mma_k_tile_rs<1, false>(As, Bs + (k0 / BK) * WS_B_TILE, acc, rsum, wm, 0,
                              gr, tq);
    }
    // K2's epilogue: (acc * s_a) * s_b, rounded once to the output type
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + gr + h * 8;
      if (row >= row_hi) continue;
      const float sa = s_a[row];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + j * 8 + tq * 2;
        if (col >= N) continue;
        store2(out + (size_t)row * N + col, (float)acc[0][j][2 * h] * sa * sb[col],
               (float)acc[0][j][2 * h + 1] * sa * sb[col + 1]);
      }
    }
  }
}

template <typename OutT, bool kPacked>
cudaError_t launch_ws(const int8_t* lhs, const float* s_a, const int8_t* rhs,
                      const float* s_b, void* out, int M, int K, int N, int E,
                      const WsSizes& sizes, cudaStream_t st) {
  const size_t smem = (size_t)(K / BK) * WS_B_TILE * 4 + WS_A_TILE;
  cudaError_t e = cudaFuncSetAttribute(gmm_ws_kernel<OutT, kPacked>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  if (M > 0) {
    dim3 grid((N + WS_BN - 1) / WS_BN, E);
    gmm_ws_kernel<OutT, kPacked><<<grid, kWsThreads, smem, st>>>(
        lhs, s_a, rhs, s_b, static_cast<OutT*>(out), M, K, N, sizes);
  }
  return cudaGetLastError();
}

}  // namespace

// shared bytes a launch takes for this K (the wrapper checks the card's limit)
extern "C" int mxmoe_gmm_ws_smem_bytes(int K) {
  return (K / BK) * WS_B_TILE * 4 + WS_A_TILE;
}

// static_sizes: E host ints (at most 512), passed to the kernel by value
extern "C" int mxmoe_gmm_ws(const void* lhs, const void* s_a, const void* rhs,
                            const void* s_b, const int* static_sizes, void* out,
                            int packed, int out_is_bf16, int M, int K, int N, int E,
                            void* stream) {
  if (E > kMaxWsGroups) return (int)cudaErrorInvalidValue;
  WsSizes sizes;
  for (int i = 0; i < E; ++i) sizes.n[i] = static_sizes[i];
  for (int i = E; i < kMaxWsGroups; ++i) sizes.n[i] = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* a = static_cast<const int8_t*>(lhs);
  const int8_t* b = static_cast<const int8_t*>(rhs);
  const float* sa = static_cast<const float*>(s_a);
  const float* sb = static_cast<const float*>(s_b);
  cudaError_t e;
  if (packed)
    e = out_is_bf16
        ? launch_ws<__nv_bfloat16, true>(a, sa, b, sb, out, M, K, N, E, sizes, st)
        : launch_ws<float, true>(a, sa, b, sb, out, M, K, N, E, sizes, st);
  else
    e = out_is_bf16
        ? launch_ws<__nv_bfloat16, false>(a, sa, b, sb, out, M, K, N, E, sizes, st)
        : launch_ws<float, false>(a, sa, b, sb, out, M, K, N, E, sizes, st);
  return (int)e;
}
