// What every grouped GEMM over expert-sorted rows shares, whatever its
// operand types: the block size, the walk from a block index to its
// (expert, m-tile) pair, and the typed two-element store of the epilogue.
//
// Schedule: grid = n-tiles x (cdiv(M, BM) + E - 1) logical m-tiles, a static
// bound. Each block reads group_sizes from device memory, finds its pair
// itself and exits when it has none, so the host never syncs on the routing.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxExperts = 1024;

// logical tile t -> info = {expert, m-tile, row begin, row end}, in expert
// order over m-tiles of kBM rows; info[0] = -1 when t is past the last tile.
// sizes: the E group sizes (shared memory). One thread calls it.
template <int kBM>
__device__ __forceinline__ void find_tile(const int* sizes, int E, int M, int t,
                                          int* info) {
  int start = 0, tiles = 0, found = -1;
  for (int g = 0; g < E; ++g) {
    const int s = sizes[g];
    if (s > 0) {
      const int first = start / kBM, last = (start + s - 1) / kBM;
      const int n = last - first + 1;
      if (t < tiles + n) {
        found = g;
        info[1] = first + (t - tiles);
        info[2] = start;
        info[3] = min(start + s, M);
        break;
      }
      tiles += n;
    }
    start += s;
  }
  info[0] = found;
}

// the block's tile: every thread calls it. Copies the group sizes into
// `sizes` (shared, kMaxExperts ints), lets one thread walk them and fills
// `info` (shared, 4 ints: expert, first row of the tile, row begin, row end of
// the expert); false when the block has no tile or no row in it.
template <int kBM>
__device__ __forceinline__ bool block_tile(const int* __restrict__ group_sizes,
                                           int E, int M, int* sizes, int* info) {
  const int tid = threadIdx.x;
  for (int e = tid; e < E; e += kThreads) sizes[e] = group_sizes[e];
  __syncthreads();
  if (tid == 0) {
    find_tile<kBM>(sizes, E, M, blockIdx.y, info);
    info[1] *= kBM;
  }
  __syncthreads();
  return info[0] >= 0 && info[1] < info[3];
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) =
      __halves2bfloat162(__float2bfloat16_rn(x), __float2bfloat16_rn(y));
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// four 4-bit codes, one per byte (bits 0..3) -> four sign-extended int8:
// ((x & 0xF) ^ 8) - 8 per byte, written without a borrow between bytes
__device__ __forceinline__ uint32_t sext4(uint32_t x) {
  return x | ((x & 0x08080808u) * 0x1Eu);
}

}  // namespace
