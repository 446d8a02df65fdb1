// K11: grouped GEMM of float operands (bf16, or f32) over expert-sorted rows.
//
// Replaces the Pallas kernel mxmoe_tpu/ops/pallas_gmm.py:gmm (alias gmm_bf16;
// bodies _gmm_kernel_1 and the k-blocked _gmm_kernel with its f32 scratch).
//
//   out[r, n] = OutT( sum_k lhs[r,k] * rhs[e,k,n] )   for the rows r of expert e
//
// lhs [M, K], rhs [E, K, N], both bf16 or both f32; f32 accumulation over all
// of K, one rounding to the output type. The TPU kernel's k-blocking exists
// for its VMEM; here a block loops over K. Rows past sum(group_sizes) are
// not written. Two bodies, by the operands' type:
//
// * bf16: gmm_bf16_wgmma_kernel, a persistent warp-specialised wgmma body,
//   at every row count (needs K and N multiples of 8 and 16-byte aligned
//   operands: TMA's strides). Bound on the H100: operations from a few
//   thousand routed rows on (65536 x 2048 x 2816 over 60 experts: 0.76 ms
//   of bf16 operations against 0.37 of bytes); bytes at a 256-token prefill
//   chunk (~17 rows an expert) and at decode. What held the 32 x 128
//   mma.sync body it replaced below either: mma.sync cannot reach the dense
//   bf16 rate (only wgmma can), and every 32-row m-tile read its expert's
//   weights again. At the decode rows neither body led: each was 5-18 %
//   ahead at some shape (PERF.md), so one body serves every row count.
//   Design: the walk of gmm_ws_body.cuh (WsWalk over WsDeviceSizes, the
//   same 128 x 256 work items): one CTA an SM takes items c, c + grid, ...
//   in (group, n-tile, m-tile) order, so the m-tiles of one weight column
//   run side by side and the weight tile comes from L2 after its first
//   read; a group's m-tiles start at its own first row, rows of the next
//   group (or past M, which TMA reads as zeros) are multiplied and not
//   stored; each CTA's cursor reads a group's size from device memory when
//   it reaches it. 384 threads, three warpgroups:
//   - two consumer warpgroups of 64 rows each issue wgmma m64n256k16
//     .f32.bf16.bf16, four a 64-deep k-tile, one k-tile's MMAs in flight
//     while the next stage is awaited, then write the tile, rounded once to
//     OutT, into shared memory and go on to the next item. A warpgroup
//     whose 64 rows all lie past its group's end issues no MMA;
//   - the producer warpgroup's thread 0 keeps a ring of three stages loaded
//     by TMA (A: [128 rows x 64 k], K-major, 128-byte swizzle, 16 KB; B:
//     four boxes of [64 k x 64 columns], 128-byte swizzled, 32 KB), the
//     weights landing as they are stored: for 16-bit operands wgmma reads an
//     MN-major B (its transpose bit), so, unlike the int8 body, no transform
//     and no raw ring;
//   - its warps 1-3 store the tile from shared memory (rows of the group
//     below M, columns below N; 16 bytes a thread, whole rows a warp) while
//     the consumers run the next item's MMAs. Written straight from the
//     fragments, 4 bytes a thread and 8 rows an instruction, the stores
//     held the MMAs up for a quarter of the time (PERF.md).
//   setmaxnreg moves the producer's registers to the consumers (128 f32
//   accumulators a thread). Boxes past K or N read zeros, so a K or N tail
//   needs no tail code.
// * f32: a plain FMA loop in full f32 outside the tensor cores (a thread
//   owns one column of the 32 x 128 tile). The tensor cores' TF32 would
//   round each operand to 10 mantissa bits, a different function than the
//   f32 product the reference computes.

#include "gmm_weight_only_tile.cuh"
#include "gmm_ws_body.cuh"

namespace {

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

template <typename OutT>
void launch_f32(const void* lhs, const void* rhs, const int* gs, void* out, int M,
                int K, int N, int E, cudaStream_t st) {
  dim3 grid((N + WBN - 1) / WBN, (M + WBM - 1) / WBM + E - 1);
  gmm_f32_kernel<OutT><<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(lhs), static_cast<const float*>(rhs), gs,
      static_cast<OutT*>(out), M, K, N, E);
}

// --- bf16: the persistent wgmma body -----------------

constexpr int BW_BK = 64;                      // k of a stage: one 128-byte row
constexpr int BW_STAGES = 3;
constexpr int BW_BOX_N = 64;                   // columns of a B box
constexpr int BW_A_BYTES = WS_BM * BW_BK * 2;  // [128 rows][64 k] bf16
constexpr int BW_BOX_BYTES = BW_BK * BW_BOX_N * 2;
constexpr int BW_B_BYTES = (WS_BN / BW_BOX_N) * BW_BOX_BYTES;   // four boxes
constexpr int BW_ROW = 512;                    // bytes of an output row in the tile
constexpr int BW_STORERS = 96;                 // the producer warpgroup's warps 1-3

struct BwSmem {
  __nv_bfloat16 a[BW_STAGES][WS_BM * BW_BK];
  __nv_bfloat16 b[BW_STAGES][WS_BN / BW_BOX_N][BW_BK * BW_BOX_N];
  uint4 out[WS_BM * BW_ROW / 16];  // the output tile, 512 bytes a row
  uint64_t full[BW_STAGES], empty[BW_STAGES];
  uint64_t out_full, out_empty;
};
static_assert(sizeof(BwSmem) + 1024 <= 232448, "the ring and the output tile");
constexpr int kBwSmemBytes = (int)sizeof(BwSmem) + 1024;

// The output tile in shared memory: 128 rows of 512 bytes (the whole 256
// columns in bf16; half of them in f32, so an f32 tile goes out in two
// passes), the 16-byte chunk c of row r at c ^ (r % 8): the fragment's
// bf16 writes (8 rows x 4 lanes a column group) and a quarter-warp's eight
// 16-byte reads of a row meet no bank conflict.
template <typename OutT>
struct BwTile {
  static constexpr int kCols = BW_ROW / (int)sizeof(OutT);     // columns of a pass
  static constexpr int kPasses = WS_BN / kCols;
  static constexpr int kPer = 16 / (int)sizeof(OutT);          // columns of a chunk
  __device__ __forceinline__ static int at(int r, int chunk) {
    return r * (BW_ROW / 16) + (chunk ^ (r & 7));
  }
};

template <typename OutT>
__global__ void __launch_bounds__(kWsThreads, 1)
gmm_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_b,
                      const int* __restrict__ group_sizes, OutT* __restrict__ out,
                      int M, int K, int N, int E) {
  using Tile = BwTile<OutT>;
  extern __shared__ uint8_t bw_smem_raw[];
  BwSmem& sm = *reinterpret_cast<BwSmem*>(
      (reinterpret_cast<uintptr_t>(bw_smem_raw) + 1023) & ~uintptr_t(1023));
  const WsDeviceSizes sizes{group_sizes};
  const int tid = threadIdx.x;
  const int nt = (N + WS_BN - 1) / WS_BN;
  const int kt_n = (K + BW_BK - 1) / BW_BK;

  if (tid == 0) {
    for (int i = 0; i < BW_STAGES; ++i) {
      mbar_init(&sm.full[i], 1);
      mbar_init(&sm.empty[i], 8);                // the 8 consumer warps
    }
    mbar_init(&sm.out_full, 256);                // every consumer thread
    mbar_init(&sm.out_empty, BW_STORERS);
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 256) {
    // ---- producer warpgroup: TMA (thread 0), the stores (warps 1-3) ----
    warpgroup_reg_dealloc<40>();
    WsWalk<WsDeviceSizes> it;
    it.begin(sizes, M);
    if (tid == 256) {
      tma_prefetch_desc(&map_a);
      tma_prefetch_desc(&map_b);
      int q = 0;
      for (int w = blockIdx.x; it.seek(sizes, E, nt, M, w); w += gridDim.x) {
        for (int kt = 0; kt < kt_n; ++kt, ++q) {
          const int s = q % BW_STAGES;
          if (q >= BW_STAGES) mbar_wait(&sm.empty[s], ((q / BW_STAGES) - 1) & 1);
          mbar_arrive_expect_tx(&sm.full[s], BW_A_BYTES + BW_B_BYTES);
          const int k0 = kt * BW_BK;
          tma_load_2d(sm.a[s], &map_a, &sm.full[s], k0, it.m0);
#pragma unroll
          for (int j = 0; j < WS_BN / BW_BOX_N; ++j)
            tma_load_3d(sm.b[s][j], &map_b, &sm.full[s], it.n0 + j * BW_BOX_N, k0, it.g);
        }
      }
    } else if (tid >= 256 + 32) {
      // the tile's rows of this group below M, columns below N, 16 bytes a
      // thread, a warp two rows' 256 contiguous bytes an instruction, while
      // the consumers run the next item's MMAs
      const int st = tid - (256 + 32);
      int e = 0;
      for (int w = blockIdx.x; it.seek(sizes, E, nt, M, w); w += gridDim.x) {
        const int rows = min(WS_BM, it.row_end - it.m0);
#pragma unroll 1
        for (int p = 0; p < Tile::kPasses; ++p, ++e) {
          mbar_wait(&sm.out_full, e & 1);
          for (int idx = st; idx < rows * (BW_ROW / 16); idx += BW_STORERS) {
            const int r = idx / (BW_ROW / 16), c = idx % (BW_ROW / 16);
            const int col = it.n0 + p * Tile::kCols + c * Tile::kPer;
            if (col < N)
              *reinterpret_cast<uint4*>(out + (size_t)(it.m0 + r) * N + col) =
                  sm.out[Tile::at(r, c)];
          }
          mbar_arrive(&sm.out_empty);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: wgmma, then the tile into shared memory ----
    warpgroup_reg_alloc<232>();
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    WsWalk<WsDeviceSizes> it;
    it.begin(sizes, M);
    int q = 0, e = 0;
    float acc[128];
    auto release = [&](int p) {          // k-tile p's stage is read
      if (lane == 0) mbar_arrive(&sm.empty[p % BW_STAGES]);
    };
    for (int w = blockIdx.x; it.seek(sizes, E, nt, M, w); w += gridDim.x) {
      // the branch stays outside the k-loop and warp-uniform, or ptxas
      // serializes every wgmma (C7518)
      const bool live = __shfl_sync(0xffffffffu, it.m0 + wg * 64 < it.row_end, 0);
      if (live) {
        for (int kt = 0; kt < kt_n; ++kt, ++q) {
          const int s = q % BW_STAGES;
          mbar_wait(&sm.full[s], (q / BW_STAGES) & 1);
          reg_fence(acc);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < BW_BK / 16; ++ks)
            wgmma_m64n256k16_bf16_tb(
                acc, smem_desc_sw128(&sm.a[s][(wg * 64) * BW_BK + ks * 16]),
                smem_desc_sw128_mn(&sm.b[s][0][ks * 16 * BW_BOX_N], BW_BOX_BYTES),
                kt > 0 || ks > 0);
          wgmma_commit();
          reg_fence(acc);
          if (kt > 0) {                  // k-tile q - 1's reads are done
            wgmma_wait<1>();
            reg_fence(acc);
            release(q - 1);
          }
        }
        wgmma_wait<0>();
        reg_fence(acc);
        release(q - 1);
      } else {                           // no stored row: keep step with the stages
        for (int kt = 0; kt < kt_n; ++kt, ++q) {
          mbar_wait(&sm.full[q % BW_STAGES], (q / BW_STAGES) & 1);
          release(q);
        }
      }
      // f32 -> OutT once, into the tile once the stores of the last one
      // have read it; every consumer thread arrives
      uint8_t* tile = reinterpret_cast<uint8_t*>(sm.out);
      const int r0 = wg * 64 + warp * 16 + (lane >> 2);
#pragma unroll
      for (int p = 0; p < Tile::kPasses; ++p, ++e) {
        if (e > 0) mbar_wait(&sm.out_empty, (e - 1) & 1);
        if (live) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r0 + 8 * h;
#pragma unroll
            for (int jj = 0; jj < Tile::kCols / 8; ++jj) {
              const int j = p * (Tile::kCols / 8) + jj;
              const int byte = (8 * jj + 2 * (lane & 3)) * (int)sizeof(OutT);
              uint8_t* dst = tile + Tile::at(r, byte >> 4) * 16 + (byte & 15);
              const float x = acc[4 * j + 2 * h], y = acc[4 * j + 2 * h + 1];
              if constexpr (sizeof(OutT) == 2)
                *reinterpret_cast<__nv_bfloat162*>(dst) =
                    __halves2bfloat162(__float2bfloat16_rn(x), __float2bfloat16_rn(y));
              else
                *reinterpret_cast<float2*>(dst) = make_float2(x, y);
            }
          }
        }
        mbar_arrive(&sm.out_full);
      }
    }
  }
}

// the TMA maps of the body: lhs [M, K] bf16 in [128 rows x 64 k] boxes and
// rhs [E, K, N] bf16 in [64 k x 64 columns] boxes, both 128-byte swizzled.
// Needs K % 8 == 0, N % 8 == 0 (16-byte strides) and 16-byte aligned
// operands.
cudaError_t bw_encode_maps(const void* lhs, const void* rhs, int M, int K, int N, int E,
                           CUtensorMap* map_a, CUtensorMap* map_b) {
  const cuuint64_t a_dim[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t a_stride[1] = {(cuuint64_t)K * 2};
  const cuuint32_t a_box[2] = {BW_BK, WS_BM};
  const cuuint64_t b_dim[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t b_stride[2] = {(cuuint64_t)N * 2, (cuuint64_t)K * N * 2};
  const cuuint32_t b_box[3] = {BW_BOX_N, BW_BK, 1};
  cudaError_t e = encode_map(map_a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, lhs, a_dim,
                             a_stride, a_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return e;
  return encode_map(map_b, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, rhs, b_dim, b_stride,
                    b_box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <typename OutT>
cudaError_t launch_wgmma(const CUtensorMap& map_a, const CUtensorMap& map_b,
                         const int* gs, void* out, int M, int K, int N, int E, int grid,
                         cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(gmm_bf16_wgmma_kernel<OutT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       kBwSmemBytes);
  if (e != cudaSuccess) return e;
  gmm_bf16_wgmma_kernel<OutT><<<grid, kWsThreads, kBwSmemBytes, st>>>(
      map_a, map_b, gs, static_cast<OutT*>(out), M, K, N, E);
  return cudaGetLastError();
}

}  // namespace

// Group sizes are int32 [E] in device memory. bf16 operands: every group's
// rows are covered by at most cdiv(M, 128) + E m-tiles, which bounds the
// persistent grid.
extern "C" int mxmoe_gmm_bf16(const void* lhs, const void* rhs,
                              const void* group_sizes, void* out, int in_is_bf16,
                              int out_is_bf16, int M, int K, int N, int E,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* gs = static_cast<const int*>(group_sizes);
  if (!in_is_bf16) {
    if (M > 0) {
      if (out_is_bf16)
        launch_f32<__nv_bfloat16>(lhs, rhs, gs, out, M, K, N, E, st);
      else
        launch_f32<float>(lhs, rhs, gs, out, M, K, N, E, st);
    }
    return (int)cudaGetLastError();
  }
  if (E <= 0 || K <= 0 || N <= 0 || K % 8 != 0 || N % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaGetLastError();
  CUtensorMap map_a, map_b;
  cudaError_t e = bw_encode_maps(lhs, rhs, M, K, N, E, &map_a, &map_b);
  if (e != cudaSuccess) return (int)e;
  const long long nt = (N + WS_BN - 1) / WS_BN;
  const int grid = ws_grid(((long long)(M + WS_BM - 1) / WS_BM + E) * nt);
  if (grid <= 0) return (int)cudaErrorInvalidValue;
  e = out_is_bf16
      ? launch_wgmma<__nv_bfloat16>(map_a, map_b, gs, out, M, K, N, E, grid, st)
      : launch_wgmma<float>(map_a, map_b, gs, out, M, K, N, E, grid, st);
  return (int)e;
}
