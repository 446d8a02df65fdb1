// K10: weight-only (a16) and w x a experts in ONE grouped GEMM launch over
// expert-sorted rows, on int8-stored codes.
//
// Replaces the Pallas kernel mxmoe_tpu/ops/pallas_gmm.py:gmm_mixed_wo_wxa
// (_gmm_mixed_kernel per channel, _gmm_mixed_flex_kernel with per-k-group
// scales and zero points).
//
// scheme_flags [E]: 1 = the expert's rows are the bf16 activations `lhs`
// multiplied with its codes dequantized in the kernel (K6's product,
// gmm_weight_only_tile.cuh); 0 = they are the int8 codes `lhs_q` with scales
// `s_a` [M, G] multiplied with the codes as they are (K8's product,
// gmm_grouped_tile.cuh; with G = 1 and no zero points that is K2's
// `(acc * s_a) * s_b`). rhs [E, K, N] int8, s_b and zp [E, G, N] f32; zp may
// be null (no asymmetric scheme: the weight-only experts add no zero point and
// the row-sum term of the others is compiled out).
//
// Three schedules, one for both bodies (ops/gmm_w8a8_grouped.py::
// weight_only_gmm_schedule, also K6's and K7's):
//
// * Above the decode rows, inside the wgmma domain (bm 128): ONE persistent
//   launch of gmm_wq_body.cuh's walk, whose work items are body A's (128 x
//   256, K6's wgmma body) for the flag-1 groups and body B's (128 x 128,
//   K8's wgmma body) for the flag-0 groups; both share one ring, whose
//   stages hold the same bytes in either body.
// * Otherwise above the decode rows (bm 32): a block finds its (expert,
//   m-tile) pair, reads the expert's flag (uniform over the block) and runs
//   K6's wo_tile_body (gmm_weight_only_tile.cuh) or K8's grouped_tile_body
//   (gmm_grouped_tile.cuh), both 32 x 128 tiles, on one grid.
// * Decode (bm 16, M <= DECODE_M): K6's wo_decode_body or K8's
//   grouped_decode_body, both m16 x 64 tiles over the same m-tiles and the
//   same split count (gridDim.z); what a split covers is each body's own
//   (byte-tile pairs evenly; logical k-tiles at whole groups).
//
// Each body loads only the activation operand it needs (the TPU kernel
// streams both every step). The bodies are K6's and K8's own, so a flag-1
// expert's rows equal K6's output and a flag-0 expert's rows K8's (or K2's)
// bit for bit on the same operands and schedule.
//
// Bound on the H100: weight bytes (one byte a code for every routed expert,
// whatever its flag, plus scales). In the mma.sync kernels shared memory is
// the union of the two bodies' (the weight-only body's is the larger at both
// schedules: 44,032 bytes of tiles at the 32 x 128 tiles, three 13,824-byte
// ring stages at decode), registers the larger of theirs. The split
// workspace is the w x a body's (int32 group parts, the larger per split),
// read as f32 by the weight-only body.

#include "gmm_grouped_tile.cuh"
#include "gmm_weight_only_tile.cuh"
#include "gmm_wq_body.cuh"

namespace {

constexpr int kWoABytes = 2 * WA_TILE * (int)sizeof(__nv_bfloat16);
constexpr int kWoBytes = kWoABytes + 2 * WB_TILE * (int)sizeof(uint32_t);
constexpr int kWxaBytes = GA_TILE + B_TILE * (int)sizeof(uint32_t);
static_assert(kWoABytes % 16 == 0 && GA_TILE % 16 == 0, "tile alignment");
static_assert(kWxaBytes <= kWoBytes, "the weight-only tiles are the larger");
static_assert(GBM == WBM && BN == WBN, "one grid serves both bodies");
constexpr int kWoDecBytes = kWoStages<false> * (int)sizeof(WoStage<false>);
constexpr int kWxaDecBytes = DSTAGES * (int)sizeof(GdStage<false>);
static_assert(kWxaDecBytes <= kWoDecBytes, "the weight-only ring is the larger");

template <typename OutT, bool kZp>
__global__ void __launch_bounds__(kThreads)
gmm_mixed_wo_wxa_kernel(const __nv_bfloat16* __restrict__ lhs,
                        const int8_t* __restrict__ lhs_q,
                        const float* __restrict__ s_a,
                        const int8_t* __restrict__ rhs,
                        const float* __restrict__ s_b,
                        const float* __restrict__ zp,
                        const int* __restrict__ flags,
                        const int* __restrict__ group_sizes,
                        OutT* __restrict__ out, int M, int K, int N, int E,
                        int gsize) {
  __shared__ __align__(16) unsigned char tiles[kWoBytes];
  __shared__ int sizes[kMaxExperts];
  __shared__ int tile_info[4];       // expert, first row, row begin, row end

  if (!block_tile<GBM>(group_sizes, E, M, sizes, tile_info)) return;
  const int e = tile_info[0];
  const int m0 = tile_info[1], row_lo = tile_info[2], row_hi = tile_info[3];
  const int n0 = blockIdx.x * BN;
  const int8_t* w = rhs + (size_t)e * K * N;
  const size_t srow = (size_t)e * (K / gsize) * N;
  const float* zb = kZp ? zp + srow : nullptr;
  if (flags[e] != 0) {
    wo_tile_body<OutT, false>(
        lhs, w, s_b + srow, zb, out, K, N, gsize, m0, row_lo, row_hi, n0,
        reinterpret_cast<__nv_bfloat16*>(tiles),
        reinterpret_cast<uint32_t*>(tiles + kWoABytes));
  } else {
    grouped_tile_body<OutT, kZp, false>(
        lhs_q, s_a, w, false, s_b + srow, zb, out, K, N, gsize, m0, row_lo,
        row_hi, n0, reinterpret_cast<int8_t*>(tiles),
        reinterpret_cast<uint32_t*>(tiles + GA_TILE));
  }
}

// the decode schedule: one m16 x 64 grid, gridDim.z splits, the two decode
// bodies over one ring's shared memory
template <typename OutT, bool kZp>
__global__ void __launch_bounds__(kThreads)
gmm_mixed_wo_wxa_decode_kernel(const __nv_bfloat16* __restrict__ lhs,
                               const int8_t* __restrict__ lhs_q,
                               const float* __restrict__ s_a,
                               const int8_t* __restrict__ rhs,
                               const float* __restrict__ s_b,
                               const float* __restrict__ zp,
                               const int* __restrict__ flags,
                               const int* __restrict__ group_sizes,
                               OutT* __restrict__ out, int* __restrict__ ws,
                               int* __restrict__ tickets, int M, int K, int N,
                               int E, int gsize, int kt_per_split) {
  __shared__ __align__(16) unsigned char ring[kWoDecBytes];
  __shared__ int sizes[kMaxExperts];
  __shared__ int tile_info[4];       // expert, first row, row begin, row end
  __shared__ int is_last;

  if (!block_tile<DBM>(group_sizes, E, M, sizes, tile_info)) return;
  const int e = tile_info[0];
  const int m0 = tile_info[1], row_lo = tile_info[2], row_hi = tile_info[3];
  if (flags[e] != 0) {
    const size_t srow = (size_t)e * (K / gsize) * N;
    wo_decode_body<OutT, false>(
        lhs, rhs + (size_t)e * K * N, s_b + srow, kZp ? zp + srow : nullptr, out,
        reinterpret_cast<float*>(ws), tickets, K, N, gsize, kt_per_split, m0,
        row_lo, row_hi, reinterpret_cast<WoStage<false>*>(ring), is_last);
  } else {
    grouped_decode_body<OutT, kZp, false>(
        lhs_q, s_a, rhs, s_b, zp, nullptr, nullptr, out, ws, tickets, K, N, gsize,
        kt_per_split, e, m0, row_lo, row_hi,
        reinterpret_cast<GdStage<false>*>(ring), nullptr, nullptr, is_last);
  }
}

// sc: bm GBM (the 32 x 128 tiles) or DBM (decode: grid_m x splits, ws /
// tickets when splits > 1)
template <typename OutT, bool kZp>
cudaError_t launch_mixed_typed(const __nv_bfloat16* lhs, const int8_t* lhs_q,
                               const float* s_a, const int8_t* rhs, const float* s_b,
                               const float* zp, const int* flags, const int* gs,
                               void* out, int M, int K, int N, int E, int gsize,
                               const Int8Schedule& sc, cudaStream_t st) {
  if (M > 0) {
    OutT* o = static_cast<OutT*>(out);
    if (sc.bm == DBM) {
      dim3 grid((N + DBN - 1) / DBN, sc.grid_m, sc.splits);
      gmm_mixed_wo_wxa_decode_kernel<OutT, kZp><<<grid, kThreads, 0, st>>>(
          lhs, lhs_q, s_a, rhs, s_b, zp, flags, gs, o, sc.ws, sc.tickets, M, K, N,
          E, gsize, sc.kt_per_split);
    } else if (sc.bm == GBM) {
      dim3 grid((N + BN - 1) / BN, sc.grid_m);
      gmm_mixed_wo_wxa_kernel<OutT, kZp><<<grid, kThreads, 0, st>>>(
          lhs, lhs_q, s_a, rhs, s_b, zp, flags, gs, o, M, K, N, E, gsize);
    } else {
      return cudaErrorInvalidValue;
    }
  }
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_mixed(const __nv_bfloat16* lhs, const int8_t* lhs_q,
                         const float* s_a, const int8_t* rhs, const float* s_b,
                         const float* zp, const int* flags, const int* gs,
                         void* out, int M, int K, int N, int E, int gsize,
                         const Int8Schedule& sc, cudaStream_t st) {
  return zp != nullptr
      ? launch_mixed_typed<OutT, true>(lhs, lhs_q, s_a, rhs, s_b, zp, flags, gs,
                                       out, M, K, N, E, gsize, sc, st)
      : launch_mixed_typed<OutT, false>(lhs, lhs_q, s_a, rhs, s_b, zp, flags, gs,
                                        out, M, K, N, E, gsize, sc, st);
}

}  // namespace

// the schedule as mxmoe_gmm_w8a8_grouped's: bm, grid_m, splits, k-tiles per
// split, workspace, tickets
extern "C" int mxmoe_gmm_mixed_wo_wxa(const void* lhs, const void* lhs_q,
                                      const void* s_a, const void* rhs,
                                      const void* s_b, const void* zp,
                                      const void* scheme_flags,
                                      const void* group_sizes, void* out,
                                      int out_is_bf16, int M, int K, int N, int E,
                                      int gsize, int bm, int grid_m, int splits,
                                      int kt_per_split, void* ws, void* tickets,
                                      void* stream) {
  if (bm == WQ_BM)
    return gmm_wq_launch<kWqMixed, false>(lhs, lhs_q, s_a, rhs, s_b, zp, scheme_flags,
                                          group_sizes, out, out_is_bf16, M, K, N, E,
                                          gsize, stream);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* a = static_cast<const __nv_bfloat16*>(lhs);
  const int8_t* aq = static_cast<const int8_t*>(lhs_q);
  const int8_t* b = static_cast<const int8_t*>(rhs);
  const float* sa = static_cast<const float*>(s_a);
  const float* sb = static_cast<const float*>(s_b);
  const float* z = static_cast<const float*>(zp);
  const int* fl = static_cast<const int*>(scheme_flags);
  const int* gs = static_cast<const int*>(group_sizes);
  const Int8Schedule sc{bm, grid_m, splits, kt_per_split, static_cast<int*>(ws),
                        static_cast<int*>(tickets)};
  cudaError_t err = out_is_bf16
      ? launch_mixed<__nv_bfloat16>(a, aq, sa, b, sb, z, fl, gs, out, M, K, N, E,
                                    gsize, sc, st)
      : launch_mixed<float>(a, aq, sa, b, sb, z, fl, gs, out, M, K, N, E, gsize,
                            sc, st);
  return (int)err;
}
