// Device code shared by the weight-only (a16) grouped GEMMs over
// expert-sorted rows: K6 gmm_weight_only (gmm_weight_only.cu, codes stored
// [E, K, N] int8) and K7 gmm_weight_only_packed (gmm_weight_only_packed.cu,
// 4-bit codes nibble-packed [E, K/2, N] in the halves layout: byte row r
// holds code k = r in the low nibble and k = r + K/2 in the high nibble).
// One templated device function computes a block's 32 x 128 output tile; the
// storage is a template parameter. The weight-only experts of K10
// gmm_mixed_wo_wxa (gmm_mixed_wo_wxa.cu) run it too.
//
//   w[e,k,n]  = bf16( (float)q[e,k,n] * scale[e, k/gsize, n] + zp[e, k/gsize, n] )
//   out[r, n] = OutT( sum_k lhs[r,k] * w[e,k,n] )        (f32 accumulation)
//
// The multiply and the add of the dequantization round separately
// (__fmul_rn, __fadd_rn), as the plain version's unfused expression does.
//
// Both storages walk K the same way, so that they give bitwise the same
// output for the same codes although f32 sums depend on their order: for
// r0 = 0, 64, ... below K/2 the block multiplies the code rows [r0, r0 + 64)
// against the same lhs columns, then the rows [K/2 + r0, K/2 + r0 + 64).
// For the packed storage that pair is one byte tile; the int8 storage loads
// the two row blocks. A row's scale group is k / gsize of its own k, so a
// group may span the two halves (K/2 = 704 with gsize 128 puts rows 640..767
// in group 5): the group index is taken per 4-row unit, never per tile.
//
// Tiles: 4 warps, a 32 x 128 block tile (16 x 64 per warp), K in steps of 64;
// mma.sync m16n8k16 bf16 with f32 accumulators. The lhs tile is staged as
// it is. A code tile is dequantized in registers and staged as bf16 pairs
// (k, k + 1) per column, [k/2][n] words: the B fragment reads are
// conflict-free (stride 136 words) and each thread stores its 4(k) x 4(n)
// unit as two 16-byte rows. The next step's global loads are started into
// registers before the current step's MMAs.

#pragma once

#include "gmm_tile_walk.cuh"

namespace {

constexpr int WBM = 32, WBN = 128, WBK = 64;
constexpr int WA_STRIDE = WBK + 8;               // bf16 elements per A row
constexpr int WB_STRIDE = WBN + 8;               // words per k-pair row of B
constexpr int WA_TILE = WBM * WA_STRIDE;         // bf16 elements
constexpr int WB_TILE = (WBK / 2) * WB_STRIDE;   // 32-bit words

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// one code (byte `byte` of word q, a signed int8) -> its bf16 weight bits
__device__ __forceinline__ uint32_t dequant_bits(uint32_t q, int byte, float s,
                                                 float z) {
  const float c = (float)(int8_t)(q >> (8 * byte));
  return (uint32_t)__bfloat16_as_ushort(
      __float2bfloat16_rn(__fadd_rn(__fmul_rn(c, s), z)));
}

// 4(k) x 4(n) int8 codes (one word per k row) -> two k-pair rows of four
// bf16x2 words, at brow[0..3] and brow[WB_STRIDE + 0..3]
__device__ __forceinline__ void store_w_unit(uint32_t* brow, const uint32_t (&q)[4],
                                             const float4& s, const float4& z) {
  const float sv[4] = {s.x, s.y, s.z, s.w}, zv[4] = {z.x, z.y, z.z, z.w};
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    uint32_t wds[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      wds[c] = dequant_bits(q[2 * p], c, sv[c], zv[c])
               | (dequant_bits(q[2 * p + 1], c, sv[c], zv[c]) << 16);
    *reinterpret_cast<uint4*>(brow + p * WB_STRIDE) =
        make_uint4(wds[0], wds[1], wds[2], wds[3]);
  }
}

// acc += As[32, 64] x Bs[64, 128] for this warp's 16 x 64 part
__device__ __forceinline__ void mma_w_tile(const __nv_bfloat16* As,
                                           const uint32_t* Bs, float (&acc)[8][4],
                                           int wm, int wn, int gr, int tq) {
#pragma unroll
  for (int ks = 0; ks < WBK; ks += 16) {
    uint32_t a[4];
    const __nv_bfloat16* p = As + (wm + gr) * WA_STRIDE + ks + tq * 2;
    a[0] = *reinterpret_cast<const uint32_t*>(p);
    a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * WA_STRIDE);
    a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
    a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * WA_STRIDE + 8);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t* q = Bs + (ks / 2 + tq) * WB_STRIDE + wn + j * 8 + gr;
      mma_bf16(acc[j], a, q[0], q[4 * WB_STRIDE]);
    }
  }
}

// One block's tile of expert rows [row_lo, row_hi) starting at row m0,
// columns from n0. w: the expert's code block; sc / zb: its [G, N] scales and
// zero points (zb may be null: no zero points). As: 2 * WA_TILE bf16, Bs:
// 2 * WB_TILE words of shared memory, 16-byte aligned ([0]: code rows r0..
// with k < K/2; [1]: code rows K/2 + r0..).
template <typename OutT, bool kPacked>
__device__ __forceinline__ void wo_tile_body(
    const __nv_bfloat16* __restrict__ lhs, const int8_t* __restrict__ w,
    const float* __restrict__ sc, const float* __restrict__ zb,
    OutT* __restrict__ out, int K, int N, int gsize, int m0, int row_lo,
    int row_hi, int n0, __nv_bfloat16* As, uint32_t* Bs) {
  const int tid = threadIdx.x;
  const int K2 = K / 2;

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 1) * 16, wn = (warp & 1) * 64;
  const int gr = lane >> 2, tq = lane & 3;

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.0f;

  // global -> registers for one step (started a step ahead of its use)
  constexpr int kCodeTiles = kPacked ? 1 : 2;
  int4 ra[2][2];
  uint32_t rb[kCodeTiles][4][4];
  auto load_step = [&](int r0) {
    // A: 2 x (32 rows x 64 bf16), 16-byte chunks; other experts' rows -> 0
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      const int row = m0 + (c >> 3), k = r0 + (c & 7) * 8;
      const bool live = row >= row_lo && row < row_hi && k < K2;
      ra[0][i] = ra[1][i] = make_int4(0, 0, 0, 0);
      if (live) {
        const __nv_bfloat16* p = lhs + (size_t)row * K + k;
        ra[0][i] = *reinterpret_cast<const int4*>(p);
        ra[1][i] = *reinterpret_cast<const int4*>(p + K2);
      }
    }
    // codes: 4(k) x 4(n) byte units
#pragma unroll
    for (int t = 0; t < kCodeTiles; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int u = tid + i * kThreads;
        const int k = r0 + (u >> 5) * 4, n = n0 + (u & 31) * 4;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          rb[t][i][j] = (n < N && k + j < K2)
              ? *reinterpret_cast<const uint32_t*>(
                    w + (size_t)(t * K2 + k + j) * N + n)
              : 0u;
      }
  };
  // registers -> shared; the codes dequantized to bf16 on the way
  auto store_step = [&](int r0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      const int off = (c >> 3) * WA_STRIDE + (c & 7) * 8;
      *reinterpret_cast<int4*>(As + off) = ra[0][i];
      *reinterpret_cast<int4*>(As + WA_TILE + off) = ra[1][i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = tid + i * kThreads;
      const int kl = (u >> 5) * 4, nl = (u & 31) * 4;
      const bool live = n0 + nl < N && r0 + kl < K2;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        uint32_t q[4] = {0u, 0u, 0u, 0u};
        float4 s = make_float4(0.f, 0.f, 0.f, 0.f), z = s;
        if (live) {
          // the unit's four rows lie in one scale group (gsize % 4 == 0)
          const size_t srow = (size_t)((t * K2 + r0 + kl) / gsize) * N + n0 + nl;
          s = *reinterpret_cast<const float4*>(sc + srow);
          if (zb != nullptr) z = *reinterpret_cast<const float4*>(zb + srow);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if constexpr (kPacked)
              q[j] = sext4((rb[0][i][j] >> (4 * t)) & 0x0F0F0F0Fu);
            else
              q[j] = rb[t][i][j];
          }
        }
        // a unit past the edge stores zeros (code 0, scale 0, zp 0)
        store_w_unit(Bs + t * WB_TILE + (kl / 2) * WB_STRIDE + nl, q, s, z);
      }
    }
  };

  load_step(0);
  for (int r0 = 0; r0 < K2; r0 += WBK) {
    store_step(r0);
    __syncthreads();
    if (r0 + WBK < K2) load_step(r0 + WBK);   // in flight during the MMAs
    mma_w_tile(As, Bs, acc, wm, wn, gr, tq);
    mma_w_tile(As + WA_TILE, Bs + WB_TILE, acc, wm, wn, gr, tq);
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

template <typename OutT, bool kPacked>
__global__ void __launch_bounds__(kThreads)
gmm_wo_kernel(const __nv_bfloat16* __restrict__ lhs,
              const int8_t* __restrict__ rhs, const float* __restrict__ scale,
              const float* __restrict__ zp, const int* __restrict__ group_sizes,
              OutT* __restrict__ out, int M, int K, int N, int E, int gsize) {
  __shared__ __align__(16) __nv_bfloat16 As[2 * WA_TILE];
  __shared__ __align__(16) uint32_t Bs[2 * WB_TILE];
  __shared__ int sizes[kMaxExperts];
  __shared__ int tile_info[4];       // expert, first row, row begin, row end

  if (!block_tile<WBM>(group_sizes, E, M, sizes, tile_info)) return;
  const int e = tile_info[0];
  const size_t srow = (size_t)e * (K / gsize) * N;
  wo_tile_body<OutT, kPacked>(
      lhs, rhs + (size_t)e * (kPacked ? K / 2 : K) * N, scale + srow, zp + srow,
      out, K, N, gsize, tile_info[1], tile_info[2], tile_info[3],
      blockIdx.x * WBN, As, Bs);
}

// the C entry points' common body
template <bool kPacked>
int gmm_wo_launch(const void* lhs, const void* rhs, const void* scale,
                  const void* zp, const void* group_sizes, void* out,
                  int out_is_bf16, int M, int K, int N, int E, int gsize,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M > 0) {
    const __nv_bfloat16* a = static_cast<const __nv_bfloat16*>(lhs);
    const int8_t* b = static_cast<const int8_t*>(rhs);
    const float* s = static_cast<const float*>(scale);
    const float* z = static_cast<const float*>(zp);
    const int* gs = static_cast<const int*>(group_sizes);
    dim3 grid((N + WBN - 1) / WBN, (M + WBM - 1) / WBM + E - 1);
    if (out_is_bf16)
      gmm_wo_kernel<__nv_bfloat16, kPacked><<<grid, kThreads, 0, st>>>(
          a, b, s, z, gs, static_cast<__nv_bfloat16*>(out), M, K, N, E, gsize);
    else
      gmm_wo_kernel<float, kPacked><<<grid, kThreads, 0, st>>>(
          a, b, s, z, gs, static_cast<float*>(out), M, K, N, E, gsize);
  }
  return (int)cudaGetLastError();
}

}  // namespace
