// Device code shared by the weight-only (a16) grouped GEMMs over
// expert-sorted rows: K6 gmm_weight_only (gmm_weight_only.cu, codes stored
// [E, K, N] int8) and K7 gmm_weight_only_packed (gmm_weight_only_packed.cu,
// 4-bit codes nibble-packed [E, K/2, N] in the halves layout: byte row r
// holds code k = r in the low nibble and k = r + K/2 in the high nibble).
// The weight-only experts of K10 gmm_mixed_wo_wxa (gmm_mixed_wo_wxa.cu) run
// the same bodies. Two schedules, chosen by the wrapper from the shapes
// (ops/gmm_w8a8_grouped.py::weight_only_gmm_schedule, shared by K6, K7 and
// K10): the prefill body wo_tile_body (a block's 32 x 128 output tile) and,
// for M <= DECODE_M, the decode body wo_decode_body.
//
//   w[e,k,n]  = bf16( (float)q[e,k,n] * scale[e, k/gsize, n] + zp[e, k/gsize, n] )
//   out[r, n] = OutT( sum_k lhs[r,k] * w[e,k,n] )        (f32 accumulation)
//
// The multiply and the add of the dequantization round separately
// (__fmul_rn, __fadd_rn), as the plain version's unfused expression does;
// an FMA would round once and change the weights.
//
// Both storages walk K the same way, so that they give bitwise the same
// output for the same codes although f32 sums depend on their order: for
// r0 = 0, 64, ... below K/2 the block multiplies the code rows [r0, r0 + 64)
// against the same lhs columns, then the rows [K/2 + r0, K/2 + r0 + 64).
// For the packed storage that pair is one byte tile; the int8 storage loads
// the two row blocks.
//
// Prefill body: 4 warps, a 32 x 128 block tile (16 x 64 per warp), K in
// steps of 64; mma.sync m16n8k16 bf16 with f32 accumulators. The lhs tile is
// staged as it is. A code tile is dequantized in registers and staged as
// bf16 pairs (k, k + 1) per column, [k/2][n] words: the B fragment reads are
// conflict-free (stride 136 words) and each thread stores its 4(k) x 4(n)
// unit as two 16-byte rows. The next step's global loads are started into
// registers before the current step's MMAs. A row's scale group is k / gsize
// of its own k, so a group may span the two halves (K/2 = 704 with gsize 128
// puts rows 640..767 in group 5): the group index is taken per 4-row unit.
//
// Decode body. At decode ~16 routed rows fall on 14-16 experts, so the 32-row
// tile held 1-2 live rows, 4-byte register loads ran one step ahead, and
// every code went through an I2F (an eighth of the f32 rate on sm_90) and a
// bf16 restage through shared memory between two barriers. Here a block is
// one m16 row block x 64 columns (4 warps x 16 columns), the m-tiles bounded
// by M. K is walked in byte-tile pairs (code rows [r0, r0 + 64) and [K/2 +
// r0, ..)); a ring stage holds one 4 KB raw code tile and what its codes
// meet: packed, the byte tile of a pair with both bf16 A tiles (lhs columns
// [r0, r0 + 64) and [K/2 + r0, ..)) and both halves' scale and zp rows over
// the block's 64 columns; int8, one half of a pair (two stages a pair) with
// its A tile and scale row. It goes through a four-deep cp.async ring (rows
// outside the expert, k past the half and columns past N zero-filled;
// K2 % 64 == 0 when G > 1, so each half-tile lies in one scale group).
// ldmatrix.trans reads a code tile's 8 x 16-byte rows as a transposed 8 x 8
// b16 matrix, so a lane gets the codes of two adjacent columns (2g, 2g + 1)
// at two adjacent k: both bf16 B fragment registers of two n8 MMAs (MMA j
// takes the columns 2s + j; the lane's four outputs of a row are then four
// adjacent columns). A code becomes an f32 without I2F: its biased byte
// (int8 ^ 0x80, or a nibble ^ 0x8) is permuted into the mantissa of 2^23,
// and 2^23 + bias is subtracted (exact for every code). Then __fmul_rn,
// __fadd_rn and one cvt.rn.bf16x2.f32 for two weights: the bf16 bits are
// dequantize_expert's. The low and high halves accumulate into two f32 sets
// (mma.sync m16n8k16), added once at the end. Where the grid is short, the
// byte-tile pairs are split over gridDim.z (ceil(P / splits) pairs a split,
// P = ceil(K/2 / 64)): each split writes its f32 lo + hi partial (the tile's
// live rows) to a workspace, and the tile's last block (an atomic ticket)
// adds the partials in ascending split order. No float atomics: the output
// is the same from run to run, and K6, K7 and K10 agree bitwise on one
// schedule.
//
// Two choices, each measured on the card (PERF.md §6). The walk: of the two
// orders that keep K7 = K6, byte-tile pairs let a packed tile be read once;
// logical k-tiles for both storages would read it twice, as the grouped
// decode body's logical walk of a packed expert does (0.0456 ms against its
// one-pass walk's 0.0394). The product: mma.sync, not CUDA-core FMAs on
// the 1-4 live rows. A variant with no product at all kept 89-98 % of this
// body's time (bench/variant_ab.py), so FMAs added to the same
// dequantization cannot be faster.
// One code tile a stage (int8 storage: a half-pair, not a pair) keeps the
// ring at 27.6 KB and the kernel at 70 registers, so six blocks fit an SM;
// a pair a stage, three deep, took 41.5 KB and 108 registers (four).

#pragma once

#include "gmm_int8_tile.cuh"

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

// ---------------------------------------------------------------------------
// The decode schedule
// ---------------------------------------------------------------------------

constexpr int WO_A_STRIDE = DBK + 8;              // bf16 a row: 144 bytes
constexpr int WO_A_TILE = DBM * WO_A_STRIDE;      // bf16 elements

// ring depth (steps in flight + 1)
template <bool kPacked>
constexpr int kWoStages = 4;

// One ring stage of the decode body: one code tile and the operands its
// codes meet. Packed storage: a byte tile, both halves of a pair (A columns
// [r0, +64) and [K/2 + r0, +64), both halves' scale rows). Int8 storage: one
// half of a pair (its A columns and scale row); a pair takes two stages.
template <bool kPacked>
struct __align__(16) WoStage {
  static constexpr int kHalves = kPacked ? 2 : 1;
  __nv_bfloat16 a[kHalves][WO_A_TILE];    // bf16 lhs rows, 144-byte stride
  int8_t b[DBK * DBN];                    // raw code tile, pieces swizzled
  float s[kHalves][2][DBN];               // [half][scale, zp][64 columns]
};

// byte offset of 16-byte piece `chunk` of code row k in a raw tile: the
// pieces of rows 2i, 2i + 1 are rotated by i % 4, so the 8 rows an
// ldmatrix phase reads fall in 8 different bank groups
__device__ __forceinline__ int wo_swz(int k, int chunk) {
  return k * DBN + ((chunk ^ ((k >> 1) & 3)) << 4);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// byte i of u (a code plus kBias, 0..255) -> the code as an f32, exactly:
// 2^23 + u in the mantissa of 2^23, less 2^23 + kBias
template <int kBias>
__device__ __forceinline__ float biased_code(uint32_t u, int i) {
  const float f = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | i));
  return __fsub_rn(f, 8388608.0f + (float)kBias);
}

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// a transposed ldmatrix register of biased codes, bytes (k, c), (k, c + 1),
// (k + 1, c), (k + 1, c + 1), -> the bf16x2 B registers of columns c (b0)
// and c + 1 (b1), low half k; s / z: the two columns' scale and zp
template <int kBias>
__device__ __forceinline__ void wo_dequant4(uint32_t u, float2 s, float2 z,
                                            uint32_t& b0, uint32_t& b1) {
  const float w0 = __fadd_rn(__fmul_rn(biased_code<kBias>(u, 0), s.x), z.x);
  const float w1 = __fadd_rn(__fmul_rn(biased_code<kBias>(u, 1), s.y), z.y);
  const float w2 = __fadd_rn(__fmul_rn(biased_code<kBias>(u, 2), s.x), z.x);
  const float w3 = __fadd_rn(__fmul_rn(biased_code<kBias>(u, 3), s.y), z.y);
  b0 = bf16x2_bits(w0, w2);
  b1 = bf16x2_bits(w1, w3);
}

// acc[j] += A (16 rows x 64 k, `at`) x the dequantized codes of the raw
// tile `bt` for the warp's columns wn + 2g + j (g = lane / 4). kNib: 0 int8
// codes, 1 the low nibbles, 2 the high nibbles of packed bytes. s_row /
// z_row: the half's scale and zp over the tile's 64 columns. Both storages
// run the same MMAs on the same operands in the same order.
template <int kNib>
__device__ __forceinline__ void wo_mma_half(float (&acc)[2][4],
                                            const __nv_bfloat16* at,
                                            const int8_t* bt, const float* s_row,
                                            const float* z_row, int wn, int lane) {
  constexpr int kBias = kNib == 0 ? 128 : 8;
  const int c2 = wn + 2 * (lane >> 2);    // this lane's two dequantized columns
  const float2 s = *reinterpret_cast<const float2*>(s_row + c2);
  const float2 z = *reinterpret_cast<const float2*>(z_row + c2);
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8, acol = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < DBK; kk += 32) {
    // code rows kk..kk+31 of the warp's 16-byte column piece, transposed,
    // biased to 0..255
    uint32_t q[4];
    ldsm_x4_trans(q, bt + wo_swz(kk + lane, wn >> 4));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (kNib == 0) q[i] ^= 0x80808080u;
      else if constexpr (kNib == 1) q[i] = (q[i] & 0x0F0F0F0Fu) ^ 0x08080808u;
      else q[i] = ((q[i] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {         // two k16 steps
      uint32_t a[4], b00, b10, b01, b11;  // b<column j><k rows 0-7 | 8-15>
      ldsm_x4(a, at + arow * WO_A_STRIDE + kk + 16 * h + acol);
      wo_dequant4<kBias>(q[2 * h], s, z, b00, b10);
      wo_dequant4<kBias>(q[2 * h + 1], s, z, b01, b11);
      mma_bf16(acc[0], a, b00, b01);
      mma_bf16(acc[1], a, b10, b11);
    }
  }
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(bf16x2_bits(v[0], v[1]),
                                            bf16x2_bits(v[2], v[3]));
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// One block of the decode schedule: expert rows [row_lo, row_hi) of the m16
// tile from m0, the 64 columns from n0 = blockIdx.x * 64, the byte-tile
// pairs of split blockIdx.z. w: the expert's storage block ([K, N] int8, or
// [K/2, N] packed); sc / zb: its [G, N] scales and zero points (zb may be
// null: zero points 0). Split-K (gridDim.z > 1): ws laid out as the w x a
// body's [tiles, splits, gmax, D_PART] (gmax = kt_per_split * 64 / gsize
// groups a split, 1 when G = 1: the schedule sizes it for K10's two bodies
// at once), split z's f32 partial (the tile's live rows of its m16 x 64)
// at slot (tile, z, 0); tickets [tiles] (zero). st: kWoStages<kPacked> ring
// stages of shared memory; is_last a shared int.
template <typename OutT, bool kPacked>
__device__ __forceinline__ void wo_decode_body(
    const __nv_bfloat16* __restrict__ lhs, const int8_t* __restrict__ w,
    const float* __restrict__ sc, const float* __restrict__ zb,
    OutT* __restrict__ out, float* __restrict__ ws, int* __restrict__ tickets,
    int K, int N, int gsize, int kt_per_split, int m0, int row_lo, int row_hi,
    WoStage<kPacked>* st, int& is_last) {
  constexpr int kStages = kWoStages<kPacked>;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3, wn = warp * 16;
  const int n0 = blockIdx.x * DBN;
  const int K2 = K / 2;
  const int P = (K2 + DBK - 1) / DBK;            // byte-tile pairs
  const int S = gridDim.z;
  const int pps = (P + S - 1) / S;
  const int p0 = blockIdx.z * pps;
  const int np = max(min(p0 + pps, P) - p0, 0);
  // the tile's live rows [rb, re) relative to m0
  const int rb = max(row_lo, m0) - m0, re = min(row_hi, m0 + DBM) - m0;

  // ring step t of this split -> stage t % kStages (one commit group): pair
  // p0 + t (packed) or half t % 2 of pair p0 + t / 2 (int8)
  using Stage = WoStage<kPacked>;
  constexpr int kSteps = kPacked ? 1 : 2;   // ring steps a pair
  const int nsteps = np * kSteps;
  auto issue = [&](int t) {
    if (t < nsteps) {
      const int r0 = (p0 + t / kSteps) * DBK, h0 = kPacked ? 0 : (t & 1);
      Stage& sg = st[t % kStages];
#pragma unroll
      for (int i = 0; i < Stage::kHalves; ++i) {   // A: 16 rows x 8 pieces a half
        const int c = tid + i * kThreads, h = c >> 7;
        const int row = (c >> 3) & 15, pc = c & 7;
        const int k = r0 + pc * 8, grow = m0 + row;
        const bool live = grow >= row_lo && grow < row_hi && k < K2;
        cp_async16(&sg.a[h][row * WO_A_STRIDE + pc * 8],
                   live ? lhs + (size_t)grow * K + (h + h0) * K2 + k : lhs,
                   live ? 16 : 0);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {       // B: 64 rows x 4 pieces
        const int u = tid + i * kThreads, r = u >> 2, c = u & 3;
        const int k = r0 + r, col = n0 + c * 16;
        const bool ok = k < K2 && col < N;
        cp_async16(&sg.b[wo_swz(r, c)],
                   ok ? w + (size_t)(h0 * K2 + k) * N + col : w, ok ? 16 : 0);
      }
      if (tid < Stage::kHalves * 32) {    // the halves' scale and zp rows
        const int h = tid >> 5, which = (tid >> 4) & 1, c = tid & 15;
        const int col = n0 + c * 4;
        const bool ok = col < N && (which == 0 || zb != nullptr);
        const size_t off = (size_t)(((h + h0) * K2 + r0) / gsize) * N + col;
        cp_async16(&sg.s[h][which][c * 4], ok ? (which ? zb : sc) + off : sc,
                   ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  float lo[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  float hi[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) issue(t);
  for (int t = 0; t < nsteps; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                      // step t landed; stage t - 1 is free
    issue(t + kStages - 1);
    const Stage& sg = st[t % kStages];
    if constexpr (kPacked) {
      wo_mma_half<1>(lo, sg.a[0], sg.b, sg.s[0][0], sg.s[0][1], wn, lane);
      wo_mma_half<2>(hi, sg.a[1], sg.b, sg.s[1][0], sg.s[1][1], wn, lane);
    } else if (t & 1) {
      wo_mma_half<0>(hi, sg.a[0], sg.b, sg.s[0][0], sg.s[0][1], wn, lane);
    } else {
      wo_mma_half<0>(lo, sg.a[0], sg.b, sg.s[0][0], sg.s[0][1], wn, lane);
    }
  }
  cp_async_wait<0>();

  // acc[h][c]: row gr + 8h, column n0 + wn + 4 tq + c
  float acc[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    acc[h][0] = __fadd_rn(lo[0][2 * h], hi[0][2 * h]);
    acc[h][1] = __fadd_rn(lo[1][2 * h], hi[1][2 * h]);
    acc[h][2] = __fadd_rn(lo[0][2 * h + 1], hi[0][2 * h + 1]);
    acc[h][3] = __fadd_rn(lo[1][2 * h + 1], hi[1][2 * h + 1]);
  }
  const int cw = wn + 4 * tq;             // the lane's four columns in the tile

  if (S > 1) {
    // the partials: [split][live row][64], the tile's last block adds them
    // in ascending split order (splits past the last pair write none)
    const size_t tile = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    const int gmax = gsize == K ? 1 : kt_per_split * DBK / gsize;
    const int stride = gmax * D_PART;     // floats from one split's slot to the next
    float* parts = ws + tile * S * stride;
    if (np > 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = gr + 8 * h;
        if (r >= rb && r < re)
          *reinterpret_cast<float4*>(parts + (size_t)blockIdx.z * stride +
                                     (r - rb) * DBN + cw) =
              make_float4(acc[h][0], acc[h][1], acc[h][2], acc[h][3]);
      }
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      is_last = atomicAdd(tickets + tile, 1) == S - 1;
      if (is_last) tickets[tile] = 0;     // every split has its ticket
    }
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    const int used = (P + pps - 1) / pps;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = gr + 8 * h;
      if (r < rb || r >= re) continue;
      const float* src = parts + (r - rb) * DBN + cw;
      float4 v = __ldcg(reinterpret_cast<const float4*>(src));
      for (int z = 1; z < used; ++z) {
        const float4 p = __ldcg(reinterpret_cast<const float4*>(src + z * stride));
        v.x = __fadd_rn(v.x, p.x);
        v.y = __fadd_rn(v.y, p.y);
        v.z = __fadd_rn(v.z, p.z);
        v.w = __fadd_rn(v.w, p.w);
      }
      acc[h][0] = v.x;
      acc[h][1] = v.y;
      acc[h][2] = v.z;
      acc[h][3] = v.w;
    }
  }

  if (n0 + cw >= N) return;               // N % 16 == 0: four columns or none
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = gr + 8 * h;
    if (r >= rb && r < re) store4(out + (size_t)(m0 + r) * N + n0 + cw, acc[h]);
  }
}

template <typename OutT, bool kPacked>
__global__ void __launch_bounds__(kThreads)
gmm_wo_decode_kernel(const __nv_bfloat16* __restrict__ lhs,
                     const int8_t* __restrict__ rhs, const float* __restrict__ scale,
                     const float* __restrict__ zp, const int* __restrict__ group_sizes,
                     OutT* __restrict__ out, float* __restrict__ ws,
                     int* __restrict__ tickets, int M, int K, int N, int E,
                     int gsize, int kt_per_split) {
  __shared__ WoStage<kPacked> st[kWoStages<kPacked>];
  __shared__ int sizes[kMaxExperts];
  __shared__ int tile_info[4];       // expert, first row, row begin, row end
  __shared__ int is_last;

  if (!block_tile<DBM>(group_sizes, E, M, sizes, tile_info)) return;
  const int e = tile_info[0];
  const size_t srow = (size_t)e * (K / gsize) * N;
  wo_decode_body<OutT, kPacked>(
      lhs, rhs + (size_t)e * (kPacked ? K / 2 : K) * N, scale + srow, zp + srow,
      out, ws, tickets, K, N, gsize, kt_per_split, tile_info[1], tile_info[2],
      tile_info[3], st, is_last);
}

// the C entry points' common body. The schedule (weight_only_gmm_schedule,
// the arguments of mxmoe_gmm_w8a8_grouped's): bm WBM (prefill body over
// grid_m logical m-tiles) or DBM (the decode body, grid_m x splits; ws /
// tickets when splits > 1). k_tiles_per_split is the w x a body's unit
// (logical k-tiles at whole groups): the weight-only body splits byte-tile
// pairs evenly over the splits and reads it only for the workspace's layout.
template <bool kPacked>
int gmm_wo_launch(const void* lhs, const void* rhs, const void* scale,
                  const void* zp, const void* group_sizes, void* out,
                  int out_is_bf16, int M, int K, int N, int E, int gsize, int bm,
                  int grid_m, int splits, int kt_per_split, void* ws,
                  void* tickets, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M > 0) {
    const __nv_bfloat16* a = static_cast<const __nv_bfloat16*>(lhs);
    const int8_t* b = static_cast<const int8_t*>(rhs);
    const float* s = static_cast<const float*>(scale);
    const float* z = static_cast<const float*>(zp);
    const int* gs = static_cast<const int*>(group_sizes);
    float* w = static_cast<float*>(ws);
    int* tk = static_cast<int*>(tickets);
    if (bm == DBM) {
      dim3 grid((N + DBN - 1) / DBN, grid_m, splits);
      if (out_is_bf16)
        gmm_wo_decode_kernel<__nv_bfloat16, kPacked><<<grid, kThreads, 0, st>>>(
            a, b, s, z, gs, static_cast<__nv_bfloat16*>(out), w, tk, M, K, N, E,
            gsize, kt_per_split);
      else
        gmm_wo_decode_kernel<float, kPacked><<<grid, kThreads, 0, st>>>(
            a, b, s, z, gs, static_cast<float*>(out), w, tk, M, K, N, E, gsize,
            kt_per_split);
    } else if (bm == WBM) {
      dim3 grid((N + WBN - 1) / WBN, grid_m);
      if (out_is_bf16)
        gmm_wo_kernel<__nv_bfloat16, kPacked><<<grid, kThreads, 0, st>>>(
            a, b, s, z, gs, static_cast<__nv_bfloat16*>(out), M, K, N, E, gsize);
      else
        gmm_wo_kernel<float, kPacked><<<grid, kThreads, 0, st>>>(
            a, b, s, z, gs, static_cast<float*>(out), M, K, N, E, gsize);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace
