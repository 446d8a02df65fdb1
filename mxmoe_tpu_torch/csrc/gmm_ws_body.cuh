// The persistent wgmma body of the int8 grouped GEMM at large M, shared by
// K15 (gmm_ws.cu: group sizes by value, every group a multiple of 128 rows),
// K2 / K5 / K4 above the decode rows (gmm_w8a8.cu, gmm_w4a8_packed.cu,
// gmm_mixed_packed.cu) and K14's second phase (gmm_w8a8_fusedquant.cu),
// which read the group sizes from an int32 tensor on the device and take
// groups that start at any row.
//
//   out[r, n] = OutT( ((float)(sum_k lhs[r,k] * w[e,k,n]) * s_a[r]) * s_b[e,n] )
//
// K2's function (K5's for nibble-packed weights, halves layout: byte row r
// holds code r in its low nibble and code K/2 + r in its high one), bitwise
// K2 / K5: the int32 sum is exact (K x 127 x 127 < 2^31 at every width the
// port runs), so its order is free, and the epilogue is K2's, rounded once.
//
// Bound on the H100: operations at the headline's rows (1.13 TOP a layer
// against ~0.2 GB of operands); weight bytes at a 256-token prefill chunk
// (17-25 rows an expert). What limits the body below either is what feeds
// the tensor cores: wgmma is the only route to the int8 rate, and a
// 128 x 256 tile needs 48 KB from L2 per 128-deep k-tile.
//
// Design. A persistent grid, one CTA an SM, walks the work items (group,
// n-tile of 256 columns, m-tile of 128 rows) in that order, CTA c taking
// items c, c + grid, ... (ops/gmm_ws.py::ws_device_work_items is the same
// walk): the m-tiles of one n-column run side by side on neighbouring CTAs,
// so the group's weight tile is read from device memory once and from L2
// after. A group's m-tiles start at the group's own first row, so a tile
// may hold rows of the next group or rows past M: they are multiplied (past
// M the TMA box reads zeros) and not stored. Each CTA advances its own
// cursor over the groups (WsWalk), reading a group's size when it reaches
// it: by value (K15) or from device memory through the read-only cache
// (WsDeviceSizes; the 224 KB of rings leave no room for 1024 sizes in shared
// memory). Stored rows of group g are [start_g, min(start_g + size_g, M)),
// disjoint from every other group's, so no row is written twice; rows past
// the last group are never written.
// 384 threads, three warpgroups:
// * Two consumer warpgroups, 64 rows each, issue wgmma m64n256k32
//   .s32.s8.s8 (four a k-tile) from the A and B rings and run the epilogue.
//   A warpgroup whose 64 rows all lie past the group's end (a prefill
//   chunk's 17-25 rows an expert, 35 of the headline's 287 m-tiles) waits
//   and releases the stages with the other but issues no MMA.
// * One producer warpgroup. Its thread 0 keeps the loads two k-tiles ahead
//   by TMA: the activations' [128 x 128] tile (lhs is [M, K], K-contiguous:
//   with the 128-byte swizzle that is wgmma's A layout as it lands) and the
//   raw weight tile in four quarter boxes of [32 k x 256 n] bytes. wgmma
//   reads 8-bit B K-major only and the weights are [E, K, N] N-contiguous,
//   so the whole warpgroup then transposes the raw tile into the K-major,
//   swizzled B stage: a thread a 16 x 16 byte block, 16-byte loads and
//   stores, 4 x 4 transposes with byte_perm, blocks rotated so that neither
//   side meets a bank conflict. The packed form sign-extends the nibble
//   first.
// * Packed weights walk the same k-tiles of codes: quarter q of k-tile t
//   holds codes c = 128 t + 32 q, which come from byte rows c (low nibbles)
//   when c < K/2 and from byte rows c - K/2 (high nibbles) after, so a
//   k-tile straddling K/2 (K 1408: codes 640-767) takes its quarters from
//   both halves and no tail tile is needed. Every K a multiple of 64 has
//   K/2 a multiple of 32, a quarter's depth. Boxes past the data (codes or
//   byte rows past their end) read as zeros.
// * Ragged storage (K4: rhs_cat [R, N], expert e's block from byte row
//   blk_offsets[e] * K/2, K/2 rows nibble-packed when pflags[e], else K
//   int8 rows): one 2D map over [R, N]; the producer reads the group's flag
//   and first byte row as its cursors reach the group, loads the quarters
//   of an int8 expert from rows 128 t + 32 q and those of a packed one as
//   above, and turns each k-tile with the group's transform. The choice is
//   the producer's alone: the consumers issue the same MMAs whatever the
//   storage, so K4 is bitwise K2 on the same codes. A box past the
//   expert's block reads the next expert's bytes (TMA fills zeros only past
//   R); those codes meet only activation columns past K, which the A map
//   fills with zeros, and add nothing (K % 64 == 0: no quarter of codes
//   below K reaches past its half).
// Rings: four A stages (16 KB), three raw stages (32 KB), two B stages
// (32 KB), 224 KB in all. Thread 0 loads k-tile q + 2 while the warpgroup
// transforms q, so two k-tiles of loads are in flight an SM. mbarriers:
// a_full / raw_full (TMA bytes), b_full (the 128 producer threads, after a
// fence.proxy.async), a_empty / b_empty (the 8 consumer warps, after their
// wgmma wait); a named barrier closes each transform before its raw stage
// is loaded again.

#pragma once

#include "wgmma.cuh"
#include "gmm_tile_walk.cuh"

namespace {

constexpr int WS_BM = 128;                   // rows of a work item: 2 x 64
constexpr int WS_BN = 256;                   // columns of a work item
constexpr int WS_BK = 128;                   // codes of a k-tile
constexpr int WS_QK = 32;                    // codes of a raw quarter box
constexpr int WS_A_STAGES = 4;               // activation ring
constexpr int WS_RAW = 3;                    // raw weight ring
constexpr int WS_B_STAGES = 2;               // transformed weight ring
constexpr int WS_AHEAD = 2;                  // k-tiles loaded ahead of the transform
constexpr int kWsThreads = 384;
constexpr int kMaxWsGroups = 512;            // groups by value (K15)
constexpr int WS_A_BYTES = WS_BM * WS_BK;    // [128 rows][128 codes], swizzled
constexpr int WS_B_BYTES = WS_BN * WS_BK;    // [256 columns][128 codes], swizzled
constexpr int WS_RAW_BYTES = WS_BK * WS_BN;  // [128 byte rows][256 columns]

// group sizes by value, in the launch parameters (K15)
struct WsSizes {
  int n[kMaxWsGroups];
  __device__ __forceinline__ int operator[](int g) const { return n[g]; }
};

// group sizes in device memory (K2, K5, K14: an int32 tensor)
struct WsDeviceSizes {
  const int* n;
  __device__ __forceinline__ int operator[](int g) const { return __ldg(n + g); }
};

// the ragged storage of K4: per group its packed flag and its first K/2-row
// unit (both int32 [E] in device memory); null for stacked storage
struct WsRagged {
  const int* pflags = nullptr;
  const int* blk = nullptr;
};

struct WsSmem {
  int8_t a[WS_A_STAGES][WS_A_BYTES];
  int8_t b[WS_B_STAGES][WS_B_BYTES];
  int8_t raw[WS_RAW][WS_RAW_BYTES];
  uint64_t a_full[WS_A_STAGES], a_empty[WS_A_STAGES];
  uint64_t raw_full[WS_RAW];
  uint64_t b_full[WS_B_STAGES], b_empty[WS_B_STAGES];
};
static_assert(WS_RAW == WS_AHEAD + 1 && WS_A_STAGES >= WS_AHEAD + 2 &&
              sizeof(WsSmem) + 1024 <= 232448, "the rings");
constexpr int kWsSmemBytes = (int)sizeof(WsSmem) + 1024;

// the CTA's walk over work items in (group, n-tile, m-tile) order; group g
// stores rows [row0, row_end), row_end = min(row0 + size, M), in
// cdiv(row_end - row0, 128) m-tiles from row0 on
template <class Sizes>
struct WsWalk {
  int g = 0, item0 = 0, row0 = 0, size = 0, mt = 0;
  int m0 = 0, n0 = 0, row_end = 0;   // the current item

  __device__ __forceinline__ static int tiles(int size, int row0, int M) {
    return (max(min(size, M - row0), 0) + WS_BM - 1) / WS_BM;
  }
  __device__ __forceinline__ void begin(const Sizes& sz, int M) {
    size = sz[0];
    mt = tiles(size, 0, M);
  }
  // item w (increasing from call to call) -> true and m0 / n0 / row_end,
  // false past the last item
  __device__ __forceinline__ bool seek(const Sizes& sz, int E, int nt, int M, int w) {
    while (w >= item0 + mt * nt) {
      item0 += mt * nt;
      row0 += size;
      if (++g >= E) return false;
      size = sz[g];
      mt = tiles(size, row0, M);
    }
    const int r = w - item0;
    n0 = (r / mt) * WS_BN;
    m0 = row0 + (r % mt) * WS_BM;
    row_end = min(row0 + size, M);
    return true;
  }
};

// the raw tile (byte rows x 256 columns) -> the K-major swizzled B stage.
// Thread (pw, lane) takes one block of 16 codes x 16 columns: 16 loads of
// 16 bytes (one per code row), 4 x 4 byte transposes, one 16-byte store per
// column. The 8 lanes of a quarter-warp take the 8 code blocks, the column
// block rotated by the code block, so that neither the loads nor the
// swizzled stores meet a bank conflict.
template <bool kPacked>
__device__ __forceinline__ void transform_b(const int8_t* raw, int8_t* b, int k0,
                                            int half, int pw, int lane) {
  const int kb = lane & 7;                               // codes 16 kb .. + 15
  const int ns = ((lane >> 3) + 4 * pw + kb) & 15;       // columns 16 ns .. + 15
  const bool hi = kPacked && k0 + ((16 * kb) & ~(WS_QK - 1)) >= half;
  const int8_t* src = raw + 16 * kb * WS_BN + 16 * ns;
  uint32_t r[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const uint4 v = *reinterpret_cast<const uint4*>(src + j * WS_BN);
    r[j][0] = v.x; r[j][1] = v.y; r[j][2] = v.z; r[j][3] = v.w;
    if constexpr (kPacked) {
#pragma unroll
      for (int g = 0; g < 4; ++g)
        r[j][g] = sext4(hi ? (r[j][g] >> 4) & 0x0F0F0F0Fu : r[j][g] & 0x0F0F0F0Fu);
    }
  }
#pragma unroll
  for (int g = 0; g < 4; ++g) {                          // columns 16 ns + 4 g + i
    uint32_t col[4][4];                                  // [i][code group]
#pragma unroll
    for (int kg = 0; kg < 4; ++kg) {
      const uint32_t t0 = __byte_perm(r[4 * kg][g], r[4 * kg + 1][g], 0x5140);
      const uint32_t t1 = __byte_perm(r[4 * kg + 2][g], r[4 * kg + 3][g], 0x5140);
      const uint32_t t2 = __byte_perm(r[4 * kg][g], r[4 * kg + 1][g], 0x7362);
      const uint32_t t3 = __byte_perm(r[4 * kg + 2][g], r[4 * kg + 3][g], 0x7362);
      col[0][kg] = __byte_perm(t0, t1, 0x5410);
      col[1][kg] = __byte_perm(t0, t1, 0x7632);
      col[2][kg] = __byte_perm(t2, t3, 0x5410);
      col[3][kg] = __byte_perm(t2, t3, 0x7632);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = 16 * ns + 4 * g + i;
      *reinterpret_cast<uint4*>(b + n * WS_BK + ((kb ^ (n & 7)) << 4)) =
          make_uint4(col[i][0], col[i][1], col[i][2], col[i][3]);
    }
  }
}

// the whole body, called by every thread of a 384-thread CTA whose dynamic
// shared memory (kWsSmemBytes) starts at `smem_raw`. s_a is read through L2
// (K14 writes it earlier in the same launch). kRagged: map_w is the 2D map
// over K4's rhs_cat, `rg` its flags and units (kPacked unused).
template <typename OutT, bool kPacked, class Sizes, bool kRagged = false>
__device__ __forceinline__ void ws_body(uint8_t* smem_raw, const CUtensorMap* map_a,
                                        const CUtensorMap* map_w,
                                        const float* __restrict__ s_a,
                                        const float* __restrict__ s_b,
                                        OutT* __restrict__ out, int M, int K, int N,
                                        int E, const Sizes& sizes,
                                        const WsRagged rg = WsRagged{}) {
  WsSmem& sm = *reinterpret_cast<WsSmem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int tid = threadIdx.x;
  const int nt = (N + WS_BN - 1) / WS_BN;
  const int kt_n = (K + WS_BK - 1) / WS_BK;

  if (tid == 0) {
    for (int i = 0; i < WS_A_STAGES; ++i) {
      mbar_init(&sm.a_full[i], 1);
      mbar_init(&sm.a_empty[i], 8);
    }
    for (int i = 0; i < WS_RAW; ++i) mbar_init(&sm.raw_full[i], 1);
    for (int i = 0; i < WS_B_STAGES; ++i) {
      mbar_init(&sm.b_full[i], 128);
      mbar_init(&sm.b_empty[i], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 256) {
    // ---- producer warpgroup: TMA (thread 0) and the B transform ----
    const int ptid = tid - 256, pw = ptid >> 5, lane = ptid & 31;
    const int half = K / 2;
    WsWalk<Sizes> ld, tf;                // the load cursor runs WS_AHEAD k-tiles ahead
    ld.begin(sizes, M);
    tf.begin(sizes, M);
    int ld_w = blockIdx.x, ld_kt = 0;
    bool ld_ok = ld.seek(sizes, E, nt, M, ld_w);
    int ld_q = 0;
    bool ld_pk = kPacked;                // the load cursor's group: packed,
    int ld_base = 0;                     // its first byte row (ragged)
    // issue the loads of the cursor's k-tile (k-tile ld_q of the CTA), then
    // step the cursor. Its raw stage was freed by the transform WS_RAW
    // k-tiles back (closed by the named barrier); its A stage waits for the
    // consumers.
    auto issue = [&]() {
      if (!ld_ok) return;
      if (ptid == 0) {
        const int sa = ld_q % WS_A_STAGES, r = ld_q % WS_RAW;
        if (ld_q >= WS_A_STAGES)
          mbar_wait(&sm.a_empty[sa], ((ld_q / WS_A_STAGES) - 1) & 1);
        const int k0 = ld_kt * WS_BK;
        if constexpr (kRagged) {
          if (ld_kt == 0) {
            ld_pk = __ldg(rg.pflags + ld.g) != 0;
            ld_base = __ldg(rg.blk + ld.g) * half;
          }
        }
        mbar_arrive_expect_tx(&sm.a_full[sa], WS_A_BYTES);
        tma_load_2d(sm.a[sa], map_a, &sm.a_full[sa], k0, ld.m0);
        mbar_arrive_expect_tx(&sm.raw_full[r], WS_RAW_BYTES);
#pragma unroll
        for (int qd = 0; qd < WS_BK / WS_QK; ++qd) {
          const int c = k0 + qd * WS_QK;
          const int row = (ld_pk && c >= half) ? c - half : c;
          if constexpr (kRagged)
            tma_load_2d(sm.raw[r] + qd * WS_QK * WS_BN, map_w, &sm.raw_full[r], ld.n0,
                        ld_base + row);
          else
            tma_load_3d(sm.raw[r] + qd * WS_QK * WS_BN, map_w, &sm.raw_full[r], ld.n0,
                        row, ld.g);
        }
      }
      ++ld_q;
      if (++ld_kt == kt_n) {
        ld_kt = 0;
        ld_w += gridDim.x;
        ld_ok = ld.seek(sizes, E, nt, M, ld_w);
      }
    };
    if (ptid == 0) {
      tma_prefetch_desc(map_a);
      tma_prefetch_desc(map_w);
    }
    for (int i = 0; i < WS_AHEAD; ++i) issue();
    int q = 0;
    for (int w = blockIdx.x; tf.seek(sizes, E, nt, M, w); w += gridDim.x) {
      const bool pk = kRagged ? __ldg(rg.pflags + tf.g) != 0 : kPacked;
      for (int kt = 0; kt < kt_n; ++kt, ++q) {
        issue();                                         // k-tile q + WS_AHEAD
        const int r = q % WS_RAW, sb = q % WS_B_STAGES;
        mbar_wait(&sm.raw_full[r], (q / WS_RAW) & 1);
        if (q >= WS_B_STAGES) mbar_wait(&sm.b_empty[sb], ((q / WS_B_STAGES) - 1) & 1);
        if (pk)
          transform_b<true>(sm.raw[r], sm.b[sb], kt * WS_BK, half, pw, lane);
        else
          transform_b<false>(sm.raw[r], sm.b[sb], kt * WS_BK, half, pw, lane);
        fence_proxy_async_smem();
        mbar_arrive(&sm.b_full[sb]);
        // every producer thread is done with raw[r] before it is loaded again
        asm volatile("bar.sync 1, 128;\n" ::: "memory");
      }
    }
  } else {
    // ---- consumer warpgroups: wgmma and the epilogue ----
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    WsWalk<Sizes> it;
    it.begin(sizes, M);
    int q = 0;
    int acc[128];
    auto release = [&](int p) {          // k-tile p's operands are read
      if (lane == 0) {
        mbar_arrive(&sm.a_empty[p % WS_A_STAGES]);
        mbar_arrive(&sm.b_empty[p % WS_B_STAGES]);
      }
    };
    for (int w = blockIdx.x; it.seek(sizes, E, nt, M, w); w += gridDim.x) {
      // a warpgroup without a stored row keeps step with the stages only; the
      // branch stays outside the k-loop and warp-uniform, or ptxas
      // serializes every wgmma (C7518)
      const bool live = __shfl_sync(0xffffffffu, it.m0 + wg * 64 < it.row_end, 0);
      if (!live) {
        for (int kt = 0; kt < kt_n; ++kt, ++q) {
          mbar_wait(&sm.a_full[q % WS_A_STAGES], (q / WS_A_STAGES) & 1);
          mbar_wait(&sm.b_full[q % WS_B_STAGES], (q / WS_B_STAGES) & 1);
          release(q);
        }
        continue;
      }
      for (int kt = 0; kt < kt_n; ++kt, ++q) {
        const int sa = q % WS_A_STAGES, sb = q % WS_B_STAGES;
        mbar_wait(&sm.a_full[sa], (q / WS_A_STAGES) & 1);
        mbar_wait(&sm.b_full[sb], (q / WS_B_STAGES) & 1);
        reg_fence(acc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < WS_BK / 32; ++ks)
          wgmma_m64n256k32_s8(acc, smem_desc_sw128(sm.a[sa] + wg * 64 * WS_BK + ks * 32),
                              smem_desc_sw128(sm.b[sb] + ks * 32), kt > 0 || ks > 0);
        wgmma_commit();
        reg_fence(acc);
        if (kt > 0) {                    // k-tile q - 1's reads are done
          wgmma_wait<1>();
          reg_fence(acc);
          release(q - 1);
        }
      }
      wgmma_wait<0>();
      reg_fence(acc);
      release(q - 1);
      // K2's epilogue: (acc * s_a) * s_b, rounded once to the output type
      const float* sbv = s_b + (size_t)it.g * N;
      const int row0 = it.m0 + wg * 64 + warp * 16 + (lane >> 2);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= it.row_end) continue;
        const float sa = __ldcg(s_a + row);
        OutT* orow = out + (size_t)row * N;
#pragma unroll
        for (int j = 0; j < WS_BN / 8; ++j) {
          const int col = it.n0 + 8 * j + 2 * (lane & 3);
          if (col >= N) continue;
          const float2 b2 = *reinterpret_cast<const float2*>(sbv + col);
          store2(orow + col, __fmul_rn(__fmul_rn((float)acc[4 * j + 2 * h], sa), b2.x),
                 __fmul_rn(__fmul_rn((float)acc[4 * j + 2 * h + 1], sa), b2.y));
        }
      }
    }
  }
}

// K2 / K5 above the decode rows: the body over group sizes in device memory
template <typename OutT, bool kPacked>
__global__ void __launch_bounds__(kWsThreads, 1)
gmm_wsd_kernel(const __grid_constant__ CUtensorMap map_a,
               const __grid_constant__ CUtensorMap map_w, const float* __restrict__ s_a,
               const float* __restrict__ s_b, const int* __restrict__ group_sizes,
               OutT* __restrict__ out, int M, int K, int N, int E) {
  extern __shared__ uint8_t wsd_smem_raw[];
  ws_body<OutT, kPacked>(wsd_smem_raw, &map_a, &map_w, s_a, s_b, out, M, K, N, E,
                         WsDeviceSizes{group_sizes});
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled, found through the runtime (no -lcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 0;
  if (count[dev] == 0)
    cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev];
}

// one TMA map over `rank` dims (innermost first) with the byte strides of
// dims 1.. and boxes of `box`: unit element strides, 256-byte L2 promotion,
// boxes past the data read zeros
cudaError_t encode_map(CUtensorMap* map, CUtensorMapDataType type, cuuint32_t rank,
                       const void* base, const cuuint64_t* dim, const cuuint64_t* stride,
                       const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint32_t one[3] = {1, 1, 1};
  return encode(map, type, rank, const_cast<void*>(base), dim, stride, box, one,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// the TMA maps of the body: the activations' codes [M, K] (128 x 128 boxes,
// 128-byte swizzle) and the weights [E, kw, N] (kw = K/2 packed; boxes of
// 32 byte rows x 256 columns). Needs K % 16 == 0 (K % 64 packed), N % 16
// == 0 and 16-byte aligned operands.
cudaError_t ws_encode_maps(const void* lhs, const void* rhs, bool packed, int M, int K,
                           int N, int E, CUtensorMap* map_a, CUtensorMap* map_w) {
  const int kw = packed ? K / 2 : K;
  const cuuint64_t a_dim[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t a_stride[1] = {(cuuint64_t)K};
  const cuuint32_t a_box[2] = {WS_BK, WS_BM};
  const cuuint64_t w_dim[3] = {(cuuint64_t)N, (cuuint64_t)kw, (cuuint64_t)E};
  const cuuint64_t w_stride[2] = {(cuuint64_t)N, (cuuint64_t)kw * N};
  const cuuint32_t w_box[3] = {WS_BN, WS_QK, 1};
  cudaError_t e = encode_map(map_a, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, lhs, a_dim, a_stride,
                             a_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return e;
  return encode_map(map_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, rhs, w_dim, w_stride, w_box,
                    CU_TENSOR_MAP_SWIZZLE_NONE);
}

// the persistent grid: one CTA an SM, no more than `items` (a bound on the
// work items)
int ws_grid(long long items) {
  const long long sms = sm_count();
  return (int)(items < sms ? items : sms);
}

template <typename OutT, bool kPacked>
cudaError_t launch_wsd_typed(const CUtensorMap& map_a, const CUtensorMap& map_w,
                             const float* s_a, const float* s_b, const int* gs, void* out,
                             int M, int K, int N, int E, int grid, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(gmm_wsd_kernel<OutT, kPacked>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       kWsSmemBytes);
  if (e != cudaSuccess) return e;
  gmm_wsd_kernel<OutT, kPacked><<<grid, kWsThreads, kWsSmemBytes, st>>>(
      map_a, map_w, s_a, s_b, gs, static_cast<OutT*>(out), M, K, N, E);
  return cudaGetLastError();
}

// K2 / K5's C entry points at bm == WS_BM: the body over the group sizes in
// device memory (int32 [E], E <= kMaxExperts). Every group's rows are
// covered by at most cdiv(M, 128) + E m-tiles, which bounds the grid.
template <bool kPacked>
int gmm_wsd_launch(const void* lhs, const void* s_a, const void* rhs, const void* s_b,
                   const void* group_sizes, void* out, int out_is_bf16, int M, int K,
                   int N, int E, void* stream) {
  if (E <= 0 || E > kMaxExperts) return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaGetLastError();
  CUtensorMap map_a, map_w;
  cudaError_t e = ws_encode_maps(lhs, rhs, kPacked, M, K, N, E, &map_a, &map_w);
  if (e != cudaSuccess) return (int)e;
  const long long nt = (N + WS_BN - 1) / WS_BN;
  const int grid = ws_grid(((long long)(M + WS_BM - 1) / WS_BM + E) * nt);
  if (grid <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sa = static_cast<const float*>(s_a);
  const float* sb = static_cast<const float*>(s_b);
  const int* gs = static_cast<const int*>(group_sizes);
  e = out_is_bf16
      ? launch_wsd_typed<__nv_bfloat16, kPacked>(map_a, map_w, sa, sb, gs, out, M, K, N, E,
                                                 grid, st)
      : launch_wsd_typed<float, kPacked>(map_a, map_w, sa, sb, gs, out, M, K, N, E, grid, st);
  return (int)e;
}

}  // namespace
