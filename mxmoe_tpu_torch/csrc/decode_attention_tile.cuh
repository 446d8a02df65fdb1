// The decode-attention body shared by decode_attention.cu (the bf16 cache:
// K3 and its read-only forms) and decode_attention_q8.cu (the int8 cache:
// K3q and its read-only forms). What it computes, its bound and its design
// are described here.
//
// K3 / K3q: fused KV-cache write + GQA decode attention over the stacked
// cache, for the Pallas kernel
// mxmoe_tpu/serving/decode_attention.py:decode_attention_update_stacked in
// both of its forms: the bf16 cache (K3) and the int8 cache with per-vector
// f32 scales (K3q). One templated body serves both, compiled per head group
// (kG >= G = n_h / n_kv: 1, 4 or 8) and key width (kDK: 32, 64, 128, 256).
//
//  1. Write this step's k_new/v_new at position lengths[b] of layer `layer`
//     of the [L, B, n_kv, S, d] caches, IN PLACE, when valid[b] != 0 and
//     lengths[b] < S (a full slot skips the write; it is never clamped onto
//     position S-1).
//  2. Online-softmax attention over positions [0, min(lengths[b], S-1)]:
//     the cost follows the slot's real length, not S. This is the clamp /
//     skip rule of the TPU kernel (decode_attention.py, raw_len / length).
//
// Bound on the H100: cache bytes (len x (dk + dv) x 2 bytes per (slot, kv
// head); int8: half, plus 8 bytes of scales a position). At serving sizes
// (B x n_kv = 64 heads of a few hundred to 2048 positions) the work is a
// few MB, so what limits it is how many cache bytes are in flight. Design:
//  * grid = (kv head, slot, S-block of 4 x `chunk` positions); warp w of a
//    block owns `chunk` positions (the wrapper's DA_CHUNK, 64) and runs its
//    own online softmax over them: no block barrier in the position loop.
//    Blocks past the slot's length exit at once.
//  * Each warp stages its positions in tiles of kTile = 16 positions, K and
//    V rows together (and the int8 form's two scales), with 16-byte
//    cp.async into a kStages-deep ring of its own: the next tile is in
//    flight during this tile's arithmetic.
//  * Scores: dk/8 lanes a row, 8 elements a lane, all G query heads of the
//    kv head from registers; a lane's partial dots (several rows x G heads)
//    are summed over the row's lanes by halving exchanges (fold_lanes: V - 1
//    shuffles for V sums, not V log2(dk/8)). P.V:
//    dv/8 lanes a V row, 8 columns a lane; the lanes that share columns fold
//    together at the end of the chunk.
//  * The block merges its warps' partials (acc, max, sum) in warp order. A
//    slot that one block covers writes its output there; otherwise each block
//    writes its partial to the workspace and the last block of a (slot, kv
//    head) to finish, found by an atomic ticket, merges the blocks' partials
//    in block order (so the output does not depend on which block came last)
//    and resets the ticket to 0.
//    Workspace size and tickets come from the wrapper
//    (serving/decode_attention.py::decode_attn_schedule).
//  * The chunk-0 block writes the new row. Every block whose range holds
//    position lengths[b] takes that row from the step's k/v (rounded to bf16
//    exactly as written, or quantized), never from the cache, so no block
//    depends on another's write: the warp that owns the position overwrites
//    it in its staged tile.
//
// Read-only forms (kWrite = false, the same body compiled without the
// write): the Pallas kernels decode_attention_stacked (stacked cache, bf16
// or int8), decode_attention and decode_attention_q8 (a per-layer
// [B, n_kv, S, d] cache: layer 0 of a one-layer stack). They take no
// k_new / v_new / valid, write nothing, and read every position, lengths[b]
// included, from the cache, clamped to S-1 (n_positions). For the per-layer
// forms, which do not clamp, lengths[b] >= S attends all S positions either
// way. On the cache that K3 / K3q has just written for the same step the
// outputs are bitwise theirs: the row K3 substitutes in its tile is the row
// it wrote. Bound: cache bytes only.
//
// K3q, the int8-cache form (cache codes [L, B, n_kv, S, d] int8, scales
// [L, B, n_kv, S] f32). The blocks that need the new row quantize the step's
// K and V vectors per (slot, kv head) in shared memory: sc = max(amax, 1e-8)
// * f32(1/127), code = rint(x / sc); the chunk-0 block writes the codes and
// the two scales at lengths[b]. (The reference divides by 127, which its
// compiler turns into this multiply by the reciprocal; the written scales are
// bitwise the reference's.) A cached position t adds (q . k_q[t]) * k_sc[t]
// * scale to the scores and p[t] * v_sc[t] to the P.V weights; the softmax
// sum takes the unscaled p. The TPU kernel's 8-row read-modify-write of the
// cache tile is a TPU tiling rule and is not carried over.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "cp_async.cuh"

namespace {

constexpr int kThreads = 128, kWarps = kThreads / 32;
constexpr int kTile = 16;         // positions per ring stage
constexpr int kStages = 2;        // ring depth of a warp

struct Args {
  const void* q;
  const void* k_new;
  const void* v_new;
  void* cache_k;
  void* cache_v;
  float* cache_ks;                // int8 cache only
  float* cache_vs;
  const int* lengths;
  const int* valid;
  void* out;
  float* ws;                      // [B, n_kv, n_split, G, dv + 2], per S-block
  int* tickets;                   // [B * n_kv], 0 between launches
  int layer, B, n_h, n_kv, S, dk, dv, chunk, n_split;
  float scale;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ int n_positions(int raw_len, int S) {
  return min(max(raw_len, 0), S - 1) + 1;
}

// 8 consecutive cache elements from shared memory -> f32
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 x = __bfloat1622float2(h[j]);
    f[2 * j] = x.x;
    f[2 * j + 1] = x.y;
  }
}
__device__ __forceinline__ void load8(const int8_t* p, float (&f)[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[j] = (float)(signed char)((u.x >> (8 * j)) & 0xffu);
    f[4 + j] = (float)(signed char)((u.y >> (8 * j)) & 0xffu);
  }
}

// max over the block of a per-thread value (all threads get the result)
__device__ __forceinline__ float block_max(float v, float* red, int warp,
                                           int lane) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) r = fmaxf(r, red[i]);
  __syncthreads();
  return r;
}

__host__ __device__ __forceinline__ int align16(int x) { return (x + 15) & ~15; }

// Sums each of V values over aligned groups of L lanes with halving
// exchanges: step j trades half of the values still held with the lane
// L / 2^(j+1) away, so all V sums take V - 1 shuffles (not V log2 L) with
// the shuffles of a step independent. Afterwards v[0 .. max(V / L, 1)) hold
// the sums of values base .. base + V / L (the return value is base); for V <
// L, groups of L / V lanes hold the same sum.
template <int V, int L>
__device__ __forceinline__ int fold_lanes(float (&v)[V], int lane) {
  int base = 0;
#pragma unroll
  for (int half = V / 2, o = L / 2; half >= 1 && o >= 1; half >>= 1, o >>= 1) {
    const bool upper = (lane & o) != 0;
#pragma unroll
    for (int k = 0; k < half; ++k) {
      const float recv = __shfl_xor_sync(0xffffffffu, upper ? v[k] : v[k + half], o);
      v[k] = (upper ? v[k + half] : v[k]) + recv;
    }
    if (upper) base += half;
  }
#pragma unroll
  for (int o = V < L ? L / (2 * V) : 0; o >= 1; o >>= 1)
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
  return base;
}

// shared memory of one block: the step's new K / V rows, then per warp a
// kStages ring of (K tile, V tile[, K scales, V scales]) and the [kG, kTile]
// probabilities
template <bool kQ8>
__host__ __device__ __forceinline__ int stage_bytes(int dk, int dv) {
  constexpr int eb = kQ8 ? 1 : 2;
  return kTile * (dk + dv) * eb + (kQ8 ? 2 * kTile * 4 : 0);
}
// a warp's ring, which after the position loop holds its partial ([kG] x
// (dv acc, max, sum)) for the block's merge, then its [kG, kTile] probabilities
template <bool kQ8, int kG>
__host__ __device__ __forceinline__ int warp_bytes(int dk, int dv) {
  const int ring = kStages * stage_bytes<kQ8>(dk, dv);
  const int part = kG * (dv + 2) * 4;
  return align16(ring > part ? ring : part) + kG * kTile * 4;
}
template <bool kQ8>
__host__ __device__ __forceinline__ int row_bytes(int dk, int dv) {
  constexpr int eb = kQ8 ? 1 : 2;
  return align16(dk * eb) + align16(dv * eb);
}

template <typename T, bool kQ8, bool kWrite, int kG, int kDK>
__global__ void __launch_bounds__(kThreads) decode_attn_kernel(const Args a) {
  using CT = std::conditional_t<kQ8, int8_t, __nv_bfloat16>;
  constexpr int kEB = sizeof(CT);
  // scores: kLPR lanes a key row, 8 elements a lane; a tile's rows in kPasses
  // passes of kRPP rows, folded kPG passes at a time (at most 32 values)
  constexpr int kLPR = kDK / 8, kRPP = 32 / kLPR, kPasses = kTile / kRPP;
  constexpr int kPG = kPasses < 32 / kG ? kPasses : 32 / kG;
  constexpr int kV = kPG * kG;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red_s[kWarps];
  __shared__ int is_last;

  const int G = a.n_h / a.n_kv, dv = a.dv;
  constexpr int dk = kDK;
  const int h = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int raw_len = a.lengths[b];
  const int n_pos = n_positions(raw_len, a.S);
  const int block_pos = kWarps * a.chunk;
  const int p_block = sp * block_pos;
  if (p_block >= n_pos) return;                  // uniform across the block
  const int p_block_end = min(p_block + block_pos, n_pos);
  const bool wrote = kWrite && a.valid[b] != 0 && raw_len >= 0 && raw_len < a.S;

  const size_t head = ((size_t)a.layer * a.B + b) * a.n_kv + h;
  CT* ck = static_cast<CT*>(a.cache_k) + head * a.S * dk;
  CT* cv = static_cast<CT*>(a.cache_v) + head * a.S * dv;
  float* cks = kQ8 ? a.cache_ks + head * a.S : nullptr;
  float* cvs = kQ8 ? a.cache_vs + head * a.S : nullptr;
  CT* kn_s = reinterpret_cast<CT*>(smem);
  CT* vn_s = reinterpret_cast<CT*>(smem + align16(dk * kEB));

  // this warp's positions and its ring; the copies start before anything else
  const int p_warp = p_block + warp * a.chunk;
  const bool active = p_warp < n_pos;            // uniform across the warp
  const int p_end = min(p_warp + a.chunk, n_pos);
  const int n_tiles = active ? (p_end - p_warp + kTile - 1) / kTile : 0;
  const int sbytes = stage_bytes<kQ8>(dk, dv), wbytes = warp_bytes<kQ8, kG>(dk, dv);
  unsigned char* const warps_base = smem + row_bytes<kQ8>(dk, dv);
  unsigned char* wbase = warps_base + warp * wbytes;
  float* p_s = reinterpret_cast<float*>(wbase + wbytes - kG * kTile * 4);  // [kG, kTile]
  auto stage_k = [&](int s) { return reinterpret_cast<CT*>(wbase + s * sbytes); };
  auto stage_v = [&](int s) { return stage_k(s) + kTile * dk; };
  auto stage_sc = [&](int s) {                   // [2, kTile]: K, then V scales
    return reinterpret_cast<float*>(wbase + s * sbytes + kTile * (dk + dv) * kEB);
  };
  const int kc = dk * kEB / 16, vc = dv * kEB / 16;       // 16-byte pieces a row
  const int v_row0 = lane / vc, v_pc0 = lane % vc, v_dr = 32 / vc, v_dp = 32 % vc;
  auto issue = [&](int t) {
    if (t < n_tiles) {
      const int p0 = p_warp + t * kTile, cnt = min(kTile, p_end - p0);
      const int s = t % kStages;
      CT* kt = stage_k(s);
      CT* vt = stage_v(s);
      for (int i = lane; i < cnt * kc; i += 32)
        cp_async16(kt + (i / kc) * dk + (i % kc) * (16 / kEB),
                   ck + (size_t)(p0 + i / kc) * dk + (i % kc) * (16 / kEB));
      // V: dv is a runtime width, so the lane walks (row, piece) pairs by
      // steps of 32 pieces without dividing by vc in the loop
      for (int r = v_row0, pc = v_pc0; r < cnt;) {
        cp_async16(vt + r * dv + pc * (16 / kEB),
                   cv + (size_t)(p0 + r) * dv + pc * (16 / kEB));
        r += v_dr;
        pc += v_dp;
        if (pc >= vc) {
          pc -= vc;
          ++r;
        }
      }
      if constexpr (kQ8) {
        const int r = lane & (kTile - 1);
        if (r < cnt)
          cp_async4(stage_sc(s) + (lane >> 4) * kTile + r,
                    (lane < kTile ? cks : cvs) + p0 + r);
      }
    }
    cp_async_commit();                           // empty groups keep the count
  };
#pragma unroll
  for (int t = 0; t < kStages; ++t) issue(t);
  // this lane's slice of q for the G heads (elements sl * 8 .. sl * 8 + 8),
  // loaded while the ring fills: kLPR lanes a key row
  const int sub = lane / kLPR, sl = lane % kLPR;
  float qreg[kG][8];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    const T* qg = static_cast<const T*>(a.q)
                  + ((size_t)b * a.n_h + (size_t)h * G + min(g, G - 1)) * dk + sl * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) qreg[g][j] = active && g < G ? ld(qg + j) : 0.f;
  }

  // the step's new row: written by the chunk-0 block, attended by the block
  // whose range holds lengths[b] (uniform across the block)
  float ksc_new = 0.f, vsc_new = 0.f;
  if (kWrite && (sp == 0 || (raw_len >= p_block && raw_len < p_block_end))) {
    const T* kn = static_cast<const T*>(a.k_new) + ((size_t)b * a.n_kv + h) * dk;
    const T* vn = static_cast<const T*>(a.v_new) + ((size_t)b * a.n_kv + h) * dv;
    const bool store = sp == 0 && wrote;
    if constexpr (kQ8) {
      const float inv127 = (float)(1.0 / 127.0);
      float ak = 0.f, av = 0.f;
      for (int d = tid; d < dk; d += kThreads) ak = fmaxf(ak, fabsf(ld(kn + d)));
      for (int d = tid; d < dv; d += kThreads) av = fmaxf(av, fabsf(ld(vn + d)));
      ksc_new = __fmul_rn(fmaxf(block_max(ak, red_s, warp, lane), 1e-8f), inv127);
      vsc_new = __fmul_rn(fmaxf(block_max(av, red_s, warp, lane), 1e-8f), inv127);
      for (int d = tid; d < dk; d += kThreads) {
        const int8_t c = (int8_t)rintf(__fdiv_rn(ld(kn + d), ksc_new));
        kn_s[d] = c;
        if (store) ck[(size_t)raw_len * dk + d] = c;
      }
      for (int d = tid; d < dv; d += kThreads) {
        const int8_t c = (int8_t)rintf(__fdiv_rn(ld(vn + d), vsc_new));
        vn_s[d] = c;
        if (store) cv[(size_t)raw_len * dv + d] = c;
      }
      if (store && tid == 0) {
        cks[raw_len] = ksc_new;
        cvs[raw_len] = vsc_new;
      }
    } else {
      for (int d = tid; d < dk; d += kThreads) {
        const CT x = __float2bfloat16_rn(ld(kn + d));
        kn_s[d] = x;
        if (store) ck[(size_t)raw_len * dk + d] = x;
      }
      for (int d = tid; d < dv; d += kThreads) {
        const CT x = __float2bfloat16_rn(ld(vn + d));
        vn_s[d] = x;
        if (store) cv[(size_t)raw_len * dv + d] = x;
      }
    }
  }
  __syncthreads();

  // P.V: lv = dv / 8 lanes a value row (8 columns a lane), nsub groups of them
  const int lv = dv / 8, nsub = 32 / lv, vsub = lane / lv, vsl = lane % lv;
  float m_run[kG], l_run[kG], acc[kG][8];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    m_run[g] = -INFINITY;
    l_run[g] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[g][j] = 0.f;
  }
  if (active) {
    for (int t = 0; t < n_tiles; ++t) {
      cp_async_wait<kStages - 1>();
      __syncwarp();
      const int s = t % kStages;
      const int p0 = p_warp + t * kTile, cnt = min(kTile, p_end - p0);
      CT* kt = stage_k(s);
      CT* vt = stage_v(s);
      if (wrote && raw_len >= p0 && raw_len < p0 + cnt) {   // warp-uniform
        const int r = raw_len - p0;
        for (int d = lane; d < dk; d += 32) kt[r * dk + d] = kn_s[d];
        for (int d = lane; d < dv; d += 32) vt[r * dv + d] = vn_s[d];
        if constexpr (kQ8) {
          if (lane == 0) {
            stage_sc(s)[r] = ksc_new;
            stage_sc(s)[kTile + r] = vsc_new;
          }
        }
        __syncwarp();
      }
      // scores of the tile's rows (rows >= cnt are masked below): each
      // lane's partial dots of kPG passes x kG heads, folded over the kLPR
      // lanes of a row (fold_lanes), then written by the lanes that hold them
#pragma unroll
      for (int i0 = 0; i0 < kPasses; i0 += kPG) {
        float v[kV];
#pragma unroll
        for (int i = 0; i < kPG; ++i) {
          float kf[8];
          load8(kt + ((i0 + i) * kRPP + sub) * dk + sl * 8, kf);
#pragma unroll
          for (int g = 0; g < kG; ++g) {
            float d = 0.f;
#pragma unroll
            for (int j = 0; j < 8; ++j) d += qreg[g][j] * kf[j];
            v[i * kG + g] = d;
          }
        }
        const int base = fold_lanes<kV, kLPR>(v, lane);
        constexpr int kHeld = kV / kLPR > 0 ? kV / kLPR : 1;
        if (kV >= kLPR || (sl & (kLPR / kV - 1)) == 0) {
#pragma unroll
          for (int k = 0; k < kHeld; ++k) {
            const int idx = base + k, g = idx % kG;
            const int r = (i0 + idx / kG) * kRPP + sub;
            if (g < G)
              p_s[g * kTile + r] = kQ8 ? v[k] * stage_sc(s)[r] * a.scale : v[k] * a.scale;
          }
        }
      }
      __syncwarp();
      // online softmax over the tile: lane and lane + 16 hold position lane & 15
      const int pp = lane & (kTile - 1);
      const bool live = pp < cnt;
      const float vsc = kQ8 && live ? stage_sc(s)[kTile + pp] : 1.f;
      float alpha[kG], pv[kG];
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const float sv = live ? p_s[g * kTile + pp] : -INFINITY;
        float mx = sv;
#pragma unroll
        for (int off = kTile / 2; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m_run[g], mx);
        const float e = live ? expf(sv - m_new) : 0.f;
        float sum = e;
#pragma unroll
        for (int off = kTile / 2; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        alpha[g] = expf(m_run[g] - m_new);       // 0 on the first tile
        l_run[g] = l_run[g] * alpha[g] + sum;
        m_run[g] = m_new;
        pv[g] = kQ8 ? e * vsc : e;
      }
      __syncwarp();
      if (lane < kTile) {
#pragma unroll
        for (int g = 0; g < kG; ++g) p_s[g * kTile + lane] = pv[g];
      }
      __syncwarp();
      // P.V: 8 columns a lane, the tile's rows split over nsub lane groups
#pragma unroll
      for (int g = 0; g < kG; ++g)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[g][j] *= alpha[g];
      if (vsub < nsub) {
        for (int p = vsub; p < cnt; p += nsub) {
          float vf[8];
          load8(vt + p * dv + vsl * 8, vf);
#pragma unroll
          for (int g = 0; g < kG; ++g) {
            const float w = p_s[g * kTile + p];
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[g][j] += w * vf[j];
          }
        }
      }
      __syncwarp();                              // stage s and p_s are free
      issue(t + kStages);
    }
    // fold the lane groups that share columns into group 0, in group order
    for (int s2 = 1; s2 < nsub; ++s2) {
      const int src = min(lane + s2 * lv, 31);
#pragma unroll
      for (int g = 0; g < kG; ++g)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float o2 = __shfl_sync(0xffffffffu, acc[g][j], src);
          if (vsub == 0) acc[g][j] += o2;
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                               // every ring is free

  // each warp's partial [G] x (dv acc, max, sum) into its ring
  const int pstride = dv + 2;
  if (active) {
    float* part = reinterpret_cast<float*>(wbase);
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      if (g >= G) break;
      if (vsub == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j) part[g * pstride + vsl * 8 + j] = acc[g][j];
      }
      if (lane == 0) {
        part[g * pstride + dv] = m_run[g];
        part[g * pstride + dv + 1] = l_run[g];
      }
    }
  }
  __syncthreads();
  // the block's partial: its warps' merged in warp order. A slot that one
  // block covers is done here (out = acc / sum); otherwise the partial goes
  // to the workspace and the last block of this (slot, kv head) merges
  const int n_act = min(kWarps, (p_block_end - p_block + a.chunk - 1) / a.chunk);
  const int n_blocks = (n_pos + block_pos - 1) / block_pos;
  T* ob = static_cast<T*>(a.out) + ((size_t)b * a.n_h + (size_t)h * G) * dv;
  float* wsb = a.ws + (((size_t)b * a.n_kv + h) * a.n_split + sp) * G * pstride;
  for (int i = tid; i < G * dv; i += kThreads) {
    const int g = i / dv, d = i % dv;
    auto pw = [&](int w) {
      return reinterpret_cast<const float*>(warps_base + w * wbytes) + g * pstride;
    };
    float mx = -INFINITY;
    for (int w = 0; w < n_act; ++w) mx = fmaxf(mx, pw(w)[dv]);
    float o = 0.f, l = 0.f;
    for (int w = 0; w < n_act; ++w) {
      const float f = expf(pw(w)[dv] - mx);
      o += pw(w)[d] * f;
      l += pw(w)[dv + 1] * f;
    }
    if (n_blocks == 1) {
      st(ob + (size_t)g * dv + d, o / fmaxf(l, 1e-30f));
    } else {
      wsb[g * pstride + d] = o;
      if (d == 0) {
        wsb[g * pstride + dv] = mx;
        wsb[g * pstride + dv + 1] = l;
      }
    }
  }
  if (n_blocks == 1) return;                     // uniform across the block
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* tk = a.tickets + (size_t)b * a.n_kv + h;
    is_last = atomicAdd(tk, 1) == n_blocks - 1;
    if (is_last) *tk = 0;                        // every block has its ticket
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const float* wh = a.ws + ((size_t)b * a.n_kv + h) * a.n_split * G * pstride;
  for (int i = tid; i < G * dv; i += kThreads) {
    const int g = i / dv, d = i % dv;
    float m = -INFINITY;
#pragma unroll 4
    for (int s = 0; s < n_blocks; ++s)
      m = fmaxf(m, __ldcg(wh + ((size_t)s * G + g) * pstride + dv));
    float l = 0.f, o = 0.f;
#pragma unroll 4
    for (int s = 0; s < n_blocks; ++s) {
      const float* ws_g = wh + ((size_t)s * G + g) * pstride;
      const float f = expf(__ldcg(ws_g + dv) - m);
      l += __ldcg(ws_g + dv + 1) * f;
      o += __ldcg(ws_g + d) * f;
    }
    st(ob + (size_t)g * dv + d, o / fmaxf(l, 1e-30f));
  }
}

template <typename T, bool kQ8, bool kWrite, int kG, int kDK>
cudaError_t launch_g(const Args& a, cudaStream_t st) {
  const int smem = row_bytes<kQ8>(kDK, a.dv) + kWarps * warp_bytes<kQ8, kG>(kDK, a.dv);
  auto kern = decode_attn_kernel<T, kQ8, kWrite, kG, kDK>;
  static int smem_set = 48 * 1024;               // the attribute, once per size
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  if (a.B > 0) {
    const int block_pos = kWarps * a.chunk;
    kern<<<dim3(a.n_kv, a.B, (a.S + block_pos - 1) / block_pos), kThreads, smem, st>>>(a);
  }
  return cudaGetLastError();
}

template <typename T, bool kQ8, bool kWrite, int kG>
cudaError_t launch_dk(const Args& a, cudaStream_t st) {
  switch (a.dk) {
    case 32: return launch_g<T, kQ8, kWrite, kG, 32>(a, st);
    case 64: return launch_g<T, kQ8, kWrite, kG, 64>(a, st);
    case 128: return launch_g<T, kQ8, kWrite, kG, 128>(a, st);
    case 256: return launch_g<T, kQ8, kWrite, kG, 256>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

// G query heads a kv head -> the body for kG >= G heads (1, 4 or 8)
template <typename T, bool kQ8, bool kWrite>
cudaError_t launch(const Args& a, cudaStream_t st) {
  const int G = a.n_h / a.n_kv;
  if (G <= 1) return launch_dk<T, kQ8, kWrite, 1>(a, st);
  if (G <= 4) return launch_dk<T, kQ8, kWrite, 4>(a, st);
  return launch_dk<T, kQ8, kWrite, 8>(a, st);
}

template <bool kQ8, bool kWrite>
int run(const Args& a, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch<__nv_bfloat16, kQ8, kWrite>(a, st)
                       : launch<float, kQ8, kWrite>(a, st));
}

}  // namespace
