// K3: fused KV-cache write + GQA decode attention over the stacked cache.
//
// Replaces the Pallas kernel
// mxmoe_tpu/serving/decode_attention.py:decode_attention_update_stacked,
// in both of its forms: the bf16 cache (K3) and the int8 cache with
// per-vector f32 scales (K3q, the second half of this file).
//
//  1. Write this step's k_new/v_new at position lengths[b] of layer `layer`
//     of the [L, B, n_kv, S, d] bf16 caches, IN PLACE, when valid[b] != 0
//     and lengths[b] < S (a full slot skips the write; it is never clamped
//     onto position S-1).
//  2. Online-softmax attention over positions [0, min(lengths[b], S-1)]:
//     the cost follows the slot's real length, not S. This is the clamp /
//     skip rule of the TPU kernel (decode_attention.py, raw_len / length).
//
// Bound on the H100: cache bytes (2 x len x d x 2 bytes per (slot, kv head))
// and, at serving sizes (B x n_kv = 64 heads of a few hundred positions),
// memory latency: a one-block-per-head walk over the length leaves most SMs
// idle and waits on one row at a time. Design (flash-decoding):
//  * grid = (kv head, slot, S-chunk of kChunk positions). A block attends
//    its chunk for the G = n_h / n_kv query heads of its kv head and writes
//    a partial (max, sum, acc) to a workspace; a second kernel merges the
//    chunks. Blocks past the slot's length exit at once.
//  * The chunk-0 block writes the new row. Every block takes position
//    lengths[b] from the step's k/v (rounded to bf16 exactly as written),
//    never from the cache, so no block depends on another's write.
//  * Scores: 16-byte key loads, dk/8 lanes per row, all of a warp's rows of
//    a 64-position step loaded before any reduction (many rows in flight).
//    P.V: one output column per thread, the position loop unrolled by 8.
// Later work: vector P.V loads, cp.async staging.
//
// Read-only forms (kWrite = false, the same bodies compiled without the
// write): the Pallas kernels decode_attention_stacked (stacked cache, bf16
// or int8), decode_attention and decode_attention_q8 (a per-layer
// [B, n_kv, S, d] cache: layer 0 of a one-layer stack). They take no
// k_new / v_new / valid, write nothing, and read every position, lengths[b]
// included, from the cache, clamped to S-1 (n_positions). For the per-layer
// forms, which do not clamp, lengths[b] >= S attends all S positions either
// way. On the cache that K3 / K3q has just written for the same step the
// outputs are bitwise theirs: the row K3 takes from shared memory is the
// row it wrote. Bound: cache bytes only.
//
// K3q, the int8-cache form (cache codes [L, B, n_kv, S, d] int8, scales
// [L, B, n_kv, S] f32). Same grid, same merge kernel, same skip rule. Every
// block quantizes the step's K and V vectors per (slot, kv head) in shared
// memory: sc = max(amax, 1e-8) * f32(1/127), code = rint(x / sc); the
// chunk-0 block writes the codes and the two scales at lengths[b]. (The
// reference divides by 127, which its compiler turns into this multiply by
// the reciprocal; the written scales are bitwise the reference's.) Position
// lengths[b] is attended from the QUANTIZED row in shared memory, never
// from the cache. A cached position t adds (q . k_q[t]) * k_sc[t] * scale to
// the scores and p[t] * v_sc[t] to the P.V weights; the softmax sum takes
// the unscaled p. Bound: cache bytes, half of the bf16 form's, plus 8 bytes
// of scales per position. The TPU kernel's 8-row read-modify-write of the
// cache tile is a TPU tiling rule and is not carried over.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128, kWarps = kThreads / 32;
constexpr int kMaxG = 8;          // query heads per kv head
constexpr int kBS = 64;           // positions per inner step
constexpr int kChunk = 256;       // positions per block
constexpr int kRowsPerWarp = kBS / kWarps;
constexpr int kMaxRounds = 16;    // dk = 256: one row per warp round

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

template <typename T, bool kWrite>
__global__ void __launch_bounds__(kThreads)
decode_attn_partial_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                           const T* __restrict__ v_new,
                           __nv_bfloat16* __restrict__ cache_k,
                           __nv_bfloat16* __restrict__ cache_v,
                           const int* __restrict__ lengths,
                           const int* __restrict__ valid,
                           float* __restrict__ ws, int layer, int B, int n_h,
                           int n_kv, int S, int dk, int dv, int n_split,
                           float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = n_h / n_kv;
  __nv_bfloat16* kn_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [dk]
  __nv_bfloat16* vn_s = kn_s + dk;                                    // [dv]
  float* q_s = reinterpret_cast<float*>(vn_s + dv);                   // [G, dk]
  float* p_s = q_s + G * dk;                                          // [G, kBS]
  float* m_s = p_s + G * kBS;
  float* l_s = m_s + G;
  float* a_s = l_s + G;

  const int h = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int raw_len = lengths[b];
  const int n_pos = n_positions(raw_len, S);
  const int p_begin = sp * kChunk;
  if (p_begin >= n_pos) return;                  // uniform across the block
  const int p_end = min(p_begin + kChunk, n_pos);
  const bool wrote = kWrite && valid[b] != 0 && raw_len >= 0 && raw_len < S;

  const size_t head = ((size_t)layer * B + b) * n_kv + h;
  __nv_bfloat16* ck = cache_k + head * S * dk;
  __nv_bfloat16* cv = cache_v + head * S * dv;
  if (kWrite) {
    const T* kn = k_new + ((size_t)b * n_kv + h) * dk;
    const T* vn = v_new + ((size_t)b * n_kv + h) * dv;
    for (int d = tid; d < dk; d += kThreads) {
      const __nv_bfloat16 x = __float2bfloat16_rn(ld(kn + d));
      kn_s[d] = x;
      if (sp == 0 && wrote) ck[(size_t)raw_len * dk + d] = x;
    }
    for (int d = tid; d < dv; d += kThreads) {
      const __nv_bfloat16 x = __float2bfloat16_rn(ld(vn + d));
      vn_s[d] = x;
      if (sp == 0 && wrote) cv[(size_t)raw_len * dv + d] = x;
    }
  }
  const T* qb = q + ((size_t)b * n_h + (size_t)h * G) * dk;
  for (int i = tid; i < G * dk; i += kThreads) q_s[i] = ld(qb + i);
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  // the row of position p: the step's new row at lengths[b], else the cache
  auto key_row = [&](int p) -> const __nv_bfloat16* {
    return (wrote && p == raw_len) ? kn_s : ck + (size_t)p * dk;
  };
  auto val_row = [&](int p) -> const __nv_bfloat16* {
    return (wrote && p == raw_len) ? vn_s : cv + (size_t)p * dv;
  };

  const int lanes_per_row = dk / 8;              // 8, 16 or 32
  const int rows_per_round = 32 / lanes_per_row;
  const int rounds = kRowsPerWarp / rows_per_round;
  const int sub = lane / lanes_per_row, sl = lane % lanes_per_row;

  float acc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;
  const int d_out = tid;                         // dv <= kThreads (wrapper)

  for (int p0 = p_begin; p0 < p_end; p0 += kBS) {
    const int cnt = min(kBS, p_end - p0);
    // scores: every key row of this warp in flight before any reduction
    uint4 kreg[kMaxRounds];
#pragma unroll
    for (int i = 0; i < kMaxRounds; ++i) {
      const int r = warp * kRowsPerWarp + i * rows_per_round + sub;
      kreg[i] = make_uint4(0u, 0u, 0u, 0u);
      if (i < rounds && r < cnt)
        kreg[i] = *reinterpret_cast<const uint4*>(key_row(p0 + r) + sl * 8);
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      const float* qg = q_s + g * dk + sl * 8;
#pragma unroll
      for (int i = 0; i < kMaxRounds; ++i) {
        if (i >= rounds) break;
        const __nv_bfloat162* kv = reinterpret_cast<const __nv_bfloat162*>(&kreg[i]);
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(kv[j]);
          s += qg[2 * j] * f.x + qg[2 * j + 1] * f.y;
        }
        for (int off = lanes_per_row / 2; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        const int r = warp * kRowsPerWarp + i * rows_per_round + sub;
        if (sl == 0 && r < cnt) p_s[g * kBS + r] = s * scale;
      }
    }
    __syncthreads();
    // online-softmax update: one head per warp
    for (int g = warp; g < G; g += kWarps) {
      float* ps = p_s + g * kBS;
      float bmax = -INFINITY;
      for (int p = lane; p < cnt; p += 32) bmax = fmaxf(bmax, ps[p]);
      for (int off = 16; off > 0; off >>= 1)
        bmax = fmaxf(bmax, __shfl_xor_sync(0xffffffffu, bmax, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, bmax);
      float sum = 0.f;
      for (int p = lane; p < cnt; p += 32) {
        const float e = expf(ps[p] - m_new);
        ps[p] = e;
        sum += e;
      }
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);   // 0 on the first step
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // P.V: column d_out for all G heads
    if (d_out < dv) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) acc[g] *= a_s[g];
#pragma unroll 8
      for (int p = 0; p < cnt; ++p) {
        const float v = __bfloat162float(val_row(p0 + p)[d_out]);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) acc[g] += p_s[g * kBS + p] * v;
      }
    }
    __syncthreads();   // p_s is rewritten by the next step
  }

  // partial [n_kv, B, n_split, G] x (dv acc, max, sum)
  float* w = ws + (((size_t)b * n_kv + h) * n_split + sp) * G * (dv + 2);
  if (d_out < dv) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) w[(size_t)g * (dv + 2) + d_out] = acc[g];
  }
  if (tid < G) {
    w[(size_t)tid * (dv + 2) + dv] = m_s[tid];
    w[(size_t)tid * (dv + 2) + dv + 1] = l_s[tid];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attn_merge_kernel(const float* __restrict__ ws,
                         const int* __restrict__ lengths, T* __restrict__ out,
                         int n_h, int n_kv, int S, int dv, int n_split) {
  const int G = n_h / n_kv;
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int n_used = (n_positions(lengths[b], S) + kChunk - 1) / kChunk;
  const float* w = ws + ((size_t)b * n_kv + h) * n_split * G * (dv + 2);
  T* ob = out + ((size_t)b * n_h + (size_t)h * G) * dv;
  for (int g = 0; g < G; ++g) {
    float m = -INFINITY;
    for (int s = 0; s < n_used; ++s)
      m = fmaxf(m, w[((size_t)s * G + g) * (dv + 2) + dv]);
    float l = 0.f, a = 0.f;
    for (int s = 0; s < n_used; ++s) {
      const float* ws_g = w + ((size_t)s * G + g) * (dv + 2);
      const float f = expf(ws_g[dv] - m);
      l += ws_g[dv + 1] * f;
      if (d < dv) a += ws_g[d] * f;
    }
    if (d < dv) st(ob + (size_t)g * dv + d, a / fmaxf(l, 1e-30f));
  }
}

template <typename T, bool kWrite>
cudaError_t launch(const void* q, const void* k_new, const void* v_new,
                   void* cache_k, void* cache_v, const int* lengths,
                   const int* valid, void* out, float* ws, int layer, int B,
                   int n_h, int n_kv, int S, int dk, int dv, float scale,
                   cudaStream_t st) {
  const int G = n_h / n_kv;
  const int n_split = (S + kChunk - 1) / kChunk;
  const size_t smem = 2 * (size_t)(dk + dv)
                      + sizeof(float) * ((size_t)G * dk + (size_t)G * kBS + 3 * G);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_attn_partial_kernel<T, kWrite>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  if (B > 0) {
    decode_attn_partial_kernel<T, kWrite><<<dim3(n_kv, B, n_split), kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_new),
        static_cast<const T*>(v_new), static_cast<__nv_bfloat16*>(cache_k),
        static_cast<__nv_bfloat16*>(cache_v), lengths, valid, ws, layer, B,
        n_h, n_kv, S, dk, dv, n_split, scale);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    decode_attn_merge_kernel<T><<<dim3(n_kv, B), kThreads, 0, st>>>(
        ws, lengths, static_cast<T*>(out), n_h, n_kv, S, dv, n_split);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K3q: the int8-cache form
// ---------------------------------------------------------------------------

constexpr int kMaxRoundsQ8 = 8;   // dk = 256: two rows per warp round

__device__ __forceinline__ float byte_to_float(uint32_t w, int j) {
  return (float)(signed char)((w >> (8 * j)) & 0xffu);
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

template <typename T, bool kWrite>
__global__ void __launch_bounds__(kThreads)
decode_attn_partial_q8_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                              const T* __restrict__ v_new,
                              int8_t* __restrict__ cache_k,
                              float* __restrict__ cache_ks,
                              int8_t* __restrict__ cache_v,
                              float* __restrict__ cache_vs,
                              const int* __restrict__ lengths,
                              const int* __restrict__ valid,
                              float* __restrict__ ws, int layer, int B, int n_h,
                              int n_kv, int S, int dk, int dv, int n_split,
                              float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = n_h / n_kv;
  int8_t* kn_s = reinterpret_cast<int8_t*>(smem_raw);                 // [dk]
  int8_t* vn_s = kn_s + dk;                                           // [dv]
  float* q_s = reinterpret_cast<float*>(smem_raw + dk + ((dv + 15) & ~15));
  float* p_s = q_s + G * dk;                                          // [G, kBS]
  float* m_s = p_s + G * kBS;
  float* l_s = m_s + G;
  float* a_s = l_s + G;
  float* red_s = a_s + G;                                             // [kWarps]

  const int h = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int raw_len = lengths[b];
  const int n_pos = n_positions(raw_len, S);
  const int p_begin = sp * kChunk;
  if (p_begin >= n_pos) return;                  // uniform across the block
  const int p_end = min(p_begin + kChunk, n_pos);
  const bool wrote = kWrite && valid[b] != 0 && raw_len >= 0 && raw_len < S;

  const size_t head = ((size_t)layer * B + b) * n_kv + h;
  int8_t* ck = cache_k + head * S * dk;
  int8_t* cv = cache_v + head * S * dv;
  float* cks = cache_ks + head * S;
  float* cvs = cache_vs + head * S;

  // per-vector symmetric int8 quantization of the step's K and V
  float ksc_new = 0.f, vsc_new = 0.f;
  if (kWrite) {
    const T* kn = k_new + ((size_t)b * n_kv + h) * dk;
    const T* vn = v_new + ((size_t)b * n_kv + h) * dv;
    const float inv127 = (float)(1.0 / 127.0);
    float ak = 0.f, av = 0.f;
    for (int d = tid; d < dk; d += kThreads) ak = fmaxf(ak, fabsf(ld(kn + d)));
    for (int d = tid; d < dv; d += kThreads) av = fmaxf(av, fabsf(ld(vn + d)));
    ksc_new = __fmul_rn(fmaxf(block_max(ak, red_s, warp, lane), 1e-8f), inv127);
    vsc_new = __fmul_rn(fmaxf(block_max(av, red_s, warp, lane), 1e-8f), inv127);
    const bool store = sp == 0 && wrote;
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
  }
  const T* qb = q + ((size_t)b * n_h + (size_t)h * G) * dk;
  for (int i = tid; i < G * dk; i += kThreads) q_s[i] = ld(qb + i);
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  // position p: the step's quantized row at lengths[b], else the cache
  auto key_row = [&](int p) -> const int8_t* {
    return (wrote && p == raw_len) ? kn_s : ck + (size_t)p * dk;
  };
  auto val_row = [&](int p) -> const int8_t* {
    return (wrote && p == raw_len) ? vn_s : cv + (size_t)p * dv;
  };
  auto key_scale = [&](int p) -> float {
    return (wrote && p == raw_len) ? ksc_new : cks[p];
  };
  auto val_scale = [&](int p) -> float {
    return (wrote && p == raw_len) ? vsc_new : cvs[p];
  };

  const int lanes_per_row = dk / 16;             // 4, 8 or 16
  const int rows_per_round = 32 / lanes_per_row;
  const int rounds = kRowsPerWarp / rows_per_round;
  const int sub = lane / lanes_per_row, sl = lane % lanes_per_row;

  float acc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;
  const int d_out = tid;                         // dv <= kThreads (wrapper)

  for (int p0 = p_begin; p0 < p_end; p0 += kBS) {
    const int cnt = min(kBS, p_end - p0);
    // scores: every key row of this warp in flight before any reduction
    uint4 kreg[kMaxRoundsQ8];
    float ksc[kMaxRoundsQ8];
#pragma unroll
    for (int i = 0; i < kMaxRoundsQ8; ++i) {
      const int r = warp * kRowsPerWarp + i * rows_per_round + sub;
      kreg[i] = make_uint4(0u, 0u, 0u, 0u);
      ksc[i] = 0.f;
      if (i < rounds && r < cnt) {
        kreg[i] = *reinterpret_cast<const uint4*>(key_row(p0 + r) + sl * 16);
        ksc[i] = key_scale(p0 + r);
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      const float* qg = q_s + g * dk + sl * 16;
#pragma unroll
      for (int i = 0; i < kMaxRoundsQ8; ++i) {
        if (i >= rounds) break;
        const uint32_t kw[4] = {kreg[i].x, kreg[i].y, kreg[i].z, kreg[i].w};
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < 4; ++w)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            s += qg[4 * w + j] * byte_to_float(kw[w], j);
        for (int off = lanes_per_row / 2; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        const int r = warp * kRowsPerWarp + i * rows_per_round + sub;
        if (sl == 0 && r < cnt) p_s[g * kBS + r] = s * ksc[i] * scale;
      }
    }
    __syncthreads();
    // online-softmax update: one head per warp; p_s becomes p * v_sc
    for (int g = warp; g < G; g += kWarps) {
      float* ps = p_s + g * kBS;
      float bmax = -INFINITY;
      for (int p = lane; p < cnt; p += 32) bmax = fmaxf(bmax, ps[p]);
      for (int off = 16; off > 0; off >>= 1)
        bmax = fmaxf(bmax, __shfl_xor_sync(0xffffffffu, bmax, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, bmax);
      float sum = 0.f;
      for (int p = lane; p < cnt; p += 32) {
        const float e = expf(ps[p] - m_new);
        ps[p] = e * val_scale(p0 + p);
        sum += e;
      }
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);   // 0 on the first step
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // P.V: column d_out for all G heads
    if (d_out < dv) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) acc[g] *= a_s[g];
#pragma unroll 8
      for (int p = 0; p < cnt; ++p) {
        const float v = (float)val_row(p0 + p)[d_out];
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) acc[g] += p_s[g * kBS + p] * v;
      }
    }
    __syncthreads();   // p_s is rewritten by the next step
  }

  // partial [n_kv, B, n_split, G] x (dv acc, max, sum), as in the bf16 form
  float* w = ws + (((size_t)b * n_kv + h) * n_split + sp) * G * (dv + 2);
  if (d_out < dv) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) w[(size_t)g * (dv + 2) + d_out] = acc[g];
  }
  if (tid < G) {
    w[(size_t)tid * (dv + 2) + dv] = m_s[tid];
    w[(size_t)tid * (dv + 2) + dv + 1] = l_s[tid];
  }
}

template <typename T, bool kWrite>
cudaError_t launch_q8(const void* q, const void* k_new, const void* v_new,
                      void* cache_k, void* cache_ks, void* cache_v,
                      void* cache_vs, const int* lengths, const int* valid,
                      void* out, float* ws, int layer, int B, int n_h, int n_kv,
                      int S, int dk, int dv, float scale, cudaStream_t st) {
  const int G = n_h / n_kv;
  const int n_split = (S + kChunk - 1) / kChunk;
  const size_t smem = (size_t)dk + ((dv + 15) & ~15)
      + sizeof(float) * ((size_t)G * dk + (size_t)G * kBS + 3 * G + kWarps);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_attn_partial_q8_kernel<T, kWrite>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  if (B > 0) {
    decode_attn_partial_q8_kernel<T, kWrite><<<dim3(n_kv, B, n_split), kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_new),
        static_cast<const T*>(v_new), static_cast<int8_t*>(cache_k),
        static_cast<float*>(cache_ks), static_cast<int8_t*>(cache_v),
        static_cast<float*>(cache_vs), lengths, valid, ws, layer, B, n_h, n_kv,
        S, dk, dv, n_split, scale);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    decode_attn_merge_kernel<T><<<dim3(n_kv, B), kThreads, 0, st>>>(
        ws, lengths, static_cast<T*>(out), n_h, n_kv, S, dv, n_split);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int mxmoe_decode_attention_workspace_floats(int B, int n_h, int n_kv,
                                                       int S, int dv) {
  return B * n_h * ((S + kChunk - 1) / kChunk) * (dv + 2);
}

extern "C" int mxmoe_decode_attention_update(
    const void* q, const void* k_new, const void* v_new, int is_bf16,
    void* cache_k, void* cache_v, const void* lengths, const void* valid,
    void* out, void* ws, int layer, int B, int n_h, int n_kv, int S, int dk,
    int dv, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  const int* val = static_cast<const int*>(valid);
  float* w = static_cast<float*>(ws);
  cudaError_t e = is_bf16
      ? launch<__nv_bfloat16, true>(q, k_new, v_new, cache_k, cache_v, len,
                                    val, out, w, layer, B, n_h, n_kv, S, dk,
                                    dv, scale, st)
      : launch<float, true>(q, k_new, v_new, cache_k, cache_v, len, val, out,
                            w, layer, B, n_h, n_kv, S, dk, dv, scale, st);
  return (int)e;
}

extern "C" int mxmoe_decode_attention_update_q8(
    const void* q, const void* k_new, const void* v_new, int is_bf16,
    void* cache_k, void* cache_ks, void* cache_v, void* cache_vs,
    const void* lengths, const void* valid, void* out, void* ws, int layer,
    int B, int n_h, int n_kv, int S, int dk, int dv, float scale,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  const int* val = static_cast<const int*>(valid);
  float* w = static_cast<float*>(ws);
  cudaError_t e = is_bf16
      ? launch_q8<__nv_bfloat16, true>(q, k_new, v_new, cache_k, cache_ks,
                                       cache_v, cache_vs, len, val, out, w,
                                       layer, B, n_h, n_kv, S, dk, dv, scale,
                                       st)
      : launch_q8<float, true>(q, k_new, v_new, cache_k, cache_ks, cache_v,
                               cache_vs, len, val, out, w, layer, B, n_h, n_kv,
                               S, dk, dv, scale, st);
  return (int)e;
}

// The read-only forms: no step vectors, no write. A per-layer cache is
// layer 0 of a one-layer stack (L = 1, layer = 0).
extern "C" int mxmoe_decode_attention(
    const void* q, int is_bf16, void* cache_k, void* cache_v,
    const void* lengths, void* out, void* ws, int layer, int B, int n_h,
    int n_kv, int S, int dk, int dv, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  float* w = static_cast<float*>(ws);
  cudaError_t e = is_bf16
      ? launch<__nv_bfloat16, false>(q, nullptr, nullptr, cache_k, cache_v, len,
                                     nullptr, out, w, layer, B, n_h, n_kv, S,
                                     dk, dv, scale, st)
      : launch<float, false>(q, nullptr, nullptr, cache_k, cache_v, len,
                             nullptr, out, w, layer, B, n_h, n_kv, S, dk, dv,
                             scale, st);
  return (int)e;
}

extern "C" int mxmoe_decode_attention_q8(
    const void* q, int is_bf16, void* cache_k, void* cache_ks, void* cache_v,
    void* cache_vs, const void* lengths, void* out, void* ws, int layer, int B,
    int n_h, int n_kv, int S, int dk, int dv, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  float* w = static_cast<float*>(ws);
  cudaError_t e = is_bf16
      ? launch_q8<__nv_bfloat16, false>(q, nullptr, nullptr, cache_k, cache_ks,
                                        cache_v, cache_vs, len, nullptr, out, w,
                                        layer, B, n_h, n_kv, S, dk, dv, scale,
                                        st)
      : launch_q8<float, false>(q, nullptr, nullptr, cache_k, cache_ks, cache_v,
                                cache_vs, len, nullptr, out, w, layer, B, n_h,
                                n_kv, S, dk, dv, scale, st);
  return (int)e;
}
