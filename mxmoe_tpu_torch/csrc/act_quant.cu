// K1: single-pass per-row symmetric activation quantization.
//
// Replaces the Pallas kernel mxmoe_tpu/ops/act_quant.py:quantize_rows
// (its wrapper quantize_rows_uniform feeds every int8 expert GEMM).
//
//   v     = x * gain                        (f32)
//   upper = 2^(min(bits,8)-1) - 1           (exact integer arithmetic)
//   scale = max(amax(|v|), 1e-8) / upper
//   q     = rint(v / scale)                 (round-half-even, int8)
//
// Codes and scales must equal the plain torch version bitwise, so the
// division is IEEE (__fdiv_rn; no --use_fast_math, no reciprocal multiply)
// and the rounding is round-to-nearest-even; the max is exact, so the order
// in which it is taken is free.
//
// Bound on the H100: memory. A row is read once and its codes written once
// (3 bytes an element from bf16: 0.067 ms for the headline's 36736 x 2048).
// Design (K % 8 == 0: 16-byte loads of 8 elements, 8-byte code stores):
// * many rows (M >= 8192) of at most 8 KB (bf16 K <= 4096, f32 K <= 2048):
//   one warp a row, eight rows a block; the row stays in registers (lane l
//   takes the 8-element chunks l, l + 32, ...), the amax is a shuffle
//   reduction. No shared memory, no block barrier.
// * fewer rows, or wider ones (the shared experts' K 5632 ... 20480): one
//   256-thread block a row, the row in registers (thread t takes chunks t,
//   t + 256, ...), the amax shared across the warps through shared memory
//   (one barrier). With few rows a warp a row leaves most of the card idle
//   and each lane a long chain of divisions. Measured on an H100 (bf16, K
//   2048, device us, block / warp a row): M 16 2.1 / 4.4, M 1024 5.4 / 6.7,
//   M 4096 13.3 / 14.2, M 36736 92 / 80 (K 1408: 75 / 57).
// * K % 8 != 0, or a row wider than a block's registers hold (K > 32768):
//   one warp a row over single elements, read twice.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 8;      // warps of the warp-a-row block
constexpr int kWarpRowBytes = 8192;   // widest row a warp holds
constexpr int kWarpMinRows = 8192;    // fewest rows that take a warp a row
constexpr int kBlockThreads = 256;    // threads of the block-a-row path
constexpr int kBlockMaxChunks = 16;   // chunks a thread holds there

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 8 consecutive elements of a row, as loaded
template <typename T> struct Chunk;
template <> struct Chunk<__nv_bfloat16> {
  uint4 w;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    w = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void values(float gain, float (&v)[8]) const {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(u[i] << 16) * gain;
      v[2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u) * gain;
    }
  }
};
template <> struct Chunk<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void values(float gain, float (&v)[8]) const {
    v[0] = a.x * gain; v[1] = a.y * gain; v[2] = a.z * gain; v[3] = a.w * gain;
    v[4] = b.x * gain; v[5] = b.y * gain; v[6] = b.z * gain; v[7] = b.w * gain;
  }
};

__device__ __forceinline__ float chunk_amax(const float (&v)[8], float a) {
#pragma unroll
  for (int i = 0; i < 8; ++i) a = fmaxf(a, fabsf(v[i]));
  return a;
}

__device__ __forceinline__ float warp_max(float a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, off));
  return a;
}

__device__ __forceinline__ float row_scale(float amax, float bits) {
  const int b = (int)fminf(bits, 8.f);
  const float upper = (float)((1 << (b - 1)) - 1);
  return __fdiv_rn(fmaxf(amax, 1e-8f), upper);
}

__device__ __forceinline__ int8_t code(float v, float s) {
  return (int8_t)__float2int_rn(__fdiv_rn(v, s));
}

// 8 codes -> one 8-byte store
__device__ __forceinline__ void store_codes(int8_t* dst, const float (&v)[8], float s) {
  uint32_t lo = 0, hi = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lo |= (uint32_t)(uint8_t)code(v[i], s) << (8 * i);
    hi |= (uint32_t)(uint8_t)code(v[4 + i], s) << (8 * i);
  }
  *reinterpret_cast<uint2*>(dst) = make_uint2(lo, hi);
}

// one warp a row, the row in registers: kCpl chunks a lane at most
template <typename T, int kCpl>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
quantize_rows_reg(const T* __restrict__ x, const float* __restrict__ bits, float gain,
                  int8_t* __restrict__ q, float* __restrict__ scale, int M, int K) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const int chunks = K / 8;
  const T* xr = x + (size_t)row * K;
  Chunk<T> c[kCpl];
#pragma unroll
  for (int i = 0; i < kCpl; ++i)
    if (lane + 32 * i < chunks) c[i].load(xr + 8 * (lane + 32 * i));
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kCpl; ++i)
    if (lane + 32 * i < chunks) {
      float v[8];
      c[i].values(gain, v);
      amax = chunk_amax(v, amax);
    }
  const float s = row_scale(warp_max(amax), bits[row]);
  if (lane == 0) scale[row] = s;
  int8_t* qr = q + (size_t)row * K;
#pragma unroll
  for (int i = 0; i < kCpl; ++i)
    if (lane + 32 * i < chunks) {
      float v[8];
      c[i].values(gain, v);
      store_codes(qr + 8 * (lane + 32 * i), v, s);
    }
}

// one block a row, the row in registers: kCpl chunks a thread at most
template <typename T, int kCpl>
__global__ void __launch_bounds__(kBlockThreads)
quantize_rows_block(const T* __restrict__ x, const float* __restrict__ bits, float gain,
                    int8_t* __restrict__ q, float* __restrict__ scale, int K) {
  __shared__ float warp_amax[kBlockThreads / 32];
  const int row = blockIdx.x, t = threadIdx.x;
  const int chunks = K / 8;
  const T* xr = x + (size_t)row * K;
  Chunk<T> c[kCpl];
#pragma unroll
  for (int i = 0; i < kCpl; ++i)
    if (t + kBlockThreads * i < chunks) c[i].load(xr + 8 * (t + kBlockThreads * i));
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kCpl; ++i)
    if (t + kBlockThreads * i < chunks) {
      float v[8];
      c[i].values(gain, v);
      amax = chunk_amax(v, amax);
    }
  amax = warp_max(amax);
  if ((t & 31) == 0) warp_amax[t >> 5] = amax;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kBlockThreads / 32; ++w) amax = fmaxf(amax, warp_amax[w]);
  const float s = row_scale(amax, bits[row]);
  if (t == 0) scale[row] = s;
  int8_t* qr = q + (size_t)row * K;
#pragma unroll
  for (int i = 0; i < kCpl; ++i)
    if (t + kBlockThreads * i < chunks) {
      float v[8];
      c[i].values(gain, v);
      store_codes(qr + 8 * (t + kBlockThreads * i), v, s);
    }
}

// any K: one warp a row over single elements, read twice
template <typename T>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
quantize_rows_scalar(const T* __restrict__ x, const float* __restrict__ bits, float gain,
                     int8_t* __restrict__ q, float* __restrict__ scale, int M, int K) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const T* xr = x + (size_t)row * K;
  float amax = 0.f;
  for (int k = lane; k < K; k += 32) amax = fmaxf(amax, fabsf(to_f32(xr[k]) * gain));
  const float s = row_scale(warp_max(amax), bits[row]);
  if (lane == 0) scale[row] = s;
  int8_t* qr = q + (size_t)row * K;
  for (int k = lane; k < K; k += 32) qr[k] = code(to_f32(xr[k]) * gain, s);
}

template <typename T, int kCpl>
void launch_warp(const T* x, const float* bits, float gain, int8_t* q, float* scale,
                 int M, int K, cudaStream_t st) {
  quantize_rows_reg<T, kCpl>
      <<<(M + kRowsPerBlock - 1) / kRowsPerBlock, 32 * kRowsPerBlock, 0, st>>>(
          x, bits, gain, q, scale, M, K);
}

template <typename T, int kCpl>
void launch_block(const T* x, const float* bits, float gain, int8_t* q, float* scale,
                  int M, int K, cudaStream_t st) {
  quantize_rows_block<T, kCpl><<<M, kBlockThreads, 0, st>>>(x, bits, gain, q, scale, K);
}

template <typename T>
cudaError_t launch(const void* xv, const float* bits, float gain, int8_t* q,
                   float* scale, int M, int K, cudaStream_t st) {
  if (M == 0 || K == 0) return cudaGetLastError();
  const T* x = static_cast<const T*>(xv);
  const bool vec = K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 8 == 0;
  const int chunks = K / 8;
  const int per_lane = (chunks + 31) / 32;
  const int per_thread = (chunks + kBlockThreads - 1) / kBlockThreads;
  if (vec && M >= kWarpMinRows && K * (int)sizeof(T) <= kWarpRowBytes) {
    if (per_lane <= 1) launch_warp<T, 1>(x, bits, gain, q, scale, M, K, st);
    else if (per_lane <= 2) launch_warp<T, 2>(x, bits, gain, q, scale, M, K, st);
    else if (per_lane <= 4) launch_warp<T, 4>(x, bits, gain, q, scale, M, K, st);
    else if (per_lane <= 8) launch_warp<T, 8>(x, bits, gain, q, scale, M, K, st);
    else launch_warp<T, kWarpRowBytes / (256 * (int)sizeof(T))>(x, bits, gain, q, scale,
                                                                 M, K, st);
  } else if (vec && per_thread <= kBlockMaxChunks) {
    if (per_thread <= 1) launch_block<T, 1>(x, bits, gain, q, scale, M, K, st);
    else if (per_thread <= 2) launch_block<T, 2>(x, bits, gain, q, scale, M, K, st);
    else if (per_thread <= 4) launch_block<T, 4>(x, bits, gain, q, scale, M, K, st);
    else if (per_thread <= 8) launch_block<T, 8>(x, bits, gain, q, scale, M, K, st);
    else launch_block<T, kBlockMaxChunks>(x, bits, gain, q, scale, M, K, st);
  } else {
    quantize_rows_scalar<T><<<(M + kRowsPerBlock - 1) / kRowsPerBlock,
                              32 * kRowsPerBlock, 0, st>>>(x, bits, gain, q, scale, M, K);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int mxmoe_quantize_rows(const void* x, int x_is_bf16,
                                   const void* bits, float gain, void* q,
                                   void* scale, int M, int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bits);
  int8_t* qq = static_cast<int8_t*>(q);
  float* sc = static_cast<float*>(scale);
  cudaError_t e = x_is_bf16
      ? launch<__nv_bfloat16>(x, b, gain, qq, sc, M, K, st)
      : launch<float>(x, b, gain, qq, sc, M, K, st);
  return (int)e;
}
