// Quantize-on-demote and dequantize-on-reload of Harvest KV blocks.
//
// Replaces: repro/kernels/harvest_copy/kernel.py::quantize_demote and
// ::dequantize_reload (the Pallas kernels the JAX engine calls on every
// quantized demotion).
//
// quantize_demote: gather rows ids[i] of an f32 pool (n_slots, elems), take
// each row's absmax scale (1 for an all-zero row) and quantize: int8
// rounded half-to-even and clipped to +-127; fp8 e4m3fn; int4 clipped to
// +-7 and packed as two's-complement nibble pairs (an odd width pads a
// zero).  The values are bit-identical to the Pallas kernel as XLA
// compiles it: the scale is absmax times the f32 reciprocal of qmax, each
// element is divided by the scale in f32 and rounded with rintf, and fp8
// takes a saturating e4m3 conversion (the row is scaled to at most 448
// plus a rounding step, where saturation and e4m3fn's own rounding agree).
//
// dequantize_reload: unpack and sign-extend, multiply by the scale and
// write dst[ids[i]] in place; slots outside ids are never touched.
//
// What bounds them on an H100: bytes.  Each element is read and written
// once with a handful of integer and float operations, so the time floor is
// (4 B in + 1 or 1/2 B out) per element over 3.35 TB/s.
//
// Design: the Pallas kernel gives one grid step a whole row.  A full-width
// demoted block is one row of 262,144 f32 (1 MiB), which one thread block
// would stream alone, so the row is split into chunks of 2,048 elements
// (128 thread blocks for that row, about one per SM): pass 1 has them
// fold |x| into the row's absmax with an atomicMax on the float's bits
// (exact for non-negative floats, and the max does not depend on the
// order), pass 2 has as many blocks quantize their chunk with the finished
// scale.  Dequantize is one pass, one thread per output element.  Scratch
// (the absmax row) is allocated and zeroed by the caller.

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 2048;    // elements of one row per thread block

enum Fidelity { kInt8 = 0, kFp8 = 1, kInt4 = 2 };

__device__ __forceinline__ float qmax_of(int fid) {
  return fid == kInt8 ? 127.f : (fid == kFp8 ? 448.f : 7.f);
}

__global__ void __launch_bounds__(kThreads)
absmax_kernel(const float* __restrict__ src, const int* __restrict__ ids,
              int elems, float* __restrict__ absmax) {
  const int i = blockIdx.y;
  const float* row = src + (size_t)ids[i] * elems;
  const int lo = blockIdx.x * kChunk;
  const int hi = min(lo + kChunk, elems);
  float mx = 0.f;
  for (int e = lo + threadIdx.x; e < hi; e += kThreads)
    mx = fmaxf(mx, fabsf(row[e]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  __shared__ float warp_max[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = mx;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) mx = fmaxf(mx, warp_max[w]);
    // non-negative floats order like their bit patterns as signed ints
    atomicMax(reinterpret_cast<int*>(absmax + i), __float_as_int(mx));
  }
}

__device__ __forceinline__ int round_clip(float x, float lim) {
  return (int)fminf(fmaxf(rintf(x), -lim), lim);
}

__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ src, const int* __restrict__ ids,
                int elems, int width, int fid,
                const float* __restrict__ absmax, uint8_t* __restrict__ values,
                float* __restrict__ scales) {
  const int i = blockIdx.y;
  const float am = absmax[i];
  // absmax times the f32 reciprocal of qmax: XLA compiles the JAX
  // kernel's division by a constant so, and the scales must match its bits
  const float scale = am == 0.f ? 1.f : am * (1.f / qmax_of(fid));
  if (blockIdx.x == 0 && threadIdx.x == 0) scales[i] = scale;
  const float* row = src + (size_t)ids[i] * elems;
  uint8_t* out = values + (size_t)i * width;
  // one output column per thread: a byte for int8/fp8, a nibble pair for
  // int4 (columns j of a chunk cover elements 2j, 2j + 1)
  const int lo = blockIdx.x * kChunk;
  const int hi = min(lo + kChunk, width);
  for (int j = lo + threadIdx.x; j < hi; j += kThreads) {
    if (fid == kInt8) {
      out[j] = (uint8_t)(int8_t)round_clip(row[j] / scale, 127.f);
    } else if (fid == kFp8) {
      out[j] = (uint8_t)__nv_cvt_float_to_fp8(row[j] / scale, __NV_SATFINITE,
                                              __NV_E4M3);
    } else {
      const int e = 2 * j;
      const int q0 = round_clip(row[e] / scale, 7.f);
      const int q1 = e + 1 < elems ? round_clip(row[e + 1] / scale, 7.f) : 0;
      out[j] = (uint8_t)((q0 & 15) | ((q1 & 15) << 4));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
dequantize_kernel(float* __restrict__ dst, const int* __restrict__ ids,
                  int elems, int width, int fid,
                  const uint8_t* __restrict__ values,
                  const float* __restrict__ scales) {
  const int i = blockIdx.y;
  const float scale = scales[i];
  const uint8_t* in = values + (size_t)i * width;
  float* row = dst + (size_t)ids[i] * elems;
  const int lo = blockIdx.x * kChunk;
  const int hi = min(lo + kChunk, elems);
  for (int e = lo + threadIdx.x; e < hi; e += kThreads) {
    float x;
    if (fid == kInt8) {
      x = (float)(int8_t)in[e];
    } else if (fid == kFp8) {
      x = __half2float(__half(__nv_cvt_fp8_to_halfraw(
          (__nv_fp8_storage_t)in[e], __NV_E4M3)));
    } else {
      const int b = in[e >> 1];
      int nib = (e & 1) ? (b >> 4) & 15 : b & 15;
      nib -= 2 * (nib & 8);             // sign-extend the nibble
      x = (float)nib;
    }
    row[e] = x * scale;
  }
}

}  // namespace

extern "C" {

// src (n_slots, elems) f32; ids (m,) int32 in range; absmax (m,) f32 zeroed
// by the caller; values (m, width) bytes; scales (m,) f32.  Returns a
// cudaError_t as int.
int quantize_demote(const void* src, const void* ids, int m, int elems,
                    int width, int fid, void* absmax, void* values,
                    void* scales, void* stream) {
  if (m == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* id = static_cast<const int*>(ids);
  absmax_kernel<<<dim3((elems + kChunk - 1) / kChunk, m), kThreads, 0, st>>>(
      static_cast<const float*>(src), id, elems, static_cast<float*>(absmax));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  quantize_kernel<<<dim3((width + kChunk - 1) / kChunk, m), kThreads, 0,
                    st>>>(static_cast<const float*>(src), id, elems, width,
                          fid, static_cast<const float*>(absmax),
                          static_cast<uint8_t*>(values),
                          static_cast<float*>(scales));
  return (int)cudaGetLastError();
}

// dst (n_slots, elems) f32, written in place at rows ids (unique, in range).
int dequantize_reload(void* dst, const void* ids, int m, int elems,
                      int width, int fid, const void* values,
                      const void* scales, void* stream) {
  if (m == 0) return 0;
  dequantize_kernel<<<dim3((elems + kChunk - 1) / kChunk, m), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(dst), static_cast<const int*>(ids), elems, width,
      fid, static_cast<const uint8_t*>(values),
      static_cast<const float*>(scales));
  return (int)cudaGetLastError();
}

const char* harvest_quant_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
