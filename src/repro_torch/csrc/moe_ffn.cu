// Expert FFN over capacity dispatch buffers:
//   out[e] = (act(x[e] @ wg[e]) * (x[e] @ wi[e])) @ wo[e]
// for x (E, C, d), wi/wg (E, d, f), wo (E, f, d); bf16 or f32.
//
// Replaces: repro/kernels/moe_ffn/kernel.py::moe_ffn, the Pallas expert-FFN
// kernel.  It rounds where the JAX model's expert_ffn (three einsums in
// the working dtype, repro/models/moe.py) does, not where the Pallas
// kernel does (that one keeps h, g and act(g) * h in f32): h and g are
// rounded to the dtype, the activation is rounded op by op (silu as
// u * (1 / (1 + exp(-u))), gelu's tanh form, squared relu), act(g) * h is
// rounded, and the output is rounded; every dot product sums in f32.  In
// f32 the roundings vanish and the result is the Pallas kernel's function.
// Any E, C, d and f: ragged tiles are masked (the Pallas kernel needs
// f % f_block == 0, which qwen2-moe's f = 1408 and phi-tiny-moe's 915 miss).
//
// What bounds it on an H100 at decode: bytes.  A decode step gives each
// expert at most a few tokens (capacity 4 at 4 rows and top-4 of 64), so
// the work is a weight read: 3 * d * f values per expert, 17.3 MB at
// qwen2-moe's width, against 2 * 3 * d * f operations per token row.
//
// Design: two launches.  Kernel A, per (f tile, C tile, expert), sums the
// h and g tiles over d in registers from tiles of x, wi and wg staged in
// shared memory as f32, applies the activation and the gate, and writes
// the rounded (C, f) intermediate to a workspace.  Kernel B, per (d tile,
// C tile, expert), multiplies that workspace by wo the same way.  The
// Pallas kernel keeps the intermediate on chip by walking f in sequence
// and accumulating the output in VMEM; blocks on 132 SMs do not run in
// sequence, so here the intermediate makes one round trip through device
// memory (E * C * f values, small against the weights).  Every expert's
// weights are read, even an expert whose capacity slots are all empty:
// its rows are zeros and its outputs exact zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileC = 16;      // rows of the dispatch buffer per block
constexpr int kTileN = 64;      // output columns per block (f in A, d in B)
constexpr int kTileK = 32;      // depth staged per step
constexpr int kRowsPerThread = kTileC / (kThreads / kTileN);

enum Act { kSilu = 0, kGelu = 1, kRelu2 = 2 };

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

// round to T and back: one op's result in the working dtype
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f<T>(from_f<T>(v));
}

template <typename T> __device__ __forceinline__ float activation(float u,
                                                                  int act) {
  if (act == kSilu) {
    const float e = rnd<T>(expf(-u));
    const float s = rnd<T>(1.f + e);
    const float sig = rnd<T>(1.f / s);
    return rnd<T>(u * sig);
  }
  if (act == kGelu) {
    const float c = rnd<T>(0.7978845608028654f);     // sqrt(2 / pi)
    const float u3 = rnd<T>(rnd<T>(u * u) * u);
    const float inner = rnd<T>(c * rnd<T>(u + rnd<T>(0.044715f * u3)));
    const float half = rnd<T>(0.5f * rnd<T>(1.f + rnd<T>(tanhf(inner))));
    return rnd<T>(u * half);
  }
  const float r = fmaxf(u, 0.f);
  return rnd<T>(r * r);
}

// Stage a (kTileC, kTileK) tile of a row-major (rows, depth) matrix and
// (kTileK, kTileN) tiles of one or two (NB) row-major (depth, cols)
// matrices b0, b1 as f32, zero outside the matrix.
template <typename T, int NB>
__device__ __forceinline__ void stage(
    float (*as)[kTileK + 1], float (*bs)[kTileK][kTileN], const T* a,
    const T* b0, const T* b1, int r0, int rows, int k0, int depth, int n0,
    int cols) {
  for (int i = threadIdx.x; i < kTileC * kTileK; i += kThreads) {
    const int r = i / kTileK, k = i % kTileK;
    as[r][k] = (r0 + r < rows && k0 + k < depth)
                   ? to_f<T>(a[(size_t)(r0 + r) * depth + k0 + k]) : 0.f;
  }
  for (int i = threadIdx.x; i < kTileK * kTileN; i += kThreads) {
    const int k = i / kTileN, n = i % kTileN;
    const bool ok = k0 + k < depth && n0 + n < cols;
    const size_t at = (size_t)(k0 + k) * cols + n0 + n;
    bs[0][k][n] = ok ? to_f<T>(b0[at]) : 0.f;
    if (NB == 2) bs[1][k][n] = ok ? to_f<T>(b1[at]) : 0.f;
  }
}

// Kernel A: p[e, c, n] = rnd(act(rnd(x.wg)) * rnd(x.wi)), n over f
template <typename T>
__global__ void __launch_bounds__(kThreads)
gate_up_kernel(const T* __restrict__ x, const T* __restrict__ wi,
               const T* __restrict__ wg, T* __restrict__ p, int C, int d,
               int f, int act) {
  __shared__ float xs[kTileC][kTileK + 1];
  __shared__ float ws[2][kTileK][kTileN];
  const int e = blockIdx.z, c0 = blockIdx.y * kTileC, n0 = blockIdx.x * kTileN;
  const int tx = threadIdx.x % kTileN, ty = threadIdx.x / kTileN;
  const T* xe = x + (size_t)e * C * d;
  const T* wie = wi + (size_t)e * d * f;
  const T* wge = wg + (size_t)e * d * f;
  float h[kRowsPerThread] = {}, g[kRowsPerThread] = {};
  for (int k0 = 0; k0 < d; k0 += kTileK) {
    stage<T, 2>(xs, ws, xe, wie, wge, c0, C, k0, d, n0, f);
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kTileK; ++k) {
      const float a = ws[0][k][tx], b = ws[1][k][tx];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const float xv = xs[ty + r * (kThreads / kTileN)][k];
        h[r] = fmaf(xv, a, h[r]);
        g[r] = fmaf(xv, b, g[r]);
      }
    }
    __syncthreads();
  }
  const int n = n0 + tx;
  if (n >= f) return;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int c = c0 + ty + r * (kThreads / kTileN);
    if (c < C)
      p[((size_t)e * C + c) * f + n] =
          from_f<T>(activation<T>(rnd<T>(g[r]), act) * rnd<T>(h[r]));
  }
}

// Kernel B: out[e, c, n] = rnd(p[e, c, :] . wo[e, :, n]), n over d
template <typename T>
__global__ void __launch_bounds__(kThreads)
down_kernel(const T* __restrict__ p, const T* __restrict__ wo,
            T* __restrict__ out, int C, int d, int f) {
  __shared__ float ps[kTileC][kTileK + 1];
  __shared__ float ws[1][kTileK][kTileN];
  const int e = blockIdx.z, c0 = blockIdx.y * kTileC, n0 = blockIdx.x * kTileN;
  const int tx = threadIdx.x % kTileN, ty = threadIdx.x / kTileN;
  const T* pe = p + (size_t)e * C * f;
  const T* woe = wo + (size_t)e * f * d;
  float acc[kRowsPerThread] = {};
  for (int k0 = 0; k0 < f; k0 += kTileK) {
    stage<T, 1>(ps, ws, pe, woe, woe, c0, C, k0, f, n0, d);
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kTileK; ++k) {
      const float b = ws[0][k][tx];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r)
        acc[r] = fmaf(ps[ty + r * (kThreads / kTileN)][k], b, acc[r]);
    }
    __syncthreads();
  }
  const int n = n0 + tx;
  if (n >= d) return;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int c = c0 + ty + r * (kThreads / kTileN);
    if (c < C) out[((size_t)e * C + c) * d + n] = from_f<T>(acc[r]);
  }
}

template <typename T>
int run(const void* x, const void* wi, const void* wg, const void* wo,
        void* work, void* out, int E, int C, int d, int f, int act,
        cudaStream_t st) {
  const dim3 ga((f + kTileN - 1) / kTileN, (C + kTileC - 1) / kTileC, E);
  gate_up_kernel<T><<<ga, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(wi),
      static_cast<const T*>(wg), static_cast<T*>(work), C, d, f, act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 gb((d + kTileN - 1) / kTileN, (C + kTileC - 1) / kTileC, E);
  down_kernel<T><<<gb, kThreads, 0, st>>>(
      static_cast<const T*>(work), static_cast<const T*>(wo),
      static_cast<T*>(out), C, d, f);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (E, C, d), wi/wg (E, d, f), wo (E, f, d), work (E, C, f), out (E, C, d),
// all contiguous, of one dtype: 0 = f32, 1 = bf16.  act: 0 silu, 1 gelu
// (tanh form), 2 squared relu.  Returns a cudaError_t as int.
int moe_ffn(const void* x, const void* wi, const void* wg, const void* wo,
            void* work, void* out, int E, int C, int d, int f, int dtype,
            int act, void* stream) {
  if (E == 0 || C == 0 || d == 0) return 0;
  if (E > 65535 || (C + kTileC - 1) / kTileC > 65535)
    return (int)cudaErrorInvalidValue;       // grid.z / grid.y limits
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(x, wi, wg, wo, work, out, E, C, d, f, act, st);
  return run<__nv_bfloat16>(x, wi, wg, wo, work, out, E, C, d, f, act, st);
}

const char* moe_ffn_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
