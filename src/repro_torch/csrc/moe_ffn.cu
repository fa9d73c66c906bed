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
// Design: two launches.  Kernel A, per (f tile, C tile, expert), computes
// the h and g tiles over d and writes the rounded (C, f) intermediate
// act(g) * h to a workspace; kernel B, per (d tile, C tile, expert),
// multiplies it by wo.  The Pallas kernel keeps the intermediate on chip by
// walking f in sequence; blocks on 132 SMs do not run in sequence, so here
// it makes one round trip through device memory (E * C * f values, small
// against the weights).
// - Experts without a token read no weights.  The dispatch buffer fills
//   each expert from row 0 and leaves its empty slots zero rows.  A zero
//   row of x gives h = g = 0, and every activation here maps 0 to 0, so the
//   row's intermediate and output are exact zeros.  So each block first
//   checks its C tile of x (kernel A) or of the intermediate (kernel B):
//   if every row is zero it writes zeros and returns without reading a
//   weight.  At a 4-row decode step at most 16 of 64 experts hold a token.
// - bf16: the products run on the tensor cores (mma.sync m16n8k16, f32
//   accumulators), the C tile padded to 16 rows.  The weights stream
//   through a ring of kStages shared-memory stages of 64-deep tiles, filled
//   by 16-byte cp.async copies (neighbouring threads on neighbouring
//   addresses), kStages - 1 stages in flight while one is computed, one
//   barrier per stage.  Rows are padded by 16 bytes so ldmatrix reads no
//   bank twice.  Widths that are no multiple of 8 (or operands not 16-byte
//   aligned) are staged by plain loads instead of cp.async.
// - f32: products on the CUDA cores (FMA, no TF32), tiles staged as f32.
//
// These decode kernels serve every call without a gradient.  Training in
// bf16 takes a forward of its own that also writes h and g (moe_ffn_train)
// and the backward that reads them (moe_ffn_bwd_train), on wgmma fed by
// TMA; the f32 backward (moe_ffn_bwd) recomputes h and g.  The backward
// has no Pallas counterpart: the JAX package differentiates expert_ffn's
// einsums with XLA.  Their designs are set out above their kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

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
    // the constant rounds to T first, as JAX's weakly typed one does
    const float k = rnd<T>(0.044715f);
    const float inner = rnd<T>(c * rnd<T>(u + rnd<T>(k * u3)));
    const float half = rnd<T>(0.5f * rnd<T>(1.f + rnd<T>(tanhf(inner))));
    return rnd<T>(u * half);
  }
  const float r = fmaxf(u, 0.f);
  return rnd<T>(r * r);
}

// True if rows [r0, r0 + rows) of the row-major (., width) matrix a hold a
// nonzero value (a barrier: every thread of the block calls it).  VEC: in
// 16-byte words (rows of width * sizeof(T) a multiple of 16 bytes, a
// 16-byte aligned), a value nonzero when a bit other than its sign is set.
template <typename T, bool VEC>
__device__ __forceinline__ bool tile_has_nonzero(const T* a, int r0, int rows,
                                                 int width) {
  const T* base = a + (size_t)r0 * width;
  bool nz = false;
  if (VEC) {
    constexpr uint32_t kMag = sizeof(T) == 2 ? 0x7fff7fffu : 0x7fffffffu;
    const uint4* w = reinterpret_cast<const uint4*>(base);
    const int n = rows * width * (int)sizeof(T) / 16;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const uint4 v = __ldg(w + i);
      nz |= ((v.x | v.y | v.z | v.w) & kMag) != 0;
    }
  } else {
    const int n = rows * width;
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      nz |= to_f<T>(base[i]) != 0.f;
  }
  return __syncthreads_or(nz);
}

// Write zeros to the (rows, cols) tile at (r0, n0) of the (., width) output.
template <typename T>
__device__ __forceinline__ void zero_tile(T* out, int r0, int rows, int n0,
                                          int cols, int width) {
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int r = i / cols, c = i - r * cols;
    out[(size_t)(r0 + r) * width + n0 + c] = from_f<T>(0.f);
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileM = 16;          // rows of the dispatch buffer per block
constexpr int kTileN = 16 * kWarps; // output columns per block, 16 per warp
constexpr int kTileK = 64;          // depth of one stage
constexpr int kStages = 4;          // ring of stages, kStages - 1 in flight
constexpr int kStr = kTileK + 8;    // padded row (bf16) of an x stage
constexpr int kWStr = kTileN + 8;   // padded row (bf16) of a weight stage
constexpr int kXElems = kTileM * kStr;
constexpr int kWElems = kTileK * kWStr;
constexpr int kXChunks = kTileM * kTileK / 8;   // 16-byte copies a stage
constexpr int kWChunks = kTileK * kTileN / 8;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, in flight until waited on; zeros if !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage k-tile kt: the (kTileM, kTileK) tile of a (rows, depth) at (r0, k0)
// and the (kTileK, kTileN) tiles of NB (depth, cols) matrices at (k0, n0),
// zero outside the matrices.  VEC: 16-byte cp.async copies (depth and cols
// multiples of 8, operands 16-byte aligned); else plain loads and stores.
template <int NB, bool VEC>
__device__ __forceinline__ void load_stage(bf16* xs, bf16* ws,
                                           const bf16* a, const bf16* b0,
                                           const bf16* b1, int r0, int rows,
                                           int k0, int depth, int n0,
                                           int cols) {
  const int tid = threadIdx.x;
  if (VEC) {
#pragma unroll
    for (int i = tid; i < kXChunks; i += kThreads) {
      const int r = i / (kTileK / 8), c = i % (kTileK / 8) * 8;
      const bool ok = r0 + r < rows && k0 + c < depth;
      cp_async16(xs + r * kStr + c,
                 ok ? a + (size_t)(r0 + r) * depth + k0 + c : a, ok);
    }
#pragma unroll
    for (int i = tid; i < kWChunks; i += kThreads) {
      const int k = i / (kTileN / 8), c = i % (kTileN / 8) * 8;
      const bool ok = k0 + k < depth && n0 + c < cols;
      const size_t at = ok ? (size_t)(k0 + k) * cols + n0 + c : 0;
      cp_async16(ws + k * kWStr + c, b0 + at, ok);
      if (NB == 2) cp_async16(ws + kWElems + k * kWStr + c, b1 + at, ok);
    }
  } else {
    for (int i = tid; i < kTileM * kTileK; i += kThreads) {
      const int r = i / kTileK, c = i - r * kTileK;
      const bool ok = r0 + r < rows && k0 + c < depth;
      xs[r * kStr + c] = ok ? a[(size_t)(r0 + r) * depth + k0 + c]
                            : from_f<bf16>(0.f);
    }
    for (int i = tid; i < kTileK * kTileN; i += kThreads) {
      const int k = i / kTileN, c = i - k * kTileN;
      const bool ok = k0 + k < depth && n0 + c < cols;
      const size_t at = (size_t)(k0 + k) * cols + n0 + c;
      ws[k * kWStr + c] = ok ? b0[at] : from_f<bf16>(0.f);
      if (NB == 2) ws[kWElems + k * kWStr + c] = ok ? b1[at] : from_f<bf16>(0.f);
    }
  }
}

// acc[b][j] (16 x 8 fragments) += A (16 x depth) . B_b (depth x 16 of this
// warp's columns, n8 tiles j = 0, 1) over the rows [r0, r0 + 16) of a and
// columns [n0 + 16 * warp, +16) of b0 (and b1).
template <int NB, bool VEC>
__device__ __forceinline__ void mma_tile(float (&acc)[NB][2][4], bf16* smem,
                                         const bf16* a, const bf16* b0,
                                         const bf16* b1, int r0, int rows,
                                         int depth, int n0, int cols) {
  constexpr int kStage = kXElems + NB * kWElems;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nk = (depth + kTileK - 1) / kTileK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk)
      load_stage<NB, VEC>(smem + s * kStage, smem + s * kStage + kXElems, a,
                          b0, b1, r0, rows, s * kTileK, depth, n0, cols);
    cp_async_commit();
  }
  // ldmatrix lane addresses: A rows (lane & 15), k half (lane >> 4); B (read
  // transposed) k rows (lane & 7) + 8 * ((lane >> 3) & 1), n half (lane >> 4)
  const int a_off = (lane & 15) * kStr + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * kWStr
                    + (lane >> 4) * 8 + 16 * warp;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    // stage kt has landed for every thread, and every warp is done with
    // stage kt - 1, which the next copy overwrites
    __syncthreads();
    const int nxt = kt + kStages - 1;
    if (nxt < nk) {
      bf16* st = smem + (nxt % kStages) * kStage;
      load_stage<NB, VEC>(st, st + kXElems, a, b0, b1, r0, rows,
                          nxt * kTileK, depth, n0, cols);
    }
    cp_async_commit();
    const bf16* st = smem + (kt % kStages) * kStage;
    const uint32_t xa = smem_u32(st + a_off);
    const uint32_t wa = smem_u32(st + kXElems + b_off);
#pragma unroll
    for (int kk = 0; kk < kTileK / 16; ++kk) {
      uint32_t af[4];
      ldmatrix_x4(af, xa + 2 * (kk * 16));
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, wa + 2 * (b * kWElems + kk * 16 * kWStr));
        mma_bf16(acc[b][0], af, bf[0], bf[1]);
        mma_bf16(acc[b][1], af, bf[2], bf[3]);
      }
    }
  }
  cp_async_wait<0>();
}

// Kernel A: p[e, c, n] = rnd(act(rnd(x.wg)) * rnd(x.wi)), n over f
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
gate_up_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wi,
                   const bf16* __restrict__ wg, bf16* __restrict__ p, int C,
                   int d, int f, int act, int* __restrict__ skipped) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int e = blockIdx.z, c0 = blockIdx.y * kTileM, n0 = blockIdx.x * kTileN;
  const int rows = min(kTileM, C - c0), cols = min(kTileN, f - n0);
  const bf16* xe = x + (size_t)e * C * d;
  bf16* pe = p + (size_t)e * C * f;
  if (!tile_has_nonzero<bf16, VEC>(xe, c0, rows, d)) {
    zero_tile(pe, c0, rows, n0, cols, f);
    if (skipped && blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(skipped, 1);
    return;
  }
  float acc[2][2][4] = {};
  mma_tile<2, VEC>(acc, smem, xe, wi + (size_t)e * d * f,
                   wg + (size_t)e * d * f, c0, C, d, n0, f);
  // fragment rows lane / 4 and + 8, columns 2 * (lane % 4) + {0, 1}
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (lane >> 2) + 8 * (i >> 1);
      const int n = n0 + 16 * warp + 8 * j + 2 * (lane & 3) + (i & 1);
      if (r < rows && n < f)
        pe[(size_t)(c0 + r) * f + n] = from_f<bf16>(
            activation<bf16>(rnd<bf16>(acc[1][j][i]), act)
            * rnd<bf16>(acc[0][j][i]));
    }
}

// Kernel B: out[e, c, n] = rnd(p[e, c, :] . wo[e, :, n]), n over d
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
down_mma_kernel(const bf16* __restrict__ p, const bf16* __restrict__ wo,
                bf16* __restrict__ out, int C, int d, int f) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int e = blockIdx.z, c0 = blockIdx.y * kTileM, n0 = blockIdx.x * kTileN;
  const int rows = min(kTileM, C - c0), cols = min(kTileN, d - n0);
  const bf16* pe = p + (size_t)e * C * f;
  bf16* oe = out + (size_t)e * C * d;
  if (!tile_has_nonzero<bf16, VEC>(pe, c0, rows, f)) {
    zero_tile(oe, c0, rows, n0, cols, d);
    return;
  }
  float acc[1][2][4] = {};
  mma_tile<1, VEC>(acc, smem, pe, wo + (size_t)e * f * d, nullptr, c0, C, f,
                   n0, d);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (lane >> 2) + 8 * (i >> 1);
      const int n = n0 + 16 * warp + 8 * j + 2 * (lane & 3) + (i & 1);
      if (r < rows && n < d)
        oe[(size_t)(c0 + r) * d + n] = from_f<bf16>(acc[0][j][i]);
    }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <bool VEC>
int run_mma(const void* x, const void* wi, const void* wg, const void* wo,
            void* work, void* out, int E, int C, int d, int f, int act,
            int* skipped, cudaStream_t st) {
  static bool ready = false;     // the shared-memory limits are set once
  const size_t smem_a = (size_t)kStages * (kXElems + 2 * kWElems) * 2;
  const size_t smem_b = (size_t)kStages * (kXElems + kWElems) * 2;
  if (!ready) {
    cudaError_t err = allow_smem(gate_up_mma_kernel<VEC>, smem_a);
    if (err == cudaSuccess) err = allow_smem(down_mma_kernel<VEC>, smem_b);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  const int mt = (C + kTileM - 1) / kTileM;
  gate_up_mma_kernel<VEC>
      <<<dim3((f + kTileN - 1) / kTileN, mt, E), kThreads, smem_a, st>>>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(wi),
          static_cast<const bf16*>(wg), static_cast<bf16*>(work), C, d, f,
          act, skipped);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  down_mma_kernel<VEC>
      <<<dim3((d + kTileN - 1) / kTileN, mt, E), kThreads, smem_b, st>>>(
          static_cast<const bf16*>(work), static_cast<const bf16*>(wo),
          static_cast<bf16*>(out), C, d, f);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kFThreads = 256;
constexpr int kFTileC = 16;      // rows of the dispatch buffer per block
constexpr int kFTileN = 64;      // output columns per block (f in A, d in B)
constexpr int kFTileK = 32;      // depth staged per step
constexpr int kRowsPerThread = kFTileC / (kFThreads / kFTileN);

// Stage a (kFTileC, kFTileK) tile of a row-major (rows, depth) matrix and
// (kFTileK, kFTileN) tiles of one or two (NB) row-major (depth, cols)
// matrices b0, b1, zero outside the matrix.
template <int NB>
__device__ __forceinline__ void stage_f32(
    float (*as)[kFTileK + 1], float (*bs)[kFTileK][kFTileN], const float* a,
    const float* b0, const float* b1, int r0, int rows, int k0, int depth,
    int n0, int cols) {
  for (int i = threadIdx.x; i < kFTileC * kFTileK; i += kFThreads) {
    const int r = i / kFTileK, k = i % kFTileK;
    as[r][k] = (r0 + r < rows && k0 + k < depth)
                   ? a[(size_t)(r0 + r) * depth + k0 + k] : 0.f;
  }
  for (int i = threadIdx.x; i < kFTileK * kFTileN; i += kFThreads) {
    const int k = i / kFTileN, n = i % kFTileN;
    const bool ok = k0 + k < depth && n0 + n < cols;
    const size_t at = (size_t)(k0 + k) * cols + n0 + n;
    bs[0][k][n] = ok ? b0[at] : 0.f;
    if (NB == 2) bs[1][k][n] = ok ? b1[at] : 0.f;
  }
}

__global__ void __launch_bounds__(kFThreads)
gate_up_f32_kernel(const float* __restrict__ x, const float* __restrict__ wi,
                   const float* __restrict__ wg, float* __restrict__ p, int C,
                   int d, int f, int act, int* __restrict__ skipped) {
  __shared__ float xs[kFTileC][kFTileK + 1];
  __shared__ float ws[2][kFTileK][kFTileN];
  const int e = blockIdx.z, c0 = blockIdx.y * kFTileC;
  const int n0 = blockIdx.x * kFTileN;
  const float* xe = x + (size_t)e * C * d;
  float* pe = p + (size_t)e * C * f;
  if (!tile_has_nonzero<float, false>(xe, c0, min(kFTileC, C - c0), d)) {
    zero_tile(pe, c0, min(kFTileC, C - c0), n0, min(kFTileN, f - n0), f);
    if (skipped && blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(skipped, 1);
    return;
  }
  const int tx = threadIdx.x % kFTileN, ty = threadIdx.x / kFTileN;
  const float* wie = wi + (size_t)e * d * f;
  const float* wge = wg + (size_t)e * d * f;
  float h[kRowsPerThread] = {}, g[kRowsPerThread] = {};
  for (int k0 = 0; k0 < d; k0 += kFTileK) {
    stage_f32<2>(xs, ws, xe, wie, wge, c0, C, k0, d, n0, f);
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kFTileK; ++k) {
      const float a = ws[0][k][tx], b = ws[1][k][tx];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const float xv = xs[ty + r * (kFThreads / kFTileN)][k];
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
    const int c = c0 + ty + r * (kFThreads / kFTileN);
    if (c < C)
      p[((size_t)e * C + c) * f + n] = activation<float>(g[r], act) * h[r];
  }
}

__global__ void __launch_bounds__(kFThreads)
down_f32_kernel(const float* __restrict__ p, const float* __restrict__ wo,
                float* __restrict__ out, int C, int d, int f) {
  __shared__ float ps[kFTileC][kFTileK + 1];
  __shared__ float ws[1][kFTileK][kFTileN];
  const int e = blockIdx.z, c0 = blockIdx.y * kFTileC;
  const int n0 = blockIdx.x * kFTileN;
  const float* pe = p + (size_t)e * C * f;
  if (!tile_has_nonzero<float, false>(pe, c0, min(kFTileC, C - c0), f)) {
    zero_tile(out + (size_t)e * C * d, c0, min(kFTileC, C - c0), n0,
              min(kFTileN, d - n0), d);
    return;
  }
  const int tx = threadIdx.x % kFTileN, ty = threadIdx.x / kFTileN;
  const float* woe = wo + (size_t)e * f * d;
  float acc[kRowsPerThread] = {};
  for (int k0 = 0; k0 < f; k0 += kFTileK) {
    stage_f32<1>(ps, ws, pe, woe, woe, c0, C, k0, f, n0, d);
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kFTileK; ++k) {
      const float b = ws[0][k][tx];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r)
        acc[r] = fmaf(ps[ty + r * (kFThreads / kFTileN)][k], b, acc[r]);
    }
    __syncthreads();
  }
  const int n = n0 + tx;
  if (n >= d) return;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int c = c0 + ty + r * (kFThreads / kFTileN);
    if (c < C) out[((size_t)e * C + c) * d + n] = acc[r];
  }
}

int run_f32(const void* x, const void* wi, const void* wg, const void* wo,
            void* work, void* out, int E, int C, int d, int f, int act,
            int* skipped, cudaStream_t st) {
  const int mt = (C + kFTileC - 1) / kFTileC;
  gate_up_f32_kernel<<<dim3((f + kFTileN - 1) / kFTileN, mt, E), kFThreads,
                       0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(wi),
      static_cast<const float*>(wg), static_cast<float*>(work), C, d, f, act,
      skipped);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  down_f32_kernel<<<dim3((d + kFTileN - 1) / kFTileN, mt, E), kFThreads, 0,
                    st>>>(
      static_cast<const float*>(work), static_cast<const float*>(wo),
      static_cast<float*>(out), C, d, f);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ---------------------------------------------------------------------------
// The gradient of out = (act(x wg) * (x wi)) wo for dY = dout
// ---------------------------------------------------------------------------
//
// With h = x wi, g = x wg, A = act(g) * h (each rounded as the forward
// rounds them):
//   dA = dY wo^T,  dH = dA * act(g),  dG = dA * h * act'(g)
//   dX = dH wi^T + dG wg^T,  dWi = x^T dH,  dWg = x^T dG,  dWo = A^T dY
// dA, dH and dX are rounded to the dtype once each; dG once from its f32
// product, act'(g) taken in f32 from the rounded g.  No launch adds with
// atomics on a value, so a second call is bit-identical.  A zero row of x
// gives h = g = A = dH = dG = 0, so tiles of zero rows (tokenless
// experts, the empty tail of each expert's buffer) add exact zeros and
// are skipped.
//
// f32 (FMA on the CUDA cores, 4 x 4 outputs a thread, 64 x 64 tiles):
// - B1 (gate): per (f tile, 64-row C tile, expert), h and g recomputed
//   over d, then dA over d; writes A, dH and dG to (E, C, fp) workspaces
//   (the pad columns hold zeros), and whether the C tile of x holds a
//   nonzero value to a flag; counts the tiles it skipped.
// - B2 (dx): per (d tile, C tile, expert), dX over f; a flagged-zero tile
//   writes zeros.
// - B3 (dw): per (f tile, d tile, expert) dWi and dWg, per (d tile, f
//   tile, expert) dWo, each summed over the C rows up to the expert's last
//   nonzero tile in one order.  An expert without a token writes zeros and
//   reads nothing.
// bf16 takes the training kernels below instead: h and g come from the
// training forward, not from a recompute.

constexpr int kBM = 64;                   // output rows per block
constexpr int kBN = 64;                   // output columns per block
constexpr int kFK = 16;                   // depth of one stage
constexpr int kFStr = kBM + 1;            // a [k][mn] tile's row

// One operand's kFK x 64 slice into dst[k][mn] (row stride kFStr), from a
// matrix stored [k][mn] (KROW) or [mn][k], zero outside it.
template <bool KROW>
__device__ __forceinline__ void stage_f32_operand(float* dst,
                                                  const float* src, int ld,
                                                  int mn0, int mn, int k0,
                                                  int k) {
  for (int i = threadIdx.x; i < kFK * kBM; i += kThreads) {
    const int kk = KROW ? i / kBM : i % kFK;
    const int r = KROW ? i % kBM : i / kFK;
    const bool ok = k0 + kk < k && mn0 + r < mn;
    const size_t at = KROW ? (size_t)(k0 + kk) * ld + mn0 + r
                           : (size_t)(mn0 + r) * ld + k0 + kk;
    dst[kk * kFStr + r] = ok ? src[at] : 0.f;
  }
}

// acc[b] (the block's 64 x 64 tile at (m0, n0), 16 values a thread) +=
// A . B_b over depth k, for A (m rows) stored [k][m] (AK) or [m][k] and
// B_b (n columns) stored [k][n] (BK) or [n][k].  Value j of a thread is
// row ty + 16 (j / 4), column tx + 16 (j % 4) of the tile (tile_rc).
template <int NB, bool AK, bool BK>
__device__ __forceinline__ void fma_gemm(float (&acc)[NB][16], float* smem,
                                         const float* a, int lda, int m,
                                         const float* b0, const float* b1,
                                         int ldb, int n, int m0, int n0,
                                         int k) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float* as = smem;
  float* bs = smem + kFK * kFStr;
  for (int k0 = 0; k0 < k; k0 += kFK) {
    __syncthreads();
    stage_f32_operand<AK>(as, a, lda, m0, m, k0, k);
    stage_f32_operand<BK>(bs, b0, ldb, n0, n, k0, k);
    if (NB == 2) stage_f32_operand<BK>(bs + kFK * kFStr, b1, ldb, n0, n, k0,
                                       k);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kFK; ++kk) {
      float av[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[kk * kFStr + ty + 16 * i];
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float bv = bs[b * kFK * kFStr + kk * kFStr + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[b][4 * i + j] = fmaf(av[i], bv, acc[b][4 * i + j]);
        }
    }
  }
}

// (row, column) in the block's tile of a thread's value j
__device__ __forceinline__ void tile_rc(int j, int& r, int& c) {
  r = (threadIdx.x >> 4) + 16 * (j >> 2);
  c = (threadIdx.x & 15) + 16 * (j & 3);
}

constexpr size_t bwd_smem(int nb) {
  return (size_t)(1 + nb) * kFK * kFStr * 4;
}

// d act(u) / du in f32, of the activations above
__device__ __forceinline__ float activation_grad(float u, int act) {
  if (act == kSilu) {
    const float s = 1.f / (1.f + expf(-u));
    return s * (1.f + u * (1.f - s));
  }
  if (act == kGelu) {
    const float c = 0.7978845608028654f;
    const float t = tanhf(c * (u + 0.044715f * (u * u * u)));
    return 0.5f * (1.f + t)
           + 0.5f * u * (1.f - t * t) * c * (1.f + 3.f * 0.044715f * u * u);
  }
  return 2.f * fmaxf(u, 0.f);
}

// B1: A, dH, dG (E, C, fp) and the C tiles' flags (E, mt)
__global__ void __launch_bounds__(kThreads)
moe_bwd_gate_f32_kernel(const float* __restrict__ x,
                        const float* __restrict__ wi,
                        const float* __restrict__ wg,
                        const float* __restrict__ wo,
                        const float* __restrict__ dy, float* __restrict__ aw,
                        float* __restrict__ dh, float* __restrict__ dg,
                        int* __restrict__ flags, int C, int d, int f, int fp,
                        int act, int* __restrict__ skipped) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int e = blockIdx.z, c0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int rows = min(kBM, C - c0);
  const size_t xo = (size_t)e * C * d, wof = (size_t)e * d * f,
               po = (size_t)e * C * fp;
  const bool nz = tile_has_nonzero<float, false>(x + xo, c0, rows, d);
  if (blockIdx.x == 0 && threadIdx.x == 0)
    flags[e * gridDim.y + blockIdx.y] = nz;
  if (!nz) {
    const int cols = min(kBN, fp - n0);
    zero_tile(aw + po, c0, rows, n0, cols, fp);
    zero_tile(dh + po, c0, rows, n0, cols, fp);
    zero_tile(dg + po, c0, rows, n0, cols, fp);
    if (skipped && blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(skipped, 1);
    return;
  }
  float hg[2][16] = {}, da[1][16] = {};
  fma_gemm<2, false, true>(hg, smem, x + xo, d, C, wi + wof, wg + wof, f, f,
                           c0, n0, d);
  fma_gemm<1, false, false>(da, smem, dy + xo, d, C, wo + wof, nullptr, d, f,
                            c0, n0, d);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    int r, c;
    tile_rc(j, r, c);
    const int n = n0 + c;
    if (r < rows && n < fp) {    // columns f..fp-1 come out exact zeros
      const float h = hg[0][j], g = hg[1][j], a = da[0][j];
      const float ag = activation<float>(g, act);
      const size_t at = po + (size_t)(c0 + r) * fp + n;
      aw[at] = ag * h;
      dh[at] = a * ag;
      dg[at] = a * h * activation_grad(g, act);
    }
  }
}

// B2: dX (E, C, d) = dH wi^T + dG wg^T
__global__ void __launch_bounds__(kThreads)
moe_bwd_dx_f32_kernel(const float* __restrict__ dh,
                      const float* __restrict__ dg,
                      const float* __restrict__ wi,
                      const float* __restrict__ wg,
                      const int* __restrict__ flags, float* __restrict__ dx,
                      int C, int d, int f, int fp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int e = blockIdx.z, c0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int rows = min(kBM, C - c0);
  float* dxe = dx + (size_t)e * C * d;
  if (!flags[e * gridDim.y + blockIdx.y]) {
    zero_tile(dxe, c0, rows, n0, min(kBN, d - n0), d);
    return;
  }
  const size_t wof = (size_t)e * d * f, po = (size_t)e * C * fp;
  float acc[1][16] = {};
  fma_gemm<1, false, false>(acc, smem, dh + po, fp, C, wi + wof, nullptr, f,
                            d, c0, n0, f);
  fma_gemm<1, false, false>(acc, smem, dg + po, fp, C, wg + wof, nullptr, f,
                            d, c0, n0, f);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    int r, c;
    tile_rc(j, r, c);
    if (r < rows && n0 + c < d) dxe[(size_t)(c0 + r) * d + n0 + c] = acc[0][j];
  }
}

// B3: dWi, dWg (E, d, f) = x^T dH, x^T dG, or (DWO) dWo (E, f, d) = A^T dY,
// over the C rows up to the expert's last flagged tile
template <bool DWO>
__global__ void __launch_bounds__(kThreads)
moe_bwd_dw_f32_kernel(const float* __restrict__ x,
                      const float* __restrict__ dy,
                      const float* __restrict__ aw,
                      const float* __restrict__ dh,
                      const float* __restrict__ dg,
                      const int* __restrict__ flags, float* __restrict__ dwi,
                      float* __restrict__ dwg, float* __restrict__ dwo, int C,
                      int d, int f, int fp, int mt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int e = blockIdx.z, m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int m = DWO ? f : d, n = DWO ? d : f;
  const int rows = min(kBM, m - m0), cols = min(kBN, n - n0);
  int last = -1;
  for (int i = 0; i < mt; ++i)
    if (flags[e * mt + i]) last = i;
  const int depth = min(C, (last + 1) * kBM);
  const size_t xo = (size_t)e * C * d, po = (size_t)e * C * fp,
               wof = (size_t)e * d * f;
  if (depth == 0) {                // no token: zeros, nothing read
    if (DWO) {
      zero_tile(dwo + wof, m0, rows, n0, cols, n);
    } else {
      zero_tile(dwi + wof, m0, rows, n0, cols, n);
      zero_tile(dwg + wof, m0, rows, n0, cols, n);
    }
    return;
  }
  if (DWO) {
    float acc[1][16] = {};
    fma_gemm<1, true, true>(acc, smem, aw + po, fp, f, dy + xo, nullptr, d,
                            d, m0, n0, depth);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      int r, c;
      tile_rc(j, r, c);
      if (r < rows && c < cols)
        dwo[wof + (size_t)(m0 + r) * d + n0 + c] = acc[0][j];
    }
  } else {
    float acc[2][16] = {};
    fma_gemm<2, true, true>(acc, smem, x + xo, d, d, dh + po, dg + po, fp, f,
                            m0, n0, depth);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      int r, c;
      tile_rc(j, r, c);
      if (r < rows && c < cols) {
        const size_t at = wof + (size_t)(m0 + r) * f + n0 + c;
        dwi[at] = acc[0][j];
        dwg[at] = acc[1][j];
      }
    }
  }
}

int run_bwd_f32(const float* x, const float* wi, const float* wg,
                const float* wo, const float* dy, float* dx, float* dwi,
                float* dwg, float* dwo, float* aw, float* dh, float* dg,
                int* flags, int E, int C, int d, int f, int fp, int act,
                int* skipped, cudaStream_t st) {
  const size_t s1 = bwd_smem(1), s2 = bwd_smem(2);
  const int mt = (C + kBM - 1) / kBM;
  const int dt = (d + kBN - 1) / kBN, ft = (f + kBN - 1) / kBN;
  const int fpt = (fp + kBN - 1) / kBN;
  moe_bwd_gate_f32_kernel<<<dim3(fpt, mt, E), kThreads, s2, st>>>(
      x, wi, wg, wo, dy, aw, dh, dg, flags, C, d, f, fp, act, skipped);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  moe_bwd_dx_f32_kernel<<<dim3(dt, mt, E), kThreads, s1, st>>>(
      dh, dg, wi, wg, flags, dx, C, d, f, fp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  moe_bwd_dw_f32_kernel<false><<<dim3(ft, dt, E), kThreads, s2, st>>>(
      x, dy, aw, dh, dg, flags, dwi, dwg, dwo, C, d, f, fp, mt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  moe_bwd_dw_f32_kernel<true><<<dim3(dt, ft, E), kThreads, s1, st>>>(
      x, dy, aw, dh, dg, flags, dwi, dwg, dwo, C, d, f, fp, mt);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 training: a forward that keeps A, h and g, and the backward that
// reads them, on wgmma fed by TMA
// ---------------------------------------------------------------------------
//
// Replaces: the same Pallas kernel (repro/kernels/moe_ffn/kernel.py::
// moe_ffn) on the training path, and its gradient, which the JAX package
// takes with XLA from moe.expert_ffn's einsums.  Serving keeps the decode
// kernels above: a decode step is bytes-bound and these tiles would waste
// 128 rows on a few tokens.
//
// What bounds it on an H100: operations.  A training step fills C (phi-
// tiny-moe: 15,363 of 16 x 1,280 slots at 8,192 tokens), so each weight
// tile is read by 10 C tiles; the forward is 6 flops a routed row per
// (d, f) pair (0.196 ms at phi-tiny-moe's width at the bf16 rate), the
// backward 12 (0.393 ms): dA, dX's two products, dWi, dWg and dWo, with h
// and g read from the forward instead of recomputed.
//
// Launches (each a grid of (N tile, M tile, expert) blocks):
// - flags: flags[e, t] = 1 where the 128-row C tile t of expert e's x holds
//   a nonzero value, one warp a row, stopping at the row's first nonzero
//   16 bytes (a row with a token costs one read).
// - forward gate-up (128 C rows x 128 f columns, h and g): the epilogue
//   rounds h and g, forms A = rnd(act(g) h) with the activation rounded op
//   by op (as gate_up_mma_kernel does), and writes A, h and g to (E, C, fp)
//   workspaces.  Down (128 x 256 of d): out = rnd(A wo) over K = fp.
// - backward dgate (P1, 128 x 256 of f): dA = dY wo^T, its epilogue reads
//   the saved h and g and writes dH and dG; dx (P2, 128 x 256 of d): dX =
//   dH wi^T + dG wg^T, one f32 sum over K = 2 fp; dw (P3, 128 of d x 128
//   of f): dWi = x^T dH and dWg = x^T dG; dwo (P4, 128 of f x 256 of d):
//   dWo = A^T dY.  P3 and P4 sum over C up to the expert's last flagged
//   tile; the others skip a flagged-zero C tile (zeros written, no weight
//   read; gate-up and P1 count those tiles).  An expert without a token
//   writes zero gradients and reads nothing.  P1's epilogue stages the
//   tile's saved h and g through the ring, which is free by then.
// Each block: 384 threads, one block an SM.  Warpgroup 0 is the producer
// (registers dropped to 40 by setmaxnreg; one thread issues the TMA
// loads), warpgroups 1 and 2 the consumers (232 registers), each owning 64
// rows of the 128.  A ring of kWgStages stages of 48 KiB (the two 64-row
// boxes of A and four 64-column boxes of B for 64 of depth) with a full
// and an empty mbarrier each.  Every operand is read through 3-D maps over
// (E, rows, columns) in 64 x 64 boxes with the 128-byte swizzle, so a box
// past an expert's rows, or past a width, lands as zeros and never reads
// the next expert; a K-major operand steps 32 bytes a k16 step inside its
// rows, an MN-major one (x^T, dH, dG, A^T, dY, the weights' columns) 16
// rows, read through wgmma's transpose bit, so no operand is copied.  A
// consumer issues a stage's products (m64n64k16, f32 accumulators, 128 of
// them in registers), commits, waits until only that stage's are in
// flight and frees the stage before.  A column chunk past N is computed
// on stale shared memory and never stored (no branch among the wgmmas).
// TMA needs rows of a multiple of 16 bytes: an operand whose rows are not
// (wi and wg at phi-tiny-moe's f = 915; x, dY and wo at an odd d) is
// copied once a call by moe_pad_rows_kernel into a workspace with rows of
// dp or fp values (d and f rounded up to 8), the pad columns zero; the
// forward's padded wi and wg are what the backward's dX pass reads.
// Outputs keep their true shapes (masked stores).  Every
// output element is one thread's sum in one order: no split-K, no
// atomics, so a recompute under the checkpoint gives the same bits.

constexpr int kWgThreads = 384;       // a producer and two consumer warpgroups
constexpr int kWgM = 128;             // output rows a block; C rows a flag
constexpr int kWgBox = 64 * 128;      // a 64 x 64 bf16 box: 8 KiB
constexpr int kWgBoxes = 6;           // a stage: 2 boxes of A, 4 of B
constexpr int kWgStages = 4;
constexpr int kWgSmem = kWgStages * kWgBoxes * kWgBox + 2 * kWgStages * 8
                        + 1024;       // the ring, its barriers, alignment

enum Epi { kEpiGate = 0, kEpiDgate = 1, kEpiStore = 2 };

// what a launch needs besides its maps
struct WgArgs {
  int M, N, K;          // the output's rows and columns; a segment's depth
  int segs;             // depth segments summed into one output (dX: 2)
  const int* flags;     // (E, mt): a 128-row C tile of x holds a token
  int mt;
  bf16* o[3];           // outputs (E, M, N): gate-up A, h, g; dgate dH,
                        // dG; store one or two (NB)
  const bf16* h;        // dgate: the forward's h and g, (E, M, N)
  const bf16* g;
  int* skipped;         // null, or counts the skipped C tiles
};

#define WG_D32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define WG_ACC(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])

// d (64 x 64 f32) += A (64 x 16) B (16 x 64), both bf16 in shared memory
// as TMA wrote them; TA / TB: A / B stored MN-major, read through the
// transpose bit.  d's element i of this thread: row 16 warp + g + 8 (i % 4
// / 2), column 8 (i / 4) + 2 tig + i % 2 of the tile
template <int TA, int TB>
__device__ __forceinline__ void wgmma_tile(float (&d)[32], uint64_t a,
                                           uint64_t b) {
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
               ", %32, %33, p, 1, 1, %35, %36;\n}\n"
               : WG_ACC(d)
               : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

#undef WG_D32
#undef WG_ACC

__device__ __forceinline__ void store_pair(bf16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

// One block's (128 x 64 NC) output tile of sum_k A B_b for NB products
// that share A (b = 0, 1) or, with segs 2, of A0 B0 + A1 B1 (maps a1, b1
// the second segment's).  TA, TB: A, B stored MN-major.  DEPTH: the depth
// runs over C up to the expert's last flagged tile; else the block's M
// tile is a C tile, skipped when its flag is 0.  ACT: the activation of
// the gate-up and dgate epilogues, fixed at compile time (a switch in
// every one of a thread's 128 elements made the epilogue's code too large
// for the instruction cache).
template <bool TA, bool TB, int NB, int NC, int EPI, bool DEPTH, int ACT>
__device__ __forceinline__ void wg_gemm(const CUtensorMap* a0,
                                        const CUtensorMap* a1,
                                        const CUtensorMap* b0,
                                        const CUtensorMap* b1,
                                        const WgArgs& p) {
  static_assert(NB * NC == 4, "a stage holds four boxes of B");
  const int e = blockIdx.z, m0 = blockIdx.y * kWgM, n0 = blockIdx.x * 64 * NC;
  const int tid = threadIdx.x;
  int depth = p.K;
  bool live;
  if (DEPTH) {
    int last = -1;
    for (int i = 0; i < p.mt; ++i)
      if (p.flags[e * p.mt + i]) last = i;
    depth = min(p.K, (last + 1) * kWgM);
    live = depth > 0;
  } else {
    live = p.flags[e * p.mt + blockIdx.y] != 0;
  }
  if (!live) {                     // zeros written, nothing read
    const int rows = min(kWgM, p.M - m0), cols = min(64 * NC, p.N - n0);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      if (p.o[k] != nullptr)
        zero_tile(p.o[k] + (size_t)e * p.M * p.N, m0, rows, n0, cols, p.N);
    if (!DEPTH && p.skipped && blockIdx.x == 0 && tid == 0)
      atomicAdd(p.skipped, 1);
    return;
  }
  const int ma = min(2, (p.M - m0 + 63) / 64);   // A's boxes that hold rows
  const int nb = min(NC, (p.N - n0 + 63) / 64);  // B's boxes that hold columns
  const int nk = (depth + 63) / 64;
  const int steps = p.segs * nk;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = base + kWgStages * kWgBoxes * kWgBox;
  const uint32_t empty = full + 8 * kWgStages;
  if (tid == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full + 8 * s, 1);              // the producer's thread
      mbar_init(empty + 8 * s, 128 * ma);      // every live consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid != 0) return;
    const uint32_t bytes = (ma + NB * nb) * kWgBox;
    int stage = 0, phase = 0;
    for (int s = 0; s < steps; ++s) {
      const int seg = s >= nk;
      const int k0 = (s - seg * nk) * 64;
      mbar_wait(empty + 8 * stage, phase ^ 1);
      const uint32_t fb = full + 8 * stage;
      const uint32_t dst = base + stage * kWgBoxes * kWgBox;
      mbar_arrive_tx(fb, bytes);
      const CUtensorMap* am = seg ? a1 : a0;
      for (int c = 0; c < ma; ++c) {
        if (TA) tma_load3(dst + c * kWgBox, am, fb, m0 + 64 * c, k0, e);
        else tma_load3(dst + c * kWgBox, am, fb, k0, m0 + 64 * c, e);
      }
      for (int b = 0; b < NB; ++b) {
        const CUtensorMap* bm = (b == 1 || seg) ? b1 : b0;
        for (int c = 0; c < nb; ++c) {
          const uint32_t at = dst + (2 + b * NC + c) * kWgBox;
          if (TB) tma_load3(at, bm, fb, n0 + 64 * c, k0, e);
          else tma_load3(at, bm, fb, k0, n0 + 64 * c, e);
        }
      }
      if (++stage == kWgStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // consumers: warpgroup w owns output rows m0 + 64 w .. + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int w = (tid >> 7) - 1;
  if (w >= ma) return;
  float acc[NB][NC][32];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[b][c][i] = 0.f;
  int stage = 0, phase = 0, held = -1;
  for (int s = 0; s < steps; ++s) {
    mbar_wait(full + 8 * stage, phase);
    const uint32_t st = base + stage * kWgBoxes * kWgBox;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da =
          sw128_desc(st + w * kWgBox + (TA ? kk * 2048 : kk * 32));
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          wgmma_tile<TA, TB>(acc[b][c], da,
                             sw128_desc(st + (2 + b * NC + c) * kWgBox
                                        + (TB ? kk * 2048 : kk * 32)));
    }
    wgmma_commit();
    wgmma_wait_upto<1>();          // the stage before has been read
    if (held >= 0) mbar_arrive(empty + 8 * held);
    held = stage;
    if (++stage == kWgStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  wgmma_wait();
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int c = 0; c < NC; ++c) pin(acc[b][c]);

  const int lane = tid & 31, cw = (tid >> 5) & 3;
  const int r0 = m0 + 64 * w + 16 * cw + (lane >> 2);
  const size_t eo = (size_t)e * p.M * p.N;
  if constexpr (EPI == kEpiDgate) {
    // dH = rnd(dA) act(g), dG = rnd(dA) h act'(g) from the saved h and g
    // (N = fp, even: pairs).  Once both consumers are done with the ring,
    // each copies its 64 rows of the tile's h and g into it by 16-byte
    // cp.async, all in flight at once, and reads them back in its
    // accumulators' layout (4-byte loads from device memory in that layout
    // sank to their uses and each waited out a round trip).  A staged row
    // is padded by 16 bytes, so the 8 rows one load instruction reads fall
    // in different banks.
    constexpr int kRow = 64 * NC * 2 + 16;
    asm volatile("bar.sync 1, %0;\n" ::"r"(128 * ma) : "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    unsigned char* hs = smem_raw + (base - smem_u32(smem_raw))
                        + w * 2 * 64 * kRow;
    unsigned char* gs = hs + 64 * kRow;
    for (int i = tid - 128 * (1 + w); i < 64 * 8 * NC; i += 128) {
      const int r = i / (8 * NC), k = (i - r * 8 * NC) * 8;
      const int row = m0 + 64 * w + r, col = n0 + k;
      if (row < p.M && col < p.N) {
        const size_t at = eo + (size_t)row * p.N + col;
        cp_async16(hs + r * kRow + 2 * k, p.h + at, true);
        cp_async16(gs + r * kRow + 2 * k, p.g + at, true);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + w) : "memory");
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = r0 + 8 * hh;
          const int col = n0 + 64 * c + 8 * j + 2 * (lane & 3);
          if (row >= p.M || col >= p.N) continue;
          const int so = (row - m0 - 64 * w) * kRow + 2 * (col - n0);
          const uint32_t h2 = *reinterpret_cast<const uint32_t*>(hs + so);
          const uint32_t g2 = *reinterpret_cast<const uint32_t*>(gs + so);
          const size_t at = eo + (size_t)row * p.N + col;
          float dhv[2], dgv[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            // bf16 q of the pair: the low half, then the high
            const float hv = __uint_as_float(q ? h2 & 0xffff0000u : h2 << 16);
            const float gv = __uint_as_float(q ? g2 & 0xffff0000u : g2 << 16);
            const float a = rnd<bf16>(acc[0][c][4 * j + 2 * hh + q]);
            dhv[q] = a * activation<bf16>(gv, ACT);
            dgv[q] = a * hv * activation_grad(gv, ACT);
          }
          store_pair(p.o[0] + at, dhv[0], dhv[1]);
          store_pair(p.o[1] + at, dgv[0], dgv[1]);
        }
    return;
  }
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + 64 * c + 8 * j + 2 * (lane & 3);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = r0 + 8 * hh;
        if (row >= p.M || col >= p.N) continue;
        const int i = 4 * j + 2 * hh;
        const size_t at = eo + (size_t)row * p.N + col;
        if constexpr (EPI == kEpiGate) {
          // N = fp, even: pairs; h from wi (b = 0), g from wg (b = 1)
          float hv[2], gv[2], av[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            hv[q] = rnd<bf16>(acc[0][c][i + q]);
            gv[q] = rnd<bf16>(acc[1][c][i + q]);
            av[q] = activation<bf16>(gv[q], ACT) * hv[q];
          }
          store_pair(p.o[0] + at, av[0], av[1]);
          store_pair(p.o[1] + at, hv[0], hv[1]);
          store_pair(p.o[2] + at, gv[0], gv[1]);
        } else {
#pragma unroll
          for (int b = 0; b < NB; ++b) {
            if ((p.N & 1) == 0) {
              store_pair(p.o[b] + at, acc[b][c][i], acc[b][c][i + 1]);
            } else {
              p.o[b][at] = from_f<bf16>(acc[b][c][i]);
              if (col + 1 < p.N)
                p.o[b][at + 1] = from_f<bf16>(acc[b][c][i + 1]);
            }
          }
        }
      }
    }
}

#define WG_KERNEL(name, TA, TB, NB, NC, EPI, DEPTH)                       \
  template <int ACT>                                                      \
  __global__ void __launch_bounds__(kWgThreads, 1) name(                  \
      const __grid_constant__ CUtensorMap a0,                             \
      const __grid_constant__ CUtensorMap a1,                             \
      const __grid_constant__ CUtensorMap b0,                             \
      const __grid_constant__ CUtensorMap b1,                             \
      const __grid_constant__ WgArgs p) {                                 \
    wg_gemm<TA, TB, NB, NC, EPI, DEPTH, ACT>(&a0, &a1, &b0, &b1, p);      \
  }

// forward: A = x (K-major), B = wi and wg (MN-major); A (K-major) by wo
WG_KERNEL(moe_train_gate_wgmma_kernel, false, true, 2, 2, kEpiGate, false)
WG_KERNEL(moe_train_down_wgmma_kernel, false, true, 1, 4, kEpiStore, false)
// backward: P1 dY by wo^T (both K-major); P2 dH by wi^T, dG by wg^T;
// P3 x^T (MN-major) by dH and dG (MN-major); P4 A^T by dY (both MN-major)
WG_KERNEL(moe_bwd_dgate_wgmma_kernel, false, false, 1, 4, kEpiDgate, false)
WG_KERNEL(moe_bwd_dx_wgmma_kernel, false, false, 1, 4, kEpiStore, false)
WG_KERNEL(moe_bwd_dw_wgmma_kernel, true, true, 2, 2, kEpiStore, true)
WG_KERNEL(moe_bwd_dwo_wgmma_kernel, true, true, 1, 4, kEpiStore, true)

#undef WG_KERNEL

// flags[e, t] = 1 (flags zeroed before) where the kWgM-row C tile t of
// expert e's rows of x (E, C, dp; dp % 8 == 0, 16-byte aligned) holds a
// nonzero value (a bit other than the sign set): a warp a row, 512 bytes
// a read, stopping at the first nonzero one
__global__ void __launch_bounds__(256)
moe_train_flags_kernel(const bf16* __restrict__ x, int C, int dp, int mt,
                       int* __restrict__ flags) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), e = blockIdx.y;
  if (row >= C) return;
  const uint4* xr =
      reinterpret_cast<const uint4*>(x + ((size_t)e * C + row) * dp);
  const int n = dp / 8;
  for (int i0 = 0; i0 < n; i0 += 32) {
    bool nz = false;
    if (i0 + lane < n) {
      const uint4 v = __ldg(xr + i0 + lane);
      nz = ((v.x | v.y | v.z | v.w) & 0x7fff7fffu) != 0;
    }
    if (__any_sync(0xffffffffu, nz)) {
      if (lane == 0) flags[e * mt + row / kWgM] = 1;
      return;
    }
  }
}

// dst (rows, wp) = src (rows, w) with zero columns w..wp - 1: what TMA
// can read of an operand whose rows are no multiple of 8 values or that
// does not start on 16 bytes (wp % 8 == 0, dst 16-byte aligned, src any
// bf16 address).  One 16-byte store a thread; neighbouring threads read
// neighbouring bytes of the row.
__global__ void __launch_bounds__(256)
moe_pad_rows_kernel(const bf16* __restrict__ src, bf16* __restrict__ dst,
                    long long rows, int w, int wp) {
  const int per_row = wp / 8;
  const long long n = rows * per_row;
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < n;
       i += (long long)gridDim.x * 256) {
    const long long r = i / per_row;
    const int c = (int)(i - r * per_row) * 8;
    const bf16* s = src + r * w + c;
    __align__(16) bf16 v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = c + q < w ? s[q] : from_f<bf16>(0.f);
    *reinterpret_cast<uint4*>(dst + r * wp + c) =
        *reinterpret_cast<const uint4*>(v);
  }
}

cudaError_t pad_rows(const void* src, void* dst, long long rows, int w,
                     int wp, cudaStream_t st) {
  const long long n = rows * (wp / 8);
  long long blocks = (n + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks == 0) return cudaSuccess;
  moe_pad_rows_kernel<<<(unsigned)blocks, 256, 0, st>>>(
      static_cast<const bf16*>(src), static_cast<bf16*>(dst), rows, w, wp);
  return cudaGetLastError();
}

// Makes the device that p lies on current for this thread in this
// library's runtime.  A backward runs on autograd's own thread, where no
// call may have bound a context yet, and the tensor-map encoder (a driver
// call) fails without one.
cudaError_t bind_device(const void* p) {
  cudaPointerAttributes at;
  cudaError_t e = cudaPointerGetAttributes(&at, p);
  if (e == cudaSuccess) e = cudaSetDevice(at.device);
  return e;
}

// a map of a contiguous bf16 (mats, rows, cols) tensor as the 3-D (cols,
// rows, mats), in 64 x 64 x 1 boxes with the 128-byte swizzle; whatever a
// box covers outside the tensor lands as zeros.  cols % 8 == 0, the base
// 16-byte aligned (TMA's strides and address).
bool box_map(CUtensorMap* m, const void* p, int mats, int rows, int cols) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)mats};
  const cuuint64_t strides[2] = {2ull * cols, 2ull * cols * rows};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p),
                dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

typedef void (*WgKernel)(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap,
                         WgArgs);

cudaError_t wg_launch(WgKernel kernel, dim3 grid, const CUtensorMap& a0,
                      const CUtensorMap& a1, const CUtensorMap& b0,
                      const CUtensorMap& b1, const WgArgs& args,
                      cudaStream_t st) {
  static WgKernel ready[16];     // the shared-memory limit is set once each
  static int n_ready = 0;
  bool set = false;
  for (int i = 0; i < n_ready; ++i) set = set || ready[i] == kernel;
  if (!set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem);
    if (e != cudaSuccess) return e;
    ready[n_ready++] = kernel;
  }
  kernel<<<grid, kWgThreads, kWgSmem, st>>>(a0, a1, b0, b1, args);
  return cudaGetLastError();
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// x (E, C, d), wi/wg (E, d, f), wo (E, f, d), work (E, C, f), out (E, C, d),
// all contiguous, of one dtype: 0 = f32, 1 = bf16.  act: 0 silu, 1 gelu
// (tanh form), 2 squared relu.  skipped: null, or an int the gate-up pass
// adds the number of (expert, C tile) pairs it skipped to.  Returns a
// cudaError_t as int.
int moe_ffn(const void* x, const void* wi, const void* wg, const void* wo,
            void* work, void* out, int E, int C, int d, int f, int dtype,
            int act, void* skipped, void* stream) {
  if (E == 0 || C == 0 || d == 0) return 0;
  if (E > 65535 || (C + kTileM - 1) / kTileM > 65535)
    return (int)cudaErrorInvalidValue;       // grid.z / grid.y limits
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* sk = static_cast<int*>(skipped);
  if (dtype == 0)
    return run_f32(x, wi, wg, wo, work, out, E, C, d, f, act, sk, st);
  const bool vec = d % 8 == 0 && f % 8 == 0 && aligned16(x) && aligned16(wi)
                   && aligned16(wg) && aligned16(wo) && aligned16(work);
  if (vec)
    return run_mma<true>(x, wi, wg, wo, work, out, E, C, d, f, act, sk, st);
  return run_mma<false>(x, wi, wg, wo, work, out, E, C, d, f, act, sk, st);
}

// The bf16 training forward.  x (E, C, d), wi and wg (E, d, f), wo (E,
// f, d), contiguous; xp, wip, wgp, wop: null where the operand's rows are
// a multiple of 8 values and it starts on 16 bytes (TMA reads it as it
// is), else a workspace of its shape with rows of dp or fp values (d and
// f rounded up to multiples of 8), 16-byte aligned, that receives it
// padded with zero columns.  aw, hw, gw (E, C, fp) receive A, h and g
// (their pad columns zeros); flags (E, ceil(C / 128)) int32 whether each
// 128-row C tile of x holds a token; out (E, C, d).  act as moe_ffn's;
// skipped: null, or an int the gate-up pass adds the number of (expert,
// 128-row tile) pairs it skipped to.  Launches the pads, a memset, the
// flags, gate-up and down.  Returns a cudaError_t as int.
int moe_ffn_train(const void* x, const void* wi, const void* wg,
                  const void* wo, void* xp, void* wip, void* wgp, void* wop,
                  void* aw, void* hw, void* gw, void* flags, void* out,
                  int E, int C, int d, int f, int act, void* skipped,
                  void* stream) {
  if (E == 0 || C == 0 || d == 0 || f == 0) return 0;
  const int mt = cdiv(C, kWgM), dp = cdiv(d, 8) * 8, fp = cdiv(f, 8) * 8;
  if (E > 65535 || mt > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = bind_device(x);
  if (err != cudaSuccess) return (int)err;
  // the operands as the kernels read them
  const void* ops[4] = {x, wi, wg, wo};
  void* pads[4] = {xp, wip, wgp, wop};
  const long long rows[4] = {(long long)E * C, (long long)E * d,
                             (long long)E * d, (long long)E * f};
  const int ws[4] = {d, f, f, d}, wps[4] = {dp, fp, fp, dp};
  for (int i = 0; i < 4; ++i) {
    if (pads[i] != nullptr) {
      err = pad_rows(ops[i], pads[i], rows[i], ws[i], wps[i], st);
      if (err != cudaSuccess) return (int)err;
      ops[i] = pads[i];
    }
    if (ws[i] != wps[i] && pads[i] == nullptr)
      return (int)cudaErrorInvalidValue;
    if (!aligned16(ops[i])) return (int)cudaErrorMisalignedAddress;
  }
  if (!aligned16(aw) || !aligned16(hw) || !aligned16(gw))
    return (int)cudaErrorMisalignedAddress;
  int* fl = static_cast<int*>(flags);
  err = cudaMemsetAsync(fl, 0, sizeof(int) * E * mt, st);
  if (err != cudaSuccess) return (int)err;
  moe_train_flags_kernel<<<dim3(cdiv(C, 8), E), 256, 0, st>>>(
      static_cast<const bf16*>(ops[0]), C, dp, mt, fl);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap mx, mwi, mwg, ma, mwo;
  if (!box_map(&mx, ops[0], E, C, dp) || !box_map(&mwi, ops[1], E, d, fp)
      || !box_map(&mwg, ops[2], E, d, fp) || !box_map(&ma, aw, E, C, fp)
      || !box_map(&mwo, ops[3], E, f, dp))
    return (int)cudaErrorInvalidValue;
  WgArgs g{};
  g.M = C, g.N = fp, g.K = d, g.segs = 1, g.flags = fl, g.mt = mt;
  g.o[0] = static_cast<bf16*>(aw), g.o[1] = static_cast<bf16*>(hw);
  g.o[2] = static_cast<bf16*>(gw);
  g.skipped = static_cast<int*>(skipped);
  err = wg_launch(act == kSilu   ? moe_train_gate_wgmma_kernel<kSilu>
                  : act == kGelu ? moe_train_gate_wgmma_kernel<kGelu>
                                 : moe_train_gate_wgmma_kernel<kRelu2>,
                  dim3(cdiv(fp, 128), mt, E), mx, mx, mwi, mwg, g, st);
  if (err != cudaSuccess) return (int)err;
  WgArgs dn{};
  dn.M = C, dn.N = d, dn.K = fp, dn.segs = 1, dn.flags = fl, dn.mt = mt;
  dn.o[0] = static_cast<bf16*>(out);
  return (int)wg_launch(moe_train_down_wgmma_kernel<0>,
                        dim3(cdiv(d, 256), mt, E), ma, ma, mwo, mwo, dn, st);
}

// The bf16 gradient of moe_ffn_train for dy (E, C, d): x, wi, wg, wo as
// moe_ffn_train read them (its workspaces where it padded them), aw, hw,
// gw and flags as it wrote them; dyp: null, or a workspace (E, C, dp)
// for dy padded as x was; dh, dg (E, C, fp) workspaces; dx (E, C, d),
// dwi and dwg (E, d, f), dwo (E, f, d).  skipped: null, or an int the
// dgate pass adds the number of (expert, 128-row tile) pairs it skipped
// to.  Launches a pad where dyp is given, then the four kernels.  Returns
// a cudaError_t as int.
int moe_ffn_bwd_train(const void* x, const void* wi, const void* wg,
                      const void* wo, const void* aw, const void* hw,
                      const void* gw, const void* flags, const void* dy,
                      void* dyp, void* dh, void* dg, void* dx, void* dwi,
                      void* dwg, void* dwo, int E, int C, int d, int f,
                      int act, void* skipped, void* stream) {
  if (E == 0 || C == 0 || d == 0 || f == 0) return 0;
  const int mt = cdiv(C, kWgM), dp = cdiv(d, 8) * 8, fp = cdiv(f, 8) * 8;
  if (E > 65535 || mt > 65535 || cdiv(d, kWgM) > 65535
      || cdiv(f, kWgM) > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = bind_device(dy);
  if (err != cudaSuccess) return (int)err;
  if (dyp != nullptr) {
    err = pad_rows(dy, dyp, (long long)E * C, d, dp, st);
    if (err != cudaSuccess) return (int)err;
    dy = dyp;
  } else if (d != dp) {
    return (int)cudaErrorInvalidValue;
  }
  if (!aligned16(dy) || !aligned16(dh) || !aligned16(dg))
    return (int)cudaErrorMisalignedAddress;
  CUtensorMap mx, mwi, mwg, mwo, ma, mdy, mdh, mdg;
  if (!box_map(&mx, x, E, C, dp) || !box_map(&mwi, wi, E, d, fp)
      || !box_map(&mwg, wg, E, d, fp) || !box_map(&mwo, wo, E, f, dp)
      || !box_map(&ma, aw, E, C, fp) || !box_map(&mdy, dy, E, C, dp)
      || !box_map(&mdh, dh, E, C, fp) || !box_map(&mdg, dg, E, C, fp))
    return (int)cudaErrorInvalidValue;
  const int* fl = static_cast<const int*>(flags);
  WgArgs a{};
  a.segs = 1, a.flags = fl, a.mt = mt;
  // P1: dA = dY wo^T (M C, N fp, K d); dH and dG from the saved h and g
  WgArgs p1 = a;
  p1.M = C, p1.N = fp, p1.K = d;
  p1.o[0] = static_cast<bf16*>(dh), p1.o[1] = static_cast<bf16*>(dg);
  p1.h = static_cast<const bf16*>(hw), p1.g = static_cast<const bf16*>(gw);
  p1.skipped = static_cast<int*>(skipped);
  err = wg_launch(act == kSilu   ? moe_bwd_dgate_wgmma_kernel<kSilu>
                  : act == kGelu ? moe_bwd_dgate_wgmma_kernel<kGelu>
                                 : moe_bwd_dgate_wgmma_kernel<kRelu2>,
                  dim3(cdiv(fp, 256), mt, E), mdy, mdy, mwo, mwo, p1, st);
  if (err != cudaSuccess) return (int)err;
  // P2: dX = dH wi^T + dG wg^T (M C, N d, K fp twice)
  WgArgs p2 = a;
  p2.M = C, p2.N = d, p2.K = fp, p2.segs = 2;
  p2.o[0] = static_cast<bf16*>(dx);
  err = wg_launch(moe_bwd_dx_wgmma_kernel<0>, dim3(cdiv(d, 256), mt, E),
                  mdh, mdg, mwi, mwg, p2, st);
  if (err != cudaSuccess) return (int)err;
  // P3: dWi = x^T dH, dWg = x^T dG (M d, N f, K C)
  WgArgs p3 = a;
  p3.M = d, p3.N = f, p3.K = C;
  p3.o[0] = static_cast<bf16*>(dwi), p3.o[1] = static_cast<bf16*>(dwg);
  err = wg_launch(moe_bwd_dw_wgmma_kernel<0>,
                  dim3(cdiv(f, 128), cdiv(d, 128), E), mx, mx, mdh, mdg, p3,
                  st);
  if (err != cudaSuccess) return (int)err;
  // P4: dWo = A^T dY (M f, N d, K C)
  WgArgs p4 = a;
  p4.M = f, p4.N = d, p4.K = C;
  p4.o[0] = static_cast<bf16*>(dwo);
  return (int)wg_launch(moe_bwd_dwo_wgmma_kernel<0>,
                        dim3(cdiv(d, 256), cdiv(f, 128), E), ma, ma, mdy, mdy,
                        p4, st);
}

// The f32 gradient of moe_ffn for dy (E, C, d): dx (E, C, d), dwi and dwg
// (E, d, f), dwo (E, f, d), all contiguous f32; workspaces aw, dh, dg (E,
// C, fp), fp = f rounded up to a multiple of 8, and flags (E, ceil(C /
// 64)) int32.  act as moe_ffn's; skipped: null, or an int the gate pass
// adds the number of (expert, 64-row tile) pairs it skipped to.  Returns a
// cudaError_t as int.
int moe_ffn_bwd(const void* x, const void* wi, const void* wg,
                const void* wo, const void* dy, void* dx, void* dwi,
                void* dwg, void* dwo, void* aw, void* dh, void* dg,
                void* flags, int E, int C, int d, int f, int fp, int act,
                void* skipped, void* stream) {
  if (E == 0 || C == 0 || d == 0 || f == 0) return 0;
  if (E > 65535 || (C + kBM - 1) / kBM > 65535 || (d + kBN - 1) / kBN > 65535
      || (f + kBN - 1) / kBN > 65535 || fp % 8 != 0 || fp < f)
    return (int)cudaErrorInvalidValue;
  auto in = [](const void* p) { return static_cast<const float*>(p); };
  auto out = [](void* p) { return static_cast<float*>(p); };
  return run_bwd_f32(in(x), in(wi), in(wg), in(wo), in(dy), out(dx),
                     out(dwi), out(dwg), out(dwo), out(aw), out(dh), out(dg),
                     static_cast<int*>(flags), E, C, d, f, fp, act,
                     static_cast<int*>(skipped),
                     static_cast<cudaStream_t>(stream));
}

const char* moe_ffn_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
