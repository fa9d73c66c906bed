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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
    const float inner = rnd<T>(c * rnd<T>(u + rnd<T>(0.044715f * u3)));
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

const char* moe_ffn_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
