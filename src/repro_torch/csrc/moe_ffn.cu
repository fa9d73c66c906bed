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
// The backward (moe_ffn_bwd, at the end) has no Pallas counterpart: the
// JAX package differentiates expert_ffn's einsums with XLA.  Its design
// is set out above its kernels.

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

// ---------------------------------------------------------------------------
// Backward: the gradient of out = (act(x wg) * (x wi)) wo for dY = dout
// ---------------------------------------------------------------------------
//
// With h = x wi, g = x wg, A = act(g) * h (each rounded as the forward
// rounds them):
//   dA = dY wo^T,  dH = dA * act(g),  dG = dA * h * act'(g)
//   dX = dH wi^T + dG wg^T,  dWi = x^T dH,  dWg = x^T dG,  dWo = A^T dY
// dA, dH and dX are rounded to the dtype once each; dG once from its f32
// product, act'(g) taken in f32 from the rounded g.  Three kinds of
// launch, none with atomics on a value, so a second call is bit-identical:
// - B1 (gate): per (f tile, C tile, expert), h and g over d, then dA over
//   d; writes A, dH and dG to (E, C, fp) workspaces (fp = f rounded up to
//   8, so their rows are 16-byte aligned and cp.async reads them whatever
//   f is; the pad columns hold zeros), and whether the C tile of x holds
//   a nonzero value to a flag.
// - B2 (dx): per (d tile, C tile, expert), dX over f; a flagged-zero tile
//   writes zeros.
// - B3 (dw): per (f tile, d tile, expert) dWi and dWg, per (d tile, f
//   tile, expert) dWo, each summed over the C rows up to the expert's last
//   nonzero tile in one order.  An expert without a token writes zeros and
//   reads nothing.
// A zero row of x gives h = g = A = dH = dG = 0, so tiles of zero rows
// (tokenless experts, the empty tail of each expert's buffer) add exact
// zeros and are skipped, as in the forward; B1 counts the skipped tiles.
// Tiles are 64 x 64 outputs (the C tile 64 rows: training fills C).
// bf16: mma.sync m16n8k16 with f32 accumulators, 8 warps of 32 x 16, the
// operands staged through a ring of kBStages 32-deep stages by cp.async
// where their rows allow it (else plain loads: wi and wg at an f that is
// no multiple of 8), each stored in the layout its ldmatrix wants.
// f32: FMA on the CUDA cores, 4 x 4 outputs a thread.

constexpr int kBM = 64;                   // output rows per block
constexpr int kBN = 64;                   // output columns per block
constexpr int kBK = 32;                   // depth of one stage
constexpr int kBStages = 4;
constexpr int kKStr = kBK + 8;            // a [mn][k] tile's row (bf16)
constexpr int kMnStr = kBM + 8;           // a [k][mn] tile's row (bf16)
constexpr int kOpElems = kBM * kKStr;     // >= kBK * kMnStr
constexpr int kFK = 16;                   // f32: depth of one stage
constexpr int kFStr = kBM + 1;            // f32: a [k][mn] tile's row

// Stage the (R, W) box at (r0, c0) of a row-major matrix (leading dim ld,
// valid rows < nr and columns < nc, zero elsewhere) into dst (row stride
// sstr).  VEC: 16-byte cp.async copies; a copy whose first column is valid
// reads 8 values, so nc % 8 == 0 or the row is padded with zeros.
template <int R, int W, bool VEC>
__device__ __forceinline__ void stage_box(bf16* dst, int sstr, const bf16* src,
                                          int ld, int r0, int nr, int c0,
                                          int nc) {
  if (VEC) {
#pragma unroll
    for (int i = threadIdx.x; i < R * W / 8; i += kThreads) {
      const int r = i / (W / 8), c = i % (W / 8) * 8;
      const bool ok = r0 + r < nr && c0 + c < nc;
      cp_async16(dst + r * sstr + c,
                 ok ? src + (size_t)(r0 + r) * ld + c0 + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < R * W; i += kThreads) {
      const int r = i / W, c = i - r * W;
      const bool ok = r0 + r < nr && c0 + c < nc;
      dst[r * sstr + c] = ok ? src[(size_t)(r0 + r) * ld + c0 + c]
                             : from_f<bf16>(0.f);
    }
  }
}

// One operand's stage: the (64 of mn) x (kBK of k) slice at (mn0, k0) of a
// matrix stored [k][mn] (KROW) or [mn][k], kept in shared memory in the
// same orientation.
template <bool KROW, bool VEC>
__device__ __forceinline__ void stage_operand(bf16* dst, const bf16* src,
                                              int ld, int mn0, int mn, int k0,
                                              int k) {
  if (KROW)
    stage_box<kBK, kBM, VEC>(dst, kMnStr, src, ld, k0, k, mn0, mn);
  else
    stage_box<kBM, kBK, VEC>(dst, kKStr, src, ld, mn0, mn, k0, k);
}

// acc[b] (the block's 64 x 64 tile at (m0, n0), 16 values a thread) +=
// A . B_b over depth k, for A (m rows) stored [k][m] (AK) or [m][k] and
// B_b (n columns) stored [k][n] (BK) or [n][k].  Value j of a thread is
// mma tile (j / 8, (j / 4) % 2) of its warp, fragment entry j % 4.
template <int NB, bool AK, bool BK, bool VA, bool VB>
__device__ __forceinline__ void mma_gemm(float (&acc)[NB][16], bf16* smem,
                                         const bf16* a, int lda, int m,
                                         const bf16* b0, const bf16* b1,
                                         int ldb, int n, int m0, int n0,
                                         int k) {
  constexpr int kStage = (1 + NB) * kOpElems;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 16;
  const int nk = (k + kBK - 1) / kBK;
  __syncthreads();             // an earlier product may still read the ring
  auto load = [&](int s, int kt) {
    bf16* st = smem + s * kStage;
    stage_operand<AK, VA>(st, a, lda, m0, m, kt * kBK, k);
    stage_operand<BK, VB>(st + kOpElems, b0, ldb, n0, n, kt * kBK, k);
    if (NB == 2)
      stage_operand<BK, VB>(st + 2 * kOpElems, b1, ldb, n0, n, kt * kBK, k);
  };
#pragma unroll
  for (int s = 0; s < kBStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  // ldmatrix lane addresses (elements) of the warp's fragments at k16 step
  // 0: A [m][k] (x4: rows lane & 15, k half lane >> 4) or [k][m] (x4.trans:
  // k rows (lane & 7) + 8 (lane >> 4), m half (lane >> 3) & 1); B [k][n]
  // (x4.trans: k rows (lane & 7) + 8 ((lane >> 3) & 1), n half lane >> 4)
  // or [n][k] (x4: n rows (lane & 7) + 8 (lane >> 4), k half (lane >> 3) & 1)
  const int a_off = AK ? ((lane & 7) + ((lane >> 4) << 3)) * kMnStr + wm
                             + ((lane >> 3) & 1) * 8
                       : (wm + (lane & 15)) * kKStr + (lane >> 4) * 8;
  const int a_mt = AK ? 16 : 16 * kKStr;          // next m16 tile
  const int a_kk = AK ? 16 * kMnStr : 16;         // next k16 step
  const int b_off = BK ? ((lane & 7) + (((lane >> 3) & 1) << 3)) * kMnStr
                             + wn + (lane >> 4) * 8
                       : (wn + (lane & 7) + ((lane >> 4) << 3)) * kKStr
                             + ((lane >> 3) & 1) * 8;
  const int b_kk = BK ? 16 * kMnStr : 16;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kBStages - 2>();
    __syncthreads();
    if (kt + kBStages - 1 < nk) load((kt + kBStages - 1) % kBStages,
                                     kt + kBStages - 1);
    cp_async_commit();
    const bf16* st = smem + (kt % kBStages) * kStage;
    const uint32_t sa = smem_u32(st + a_off);
    const uint32_t sb = smem_u32(st + kOpElems + b_off);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const uint32_t at = sa + 2 * (mt * a_mt + kk * a_kk);
        if (AK) ldmatrix_x4_trans(af[mt], at);
        else ldmatrix_x4(af[mt], at);
      }
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        uint32_t bfr[4];
        const uint32_t bt = sb + 2 * (b * kOpElems + kk * b_kk);
        if (BK) ldmatrix_x4_trans(bfr, bt);
        else ldmatrix_x4(bfr, bt);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(*reinterpret_cast<float(*)[4]>(&acc[b][mt * 8]), af[mt],
                   bfr[0], bfr[1]);
          mma_bf16(*reinterpret_cast<float(*)[4]>(&acc[b][mt * 8 + 4]),
                   af[mt], bfr[2], bfr[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
}

// f32: one operand's kFK x 64 slice into dst[k][mn] (row stride kFStr).
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

// mma_gemm's contract on the CUDA cores: value j of a thread is row
// ty + 16 (j / 4), column tx + 16 (j % 4) of the tile.
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

template <typename T, int NB, bool AK, bool BK, bool VA, bool VB>
__device__ __forceinline__ void tile_gemm(float (&acc)[NB][16], void* smem,
                                          const T* a, int lda, int m,
                                          const T* b0, const T* b1, int ldb,
                                          int n, int m0, int n0, int k) {
  if constexpr (sizeof(T) == 4)
    fma_gemm<NB, AK, BK>(acc, static_cast<float*>(smem), a, lda, m, b0, b1,
                         ldb, n, m0, n0, k);
  else
    mma_gemm<NB, AK, BK, VA, VB>(acc, static_cast<bf16*>(smem), a, lda, m,
                                 b0, b1, ldb, n, m0, n0, k);
}

// (row, column) in the block's tile of a thread's value j
template <typename T>
__device__ __forceinline__ void tile_rc(int j, int& r, int& c) {
  if constexpr (sizeof(T) == 4) {
    r = (threadIdx.x >> 4) + 16 * (j >> 2);
    c = (threadIdx.x & 15) + 16 * (j & 3);
  } else {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    r = (warp >> 2) * 32 + 16 * (j >> 3) + (lane >> 2) + 8 * ((j >> 1) & 1);
    c = (warp & 3) * 16 + 8 * ((j >> 2) & 1) + 2 * (lane & 3) + (j & 1);
  }
}

template <typename T>
constexpr size_t bwd_smem(int nb) {
  return sizeof(T) == 4 ? (size_t)(1 + nb) * kFK * kFStr * 4
                        : (size_t)kBStages * (1 + nb) * kOpElems * 2;
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
template <typename T, bool VX, bool VF>
__global__ void __launch_bounds__(kThreads)
moe_bwd_gate_kernel(const T* __restrict__ x, const T* __restrict__ wi,
                    const T* __restrict__ wg, const T* __restrict__ wo,
                    const T* __restrict__ dy, T* __restrict__ aw,
                    T* __restrict__ dh, T* __restrict__ dg,
                    int* __restrict__ flags, int C, int d, int f, int fp,
                    int act, int* __restrict__ skipped) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int e = blockIdx.z, c0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int rows = min(kBM, C - c0);
  const size_t xo = (size_t)e * C * d, wof = (size_t)e * d * f,
               po = (size_t)e * C * fp;
  const bool nz = tile_has_nonzero<T, VX>(x + xo, c0, rows, d);
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
  tile_gemm<T, 2, false, true, VX, VF>(hg, smem_raw, x + xo, d, C, wi + wof,
                                       wg + wof, f, f, c0, n0, d);
  tile_gemm<T, 1, false, false, VX, VX>(da, smem_raw, dy + xo, d, C,
                                        wo + wof, nullptr, d, f, c0, n0, d);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    int r, c;
    tile_rc<T>(j, r, c);
    const int n = n0 + c;
    if (r < rows && n < fp) {    // columns f..fp-1 come out exact zeros
      const float h = rnd<T>(hg[0][j]), g = rnd<T>(hg[1][j]);
      const float a = rnd<T>(da[0][j]);
      const float ag = activation<T>(g, act);
      const size_t at = po + (size_t)(c0 + r) * fp + n;
      aw[at] = from_f<T>(ag * h);
      dh[at] = from_f<T>(a * ag);
      dg[at] = from_f<T>(a * h * activation_grad(g, act));
    }
  }
}

// B2: dX (E, C, d) = dH wi^T + dG wg^T
template <typename T, bool VF>
__global__ void __launch_bounds__(kThreads)
moe_bwd_dx_kernel(const T* __restrict__ dh, const T* __restrict__ dg,
                  const T* __restrict__ wi, const T* __restrict__ wg,
                  const int* __restrict__ flags, T* __restrict__ dx, int C,
                  int d, int f, int fp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int e = blockIdx.z, c0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int rows = min(kBM, C - c0);
  T* dxe = dx + (size_t)e * C * d;
  if (!flags[e * gridDim.y + blockIdx.y]) {
    zero_tile(dxe, c0, rows, n0, min(kBN, d - n0), d);
    return;
  }
  const size_t wof = (size_t)e * d * f, po = (size_t)e * C * fp;
  float acc[1][16] = {};
  tile_gemm<T, 1, false, false, true, VF>(acc, smem_raw, dh + po, fp, C,
                                          wi + wof, nullptr, f, d, c0, n0, f);
  tile_gemm<T, 1, false, false, true, VF>(acc, smem_raw, dg + po, fp, C,
                                          wg + wof, nullptr, f, d, c0, n0, f);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    int r, c;
    tile_rc<T>(j, r, c);
    if (r < rows && n0 + c < d)
      dxe[(size_t)(c0 + r) * d + n0 + c] = from_f<T>(acc[0][j]);
  }
}

// B3: dWi, dWg (E, d, f) = x^T dH, x^T dG, or (DWO) dWo (E, f, d) = A^T dY,
// over the C rows up to the expert's last flagged tile
template <typename T, bool VX, bool DWO>
__global__ void __launch_bounds__(kThreads)
moe_bwd_dw_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                  const T* __restrict__ aw, const T* __restrict__ dh,
                  const T* __restrict__ dg, const int* __restrict__ flags,
                  T* __restrict__ dwi, T* __restrict__ dwg,
                  T* __restrict__ dwo, int C, int d, int f, int fp, int mt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
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
    tile_gemm<T, 1, true, true, true, VX>(acc, smem_raw, aw + po, fp, f,
                                          dy + xo, nullptr, d, d, m0, n0,
                                          depth);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      int r, c;
      tile_rc<T>(j, r, c);
      if (r < rows && c < cols)
        dwo[wof + (size_t)(m0 + r) * d + n0 + c] = from_f<T>(acc[0][j]);
    }
  } else {
    float acc[2][16] = {};
    tile_gemm<T, 2, true, true, VX, true>(acc, smem_raw, x + xo, d, d,
                                          dh + po, dg + po, fp, f, m0, n0,
                                          depth);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      int r, c;
      tile_rc<T>(j, r, c);
      if (r < rows && c < cols) {
        const size_t at = wof + (size_t)(m0 + r) * f + n0 + c;
        dwi[at] = from_f<T>(acc[0][j]);
        dwg[at] = from_f<T>(acc[1][j]);
      }
    }
  }
}

template <typename T, bool VX, bool VF>
int run_bwd(const T* x, const T* wi, const T* wg, const T* wo, const T* dy,
            T* dx, T* dwi, T* dwg, T* dwo, T* aw, T* dh, T* dg, int* flags,
            int E, int C, int d, int f, int fp, int act, int* skipped,
            cudaStream_t st) {
  static bool ready = false;     // the shared-memory limits are set once
  const size_t s1 = bwd_smem<T>(1), s2 = bwd_smem<T>(2);
  if (!ready) {
    cudaError_t err = allow_smem(moe_bwd_gate_kernel<T, VX, VF>, s2);
    if (err == cudaSuccess) err = allow_smem(moe_bwd_dx_kernel<T, VF>, s1);
    if (err == cudaSuccess)
      err = allow_smem(moe_bwd_dw_kernel<T, VX, false>, s2);
    if (err == cudaSuccess)
      err = allow_smem(moe_bwd_dw_kernel<T, VX, true>, s1);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  const int mt = (C + kBM - 1) / kBM;
  const int dt = (d + kBN - 1) / kBN, ft = (f + kBN - 1) / kBN;
  const int fpt = (fp + kBN - 1) / kBN;
  moe_bwd_gate_kernel<T, VX, VF><<<dim3(fpt, mt, E), kThreads, s2, st>>>(
      x, wi, wg, wo, dy, aw, dh, dg, flags, C, d, f, fp, act, skipped);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  moe_bwd_dx_kernel<T, VF><<<dim3(dt, mt, E), kThreads, s1, st>>>(
      dh, dg, wi, wg, flags, dx, C, d, f, fp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  moe_bwd_dw_kernel<T, VX, false><<<dim3(ft, dt, E), kThreads, s2, st>>>(
      x, dy, aw, dh, dg, flags, dwi, dwg, dwo, C, d, f, fp, mt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  moe_bwd_dw_kernel<T, VX, true><<<dim3(dt, ft, E), kThreads, s1, st>>>(
      x, dy, aw, dh, dg, flags, dwi, dwg, dwo, C, d, f, fp, mt);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_bwd(const void* x, const void* wi, const void* wg,
                 const void* wo, const void* dy, void* dx, void* dwi,
                 void* dwg, void* dwo, void* aw, void* dh, void* dg,
                 int* flags, int E, int C, int d, int f, int fp, int act,
                 int* skipped, cudaStream_t st, bool vx, bool vf) {
#define MOE_BWD_ARGS                                                       \
  static_cast<const T*>(x), static_cast<const T*>(wi),                     \
      static_cast<const T*>(wg), static_cast<const T*>(wo),                \
      static_cast<const T*>(dy), static_cast<T*>(dx), static_cast<T*>(dwi), \
      static_cast<T*>(dwg), static_cast<T*>(dwo), static_cast<T*>(aw),     \
      static_cast<T*>(dh), static_cast<T*>(dg), flags, E, C, d, f, fp, act, \
      skipped, st
  if constexpr (sizeof(T) == 4) {
    return run_bwd<T, false, false>(MOE_BWD_ARGS);
  } else {
    if (vx && vf) return run_bwd<T, true, true>(MOE_BWD_ARGS);
    if (vx) return run_bwd<T, true, false>(MOE_BWD_ARGS);
    if (vf) return run_bwd<T, false, true>(MOE_BWD_ARGS);
    return run_bwd<T, false, false>(MOE_BWD_ARGS);
  }
#undef MOE_BWD_ARGS
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

// The gradient of moe_ffn for dy (E, C, d): dx (E, C, d), dwi and dwg
// (E, d, f), dwo (E, f, d), all contiguous, of x's dtype; workspaces aw,
// dh, dg (E, C, fp) of that dtype, fp = f rounded up to a multiple of 8,
// 16-byte aligned, and flags (E, ceil(C / 64)) int32.  dtype and act as
// moe_ffn's; skipped: null, or an int the gate pass adds the number of
// (expert, 64-row tile) pairs it skipped to.  Returns a cudaError_t as
// int.
int moe_ffn_bwd(const void* x, const void* wi, const void* wg,
                const void* wo, const void* dy, void* dx, void* dwi,
                void* dwg, void* dwo, void* aw, void* dh, void* dg,
                void* flags, int E, int C, int d, int f, int fp, int dtype,
                int act, void* skipped, void* stream) {
  if (E == 0 || C == 0 || d == 0 || f == 0) return 0;
  if (E > 65535 || (C + kBM - 1) / kBM > 65535 || (d + kBN - 1) / kBN > 65535
      || (f + kBN - 1) / kBN > 65535 || fp % 8 != 0 || fp < f)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(aw) || !aligned16(dh) || !aligned16(dg))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* fl = static_cast<int*>(flags);
  int* sk = static_cast<int*>(skipped);
  const bool vx = d % 8 == 0 && aligned16(x) && aligned16(dy)
                  && aligned16(wo);
  const bool vf = f % 8 == 0 && aligned16(wi) && aligned16(wg);
  if (dtype == 0)
    return dispatch_bwd<float>(x, wi, wg, wo, dy, dx, dwi, dwg, dwo, aw, dh,
                               dg, fl, E, C, d, f, fp, act, sk, st, vx, vf);
  return dispatch_bwd<bf16>(x, wi, wg, wo, dy, dx, dwi, dwg, dwo, aw, dh, dg,
                            fl, E, C, d, f, fp, act, sk, st, vx, vf);
}

const char* moe_ffn_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
