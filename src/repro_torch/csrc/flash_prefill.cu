// Prefill attention with an online softmax over K/V tiles (flash attention).
//
// Replaces: repro/kernels/flash_attention/kernel.py::flash_attention (the
// Pallas kernel) and computes what the port's plain version,
// repro_torch/kernels/flash_attention/ops.py::prefill_attention_plain
// (layers.chunked_attention), computes at the model's one prefill call
// site: causal GQA attention of q (b, sq, nq, hd) over k, v (b, sk, nkv, hd)
// in the model layout, masked from int32 positions (causal, optional
// sliding window, optional chunked-local) with an optional logit softcap.
// The Pallas kernel derives positions from row indices; this one takes
// them as input, so the caller never checks positions == arange.
//
// Rounding follows the plain version: q * scale rounded to q's type;
// scores, running max and sum in f32; probabilities rounded to v's type
// before the PV product; an f32 accumulator; out = acc / max(l, 1e-30)
// rounded once.  A key the mask rejects adds nothing (p = 0).
//
// What bounds it on an H100: operations.  At long prompts the unmasked
// (q, k) pairs cost 4 * hd flops each (QK^T and PV) against each q, k, v
// and o element moved once: at 6,000 tokens, hd 120, that is thousands of
// flops per byte, far above the ~295 at which bf16 tensor cores stop being
// memory-bound.  So bf16 runs on the tensor cores, and its floor is the
// unmasked pairs' flops over the bf16 tensor-core rate.
//
// Shared by both kernels:
// - One 128-thread block per (q tile, kv head, batch row).  The GQA group
//   is folded into the tile's 64 rows: row r is query head kh * gq + r % gq
//   at position t0 + r / gq (gq 1..64), so one K/V tile in shared memory
//   serves every query head of its kv head, read by index from the model
//   layout (no repeated K/V in memory).
// - A loop over K/V tiles of 64 keys replaces the Pallas grid's sequential
//   kv axis.  Every warp reduces a tile's key positions to (min, max) and
//   compares them with the q tile's: a tile whose every pair is masked is
//   skipped (keys all after the tile's last query, all behind the window of
//   its first, or in other attention chunks), which skips the causal upper
//   triangle and everything behind the window, exactly for any positions.
// - q tiles are scheduled longest first (reverse order), which evens out
//   the causal triangle's uneven work across the waves.
//
// bf16 (flash_prefill_mma_kernel, hd % 8 == 0, hd <= 128): tensor cores.
// - Each of the 4 warps owns 16 folded rows.  S = Q K^T and O += P V are
//   mma.sync m16n8k16 bf16 products with f32 accumulators in registers.
//   Q (scaled and rounded once) is read into A fragments with ldmatrix
//   before the loop and stays in registers; K is read with ldmatrix, V
//   with ldmatrix.trans; P goes from the S accumulators straight into the
//   A fragments of the PV product, rounded to bf16, never through shared
//   memory.  Row max and sum are reduced over the 4 lanes that share a row.
// - K and V tiles arrive by 16-byte cp.async.cg into a two-stage ring: tile
//   j+1 is in flight while tile j is computed, with one barrier per tile.
//   Rows are padded by 16 bytes, so the 8 rows an ldmatrix phase reads fall
//   in distinct banks.  Q shares the ring's second K stage until the loop
//   starts, which keeps a block at 4 stages of 64 x (hd16 + 8) bf16 (68 KiB
//   at hd 120/128), three blocks to an SM.  Keys past sk are zero-filled.
// - The QK^T product runs over hd rounded up to 16 (hd16); columns hd..hd16
//   of Q and of both K stages are zeroed once and never written by
//   cp.async (zeroing one side would let garbage times 0 poison S).  The PV
//   product runs in n8 steps over hd itself (120 = 15 x 8).
// - A tile that the (min, max) test shows wholly allowed skips the
//   per-element mask; only diagonal and window- or chunk-edge tiles, and
//   the ragged last tile, evaluate it.
// - What still bounds it: mma.sync, not wgmma, and the exponentials on the
//   special-function units beside the products.  wgmma, TMA and warp
//   specialisation are the next step.
//
// f32 (flash_prefill_kernel): FMA on CUDA cores, any hd <= 128.  Its inputs
// are held to 1e-4, which TF32 tensor cores (10 mantissa bits) would break,
// and the f32 runs are the ones compared with JAX's tokens.
// - Each thread owns 8 rows x 4 key columns of the score tile and 8 rows x
//   8 columns (stride 16) of the accumulator.  Q is kept transposed in
//   shared memory (rows contiguous, read as float4), K transposed with a
//   padded stride (conflict-free stores and loads), V row-major, and the
//   probabilities transposed in K's space once the scores are in
//   registers.  Rows of a score tile live in 16 neighbouring lanes, so the
//   row max and row sum are warp shuffles.  Ragged sq, sk and hd are
//   masked at the edges.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 64;          // folded q rows per block
constexpr int kKeys = 64;          // keys per K/V tile
constexpr int kQStride = kRows + 4;    // QsT[d][r], float4-aligned rows
constexpr int kKStride = kKeys + 1;    // KsT[d][c], conflict-free
constexpr int kPStride = kRows + 4;    // PsT[c][r], float4-aligned rows
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x rounded to T's precision, as a float
__device__ __forceinline__ float round_as(float x, float) { return x; }
__device__ __forceinline__ float round_as(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (q * b > a) ? q - 1 : q;
}

__device__ __forceinline__ bool allowed(int kp, int qp, int window,
                                        int chunk) {
  bool ok = kp <= qp;
  if (window > 0) ok = ok && kp > qp - window;
  if (chunk > 0) ok = ok && floor_div(kp, chunk) == floor_div(qp, chunk);
  return ok;
}

// What the mask does to K/V tile [c0, c0 + kKeys) against a q tile whose
// valid positions span [qmin, qmax]: 0 every pair masked, 1 some, 2 none.
// Every warp computes the same answer (lane loads and full-warp shuffles).
__device__ __forceinline__ int tile_class(const int* __restrict__ kpos,
                                          int c0, int sk, int qmin, int qmax,
                                          int window, int chunk, int lane) {
  int kmin = INT32_MAX, kmax = INT32_MIN;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = c0 + lane + 32 * h;
    if (c < sk) {
      const int p = __ldg(kpos + c);
      kmin = min(kmin, p);
      kmax = max(kmax, p);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    kmin = min(kmin, __shfl_xor_sync(0xffffffffu, kmin, o));
    kmax = max(kmax, __shfl_xor_sync(0xffffffffu, kmax, o));
  }
  bool skip = qmin > qmax || kmin > qmax;
  if (window > 0) skip = skip || (long long)kmax <= (long long)qmin - window;
  if (chunk > 0)
    skip = skip || floor_div(kmax, chunk) < floor_div(qmin, chunk)
           || floor_div(kmin, chunk) > floor_div(qmax, chunk);
  if (skip) return 0;
  bool all = c0 + kKeys <= sk && kmax <= qmin;
  if (window > 0) all = all && (long long)kmin > (long long)qmax - window;
  if (chunk > 0)
    all = all && floor_div(kmin, chunk) == floor_div(qmax, chunk)
          && floor_div(kmax, chunk) == floor_div(qmin, chunk);
  return all ? 2 : 1;
}

// NJ: accumulator columns per thread (16 * NJ >= hd), 4 or 8
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ q_pos,
                     const int* __restrict__ k_pos, T* __restrict__ out,
                     float* __restrict__ lse, int sq, int sk, int nq,
                     int nkv, int hd, float scale, int window, int chunk,
                     float softcap) {
  const int gq = nq / nkv;
  const int bq = kRows / gq;                 // positions per q tile
  const int rows = bq * gq;                  // rows in use (<= kRows)
  const int t0 = (gridDim.x - 1 - blockIdx.x) * bq;
  const int kh = blockIdx.y;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tx = lane & 15;                  // key / hd column group
  const int ty = (tid >> 5) * 2 + (lane >> 4);   // row group: rows ty*8+i
  const int hdp = 16 * NJ;                   // V's row stride

  extern __shared__ float smem[];
  float* qs = smem;                          // (hd, kQStride)
  float* ks = qs + hd * kQStride;            // (hd, kKStride); later P
  const int k_space = max(hd * kKStride, kKeys * kPStride);
  float* ps = ks;                            // (kKeys, kPStride)
  float* vs = ks + k_space;                  // (kKeys, hdp)

  const size_t q_row = (size_t)nq * hd;      // one position of q / out
  const size_t kv_row = (size_t)nkv * hd;    // one position of k / v

  for (int i = tid; i < kRows * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    const int t = r / gq, g = r - t * gq;
    float x = 0.f;
    if (r < rows && t0 + t < sq) {
      const T* src = q + ((size_t)bi * sq + t0 + t) * q_row
                     + (size_t)(kh * gq + g) * hd + d;
      x = round_as(to_f32(*src) * scale, T());
    }
    qs[d * kQStride + r] = x;
  }

  int qp[8];
  bool qok[8];
  int qmin = INT32_MAX, qmax = INT32_MIN;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty * 8 + i;
    const int t = r / gq;
    qok[i] = r < rows && t0 + t < sq;
    qp[i] = qok[i] ? q_pos[(size_t)bi * sq + t0 + t] : 0;
  }
  // the tile's position range, for skipping K/V tiles: one warp's view of
  // every position of the tile
  for (int t = lane; t < bq; t += 32) {
    if (t0 + t < sq) {
      const int p = q_pos[(size_t)bi * sq + t0 + t];
      qmin = min(qmin, p);
      qmax = max(qmax, p);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    qmin = min(qmin, __shfl_xor_sync(0xffffffffu, qmin, o));
    qmax = max(qmax, __shfl_xor_sync(0xffffffffu, qmax, o));
  }

  // V's columns past hd are read by the PV loop and never written
  for (int i = tid; i < kKeys * (hdp - hd); i += kThreads) {
    const int c = i / (hdp - hd), d = hd + i % (hdp - hd);
    vs[c * hdp + d] = 0.f;
  }

  float m[8], l[8], acc[8][NJ];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }
  __syncthreads();

  const int n_tiles = (sk + kKeys - 1) / kKeys;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int c0 = kt * kKeys;
    // skip test, the same in every warp (no shared memory, no barrier)
    if (tile_class(k_pos + (size_t)bi * sk, c0, sk, qmin, qmax, window,
                   chunk, lane) == 0)
      continue;

    for (int i = tid; i < kKeys * hd; i += kThreads) {
      const int c = i / hd, d = i - c * hd;
      float kx = 0.f, vx = 0.f;
      if (c0 + c < sk) {
        const size_t off = ((size_t)bi * sk + c0 + c) * kv_row
                           + (size_t)kh * hd + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      ks[d * kKStride + c] = kx;
      vs[c * hdp + d] = vx;
    }
    __syncthreads();

    // scores: rows ty*8 + i, keys tx + 16 * j
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(
          qs + d * kQStride + ty * 8);
      const float4 qb = *reinterpret_cast<const float4*>(
          qs + d * kQStride + ty * 8 + 4);
      const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
      float kk[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = ks[d * kKStride + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kk[j], s[i][j]);
    }

    int kp[4];
    bool kok[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      kok[j] = c < sk;
      kp[j] = kok[j] ? k_pos[(size_t)bi * sk + c] : 0;
    }
    float corr[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = qok[i] && kok[j] && allowed(kp[j], qp[i], window,
                                                     chunk);
        float x = s[i][j];
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        s[i][j] = ok ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] > 0.5f * kNegInf ? expf(s[i][j] - mx) : 0.f;
        sum += p;
        s[i][j] = round_as(p, T());       // p in v's type for PV
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      corr[i] = expf(m[i] - mx);
      l[i] = l[i] * corr[i] + sum;
      m[i] = mx;
    }
    __syncthreads();   // every warp is done reading K: P takes its space
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* dst = ps + (tx + 16 * j) * kPStride + ty * 8;
      *reinterpret_cast<float4*>(dst) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(s[4][j], s[5][j], s[6][j], s[7][j]);
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr[i];
#pragma unroll 4
    for (int c = 0; c < kKeys; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(
          ps + c * kPStride + ty * 8);
      const float4 pb = *reinterpret_cast<const float4*>(
          ps + c * kPStride + ty * 8 + 4);
      const float pv[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
      float vv[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = vs[c * hdp + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
    __syncthreads();   // K, P and V are rewritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (!qok[i]) continue;
    const int r = ty * 8 + i;
    const int t = r / gq, g = r - t * gq;
    T* dst = out + ((size_t)bi * sq + t0 + t) * q_row
             + (size_t)(kh * gq + g) * hd;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) store(dst + d, acc[i][j] / den);
    }
    if (lse != nullptr && tx == 0)
      lse[((size_t)bi * nq + kh * gq + g) * sq + t0 + t] = m[i] + logf(den);
  }
}

template <typename T, int NJ>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* q_pos, const int* k_pos, void* out,
                   float* lse, int b,
                   int sq, int sk, int nq, int nkv, int hd, float scale,
                   int window, int chunk, float softcap,
                   cudaStream_t stream) {
  const int gq = nq / nkv;
  const int bq = kRows / gq;
  const int k_space = max(hd * kKStride, kKeys * kPStride);
  const size_t smem =
      (size_t)(hd * kQStride + k_space + kKeys * 16 * NJ) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_prefill_kernel<T, NJ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((sq + bq - 1) / bq, nkv, b);
  flash_prefill_kernel<T, NJ><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_pos, k_pos, static_cast<T*>(out), lse, sq,
      sk, nq, nkv, hd, scale, window, chunk, softcap);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on tensor cores
// ---------------------------------------------------------------------------

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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

// two floats rounded to bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// KS: k16 steps of the QK^T product, hd rounded up to 16 over 16 (2..8;
// hd <= 16 takes 2).  At most 168 registers, so three blocks share an SM.
template <int KS>
__global__ void __launch_bounds__(kThreads, 3)
flash_prefill_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const int* __restrict__ q_pos,
                         const int* __restrict__ k_pos,
                         __nv_bfloat16* __restrict__ out,
                         float* __restrict__ lse, int sq, int sk, int nq,
                         int nkv, int hd, float scale, int window, int chunk,
                         float softcap) {
  constexpr int HDP = 16 * KS;       // hd rounded up to 16
  constexpr int STR = HDP + 8;       // row stride (elements) in shared
  constexpr int TILE = kKeys * STR;  // elements of one stage of K or V
  constexpr int CH = HDP / 8;        // 16-byte chunks of a row
  const int gq = nq / nkv;
  const int bq = kRows / gq;                 // positions per q tile
  const int rows = bq * gq;                  // rows in use (<= kRows)
  const int t0 = (gridDim.x - 1 - blockIdx.x) * bq;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;                   // row in the mma fragment
  const int tig = lane & 3;                  // column pair in the fragment
  // K/V rows of this (batch row, kv head), and their positions; kept as
  // offsets from the kernel's arguments, which cost no registers
#define KV_ROW(c) \
  ((((size_t)blockIdx.z * sk + (c)) * nkv + blockIdx.y) * (size_t)hd)
#define KPOS (k_pos + (size_t)blockIdx.z * sk)
#define QPOS (q_pos + (size_t)blockIdx.z * sq)

  // ks[0], ks[1] (Q until the loop starts), vs[0], vs[1]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* qs = ks + TILE;
  __nv_bfloat16* vs = ks + 2 * TILE;

  // columns hd..HDP of every K and V stage: never written by cp.async
  const int pad = CH - hd / 8;               // 16-byte chunks past hd
  for (int i = tid; i < 4 * kKeys * pad; i += kThreads) {
    const int r = i / pad;                   // stage * kKeys + key
    *reinterpret_cast<uint4*>(ks + (r / kKeys) * TILE + (r % kKeys) * STR
                              + hd + 8 * (i % pad)) = make_uint4(0, 0, 0, 0);
  }

  // the q tile's position range, for classifying K/V tiles: one warp's
  // view of every position of the tile
  int qmin = INT32_MAX, qmax = INT32_MIN;
  for (int t = lane; t < bq; t += 32) {
    if (t0 + t < sq) {
      const int p = QPOS[t0 + t];
      qmin = min(qmin, p);
      qmax = max(qmax, p);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    qmin = min(qmin, __shfl_xor_sync(0xffffffffu, qmin, o));
    qmax = max(qmax, __shfl_xor_sync(0xffffffffu, qmax, o));
  }

  auto load_tile = [&](int kt, int stage) {
    const int c0 = kt * kKeys;
    __nv_bfloat16* kd = ks + stage * TILE;
    __nv_bfloat16* vd = vs + stage * TILE;
#pragma unroll 2
    for (int i = tid; i < kKeys * CH; i += kThreads) {
      const int c = i / CH, d = (i % CH) * 8;
      if (d < hd) {
        const bool ok = c0 + c < sk;
        const size_t off = ok ? KV_ROW(c0 + c) + d : 0;
        cp_async16(kd + c * STR + d, k + off, ok);
        cp_async16(vd + c * STR + d, v + off, ok);
      }
    }
  };

  const int n_tiles = (sk + kKeys - 1) / kKeys;
  int cur = 0, cls = 0;
  while (cur < n_tiles
         && (cls = tile_class(KPOS, cur * kKeys, sk, qmin, qmax, window,
                              chunk, lane)) == 0)
    ++cur;
  if (cur < n_tiles) load_tile(cur, 0);
  cp_async_commit();

  // Q * scale, rounded to bf16, into ks[1]'s space while tile 0 lands
  for (int i = tid; i < kRows * CH; i += kThreads) {
    const int r = i / CH, d = (i % CH) * 8;
    const int t = r / gq, hh = r - t * gq;
    uint4 w = make_uint4(0, 0, 0, 0);
    if (r < rows && t0 + t < sq && d < hd) {
      const uint4 x = *reinterpret_cast<const uint4*>(
          q + (((size_t)blockIdx.z * sq + t0 + t) * nq + blockIdx.y * gq + hh)
                  * hd + d);
      const __nv_bfloat162* xh = reinterpret_cast<const __nv_bfloat162*>(&x);
      uint32_t* wp = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(xh[e]);
        wp[e] = pack_bf16(f.x * scale, f.y * scale);
      }
    }
    *reinterpret_cast<uint4*>(qs + r * STR + d) = w;
  }
  __syncthreads();

  uint32_t qf[KS][4];
  {
    const uint32_t a = smem_u32(qs + (warp * 16 + (lane & 15)) * STR
                                + (lane >> 4) * 8);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) ldmatrix_x4(qf[kk], a + kk * 32);
  }

  float acc[2 * KS][4];
#pragma unroll
  for (int j = 0; j < 2 * KS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};     // this lane's share of the row sums

  int stage = 0;
  while (cur < n_tiles) {
    int nxt = cur + 1, ncls = 0;
    while (nxt < n_tiles
           && (ncls = tile_class(KPOS, nxt * kKeys, sk, qmin, qmax, window,
                                 chunk, lane)) == 0)
      ++nxt;
    cp_async_wait_all();
    // tile cur has landed for every thread, and every warp is done with
    // the stage that tile nxt overwrites (tile cur - 1's, or Q)
    __syncthreads();
    if (nxt < n_tiles) load_tile(nxt, stage ^ 1);
    cp_async_commit();

    // S = Q K^T: 8 n8 tiles of keys, fragment rows g and g + 8.  K is read
    // as four 8 x 8 matrices, (keys 0-7 | 8-15) x (d 0-7 | 8-15): the
    // b0/b1 of two n8 key tiles
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    {
      const uint32_t kt = smem_u32(
          ks + stage * TILE + ((lane & 7) + ((lane >> 4) << 3)) * STR
          + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t b[4];
          ldmatrix_x4(b, kt + 2 * (jp * 16 * STR + kk * 16));
          mma_bf16(s[2 * jp], qf[kk], b[0], b[1]);
          mma_bf16(s[2 * jp + 1], qf[kk], b[2], b[3]);
        }
      }
    }

    if (softcap > 0.f) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = softcap * tanhf(s[j][e] / softcap);
    }
    if (cls == 1) {
      // a diagonal, window- or chunk-edge or ragged tile: the mask per pair
      int qp[2];
      bool qok[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + g + 8 * h;
        const int t = r / gq;
        qok[h] = r < rows && t0 + t < sq;
        qp[h] = qok[h] ? QPOS[t0 + t] : 0;
      }
      const int c0 = cur * kKeys;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int c = c0 + 8 * j + 2 * tig + e2;
          const bool kok = c < sk;
          const int kp = kok ? __ldg(KPOS + c) : 0;
          if (!(kok && qok[0] && allowed(kp, qp[0], window, chunk)))
            s[j][e2] = kNegInf;
          if (!(kok && qok[1] && allowed(kp, qp[1], window, chunk)))
            s[j][2 + e2] = kNegInf;
        }
      }
    }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      corr[h] = __expf(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= corr[h];
    }

    // P: f32 into the row sums, rounded to bf16 into the A fragments of
    // the PV product (key step j / 2: a0, a1 from n8 tile j even, a2, a3
    // from j odd)
    uint32_t pa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[e] = (cls == 2 || s[j][e] > 0.5f * kNegInf)
                   ? __expf(s[j][e] - mx[e >> 1]) : 0.f;
      l[0] += p[0] + p[1];
      l[1] += p[2] + p[3];
      pa[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }

#pragma unroll
    for (int j = 0; j < 2 * KS; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }
    // V is read transposed as (keys 0-7 | 8-15) x (d 0-7 | 8-15): the
    // b0/b1 of two n8 d tiles
    {
      const uint32_t vt = smem_u32(
          vs + stage * TILE + ((lane & 7) + (((lane >> 3) & 1) << 3)) * STR
          + (lane >> 4) * 8);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int jp = 0; jp < KS; ++jp) {
          if (16 * jp >= hd) break;
          uint32_t b[4];
          ldmatrix_x4_trans(b, vt + 2 * (kk * 16 * STR + jp * 16));
          mma_bf16(acc[2 * jp], pa[kk], b[0], b[1]);
          if (16 * jp + 8 < hd) mma_bf16(acc[2 * jp + 1], pa[kk], b[2], b[3]);
        }
      }
    }
    cur = nxt;
    cls = ncls;
    stage ^= 1;
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = warp * 16 + g + 8 * h;
    const int t = r / gq, hh = r - t * gq;
    if (r >= rows || t0 + t >= sq) continue;
    __nv_bfloat16* dst =
        out + (((size_t)blockIdx.z * sq + t0 + t) * nq + blockIdx.y * gq + hh)
                  * hd + 2 * tig;
    const float den = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int j = 0; j < 2 * KS; ++j) {
      if (8 * j < hd)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(acc[j][2 * h] / den,
                                  acc[j][2 * h + 1] / den);
    }
    if (lse != nullptr && tig == 0)
      lse[((size_t)blockIdx.z * nq + blockIdx.y * gq + hh) * sq + t0 + t] =
          m[h] + logf(den);
  }
#undef KV_ROW
#undef KPOS
#undef QPOS
}

template <int KS>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const int* q_pos, const int* k_pos, void* out,
                       float* lse, int b,
                       int sq, int sk, int nq, int nkv, int hd, float scale,
                       int window, int chunk, float softcap,
                       cudaStream_t stream) {
  const int bq = kRows / (nq / nkv);
  const size_t smem = (size_t)4 * kKeys * (16 * KS + 8)
                      * sizeof(__nv_bfloat16);
  cudaError_t e = cudaFuncSetAttribute(
      flash_prefill_mma_kernel<KS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((sq + bq - 1) / bq, nkv, b);
  flash_prefill_mma_kernel<KS><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), q_pos, k_pos,
      static_cast<__nv_bfloat16*>(out), lse, sq, sk, nq, nkv, hd, scale,
      window, chunk, softcap);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The backward: no Pallas counterpart
// ---------------------------------------------------------------------------
//
// The JAX package has no backward kernel: its loss differentiates
// layers.chunked_attention (jnp under jax.checkpoint) with XLA.  These
// kernels compute that gradient from the forward's output O and row
// log-sum-exp LSE (flash attention 2's backward), in three launches:
// - flash_bwd_prep_kernel: D = rowsum(dO * O) in f32, one warp a row; in
//   bf16 also q * scale rounded to bf16 (the forward's rounding) into a
//   scratch tensor, so that the tiles below arrive as they are;
// - a dK/dV kernel: one block per (key tile, kv head, batch row) loops
//   over the q tiles of every q head of its GQA group, so the group's dK
//   and dV sum in registers: no atomics, and the result is the same from
//   run to run;
// - a dQ kernel: one block per (folded q tile, kv head, batch row), the
//   forward's folding of the group into 64 rows, loops over the key tiles.
// Each recomputes S = (q * scale, rounded to q's type) k^T in f32,
// P = exp(S - LSE) masked as the forward masks (p = 0 for a rejected pair
// or a key past sk), dP = dO v^T and dS = P * (dP - D); a logit softcap c
// multiplies dS by 1 - (s / c)^2, s the capped score.  Then dV = P^T dO,
// dK = dS^T (q * scale) and dQ = dS k * scale, each rounded once to the
// operands' type.  P and dS enter their products in the operands' type
// (bf16 rounds them, as the forward rounds p); the plain version
// (ops.py::prefill_attention_bwd_plain) does the same.
//
// What bounds it on an H100: operations, 10 * hd flops per unmasked pair
// (five products) against q, k, v, o, dO and the gradients moved once:
// at danube's 8,192-token training sequence, 966 GFLOP a layer, 0.98 ms
// at the bf16 tensor-core rate.  A (q tile, key tile) pair whose every
// pair is masked is skipped (the forward's tile_class), and a wholly
// allowed one skips the per-pair mask, as in the forward; at 8,192 tokens
// and a 4,096 window that skips 62% of the 64 x 64 tiles.
//
// bf16 (flash_bwd_dkdv_wgmma_kernel, flash_bwd_dq_wgmma_kernel, hd % 8
// == 0): the five products on wgmma m64n64k16 with f32 accumulators, the
// operands brought by TMA.  Shared by both kernels:
// - 384 threads, one block to an SM: warpgroup 0 is the producer (one
//   warp; its registers dropped to 40 by setmaxnreg), warpgroups 1 and 2
//   the consumers (232 registers), each owning 64 rows of the block's
//   stationary tile.
// - The producer classifies the moving tiles 32 at a time, one a lane
//   (tile_class's test from each side's position range), and passes each
//   kept tile's position, head and class through a ring of kBwdStages
//   stages with a full and an empty mbarrier each; a class of -1 ends the
//   stream.  Consumers never see a skipped tile, and only partly masked
//   tiles evaluate the per-pair mask.
// - TMA reads q * scale, dO, k and v through 4-D maps (hd, heads,
//   positions, batch) with the 128-byte swizzle, so a tile never crosses a
//   batch row and positions past sq or sk, and columns past hd, land as
//   zeros.  A box is 64 columns (128 bytes, the swizzle's span): a head
//   row of hd 65..128 is two boxes (at hd 120 the second holds 56 columns
//   and 8 zeros), and every product runs in 64-column pieces.  The maps
//   are made on the host for each call, the encoder looked up through
//   the runtime (cudaGetDriverEntryPoint), so nothing links libcuda.
// - A K-major operand (S's and dP's both sides) is stepped along the head
//   dim inside its 128-byte rows; the products dV += P^T dO, dK += dS^T qs
//   and dQ += dS K take their A from registers (the accumulators rounded
//   to bf16, as the forward turns S into P) and their B MN-major from the
//   same tiles (wgmma's transpose bit), so no operand is copied or read
//   twice from device memory in a block.
// - Exponentials are exp2 with log2 e folded into the score and the LSE;
//   the producer stores each tile's LSE so multiplied.  P and dS are formed
//   by one of four straight-line loops picked once a tile (partly masked
//   or not, softcap or not): per element an FMA, an exp2 and two products,
//   the mask two compares against the key bound key_lo (window and chunk
//   in one number a query, made by the producer): per element, with the
//   softcap and the chunk division inline, this part would cost more
//   than the products.
// - The two consumers take turns at the tensor cores (two named
//   barriers), so one's exponentials run under the other's products.
// dK/dV: a block holds 128 keys (K and V stay in shared memory, 64 KiB at
// hd > 64) and loops over every (q head of the group, 64-position q tile)
// pair that is kept; a stage holds qs and dO (32 KiB) with the tile's LSE,
// D, positions and key bounds.  Per tile a consumer computes S^T = K qs^T
// and dP^T = V dO^T (64 x 64), P^T and dS^T in registers, then dV += P^T
// dO and dK += dS^T qs; dK and dV (64 x 128 f32 each) stay in registers,
// which with S^T and dP^T fill the 232 a consumer has.
// dQ: a block holds 128 folded q rows, the forward's folding (row r of a
// consumer's 64 is q head kh * gq + r % gq at position t0 + r / gq), each
// consumer's 64 one TMA box of gq heads x 64 / gq positions, which lands
// in exactly that order; where gq does not divide 64 the rows past the box
// are zeroed once and read LSE +inf.  It loops over the kept 64-key tiles:
// S = qs K^T and dP = dO V^T, then dQ += dS K, the scale at the store.
// dK/dV and dQ stay separate kernels with no atomics, so the result is the
// same from run to run, at 14 hd flops a pair against the bound's 10.  What
// still bounds it: S and dP read both operands from shared memory at n64,
// which needs as many bytes a clock as shared memory gives; each consumer
// waits on its own products; and dQ recomputes S and dP.  An f32 atomic dQ
// folded into the dK/dV kernel (flash attention 3's) is the next step.
//
// f32 (flash_bwd_dkdv_kernel, flash_bwd_dq_kernel): FMA on the CUDA cores,
// any hd <= 128, its floor the f32 rate.
// - 256 threads a block, each owning 4 rows x 4 columns of a 64 x 64 score
//   tile and 4 rows x (16 * NJ / 16) columns of its gradient tile.
// - Operands sit in shared memory, laid out so that a thread's 4 rows are
//   one float4 read as a broadcast (stride kTS) and its columns are
//   conflict-free scalar reads (stride kCS, 65: consecutive rows fall in
//   consecutive banks).

constexpr int kBwdThreads = 256;
constexpr int kTS = kKeys + 4;     // row stride of float4-read tiles
constexpr int kCS = kKeys + 1;     // row stride of column-read tiles

__device__ __forceinline__ void tile_range(const int* __restrict__ pos,
                                           int t0, int n, int len, int lane,
                                           int& lo, int& hi) {
  lo = INT32_MAX;
  hi = INT32_MIN;
  for (int t = lane; t < n; t += 32) {
    if (t0 + t < len) {
      const int p = __ldg(pos + t0 + t);
      lo = min(lo, p);
      hi = max(hi, p);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
}

// D = rowsum(dO * O) in f32 for every (batch row, position, q head), in
// the (b, nq, sq) layout of the LSE; and, given qs, q * scale rounded to
// T into it, in q's layout
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_prep_kernel(const T* __restrict__ q, const T* __restrict__ o,
                      const T* __restrict__ dout, T* __restrict__ qs,
                      float* __restrict__ delta, long long n_rows, int sq,
                      int nq, int hd, float scale) {
  const long long w =
      ((long long)blockIdx.x * kBwdThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= n_rows) return;
  const T* po = o + w * hd;
  const T* pd = dout + w * hd;
  float sum = 0.f;
  for (int d = lane; d < hd; d += 32) sum += to_f32(po[d]) * to_f32(pd[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (qs != nullptr)
    for (int d = lane; d < hd; d += 32)
      store(qs + w * hd + d, to_f32(q[w * hd + d]) * scale);
  if (lane == 0) {
    const int h = (int)(w % nq);
    const long long bt = w / nq;
    const int t = (int)(bt % sq);
    const long long bi = bt / sq;
    delta[(bi * nq + h) * sq + t] = sum;
  }
}

// softcap, mask, P and dS of one score, in place: s becomes P and dp
// becomes dS
__device__ __forceinline__ void p_ds(float& s, float& dp, float lse, float d,
                                     bool ok, float softcap) {
  float x = s, dcap = 1.f;
  if (softcap > 0.f) {
    const float th = tanhf(x / softcap);
    x = softcap * th;
    dcap = 1.f - th * th;
  }
  const float p = ok ? __expf(x - lse) : 0.f;
  s = p;
  dp = p * (dp - d) * dcap;
}

// dK and dV of one 64-key tile of one kv head: rows are keys, the score
// tile's columns are the 64 positions of one q tile of one q head
template <int NJ>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const int* __restrict__ q_pos,
                      const int* __restrict__ k_pos, float* __restrict__ dk,
                      float* __restrict__ dv, int sq, int sk, int nq, int nkv,
                      int hd, float scale, int window, int chunk,
                      float softcap) {
  constexpr int HDP = 16 * NJ;
  const int gq = nq / nkv;
  const int c0 = blockIdx.x * kKeys;
  const int kh = blockIdx.y;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tx = tid & 15;       // score columns and gradient columns
  const int ty = tid >> 4;       // rows ty * 4 + i
  const int* kpos = k_pos + (size_t)bi * sk;
  const int* qpos = q_pos + (size_t)bi * sq;

  extern __shared__ float smem[];
  float* kt = smem;              // K[c][d] at kt[d * kTS + c]
  float* vt = kt + hd * kTS;     // V alike
  float* qt = vt + hd * kTS;     // (q * scale)[r][d] at qt[d * kCS + r]
  float* ot = qt + HDP * kCS;    // dO alike
  float* pt = ot + HDP * kCS;    // P[r][c] at pt[r * kTS + c]
  float* st = pt + kKeys * kTS;  // dS alike

  const size_t q_row = (size_t)nq * hd;
  const size_t kv_row = (size_t)nkv * hd;
  for (int i = tid; i < kKeys * hd; i += kBwdThreads) {
    const int c = i / hd, d = i - c * hd;
    float kx = 0.f, vx = 0.f;
    if (c0 + c < sk) {
      const size_t off = ((size_t)bi * sk + c0 + c) * kv_row
                         + (size_t)kh * hd + d;
      kx = k[off];
      vx = v[off];
    }
    kt[d * kTS + c] = kx;
    vt[d * kTS + c] = vx;
  }
  // rows hd..HDP of the q-side tiles: read by the gradient loop, never
  // loaded
  for (int i = tid; i < (HDP - hd) * kCS; i += kBwdThreads) {
    qt[hd * kCS + i] = 0.f;
    ot[hd * kCS + i] = 0.f;
  }
  int kp[4];
  bool kok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty * 4 + i;
    kok[i] = c < sk;
    kp[i] = kok[i] ? kpos[c] : 0;
  }
  float gk[4][NJ], gv[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) gk[i][j] = gv[i][j] = 0.f;

  const int n_qt = (sq + kKeys - 1) / kKeys;
  for (int it = 0; it < gq * n_qt; ++it) {
    const int h = kh * gq + it / n_qt;
    const int t0 = (it % n_qt) * kKeys;
    int qmin, qmax;
    tile_range(qpos, t0, kKeys, sq, lane, qmin, qmax);
    const int cls = tile_class(kpos, c0, sk, qmin, qmax, window, chunk,
                               lane);
    if (cls == 0) continue;      // the same in every warp
    __syncthreads();             // every warp is done with the last tile
    for (int i = tid; i < kKeys * hd; i += kBwdThreads) {
      const int r = i / hd, d = i - r * hd;
      float qx = 0.f, ox = 0.f;
      if (t0 + r < sq) {
        const size_t off = ((size_t)bi * sq + t0 + r) * q_row
                           + (size_t)h * hd + d;
        qx = q[off] * scale;
        ox = dout[off];
      }
      qt[d * kCS + r] = qx;
      ot[d * kCS + r] = ox;
    }
    int qp[4];
    bool qok[4];
    float ql[4], qd[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = t0 + tx + 16 * j;
      qok[j] = t < sq;
      const size_t ri = ((size_t)bi * nq + h) * sq + t;
      qp[j] = qok[j] ? qpos[t] : 0;
      ql[j] = qok[j] ? lse[ri] : 0.f;
      qd[j] = qok[j] ? delta[ri] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      const float4 k4 = *reinterpret_cast<const float4*>(kt + d * kTS
                                                         + ty * 4);
      const float4 v4 = *reinterpret_cast<const float4*>(vt + d * kTS
                                                         + ty * 4);
      const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
      const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
      float qq[4], oo[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qq[j] = qt[d * kCS + tx + 16 * j];
        oo[j] = ot[d * kCS + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(kk[i], qq[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], oo[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = kok[i] && qok[j]
                        && (cls == 2 || allowed(kp[i], qp[j], window, chunk));
        p_ds(s[i][j], dp[i][j], ql[j], qd[j], ok, softcap);
      }
      *reinterpret_cast<float4*>(pt + (tx + 16 * j) * kTS + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      *reinterpret_cast<float4*>(st + (tx + 16 * j) * kTS + ty * 4) =
          make_float4(dp[0][j], dp[1][j], dp[2][j], dp[3][j]);
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < kKeys; ++r) {
      const float4 p4 = *reinterpret_cast<const float4*>(pt + r * kTS
                                                         + ty * 4);
      const float4 d4 = *reinterpret_cast<const float4*>(st + r * kTS
                                                         + ty * 4);
      const float pp[4] = {p4.x, p4.y, p4.z, p4.w};
      const float dd[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float o = ot[(tx + 16 * j) * kCS + r];
        const float qv = qt[(tx + 16 * j) * kCS + r];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          gv[i][j] = fmaf(pp[i], o, gv[i][j]);
          gk[i][j] = fmaf(dd[i], qv, gk[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty * 4 + i;
    if (c >= sk) continue;
    const size_t off = ((size_t)bi * sk + c) * kv_row + (size_t)kh * hd;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) {
        dk[off + d] = gk[i][j];
        dv[off + d] = gv[i][j];
      }
    }
  }
}

// dQ of one folded q tile of one kv head (the forward's folding: row r is
// q head kh * gq + r % gq at position t0 + r / gq); columns are keys
template <int NJ>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dq_kernel(const float* __restrict__ q,
                    const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ q_pos,
                    const int* __restrict__ k_pos, float* __restrict__ dq,
                    int sq, int sk, int nq, int nkv, int hd, float scale,
                    int window, int chunk, float softcap) {
  constexpr int HDP = 16 * NJ;
  const int gq = nq / nkv;
  const int bq = kRows / gq;                 // positions per q tile
  const int rows = bq * gq;                  // rows in use (<= kRows)
  const int t0 = (gridDim.x - 1 - blockIdx.x) * bq;
  const int kh = blockIdx.y;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tx = tid & 15;       // score columns and gradient columns
  const int ty = tid >> 4;       // rows ty * 4 + i
  const int* kpos = k_pos + (size_t)bi * sk;
  const int* qpos = q_pos + (size_t)bi * sq;

  extern __shared__ float smem[];
  float* qt = smem;              // (q * scale)[r][d] at qt[d * kTS + r]
  float* ot = qt + hd * kTS;     // dO alike
  float* kt = ot + hd * kTS;     // K[c][d] at kt[d * kCS + c], HDP rows
  float* vt = kt + HDP * kCS;    // V alike
  float* st = vt + HDP * kCS;    // dS[r][c] at st[c * kTS + r]

  const size_t q_row = (size_t)nq * hd;
  const size_t kv_row = (size_t)nkv * hd;
  for (int i = tid; i < kRows * hd; i += kBwdThreads) {
    const int r = i / hd, d = i - r * hd;
    const int t = r / gq, g = r - t * gq;
    float qx = 0.f, ox = 0.f;
    if (r < rows && t0 + t < sq) {
      const size_t off = ((size_t)bi * sq + t0 + t) * q_row
                         + (size_t)(kh * gq + g) * hd + d;
      qx = q[off] * scale;
      ox = dout[off];
    }
    qt[d * kTS + r] = qx;
    ot[d * kTS + r] = ox;
  }
  for (int i = tid; i < (HDP - hd) * kCS; i += kBwdThreads)
    kt[hd * kCS + i] = 0.f;

  int rp[4];
  bool rok[4];
  float rl[4], rd[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int t = r / gq, g = r - t * gq;
    rok[i] = r < rows && t0 + t < sq;
    const size_t ri = ((size_t)bi * nq + kh * gq + g) * sq + t0 + t;
    rp[i] = rok[i] ? qpos[t0 + t] : 0;
    rl[i] = rok[i] ? lse[ri] : 0.f;
    rd[i] = rok[i] ? delta[ri] : 0.f;
  }
  int qmin, qmax;
  tile_range(qpos, t0, bq, sq, lane, qmin, qmax);

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int n_tiles = (sk + kKeys - 1) / kKeys;
  for (int kt_i = 0; kt_i < n_tiles; ++kt_i) {
    const int c0 = kt_i * kKeys;
    const int cls = tile_class(kpos, c0, sk, qmin, qmax, window, chunk,
                               lane);
    if (cls == 0) continue;      // the same in every warp
    __syncthreads();             // every warp is done with the last tile
    for (int i = tid; i < kKeys * hd; i += kBwdThreads) {
      const int c = i / hd, d = i - c * hd;
      float kx = 0.f, vx = 0.f;
      if (c0 + c < sk) {
        const size_t off = ((size_t)bi * sk + c0 + c) * kv_row
                           + (size_t)kh * hd + d;
        kx = k[off];
        vx = v[off];
      }
      kt[d * kCS + c] = kx;
      vt[d * kCS + c] = vx;
    }
    int kp[4];
    bool kok[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      kok[j] = c < sk;
      kp[j] = kok[j] ? kpos[c] : 0;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      const float4 q4 = *reinterpret_cast<const float4*>(qt + d * kTS
                                                         + ty * 4);
      const float4 o4 = *reinterpret_cast<const float4*>(ot + d * kTS
                                                         + ty * 4);
      const float qq[4] = {q4.x, q4.y, q4.z, q4.w};
      const float oo[4] = {o4.x, o4.y, o4.z, o4.w};
      float kk[4], vv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kk[j] = kt[d * kCS + tx + 16 * j];
        vv[j] = vt[d * kCS + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qq[i], kk[j], s[i][j]);
          dp[i][j] = fmaf(oo[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = rok[i] && kok[j]
                        && (cls == 2 || allowed(kp[j], rp[i], window, chunk));
        p_ds(s[i][j], dp[i][j], rl[i], rd[i], ok, softcap);
      }
      *reinterpret_cast<float4*>(st + (tx + 16 * j) * kTS + ty * 4) =
          make_float4(dp[0][j], dp[1][j], dp[2][j], dp[3][j]);
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kKeys; ++c) {
      const float4 d4 = *reinterpret_cast<const float4*>(st + c * kTS
                                                         + ty * 4);
      const float dd[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float kv = kt[(tx + 16 * j) * kCS + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(dd[i], kv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!rok[i]) continue;
    const int r = ty * 4 + i;
    const int t = r / gq, g = r - t * gq;
    float* dst = dq + ((size_t)bi * sq + t0 + t) * q_row
             + (size_t)(kh * gq + g) * hd;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) dst[d] = acc[i][j] * scale;
    }
  }
}


// ---------------------------------------------------------------------------
// the backward in bf16 on the tensor cores: wgmma fed by TMA
// ---------------------------------------------------------------------------

constexpr int kWsThreads = 384;        // a producer and two consumer warpgroups
constexpr int kBoxBytes = 64 * 128;    // a TMA box of 64 rows x 64 columns
constexpr int kBwdStages = 4;          // depth of the ring
constexpr float kLog2e = 1.4426950408889634f;

// what a ring stage carries besides its tiles: the tile's first position
// (dK/dV: of the q tile; dQ: of the key tile) and its class (1 some pairs
// masked, 2 none; -1 ends the stream)
struct StageMeta {
  int t0, cls;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

// one box of a 4-D map (columns, heads, positions, batch) into shared
// memory at dst, its bytes completing on bar; zeros outside the tensor
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(bar) : "memory");
}

// the consumers take turns to start their products (named barriers 1 and
// 2, each passed by its own warpgroup's bar.sync and the other's
// bar.arrive), so one's exponentials overlap the other's products
__device__ __forceinline__ void turn_wait(int w) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + w) : "memory");
}
__device__ __forceinline__ void turn_pass(int w) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - w) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// registers that an asynchronous wgmma reads or writes: pinned here, after
// its wait, so that the compiler neither reads them earlier nor reuses
// them while it runs
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void pin(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// the wgmma descriptor of a tile in shared memory as TMA wrote it with the
// 128-byte swizzle: rows of 128 bytes in 1,024-byte atoms of 8 rows, the
// atom 1,024-aligned.  Stride byte offset 1,024 (the next 8 rows: of M or
// N for a K-major operand, of K for an MN-major one), leading byte offset
// unused (no operand here is wider than one 128-byte row along its
// contiguous dimension), layout 1 (128-byte swizzle).  A K-major operand
// steps along K by adding 32 bytes a k16 step inside the 128-byte row.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)
         | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

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

// d (64 x 64 f32; its old value kept if acc, else dropped) += A (64 x 16)
// B (16 x 64), both bf16 K-major in shared memory.  d's element i of this
// thread is the mma.sync accumulator's: row 16 warp + g + 8 (i % 4 / 2),
// column 8 (i / 4) + 2 tig + i % 2
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int acc) {
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
               ", %32, %33, p, 1, 1, 0, 0;\n}\n"
               : WG_ACC(d)
               : "l"(a), "l"(b), "r"(acc));
}

// d (64 x 64 f32) += A (64 x 16 bf16 in registers, mma.sync's A fragment
// of each warp's 16 rows) B (16 x 64 bf16, MN-major in shared memory)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
               ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
               : WG_ACC(d)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef WG_D32
#undef WG_ACC

// A fragments of the four k16 steps of a 64 x 64 accumulator, rounded to
// bf16: the forward's P
__device__ __forceinline__ void acc_to_a(const float (&c)[32],
                                         uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(c[8 * kk + 2 * r], c[8 * kk + 2 * r + 1]);
}

// 2^x; volatile, like lds2f and lds2i below, so that the softmax's loads
// stay in step with its exponentials instead of all being hoisted into
// registers
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm volatile("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two 32-bit words from shared memory at addr
__device__ __forceinline__ float2 lds2f(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}
__device__ __forceinline__ int2 lds2i(uint32_t addr) {
  int2 v;
  asm volatile("ld.shared.v2.s32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y) : "r"(addr));
  return v;
}

// P and dS of one score in place (s becomes P, dp becomes dS), the LSE
// given times log2 e: P = 2^(s log2 e - lse2), masked unless ok
template <bool CAP>
__device__ __forceinline__ void p_ds2(float& s, float& dp, float lse2, float d,
                                      bool ok, float softcap) {
  float x = s, dcap = 1.f;
  if constexpr (CAP) {
    const float th = tanhf(x / softcap);
    x = softcap * th;
    dcap = 1.f - th * th;
  }
  const float p = ok ? ex2(fmaf(x, kLog2e, -lse2)) : 0.f;
  s = p;
  dp = CAP ? p * (dp - d) * dcap : p * (dp - d);
}

// the lowest key position that query position qp may see: the pair
// (kp, qp) is unmasked iff key_lo(qp) <= kp <= qp, which is allowed()
// with the window and the chunk folded into one bound (one division a
// query instead of two a pair)
__device__ __forceinline__ int key_lo(int qp, int window, int chunk) {
  int lo = INT32_MIN;
  if (window > 0) lo = qp - window + 1;
  if (chunk > 0)
    lo = max(lo, (int)max((long long)floor_div(qp, chunk) * chunk,
                          (long long)INT32_MIN));
  return lo;
}

// P^T and dS^T of a dK/dV tile in place: element i of this thread is key
// row g + 8 (i % 4 / 2) (position kp), query column 8 (i / 4) + 2 tig +
// i % 2; the queries' LSE (times log2 e), D, positions and key_lo come
// from the stage's four arrays of 64 at shared address meta (256 bytes
// apart).  A key past sk is not masked: its row of dK and dV is never
// stored, and no other row reads it.
template <bool MASK, bool CAP>
__device__ __forceinline__ void dkdv_p_ds(float (&s)[32], float (&dp)[32],
                                          uint32_t meta, const int (&kp)[2],
                                          int tig, float softcap) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t col = meta + 4 * (8 * j + 2 * tig);
    const float2 l2 = lds2f(col);
    const float2 d2 = lds2f(col + 256);
    int2 q2 = make_int2(0, 0), lo2 = make_int2(0, 0);
    if constexpr (MASK) {
      q2 = lds2i(col + 512);
      lo2 = lds2i(col + 768);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const bool ok = !MASK || (kp[h] <= ((e & 1) ? q2.y : q2.x)
                                && kp[h] >= ((e & 1) ? lo2.y : lo2.x));
      p_ds2<CAP>(s[4 * j + e], dp[4 * j + e], (e & 1) ? l2.y : l2.x,
                 (e & 1) ? d2.y : d2.x, ok, softcap);
    }
  }
}

// P and dS of a dQ tile in place: element i is folded row g + 8 (i % 4 /
// 2) (LSE times log2 e, D, position and key_lo in registers), key column
// 8 (i / 4) + 2 tig + i % 2 (positions from the stage at shared address
// pv; keys from k0 on exist up to sk)
template <bool MASK, bool CAP>
__device__ __forceinline__ void dq_p_ds(float (&s)[32], float (&dp)[32],
                                        const float (&rl)[2],
                                        const float (&rd)[2],
                                        const int (&rp)[2],
                                        const int (&rlo)[2], uint32_t pv,
                                        int k0, int sk, int tig,
                                        float softcap) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * tig;
    int2 k2 = make_int2(0, 0);
    if constexpr (MASK) k2 = lds2i(pv + 4 * col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const int kp = (e & 1) ? k2.y : k2.x;
      const bool ok = !MASK || (k0 + col + (e & 1) < sk && kp <= rp[h]
                                && kp >= rlo[h]);
      p_ds2<CAP>(s[4 * j + e], dp[4 * j + e], rl[h], rd[h], ok, softcap);
    }
  }
}

// one lane's (min, max) of positions [t0, t0 + n) below len
__device__ __forceinline__ void lane_range(const int* __restrict__ pos, int t0,
                                           int n, int len, int& lo, int& hi) {
  lo = INT32_MAX;
  hi = INT32_MIN;
  const int end = min(t0 + n, len);
#pragma unroll 4
  for (int t = t0; t < end; ++t) {
    const int p = __ldg(pos + t);
    lo = min(lo, p);
    hi = max(hi, p);
  }
}

// (min, max) of positions and of their attention chunks (floor(pos /
// chunk); 0 and 0 without chunks): one side of a tile
struct PosRange {
  int lo, hi, clo, chi;
};

__device__ __forceinline__ PosRange pos_range(int lo, int hi, int chunk) {
  PosRange r{lo, hi, 0, 0};
  if (chunk > 0 && lo <= hi) {
    r.clo = floor_div(lo, chunk);
    r.chi = floor_div(hi, chunk);
  }
  return r;
}

// tile_class from the two sides' ranges: 0 every pair masked, 1 some, 2
// none; kfull: every key of the tile exists
__device__ __forceinline__ int range_class(const PosRange& k, bool kfull,
                                           const PosRange& q, int window,
                                           int chunk) {
  bool skip = q.lo > q.hi || k.lo > q.hi;
  if (window > 0) skip = skip || (long long)k.hi <= (long long)q.lo - window;
  if (chunk > 0) skip = skip || k.chi < q.clo || k.clo > q.chi;
  if (skip) return 0;
  bool all = kfull && k.hi <= q.lo;
  if (window > 0) all = all && (long long)k.lo > (long long)q.hi - window;
  if (chunk > 0) all = all && k.clo == q.chi && k.chi == q.clo;
  return all ? 2 : 1;
}

__device__ __forceinline__ void warp_range(int& lo, int& hi) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// dK/dV shared memory in bytes: K and V (NB boxes of 128 keys each), the
// ring's qs and dO (NB boxes of 64 positions each), its LSE, D, positions
// and key_lo, its meta, the barriers, and the slack to align to 1,024
__host__ __device__ constexpr int dkdv_smem(int nb) {
  return 2 * nb * 2 * kBoxBytes + kBwdStages * 2 * nb * kBoxBytes
         + kBwdStages * (4 * 64 * 4 + 8) + (2 * kBwdStages + 1) * 8 + 1024;
}

// dQ shared memory: qs and dO of both consumers' 64 folded rows (NB boxes
// each), the ring's K and V (NB boxes of 64 keys each), its key positions
// and meta, the barriers, the slack
__host__ __device__ constexpr int dq_smem(int nb) {
  return 2 * 2 * nb * kBoxBytes + kBwdStages * 2 * nb * kBoxBytes
         + kBwdStages * (64 * 4 + 8) + (2 * kBwdStages + 1) * 8 + 1024;
}

// dK and dV of 128 keys of one kv head (rows 64 w.. belong to consumer w),
// over every (q head of the group, 64-position q tile) the producer finds
// not wholly masked.  NB: 64-column boxes of the head dim (1 or 2).
template <int NB>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap m_k,
                            const __grid_constant__ CUtensorMap m_v,
                            const __grid_constant__ CUtensorMap m_qs,
                            const __grid_constant__ CUtensorMap m_do,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            const int* __restrict__ q_pos,
                            const int* __restrict__ k_pos,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, int sq, int sk,
                            int nq, int nkv, int hd, int window, int chunk,
                            float softcap) {
  constexpr int S = kBwdStages;
  constexpr int KV = 2 * NB * kBoxBytes;   // K or V: NB boxes of 128 rows
  constexpr int ST = 2 * NB * kBoxBytes;   // a stage: qs, then dO
  const int gq = nq / nkv;
  const int c0 = blockIdx.x * 128;
  const int kh = blockIdx.y;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int* qpos = q_pos + (size_t)bi * sq;
  const int* kpos = k_pos + (size_t)bi * sk;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  const uint32_t base = smem_u32(sm);
  // per stage: the q tile's LSE (times log2 e), D, positions and key_lo
  float* lse_s = reinterpret_cast<float*>(sm + 2 * KV + S * ST);
  StageMeta* meta = reinterpret_cast<StageMeta*>(lse_s + S * 4 * 64);
  const uint32_t full = smem_u32(meta + S);  // S full, S empty, K/V landed
  const uint32_t empty = full + 8 * S;
  const uint32_t kvbar = full + 16 * S;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 32);            // the producer warp's lanes
      mbar_init(empty + 8 * s, 256);          // every consumer thread
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // producer: one warp classifies the q tiles and feeds the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid >= 32) return;
    int kmin = INT32_MAX, kmax = INT32_MIN;
    for (int c = c0 + lane; c < min(c0 + 128, sk); c += 32) {
      const int p = __ldg(kpos + c);
      kmin = min(kmin, p);
      kmax = max(kmax, p);
    }
    warp_range(kmin, kmax);
    const PosRange kr = pos_range(kmin, kmax, chunk);
    const bool kfull = c0 + 128 <= sk;
    if (lane == 0) {
      mbar_arrive_tx(kvbar, 2 * KV);
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        tma_load(base + c * 2 * kBoxBytes, &m_k, kvbar, 64 * c, kh, c0, bi);
        tma_load(base + KV + c * 2 * kBoxBytes, &m_v, kvbar, 64 * c, kh, c0,
                 bi);
      }
    }
    const int n_qt = (sq + 63) / 64;
    int stage = 0, phase = 0;
    for (int b0 = 0; b0 < n_qt; b0 += 32) {
      // lane l classifies q tile b0 + l; the kept ones go in order
      int cls = 0;
      if (b0 + lane < n_qt) {
        int qmin, qmax;
        lane_range(qpos, (b0 + lane) * 64, 64, sq, qmin, qmax);
        cls = range_class(kr, kfull, pos_range(qmin, qmax, chunk), window,
                          chunk);
      }
      unsigned todo = __ballot_sync(0xffffffffu, cls != 0);
      while (todo) {
        const int i = __ffs(todo) - 1;
        todo &= todo - 1;
        const int tc = __shfl_sync(0xffffffffu, cls, i);
        const int t0 = (b0 + i) * 64;
        for (int hh = 0; hh < gq; ++hh) {
          const int h = kh * gq + hh;
          mbar_wait(empty + 8 * stage, phase ^ 1);
          // a query past sq gets LSE +inf: p = 0 without a mask
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int t = t0 + lane + 32 * r;
            const bool ok = t < sq;
            const size_t ri = ((size_t)bi * nq + h) * sq + t;
            float* st = lse_s + stage * 4 * 64 + lane + 32 * r;
            const int p = ok ? __ldg(qpos + t) : 0;
            st[0] = ok ? __ldg(lse + ri) * kLog2e : INFINITY;
            st[64] = ok ? __ldg(delta + ri) : 0.f;
            reinterpret_cast<int*>(st)[128] = p;
            reinterpret_cast<int*>(st)[192] = key_lo(p, window, chunk);
          }
          const uint32_t fb = full + 8 * stage;
          if (lane == 0) {
            meta[stage] = StageMeta{t0, tc};
            const uint32_t dst = base + 2 * KV + stage * ST;
            mbar_arrive_tx(fb, ST);
#pragma unroll
            for (int c = 0; c < NB; ++c) {
              tma_load(dst + c * kBoxBytes, &m_qs, fb, 64 * c, h, t0, bi);
              tma_load(dst + (NB + c) * kBoxBytes, &m_do, fb, 64 * c, h, t0,
                       bi);
            }
          } else {
            mbar_arrive(fb);
          }
          if (++stage == S) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    mbar_wait(empty + 8 * stage, phase ^ 1);
    if (lane == 0) meta[stage].cls = -1;
    mbar_arrive(full + 8 * stage);
  } else {
    // consumers: warpgroup w owns keys c0 + 64 w .. c0 + 64 w + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int w = (tid >> 7) - 1;
    const int cw = (tid >> 5) & 3;            // warp in the warpgroup
    const int g = lane >> 2;
    const int tig = lane & 3;
    int kp[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + 64 * w + 16 * cw + g + 8 * h;
      kp[h] = c < sk ? __ldg(kpos + c) : 0;
    }
    float gk[NB][32], gv[NB][32];
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) gk[c][i] = gv[c][i] = 0.f;
    const uint32_t ka = base + w * kBoxBytes;       // this warpgroup's rows
    const uint32_t va = ka + KV;
    mbar_wait(kvbar, 0);
    if (w == 1) turn_pass(w);               // consumer 0 goes first

    int stage = 0, phase = 0;
    for (;;) {
      mbar_wait(full + 8 * stage, phase);
      const StageMeta m = meta[stage];
      if (m.cls < 0) break;
      const uint32_t qa = base + 2 * KV + stage * ST;
      const uint32_t oa = qa + NB * kBoxBytes;

      // S^T = K qs^T and dP^T = V dO^T: 64 keys x 64 queries
      float s[32], dp[32];
      turn_wait(w);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * NB; ++kk)
        wgmma_ss(s, sw128_desc(ka + (kk >> 2) * 2 * kBoxBytes + (kk & 3) * 32),
                 sw128_desc(qa + (kk >> 2) * kBoxBytes + (kk & 3) * 32),
                 kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4 * NB; ++kk)
        wgmma_ss(dp, sw128_desc(va + (kk >> 2) * 2 * kBoxBytes + (kk & 3) * 32),
                 sw128_desc(oa + (kk >> 2) * kBoxBytes + (kk & 3) * 32),
                 kk > 0);
      wgmma_commit();
      turn_pass(w);
      wgmma_wait();
      pin(s);
      pin(dp);

      // P^T into s, dS^T into dp
      const uint32_t mv = smem_u32(lse_s) + stage * 4 * 256;
      if (softcap > 0.f) {
        if (m.cls == 1)
          dkdv_p_ds<true, true>(s, dp, mv, kp, tig, softcap);
        else
          dkdv_p_ds<false, true>(s, dp, mv, kp, tig, softcap);
      } else if (m.cls == 1) {
        dkdv_p_ds<true, false>(s, dp, mv, kp, tig, softcap);
      } else {
        dkdv_p_ds<false, false>(s, dp, mv, kp, tig, softcap);
      }
      uint32_t pa[4][4], da[4][4];
      acc_to_a(s, pa);
      acc_to_a(dp, da);

      // dV += P^T dO and dK += dS^T qs: dO and qs MN-major, one 64-column
      // box of the head dim a product
      turn_wait(w);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < NB; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_rs(gv[c], pa[kk], sw128_desc(oa + c * kBoxBytes + kk * 2048));
          wgmma_rs(gk[c], da[kk], sw128_desc(qa + c * kBoxBytes + kk * 2048));
        }
      wgmma_commit();
      turn_pass(w);
      wgmma_wait();
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        pin(gv[c]);
        pin(gk[c]);
      }
      pin(pa);
      pin(da);
      mbar_arrive(empty + 8 * stage);
      if (++stage == S) {
        stage = 0;
        phase ^= 1;
      }
    }
    if (w == 0) turn_wait(w);               // consumer 1's last pass

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + 64 * w + 16 * cw + g + 8 * h;
      if (c >= sk) continue;
      const size_t off = (((size_t)bi * sk + c) * nkv + kh) * hd;
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int d = 64 * b + 8 * j + 2 * tig;
          if (d < hd) {
            *reinterpret_cast<__nv_bfloat162*>(dk + off + d) =
                __floats2bfloat162_rn(gk[b][4 * j + 2 * h],
                                      gk[b][4 * j + 2 * h + 1]);
            *reinterpret_cast<__nv_bfloat162*>(dv + off + d) =
                __floats2bfloat162_rn(gv[b][4 * j + 2 * h],
                                      gv[b][4 * j + 2 * h + 1]);
          }
        }
    }
  }
}

// dQ of 128 folded q rows of one kv head (the forward's folding; rows
// 64 w.. belong to consumer w, at positions t0 + w bq ..), over every
// 64-key tile the producer finds not wholly masked
template <int NB>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap m_qs,
                          const __grid_constant__ CUtensorMap m_do,
                          const __grid_constant__ CUtensorMap m_k,
                          const __grid_constant__ CUtensorMap m_v,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const int* __restrict__ q_pos,
                          const int* __restrict__ k_pos,
                          __nv_bfloat16* __restrict__ dq, int sq, int sk,
                          int nq, int nkv, int hd, float scale, int window,
                          int chunk, float softcap) {
  constexpr int S = kBwdStages;
  constexpr int QR = NB * kBoxBytes;      // one consumer's qs (or dO) rows
  constexpr int ST = 2 * NB * kBoxBytes;  // a stage: K, then V
  const int gq = nq / nkv;
  const int bq = 64 / gq;                 // positions per consumer
  const int rows = bq * gq;               // folded rows in use (<= 64)
  const int t0 = (gridDim.x - 1 - blockIdx.x) * 2 * bq;
  const int kh = blockIdx.y;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int* qpos = q_pos + (size_t)bi * sq;
  const int* kpos = k_pos + (size_t)bi * sk;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  const uint32_t base = smem_u32(sm);       // qs of both, dO of both, ring
  int* kpos_s = reinterpret_cast<int*>(sm + 4 * QR + S * ST);
  StageMeta* meta = reinterpret_cast<StageMeta*>(kpos_s + S * 64);
  const uint32_t full = smem_u32(meta + S);  // S full, S empty, q landed
  const uint32_t empty = full + 8 * S;
  const uint32_t qbar = full + 16 * S;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 32);
      mbar_init(empty + 8 * s, 256);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // rows rows..63 of the q boxes, which TMA never writes, read as zeros
  // (gq that does not divide 64)
  const int pad = 64 - rows;
  for (int i = tid; i < 4 * NB * pad * 8; i += kWsThreads) {
    const int bx = i / (pad * 8), r = rows + (i % (pad * 8)) / 8;
    *reinterpret_cast<uint4*>(sm + bx * kBoxBytes + r * 128 + (i % 8) * 16) =
        make_uint4(0, 0, 0, 0);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  if (tid < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid >= 32) return;
    int qmin = INT32_MAX, qmax = INT32_MIN;
    for (int t = t0 + lane; t < min(t0 + 2 * bq, sq); t += 32) {
      const int p = __ldg(qpos + t);
      qmin = min(qmin, p);
      qmax = max(qmax, p);
    }
    warp_range(qmin, qmax);
    const PosRange qr = pos_range(qmin, qmax, chunk);
    if (lane == 0) {
      mbar_arrive_tx(qbar, 4 * NB * rows * 128);
#pragma unroll
      for (int w = 0; w < 2; ++w)
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          tma_load(base + w * QR + c * kBoxBytes, &m_qs, qbar, 64 * c,
                   kh * gq, t0 + w * bq, bi);
          tma_load(base + 2 * QR + w * QR + c * kBoxBytes, &m_do, qbar,
                   64 * c, kh * gq, t0 + w * bq, bi);
        }
    }
    const int n_kt = (sk + 63) / 64;
    int stage = 0, phase = 0;
    for (int b0 = 0; b0 < n_kt; b0 += 32) {
      int cls = 0;
      if (b0 + lane < n_kt) {
        int kmin, kmax;
        lane_range(kpos, (b0 + lane) * 64, 64, sk, kmin, kmax);
        cls = range_class(pos_range(kmin, kmax, chunk),
                          (b0 + lane) * 64 + 64 <= sk, qr, window, chunk);
      }
      unsigned todo = __ballot_sync(0xffffffffu, cls != 0);
      while (todo) {
        const int i = __ffs(todo) - 1;
        todo &= todo - 1;
        const int tc = __shfl_sync(0xffffffffu, cls, i);
        const int kc = (b0 + i) * 64;
        int pp[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int c = kc + lane + 32 * r;
          pp[r] = c < sk ? __ldg(kpos + c) : 0;
        }
        mbar_wait(empty + 8 * stage, phase ^ 1);
        kpos_s[stage * 64 + lane] = pp[0];
        kpos_s[stage * 64 + lane + 32] = pp[1];
        const uint32_t fb = full + 8 * stage;
        if (lane == 0) {
          meta[stage] = StageMeta{kc, tc};
          const uint32_t dst = base + 4 * QR + stage * ST;
          mbar_arrive_tx(fb, ST);
#pragma unroll
          for (int c = 0; c < NB; ++c) {
            tma_load(dst + c * kBoxBytes, &m_k, fb, 64 * c, kh, kc, bi);
            tma_load(dst + (NB + c) * kBoxBytes, &m_v, fb, 64 * c, kh, kc,
                     bi);
          }
        } else {
          mbar_arrive(fb);
        }
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    mbar_wait(empty + 8 * stage, phase ^ 1);
    if (lane == 0) meta[stage].cls = -1;
    mbar_arrive(full + 8 * stage);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int w = (tid >> 7) - 1;
    const int cw = (tid >> 5) & 3;
    const int g = lane >> 2;
    const int tig = lane & 3;
    // this lane's rows g and g + 8 of the warp's 16: a row past the tile
    // or past sq gets LSE +inf, so p = 0 without a mask
    int rp[2], rlo[2], rt[2], rh[2];
    bool rok[2];
    float rl[2], rd[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * cw + g + 8 * h;
      const int t = r / gq;
      rh[h] = kh * gq + r - t * gq;
      rt[h] = t0 + w * bq + t;
      rok[h] = r < rows && rt[h] < sq;
      const size_t ri = ((size_t)bi * nq + rh[h]) * sq + rt[h];
      rp[h] = rok[h] ? __ldg(qpos + rt[h]) : 0;
      rlo[h] = key_lo(rp[h], window, chunk);
      rl[h] = rok[h] ? __ldg(lse + ri) * kLog2e : INFINITY;
      rd[h] = rok[h] ? __ldg(delta + ri) : 0.f;
    }
    float acc[NB][32];
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
    const uint32_t qa = base + w * QR;
    const uint32_t oa = qa + 2 * QR;
    mbar_wait(qbar, 0);
    if (w == 1) turn_pass(w);

    int stage = 0, phase = 0;
    for (;;) {
      mbar_wait(full + 8 * stage, phase);
      const StageMeta m = meta[stage];
      if (m.cls < 0) break;
      const uint32_t ka = base + 4 * QR + stage * ST;
      const uint32_t va = ka + NB * kBoxBytes;

      // S = qs K^T and dP = dO V^T: 64 folded rows x 64 keys
      float s[32], dp[32];
      turn_wait(w);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * NB; ++kk)
        wgmma_ss(s, sw128_desc(qa + (kk >> 2) * kBoxBytes + (kk & 3) * 32),
                 sw128_desc(ka + (kk >> 2) * kBoxBytes + (kk & 3) * 32),
                 kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4 * NB; ++kk)
        wgmma_ss(dp, sw128_desc(oa + (kk >> 2) * kBoxBytes + (kk & 3) * 32),
                 sw128_desc(va + (kk >> 2) * kBoxBytes + (kk & 3) * 32),
                 kk > 0);
      wgmma_commit();
      turn_pass(w);
      wgmma_wait();
      pin(s);
      pin(dp);

      const uint32_t pv = smem_u32(kpos_s) + stage * 256;
      if (softcap > 0.f) {
        if (m.cls == 1)
          dq_p_ds<true, true>(s, dp, rl, rd, rp, rlo, pv, m.t0, sk, tig,
                              softcap);
        else
          dq_p_ds<false, true>(s, dp, rl, rd, rp, rlo, pv, m.t0, sk, tig,
                               softcap);
      } else if (m.cls == 1) {
        dq_p_ds<true, false>(s, dp, rl, rd, rp, rlo, pv, m.t0, sk, tig,
                             softcap);
      } else {
        dq_p_ds<false, false>(s, dp, rl, rd, rp, rlo, pv, m.t0, sk, tig,
                              softcap);
      }
      uint32_t da[4][4];
      acc_to_a(dp, da);

      // dQ += dS K: K MN-major, one 64-column box a product
      turn_wait(w);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < NB; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs(acc[c], da[kk], sw128_desc(ka + c * kBoxBytes + kk * 2048));
      wgmma_commit();
      turn_pass(w);
      wgmma_wait();
#pragma unroll
      for (int c = 0; c < NB; ++c) pin(acc[c]);
      pin(da);
      mbar_arrive(empty + 8 * stage);
      if (++stage == S) {
        stage = 0;
        phase ^= 1;
      }
    }
    if (w == 0) turn_wait(w);

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!rok[h]) continue;
      __nv_bfloat16* dst = dq + (((size_t)bi * sq + rt[h]) * nq + rh[h]) * hd;
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int d = 64 * b + 8 * j + 2 * tig;
          if (d < hd)
            *reinterpret_cast<__nv_bfloat162*>(dst + d) =
                __floats2bfloat162_rn(acc[b][4 * j + 2 * h] * scale,
                                      acc[b][4 * j + 2 * h + 1] * scale);
        }
    }
  }
}

cudaError_t launch_prep(const void* q, const void* o, const void* dout,
                        void* qs, float* delta, int dtype, int b, int sq,
                        int nq, int hd, float scale, cudaStream_t stream) {
  const long long n_rows = (long long)b * sq * nq;
  const int warps = kBwdThreads / 32;
  const unsigned blocks = (unsigned)((n_rows + warps - 1) / warps);
  if (dtype == 0)
    flash_bwd_prep_kernel<float><<<blocks, kBwdThreads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(o),
        static_cast<const float*>(dout), nullptr, delta, n_rows, sq, nq, hd,
        scale);
  else
    flash_bwd_prep_kernel<__nv_bfloat16><<<blocks, kBwdThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(o),
        static_cast<const __nv_bfloat16*>(dout),
        static_cast<__nv_bfloat16*>(qs), delta, n_rows, sq, nq, hd, scale);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a map of a contiguous bf16 (b, len, heads, hd) tensor as the 4-D
// (hd, heads, len, b), in boxes of 64 columns x box_heads x box_rows x 1
// with the 128-byte swizzle; whatever a box covers outside the tensor
// (columns past hd, positions past len) lands as zeros
bool bf16_map(CUtensorMap* m, const void* p, int b, int len, int heads,
              int hd, int box_heads, int box_rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)len, (cuuint64_t)b};
  const cuuint64_t strides[3] = {2ull * hd, 2ull * hd * heads,
                                 2ull * hd * heads * len};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_heads, (cuuint32_t)box_rows,
                             1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p),
                dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NB>
cudaError_t launch_bwd_wgmma(const void* qs, const void* k, const void* v,
                             const float* lse, const void* dout,
                             const float* delta, const int* q_pos,
                             const int* k_pos, void* dq, void* dk, void* dv,
                             int b, int sq, int sk, int nq, int nkv, int hd,
                             float scale, int window, int chunk,
                             float softcap, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const int gq = nq / nkv, bq = 64 / gq;
  CUtensorMap mk, mv, mq, mo;
  if (!bf16_map(&mk, k, b, sk, nkv, hd, 1, 128)
      || !bf16_map(&mv, v, b, sk, nkv, hd, 1, 128)
      || !bf16_map(&mq, qs, b, sq, nq, hd, 1, 64)
      || !bf16_map(&mo, dout, b, sq, nq, hd, 1, 64))
    return cudaErrorInvalidValue;
  constexpr int smem_kv = dkdv_smem(NB);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkdv_wgmma_kernel<NB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (e != cudaSuccess) return e;
  flash_bwd_dkdv_wgmma_kernel<NB>
      <<<dim3((sk + 127) / 128, nkv, b), kWsThreads, smem_kv, stream>>>(
          mk, mv, mq, mo, lse, delta, q_pos, k_pos, static_cast<bf*>(dk),
          static_cast<bf*>(dv), sq, sk, nq, nkv, hd, window, chunk, softcap);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  // dQ: q and dO in the folded box (gq heads x bq positions), K and V in
  // 64-key tiles
  if (!bf16_map(&mq, qs, b, sq, nq, hd, gq, bq)
      || !bf16_map(&mo, dout, b, sq, nq, hd, gq, bq)
      || !bf16_map(&mk, k, b, sk, nkv, hd, 1, 64)
      || !bf16_map(&mv, v, b, sk, nkv, hd, 1, 64))
    return cudaErrorInvalidValue;
  constexpr int smem_q = dq_smem(NB);
  e = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<NB>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_q);
  if (e != cudaSuccess) return e;
  flash_bwd_dq_wgmma_kernel<NB>
      <<<dim3((sq + 2 * bq - 1) / (2 * bq), nkv, b), kWsThreads, smem_q,
          stream>>>(mq, mo, mk, mv, lse, delta, q_pos, k_pos,
                    static_cast<bf*>(dq), sq, sk, nq, nkv, hd, scale, window,
                    chunk, softcap);
  return cudaGetLastError();
}

template <int NJ>
cudaError_t launch_bwd(const float* q, const float* k, const float* v,
                       const float* lse, const float* dout,
                       const float* delta, const int* q_pos,
                       const int* k_pos, float* dq, float* dk, float* dv,
                       int b, int sq, int sk, int nq, int nkv, int hd,
                       float scale, int window, int chunk, float softcap,
                       cudaStream_t stream) {
  constexpr int HDP = 16 * NJ;
  const size_t smem_kv =
      (size_t)(2 * hd * kTS + 2 * HDP * kCS + 2 * kKeys * kTS) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<NJ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (e != cudaSuccess) return e;
  flash_bwd_dkdv_kernel<NJ>
      <<<dim3((sk + kKeys - 1) / kKeys, nkv, b), kBwdThreads, smem_kv,
          stream>>>(q, k, v, dout, lse, delta, q_pos, k_pos, dk, dv, sq,
                    sk, nq, nkv, hd, scale, window, chunk, softcap);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const int bq = kRows / (nq / nkv);
  const size_t smem_q =
      (size_t)(2 * hd * kTS + 2 * HDP * kCS + kKeys * kTS) * sizeof(float);
  e = cudaFuncSetAttribute(flash_bwd_dq_kernel<NJ>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_q);
  if (e != cudaSuccess) return e;
  flash_bwd_dq_kernel<NJ>
      <<<dim3((sq + bq - 1) / bq, nkv, b), kBwdThreads, smem_q, stream>>>(
          q, k, v, dout, lse, delta, q_pos, k_pos, dq, sq, sk, nq, nkv, hd,
          scale, window, chunk, softcap);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t as int (0 = launched).  dtype: 0 = f32, 1 = bf16
// (q, k, v and out alike).  window / chunk <= 0 and softcap <= 0 mean "no
// such mask".  nq must be a multiple of nkv with nq / nkv <= 64; hd <= 128,
// and for bf16 a multiple of 8 with q, k, v and out 16-byte aligned.
// scale is hd ** -0.5 rounded to the dtype, as the plain version has it.
// lse: null, or f32 (b, nq, sq) that receives each row's log-sum-exp of
// its masked scores, m + log(max(l, 1e-30)) (the backward's input).
int flash_prefill(const void* q, const void* k, const void* v,
                  const void* q_pos, const void* k_pos, void* out, void* lse,
                  int b, int sq, int sk, int nq, int nkv, int hd, int dtype,
                  int window, int chunk, float scale, float softcap,
                  void* stream) {
  if (nkv <= 0 || nq % nkv || nq / nkv > kRows || hd <= 0 || hd > 128 ||
      b <= 0 || sq <= 0 || sk <= 0)
    return (int)cudaErrorInvalidValue;
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(k_pos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ls = static_cast<float*>(lse);
  if (dtype == 0) {
    if (hd <= 64)
      return (int)launch<float, 4>(q, k, v, qp, kp, out, ls, b, sq, sk, nq,
                                   nkv, hd, scale, window, chunk, softcap, st);
    return (int)launch<float, 8>(q, k, v, qp, kp, out, ls, b, sq, sk, nq, nkv,
                                 hd, scale, window, chunk, softcap, st);
  }
  if (dtype != 1 || hd % 8 ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
#define GO(KS)                                                               \
  case KS:                                                                   \
    return (int)launch_mma<KS>(q, k, v, qp, kp, out, ls, b, sq, sk, nq, nkv, \
                               hd, scale, window, chunk, softcap, st)
  switch (max(2, (hd + 15) / 16)) {
    GO(2); GO(3); GO(4); GO(5); GO(6); GO(7); GO(8);
  }
#undef GO
  return (int)cudaErrorInvalidValue;
}

// The backward of flash_prefill.  Returns a cudaError_t as int (0 =
// launched).  q, o, dout and dq: (b, sq, nq, hd); k, v, dk and dv: (b, sk,
// nkv, hd); all of one dtype (0 = f32, 1 = bf16) and contiguous, for bf16
// with hd a multiple of 8 and 16-byte aligned.  lse: f32 (b, nq, sq) from
// the forward; delta: f32 (b, nq, sq) scratch; qs: for bf16 a scratch like
// q (q * scale lands there), else null.  The masks, scale and softcap are
// the forward's.  Three launches on stream.
int flash_prefill_bwd(const void* q, const void* k, const void* v,
                      const void* o, const void* lse, const void* dout,
                      const void* q_pos, const void* k_pos, void* dq,
                      void* dk, void* dv, void* delta, void* qs, int b,
                      int sq, int sk, int nq, int nkv, int hd, int dtype,
                      int window, int chunk, float scale, float softcap,
                      void* stream) {
  if (nkv <= 0 || nq % nkv || nq / nkv > kRows || hd <= 0 || hd > 128 ||
      b <= 0 || sq <= 0 || sk <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && (hd % 8 || qs == nullptr ||
                     ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                      (uintptr_t)dout | (uintptr_t)qs) % 16))
    return (int)cudaErrorInvalidValue;
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(k_pos);
  const float* ls = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = launch_prep(q, o, dout, qs, dl, dtype, b, sq, nq, hd, scale,
                              st);
  if (e != cudaSuccess) return (int)e;
  if (dtype == 0) {
    auto in = [](const void* p) { return static_cast<const float*>(p); };
    auto out = [](void* p) { return static_cast<float*>(p); };
    return (int)(hd <= 64 ? launch_bwd<4> : launch_bwd<8>)(
        in(q), in(k), in(v), ls, in(dout), dl, qp, kp, out(dq), out(dk),
        out(dv), b, sq, sk, nq, nkv, hd, scale, window, chunk, softcap, st);
  }
  return (int)(hd <= 64 ? launch_bwd_wgmma<1> : launch_bwd_wgmma<2>)(
      qs, k, v, ls, dout, dl, qp, kp, dq, dk, dv, b, sq, sk, nq, nkv, hd,
      scale, window, chunk, softcap, st);
}

const char* flash_prefill_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
