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
//   scratch tensor, so that the tiles below arrive by cp.async as they are;
// - a dK/dV kernel: one block per (64-key tile, kv head, batch row) loops
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
// bf16 (flash_bwd_dkdv_mma_kernel, flash_bwd_dq_mma_kernel, hd % 8 == 0):
// the five products on mma.sync m16n8k16 with f32 accumulators, the
// forward's fragments turned around:
// - dK/dV: each of 4 warps owns 16 key rows and computes S^T = K Q^T and
//   dP^T = V dO^T for a 64-query tile (K and V read with ldmatrix as A,
//   q and dO as B, as the forward reads Q and K), then dV += P^T dO and
//   dK += dS^T Q with P^T and dS^T taken from the accumulators into A
//   fragments in registers (as the forward's P) and dO and q read with
//   ldmatrix.trans (as the forward's V).  The q and dO tiles, with their
//   LSE and D, arrive by cp.async into a two-stage ring.
// - dQ: each warp owns 16 folded q rows, computes S = Q K^T and dP = dO V^T
//   over a 64-key tile and dQ += dS K, K read with ldmatrix.trans; the K
//   and V tiles arrive by cp.async into a two-stage ring.
// - 128 threads, at most 256 registers, 102 KiB of shared memory at hd
//   120/128: two blocks to an SM.
// - What still bounds it: mma.sync, not wgmma, and the exponentials
//   recomputed in both kernels; wgmma fed by TMA is the next step.
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
// the backward in bf16 on the tensor cores
// ---------------------------------------------------------------------------

// A fragments (16 x 16, k = columns 16 kk .. 16 kk + 15) of an accumulator
// tile c[8][4] (16 rows x 64 columns), rounded to bf16: the forward's P
__device__ __forceinline__ void acc_to_a(const float (&c)[8][4], int kk,
                                         uint32_t (&a)[4]) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// c[8][4] (16 rows x 64 columns) += A (16 rows x HDP, rows at a_row, read
// with ldmatrix) times B^T (64 rows x HDP at b_row, read with ldmatrix):
// the forward's S = Q K^T
template <int KS>
__device__ __forceinline__ void rows_times_rows(float (&c)[8][4],
                                                uint32_t a_row,
                                                uint32_t b_row, int str) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, a_row + kk * 32);
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      uint32_t b[4];
      ldmatrix_x4(b, b_row + 2 * (jp * 16 * str + kk * 16));
      mma_bf16(c[2 * jp], a, b[0], b[1]);
      mma_bf16(c[2 * jp + 1], a, b[2], b[3]);
    }
  }
}

// acc[2 KS][4] (16 rows x HDP) += c (16 rows x 64, as A fragments) times
// B (64 rows x HDP at b_row, read with ldmatrix.trans): the forward's PV
template <int KS>
__device__ __forceinline__ void acc_times_rows(float (&acc)[2 * KS][4],
                                               const float (&c)[8][4],
                                               uint32_t b_row, int str,
                                               int hd) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    acc_to_a(c, kk, a);
#pragma unroll
    for (int jp = 0; jp < KS; ++jp) {
      if (16 * jp >= hd) break;
      uint32_t b[4];
      ldmatrix_x4_trans(b, b_row + 2 * (kk * 16 * str + jp * 16));
      mma_bf16(acc[2 * jp], a, b[0], b[1]);
      if (16 * jp + 8 < hd) mma_bf16(acc[2 * jp + 1], a, b[2], b[3]);
    }
  }
}

// ldmatrix row addresses of a 16-row A block at row0, a B block read as
// rows (non-trans) and one read transposed, in a tile of stride str
__device__ __forceinline__ uint32_t a_addr(const __nv_bfloat16* t, int row0,
                                           int str, int lane) {
  return smem_u32(t + (row0 + (lane & 15)) * str + (lane >> 4) * 8);
}
__device__ __forceinline__ uint32_t b_addr(const __nv_bfloat16* t, int str,
                                           int lane) {
  return smem_u32(t + ((lane & 7) + ((lane >> 4) << 3)) * str
                  + ((lane >> 3) & 1) * 8);
}
__device__ __forceinline__ uint32_t bt_addr(const __nv_bfloat16* t, int str,
                                            int lane) {
  return smem_u32(t + ((lane & 7) + (((lane >> 3) & 1) << 3)) * str
                  + (lane >> 4) * 8);
}

// columns hd..16 KS of n tiles of 64 rows: never written by cp.async, read
// by products over the head dim (zeroing one side would let garbage times
// 0 poison the sum)
template <int KS>
__device__ __forceinline__ void zero_pad(__nv_bfloat16* t, int n, int hd,
                                         int tid) {
  constexpr int STR = 16 * KS + 8, TILE = kKeys * STR, CH = 2 * KS;
  const int pad = CH - hd / 8;
  for (int i = tid; i < n * kKeys * pad; i += kThreads) {
    const int r = i / pad;
    *reinterpret_cast<uint4*>(t + (r / kKeys) * TILE + (r % kKeys) * STR + hd
                              + 8 * (i % pad)) = make_uint4(0, 0, 0, 0);
  }
}

// 64 rows of hd bf16 from rows row0.. of a (rows, heads, hd) tensor at
// head h (rows past n zero-filled) into a tile, by cp.async
template <int KS>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          size_t base_row, int row0, int n,
                                          int heads, int h, int hd, int tid) {
  constexpr int STR = 16 * KS + 8, CH = 2 * KS;
  for (int i = tid; i < kKeys * CH; i += kThreads) {
    const int r = i / CH, d = (i % CH) * 8;
    if (d < hd) {
      const bool ok = row0 + r < n;
      const size_t off =
          ok ? ((base_row + row0 + r) * heads + h) * (size_t)hd + d : 0;
      cp_async16(dst + r * STR + d, src + off, ok);
    }
  }
}

template <int KS>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dkdv_mma_kernel(const __nv_bfloat16* __restrict__ qs,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const int* __restrict__ q_pos,
                          const int* __restrict__ k_pos,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int sq, int sk,
                          int nq, int nkv, int hd, int window, int chunk,
                          float softcap) {
  constexpr int STR = 16 * KS + 8;   // row stride (elements) in shared
  constexpr int TILE = kKeys * STR;
  const int gq = nq / nkv;
  const int c0 = blockIdx.x * kKeys;
  const int kh = blockIdx.y;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;                   // row in the mma fragment
  const int tig = lane & 3;                  // column pair in the fragment
  const int* kpos = k_pos + (size_t)bi * sk;
  const int* qpos = q_pos + (size_t)bi * sq;

  // K, V, then two stages of (q * scale) and of dO, then their LSE and D
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + TILE;
  __nv_bfloat16* qst = vs + TILE;
  __nv_bfloat16* ost = qst + 2 * TILE;
  float* lst = reinterpret_cast<float*>(ost + 2 * TILE);
  float* dst_ = lst + 2 * kKeys;

  zero_pad<KS>(ks, 6, hd, tid);
  load_rows<KS>(ks, k, (size_t)bi * sk, c0, sk, nkv, kh, hd, tid);
  load_rows<KS>(vs, v, (size_t)bi * sk, c0, sk, nkv, kh, hd, tid);
  cp_async_commit();

  const int n_qt = (sq + kKeys - 1) / kKeys;
  const int n_it = gq * n_qt;
  auto classify = [&](int it) {
    int qmin, qmax;
    tile_range(qpos, (it % n_qt) * kKeys, kKeys, sq, lane, qmin, qmax);
    return tile_class(kpos, c0, sk, qmin, qmax, window, chunk, lane);
  };
  auto load_q = [&](int it, int stage) {
    const int h = kh * gq + it / n_qt;
    const int t0 = (it % n_qt) * kKeys;
    load_rows<KS>(qst + stage * TILE, qs, (size_t)bi * sq, t0, sq, nq, h, hd,
                  tid);
    load_rows<KS>(ost + stage * TILE, dout, (size_t)bi * sq, t0, sq, nq, h,
                  hd, tid);
    // a query past sq gets LSE +inf: p = 0 without a mask
    for (int r = tid; r < kKeys; r += kThreads) {
      const int t = t0 + r;
      const size_t ri = ((size_t)bi * nq + h) * sq + t;
      lst[stage * kKeys + r] = t < sq ? lse[ri] : INFINITY;
      dst_[stage * kKeys + r] = t < sq ? delta[ri] : 0.f;
    }
  };

  int cur = 0, cls = 0;
  while (cur < n_it && (cls = classify(cur)) == 0) ++cur;
  if (cur < n_it) load_q(cur, 0);
  cp_async_commit();

  int kp[2];
  bool kok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = c0 + warp * 16 + g + 8 * h;
    kok[h] = c < sk;
    kp[h] = kok[h] ? kpos[c] : 0;
  }
  float gk[2 * KS][4], gv[2 * KS][4];
#pragma unroll
  for (int j = 0; j < 2 * KS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[j][e] = gv[j][e] = 0.f;

  int stage = 0;
  while (cur < n_it) {
    int nxt = cur + 1, ncls = 0;
    while (nxt < n_it && (ncls = classify(nxt)) == 0) ++nxt;
    cp_async_wait_all();
    // tile cur has landed for every thread, and every warp is done with
    // the stage that tile nxt overwrites
    __syncthreads();
    if (nxt < n_it) load_q(nxt, stage ^ 1);
    cp_async_commit();

    const __nv_bfloat16* qt = qst + stage * TILE;
    const __nv_bfloat16* ot = ost + stage * TILE;
    const float* lv = lst + stage * kKeys;
    const float* dv_ = dst_ + stage * kKeys;
    const int t0 = (cur % n_qt) * kKeys;

    // S^T = K q^T and dP^T = V dO^T: 16 key rows x 64 queries a warp
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    rows_times_rows<KS>(s, a_addr(ks, warp * 16, STR, lane),
                        b_addr(qt, STR, lane), STR);
    rows_times_rows<KS>(dp, a_addr(vs, warp * 16, STR, lane),
                        b_addr(ot, STR, lane), STR);

    // P^T into s, dS^T into dp: element (j, e) is key row g + 8 (e / 2),
    // query column 8 j + 2 tig + e % 2
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * tig + (e & 1);
        bool ok = true;
        if (cls == 1) {
          const int t = t0 + col;
          ok = kok[e >> 1] && t < sq
               && allowed(kp[e >> 1], __ldg(qpos + t), window, chunk);
        }
        p_ds(s[j][e], dp[j][e], lv[col], dv_[col], ok, softcap);
      }

    // dV += P^T dO, dK += dS^T q: dO and q read transposed
    acc_times_rows<KS>(gv, s, bt_addr(ot, STR, lane), STR, hd);
    acc_times_rows<KS>(gk, dp, bt_addr(qt, STR, lane), STR, hd);
    cur = nxt;
    cls = ncls;
    stage ^= 1;
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = c0 + warp * 16 + g + 8 * h;
    if (c >= sk) continue;
    const size_t off = (((size_t)bi * sk + c) * nkv + kh) * hd + 2 * tig;
#pragma unroll
    for (int j = 0; j < 2 * KS; ++j) {
      if (8 * j < hd) {
        *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * j) =
            __floats2bfloat162_rn(gk[j][2 * h], gk[j][2 * h + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * j) =
            __floats2bfloat162_rn(gv[j][2 * h], gv[j][2 * h + 1]);
      }
    }
  }
}

template <int KS>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ qs,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int* __restrict__ q_pos,
                        const int* __restrict__ k_pos,
                        __nv_bfloat16* __restrict__ dq, int sq, int sk,
                        int nq, int nkv, int hd, float scale, int window,
                        int chunk, float softcap) {
  constexpr int STR = 16 * KS + 8;
  constexpr int TILE = kKeys * STR;
  constexpr int CH = 2 * KS;
  const int gq = nq / nkv;
  const int bq = kRows / gq;                 // positions per q tile
  const int rows = bq * gq;                  // rows in use (<= kRows)
  const int t0 = (gridDim.x - 1 - blockIdx.x) * bq;
  const int kh = blockIdx.y;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int* kpos = k_pos + (size_t)bi * sk;
  const int* qpos = q_pos + (size_t)bi * sq;

  // (q * scale) and dO, folded; then two stages of K and of V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qt = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ot = qt + TILE;
  __nv_bfloat16* kst = ot + TILE;
  __nv_bfloat16* vst = kst + 2 * TILE;

  zero_pad<KS>(qt, 6, hd, tid);
  for (int i = tid; i < kRows * CH; i += kThreads) {
    const int r = i / CH, d = (i % CH) * 8;
    const int t = r / gq, hh = r - t * gq;
    if (d < hd) {
      const bool ok = r < rows && t0 + t < sq;
      const size_t off =
          ok ? (((size_t)bi * sq + t0 + t) * nq + kh * gq + hh) * hd + d : 0;
      cp_async16(qt + r * STR + d, qs + off, ok);
      cp_async16(ot + r * STR + d, dout + off, ok);
    }
  }
  cp_async_commit();

  // this lane's rows g and g + 8: a row past the tile gets LSE +inf, so
  // p = 0 without a mask
  int rp[2];
  bool rok[2];
  float rl[2], rd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + g + 8 * h;
    const int t = r / gq, hh = r - t * gq;
    rok[h] = r < rows && t0 + t < sq;
    const size_t ri = ((size_t)bi * nq + kh * gq + hh) * sq + t0 + t;
    rp[h] = rok[h] ? qpos[t0 + t] : 0;
    rl[h] = rok[h] ? lse[ri] : INFINITY;
    rd[h] = rok[h] ? delta[ri] : 0.f;
  }
  int qmin, qmax;
  tile_range(qpos, t0, bq, sq, lane, qmin, qmax);

  const int n_tiles = (sk + kKeys - 1) / kKeys;
  auto load_kv = [&](int kt, int stage) {
    load_rows<KS>(kst + stage * TILE, k, (size_t)bi * sk, kt * kKeys, sk,
                  nkv, kh, hd, tid);
    load_rows<KS>(vst + stage * TILE, v, (size_t)bi * sk, kt * kKeys, sk,
                  nkv, kh, hd, tid);
  };
  int cur = 0, cls = 0;
  while (cur < n_tiles
         && (cls = tile_class(kpos, cur * kKeys, sk, qmin, qmax, window,
                              chunk, lane)) == 0)
    ++cur;
  if (cur < n_tiles) load_kv(cur, 0);
  cp_async_commit();

  float acc[2 * KS][4];
#pragma unroll
  for (int j = 0; j < 2 * KS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  int stage = 0;
  while (cur < n_tiles) {
    int nxt = cur + 1, ncls = 0;
    while (nxt < n_tiles
           && (ncls = tile_class(kpos, nxt * kKeys, sk, qmin, qmax, window,
                                 chunk, lane)) == 0)
      ++nxt;
    cp_async_wait_all();
    __syncthreads();
    if (nxt < n_tiles) load_kv(nxt, stage ^ 1);
    cp_async_commit();

    const __nv_bfloat16* kt = kst + stage * TILE;
    const __nv_bfloat16* vt = vst + stage * TILE;
    const int c0 = cur * kKeys;

    // S = q K^T and dP = dO V^T: 16 rows x 64 keys a warp
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    rows_times_rows<KS>(s, a_addr(qt, warp * 16, STR, lane),
                        b_addr(kt, STR, lane), STR);
    rows_times_rows<KS>(dp, a_addr(ot, warp * 16, STR, lane),
                        b_addr(vt, STR, lane), STR);

#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool ok = true;
        if (cls == 1) {
          const int c = c0 + 8 * j + 2 * tig + (e & 1);
          ok = rok[e >> 1] && c < sk
               && allowed(__ldg(kpos + c), rp[e >> 1], window, chunk);
        }
        p_ds(s[j][e], dp[j][e], rl[e >> 1], rd[e >> 1], ok, softcap);
      }

    // dQ += dS K: K read transposed
    acc_times_rows<KS>(acc, dp, bt_addr(kt, STR, lane), STR, hd);
    cur = nxt;
    cls = ncls;
    stage ^= 1;
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!rok[h]) continue;
    const int r = warp * 16 + g + 8 * h;
    const int t = r / gq, hh = r - t * gq;
    __nv_bfloat16* dst =
        dq + (((size_t)bi * sq + t0 + t) * nq + kh * gq + hh) * hd + 2 * tig;
#pragma unroll
    for (int j = 0; j < 2 * KS; ++j) {
      if (8 * j < hd)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(acc[j][2 * h] * scale,
                                  acc[j][2 * h + 1] * scale);
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

template <int KS>
cudaError_t launch_bwd_mma(const void* qs, const void* k, const void* v,
                           const float* lse, const void* dout,
                           const float* delta, const int* q_pos,
                           const int* k_pos, void* dq, void* dk, void* dv,
                           int b, int sq, int sk, int nq, int nkv, int hd,
                           float scale, int window, int chunk, float softcap,
                           cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const size_t tiles = (size_t)6 * kKeys * (16 * KS + 8) * sizeof(bf);
  const size_t smem_kv = tiles + 4 * kKeys * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkdv_mma_kernel<KS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (e != cudaSuccess) return e;
  flash_bwd_dkdv_mma_kernel<KS>
      <<<dim3((sk + kKeys - 1) / kKeys, nkv, b), kThreads, smem_kv,
          stream>>>(static_cast<const bf*>(qs), static_cast<const bf*>(k),
                    static_cast<const bf*>(v), static_cast<const bf*>(dout),
                    lse, delta, q_pos, k_pos, static_cast<bf*>(dk),
                    static_cast<bf*>(dv), sq, sk, nq, nkv, hd, window, chunk,
                    softcap);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(flash_bwd_dq_mma_kernel<KS>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)tiles);
  if (e != cudaSuccess) return e;
  const int bq = kRows / (nq / nkv);
  flash_bwd_dq_mma_kernel<KS>
      <<<dim3((sq + bq - 1) / bq, nkv, b), kThreads, tiles, stream>>>(
          static_cast<const bf*>(qs), static_cast<const bf*>(k),
          static_cast<const bf*>(v), static_cast<const bf*>(dout), lse, delta,
          q_pos, k_pos, static_cast<bf*>(dq), sq, sk, nq, nkv, hd, scale,
          window, chunk, softcap);
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
#define GO(KS)                                                               \
  case KS:                                                                   \
    return (int)launch_bwd_mma<KS>(qs, k, v, ls, dout, dl, qp, kp, dq, dk,   \
                                   dv, b, sq, sk, nq, nkv, hd, scale, window,\
                                   chunk, softcap, st)
  switch (max(2, (hd + 15) / 16)) {
    GO(2); GO(3); GO(4); GO(5); GO(6); GO(7); GO(8);
  }
#undef GO
  return (int)cudaErrorInvalidValue;
}

const char* flash_prefill_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
