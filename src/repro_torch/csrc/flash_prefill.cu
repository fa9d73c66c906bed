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

// x rounded to T's precision, as a float
__device__ __forceinline__ float round_as(float x, float) { return x; }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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
                     int sq, int sk, int nq, int nkv, int hd, float scale,
                     int window, int chunk, float softcap) {
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
  }
}

template <typename T, int NJ>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* q_pos, const int* k_pos, void* out, int b,
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
      static_cast<const T*>(v), q_pos, k_pos, static_cast<T*>(out), sq, sk,
      nq, nkv, hd, scale, window, chunk, softcap);
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
                         __nv_bfloat16* __restrict__ out, int sq, int sk,
                         int nq, int nkv, int hd, float scale, int window,
                         int chunk, float softcap) {
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
  }
#undef KV_ROW
#undef KPOS
#undef QPOS
}

template <int KS>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const int* q_pos, const int* k_pos, void* out, int b,
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
      static_cast<__nv_bfloat16*>(out), sq, sk, nq, nkv, hd, scale, window,
      chunk, softcap);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t as int (0 = launched).  dtype: 0 = f32, 1 = bf16
// (q, k, v and out alike).  window / chunk <= 0 and softcap <= 0 mean "no
// such mask".  nq must be a multiple of nkv with nq / nkv <= 64; hd <= 128,
// and for bf16 a multiple of 8 with q, k, v and out 16-byte aligned.
// scale is hd ** -0.5 rounded to the dtype, as the plain version has it.
int flash_prefill(const void* q, const void* k, const void* v,
                  const void* q_pos, const void* k_pos, void* out, int b,
                  int sq, int sk, int nq, int nkv, int hd, int dtype,
                  int window, int chunk, float scale, float softcap,
                  void* stream) {
  if (nkv <= 0 || nq % nkv || nq / nkv > kRows || hd <= 0 || hd > 128 ||
      b <= 0 || sq <= 0 || sk <= 0)
    return (int)cudaErrorInvalidValue;
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(k_pos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (hd <= 64)
      return (int)launch<float, 4>(q, k, v, qp, kp, out, b, sq, sk, nq, nkv,
                                   hd, scale, window, chunk, softcap, st);
    return (int)launch<float, 8>(q, k, v, qp, kp, out, b, sq, sk, nq, nkv,
                                 hd, scale, window, chunk, softcap, st);
  }
  if (dtype != 1 || hd % 8 ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
#define GO(KS)                                                               \
  case KS:                                                                   \
    return (int)launch_mma<KS>(q, k, v, qp, kp, out, b, sq, sk, nq, nkv, hd, \
                               scale, window, chunk, softcap, st)
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
