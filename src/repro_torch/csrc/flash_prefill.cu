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
// flops per byte, far above the ~295 (bf16 tensor cores) or ~20 (f32
// CUDA cores) at which the card stops being memory-bound.
//
// Design (simple first; f32 FMA on CUDA cores, no tensor cores):
// - One thread block of 128 threads per (q tile, kv head, batch row).  The
//   GQA group is folded into the tile's 64 rows: row r is query head
//   kh * gq + r % gq at position t0 + r / gq, so one K/V tile in shared
//   memory serves every query head of its kv head, read by index from the
//   model layout (no repeated K/V in memory).
// - A loop over K/V tiles of 64 keys replaces the Pallas grid's sequential
//   kv axis.  Before loading a tile, every warp reduces the tile's key
//   positions to (min, max) and the block skips the tile when the mask
//   rejects every pair of it (keys all after the tile's last query, all
//   behind the window of its first, or in other attention chunks).  This
//   skips the causal upper triangle and everything behind the window.
// - Each thread owns 8 rows x 4 key columns of the score tile and 8 rows x
//   8 columns (stride 16) of the accumulator.  Q is kept transposed in
//   shared memory (rows contiguous, read as float4), K transposed with a
//   padded stride (conflict-free stores and loads), V row-major, and the
//   probabilities transposed in K's space once the scores are in
//   registers.  Rows of a score tile live in 16 neighbouring lanes, so the
//   row max and row sum are warp shuffles.
// - q tiles are scheduled longest first (reverse order), which evens out
//   the causal triangle's uneven work across the waves.
// Ragged sq, sk and hd (anything up to 128) are masked at the edges.

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
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
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
    int kmin = INT32_MAX, kmax = INT32_MIN;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + lane + 32 * h;
      if (c < sk) {
        const int p = k_pos[(size_t)bi * sk + c];
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
    if (skip) continue;

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

}  // namespace

extern "C" {

// Returns a cudaError_t as int (0 = launched).  dtype: 0 = f32, 1 = bf16
// (q, k, v and out alike).  window / chunk <= 0 and softcap <= 0 mean "no
// such mask".  nq must be a multiple of nkv with nq / nkv <= 64; hd <= 128.
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
  const bool narrow = hd <= 64;
#define GO(T, NJ)                                                            \
  return (int)launch<T, NJ>(q, k, v, qp, kp, out, b, sq, sk, nq, nkv, hd,    \
                            scale, window, chunk, softcap, st)
  if (dtype == 0) {
    if (narrow) GO(float, 4);
    GO(float, 8);
  }
  if (dtype == 1) {
    if (narrow) GO(__nv_bfloat16, 4);
    GO(__nv_bfloat16, 8);
  }
#undef GO
  return (int)cudaErrorInvalidValue;
}

const char* flash_prefill_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
