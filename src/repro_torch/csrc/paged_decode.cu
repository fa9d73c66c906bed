// Paged decode attention partials over one Harvest KV block pool.
//
// Replaces: repro/kernels/paged_attention/kernel.py::paged_attention (the
// Pallas kernel) and computes what repro/core/paged_attention.py::
// pool_partials computes in jnp on the decode path: one query token per
// request attends over the pool slots that request owns, GQA folded per kv
// head, and the kernel returns the flash-decode partials (m, l, acc) in f32
// so that partials of several pools (local + peer) still merge by LSE.
//
// Layout: the engine's *inverted* block table.  Slot n belongs to request
// slot_req[n] (-1 = free) and covers positions slot_base[n] + [0, bs).  The
// Pallas kernel chases a (b, max_blk) table and assumes block j starts at
// j * bs; here every slot carries its own base.
//
// What bounds it on an H100: bytes.  Each owned slot's k and v rows are read
// once (bs * hd * 4 B per kv head each), against 2 * gq * hd flops per row
// and row of v: about 1 flop per byte, far below the ~20 flop/byte at which
// the card's f32 rate (67 TFLOP/s) would take over from 3.35 TB/s.
//
// Design (simple first): one thread block per (request, kv head), 128
// threads.  The block walks the slot list and skips slots it does not own
// (a uniform branch).  For an owned slot, each warp scores some of its bs
// positions against the gq query rows held in shared memory (lanes stride
// over hd, a warp shuffle reduces), then every thread folds the slot into
// the online softmax of all gq rows and updates its own hd columns of the
// accumulator.  k and v rows are read with neighbouring threads on
// neighbouring addresses.  Free slots and masked positions add nothing; a
// request with no valid position ends with m = -1e30, l = 0, acc = 0.
// The slot scan costs O(n_slots) per block, which a later kernel can drop
// by taking a per-request slot list.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int GQ>
__global__ void __launch_bounds__(kThreads)
paged_partials_kernel(const float* __restrict__ q,
                      const float* __restrict__ pool_k,
                      const float* __restrict__ pool_v,
                      const int* __restrict__ slot_req,
                      const int* __restrict__ slot_base,
                      const int* __restrict__ q_pos,
                      float* __restrict__ m_out, float* __restrict__ l_out,
                      float* __restrict__ acc_out, int nq, int nkv, int hd,
                      int n_slots, int bs, float scale, int window,
                      int chunk, float softcap) {
  const int r = blockIdx.x;
  const int kh = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ float smem[];
  float* qs = smem;               // (GQ, hd) scaled queries
  float* acc = qs + GQ * hd;      // (GQ, hd) running numerators
  float* ps = acc + GQ * hd;      // (GQ, bs) scores, then probabilities
  int* valid = reinterpret_cast<int*>(ps + GQ * bs);  // (bs,)

  for (int i = tid; i < GQ * hd; i += kThreads) {
    const int g = i / hd, d = i - g * hd;
    qs[i] = q[((size_t)r * nq + (size_t)kh * GQ + g) * hd + d] * scale;
    acc[i] = 0.f;
  }
  float m[GQ], l[GQ];
#pragma unroll
  for (int g = 0; g < GQ; ++g) { m[g] = kNegInf; l[g] = 0.f; }
  const int qp = q_pos[r];
  __syncthreads();

  const size_t row = (size_t)nkv * hd;   // one position of one slot
  for (int n = 0; n < n_slots; ++n) {
    if (slot_req[n] != r) continue;     // same value for the whole block
    const int base = slot_base[n];
    const float* kslot = pool_k + (size_t)n * bs * row + (size_t)kh * hd;
    const float* vslot = pool_v + (size_t)n * bs * row + (size_t)kh * hd;

    for (int t = warp; t < bs; t += kWarps) {
      const int pos = base + t;
      bool ok = pos >= 0 && pos <= qp;
      if (window > 0) ok = ok && pos > qp - window;
      if (chunk > 0) ok = ok && (pos / chunk) == (qp / chunk);
      const float* krow = kslot + (size_t)t * row;
      float part[GQ];
#pragma unroll
      for (int g = 0; g < GQ; ++g) part[g] = 0.f;
      for (int d = lane; d < hd; d += 32) {
        const float kv = krow[d];
#pragma unroll
        for (int g = 0; g < GQ; ++g) part[g] += qs[g * hd + d] * kv;
      }
#pragma unroll
      for (int g = 0; g < GQ; ++g) {
        float s = warp_sum(part[g]);
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        if (lane == 0) ps[g * bs + t] = ok ? s : kNegInf;
      }
      if (lane == 0) valid[t] = ok;
    }
    __syncthreads();

    // online softmax: every thread keeps the same (m, l) of all GQ rows
    float corr[GQ];
#pragma unroll
    for (int g = 0; g < GQ; ++g) {
      float mx = m[g];
      for (int t = 0; t < bs; ++t) mx = fmaxf(mx, ps[g * bs + t]);
      corr[g] = expf(m[g] - mx);
      m[g] = mx;
    }
    __syncthreads();   // every thread has read the raw scores
    for (int i = tid; i < GQ * bs; i += kThreads) {
      const int g = i / bs, t = i - g * bs;
      ps[i] = valid[t] ? expf(ps[i] - m[g]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < GQ; ++g) {
      float sum = 0.f;
      for (int t = 0; t < bs; ++t) sum += ps[g * bs + t];
      l[g] = l[g] * corr[g] + sum;
    }
    for (int d = tid; d < hd; d += kThreads) {
      float a[GQ];
#pragma unroll
      for (int g = 0; g < GQ; ++g) a[g] = acc[g * hd + d] * corr[g];
      for (int t = 0; t < bs; ++t) {
        const float vv = vslot[(size_t)t * row + d];
#pragma unroll
        for (int g = 0; g < GQ; ++g) a[g] += ps[g * bs + t] * vv;
      }
#pragma unroll
      for (int g = 0; g < GQ; ++g) acc[g * hd + d] = a[g];
    }
    __syncthreads();   // ps and valid are rewritten by the next slot
  }

  const size_t head = ((size_t)r * nkv + kh) * GQ;
  if (tid < GQ) {
    m_out[head + tid] = m[tid];
    l_out[head + tid] = l[tid];
  }
  for (int i = tid; i < GQ * hd; i += kThreads) acc_out[head * hd + i] = acc[i];
}

template <int GQ>
cudaError_t launch(const float* q, const float* pool_k, const float* pool_v,
                   const int* slot_req, const int* slot_base, const int* q_pos,
                   float* m_out, float* l_out, float* acc_out, int b, int nq,
                   int nkv, int hd, int n_slots, int bs, float scale,
                   int window, int chunk, float softcap,
                   cudaStream_t stream) {
  const size_t smem = (size_t)(2 * GQ * hd + GQ * bs) * sizeof(float)
                      + (size_t)bs * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_partials_kernel<GQ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  paged_partials_kernel<GQ><<<dim3(b, nkv), kThreads, smem, stream>>>(
      q, pool_k, pool_v, slot_req, slot_base, q_pos, m_out, l_out, acc_out,
      nq, nkv, hd, n_slots, bs, scale, window, chunk, softcap);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t as int (0 = launched).  window / chunk <= 0 and
// softcap <= 0 mean "no such mask".  gq = nq / nkv must be 1, 2, 4, 8 or 16.
int paged_decode_partials(const void* q, const void* pool_k,
                          const void* pool_v, const void* slot_req,
                          const void* slot_base, const void* q_pos,
                          void* m_out, void* l_out, void* acc_out, int b,
                          int nq, int nkv, int hd, int n_slots, int bs,
                          int window, int chunk, float scale, float softcap,
                          void* stream) {
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(pool_k);
  const float* vf = static_cast<const float*>(pool_v);
  const int* sr = static_cast<const int*>(slot_req);
  const int* sb = static_cast<const int*>(slot_base);
  const int* qp = static_cast<const int*>(q_pos);
  float* mo = static_cast<float*>(m_out);
  float* lo = static_cast<float*>(l_out);
  float* ao = static_cast<float*>(acc_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nq / nkv) {
#define CASE(G)                                                              \
  case G:                                                                    \
    return (int)launch<G>(qf, kf, vf, sr, sb, qp, mo, lo, ao, b, nq, nkv,    \
                          hd, n_slots, bs, scale, window, chunk, softcap, st);
    CASE(1) CASE(2) CASE(4) CASE(8) CASE(16)
#undef CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* paged_decode_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
