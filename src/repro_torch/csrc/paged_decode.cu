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
// What bounds it on an H100: bytes.  Each live position's k and v rows are
// read once (hd * 4 B per kv head each), against 4 * gq * hd flops: about
// gq / 2 flops per byte, far below the ~20 flop/byte at which the card's
// f32 rate (67 TFLOP/s) would take over from 3.35 TB/s.  So the design
// keeps many rows' loads in flight on every SM and reads nothing twice.
//
// Design:
// - The grid is (split, kv head, request).  The host picks the split count
//   from the pool's shape and the card's SM count alone (no value is read
//   back from the device), so that a long context fills the card with
//   about one wave of 4 blocks per SM: at 2 requests x 8 kv heads over 800
//   slots, 33 splits.  It does not grow with the pool.
// - Each block lists the slots its request owns and whose positions meet
//   the allowed interval [lo, q_pos] (causal, window, chunk), in slot
//   order, so every block of the request agrees on the list, and keeps its
//   contiguous share of that list in shared memory.  Slots wholly outside
//   the window are never read.  The list comes from a bitmap of the
//   request's live slots, one bit a slot:
//   - a table of at most kChunk slots: the block builds it by ballots;
//   - a larger one: a pre-pass builds every request's row (one thread per
//     slot, the table read once), and each block reads only its request's
//     row, 1/32 of the table's bytes, however many splits there are.
//   Each warp counts a contiguous range of the row's words; their counts
//   place every warp's slots in the list (one barrier).  A share past
//   kListCap slots is taken in rounds.
// - Each warp takes units of P positions of a slot in turn and keeps its own
//   online-softmax state (m, l, acc) for the gq query rows: no barrier per
//   slot.  A lane holds 4 of the hd columns (hd <= 128, a multiple of 4)
//   and reads k and v rows as 16-byte float4 loads, the P rows' k and v
//   loads issued together.  The GQA group is a runtime gq <= GP, the
//   register arrays sized by GP = gq rounded up to a power of two; rows
//   past gq hold zero queries and are not written.
// - The warps merge by LSE once, through shared memory.  With one split the
//   block writes the final partials; with more, each writes its split's
//   partials to a workspace and a second small kernel merges them by LSE,
//   one block per (request, kv head, q row), its warps taking the splits
//   in turn.
// - A request with no valid position ends with m = -1e30, l = 0, acc = 0.
// - f32 FMA throughout: the pools are f32 and the work is far under the
//   card's f32 rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 1024;     // a table this small is listed in-kernel
constexpr int kChunkWords = kChunk / 32;
constexpr int kListCap = 1024;   // slots one block lists at a time
constexpr int kBitsThreads = 256;
constexpr unsigned kAll = 0xffffffffu;
constexpr float kNegInf = -1e30f;

// the lowest position request r may attend to (causal, window, chunk)
__device__ __forceinline__ int lowest_pos(int qp, int window, int chunk) {
  int lo = 0;
  if (window > 0) lo = max(lo, qp - window + 1);
  if (chunk > 0 && qp >= 0) lo = max(lo, (qp / chunk) * chunk);
  return lo;
}

// a slot at base holds an allowed position of [lo, qp]
__device__ __forceinline__ bool slot_live(int base, int bs, int lo, int qp) {
  return base <= qp && base + bs - 1 >= lo;
}

// Pre-pass for a table of more than kChunk slots: bit j of bits[r, w]
// marks slot 32 w + j as a live slot of request r.  The rows start zeroed;
// one thread per slot, and the first lane of each request's lanes in a
// warp writes the request's word.
__global__ void __launch_bounds__(kBitsThreads)
live_bits_kernel(const int* __restrict__ slot_req,
                 const int* __restrict__ slot_base,
                 const int* __restrict__ q_pos, unsigned* __restrict__ bits,
                 int b, int n_slots, int n_words, int bs, int window,
                 int chunk) {
  const int n = blockIdx.x * kBitsThreads + threadIdx.x;
  int key = -1;
  if (n < n_slots) {
    const int r = __ldg(slot_req + n);
    if (r >= 0 && r < b) {
      const int qp = __ldg(q_pos + r);
      if (slot_live(__ldg(slot_base + n), bs, lowest_pos(qp, window, chunk),
                    qp))
        key = r;
    }
  }
  const unsigned peers = __match_any_sync(kAll, key);
  if (key >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1)
    bits[(size_t)key * n_words + (n >> 5)] = peers;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ float4 axpy4(float a, float4 x, float4 y) {
  return make_float4(fmaf(a, x.x, y.x), fmaf(a, x.y, y.y), fmaf(a, x.z, y.z),
                     fmaf(a, x.w, y.w));
}

__device__ __forceinline__ float4 scale4(float a, float4 x) {
  return make_float4(a * x.x, a * x.y, a * x.z, a * x.w);
}

// GP: register rows (gq rounded up to a power of two); P: positions per
// unit of a warp's work, so that 2 * P rows' loads are in flight at once
template <int GP, int P>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const float* __restrict__ q,
                   const float* __restrict__ pool_k,
                   const float* __restrict__ pool_v,
                   const int* __restrict__ slot_req,
                   const int* __restrict__ slot_base,
                   const int* __restrict__ q_pos,
                   const unsigned* __restrict__ bits,
                   float* __restrict__ m_out, float* __restrict__ l_out,
                   float* __restrict__ acc_out, int nq, int nkv, int gq,
                   int hd, int n_slots, int bs, float scale, int window,
                   int chunk, float softcap) {
  const int split = blockIdx.x, kh = blockIdx.y, r = blockIdx.z;
  const int splits = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  __shared__ int list_slot[kListCap];
  __shared__ unsigned chunk_words[kChunkWords];
  __shared__ int warp_count[kWarps];
  extern __shared__ float wsm[];   // per warp: m, l (GP each), acc (GP, hd)

  // the allowed positions of this request: [lo, qp]
  const int qp = q_pos[r];
  const int lo = lowest_pos(qp, window, chunk);

  // 1. the request's live slots as a bitmap of n_words words: the
  //    pre-pass's row, or (a table of one chunk) built here by ballots
  const int n_words = (n_slots + 31) >> 5;
  const unsigned* words = chunk_words;
  if (bits) {
    words = bits + (size_t)r * n_words;
  } else {
#pragma unroll
    for (int i = 0; i < kChunkWords / kWarps; ++i) {
      const int w = warp * (kChunkWords / kWarps) + i;
      const int n = w * 32 + lane;
      const unsigned word = __ballot_sync(
          kAll, n < n_slots && __ldg(slot_req + n) == r
                    && slot_live(__ldg(slot_base + n), bs, lo, qp));
      if (lane == 0) chunk_words[w] = word;
    }
    __syncwarp();                        // a warp reads back its own words
  }
  // each warp counts the live slots of its contiguous range of words (the
  // ones it built, with one chunk); in slot order, its first has rank
  // `first` in the request's list
  const int per_warp = bits ? (n_words + kWarps - 1) / kWarps
                            : kChunkWords / kWarps;
  const int w0 = min(n_words, warp * per_warp);
  const int w1 = min(n_words, w0 + per_warp);
  int mine = 0;
  for (int w = w0 + lane; w < w1; w += 32) mine += __popc(words[w]);
  mine = __reduce_add_sync(kAll, mine);
  if (lane == 0) warp_count[warp] = mine;
  __syncthreads();
  int first = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) first += warp_count[w];
    total += warp_count[w];
  }
  // this split's share [s_lo, s_hi) of the list
  const int s_lo = (int)((long long)total * split / splits);
  const int s_hi = (int)((long long)total * (split + 1) / splits);

  // the warp's online-softmax state over the gq rows
  const int nv = hd >> 2;               // float4 columns of a row
  const bool col = lane < nv;
  float4 qv[GP], acc[GP];
  float m[GP], l[GP];
  const float* qr = q + ((size_t)r * nq + (size_t)kh * gq) * hd;
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    qv[g] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (g < gq && col)
      qv[g] = scale4(scale, __ldg(reinterpret_cast<const float4*>(
                                qr + (size_t)g * hd) + lane));
    acc[g] = make_float4(0.f, 0.f, 0.f, 0.f);
    m[g] = kNegInf;
    l[g] = 0.f;
  }
  const size_t row = (size_t)nkv * hd;   // one position of one slot
  const int per_slot = (bs + P - 1) / P;

  // 3. fold the listed slots into the warps' states, units of P positions
  auto attend = [&](int n_list) {
    const int units = n_list * per_slot;
    for (int u = warp; u < units; u += kWarps) {
      const int j = u / per_slot;
      const int t0 = (u - j * per_slot) * P;
      // the slot's rows are read whole, its base beside them: rows
      // outside [lo, qp] (only in a request's first and last listed
      // slots) are masked below
      const int n = list_slot[j];
      const int base = __ldg(slot_base + n);
      const float4* kr = reinterpret_cast<const float4*>(
          pool_k + ((size_t)n * bs + t0) * row + (size_t)kh * hd) + lane;
      const float4* vr = reinterpret_cast<const float4*>(
          pool_v + ((size_t)n * bs + t0) * row + (size_t)kh * hd) + lane;
      float4 kx[P], vx[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        kx[p] = vx[p] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (t0 + p < bs && col) {
          kx[p] = __ldg(kr + p * (row >> 2));
          vx[p] = __ldg(vr + p * (row >> 2));
        }
      }
      bool ok[P];
      bool any = false;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int pos = base + t0 + p;
        ok[p] = t0 + p < bs && pos >= lo && pos <= qp;
        any |= ok[p];
      }
      if (!any) continue;                // the same for the whole warp
      float s[P][GP];
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          float v = warp_sum(dot4(qv[g], kx[p]));
          if (softcap > 0.f) v = softcap * tanhf(v / softcap);
          s[p][g] = v;
        }
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        float mx = m[g];
#pragma unroll
        for (int p = 0; p < P; ++p)
          if (ok[p]) mx = fmaxf(mx, s[p][g]);
        const float corr = expf(m[g] - mx);
        float sum = 0.f;
        float4 a = scale4(corr, acc[g]);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const float pr = ok[p] ? expf(s[p][g] - mx) : 0.f;
          sum += pr;
          a = axpy4(pr, vx[p], a);
        }
        acc[g] = a;
        l[g] = l[g] * corr + sum;
        m[g] = mx;
      }
    }
  };

  // 2. list the share in rounds of at most kListCap slots, each folded
  //    in by step 3: a warp whose range holds part of the round takes its
  //    words 32 at a time, ranks them by a prefix of their counts, and
  //    each lane places its bit of every word that is not zero
  for (int round_lo = s_lo; round_lo < s_hi; round_lo += kListCap) {
    const int round_hi = min(s_hi, round_lo + kListCap);
    if (first < round_hi && first + mine > round_lo) {
      int k = first;                     // rank of the batch's first slot
      unsigned next = w0 + lane < w1 ? words[w0 + lane] : 0u;
      for (int wb = w0; wb < w1 && k < round_hi; wb += 32) {
        const unsigned word = next;
        next = wb + 32 + lane < w1 ? words[wb + 32 + lane] : 0u;
        const int pc = __popc(word);
        int incl = pc;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int v = __shfl_up_sync(kAll, incl, o);
          if (lane >= o) incl += v;
        }
        if (k + __shfl_sync(kAll, incl, 31) > round_lo) {
          for (unsigned nz = __ballot_sync(kAll, word != 0u); nz;
               nz &= nz - 1) {
            const int j = __ffs(nz) - 1;
            const unsigned wj = __shfl_sync(kAll, word, j);
            const int kk = k + __shfl_sync(kAll, incl - pc, j)
                           + __popc(wj & ((1u << lane) - 1u));
            if ((wj >> lane & 1u) && kk >= round_lo && kk < round_hi)
              list_slot[kk - round_lo] = (wb + j) * 32 + lane;
          }
        }
        k += __shfl_sync(kAll, incl, 31);
      }
    }
    __syncthreads();
    attend(round_hi - round_lo);
    __syncthreads();
  }

  // 4. merge the warps' states by LSE
  float* wm = wsm;                        // (kWarps, GP)
  float* wl = wm + kWarps * GP;           // (kWarps, GP)
  float* wa = wl + kWarps * GP;           // (kWarps, GP, hd)
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    if (lane == 0) {
      wm[warp * GP + g] = m[g];
      wl[warp * GP + g] = l[g];
    }
    if (col)
      reinterpret_cast<float4*>(wa + (size_t)(warp * GP + g) * hd)[lane] =
          acc[g];
  }
  __syncthreads();
  // row (request, kv head, split, g) of the outputs: the final partials
  // when splits == 1, else this split's row of the workspace
  const size_t out_row = (((size_t)r * nkv + kh) * splits + split) * gq;
  for (int i = tid; i < gq * nv; i += kThreads) {
    const int g = i / nv, c = i - g * nv;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * GP + g]);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      a = axpy4(expf(wm[w * GP + g] - mx),
                reinterpret_cast<const float4*>(
                    wa + (size_t)(w * GP + g) * hd)[c], a);
    reinterpret_cast<float4*>(acc_out + (out_row + g) * hd)[c] = a;
    if (c == 0) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        sum += wl[w * GP + g] * expf(wm[w * GP + g] - mx);
      m_out[out_row + g] = mx;
      l_out[out_row + g] = sum;
    }
  }
}

// Merge the splits' partials of one (request, kv head, q row g) by LSE:
// the warps take the splits in turn (a lane holds 4 hd columns), then add
// their sums through shared memory.
constexpr int kMergeWarps = 8;

__global__ void __launch_bounds__(32 * kMergeWarps)
merge_splits_kernel(const float* __restrict__ wm, const float* __restrict__ wl,
                    const float* __restrict__ wacc, float* __restrict__ m_out,
                    float* __restrict__ l_out, float* __restrict__ acc_out,
                    int gq, int hd, int splits) {
  const size_t rk = blockIdx.x;          // request * nkv + kv head
  const int g = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool col = lane < (hd >> 2);
  const float* mrow = wm + rk * splits * gq + g;
  float mx = kNegInf;
  for (int s = lane; s < splits; s += 32)
    mx = fmaxf(mx, mrow[(size_t)s * gq]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  float sum = 0.f;
#pragma unroll 4
  for (int s = warp; s < splits; s += kMergeWarps) {
    const size_t at = (rk * splits + s) * gq + g;
    const float c = expf(wm[at] - mx);
    if (col)
      a = axpy4(c, reinterpret_cast<const float4*>(wacc + at * hd)[lane], a);
    sum = fmaf(c, wl[at], sum);
  }
  __shared__ float4 part[kMergeWarps][32];
  __shared__ float part_l[kMergeWarps];
  part[warp][lane] = a;
  if (lane == 0) part_l[warp] = sum;
  __syncthreads();
  if (warp) return;
  a = part[0][lane];
  sum = part_l[0];
#pragma unroll
  for (int w = 1; w < kMergeWarps; ++w) {
    const float4 b = part[w][lane];
    a = make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
    sum += part_l[w];
  }
  if (col) reinterpret_cast<float4*>(acc_out + (rk * gq + g) * hd)[lane] = a;
  if (lane == 0) {
    m_out[rk * gq + g] = mx;
    l_out[rk * gq + g] = sum;
  }
}

// The workspace: the splits' partials (acc, then m and l; acc first so
// its float4 rows stay 16-byte aligned) when splits > 1, then the
// pre-pass's live-slot bitmap (b, n_words) when the table has more than
// kChunk slots.
size_t partials_floats(int b, int nkv, int gq, int hd, int splits) {
  return splits > 1 ? (size_t)(hd + 2) * b * nkv * splits * gq : 0;
}

size_t bits_words(int b, int n_slots) {
  return n_slots > kChunk ? (size_t)b * ((n_slots + 31) >> 5) : 0;
}

template <int GP, int P>
cudaError_t launch(const float* q, const float* pool_k, const float* pool_v,
                   const int* slot_req, const int* slot_base, const int* q_pos,
                   float* m_out, float* l_out, float* acc_out, float* work,
                   int b, int nq, int nkv, int hd, int n_slots, int bs,
                   int splits, float scale, int window, int chunk,
                   float softcap, cudaStream_t stream) {
  const int gq = nq / nkv;
  unsigned* bits = nullptr;
  if (const size_t words = bits_words(b, n_slots)) {
    bits = reinterpret_cast<unsigned*>(
        work + partials_floats(b, nkv, gq, hd, splits));
    cudaError_t err = cudaMemsetAsync(bits, 0, words * sizeof(unsigned),
                                      stream);
    if (err != cudaSuccess) return err;
    live_bits_kernel<<<(n_slots + kBitsThreads - 1) / kBitsThreads,
                       kBitsThreads, 0, stream>>>(
        slot_req, slot_base, q_pos, bits, b, n_slots, (n_slots + 31) >> 5,
        bs, window, chunk);
  }
  const size_t smem = (size_t)kWarps * GP * (hd + 2) * sizeof(float);
  // one split writes the partials; more write the workspace, then merge
  const size_t rows = (size_t)b * nkv * splits * gq;
  float* wa = splits == 1 ? acc_out : work;
  float* wm = splits == 1 ? m_out : work + rows * hd;
  float* wl = splits == 1 ? l_out : work + rows * (hd + 1);
  paged_split_kernel<GP, P><<<dim3(splits, nkv, b), kThreads, smem, stream>>>(
      q, pool_k, pool_v, slot_req, slot_base, q_pos, bits, wm, wl, wa, nq,
      nkv, gq, hd, n_slots, bs, scale, window, chunk, softcap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  merge_splits_kernel<<<dim3(b * nkv, gq), 32 * kMergeWarps, 0, stream>>>(
      wm, wl, wa, m_out, l_out, acc_out, gq, hd, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of the workspace paged_decode_partials takes (0: none).
size_t paged_decode_workspace_bytes(int b, int nkv, int gq, int hd,
                                    int n_slots, int splits) {
  return sizeof(float) * partials_floats(b, nkv, gq, hd, splits)
         + sizeof(unsigned) * bits_words(b, n_slots);
}

// Returns a cudaError_t as int (0 = launched).  window / chunk <= 0 and
// softcap <= 0 mean "no such mask".  gq = nq / nkv from 1 to 16; hd a
// multiple of 4 up to 128.  work: paged_decode_workspace_bytes(...)
// bytes, 16-byte aligned (may be null where that is 0).
int paged_decode_partials(const void* q, const void* pool_k,
                          const void* pool_v, const void* slot_req,
                          const void* slot_base, const void* q_pos,
                          void* m_out, void* l_out, void* acc_out, void* work,
                          int b, int nq, int nkv, int hd, int n_slots, int bs,
                          int splits, int window, int chunk, float scale,
                          float softcap, void* stream) {
  if (nkv <= 0 || nq % nkv || nq / nkv < 1 || nq / nkv > 16 || hd % 4
      || hd > 128 || hd <= 0 || splits < 1 || b > 65535 || nkv > 65535
      || (work == nullptr
          && paged_decode_workspace_bytes(b, nkv, nq / nkv, hd, n_slots,
                                          splits) > 0))
    return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(pool_k);
  const float* vf = static_cast<const float*>(pool_v);
  const int* sr = static_cast<const int*>(slot_req);
  const int* sb = static_cast<const int*>(slot_base);
  const int* qp = static_cast<const int*>(q_pos);
  float* mo = static_cast<float*>(m_out);
  float* lo = static_cast<float*>(l_out);
  float* ao = static_cast<float*>(acc_out);
  float* wk = static_cast<float*>(work);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int gq = nq / nkv;
#define LAUNCH(GP, P)                                                        \
  return (int)launch<GP, P>(qf, kf, vf, sr, sb, qp, mo, lo, ao, wk, b, nq,   \
                            nkv, hd, n_slots, bs, splits, scale, window,     \
                            chunk, softcap, st)
  if (gq == 1) LAUNCH(1, 4);
  if (gq == 2) LAUNCH(2, 4);
  if (gq <= 4) LAUNCH(4, 4);
  if (gq <= 8) LAUNCH(8, 2);
  LAUNCH(16, 1);
#undef LAUNCH
}

const char* paged_decode_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
