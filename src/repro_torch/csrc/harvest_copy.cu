// Harvest block movers: gather pool rows into a staging buffer, and copy
// pool rows straight into other pool rows.
//
// Replaces: repro/kernels/harvest_copy/kernel.py::harvest_gather (K6) and
// ::harvest_copy (K5), the Pallas kernels that move KV blocks between a
// pool and the tiers (gather on eviction, fused gather->scatter on reload
// and on the prefix cache's copy-on-write split).
//
// gather_rows: out[i] = src[ids[i]] for i < m, out's rows out_stride bytes
//              apart (the engine gathers k and v into the two halves of
//              one (L, 2, ...) payload).
// copy_rows:   dst[dst_ids[i]] = src[src_ids[i]] for i < m; every other row
//              of dst keeps its bytes (the Pallas kernel aliases its output
//              to the destination pool; here dst is written where it lies).
// Rows are opaque bytes, so any dtype moves bit for bit.  The caller has
// checked the ids (in range; for copy_rows, unique destinations and no
// row that is both read and written when src and dst are one pool).
//
// What bounds them on an H100: bytes.  Each moved row is read once and
// written once, so the floor is 2 * m * row_bytes over 3.35 TB/s; at the
// engine's sizes (one layer's block, 16 to 64 KiB, times the layers) that
// is under a microsecond, and the time is the launch and the round trips
// to device memory.
//
// Design of gather_rows: the Pallas grid is (rows, chunks of 512 elements),
// one step after another.  Here every (row, 8 KiB chunk) is its own thread
// block, all in flight at once, and each thread issues both of its loads
// (16-byte vectors where the row, the out stride and both base addresses
// allow, narrower ones otherwise) before either store: every load of the
// gather is in flight before any store, one DRAM round trip in all.  Ids
// the host holds ride in the launch, so the first load waits on no other.  On
// the engine's eviction shapes this beat bulk copies through shared memory
// by the copy engine (TMA) by about 0.1 us a call.
//
// Design of copy_rows: the Pallas grid is (rows, chunks of 512 elements),
// one step after another.  Here every (row, chunk) is its own thread block,
// all in flight at once, as in gather_rows: each thread issues all of its
// loads (up to four vectors, 16 down to 1 bytes as the row size and both
// base addresses allow, neighbouring threads on neighbouring addresses)
// before any of its stores.  The chunk shrinks until the rows fill a wave
// of blocks (one block per SM at least): 4 KiB at yi-6b's 16 KiB rows, 8
// KiB at qwen2-moe's and h2o-danube-3-4b's 60-64 KiB.  The (src, dst) id
// pairs of up to 128 rows ride in the launch (1 KiB of parameters, taken
// from the host arrays the engine holds): no id copy to the card, and no
// load between the launch and the row.  More rows read one device table
// of src ids then dst ids in the same kernel.  Loads before stores are
// safe with src and dst one pool because the caller refuses a row that is
// both read and written.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kIdsByValue = 128;       // rows whose ids may ride in the launch

// ---- copy_rows ----

constexpr int kCopyThreads = 256;
constexpr int kCopyUnroll = 4;         // vectors a thread may hold in flight

// (src, dst) row id pairs passed in the launch itself
struct RowPairs {
  int src[kIdsByValue];
  int dst[kIdsByValue];
};

// block (c, i) moves chunk c (kCopyThreads * unroll vectors) of row i,
// from src row ids[i] to dst row ids[m + i] (by_value's where ids is
// null): each thread loads its up to kCopyUnroll vectors before it stores
// any
template <typename V>
__global__ void __launch_bounds__(kCopyThreads)
copy_rows_kernel(const V* __restrict__ src, V* __restrict__ dst,
                 const int* __restrict__ ids,
                 const __grid_constant__ RowPairs by_value, int m,
                 int unroll, long long row_vecs) {
  const int i = blockIdx.y;
  const V* s = src + (long long)(ids ? ids[i] : by_value.src[i]) * row_vecs;
  V* o = dst + (long long)(ids ? ids[m + i] : by_value.dst[i]) * row_vecs;
  const long long lo = (long long)blockIdx.x * kCopyThreads * unroll
                       + threadIdx.x;
  V v[kCopyUnroll];
#pragma unroll
  for (int u = 0; u < kCopyUnroll; ++u) {
    const long long k = lo + (long long)u * kCopyThreads;
    if (u < unroll && k < row_vecs) v[u] = s[k];
  }
#pragma unroll
  for (int u = 0; u < kCopyUnroll; ++u) {
    const long long k = lo + (long long)u * kCopyThreads;
    if (u < unroll && k < row_vecs) o[k] = v[u];
  }
}

template <typename V>
int launch_copy(const void* src, void* dst, const int* ids,
                const RowPairs& by_value, int m, long long row_bytes,
                int sms, cudaStream_t st) {
  const long long row_vecs = row_bytes / (long long)sizeof(V);
  // the largest chunk whose blocks still fill a wave (at least one per SM)
  int unroll = kCopyUnroll;
  auto chunks = [&](int u) {
    const long long per_block = (long long)kCopyThreads * u;
    return (row_vecs + per_block - 1) / per_block;
  };
  while (unroll > 1 && chunks(unroll) * m < sms) unroll /= 2;
  if (chunks(unroll) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  copy_rows_kernel<V><<<dim3((unsigned)chunks(unroll), m), kCopyThreads, 0,
                        st>>>(
      static_cast<const V*>(src), static_cast<V*>(dst), ids, by_value, m,
      unroll, row_vecs);
  return (int)cudaGetLastError();
}

int copy_rows(const void* src, void* dst, const void* ids,
              const int* host_src_ids, const int* host_dst_ids, int m,
              long long row_bytes, int sms, void* stream) {
  if (m == 0 || row_bytes == 0) return 0;
  if (m > 65535) return (int)cudaErrorInvalidValue;   // grid.y limit
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* id = static_cast<const int*>(ids);
  RowPairs v = {};
  if (id == nullptr) {
    if (host_src_ids == nullptr || host_dst_ids == nullptr
        || m > kIdsByValue)
      return (int)cudaErrorInvalidValue;
    for (int r = 0; r < m; ++r) {
      v.src[r] = host_src_ids[r];
      v.dst[r] = host_dst_ids[r];
    }
  }
  // the widest vector that divides the row and both base addresses
  const uintptr_t align = (uintptr_t)src | (uintptr_t)dst
                          | (uintptr_t)row_bytes;
  if (align % 16 == 0)
    return launch_copy<uint4>(src, dst, id, v, m, row_bytes, sms, st);
  if (align % 8 == 0)
    return launch_copy<uint2>(src, dst, id, v, m, row_bytes, sms, st);
  if (align % 4 == 0)
    return launch_copy<uint32_t>(src, dst, id, v, m, row_bytes, sms, st);
  if (align % 2 == 0)
    return launch_copy<uint16_t>(src, dst, id, v, m, row_bytes, sms, st);
  return launch_copy<uint8_t>(src, dst, id, v, m, row_bytes, sms, st);
}

// ---- gather_rows ----

constexpr int kGatherThreads = 256;
constexpr int kGatherUnroll = 2;       // vectors a thread holds in flight

// row ids passed in the launch itself, for rows whose ids the host holds:
// no load stands between the launch and the row's first bytes
struct RowIds {
  int id[kIdsByValue];
};

// block (c, i) moves chunk c of row ids[i] (by_value.id[i] where ids is
// null): each thread loads its kGatherUnroll vectors before it stores any
template <typename V>
__global__ void __launch_bounds__(kGatherThreads)
gather_rows_kernel(const V* __restrict__ src, V* __restrict__ out,
                   const int* __restrict__ ids,
                   const __grid_constant__ RowIds by_value,
                   long long row_vecs, long long out_stride) {
  const int i = blockIdx.y;
  const V* s = src + (long long)(ids ? ids[i] : by_value.id[i]) * row_vecs;
  V* o = out + (long long)i * out_stride;
  const long long lo = (long long)blockIdx.x * kGatherThreads * kGatherUnroll
                       + threadIdx.x;
  V v[kGatherUnroll];
#pragma unroll
  for (int u = 0; u < kGatherUnroll; ++u) {
    const long long k = lo + (long long)u * kGatherThreads;
    if (k < row_vecs) v[u] = s[k];
  }
#pragma unroll
  for (int u = 0; u < kGatherUnroll; ++u) {
    const long long k = lo + (long long)u * kGatherThreads;
    if (k < row_vecs) o[k] = v[u];
  }
}

template <typename V>
int launch_gather(const void* src, void* out, const int* ids,
                  const RowIds& by_value, int m, long long row_bytes,
                  long long out_stride, cudaStream_t st) {
  const long long row_vecs = row_bytes / (long long)sizeof(V);
  const long long per_block = (long long)kGatherThreads * kGatherUnroll;
  const long long chunks = (row_vecs + per_block - 1) / per_block;
  if (chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  gather_rows_kernel<V><<<dim3((unsigned)chunks, m), kGatherThreads, 0,
                          st>>>(
      static_cast<const V*>(src), static_cast<V*>(out), ids, by_value,
      row_vecs, out_stride / (long long)sizeof(V));
  return (int)cudaGetLastError();
}

int gather_rows(const void* src, const void* ids, const int* host_ids,
                void* out, int m, long long row_bytes, long long out_stride,
                void* stream) {
  if (m == 0 || row_bytes == 0) return 0;
  if (m > 65535) return (int)cudaErrorInvalidValue;   // grid.y limit
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* id = static_cast<const int*>(ids);
  RowIds v = {};
  if (id == nullptr) {
    if (host_ids == nullptr || m > kIdsByValue)
      return (int)cudaErrorInvalidValue;
    for (int r = 0; r < m; ++r) v.id[r] = host_ids[r];
  }
  // the widest vector that divides the row, the out stride and both bases
  const uintptr_t align = (uintptr_t)src | (uintptr_t)out
                          | (uintptr_t)row_bytes | (uintptr_t)out_stride;
  if (align % 16 == 0)
    return launch_gather<uint4>(src, out, id, v, m, row_bytes, out_stride, st);
  if (align % 8 == 0)
    return launch_gather<uint2>(src, out, id, v, m, row_bytes, out_stride, st);
  if (align % 4 == 0)
    return launch_gather<uint32_t>(src, out, id, v, m, row_bytes, out_stride,
                                   st);
  if (align % 2 == 0)
    return launch_gather<uint16_t>(src, out, id, v, m, row_bytes, out_stride,
                                   st);
  return launch_gather<uint8_t>(src, out, id, v, m, row_bytes, out_stride, st);
}

}  // namespace

extern "C" {

// src (n_src, row_bytes) bytes; ids (m,) int32 in range on the device,
// or null with host_ids (m <= 128 ids in host memory) passed in the launch
// instead; out m rows of row_bytes, out_stride bytes apart (out_stride >=
// row_bytes).  Returns a cudaError_t as int.
int harvest_gather_rows(const void* src, const void* ids,
                        const int* host_ids, void* out, int m,
                        long long row_bytes, long long out_stride,
                        void* stream) {
  return gather_rows(src, ids, host_ids, out, m, row_bytes, out_stride,
                     stream);
}

// dst rows dst_ids[i] <- src rows src_ids[i] for i < m: ids (2m,) int32
// on the device, the m src ids then the m dst ids, or null with
// host_src_ids and host_dst_ids (m <= 128 each, in host memory) passed in
// the launch instead; ids in range, destinations unique, and no
// destination row among the sources when src == dst; sms the card's SM
// count (the chunk is sized to fill a wave).  Returns a cudaError_t as
// int.
int harvest_copy_rows(const void* src, void* dst, const void* ids,
                      const int* host_src_ids, const int* host_dst_ids,
                      int m, long long row_bytes, int sms, void* stream) {
  return copy_rows(src, dst, ids, host_src_ids, host_dst_ids, m, row_bytes,
                   sms, stream);
}

const char* harvest_copy_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
