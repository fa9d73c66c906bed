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
// all in flight at once: a chunk is 16 KiB, moved in the widest vector (16
// down to 1 bytes) that the row size and both base addresses allow,
// neighbouring threads on neighbouring addresses.  A block reads its row id
// itself (the TPU kernel's scalar prefetch).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunkBytes = 16 * 1024;

template <typename V>
__global__ void __launch_bounds__(kThreads)
copy_rows_kernel(const V* __restrict__ src, V* __restrict__ dst,
                 const int* __restrict__ src_ids,
                 const int* __restrict__ dst_ids, long long row_vecs,
                 long long chunk_vecs) {
  const int i = blockIdx.y;
  const V* s = src + (long long)src_ids[i] * row_vecs;
  V* o = dst + (long long)(dst_ids ? dst_ids[i] : i) * row_vecs;
  const long long lo = (long long)blockIdx.x * chunk_vecs;
  const long long hi = lo + chunk_vecs < row_vecs ? lo + chunk_vecs : row_vecs;
  for (long long v = lo + threadIdx.x; v < hi; v += kThreads) o[v] = s[v];
}

template <typename V>
int launch(const void* src, void* dst, const int* src_ids,
           const int* dst_ids, int m, long long row_bytes,
           cudaStream_t st) {
  const long long row_vecs = row_bytes / (long long)sizeof(V);
  const long long chunk_vecs = kChunkBytes / (long long)sizeof(V);
  const long long chunks = (row_vecs + chunk_vecs - 1) / chunk_vecs;
  if (chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  copy_rows_kernel<V><<<dim3((unsigned)chunks, m), kThreads, 0, st>>>(
      static_cast<const V*>(src), static_cast<V*>(dst), src_ids, dst_ids,
      row_vecs, chunk_vecs);
  return (int)cudaGetLastError();
}

int copy_rows(const void* src, void* dst, const void* src_ids,
              const void* dst_ids, int m, long long row_bytes, void* stream) {
  if (m == 0 || row_bytes == 0) return 0;
  if (m > 65535) return (int)cudaErrorInvalidValue;   // grid.y limit
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sid = static_cast<const int*>(src_ids);
  const int* did = static_cast<const int*>(dst_ids);
  // the widest vector that divides the row and both base addresses
  const uintptr_t align = (uintptr_t)src | (uintptr_t)dst
                          | (uintptr_t)row_bytes;
  if (align % 16 == 0) return launch<uint4>(src, dst, sid, did, m, row_bytes,
                                            st);
  if (align % 8 == 0) return launch<uint2>(src, dst, sid, did, m, row_bytes,
                                           st);
  if (align % 4 == 0) return launch<uint32_t>(src, dst, sid, did, m,
                                              row_bytes, st);
  if (align % 2 == 0) return launch<uint16_t>(src, dst, sid, did, m,
                                              row_bytes, st);
  return launch<uint8_t>(src, dst, sid, did, m, row_bytes, st);
}

// ---- gather_rows ----

constexpr int kGatherThreads = 256;
constexpr int kGatherUnroll = 2;       // vectors a thread holds in flight
constexpr int kIdsByValue = 128;       // rows whose ids may ride in the launch

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

// dst rows dst_ids[i] <- src rows src_ids[i]; ids in range, destinations
// unique, and no destination row among the sources when src == dst.
int harvest_copy_rows(const void* src, void* dst, const void* src_ids,
                      const void* dst_ids, int m, long long row_bytes,
                      void* stream) {
  return copy_rows(src, dst, src_ids, dst_ids, m, row_bytes, stream);
}

const char* harvest_copy_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
