// Quantize-on-demote and dequantize-on-reload of Harvest KV blocks.
//
// Replaces: repro/kernels/harvest_copy/kernel.py::quantize_demote and
// ::dequantize_reload (the Pallas kernels the JAX engine calls on every
// quantized demotion).
//
// Pools are f32, bf16 or f16 (the Pallas kernels take any floating pool).
//
// quantize_demote: gather rows ids[i] of a pool (n_slots, elems), read each
// element as f32 (the Pallas kernel's astype), take each row's absmax
// scale (1 for an all-zero row) and quantize: int8 rounded half-to-even
// and clipped to +-127; fp8 e4m3fn; int4 clipped to +-7 and packed as
// two's-complement nibble pairs (an odd width pads a zero).  The values
// are bit-identical to the Pallas kernel as XLA compiles it: the scale is
// absmax times the f32 reciprocal of qmax, each element is divided by the
// scale in f32 and rounded with rintf, and fp8 takes a saturating e4m3
// conversion (the row is scaled to at most 448 plus a rounding step, where
// saturation and e4m3fn's own rounding agree).
//
// dequantize_reload: unpack and sign-extend, multiply by the scale in f32,
// round to the pool's type (round to nearest even, the Pallas kernel's
// astype) and write dst[ids[i]] in place; slots outside ids are never
// touched.
//
// What bounds them on an H100: bytes.  Each element is read and written
// once with a handful of integer and float operations, so the time floor is
// (4, or 2 for bf16 and f16, bytes of pool + 1 or 1/2 byte packed) per
// element over 3.35 TB/s.
//
// Design of quantize_demote: the Pallas kernel gives one grid step a whole
// row and keeps it in VMEM for both the absmax and the quantization.  Here
// one launch spreads the rows over the card, one block per SM (a row of
// 2.8 MiB gives each of 132 blocks a 22 KB slice).  A block brings its
// slice into shared memory once, all of it in flight together (TMA bulk
// copies, or 4-byte cp.async where an f32 slice is not 16-byte aligned and
// plain loads where a bf16 or f16 one is not), in four parts whose absmax
// it folds as each lands.  Shared memory holds the slice in the pool's own
// type: the bulk copy moves bytes as they are, a 2-byte pool's slice takes
// half the room (114,688 elements fit, against 57,344 of f32), and each
// element is converted to f32 where it is read, once for the absmax and
// once to quantize, exactly (every bf16 and f16 value is an f32 value).
// The blocks' maxima meet in one exchange through device memory (below: a
// slot per block, one block folding them, one word releasing the rest),
// and each block then quantizes its slice from shared memory with 4-byte
// stores, 128 contiguous bytes per warp.  One launch, one read of the row
// from device memory, no memset.  With more rows than half the SMs a block
// takes a whole row and needs no exchange.  A slice longer than the 224
// KiB a block keeps reads the rest from device memory again in the
// quantize phase: chosen by shape.  A thread block cluster of 16 would
// exchange through distributed shared memory instead, but it sits on one
// GPC, whose share of the memory system caps the read
// (tools/probe_k2_cluster.py).
//
// Design of dequantize_reload: the Pallas grid is one step per row, the
// whole row in VMEM.  Here every thread moves one 16-byte vector of packed
// values (16 int8 or fp8 weights, 32 int4) with one load, issued with the
// row's scale load before any store, and the weights leave as 16-byte
// stores (float4, or eight bf16 or f16).  A thread's own vector unpacks
// to 64 to 128 contiguous bytes, so a warp's stores would land 64 or more
// bytes apart; its 512 bytes of values pass through shared memory
// instead, and each store instruction writes 512 contiguous bytes
// (without it the kernel took 1.5x the time of a one-weight-a-thread
// kernel at qwen2-moe's block on an H100, tools/time_k3_k5.py).  Blocks
// of 128 threads take 2,048 (int8, fp8) or 4,096 (int4) weights for each
// vector a thread, up to four vectors a thread, all loaded before any
// store, as many as keep the blocks filling a wave: one at yi-6b's
// demoted block, two at qwen2-moe's and h2o-danube-3-4b's (int8), which
// beat 64 and 256 threads a block on an H100.  The fidelity and the
// pool's type are template parameters: no switch inside the loop.  Row
// ids of up to 128 rows ride in the launch (from the host mirror the
// engine holds), so no load stands between the launch and the values;
// more rows read a device table in the same kernel.  Rows whose packed values or
// destination do not start 16-byte aligned (an odd width, a row of 37, an
// unaligned base) take a narrower path of one weight per thread.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" int quantize_demote_blocks(int m, int sms);

namespace {

enum Fidelity { kInt8 = 0, kFp8 = 1, kInt4 = 2 };

// the pool's element type, as the wrappers name it
enum PoolType { kF32 = 0, kBf16 = 1, kF16 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// four consecutive elements (4-element aligned) as f32, in one load
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float qmax_of(int fid) {
  return fid == kInt8 ? 127.f : (fid == kFp8 ? 448.f : 7.f);
}

__device__ __forceinline__ int round_clip(float x, float lim) {
  return (int)fminf(fmaxf(rintf(x), -lim), lim);
}

constexpr int kQThreads = 512;
constexpr int kStages = 4;           // commit groups of a slice's loads
constexpr int kSliceAlign = 32;      // elements: 128-byte slices
constexpr int kMaxCachedBytes = 229376;   // of a slice kept on chip (224 KiB)
constexpr int kIdsByValue = 128;     // rows whose ids may ride in the launch

__device__ __forceinline__ void cp_async4(void* s, const void* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"((uint32_t)__cvta_generic_to_shared(s)), "l"(g)
               : "memory");
}

// wait until at most ``left`` of this thread's commit groups are in flight
__device__ __forceinline__ void cp_async_wait(int left) {
  switch (left) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// round_clip(x / scale, lim) for |x| <= the row's absmax, where lim <=
// 127 and inv = 1 / scale.  x * inv lies within 2.5 ulp (at most 2^-15
// here) of the true quotient, as the division does within half of one, so
// unless it lies within 2^-14 of a rounding boundary k + 1/2 both round to
// the same integer; there (and for an inf or NaN product) it divides.
__device__ __forceinline__ int quant_int(float x, float scale, float inv,
                                         float lim) {
  float y = x * inv;
  if (!(fabsf(y - floorf(y) - 0.5f) >= 0x1p-14f)) y = x / scale;
  return round_clip(y, lim);
}

// one output byte of int8 / fp8
__device__ __forceinline__ uint32_t quant8(float x, float scale, float inv,
                                           int fid) {
  return fid == kInt8
      ? (uint32_t)(uint8_t)(int8_t)quant_int(x, scale, inv, 127.f)
      : (uint32_t)__nv_cvt_float_to_fp8(x / scale, __NV_SATFINITE,
                                        __NV_E4M3);
}

// one int4 nibble pair, elements a (low) and b (high)
__device__ __forceinline__ uint32_t quant4(float a, float b, float scale,
                                           float inv) {
  return (uint32_t)((quant_int(a, scale, inv, 7.f) & 15)
                    | ((quant_int(b, scale, inv, 7.f) & 15) << 4));
}

// The row maxima's exchange across the grid, with no atomic and no second
// hop.  ``state`` (per stream, zeroed once) is u64 words: the epoch word at
// 0 and one slot per block from kSlotWords.  Every block reads the epoch at
// its start and stores (epoch + 1 << 32 | its max) into its slot; then one
// warp of every block reads all the slots (a load instruction covers 32)
// until each carries epoch + 1, folds its row's, and stores epoch + 1 into
// the epoch word for the next launch (by then every block of this one has
// read it).  A slot of an older launch carries an older epoch (a 32-bit
// epoch wraps after 2^32 launches on one stream).  Every block of the grid
// must be resident at once.
constexpr int kMaxGrid = 256;          // blocks of one launch, at most
constexpr int kSlotWords = 16;         // the slots start on their own line
constexpr int kStateWords = kSlotWords + kMaxGrid;

__device__ __forceinline__ uint64_t ld_relaxed(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];\n" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;\n" :: "l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ float warp_fold_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// row ids passed in the launch itself, for a few rows whose ids the host
// holds: no load stands between the launch and the row's first bytes
struct RowIds {
  int id[kIdsByValue];
};

// grid (blocks per row, m); row i is ids[i], or by_value.id[i] where ids
// is null.  With more than one block per row the blocks exchange their
// maxima through ``state``.  T is the pool's element type; the slice is
// held in shared memory as T.
template <typename T>
__global__ void __launch_bounds__(kQThreads)
quantize_rows_kernel(const T* __restrict__ src,
                     const int* __restrict__ ids,
                     const __grid_constant__ RowIds by_value,
                     int elems, int width, int fid, int slice, int cached,
                     uint64_t* __restrict__ state,
                     uint8_t* __restrict__ values,
                     float* __restrict__ scales) {
  extern __shared__ __align__(128) unsigned char sm_bytes[];
  T* sm = reinterpret_cast<T*>(sm_bytes);
  constexpr int kVec = 16 / (int)sizeof(T);  // elements of 16 bytes
  __shared__ float warp_max[kQThreads / 32];
  __shared__ float block_max;
  __shared__ __align__(8) uint64_t landed[kStages];
  const int tid = threadIdx.x, lane = tid & 31;
  const int i = blockIdx.y, nb = gridDim.x, rows = gridDim.y;
  const T* row = src + (size_t)(ids ? ids[i] : by_value.id[i]) * elems;
  const int lo = blockIdx.x * slice;
  const int hi = min(lo + slice, elems);
  const int n = max(hi - lo, 0);
  const int nc = min(n, cached);             // elements held on chip
  const T* g = row + lo;

  // 1. every load of the slice's cached part in flight, in kStages parts
  // of whole 16-byte vectors: TMA bulk copies on an mbarrier each where
  // the slice is 16-byte aligned (its length then is too, but for the
  // row's end); otherwise 4-byte cp.async in commit groups (f32) or plain
  // loads (bf16, f16)
  const int stage = ((nc + kStages - 1) / kStages + kVec - 1) & ~(kVec - 1);
  const bool bulk = (reinterpret_cast<uintptr_t>(g) & 15) == 0
                    && nc % kVec == 0;
  if (bulk) {
    if (tid == 0) {
      for (int s = 0; s < kStages; ++s)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                     :: "r"(smem_addr(&landed[s])) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      for (int s = 0; s < kStages; ++s) {
        const int a = min(s * stage, nc), b = min(a + stage, nc);
        const uint32_t bytes = (uint32_t)sizeof(T) * (uint32_t)(b - a);
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], "
                     "%1;\n" :: "r"(smem_addr(&landed[s])), "r"(bytes)
                     : "memory");
        if (bytes)
          asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::"
                       "complete_tx::bytes [%0], [%1], %2, [%3];\n"
                       :: "r"(smem_addr(sm + a)), "l"(g + a), "r"(bytes),
                          "r"(smem_addr(&landed[s])) : "memory");
      }
    }
  }
  // the last launch on this stream has ended, so a relaxed read finds its
  // epoch; read after the loads are issued (the mbarrier fence would wait
  // for it)
  uint32_t epoch = 0;
  if (nb > 1 && tid == 0)
    epoch = (uint32_t)(ld_relaxed(state) >> 32) + 1;
  if (bulk) {
    __syncthreads();                 // the mbarriers are initialised
  } else {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      const int a = min(s * stage, nc), b = min(a + stage, nc);
      for (int e = a + tid; e < b; e += kQThreads) {
        if constexpr (sizeof(T) == 4) cp_async4(sm + e, g + e);
        else sm[e] = g[e];
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
  }

  // 2. fold |x| into the block's maximum, each part as it lands; the part
  // past what shared memory holds straight from device memory
  float mx = 0.f;
  for (int s = 0; s < kStages; ++s) {
    if (bulk) {
      uint32_t done = 0;
      while (!done)
        asm volatile("{\n .reg .pred p;\n"
                     " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
                     "%2;\n selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(smem_addr(&landed[s])), "r"(0u)
                     : "memory");
    } else {
      cp_async_wait(kStages - 1 - s);
      __syncthreads();
    }
    const int a = min(s * stage, nc), b = min(a + stage, nc);
    const int quads = (b - a) >> 2;
    for (int q = tid; q < quads; q += kQThreads) {
      const float4 v = load4(sm + a + 4 * q);
      mx = fmaxf(mx, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                           fmaxf(fabsf(v.z), fabsf(v.w))));
    }
    for (int e = a + 4 * quads + tid; e < b; e += kQThreads)
      mx = fmaxf(mx, fabsf(to_f32(sm[e])));
  }
  for (int e = nc + tid; e < n; e += kQThreads)
    mx = fmaxf(mx, fabsf(to_f32(g[e])));
  mx = warp_fold_max(mx);
  if (lane == 0) warp_max[tid >> 5] = mx;
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kQThreads / 32; ++w) mx = fmaxf(mx, warp_max[w]);
    block_max = mx;
    if (nb > 1)     // the slot carries its own data: no fence needed
      st_relaxed(state + kSlotWords + i * nb + blockIdx.x,
                 (uint64_t)epoch << 32 | __float_as_uint(mx));
  }

  // 3. the row's maximum: one block holds it already; else the first warp
  // reads every slot, all of a lane's at once (the maxima travel in the
  // slots: relaxed loads suffice), until all are this launch's, and folds
  // its row's
  if (nb > 1 && tid < 32) {
    const uint32_t ep = __shfl_sync(0xffffffffu, epoch, 0);
    const int blocks = nb * rows;
    constexpr int kSlotPoll = kMaxGrid / 32;
    uint64_t v[kSlotPoll];
    for (;;) {
      bool all = true;
#pragma unroll
      for (int k = 0; k < kSlotPoll; ++k) {
        const int b = lane + 32 * k;
        v[k] = b < blocks ? ld_relaxed(state + kSlotWords + b)
                          : (uint64_t)ep << 32;
        all &= (uint32_t)(v[k] >> 32) == ep;
      }
      if (__all_sync(0xffffffffu, all)) break;
    }
    float x = 0.f;
#pragma unroll
    for (int k = 0; k < kSlotPoll; ++k) {
      const int b = lane + 32 * k;
      if (b < blocks && b / nb == i)
        x = fmaxf(x, __uint_as_float((uint32_t)v[k]));
    }
    x = warp_fold_max(x);
    if (lane == 0) {
      block_max = x;
      st_relaxed(state, (uint64_t)ep << 32);
    }
  }
  __syncthreads();
  const float am = block_max;

  // absmax times the f32 reciprocal of qmax: XLA compiles the JAX
  // kernel's division by a constant so, and the scales must match its bits
  const float scale = am == 0.f ? 1.f : am * (1.f / qmax_of(fid));
  if (lo == 0 && tid == 0) scales[i] = scale;
  const float inv = 1.f / scale;

  // 4. quantize: a group is the 4 output bytes of 4 elements (int8, fp8)
  // or 8 (int4); a whole group on chip, 4-byte aligned, is one store
  const bool i4 = fid == kInt4;
  const int per = i4 ? 8 : 4;
  const int groups = (n + per - 1) / per;
  const int out_lo = i4 ? lo / 2 : lo;
  const int out_hi = i4 ? (hi + 1) / 2 : hi;
  uint8_t* out = values + (size_t)i * width;
  for (int gi = tid; gi < groups; gi += kQThreads) {
    const int e0 = gi * per;                 // relative to lo
    const int o0 = out_lo + 4 * gi;
    uint32_t word = 0;
    if (e0 + per <= nc) {
      const float4 v = load4(sm + e0);
      if (i4) {
        const float4 w = load4(sm + e0 + 4);
        word = quant4(v.x, v.y, scale, inv)
               | quant4(v.z, v.w, scale, inv) << 8
               | quant4(w.x, w.y, scale, inv) << 16
               | quant4(w.z, w.w, scale, inv) << 24;
      } else {
        word = quant8(v.x, scale, inv, fid)
               | quant8(v.y, scale, inv, fid) << 8
               | quant8(v.z, scale, inv, fid) << 16
               | quant8(v.w, scale, inv, fid) << 24;
      }
    } else {
      // the slice's ragged end or its part past shared memory; int4 pads
      // the element past the row with zero
      for (int k = 0; k < 4; ++k) {
        if (i4) {
          const int e = e0 + 2 * k;
          const float a = e < nc ? to_f32(sm[e])
                                 : (e < n ? to_f32(g[e]) : 0.f);
          const float b = e + 1 < nc ? to_f32(sm[e + 1])
                                     : (e + 1 < n ? to_f32(g[e + 1]) : 0.f);
          word |= quant4(a, b, scale, inv) << (8 * k);
        } else {
          const int e = e0 + k;
          const float a = e < nc ? to_f32(sm[e])
                                 : (e < n ? to_f32(g[e]) : 0.f);
          word |= quant8(a, scale, inv, fid) << (8 * k);
        }
      }
    }
    uint8_t* o = out + o0;
    if (o0 + 4 <= out_hi && (reinterpret_cast<uintptr_t>(o) & 3) == 0) {
      *reinterpret_cast<uint32_t*>(o) = word;
    } else {
      for (int k = 0; k < 4 && o0 + k < out_hi; ++k)
        o[k] = (uint8_t)(word >> (8 * k));
    }
  }
}

// ---- dequantize_reload ----

constexpr int kDqThreads = 128;
constexpr int kDqUnroll = 4;         // vectors a thread may hold in flight

// f32 to the pool's type, round to nearest even
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

__device__ __forceinline__ uint32_t bits16(__nv_bfloat16 x) {
  return __bfloat16_as_ushort(x);
}
__device__ __forceinline__ uint32_t bits16(__half x) {
  return __half_as_ushort(x);
}

// one packed byte of int8 or fp8 as f32 (both exact)
template <int FID>
__device__ __forceinline__ float unpack8(uint32_t b) {
  if constexpr (FID == kInt8) {
    return (float)(int8_t)(uint8_t)b;
  } else {
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(
        (__nv_fp8_storage_t)b, __NV_E4M3)));
  }
}

// the low nibble of b, sign-extended, as f32
__device__ __forceinline__ float nibble(uint32_t b) {
  const int n = (int)(b & 15u);
  return (float)(n - 2 * (n & 8));
}

// N f32 (4 for f32, 8 for bf16 and f16) rounded to T and written as
// 16-byte stores at o (16-byte aligned)
template <typename T, int N>
__device__ __forceinline__ void store_vec(T* o, const float (&x)[N]) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int k = 0; k < N / 4; ++k)
      reinterpret_cast<float4*>(o)[k] =
          make_float4(x[4 * k], x[4 * k + 1], x[4 * k + 2], x[4 * k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < N / 8; ++k) {
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w[j] = bits16(from_f32<T>(x[8 * k + 2 * j]))
               | bits16(from_f32<T>(x[8 * k + 2 * j + 1])) << 16;
      reinterpret_cast<uint4*>(o)[k] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// grid (blocks, m); row i goes to dst row ids[i] (by_value's where ids is
// null).  With nvec 16-byte vectors of packed values to a row (kPer
// weights each), block b takes vectors b * kDqThreads * unroll on, a
// thread's k-th the block's (k * kDqThreads + thread)-th: it loads all of
// them, and the row's scale, before it stores any.  Each warp's 32
// vectors of one k pass through shared memory so that each of its 16-byte
// stores covers the weights of consecutive lanes: lane l's j-th store is
// the group's (32 j + l)-th 16 bytes of output, every store instruction
// one contiguous run.  With nvec 0 a thread writes one weight.
template <typename T, int FID>
__global__ void __launch_bounds__(kDqThreads)
dequantize_kernel(T* __restrict__ dst, const int* __restrict__ ids,
                  const __grid_constant__ RowIds by_value, int elems,
                  int width, int nvec, int unroll,
                  const uint8_t* __restrict__ values,
                  const float* __restrict__ scales) {
  constexpr int kPer = FID == kInt4 ? 32 : 16;    // weights of a load
  constexpr int kEpv = 16 / (int)sizeof(T);       // weights of a store
  constexpr int kPb = FID == kInt4 ? kEpv / 2 : kEpv;   // their bytes
  __shared__ __align__(16) uint4 stage[kDqUnroll * kDqThreads];
  const int i = blockIdx.y, lane = threadIdx.x & 31;
  const uint8_t* in = values + (size_t)i * width;
  T* row = dst + (size_t)(ids ? ids[i] : by_value.id[i]) * elems;
  if (nvec == 0) {
    const long long e = (long long)blockIdx.x * kDqThreads + threadIdx.x;
    if (e >= elems) return;
    float x;
    if constexpr (FID == kInt4) {
      x = nibble((uint32_t)in[e >> 1] >> (4 * (int)(e & 1)));
    } else {
      x = unpack8<FID>(in[e]);
    }
    row[e] = from_f32<T>(x * scales[i]);
    return;
  }
  const long long first = (long long)blockIdx.x * kDqThreads * unroll;
  uint4 q[kDqUnroll];
#pragma unroll
  for (int k = 0; k < kDqUnroll; ++k) {
    const long long v = first + (long long)k * kDqThreads + threadIdx.x;
    q[k] = k < unroll && v < nvec ? reinterpret_cast<const uint4*>(in)[v]
                                  : make_uint4(0u, 0u, 0u, 0u);
  }
  const float scale = scales[i];
#pragma unroll
  for (int k = 0; k < kDqUnroll; ++k) {
    // the warp's group: vectors w0 .. w0 + live - 1 (warp-uniform)
    const long long w0 = first + (long long)k * kDqThreads
                         + (threadIdx.x - lane);
    if (k >= unroll || w0 >= nvec) break;
    const int live = nvec - w0 < 32 ? (int)(nvec - w0) : 32;
    uint4* ws = stage + k * kDqThreads + (threadIdx.x - lane);
    ws[lane] = q[k];
    __syncwarp();
    const uint8_t* wb = reinterpret_cast<const uint8_t*>(ws);
    T* o = row + w0 * kPer;
#pragma unroll
    for (int s = 0; s < kPer / kEpv; ++s) {
      const int j = 32 * s + lane;
      if (j * kPb >= live * 16) break;
      uint64_t bits;
      if constexpr (kPb == 8) {
        bits = *reinterpret_cast<const uint64_t*>(wb + j * kPb);
      } else if constexpr (kPb == 4) {
        bits = *reinterpret_cast<const uint32_t*>(wb + j * kPb);
      } else {
        bits = *reinterpret_cast<const uint16_t*>(wb + j * kPb);
      }
      float x[kEpv];
#pragma unroll
      for (int c = 0; c < kPb; ++c) {
        const uint32_t byte = (uint32_t)(bits >> (8 * c)) & 0xffu;
        if constexpr (FID == kInt4) {
          x[2 * c] = nibble(byte) * scale;
          x[2 * c + 1] = nibble(byte >> 4) * scale;
        } else {
          x[c] = unpack8<FID>(byte) * scale;
        }
      }
      store_vec<T, kEpv>(o + (long long)j * kEpv, x);
    }
  }
}

template <typename T, int FID>
int launch_dequantize(void* dst, const int* ids, const RowIds& by_value,
                      int m, int elems, int width, int sms,
                      const void* values, const void* scales,
                      cudaStream_t st) {
  // whole vectors where every row's values and destination start 16-byte
  // aligned (the vectors then cover the row exactly: width / 16 of them),
  // else one weight a thread
  const bool aligned = (((uintptr_t)dst | (uintptr_t)values) & 15) == 0
                       && ((long long)elems * (long long)sizeof(T)) % 16 == 0
                       && width % 16 == 0;
  const int nvec = aligned ? width / 16 : 0;
  // the most vectors a thread whose blocks still fill a wave (one per SM)
  int unroll = kDqUnroll;
  auto blocks = [&](int u) {
    const long long per_block = (long long)kDqThreads * u;
    return nvec ? (nvec + per_block - 1) / per_block
                : ((long long)elems + kDqThreads - 1) / kDqThreads;
  };
  while (unroll > 1 && blocks(unroll) * m < sms) unroll /= 2;
  if (blocks(unroll) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dequantize_kernel<T, FID><<<dim3((unsigned)blocks(unroll), m), kDqThreads,
                              0, st>>>(
      static_cast<T*>(dst), ids, by_value, elems, width, nvec, unroll,
      static_cast<const uint8_t*>(values),
      static_cast<const float*>(scales));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dequantize_as(int fid, void* dst, const int* ids,
                         const RowIds& by_value, int m, int elems, int width,
                         int sms, const void* values, const void* scales,
                         cudaStream_t st) {
  switch (fid) {
    case kInt8:
      return launch_dequantize<T, kInt8>(dst, ids, by_value, m, elems, width,
                                         sms, values, scales, st);
    case kFp8:
      return launch_dequantize<T, kFp8>(dst, ids, by_value, m, elems, width,
                                        sms, values, scales, st);
    case kInt4:
      return launch_dequantize<T, kInt4>(dst, ids, by_value, m, elems, width,
                                         sms, values, scales, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_quantize(const void* src, const int* ids, const RowIds& by_value,
                    int m, int elems, int width, int fid, int sms,
                    void* state, void* values, void* scales,
                    cudaStream_t st) {
  const int nb = quantize_demote_blocks(m, sms);
  int slice = (elems + nb - 1) / nb;
  slice = (slice + kSliceAlign - 1) / kSliceAlign * kSliceAlign;
  constexpr int kMaxCached = kMaxCachedBytes / (int)sizeof(T);
  const int cached = slice < kMaxCached ? slice : kMaxCached;
  // once per device and pool type: shared memory past 48 KB
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 64 && !ready[dev]) {
    e = cudaFuncSetAttribute(quantize_rows_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxCachedBytes);
    if (e != cudaSuccess) return (int)e;
    ready[dev] = true;
  }
  // nb * m <= sms blocks of at most 224 KiB: one per SM, all resident at
  // once, as the grid barrier needs (a cooperative launch is refused
  // otherwise)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb, m, 1);
  cfg.blockDim = dim3(kQThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)cached * sizeof(T);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = nb > 1 ? 1 : 0;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, quantize_rows_kernel<T>,
                         static_cast<const T*>(src), ids, by_value, elems,
                         width, fid, slice, cached,
                         static_cast<uint64_t*>(state),
                         static_cast<uint8_t*>(values),
                         static_cast<float*>(scales));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the launch's row ids: null and by_value filled from host_ids (m <= 128),
// or the device table ids
int row_ids(const void* ids, const int* host_ids, int m, RowIds* by_value) {
  *by_value = {};
  if (ids != nullptr) return 0;
  if (host_ids == nullptr || m > kIdsByValue)
    return (int)cudaErrorInvalidValue;
  for (int r = 0; r < m; ++r) by_value->id[r] = host_ids[r];
  return 0;
}

}  // namespace

extern "C" {

// Bytes of quantize_demote's per-stream state, zeroed once by the caller.
int quantize_demote_state_bytes() { return kStateWords * 8; }

// Blocks per row of quantize_demote: one block per SM over the whole
// gather (at most kMaxGrid), at least one per row.
int quantize_demote_blocks(int m, int sms) {
  const int cap = sms < kMaxGrid ? sms : kMaxGrid;
  return m > 0 && cap / m > 1 ? cap / m : 1;
}

// src (n_slots, elems) of the pool type dtype (PoolType: f32, bf16, f16);
// ids (m,) int32 in range on the device, or null with host_ids (m <= 128
// ids in host memory) passed in the launch instead; state
// quantize_demote_state_bytes() bytes, zeroed once and then used by this
// stream's launches only; values (m, width) bytes; scales (m,) f32.
// Returns a cudaError_t as int.
int quantize_demote(const void* src, const void* ids, const int* host_ids,
                    int m, int elems, int width, int fid, int dtype, int sms,
                    void* state, void* values, void* scales, void* stream) {
  if (m == 0) return 0;
  if (m > 65535) return (int)cudaErrorInvalidValue;   // grid.y limit
  RowIds by_value;
  const int rc = row_ids(ids, host_ids, m, &by_value);
  if (rc != 0) return rc;
  const int* id = static_cast<const int*>(ids);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_quantize<float>(src, id, by_value, m, elems, width, fid,
                                    sms, state, values, scales, st);
    case kBf16:
      return launch_quantize<__nv_bfloat16>(src, id, by_value, m, elems,
                                            width, fid, sms, state, values,
                                            scales, st);
    case kF16:
      return launch_quantize<__half>(src, id, by_value, m, elems, width, fid,
                                     sms, state, values, scales, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// dst (n_slots, elems) of the pool type dtype, written in place at rows
// ids (unique, in range): ids (m,) int32 on the device, or null with
// host_ids (m <= 128 ids in host memory) passed in the launch instead;
// sms the card's SM count (the chunk is sized to fill a wave); values (m,
// width) bytes; scales (m,) f32.  Returns a cudaError_t as int.
int dequantize_reload(void* dst, const void* ids, const int* host_ids,
                      int m, int elems, int width, int fid, int dtype,
                      int sms, const void* values, const void* scales,
                      void* stream) {
  if (m == 0 || elems == 0) return 0;
  if (m > 65535) return (int)cudaErrorInvalidValue;   // grid.y limit
  RowIds by_value;
  const int rc = row_ids(ids, host_ids, m, &by_value);
  if (rc != 0) return rc;
  const int* id = static_cast<const int*>(ids);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_dequantize_as<float>(fid, dst, id, by_value, m, elems,
                                         width, sms, values, scales, st);
    case kBf16:
      return launch_dequantize_as<__nv_bfloat16>(fid, dst, id, by_value, m,
                                                 elems, width, sms, values,
                                                 scales, st);
    case kF16:
      return launch_dequantize_as<__half>(fid, dst, id, by_value, m, elems,
                                          width, sms, values, scales, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* harvest_quant_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
