// Probe for quantize-on-demote's design (tools/probe_k2_cluster.py): the
// row absmax and int8 quantization of one f32 row, with the row's slices
// loaded into shared memory by cp.async and the block maxima reduced
// either through a thread block cluster's distributed shared memory or
// not at all (each block keeps its own: wrong values, right traffic), to
// time the load where the blocks sit.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;

template <bool QUANT>
__global__ void __launch_bounds__(kThreads)
probe_kernel(const float* __restrict__ row, int elems, int slice,
             uint8_t* __restrict__ values, int cluster_on) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float warp_max[kThreads / 32];
  __shared__ float block_max;
  const int tid = threadIdx.x;
  const int lo = blockIdx.x * slice;
  const int n = max(min(lo + slice, elems) - lo, 0);
  for (int q = tid; q < n / 4; q += kThreads)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"((uint32_t)__cvta_generic_to_shared(sm + 4 * q)),
                    "l"(row + lo + 4 * q) : "memory");
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  float mx = 0.f;
  for (int q = tid; q < n / 4; q += kThreads) {
    const float4 v = reinterpret_cast<const float4*>(sm)[q];
    mx = fmaxf(mx, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                         fmaxf(fabsf(v.z), fabsf(v.w))));
  }
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if ((tid & 31) == 0) warp_max[tid >> 5] = mx;
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kThreads / 32; ++w) mx = fmaxf(mx, warp_max[w]);
    block_max = mx;
  }
  float am;
  if (cluster_on) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int lane = tid & 31;
    am = lane < (int)cluster.num_blocks()
        ? *cluster.map_shared_rank(&block_max, lane) : 0.f;
    for (int o = 16; o > 0; o >>= 1)
      am = fmaxf(am, __shfl_xor_sync(0xffffffffu, am, o));
    cluster.sync();
  } else {
    __syncthreads();
    am = block_max;
  }
  if (!QUANT) return;
  const float scale = am == 0.f ? 1.f : am * (1.f / 127.f);
  for (int q = tid; q < n / 4; q += kThreads) {
    const float4 v = reinterpret_cast<const float4*>(sm)[q];
    const float x[4] = {v.x, v.y, v.z, v.w};
    uint32_t w = 0;
    for (int k = 0; k < 4; ++k)
      w |= (uint32_t)(uint8_t)(int8_t)fminf(fmaxf(rintf(x[k] / scale),
                                                  -127.f), 127.f) << (8 * k);
    reinterpret_cast<uint32_t*>(values + lo)[q] = w;
  }
}

}  // namespace

extern "C" {

// one row of elems f32 (a multiple of 4 * blocks) over ``blocks`` blocks,
// in clusters of ``cluster`` blocks (1: no cluster); quant 0 stops after
// the maxima.  Returns a cudaError_t as int.
int probe_k2(const void* row, int elems, int blocks, int cluster, int quant,
             void* values, void* stream) {
  const int slice = elems / blocks;
  auto k = quant ? probe_kernel<true> : probe_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             slice * 4);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)slice * 4;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, k, static_cast<const float*>(row), elems,
                         slice, static_cast<uint8_t*>(values),
                         cluster > 1 ? 1 : 0);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // extern "C"
