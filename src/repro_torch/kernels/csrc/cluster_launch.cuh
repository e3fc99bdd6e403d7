// Launch a kernel over a grid of thread-block clusters of `cluster` blocks
// (at most the portable 8) along x (Hopper, sm_90) with `smem` bytes of
// dynamic shared memory. The kernel's dynamic shared memory limit is raised
// to `smem`: above 48 KB less its static shared memory the launch fails
// without it. Returns a CUDA error code, 0 on success.
#pragma once
#include <cuda_runtime.h>

template <typename Kernel, typename... Args>
inline int cluster_launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                          int cluster, void* stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
