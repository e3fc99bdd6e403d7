// Launch a kernel over a grid of thread-block clusters of `cluster` blocks
// (at most the portable 8) along x (Hopper, sm_90) with `smem` bytes of
// dynamic shared memory. The kernel's dynamic shared memory limit is raised
// to `smem`: above 48 KB less its static shared memory the launch fails
// without it. Returns a CUDA error code, 0 on success.
//
// `cluster_launch_resident` is the persistent form the Eq. 19 chains use:
// one cooperative launch of grid (cluster, n_clusters), every cluster
// resident at once, so the kernel may separate its rounds with
// cooperative_groups' grid barrier (cg::this_grid().sync()). CUDA takes the
// cooperative and the cluster-dimension attributes together in one
// cudaLaunchKernelEx (checked on an H100 with the CUDA 12.9 toolkit:
// cg::this_grid().is_valid() holds and the barrier does). A grid of more
// clusters than `cluster_max_active` reports is refused before it runs:
// the barrier would wait forever for clusters that cannot be scheduled.
#pragma once
#include <cuda_runtime.h>

namespace cluster_detail {

template <typename Kernel>
inline cudaError_t configure(Kernel kernel, cudaLaunchConfig_t& cfg,
                             cudaLaunchAttribute (&attr)[2], dim3 grid,
                             int threads, size_t smem, int cluster,
                             bool cooperative, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cooperative ? 2 : 1;
  return cudaSuccess;
}

}  // namespace cluster_detail

template <typename Kernel, typename... Args>
inline int cluster_launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                          int cluster, void* stream, Args... args) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  cudaError_t err = cluster_detail::configure(kernel, cfg, attr, grid, threads,
                                              smem, cluster, false, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Clusters of `cluster` blocks of `threads` threads and `smem` bytes of
// dynamic shared memory that the device holds at once
// (cudaOccupancyMaxActiveClusters), or a negative CUDA error code.
template <typename Kernel>
inline int cluster_max_active(Kernel kernel, int threads, size_t smem,
                              int cluster) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  cudaError_t err = cluster_detail::configure(
      kernel, cfg, attr, dim3(cluster), threads, smem, cluster, false,
      nullptr);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return n;
}

template <typename Kernel, typename... Args>
inline int cluster_launch_resident(Kernel kernel, int n_clusters, int threads,
                                   size_t smem, int cluster, void* stream,
                                   Args... args) {
  const int cap = cluster_max_active(kernel, threads, smem, cluster);
  if (cap < 0) return -cap;
  if (n_clusters < 1 || n_clusters > cap)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  cudaError_t err = cluster_detail::configure(
      kernel, cfg, attr, dim3(cluster, n_clusters), threads, smem, cluster,
      true, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
