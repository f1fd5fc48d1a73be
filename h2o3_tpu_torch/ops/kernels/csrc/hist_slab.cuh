// Device code shared by treekernel.cu (tree_hist) and histogram.cu
// (histogram): the (node, feature, bin) histogram accumulated in a
// shared-memory slab, plus the launch helpers both libraries use. Each
// library is its own translation unit, so the definitions here are
// private to the library that includes them. ops/kernels/__init__.py
// hashes this header into every library's build digest.
//
// Layouts (row-major, as the plain versions use them):
//   bins [N, F] int8 or int32, nid [N] int32, stats [N, 3] float32
//   histograms [nodes, F, B, 3] float32; NA is bin B-1.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

extern "C" const char* h2o3_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

static cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// A block owns one (row chunk, feature, node chunk) triple and sums its
// rows' stats into a [nodes, B, 3] slab in shared memory with shared
// atomics, then flushes the non-zero cells to global memory with
// atomicAdd. With left_only, a row counts only if its nid is even (a
// left child), into the parent slot nid >> 1. Rows whose node or bin lies
// outside the histogram contribute nothing, and so do rows whose three
// stats are all zero (adding +-0 to a sum that starts at +0 leaves it
// unchanged). Each stat goes into its own slot, so a NaN stat never
// touches its neighbours. The float sums happen in no fixed order: exact
// for small-integer stats, within rounding otherwise.
template <typename BinT>
__global__ void slab_hist_kernel(const BinT* __restrict__ bins,
                                 const int32_t* __restrict__ nid,
                                 const float* __restrict__ stats,
                                 float* __restrict__ out, long long n_rows,
                                 int n_feat, int n_bins, int n_nodes,
                                 int left_only, long long rows_per_block,
                                 int node_chunk) {
  extern __shared__ float slab[];
  const int f = blockIdx.y;
  const int c0 = blockIdx.z * node_chunk;
  const int nc = min(node_chunk, n_nodes - c0);
  const int per_node = n_bins * 3;
  const int slab_n = nc * per_node;
  for (int i = threadIdx.x; i < slab_n; i += blockDim.x) slab[i] = 0.f;
  __syncthreads();
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r1 = min(n_rows, r0 + rows_per_block);
  for (long long r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    int n = nid[r];
    if (left_only) {
      if (n & 1) continue;
      n >>= 1;
    }
    n -= c0;
    if (static_cast<unsigned>(n) >= static_cast<unsigned>(nc)) continue;
    const float* s = stats + r * 3;
    const float s0 = s[0], s1 = s[1], s2 = s[2];
    if (s0 == 0.f && s1 == 0.f && s2 == 0.f) continue;
    const int b = static_cast<int>(bins[r * n_feat + f]);
    if (static_cast<unsigned>(b) >= static_cast<unsigned>(n_bins)) continue;
    float* cell = slab + n * per_node + b * 3;
    atomicAdd(cell + 0, s0);
    atomicAdd(cell + 1, s1);
    atomicAdd(cell + 2, s2);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < slab_n; i += blockDim.x) {
    const float v = slab[i];
    if (v != 0.f) {  // NaN compares unequal, so it is flushed too
      const int nl = i / per_node;
      const int rest = i - nl * per_node;
      atomicAdd(out + (static_cast<long long>(c0 + nl) * n_feat + f) *
                          per_node + rest,
                v);
    }
  }
}

// Launch over a (row blocks, features, node chunks) grid; `out` must be
// zeroed [n_nodes, F, B, 3]. Returns the launch's cudaError_t.
static cudaError_t launch_slab_hist(const void* bins, int bins_int8,
                                    const void* nid, const void* stats,
                                    void* out, long long n_rows, int n_feat,
                                    int n_bins, int n_nodes, int left_only,
                                    long long rows_per_block, int node_chunk,
                                    void* stream) {
  const long long nrb = (n_rows + rows_per_block - 1) / rows_per_block;
  const int nchunks = (n_nodes + node_chunk - 1) / node_chunk;
  const size_t smem = static_cast<size_t>(std::min(node_chunk, n_nodes)) *
                      n_bins * 3 * sizeof(float);
  dim3 grid(static_cast<unsigned>(nrb), n_feat, nchunks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bins_int8) {
    err = allow_smem(reinterpret_cast<const void*>(&slab_hist_kernel<int8_t>),
                     smem);
    if (err != cudaSuccess) return err;
    slab_hist_kernel<int8_t><<<grid, 256, smem, s>>>(
        static_cast<const int8_t*>(bins), static_cast<const int32_t*>(nid),
        static_cast<const float*>(stats), static_cast<float*>(out), n_rows,
        n_feat, n_bins, n_nodes, left_only, rows_per_block, node_chunk);
  } else {
    err = allow_smem(
        reinterpret_cast<const void*>(&slab_hist_kernel<int32_t>), smem);
    if (err != cudaSuccess) return err;
    slab_hist_kernel<int32_t><<<grid, 256, smem, s>>>(
        static_cast<const int32_t*>(bins), static_cast<const int32_t*>(nid),
        static_cast<const float*>(stats), static_cast<float*>(out), n_rows,
        n_feat, n_bins, n_nodes, left_only, rows_per_block, node_chunk);
  }
  return cudaGetLastError();
}
