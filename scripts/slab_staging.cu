// The load side of the slab histogram's row scan (h2o3_tpu_torch/ops/
// kernels/csrc/hist_slab.cuh), two ways, for scripts/slab_probe.py to
// time against each other: which rows count (nid in [0, n_nodes), stats
// not all zero), summed into *counted.
//
//   scan_unrolled  as the kernel does it: each thread loads the nids of
//                  kRows rows at once, then the stats of those that are
//                  in range, from device memory.
//   scan_staged    one thread copies each tile of kTile rows' nids and
//                  stats into shared memory with the bulk asynchronous
//                  copy (cp.async.bulk, completion on an mbarrier), in a
//                  two-stage ring, so tile k+1 loads while the block reads
//                  tile k; the rows after the last whole tile are read
//                  directly.
//
// Plain C interface, built by scripts/slab_probe.py with nvcc for sm_90a.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kRows = 8;
constexpr int kTile = 1024;  // rows a tile: 4 KB of nid, 12 KB of stats

__device__ __forceinline__ bool counts(int n, int n_nodes, float a, float b,
                                       float c) {
  return static_cast<unsigned>(n) < static_cast<unsigned>(n_nodes) &&
         (a != 0.f || b != 0.f || c != 0.f);
}

__device__ __forceinline__ void add_block(int mine,
                                          unsigned long long* counted) {
  __shared__ int total;
  if (threadIdx.x == 0) total = 0;
  __syncthreads();
  atomicAdd(&total, mine);
  __syncthreads();
  if (threadIdx.x == 0)
    atomicAdd(counted, static_cast<unsigned long long>(total));
}

__global__ void scan_unrolled(const int32_t* __restrict__ nid,
                              const float* __restrict__ stats,
                              long long n_rows, long long rows_per_block,
                              int n_nodes, unsigned long long* counted) {
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r1 = min(n_rows, r0 + rows_per_block);
  const long long step = blockDim.x;
  int mine = 0;
  for (long long base = r0 + threadIdx.x; base < r1; base += step * kRows) {
    int node[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const long long r = base + u * step;
      node[u] = r < r1 ? __ldg(nid + r) : -1;
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const float* sp = stats + (base + u * step) * 3;
      const bool in = static_cast<unsigned>(node[u]) <
                      static_cast<unsigned>(n_nodes);
      const float a = in ? __ldg(sp) : 0.f;
      const float b = in ? __ldg(sp + 1) : 0.f;
      const float c = in ? __ldg(sp + 2) : 0.f;
      mine += counts(node[u], n_nodes, a, b, c);
    }
  }
  add_block(mine, counted);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n"
      "WAIT%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT%=;\n}" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// tile t's nids and stats into stage s (thread 0 only)
__device__ __forceinline__ void load_tile(const int32_t* nid,
                                          const float* stats, long long row,
                                          int32_t* s_nid, float* s_stats,
                                          uint32_t bar) {
  const uint32_t b_nid = kTile * 4, b_stats = kTile * 12;
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(b_nid + b_stats)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(s_nid)),
      "l"(nid + row), "r"(b_nid), "r"(bar)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(s_stats)),
      "l"(stats + row * 3), "r"(b_stats), "r"(bar)
      : "memory");
}

// rows_per_block must be a multiple of kTile and nid, stats 16-byte
// aligned; blockDim.x == kTile
__global__ void scan_staged(const int32_t* __restrict__ nid,
                            const float* __restrict__ stats, long long n_rows,
                            long long rows_per_block, int n_nodes,
                            unsigned long long* counted) {
  __shared__ __align__(128) int32_t s_nid[2][kTile];
  __shared__ __align__(128) float s_stats[2][kTile * 3];
  __shared__ __align__(8) uint64_t bars[2];
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r1 = min(n_rows, r0 + rows_per_block);
  const long long tiles = (r1 - r0) / kTile;
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       smem_addr(&bars[s]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = 0; s < 2 && s < tiles; ++s)
      load_tile(nid, stats, r0 + s * kTile, s_nid[s], s_stats[s],
                smem_addr(&bars[s]));
  }
  __syncthreads();
  int mine = 0;
  for (long long k = 0; k < tiles; ++k) {
    const int s = static_cast<int>(k & 1);
    mbar_wait(smem_addr(&bars[s]), static_cast<uint32_t>((k >> 1) & 1));
    const int t = threadIdx.x;
    mine += counts(s_nid[s][t], n_nodes, s_stats[s][t * 3],
                   s_stats[s][t * 3 + 1], s_stats[s][t * 3 + 2]);
    __syncthreads();  // every thread is done with stage s
    if (threadIdx.x == 0 && k + 2 < tiles)
      load_tile(nid, stats, r0 + (k + 2) * kTile, s_nid[s], s_stats[s],
                smem_addr(&bars[s]));
  }
  for (long long r = r0 + tiles * kTile + threadIdx.x; r < r1;
       r += blockDim.x) {
    const float* sp = stats + r * 3;
    mine += counts(__ldg(nid + r), n_nodes, __ldg(sp), __ldg(sp + 1),
                   __ldg(sp + 2));
  }
  add_block(mine, counted);
}

extern "C" int slab_scan(int staged, const void* nid, const void* stats,
                         long long n_rows, long long rows_per_block,
                         int n_nodes, void* counted, void* stream) {
  const long long blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (staged) {
    if (rows_per_block % kTile ||
        reinterpret_cast<uintptr_t>(nid) % 16 ||
        reinterpret_cast<uintptr_t>(stats) % 16)
      return cudaErrorMisalignedAddress;
    scan_staged<<<static_cast<unsigned>(blocks), kTile, 0, s>>>(
        static_cast<const int32_t*>(nid), static_cast<const float*>(stats),
        n_rows, rows_per_block, n_nodes,
        static_cast<unsigned long long*>(counted));
  } else {
    scan_unrolled<<<static_cast<unsigned>(blocks), 1024, 0, s>>>(
        static_cast<const int32_t*>(nid), static_cast<const float*>(stats),
        n_rows, rows_per_block, n_nodes,
        static_cast<unsigned long long*>(counted));
  }
  return static_cast<int>(cudaGetLastError());
}
