// Device code shared by treekernel.cu (tree_hist) and histogram.cu
// (histogram): the (node, feature, bin) histogram accumulated in a
// shared-memory slab, plus the launch helpers both libraries use. Each
// library is its own translation unit, so the definitions here are
// private to the library that includes them. ops/kernels/__init__.py
// hashes this header into every library's build digest, and plans the
// launch (slab_geometry).
//
// Layouts (row-major, as the plain versions use them):
//   bins [N, F] int8 or int32, nid [N] int32, stats [N, 3] float32
//   histograms [nodes, F, B, 3] float32; NA is bin B-1.
// The model axis (tree_hist_models): M models share one bins [N, F] and
// each has its own nid, stats, exps and histogram, stacked model-major
// (nid [M, N], stats [M, N, 3], exps [M, 3], histograms [M, nodes, F, B,
// 3]); blockIdx.z (the slab) or blockIdx.y (the deep-level route) is the
// model, and a block moves its pointers to its model's rows before
// anything else. A one-model launch has one model and moves nothing.
//
// The sums are 64-bit fixed point (ops/fixed_point.py), so they do not
// depend on the order of the adds and two runs give the same bits: stat k
// of a row is rounded to the int64 round(s * 2^e_k), with e_k (exps[k],
// on the device) chosen by the caller so that no cell can overflow; the
// slab and the global accumulator add int64 cells with integer atomics;
// one pass converts each cell to float32 as (double) sum * 2^-e_k. A
// non-finite stat is added as a float into the output cell itself
// (zero until then), whose value then stands: a float sum of values from
// {0, +-inf, NaN} is the same in any order.

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

typedef unsigned long long u64;  // an int64 cell, added as two's complement

// 2^e as a float, e in [-126, 127]
__device__ __forceinline__ float pow2f(int e) {
  return __int_as_float((e + 127) << 23);
}

// Rows a thread scans or marks at once (their loads in flight together);
// row offsets a warp's queue holds; bins a lane loads before it scatters
// them, where its row is not an int8 row of up to 13 features.
constexpr int kSlabRows = 8;
constexpr int kSlabQueue = 32;
constexpr int kSlabFeats = 8;
constexpr int kSlabMaxThreads = 1024;
// Past this many node chunks (and up to the queues' room for a count and
// a start per chunk) a block first sorts its rows by chunk into a list.
constexpr int kSlabListChunks = 2;
constexpr unsigned kSlabSkip = 0xffffu;  // key of a row that counts nowhere

// The node of a row in the chunk [c0, c0 + nc), or -1: with left_only
// only an even nid counts, in the parent slot nid >> 1.
__device__ __forceinline__ int chunk_node(int n, int left_only, unsigned c0,
                                          unsigned nc) {
  if (left_only) n = (n & 1) ? -1 : (n >> 1);
  return static_cast<unsigned>(n) - c0 < nc ? static_cast<int>(n - c0) : -1;
}

// The key of row r: its node (0 <= node < n_nodes) if it counts (its
// stats not all zero), else kSlabSkip.
__device__ __forceinline__ unsigned row_key(int node, const float* sp) {
  if (node < 0) return kSlabSkip;
  const float a = __ldg(sp), b = __ldg(sp + 1), c = __ldg(sp + 2);
  return a != 0.f || b != 0.f || c != 0.f ? static_cast<unsigned>(node)
                                          : kSlabSkip;
}

// Add n to counter[c] once per distinct c among the calling lanes (all
// 32, each with its own c, or c < 0 to add nothing), and return the
// counter's old value plus the lane's rank among the lanes with its c.
__device__ __forceinline__ int warp_claim(int* counter, int c) {
  const unsigned peers = __match_any_sync(0xffffffffu, c);
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(peers) - 1;
  int base = 0;
  if (c >= 0 && lane == leader) base = atomicAdd(counter + c, __popc(peers));
  base = __shfl_sync(0xffffffffu, base, leader);
  return base + __popc(peers & ((1u << lane) - 1u));
}

// What a warp needs to scatter the rows of one chunk: the inputs, its
// copy of the slab and its queue of row offsets (relative to r0).
template <typename BinT>
struct SlabPass {
  const BinT* __restrict__ bins;
  const int32_t* __restrict__ nid;
  const float* __restrict__ stats;
  const unsigned short* keys;  // null: take the node from nid
  u64* mine;
  float* side;  // the output: non-finite stats, as floats
  int* queue;
  long long r0, n_rows;
  int n_feat, n_bins, f0, fg, per_node, per_feat, rot, left_only;
  unsigned c0, nc, below;
  float q0, q1, q2;  // 2^e_k: the stats' fixed-point scales
  int queued;  // the same in every lane of the warp

  // Quantised stats (s0, s1, s2) into the cell of bin b of feature f of
  // a node.
  __device__ __forceinline__ void add(u64* cells, int f, int b, u64 s0,
                                      u64 s1, u64 s2) const {
    if (static_cast<unsigned>(b) >= static_cast<unsigned>(n_bins)) return;
    u64* cell = cells + f * per_feat + b * 3;
    atomicAdd(cell + 0, s0);
    atomicAdd(cell + 1, s1);
    atomicAdd(cell + 2, s2);
  }

  // A row with a non-finite stat (rare): its finite stats into the slab,
  // the others as floats into the output cells of node n of the chunk.
  __device__ __noinline__ void poison(long long r, int n, float s0,
                                      float s1, float s2) const {
    const float s[3] = {s0, s1, s2};
    const float q[3] = {q0, q1, q2};
    for (int f = 0; f < fg; ++f) {
      const int b = static_cast<int>(bins[r * n_feat + f0 + f]);
      if (static_cast<unsigned>(b) >= static_cast<unsigned>(n_bins)) continue;
      u64* cell = mine + n * per_node + f * per_feat + b * 3;
      float* out = side +
                   ((static_cast<long long>(c0) + n) * n_feat + f0 + f) *
                       per_feat + b * 3;
      for (int k = 0; k < 3; ++k) {
        if (isfinite(s[k]))
          atomicAdd(cell + k, static_cast<u64>(__float2ll_rn(s[k] * q[k])));
        else
          atomicAdd(out + k, s[k]);
      }
    }
  }

  // Row r (in the chunk, stats not all zero) into the slab: its stats
  // into the (node, feature, bin) cell of each of its features. Lane l
  // starts at feature l % fg, so the lanes that share a feature at one
  // step are a few, not 32, and seldom share a cell.
  __device__ __forceinline__ void scatter(long long r) const {
    const int n = keys ? static_cast<int>(keys[r] - c0)
                       : chunk_node(__ldg(nid + r), left_only, c0, nc);
    const float f0s = __ldg(stats + r * 3 + 0);
    const float f1s = __ldg(stats + r * 3 + 1);
    const float f2s = __ldg(stats + r * 3 + 2);
    if (!(isfinite(f0s) && isfinite(f1s) && isfinite(f2s))) {
      poison(r, n, f0s, f1s, f2s);
      return;
    }
    const u64 s0 = static_cast<u64>(__float2ll_rn(f0s * q0));
    const u64 s1 = static_cast<u64>(__float2ll_rn(f1s * q1));
    const u64 s2 = static_cast<u64>(__float2ll_rn(f2s * q2));
    const BinT* row = bins + r * n_feat + f0;
    u64* cells = mine + n * per_node;
    if (sizeof(BinT) == 1 && fg <= 13 &&
        r * n_feat + f0 + 16 <= n_rows * n_feat) {
      // an int8 row of up to 13 features: the 16 bytes from its 4-byte-
      // aligned start in four 32-bit loads, not 13 byte loads
      const uintptr_t at = reinterpret_cast<uintptr_t>(row);
      const unsigned* w =
          reinterpret_cast<const unsigned*>(at & ~static_cast<uintptr_t>(3));
      const unsigned long long lo =
          __ldg(w) | static_cast<unsigned long long>(__ldg(w + 1)) << 32;
      const unsigned long long hi =
          __ldg(w + 2) | static_cast<unsigned long long>(__ldg(w + 3)) << 32;
      const int sh = static_cast<int>(at & 3);
#pragma unroll
      for (int k = 0; k < 13; ++k) {
        if (k >= fg) break;
        const int f = k + rot < fg ? k + rot : k + rot - fg;
        const int j = sh + f;  // byte j of the 16
        const unsigned byte = static_cast<unsigned>(
            (j < 8 ? lo >> (8 * j) : hi >> (8 * (j - 8))) & 0xffu);
        add(cells, f, static_cast<signed char>(byte), s0, s1, s2);
      }
      return;
    }
    for (int fb = 0; fb < fg; fb += kSlabFeats) {
      int b[kSlabFeats];
#pragma unroll
      for (int k = 0; k < kSlabFeats; ++k) {
        const int f = fb + k + rot < fg ? fb + k + rot : fb + k + rot - fg;
        b[k] = fb + k < fg ? static_cast<int>(__ldg(row + f)) : -1;
      }
#pragma unroll
      for (int k = 0; k < kSlabFeats; ++k) {
        if (fb + k >= fg) break;
        const int f = fb + k + rot < fg ? fb + k + rot : fb + k + rot - fg;
        add(cells, f, b[k], s0, s1, s2);
      }
    }
  }

  // Called by all 32 lanes together: queue row r0 + off where `counts`;
  // each time the queue fills, every lane scatters one queued row.
  __device__ __forceinline__ void offer(bool counts, int off) {
    const unsigned m = __ballot_sync(0xffffffffu, counts);
    const int rank = __popc(m & below);
    const int room = kSlabQueue - queued;
    if (counts && rank < room) queue[queued + rank] = off;
    if (__popc(m) < room) {
      queued += __popc(m);
      return;
    }
    __syncwarp();
    scatter(r0 + queue[threadIdx.x & 31]);
    __syncwarp();
    if (counts && rank >= room) queue[rank - room] = off;
    queued = __popc(m) - room;
  }

  // The rows still queued, after the warp's last offer.
  __device__ __forceinline__ void drain() {
    __syncwarp();
    if (static_cast<int>(threadIdx.x & 31) < queued)
      scatter(r0 + queue[threadIdx.x & 31]);
  }
};

// A block owns one (row range, feature group) and walks the node chunks
// in turn (each block from a different first chunk, so that their flushes
// spread over the histogram), summing into a [nodes, features, B, 3] slab
// in shared memory (64-bit fixed-point cells) the rows of its range whose
// node falls in the chunk.
// The chunks and groups are balanced (chunk c holds nodes
// [c*L/chunks, (c+1)*L/chunks)), and there is more than one feature group
// only when one node's F*B*12 bytes exceed the budget. Every block covers
// every chunk, so a level whose rows crowd into a few nodes still spreads
// them over all blocks.
//
// Up to kSlabListChunks chunks, each warp scans its rows once a chunk, 32
// a step and kSlabRows steps of nid and stats in flight, and puts those
// that count (in the chunk, stats not all zero) into its queue in shared
// memory; each time the queue holds 32, every lane scatters one of them,
// so the scatter runs on full warps however few rows count. Past that, a
// chunk's rows would be scanned once per chunk for a few of them each, so
// the block sorts its rows by chunk first: it marks each row with a
// 16-bit key (its node, or kSlabSkip) in `keys` while it counts the rows
// of every chunk, then writes each counted row's offset into its chunk's
// run of `list` (global scratch of N ints a feature group). Each chunk
// then reads only its own run, 32 rows a warp.
//
// With `replicas` > 1 the slab is held that many times and warp w adds
// into copy w % replicas, so warps do not collide on the hot bins of a
// shallow level; the copies are summed in shared memory before the flush,
// which adds every non-zero cell of the chunk into the int64 accumulator
// `acc` with one 64-bit atomic add.
//
// With left_only, a row counts only if its nid is even (a left child),
// into the parent slot nid >> 1. Rows whose node or bin lies outside the
// histogram contribute nothing, and so do rows whose three stats are all
// zero (adding +-0 to a sum that starts at +0 leaves it unchanged); their
// bins are never read. Each stat goes into its own slot, so a NaN stat
// never touches its neighbours. The integer sums happen in no fixed
// order, and give the same bits in any.
template <typename BinT>
__global__ void __launch_bounds__(kSlabMaxThreads)
    slab_hist_kernel(const BinT* __restrict__ bins,
                     const int32_t* __restrict__ nid,
                     const float* __restrict__ stats,
                     const int* __restrict__ exps, unsigned short* keys,
                     int* list, u64* __restrict__ acc, float* out,
                     long long n_rows, int n_feat, int n_bins, int n_nodes,
                     int left_only, long long rows_per_block, int n_chunks,
                     int n_groups, int replicas) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  u64* slab = reinterpret_cast<u64*>(smem_raw);
  {  // this block's model
    const long long m = blockIdx.z;
    const long long cells =
        static_cast<long long>(n_nodes) * n_feat * n_bins * 3;
    nid += m * n_rows;
    stats += m * n_rows * 3;
    exps += m * 3;
    acc += m * cells;
    out += m * cells;
    if (keys) keys += m * n_rows;
    if (list) list += m * n_groups * n_rows;
  }
  const int f0 = blockIdx.y * n_feat / n_groups;
  const int fg = (blockIdx.y + 1) * n_feat / n_groups - f0;
  const int per_feat = n_bins * 3;
  const int per_node = fg * per_feat;
  // cells of one copy of the largest chunk's slab in the largest group
  const int slab_stride = (n_nodes + n_chunks - 1) / n_chunks *
                          ((n_feat + n_groups - 1) / n_groups) * per_feat;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r1 = min(n_rows, r0 + rows_per_block);
  const long long step = blockDim.x;
  // the warps' queues, or with a list every chunk's count and start
  int* queues = reinterpret_cast<int*>(slab + replicas * slab_stride);
  const bool listed =
      n_chunks > kSlabListChunks &&
      2 * n_chunks <= static_cast<int>(blockDim.x / 32) * kSlabQueue;
  int* count = queues;
  int* start = queues + n_chunks;
  // the blocks of one row range in other feature groups sort the same
  // rows into lists of their own (and write the same keys)
  if (listed) list += blockIdx.y * n_rows + r0;

  if (listed) {
    for (int c = threadIdx.x; c < 2 * n_chunks; c += blockDim.x)
      queues[c] = 0;
    __syncthreads();
    // each row's key, and the rows of each chunk
    for (long long base = r0 + warp * 32; base < r1;
         base += step * kSlabRows) {
      int node[kSlabRows];
#pragma unroll
      for (int u = 0; u < kSlabRows; ++u) {
        const long long r = base + u * step + lane;
        node[u] = r < r1 ? chunk_node(__ldg(nid + r), left_only, 0u,
                                      static_cast<unsigned>(n_nodes))
                         : -1;
      }
#pragma unroll
      for (int u = 0; u < kSlabRows; ++u) {
        const long long r = base + u * step + lane;
        const unsigned key = row_key(node[u], stats + r * 3);
        if (r < r1) keys[r] = static_cast<unsigned short>(key);
        warp_claim(count, key == kSlabSkip
                              ? -1
                              : static_cast<int>(((key + 1ll) * n_chunks - 1) /
                                                 n_nodes));
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int at = 0;
      for (int c = 0; c < n_chunks; ++c) {
        start[c] = at;
        at += count[c];
        count[c] = start[c];  // a cursor while the list is written
      }
    }
    __syncthreads();
    // each counted row's offset into its chunk's run of the list
    for (long long base = r0 + warp * 32; base < r1; base += step) {
      const long long r = base + lane;
      const unsigned key = r < r1 ? keys[r] : kSlabSkip;
      const int c = key == kSlabSkip
                        ? -1
                        : static_cast<int>(((key + 1ll) * n_chunks - 1) /
                                           n_nodes);
      const int slot = warp_claim(count, c);
      if (c >= 0) list[slot] = static_cast<int>(r - r0);
    }
    __syncthreads();
    // count[c] is now the end of chunk c's run
  }

  SlabPass<BinT> pass{bins, nid, stats, listed ? keys : nullptr,
                      slab + (warp % replicas) * slab_stride, out,
                      queues + warp * kSlabQueue, r0, n_rows, n_feat, n_bins,
                      f0, fg, per_node, per_feat, lane % fg, left_only, 0u,
                      0u, (1u << lane) - 1u, pow2f(__ldg(exps)),
                      pow2f(__ldg(exps + 1)), pow2f(__ldg(exps + 2)), 0};
  for (int k = 0; k < n_chunks; ++k) {
    const int chunk = (k + blockIdx.x) % n_chunks;
    pass.c0 = static_cast<unsigned>(
        static_cast<long long>(chunk) * n_nodes / n_chunks);
    pass.nc = static_cast<unsigned>(
        static_cast<long long>(chunk + 1) * n_nodes / n_chunks) - pass.c0;
    pass.queued = 0;
    for (int i = threadIdx.x; i < replicas * slab_stride; i += blockDim.x)
      slab[i] = 0ull;
    __syncthreads();
    if (listed) {
      const int beg = start[chunk], end = count[chunk];
      for (int i = beg + warp * 32; i < end; i += blockDim.x)
        if (i + lane < end) pass.scatter(r0 + list[i + lane]);
    } else {
      for (long long base = r0 + warp * 32; base < r1;
           base += step * kSlabRows) {
        int node[kSlabRows];
#pragma unroll
        for (int u = 0; u < kSlabRows; ++u) {
          const long long r = base + u * step + lane;
          node[u] = r < r1 ? chunk_node(__ldg(nid + r), left_only, pass.c0,
                                        pass.nc)
                           : -1;
        }
        bool counts[kSlabRows];
#pragma unroll
        for (int u = 0; u < kSlabRows; ++u)
          counts[u] = row_key(node[u], stats + (base + u * step + lane) * 3) !=
                      kSlabSkip;
#pragma unroll
        for (int u = 0; u < kSlabRows; ++u)
          pass.offer(counts[u], static_cast<int>(base + u * step + lane - r0));
      }
      pass.drain();
    }
    __syncthreads();
    // flush: cell i of node nl goes to acc[g0 + i], g0 below
    for (int t = threadIdx.x; t < static_cast<int>(pass.nc) * per_node;
         t += blockDim.x) {
      u64 v = 0;
      for (int k = 0; k < replicas; ++k) v += slab[k * slab_stride + t];
      if (v == 0) continue;
      const int nl = t / per_node;
      const long long g0 =
          (static_cast<long long>(pass.c0) + nl) * n_feat * per_feat +
          static_cast<long long>(f0) * per_feat;
      atomicAdd(acc + g0 + (t - nl * per_node), v);
    }
    __syncthreads();  // the next chunk zeroes the slab
  }
}

// Each cell of the int64 accumulator `acc` into the float32 output
// `out`, as (double) sum * 2^-e_k (k = the cell's stat, e the exponents
// of the cell's model: `per_model` cells a model), unless `out` already
// holds the cell's non-finite sum.
__global__ void slab_convert_kernel(const long long* __restrict__ acc,
                                    float* __restrict__ out,
                                    const int* __restrict__ exps,
                                    long long cells, long long per_model) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < cells; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (out[i] != 0.f) continue;
    const int e = exps[i / per_model * 3 + i % 3];
    const double inv =
        __longlong_as_double(static_cast<long long>(1023 - e) << 52);
    out[i] = __double2float_rn(__ll2double_rn(acc[i]) * inv);
  }
}

static cudaError_t launch_slab_convert(const void* acc, void* out,
                                       const void* exps, long long cells,
                                       void* stream, int n_models = 1) {
  if (cells <= 0) return cudaSuccess;
  const long long total = cells * n_models;
  const long long blocks = std::min((total + 255) / 256, 8192ll);
  slab_convert_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(acc), static_cast<float*>(out),
      static_cast<const int*>(exps), total, cells);
  return cudaGetLastError();
}

// The conversion alone, after the caller summed `acc` and `out` over the
// ranks of a mesh (shard_hist).
extern "C" int slab_convert(const void* acc, void* out, const void* exps,
                            long long cells, void* stream) {
  return launch_slab_convert(acc, out, exps, cells, stream);
}

// The deep-level route: where the nodes are too many for the slab's
// chunks to be sorted into (more than a 16-bit key holds, or more chunks
// than a block can list), a row per thread adds its fixed-point stats
// straight into the int64 accumulator's (node, feature, bin) cells with
// global atomics. At such a level a node holds few rows, so the atomics
// seldom collide, and every row is read once (the slab walks every row
// once a chunk there). The integer sums are the slab's, in another
// order: the same bits. A non-finite stat goes as a float into its
// output cell, as in the slab's poison().
template <typename BinT>
__global__ void global_hist_kernel(const BinT* __restrict__ bins,
                                   const int32_t* __restrict__ nid,
                                   const float* __restrict__ stats,
                                   const int* __restrict__ exps,
                                   u64* __restrict__ acc, float* out,
                                   long long n_rows, int n_feat, int n_bins,
                                   int n_nodes, int left_only) {
  {  // this block's model
    const long long m = blockIdx.y;
    const long long cells =
        static_cast<long long>(n_nodes) * n_feat * n_bins * 3;
    nid += m * n_rows;
    stats += m * n_rows * 3;
    exps += m * 3;
    acc += m * cells;
    out += m * cells;
  }
  const float q[3] = {pow2f(__ldg(exps)), pow2f(__ldg(exps + 1)),
                      pow2f(__ldg(exps + 2))};
  const int per_feat = n_bins * 3;
  for (long long r = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       r < n_rows; r += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int node = chunk_node(__ldg(nid + r), left_only, 0u,
                                static_cast<unsigned>(n_nodes));
    if (node < 0) continue;
    const float s[3] = {__ldg(stats + r * 3), __ldg(stats + r * 3 + 1),
                        __ldg(stats + r * 3 + 2)};
    if (s[0] == 0.f && s[1] == 0.f && s[2] == 0.f) continue;
    const bool fin = isfinite(s[0]) && isfinite(s[1]) && isfinite(s[2]);
    u64 v[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      v[k] = isfinite(s[k]) ? static_cast<u64>(__float2ll_rn(s[k] * q[k]))
                            : 0ull;
    const long long base = static_cast<long long>(node) * n_feat * per_feat;
    const BinT* row = bins + r * n_feat;
    for (int f = 0; f < n_feat; ++f) {
      const int b = static_cast<int>(__ldg(row + f));
      if (static_cast<unsigned>(b) >= static_cast<unsigned>(n_bins)) continue;
      const long long at = base + f * per_feat + b * 3;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        if (fin || isfinite(s[k]))
          atomicAdd(acc + at + k, v[k]);
        else
          atomicAdd(out + at + k, s[k]);
      }
    }
  }
}

// The deep-level route over a one-wave grid of 256-thread blocks (a
// wave a model), then, with `convert`, the conversion of `acc` into `out`
// (both zeroed, as for launch_slab_hist).
static cudaError_t launch_global_hist(const void* bins, int bins_int8,
                                      const void* nid, const void* stats,
                                      const void* exps, void* acc, void* out,
                                      long long n_rows, int n_feat,
                                      int n_bins, int n_nodes, int left_only,
                                      int blocks, int convert, void* stream,
                                      int n_models = 1) {
  if (reinterpret_cast<uintptr_t>(acc) % 8) return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks, n_models);
  if (n_rows > 0) {
    if (bins_int8)
      global_hist_kernel<int8_t><<<grid, 256, 0, s>>>(
          static_cast<const int8_t*>(bins), static_cast<const int32_t*>(nid),
          static_cast<const float*>(stats), static_cast<const int*>(exps),
          static_cast<u64*>(acc), static_cast<float*>(out), n_rows, n_feat,
          n_bins, n_nodes, left_only);
    else
      global_hist_kernel<int32_t><<<grid, 256, 0, s>>>(
          static_cast<const int32_t*>(bins), static_cast<const int32_t*>(nid),
          static_cast<const float*>(stats), static_cast<const int*>(exps),
          static_cast<u64*>(acc), static_cast<float*>(out), n_rows, n_feat,
          n_bins, n_nodes, left_only);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !convert) return err;
  return launch_slab_convert(
      acc, out, exps,
      static_cast<long long>(n_nodes) * n_feat * n_bins * 3, stream,
      n_models);
}

// Launch over a (row blocks, feature groups) grid of `threads`-thread
// blocks with `smem` bytes of shared memory each (`replicas` copies of
// the largest chunk's slab of 8-byte cells, then a queue of kSlabQueue
// ints a warp), as ops/kernels/__init__.py slab_geometry planned it;
// then, with `convert`, the conversion of `acc` into `out`. `acc` must be
// zeroed int64 [n_nodes, F, B, 3] and `out` zeroed float32 of the same
// shape; `exps` the three stats' exponents on the device; `keys` holds N
// entries and `list` N a feature group (both null where the plan sorts
// no rows); n_nodes < 65536. With `n_models` > 1 the grid gets a model
// axis (blockIdx.z) and every per-model buffer holds n_models stacked
// copies (the header's model axis). Returns the launches' cudaError_t.
static cudaError_t launch_slab_hist(const void* bins, int bins_int8,
                                    const void* nid, const void* stats,
                                    const void* exps, void* keys, void* list,
                                    void* acc, void* out, long long n_rows,
                                    int n_feat, int n_bins, int n_nodes,
                                    int left_only, long long rows_per_block,
                                    int n_chunks, int n_groups, int replicas,
                                    int threads, long long smem, int convert,
                                    void* stream, int n_models = 1) {
  if (reinterpret_cast<uintptr_t>(acc) % 8) return cudaErrorMisalignedAddress;
  if (n_nodes > static_cast<int>(kSlabSkip)) return cudaErrorInvalidValue;
  const long long nrb = (n_rows + rows_per_block - 1) / rows_per_block;
  dim3 grid(static_cast<unsigned>(nrb), n_groups, n_models);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(smem);
  cudaError_t err;
  if (bins_int8) {
    err = allow_smem(reinterpret_cast<const void*>(&slab_hist_kernel<int8_t>),
                     bytes);
    if (err != cudaSuccess) return err;
    if (nrb > 0)
      slab_hist_kernel<int8_t><<<grid, threads, bytes, s>>>(
          static_cast<const int8_t*>(bins), static_cast<const int32_t*>(nid),
          static_cast<const float*>(stats), static_cast<const int*>(exps),
          static_cast<unsigned short*>(keys), static_cast<int*>(list),
          static_cast<u64*>(acc), static_cast<float*>(out), n_rows, n_feat,
          n_bins, n_nodes, left_only, rows_per_block, n_chunks, n_groups,
          replicas);
  } else {
    err = allow_smem(
        reinterpret_cast<const void*>(&slab_hist_kernel<int32_t>), bytes);
    if (err != cudaSuccess) return err;
    if (nrb > 0)
      slab_hist_kernel<int32_t><<<grid, threads, bytes, s>>>(
          static_cast<const int32_t*>(bins), static_cast<const int32_t*>(nid),
          static_cast<const float*>(stats), static_cast<const int*>(exps),
          static_cast<unsigned short*>(keys), static_cast<int*>(list),
          static_cast<u64*>(acc), static_cast<float*>(out), n_rows, n_feat,
          n_bins, n_nodes, left_only, rows_per_block, n_chunks, n_groups,
          replicas);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || !convert) return err;
  return launch_slab_convert(
      acc, out, exps,
      static_cast<long long>(n_nodes) * n_feat * n_bins * 3, stream,
      n_models);
}
