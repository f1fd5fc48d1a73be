// One tree level on one H100, as three kernels: histogram, split scan,
// row partition. Plain C interface (no PyTorch headers), loaded through
// ctypes by h2o3_tpu_torch/ops/kernels/treekernel.py, which also holds
// the plain PyTorch version of each kernel.
//
// Replaces: h2o3_tpu/ops/pallas/treekernel.py _fused_call (pallas_call at
// :250), whose body _fused_kernel runs _hist_block (phase 0),
// _level_boundary (the split scan) and _partition_block (phase 1) in one
// launch over a sequential (phase, tile) grid with a VMEM accumulator.
// Hopper runs blocks in parallel and in no order and gives a block at
// most 227 KB of shared memory, so the phases become three launches on
// the caller's stream; nothing carries over between blocks.
//
// Layouts (row-major, as the plain versions use them):
//   bins [N, F] int8 or int32, nid [N] int32, stats [N, 3] float32 {w, w*g, w*h}
//   histograms [nodes, F, B, 3] float32; NA is bin B-1.
// Every launcher returns the cudaError_t of its launch (0 = launched).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "hist_slab.cuh"

// ------------------------------------------------------------ tree_hist
// Replaces phase 0 (_hist_block, treekernel.py:72): the [Lh, F, B, 3]
// histogram of {w, w*g, w*h}; at levels d >= 1 only LEFT-child rows (even
// nid) count, into their parent's slot nid >> 1 (sibling subtraction
// derives the right child in tree_split).
//
// Bound: bytes. Each row's bins row, nid and 12 bytes of stats must be
// read once (26 bytes a row at F = 10, int8) and the [Lh, F, B, 3] result
// written once; the work is a few shared atomics a byte, far below the
// card's arithmetic rate, but the shared-memory float atomics (a
// compare-and-swap loop, about 1.6 lanes a clock an SM) set its time.
// Design: slab_hist_kernel (hist_slab.cuh). One block per SM covers all
// F features of its rows, walking the node chunks of a [nodes, F, B, 3]
// slab of up to 227 KB (15 nodes at B = 126: the flagship's depths run
// in one chunk each, then two of 8 at Lh = 16; depth bucket 10's
// Lh = 256 in 18, its rows sorted by chunk first). Right-child rows never
// reach the scatter, which runs on full warps of left-child rows. Where
// the slab fits twice or more, each warp adds into its own copy of it
// (15 copies at d = 0), so warps do not collide on a shallow level's hot
// bins.

extern "C" int tree_hist(const void* bins, int bins_int8, const void* nid,
                         const void* stats, void* keys, void* list,
                         void* out, long long n_rows, int n_feat, int n_bins,
                         int n_parents, int left_only,
                         long long rows_per_block, int n_chunks, int n_groups,
                         int replicas, int threads, long long smem,
                         void* stream) {
  return launch_slab_hist(bins, bins_int8, nid, stats, keys, list, out,
                          n_rows, n_feat, n_bins, n_parents, left_only,
                          rows_per_block, n_chunks, n_groups, replicas,
                          threads, smem, stream);
}

// ----------------------------------------------------------- tree_split
// Replaces the phase boundary (_level_boundary, treekernel.py:106, which
// runs h2o3_tpu/ops/split_scan.py best_splits): sibling subtraction with
// the w/h >= 0 clamps, the best split of every node over (feature,
// threshold, NA direction) with categorical sorted-prefix subsets,
// monotone constraints and the column mask, then the min-split-
// improvement and depth-limit masks and the categorical-split flag.
//
// Bound: the level's histograms are small (L*F*B*12 bytes, 483 KB at the
// deepest flagship level), so the kernel is bound by latency and by its
// per-(node, feature) arithmetic, not by device memory.
// Design: one block per node, one warp per (node, feature) at a time.
// A warp loads the feature's B bins, ranks categorical bins by counting
// (rank(b) = #{b': key[b'] < key[b] or (key[b'] == key[b] and b' < b)},
// NaN keys last, empty bins key to +inf), permutes them into that order,
// takes a warp prefix sum, and scores every threshold in both NA
// directions. The block argmax over the flattened [F, B-1, 2] index keeps
// the first maximum, lets a NaN gain win as jnp.argmax does, and returns
// index 0 when every gain is -inf. The winning feature's leftmask is the
// inverse permutation: b goes left iff rank(b) <= t. All gain arithmetic
// is spelled with _rn intrinsics (and the file builds with -fmad=false)
// so it rounds as the plain float32 version does; only the prefix sums
// add in another order.

struct Cand {
  float g;
  int idx;
  float lv, rv;
};

__device__ __forceinline__ bool better(const Cand& a, const Cand& b) {
  const bool an = isnan(a.g), bn = isnan(b.g);
  if (an || bn) return an && (!bn || a.idx < b.idx);
  if (a.g != b.g) return a.g > b.g;
  return a.idx < b.idx;
}

// ascending order with NaN last and equal keys by position (stable)
__device__ __forceinline__ bool key_before(float k2, int b2, float k,
                                           int b) {
  const bool n2 = isnan(k2), n = isnan(k);
  if (n2 || n) return n && (!n2 || b2 < b);
  return k2 < k || (k2 == k && b2 < b);
}

// jnp.clip(x, lo, hi) = minimum(hi, maximum(lo, x)), NaN propagating
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  if (isnan(x)) return x;
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

__device__ __forceinline__ float newton_key(float w, float g, float h,
                                            float lam) {
  return w > 0.f ? __fdiv_rn(-g, __fadd_rn(__fadd_rn(h, lam), 1e-10f))
                 : INFINITY;
}

__device__ __forceinline__ Cand shfl_cand(const Cand& c, int off) {
  Cand o;
  o.g = __shfl_down_sync(0xffffffffu, c.g, off);
  o.idx = __shfl_down_sync(0xffffffffu, c.idx, off);
  o.lv = __shfl_down_sync(0xffffffffu, c.lv, off);
  o.rv = __shfl_down_sync(0xffffffffu, c.rv, off);
  return o;
}

// warp-inclusive prefix sum of p[0..n) in place: each lane sums its own
// contiguous run sequentially, then adds the lanes' exclusive offsets
__device__ void warp_prefix(float* p, int n, int lane) {
  const int k = (n + 31) / 32;
  const int lo = min(lane * k, n), hi = min(lo + k, n);
  float acc = 0.f;
  for (int i = lo; i < hi; ++i) {
    acc = (i == lo) ? p[i] : __fadd_rn(acc, p[i]);
    p[i] = acc;
  }
  float incl = acc;
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl = __fadd_rn(y, incl);
  }
  const float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane > 0)
    for (int i = lo; i < hi; ++i) p[i] = __fadd_rn(excl, p[i]);
  __syncwarp();
}

__global__ void tree_split_kernel(
    const float* __restrict__ lh, const float* __restrict__ prev,
    const int8_t* __restrict__ col_mask, const int32_t* __restrict__ nb,
    const int8_t* __restrict__ is_cat, const int8_t* __restrict__ cons,
    const float* __restrict__ lo, const float* __restrict__ hi,
    const float* __restrict__ knobs, const int32_t* __restrict__ depth_limit,
    float* __restrict__ hist, float* __restrict__ gain_out,
    int32_t* __restrict__ feat_out, int32_t* __restrict__ thresh_out,
    uint8_t* __restrict__ nal_out, float* __restrict__ lv_out,
    float* __restrict__ rv_out, uint8_t* __restrict__ leftmask,
    uint8_t* __restrict__ split_out, uint8_t* __restrict__ cs_out, int d,
    int n_feat, int n_bins, int cm_rows, int bound_rows) {
  extern __shared__ float smem[];
  const int node = blockIdx.x;
  const int nwarps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int B = n_bins, Bm = n_bins - 1;
  // per-warp scratch: orig w/g/h [B] (NA at B-1), sorted w/g/h [B], key [B]
  float* ow = smem + warp * 7 * B;
  float* og = ow + B;
  float* oh = og + B;
  float* sw = oh + B;
  float* sg = sw + B;
  float* sh = sg + B;
  float* key = sh + B;
  Cand* red = reinterpret_cast<Cand*>(smem + nwarps * 7 * B);

  const float min_rows = knobs[0], lam = knobs[1], msi = knobs[2];
  const float lo_n = lo[bound_rows == 1 ? 0 : node];
  const float hi_n = hi[bound_rows == 1 ? 0 : node];
  const int parent = d == 0 ? 0 : node >> 1;
  const bool right = d > 0 && (node & 1);

  Cand best;
  best.g = -INFINITY;
  best.idx = 0x7fffffff;
  best.lv = best.rv = 0.f;

  for (int f = warp; f < n_feat; f += nwarps) {
    // this node's [B, 3] histogram row: the left child as accumulated,
    // the right child as parent - left with w, h clamped at 0
    const long long src = (static_cast<long long>(parent) * n_feat + f) * B * 3;
    const long long dst = (static_cast<long long>(node) * n_feat + f) * B * 3;
    for (int b = lane; b < B; b += 32) {
      float v[3];
      for (int s = 0; s < 3; ++s) {
        float x = lh[src + b * 3 + s];
        if (right) {
          x = __fsub_rn(prev[src + b * 3 + s], x);
          if (s != 1 && x < 0.f) x = 0.f;
        }
        v[s] = x;
        hist[dst + b * 3 + s] = x;
      }
      ow[b] = v[0];
      og[b] = v[1];
      oh[b] = v[2];
    }
    __syncwarp();
    const bool cat = is_cat != nullptr && is_cat[f] != 0;
    float *cw = ow, *cg = og, *ch = oh;
    if (cat) {
      for (int b = lane; b < Bm; b += 32)
        key[b] = newton_key(ow[b], og[b], oh[b], lam);
      __syncwarp();
      for (int b = lane; b < Bm; b += 32) {
        const float kb = key[b];
        int rank = 0;
        for (int b2 = 0; b2 < Bm; ++b2) rank += key_before(key[b2], b2, kb, b);
        sw[rank] = ow[b];
        sg[rank] = og[b];
        sh[rank] = oh[b];
      }
      __syncwarp();
      cw = sw;
      cg = sg;
      ch = sh;
    }
    const float naw = ow[Bm], nag = og[Bm], nah = oh[Bm];
    warp_prefix(cw, Bm, lane);
    warp_prefix(cg, Bm, lane);
    warp_prefix(ch, Bm, lane);
    const float tw = __fadd_rn(cw[Bm - 1], naw);
    const float tg = __fadd_rn(cg[Bm - 1], nag);
    const float th = __fadd_rn(ch[Bm - 1], nah);
    const float parent_term = __fdiv_rn(__fmul_rn(tg, tg), __fadd_rn(th, lam));
    const bool col_ok = col_mask[(cm_rows == 1 ? 0 : node) * n_feat + f] != 0;
    const float c = cons != nullptr ? static_cast<float>(cons[f]) : 0.f;
    const int t_max = nb[f] - 2;
    for (int t = lane; t < Bm; t += 32) {
      for (int dir = 0; dir < 2; ++dir) {  // 0: NA right, 1: NA left
        float wl = cw[t], gl = cg[t], hl = ch[t];
        if (dir) {
          wl = __fadd_rn(wl, naw);
          gl = __fadd_rn(gl, nag);
          hl = __fadd_rn(hl, nah);
        }
        const float wr = __fsub_rn(tw, wl);
        const float gr = __fsub_rn(tg, gl);
        const float hr = __fsub_rn(th, hl);
        const float hlr = __fadd_rn(hl, lam), hrr = __fadd_rn(hr, lam);
        Cand k;
        k.lv = clip(__fdiv_rn(-gl, hlr), lo_n, hi_n);
        k.rv = clip(__fdiv_rn(-gr, hrr), lo_n, hi_n);
        bool ok = wl >= min_rows && wr >= min_rows;
        if (cons != nullptr) ok = ok && __fmul_rn(c, __fsub_rn(k.rv, k.lv)) >= 0.f;
        const float gsum = __fadd_rn(__fdiv_rn(__fmul_rn(gl, gl), hlr),
                                     __fdiv_rn(__fmul_rn(gr, gr), hrr));
        k.g = ok ? __fsub_rn(gsum, parent_term) : -INFINITY;
        if (!(col_ok && t <= t_max)) k.g = -INFINITY;
        k.idx = (f * Bm + t) * 2 + dir;
        if (better(k, best)) best = k;
      }
    }
    __syncwarp();
  }
  for (int off = 16; off > 0; off >>= 1) {
    const Cand o = shfl_cand(best, off);
    if (better(o, best)) best = o;
  }
  if (lane == 0) red[warp] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    Cand b = red[0];
    for (int w = 1; w < nwarps; ++w)
      if (better(red[w], b)) b = red[w];
    red[0] = b;
  }
  __syncthreads();
  const Cand win = red[0];
  const int bf = win.idx / (2 * Bm);
  const int bt = (win.idx / 2) % Bm;
  const bool win_cat = is_cat != nullptr && is_cat[bf] != 0;
  if (threadIdx.x == 0) {
    const bool split = win.g > msi && d < depth_limit[0];
    gain_out[node] = win.g;
    feat_out[node] = bf;
    thresh_out[node] = bt;
    nal_out[node] = win.idx % 2;
    lv_out[node] = win.lv;
    rv_out[node] = win.rv;
    split_out[node] = split;
    cs_out[node] = win_cat && split;
  }
  // leftmask of the winning feature, over ORIGINAL bin ids
  uint8_t* lm = leftmask + static_cast<long long>(node) * Bm;
  if (win_cat) {
    float* wkey = smem;  // scratch free again after the reduction
    const long long row = (static_cast<long long>(node) * n_feat + bf) * B * 3;
    for (int b = threadIdx.x; b < Bm; b += blockDim.x)
      wkey[b] = newton_key(hist[row + b * 3], hist[row + b * 3 + 1],
                           hist[row + b * 3 + 2], lam);
    __syncthreads();
    for (int b = threadIdx.x; b < Bm; b += blockDim.x) {
      const float kb = wkey[b];
      int rank = 0;
      for (int b2 = 0; b2 < Bm; ++b2) rank += key_before(wkey[b2], b2, kb, b);
      lm[b] = rank <= bt;
    }
  } else {
    for (int b = threadIdx.x; b < Bm; b += blockDim.x) lm[b] = b <= bt;
  }
}

extern "C" int tree_split(const void* lh, const void* prev,
                          const void* col_mask, const void* nb,
                          const void* is_cat, const void* cons,
                          const void* lo, const void* hi, const void* knobs,
                          const void* depth_limit, void* hist, void* gain,
                          void* feat, void* thresh, void* na_left, void* lv,
                          void* rv, void* leftmask, void* split, void* cs,
                          int d, int n_nodes, int n_feat, int n_bins,
                          int cm_rows, int bound_rows, int n_warps,
                          void* stream) {
  const size_t smem = static_cast<size_t>(n_warps) * 7 * n_bins * sizeof(float) +
                      n_warps * sizeof(Cand);
  cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(&tree_split_kernel), smem);
  if (err != cudaSuccess) return err;
  tree_split_kernel<<<n_nodes, 32 * n_warps, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lh), static_cast<const float*>(prev),
      static_cast<const int8_t*>(col_mask), static_cast<const int32_t*>(nb),
      static_cast<const int8_t*>(is_cat), static_cast<const int8_t*>(cons),
      static_cast<const float*>(lo), static_cast<const float*>(hi),
      static_cast<const float*>(knobs),
      static_cast<const int32_t*>(depth_limit), static_cast<float*>(hist),
      static_cast<float*>(gain), static_cast<int32_t*>(feat),
      static_cast<int32_t*>(thresh), static_cast<uint8_t*>(na_left),
      static_cast<float*>(lv), static_cast<float*>(rv),
      static_cast<uint8_t*>(leftmask), static_cast<uint8_t*>(split),
      static_cast<uint8_t*>(cs), d, n_feat, n_bins, cm_rows, bound_rows);
  return cudaGetLastError();
}

// ------------------------------------------------------- tree_partition
// Replaces phase 1 (_partition_block, treekernel.py:137): route every row
// to child 2*nid + {0: left, 1: right}. A node that did not split sends
// all its rows left; NA (bin B-1) follows na_left; a categorical split
// tests leftmask[nid, bin]; a numeric split sends bin <= thresh left.
//
// Bound: bytes (the row's nid, one bin byte of its node's feature, the
// new nid); integer work only, so it is exact.
// Design: one thread per row in a grid-stride loop over a few waves of
// blocks; each block first stages the level's node tables (feature,
// threshold, flags, and the [L, B-1] leftmask when it fits) in shared
// memory, so a row's lookups never leave the SM.

template <typename BinT>
__global__ void tree_partition_kernel(
    const BinT* __restrict__ bins, const int32_t* __restrict__ nid,
    int32_t* __restrict__ out, const int32_t* __restrict__ feat,
    const int32_t* __restrict__ thresh, const uint8_t* __restrict__ na_left,
    const uint8_t* __restrict__ split, const uint8_t* __restrict__ cs,
    const uint8_t* __restrict__ leftmask, long long n_rows, int n_feat,
    int n_bins, int n_nodes, int mask_in_smem) {
  extern __shared__ int32_t tab[];
  int32_t* s_feat = tab;
  int32_t* s_thr = tab + n_nodes;
  uint8_t* s_flag = reinterpret_cast<uint8_t*>(tab + 2 * n_nodes);
  uint8_t* s_mask = s_flag + n_nodes;
  const int Bm = n_bins - 1;
  for (int i = threadIdx.x; i < n_nodes; i += blockDim.x) {
    s_feat[i] = feat[i];
    s_thr[i] = thresh[i];
    s_flag[i] = (na_left[i] ? 1 : 0) | (split[i] ? 2 : 0) | (cs[i] ? 4 : 0);
  }
  if (mask_in_smem)
    for (int i = threadIdx.x; i < n_nodes * Bm; i += blockDim.x)
      s_mask[i] = leftmask[i];
  const uint8_t* mask = mask_in_smem ? s_mask : leftmask;
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       r < n_rows; r += stride) {
    const int n = nid[r];
    int go_left = 1;
    if (static_cast<unsigned>(n) < static_cast<unsigned>(n_nodes)) {
      const int fl = s_flag[n];
      if (fl & 2) {
        const int b = static_cast<int>(bins[r * n_feat + s_feat[n]]);
        if (b == Bm)
          go_left = fl & 1;
        else if (fl & 4)
          go_left = static_cast<unsigned>(b) < static_cast<unsigned>(Bm) &&
                    mask[static_cast<long long>(n) * Bm + b];
        else
          go_left = b <= s_thr[n];
      }
    }
    out[r] = 2 * n + (go_left ? 0 : 1);
  }
}

extern "C" int tree_partition(const void* bins, int bins_int8,
                              const void* nid, void* out, const void* feat,
                              const void* thresh, const void* na_left,
                              const void* split, const void* cs,
                              const void* leftmask, long long n_rows,
                              int n_feat, int n_bins, int n_nodes,
                              int n_blocks, void* stream) {
  const size_t tables = static_cast<size_t>(n_nodes) * 9;
  const size_t with_mask = tables + static_cast<size_t>(n_nodes) * (n_bins - 1);
  const int mask_in_smem = with_mask <= 160 * 1024;
  const size_t smem = mask_in_smem ? with_mask : tables;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bins_int8) {
    err = allow_smem(
        reinterpret_cast<const void*>(&tree_partition_kernel<int8_t>), smem);
    if (err != cudaSuccess) return err;
    tree_partition_kernel<int8_t><<<n_blocks, 256, smem, s>>>(
        static_cast<const int8_t*>(bins), static_cast<const int32_t*>(nid),
        static_cast<int32_t*>(out), static_cast<const int32_t*>(feat),
        static_cast<const int32_t*>(thresh),
        static_cast<const uint8_t*>(na_left),
        static_cast<const uint8_t*>(split), static_cast<const uint8_t*>(cs),
        static_cast<const uint8_t*>(leftmask), n_rows, n_feat, n_bins,
        n_nodes, mask_in_smem);
  } else {
    err = allow_smem(
        reinterpret_cast<const void*>(&tree_partition_kernel<int32_t>), smem);
    if (err != cudaSuccess) return err;
    tree_partition_kernel<int32_t><<<n_blocks, 256, smem, s>>>(
        static_cast<const int32_t*>(bins), static_cast<const int32_t*>(nid),
        static_cast<int32_t*>(out), static_cast<const int32_t*>(feat),
        static_cast<const int32_t*>(thresh),
        static_cast<const uint8_t*>(na_left),
        static_cast<const uint8_t*>(split), static_cast<const uint8_t*>(cs),
        static_cast<const uint8_t*>(leftmask), n_rows, n_feat, n_bins,
        n_nodes, mask_in_smem);
  }
  return cudaGetLastError();
}
