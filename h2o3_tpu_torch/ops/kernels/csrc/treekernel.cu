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
// card's arithmetic rate, but the shared-memory atomics set its time.
// Design: slab_hist_kernel (hist_slab.cuh), in 64-bit fixed point so
// that two runs give the same bits. One block per SM covers all F
// features of its rows, walking the node chunks of a [nodes, F, B, 3]
// slab of 8-byte cells of up to 227 KB (7 nodes at B = 126: the
// flagship's depths run in one chunk each up to Lh = 4, then 2 at Lh = 8
// and 3 at Lh = 16; depth bucket 10's Lh = 256 in 37, rows sorted by chunk
// first beyond 2). Right-child rows never reach the scatter, which runs
// on full warps of left-child rows. Where the slab fits twice or more,
// each warp adds into its own copy of it (7 copies at d = 0), so warps do
// not collide on a shallow level's hot bins. A second, small launch
// converts the int64 cells to float32.

extern "C" int tree_hist(const void* bins, int bins_int8, const void* nid,
                         const void* stats, const void* exps, void* keys,
                         void* list, void* acc, void* out, long long n_rows,
                         int n_feat, int n_bins, int n_parents, int left_only,
                         long long rows_per_block, int n_chunks, int n_groups,
                         int replicas, int threads, long long smem,
                         int convert, void* stream) {
  return launch_slab_hist(bins, bins_int8, nid, stats, exps, keys, list, acc,
                          out, n_rows, n_feat, n_bins, n_parents, left_only,
                          rows_per_block, n_chunks, n_groups, replicas,
                          threads, smem, convert, stream);
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
// deepest flagship level), so the kernel is bound by the length of its
// chain of dependent steps and by the launch, not by device memory.
// Design: one block per (node, feature), one thread per bin (a run of
// `per_thread` bins where B-1 exceeds 1024), so every step is a block-
// wide parallel one and the level's nodes and features fill the card.
// A block subtracts and writes its [B, 3] histogram row, then, for a
// categorical feature, sorts its (Newton key, bin) pairs with a bitonic
// sort in shared memory (NaN keys last, equal keys by bin: the stable
// order), takes three block-wide inclusive prefix sums, scores every
// threshold in both NA directions and keeps its best candidate by
// `better`. A feature the column mask drops skips the sort, the scan of
// thresholds and the scoring: its candidate is the one a full scan
// reaches when every gain is -inf, t = 0 with NA right, whose left child
// is the bin with the lowest (key, bin). Of these only feature 0's can
// win: a masked feature f > 0 loses to feature 0's first candidate,
// which has a lower index and a gain of at least -inf, so its block
// publishes gain -inf at once. Each block writes its candidate
// and its left set (as bits over original bin ids) to scratch and counts
// itself in its node's arrival counter; the node's last block reduces
// the F candidates with `better` (a total order, so the winner does not
// depend on which block comes last), writes the node's outputs and the
// leftmask, and sets the counter back to 0 for the next launch. All gain
// arithmetic is spelled with _rn intrinsics (and the file builds with
// -fmad=false) so it rounds as the plain float32 version does; only the
// prefix sums add in another order.

struct Cand {
  float g;
  int idx;
  float lv, rv;
};

// the better of two candidates: a NaN gain wins (as jnp.argmax lets it),
// then the larger gain, then the lower flat [F, B-1, 2] index
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

// the block's best candidate, returned to every thread; `red` holds one
// Cand per warp
__device__ Cand block_best(Cand c, Cand* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    const Cand o = shfl_cand(c, off);
    if (better(o, c)) c = o;
  }
  __syncthreads();
  if (lane == 0) red[warp] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w)
      if (better(red[w], c)) c = red[w];
    red[0] = c;
  }
  __syncthreads();
  return red[0];
}

// the first bin of the stable (key, bin) order over the block's keys,
// returned to every thread; `red` as in block_best
__device__ int block_first_bin(const float* key, int n, Cand* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float k = NAN;
  int b = 0x7fffffff;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    if (key_before(key[i], i, k, b)) k = key[i], b = i;
  for (int off = 16; off > 0; off >>= 1) {
    const float k2 = __shfl_down_sync(0xffffffffu, k, off);
    const int b2 = __shfl_down_sync(0xffffffffu, b, off);
    if (key_before(k2, b2, k, b)) k = k2, b = b2;
  }
  __syncthreads();
  if (lane == 0) red[warp].g = k, red[warp].idx = b;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w)
      if (key_before(red[w].g, red[w].idx, k, b)) k = red[w].g, b = red[w].idx;
    red[0].idx = b;
  }
  __syncthreads();
  return red[0].idx;
}

// in-place inclusive prefix sums of a, b, c [blockDim.x * per]: thread t
// sums its own run [t*per, t*per + per) in order, the warps scan the run
// totals by shuffles, and one warp scans the warp totals (`wsum`, 96
// floats); an offset is added only where one exists, so a prefix keeps
// the sign of a zero as a plain cumulative sum does
__device__ void block_scan3(float* a, float* b, float* c, int per,
                            float* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5, lo = threadIdx.x * per;
  float sa = a[lo], sb = b[lo], sc = c[lo];
  for (int i = 1; i < per; ++i) {
    sa = __fadd_rn(sa, a[lo + i]);
    sb = __fadd_rn(sb, b[lo + i]);
    sc = __fadd_rn(sc, c[lo + i]);
    a[lo + i] = sa;
    b[lo + i] = sb;
    c[lo + i] = sc;
  }
  for (int o = 1; o < 32; o <<= 1) {
    const float ya = __shfl_up_sync(0xffffffffu, sa, o);
    const float yb = __shfl_up_sync(0xffffffffu, sb, o);
    const float yc = __shfl_up_sync(0xffffffffu, sc, o);
    if (lane >= o) {
      sa = __fadd_rn(ya, sa);
      sb = __fadd_rn(yb, sb);
      sc = __fadd_rn(yc, sc);
    }
  }
  if (lane == 31) {
    wsum[warp] = sa;
    wsum[32 + warp] = sb;
    wsum[64 + warp] = sc;
  }
  __syncthreads();
  if (warp == 0) {
    float va = lane < nw ? wsum[lane] : 0.f;
    float vb = lane < nw ? wsum[32 + lane] : 0.f;
    float vc = lane < nw ? wsum[64 + lane] : 0.f;
    for (int o = 1; o < 32; o <<= 1) {
      const float ya = __shfl_up_sync(0xffffffffu, va, o);
      const float yb = __shfl_up_sync(0xffffffffu, vb, o);
      const float yc = __shfl_up_sync(0xffffffffu, vc, o);
      if (lane >= o) {
        va = __fadd_rn(ya, va);
        vb = __fadd_rn(yb, vb);
        vc = __fadd_rn(yc, vc);
      }
    }
    __syncwarp();
    if (lane < nw) {  // inclusive totals of the warps before this one
      wsum[lane] = va;
      wsum[32 + lane] = vb;
      wsum[64 + lane] = vc;
    }
  }
  __syncthreads();
  // this thread's offset: the warps before it, then the lanes before it
  float oa = __shfl_up_sync(0xffffffffu, sa, 1);
  float ob = __shfl_up_sync(0xffffffffu, sb, 1);
  float oc = __shfl_up_sync(0xffffffffu, sc, 1);
  const bool has_lane = lane > 0, has_warp = warp > 0;
  if (has_warp) {
    const float wa = wsum[warp - 1], wb = wsum[32 + warp - 1],
                wc = wsum[64 + warp - 1];
    oa = has_lane ? __fadd_rn(wa, oa) : wa;
    ob = has_lane ? __fadd_rn(wb, ob) : wb;
    oc = has_lane ? __fadd_rn(wc, oc) : wc;
  }
  if (has_lane || has_warp)
    for (int i = 0; i < per; ++i) {
      a[lo + i] = __fadd_rn(oa, a[lo + i]);
      b[lo + i] = __fadd_rn(ob, b[lo + i]);
      c[lo + i] = __fadd_rn(oc, c[lo + i]);
    }
  __syncthreads();
}

// bitonic sort of (key, bin) pairs [0, n_sort) in shared memory into the
// stable ascending order of key_before; n_sort is a power of two. Where
// n_sort == blockDim.x each thread holds one pair in registers and the
// stages with partners in its own warp exchange by shuffles; the others
// (and wider sorts) go through shared memory, a barrier a stage.
__device__ void block_sort(float* key, int* bin, int n_sort) {
  if (n_sort == static_cast<int>(blockDim.x)) {
    const int i = threadIdx.x;
    float k = key[i];
    int b = bin[i];
    for (int size = 2; size <= n_sort; size <<= 1)
      for (int j = size >> 1; j > 0; j >>= 1) {
        float pk;
        int pb;
        if (j >= 32) {
          __syncthreads();
          key[i] = k;
          bin[i] = b;
          __syncthreads();
          pk = key[i ^ j];
          pb = bin[i ^ j];
        } else {
          pk = __shfl_xor_sync(0xffffffffu, k, j);
          pb = __shfl_xor_sync(0xffffffffu, b, j);
        }
        // the lower index of an ascending pair keeps the first of the two
        const bool low_first = ((i & j) == 0) == ((i & size) == 0);
        if (key_before(pk, pb, k, b) == low_first) k = pk, b = pb;
      }
    __syncthreads();
    key[i] = k;
    bin[i] = b;
    __syncthreads();
    return;
  }
  for (int k = 2; k <= n_sort; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n_sort; i += blockDim.x) {
        const int p = i ^ j;
        if (p > i) {
          const float ki = key[i], kp = key[p];
          const int bi = bin[i], bp = bin[p];
          const bool up = (i & k) == 0;
          if (up ? key_before(kp, bp, ki, bi) : key_before(ki, bi, kp, bp)) {
            key[i] = kp;
            key[p] = ki;
            bin[i] = bp;
            bin[p] = bi;
          }
        }
      }
      __syncthreads();
    }
}

// Shared memory of one block (split_plan in treekernel.py sizes it):
// orig w/g/h [B] (NA at B-1), scan-order w/g/h [R = blockDim * per],
// sort keys [S] (then the ranks), sort bins [S], warp totals [96], one
// Cand a warp [32]. The launch bound keeps the registers within what a
// block of kSplitThreads (B = 1025: 1024 sort slots) can hold.
constexpr int kSplitThreads = 1024;

__global__ void __launch_bounds__(kSplitThreads) tree_split_kernel(
    const float* __restrict__ lh, const float* __restrict__ prev,
    const int8_t* __restrict__ col_mask, const int32_t* __restrict__ nb,
    const int8_t* __restrict__ is_cat, const int8_t* __restrict__ cons,
    const float* __restrict__ lo, const float* __restrict__ hi,
    const float* __restrict__ knobs, const int32_t* __restrict__ depth_limit,
    float* __restrict__ hist, float* __restrict__ gain_out,
    int32_t* __restrict__ feat_out, int32_t* __restrict__ thresh_out,
    uint8_t* __restrict__ nal_out, float* __restrict__ lv_out,
    float* __restrict__ rv_out, uint8_t* __restrict__ leftmask,
    uint8_t* __restrict__ split_out, uint8_t* __restrict__ cs_out,
    Cand* __restrict__ cands, uint32_t* __restrict__ bits,
    int* __restrict__ arrivals, int d, int n_feat, int n_bins, int cm_rows,
    int bound_rows, int per, int n_sort) {
  extern __shared__ float smem[];
  const int node = blockIdx.x / n_feat, f = blockIdx.x % n_feat;
  const int tid = threadIdx.x, T = blockDim.x;
  const int B = n_bins, Bm = n_bins - 1, R = T * per;
  const int W = (Bm + 31) / 32;
  float* ow = smem;
  float* og = ow + B;
  float* oh = og + B;
  float* cw = oh + B;
  float* cg = cw + R;
  float* ch = cg + R;
  float* key = ch + R;
  int* rank = reinterpret_cast<int*>(key);  // after the sort
  int* sbin = reinterpret_cast<int*>(key + n_sort);
  float* wsum = reinterpret_cast<float*>(sbin + n_sort);
  Cand* red = reinterpret_cast<Cand*>(wsum + 96);

  const float min_rows = knobs[0], lam = knobs[1], msi = knobs[2];
  const float lo_n = lo[bound_rows == 1 ? 0 : node];
  const float hi_n = hi[bound_rows == 1 ? 0 : node];
  const int parent = d == 0 ? 0 : node >> 1;
  const bool right = d > 0 && (node & 1);
  const bool cat = is_cat != nullptr && is_cat[f] != 0;
  const int8_t* cm_row = col_mask + (cm_rows == 1 ? 0 : node) * n_feat;
  const bool col_ok = cm_row[f] != 0;
  // a masked feature past f = 0 cannot win (see above): published as is
  const bool shadowed = !col_ok && f > 0;

  // this (node, feature)'s [B, 3] histogram row: the left child as
  // accumulated, the right child as parent - left with w, h clamped at 0
  const long long src = (static_cast<long long>(parent) * n_feat + f) * B * 3;
  const long long dst = (static_cast<long long>(node) * n_feat + f) * B * 3;
  for (int b = tid; b < B; b += T) {
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
    if (cat && b < Bm) key[b] = newton_key(v[0], v[1], v[2], lam);
  }
  const long long slot = static_cast<long long>(node) * n_feat + f;
  Cand win;
  win.g = -INFINITY;
  win.idx = f * Bm * 2;
  win.lv = win.rv = 0.f;
  if (!shadowed) {
    __syncthreads();
    // the scan order: the stable (key, bin) order of a categorical
    // feature the mask keeps, else bin order; a masked categorical
    // feature needs only its first bin
    int first = 0;
    if (cat && col_ok) {
      for (int i = tid; i < n_sort; i += T) {
        if (i >= Bm) key[i] = NAN;  // padding sorts after every bin
        sbin[i] = i;
      }
      __syncthreads();
      block_sort(key, sbin, n_sort);
    } else if (cat) {
      first = block_first_bin(key, Bm, red);
    }
    for (int p = tid; p < R; p += T) {
      const int b = p < Bm ? (cat && col_ok ? sbin[p] : p) : -1;
      cw[p] = b >= 0 ? ow[b] : 0.f;
      cg[p] = b >= 0 ? og[b] : 0.f;
      ch[p] = b >= 0 ? oh[b] : 0.f;
      if (cat && col_ok && b >= 0) rank[b] = p;
    }
    __syncthreads();
    const float naw = ow[Bm], nag = og[Bm], nah = oh[Bm];
    // t = 0's left sums, before the scan overwrites them
    const float w0 = cat && !col_ok ? ow[first] : cw[0];
    const float g0 = cat && !col_ok ? og[first] : cg[0];
    const float h0 = cat && !col_ok ? oh[first] : ch[0];
    block_scan3(cw, cg, ch, per, wsum);
    const float tw = __fadd_rn(cw[Bm - 1], naw);
    const float tg = __fadd_rn(cg[Bm - 1], nag);
    const float th = __fadd_rn(ch[Bm - 1], nah);
    const float parent_term =
        __fdiv_rn(__fmul_rn(tg, tg), __fadd_rn(th, lam));
    const float c = cons != nullptr ? static_cast<float>(cons[f]) : 0.f;
    const int t_max = nb[f] - 2;

    // score: one thread per threshold of its run, both NA directions
    Cand best;
    best.g = -INFINITY;
    best.idx = 0x7fffffff;
    best.lv = best.rv = 0.f;
    const int t_lo = col_ok ? tid * per : (tid == 0 ? 0 : Bm);
    const int t_hi = col_ok ? min(t_lo + per, Bm) : (tid == 0 ? 1 : Bm);
    for (int t = t_lo; t < t_hi; ++t) {
      for (int dir = 0; dir < 2; ++dir) {  // 0: NA right, 1: NA left
        float wl = col_ok ? cw[t] : w0, gl = col_ok ? cg[t] : g0,
              hl = col_ok ? ch[t] : h0;
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
        if (cons != nullptr)
          ok = ok && __fmul_rn(c, __fsub_rn(k.rv, k.lv)) >= 0.f;
        const float gsum = __fadd_rn(__fdiv_rn(__fmul_rn(gl, gl), hlr),
                                     __fdiv_rn(__fmul_rn(gr, gr), hrr));
        k.g = ok ? __fsub_rn(gsum, parent_term) : -INFINITY;
        if (!(col_ok && t <= t_max)) k.g = -INFINITY;
        k.idx = (f * Bm + t) * 2 + dir;
        if (better(k, best)) best = k;
        if (!col_ok) break;  // the masked candidate is t = 0, NA right
      }
    }
    win = block_best(best, red);

    // publish the left set of a categorical candidate over ORIGINAL bin
    // ids: b goes left iff rank(b) <= t
    if (cat) {
      const int bt = (win.idx / 2) % Bm;
      for (int b0 = 0; b0 < W * 32; b0 += T) {
        const int b = b0 + tid;
        const bool left = b < Bm && (col_ok ? rank[b] <= bt : b == first);
        const unsigned word = __ballot_sync(0xffffffffu, left);
        if ((tid & 31) == 0 && (b >> 5) < W) bits[slot * W + (b >> 5)] = word;
      }
    }
  }
  if (tid == 0) cands[slot] = win;
  __threadfence();
  __syncthreads();
  if (tid == 0) red[0].idx = atomicAdd(arrivals + node, 1) == n_feat - 1;
  __syncthreads();
  if (!red[0].idx) return;

  // the node's last block: reduce its F candidates (written by other
  // blocks, so read past L1)
  __threadfence();
  Cand nb_best;
  nb_best.g = -INFINITY;
  nb_best.idx = 0x7fffffff;
  nb_best.lv = nb_best.rv = 0.f;
  for (int g = tid; g < n_feat; g += T) {
    const Cand* p = cands + static_cast<long long>(node) * n_feat + g;
    Cand o;
    o.g = __ldcg(&p->g);
    o.idx = __ldcg(&p->idx);
    o.lv = __ldcg(&p->lv);
    o.rv = __ldcg(&p->rv);
    if (better(o, nb_best)) nb_best = o;
  }
  const Cand nw = block_best(nb_best, red);
  const int bf = nw.idx / (2 * Bm);
  const int bt = (nw.idx / 2) % Bm;
  const bool win_cat = is_cat != nullptr && is_cat[bf] != 0;
  if (tid == 0) {
    const bool split = nw.g > msi && d < depth_limit[0];
    gain_out[node] = nw.g;
    feat_out[node] = bf;
    thresh_out[node] = bt;
    nal_out[node] = nw.idx % 2;
    lv_out[node] = nw.lv;
    rv_out[node] = nw.rv;
    split_out[node] = split;
    cs_out[node] = win_cat && split;
    arrivals[node] = 0;  // ready for the next launch
  }
  uint8_t* lm = leftmask + static_cast<long long>(node) * Bm;
  const uint32_t* wb = bits + (static_cast<long long>(node) * n_feat + bf) * W;
  for (int b = tid; b < Bm; b += T)
    lm[b] = win_cat ? (__ldcg(wb + (b >> 5)) >> (b & 31)) & 1u : b <= bt;
}

extern "C" int tree_split(const void* lh, const void* prev,
                          const void* col_mask, const void* nb,
                          const void* is_cat, const void* cons,
                          const void* lo, const void* hi, const void* knobs,
                          const void* depth_limit, void* hist, void* gain,
                          void* feat, void* thresh, void* na_left, void* lv,
                          void* rv, void* leftmask, void* split, void* cs,
                          void* cands, void* bits, void* arrivals, int d,
                          int n_nodes, int n_feat, int n_bins, int cm_rows,
                          int bound_rows, int threads, int per, int n_sort,
                          long long smem, void* stream) {
  cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(&tree_split_kernel), smem);
  if (err != cudaSuccess) return err;
  tree_split_kernel<<<static_cast<unsigned>(n_nodes) * n_feat, threads,
                      smem, static_cast<cudaStream_t>(stream)>>>(
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
      static_cast<uint8_t*>(cs), static_cast<Cand*>(cands),
      static_cast<uint32_t*>(bits), static_cast<int*>(arrivals), d, n_feat,
      n_bins, cm_rows, bound_rows, per, n_sort);
  return cudaGetLastError();
}

// ------------------------------------------------------- tree_partition
// Replaces phase 1 (_partition_block, treekernel.py:137): route every row
// to child 2*nid + {0: left, 1: right}. A node that did not split sends
// all its rows left; NA (bin B-1) follows na_left; a categorical split
// tests the node's left set at the row's bin; a numeric split sends
// bin <= thresh left.
//
// Bound: bytes (the row's nid, the bin sector of its node's feature, the
// new nid); integer work only, so it is exact.
// Design: one wave of blocks, kRouteBlocksPerSm an SM (the launch bound
// keeps the registers within it; route_plan in treekernel.py sizes the
// grid, fewer blocks where the shared memory allows fewer). A block stages each node's feature, threshold and flags
// as one 8-byte record in shared memory, and the left sets of the
// categorical splits as bits (ceil((B-1)/32) words a node; where they do
// not fit, the byte leftmask is read from global memory instead). Each
// thread then routes eight rows at a time: two 16-byte nid loads, the
// eight records, the eight bin loads all issued before any is used, and
// two 16-byte stores of the new ids. The host plans the vector part (the
// rows from `head` on, where nid is 16-byte aligned); the few rows before
// it and after it are routed one by one, and where `out` is not aligned
// like nid its stores are scalar.

constexpr int kRouteThreads = 512, kRouteBlocksPerSm = 2;

template <typename BinT>
__global__ void __launch_bounds__(kRouteThreads, kRouteBlocksPerSm)
    tree_partition_kernel(
    const BinT* __restrict__ bins, const int32_t* __restrict__ nid,
    int32_t* __restrict__ out, const int32_t* __restrict__ feat,
    const int32_t* __restrict__ thresh, const uint8_t* __restrict__ na_left,
    const uint8_t* __restrict__ split, const uint8_t* __restrict__ cs,
    const uint8_t* __restrict__ leftmask, long long n_rows, int n_feat,
    int n_bins, int n_nodes, long long head, long long n_vec, int vec_out,
    int bits_in_smem) {
  extern __shared__ int2 rec[];  // x: feat, y: thresh * 8 | flags
  uint32_t* s_bits = reinterpret_cast<uint32_t*>(rec + n_nodes);
  const int Bm = n_bins - 1, W = (Bm + 31) / 32;
  for (int i = threadIdx.x; i < n_nodes; i += blockDim.x)
    rec[i] = make_int2(feat[i], thresh[i] * 8 + (na_left[i] ? 1 : 0) +
                                    (split[i] ? 2 : 0) + (cs[i] ? 4 : 0));
  if (bits_in_smem)
    for (int i = threadIdx.x; i < n_nodes * W; i += blockDim.x) {
      const int n = i / W, b0 = (i % W) * 32;
      if (!(split[n] && cs[n])) continue;
      const uint8_t* m = leftmask + static_cast<long long>(n) * Bm + b0;
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < 32; ++j)
        if (b0 + j < Bm && m[j]) word |= 1u << j;
      s_bits[i] = word;
    }
  __syncthreads();

  // the new id of row r in node n, its record and bin already loaded
  auto route = [&](int n, int2 rc, int b) {
    int go_left = 1;
    if (rc.y & 2) {
      if (b == Bm)
        go_left = rc.y & 1;
      else if (rc.y & 4)
        go_left = static_cast<unsigned>(b) < static_cast<unsigned>(Bm) &&
                  (bits_in_smem
                       ? (s_bits[n * W + (b >> 5)] >> (b & 31)) & 1u
                       : leftmask[static_cast<long long>(n) * Bm + b]);
      else
        go_left = b <= (rc.y >> 3);
    }
    return 2 * n + (go_left ? 0 : 1);
  };
  auto record = [&](int n) {
    return static_cast<unsigned>(n) < static_cast<unsigned>(n_nodes)
               ? rec[n]
               : make_int2(0, 0);  // outside the level: stays left
  };

  const long long gtid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  // the scalar rows: [0, head) and the tail past the vector part
  const long long vec_end = head + 4 * n_vec;
  if (gtid < head + (n_rows - vec_end)) {
    const long long r = gtid < head ? gtid : vec_end + (gtid - head);
    const int n = nid[r];
    const int2 rc = record(n);
    const int b = rc.y & 2 ? static_cast<int>(bins[r * n_feat + rc.x]) : 0;
    out[r] = route(n, rc, b);
  }
  const int4* nid4 = reinterpret_cast<const int4*>(nid + head);
  for (long long u = gtid; u < n_vec; u += 2 * stride) {
    const long long u2 = u + stride;
    const bool two = u2 < n_vec;
    const int4 a = nid4[u];
    const int4 z = two ? nid4[u2] : make_int4(-1, -1, -1, -1);
    const int n[8] = {a.x, a.y, a.z, a.w, z.x, z.y, z.z, z.w};
    int2 rc[8];
    int b[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long r = head + 4 * (i < 4 ? u : u2) + (i & 3);
      rc[i] = record(n[i]);
      b[i] = rc[i].y & 2 ? static_cast<int>(bins[r * n_feat + rc[i].x]) : 0;
    }
    int o[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = route(n[i], rc[i], b[i]);
    int32_t* o1 = out + head + 4 * u;
    int32_t* o2 = out + head + 4 * u2;
    if (vec_out) {
      *reinterpret_cast<int4*>(o1) = make_int4(o[0], o[1], o[2], o[3]);
      if (two) *reinterpret_cast<int4*>(o2) = make_int4(o[4], o[5], o[6], o[7]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) o1[i] = o[i];
      if (two)
#pragma unroll
        for (int i = 0; i < 4; ++i) o2[i] = o[4 + i];
    }
  }
}

template <typename BinT>
static cudaError_t launch_partition(
    const void* bins, const void* nid, void* out, const void* feat,
    const void* thresh, const void* na_left, const void* split,
    const void* cs, const void* leftmask, long long n_rows, int n_feat,
    int n_bins, int n_nodes, long long head, long long n_vec, int vec_out,
    int n_blocks, size_t smem, int bits_in_smem, cudaStream_t s) {
  const cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(&tree_partition_kernel<BinT>), smem);
  if (err != cudaSuccess) return err;
  tree_partition_kernel<BinT><<<n_blocks, kRouteThreads, smem, s>>>(
      static_cast<const BinT*>(bins), static_cast<const int32_t*>(nid),
      static_cast<int32_t*>(out), static_cast<const int32_t*>(feat),
      static_cast<const int32_t*>(thresh),
      static_cast<const uint8_t*>(na_left),
      static_cast<const uint8_t*>(split), static_cast<const uint8_t*>(cs),
      static_cast<const uint8_t*>(leftmask), n_rows, n_feat, n_bins, n_nodes,
      head, n_vec, vec_out, bits_in_smem);
  return cudaGetLastError();
}

extern "C" int tree_partition(const void* bins, int bins_int8,
                              const void* nid, void* out, const void* feat,
                              const void* thresh, const void* na_left,
                              const void* split, const void* cs,
                              const void* leftmask, long long n_rows,
                              int n_feat, int n_bins, int n_nodes,
                              long long head, long long n_vec, int vec_out,
                              int n_blocks, long long smem, int bits_in_smem,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bins_int8
             ? launch_partition<int8_t>(bins, nid, out, feat, thresh, na_left,
                                        split, cs, leftmask, n_rows, n_feat,
                                        n_bins, n_nodes, head, n_vec, vec_out,
                                        n_blocks, smem, bits_in_smem, s)
             : launch_partition<int32_t>(bins, nid, out, feat, thresh,
                                         na_left, split, cs, leftmask, n_rows,
                                         n_feat, n_bins, n_nodes, head, n_vec,
                                         vec_out, n_blocks, smem, bits_in_smem,
                                         s);
}
