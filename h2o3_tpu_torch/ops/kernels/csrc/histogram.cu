// The full (node, feature, bin) histogram on one H100: every node is
// summed, with no sibling subtraction. Plain C interface (no PyTorch
// headers), loaded through ctypes by h2o3_tpu_torch/ops/kernels/
// histogram.py, which also holds the plain PyTorch version.
//
// Replaces: h2o3_tpu/ops/pallas_histogram.py pallas_local_histogram
// (pallas_call at :94). The TPU kernel builds one-hot indicators of
// (node, stat) and (feature, bin) per row block in VMEM and contracts
// them on the MXU into a [3L, F*B] accumulator carried across a
// sequential row-block grid. On Hopper the one-hot product would spend
// L*F*B multiply-adds per row on a scatter of F cells, and blocks run in
// no order, so the kernel scatters instead: slab_hist_kernel
// (hist_slab.cuh) with the left-child path off.
//
// Inputs: bins [N, F] int8 or int32 (NA folded in as bin B-1), nid [N]
// int32, stats [N, 3] float32. Output: [L, F, B, 3] float32, zeroed by the
// caller; rows whose nid lies outside [0, L) or whose bin lies outside
// [0, B) contribute nothing.
//
// Bound: bytes. One launch must read N*(F*bin bytes + 4 + 12) bytes and
// write L*F*B*12; the work is 3*N*F adds. What sets its time on the card
// is neither: it is the shared-memory atomics, three per (row, feature)
// that counts.
// Design: slab_hist_kernel (hist_slab.cuh) with the left-child path off,
// in 64-bit fixed point so that two runs give the same bits. One block
// per SM covers all F features of its rows, walking the node chunks of a
// [nodes, F, B, 3] slab of 8-byte cells of up to 227 KB: 12 nodes at
// F = 12, B = 65, so L <= 8 runs in one chunk and L = 512 (the deepest
// uplift level: 5 MB of output) in 43. Past two chunks the block first
// sorts its rows by chunk, so a chunk reads only its own rows. At shallow
// levels each warp adds into its own copy of the slab (12 copies at
// L = 1). Rows whose stats are all zero (out of bag, or the other arm of
// an uplift split) are skipped before their bin is read, and the scatter
// runs on full warps of rows that count. A second, small launch converts
// the int64 cells to float32.

#include "hist_slab.cuh"

extern "C" int histogram(const void* bins, int bins_int8, const void* nid,
                         const void* stats, const void* exps, void* keys,
                         void* list, void* acc, void* out, long long n_rows,
                         int n_feat, int n_bins, int n_nodes,
                         long long rows_per_block, int n_chunks, int n_groups,
                         int replicas, int threads, long long smem,
                         void* stream) {
  return launch_slab_hist(bins, bins_int8, nid, stats, exps, keys, list, acc,
                          out, n_rows, n_feat, n_bins, n_nodes,
                          /*left_only=*/0, rows_per_block, n_chunks, n_groups,
                          replicas, threads, smem, /*convert=*/1, stream);
}
