// K1: metric-mode approximate EMD (auction-style approxmatch), Hopper.
//
// Replaces the Pallas TPU kernel monopsr_tpu/ops/emd.py:_emd_fused_kernel
// (launched by _emd_cost_fused_pallas, chosen by emd_cost_fused). Same
// value as the plain PyTorch version in monopsr_torch/ops/emd.py
// (emd_cost_fused_plain): per cloud pair, the annealing sweep of
// csrc/emd_sweep.cuh without the gradient accumulators, 11 rounds at level
// -4^j for j = 8..-1, then 0, and the cost sum(w * sqrt(d)) over them.
//
// The TPU kernel keeps the (n, m) plan of a round in VMEM. A block here
// has 227 KB of shared memory and the plan of one 2304 x 2304 pair is
// 21 MB, so the plan is never stored: each pass recomputes its weights
// from the coordinates and 24 (n + m) bytes of state.
//
// Bound on the card: the work is transcendental. Per element and round it
// needs one exp (none in the final level-0 round) and one sqrt, i.e. 21
// special-function results per element over the 11 rounds:
// 128 x 2304^2 x 21 = 1.4e10 at the eval step's (128, 2304, 3) shape.
// Hopper's special-function units give 16 results per clock per SM, so on
// an H100 SXM (132 SMs, 1980 MHz) the bound is 3.4 ms; the inputs (7 MB)
// are negligible. The sweep takes two exps and one rsqrt per element and
// round (an exp in each pass), and one block per pair at the eval step's
// 128 pairs.

#include "emd_sweep.cuh"

// xyz1 (b, n, 3), xyz2 (b, m, 3), cost (b,): contiguous float32. Launches
// on `stream`; returns a cudaError_t.
extern "C" int emd_cost_fused_launch(const float* xyz1, const float* xyz2,
                                     float* cost, int b, int n, int m,
                                     void* stream) {
  const emd_sweep::Grads none = {nullptr, nullptr, nullptr, nullptr};
  return emd_sweep::launch<false>(xyz1, xyz2, cost, none, b, n, m,
                                  static_cast<cudaStream_t>(stream));
}

// Blocks per cloud pair at (b, n, m) on the current device; minus a
// cudaError_t on an error
extern "C" int emd_cost_fused_cluster_size(int b, int n, int m) {
  return emd_sweep::cluster_size<false>(b, n, m);
}

// Clusters of c blocks the current device holds at once at (b, n, m);
// minus a cudaError_t on an error
extern "C" int emd_cost_fused_active_clusters(int b, int n, int m, int c) {
  return emd_sweep::active_clusters<false>(b, n, m, c);
}

extern "C" const char* emd_cost_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
