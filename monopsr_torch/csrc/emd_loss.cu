// K2: approximate EMD loss with its gradient accumulators, Hopper.
//
// Replaces the Pallas TPU kernel monopsr_tpu/ops/emd.py:_emd_loss_kernel
// (launched by _emd_loss_pallas_call, behind the custom VJP of
// _emd_loss_pallas, chosen by emd_distance). Same arithmetic as the plain
// PyTorch version in monopsr_torch/ops/emd.py (emd_loss_plain_accumulators):
// per cloud pair, the annealing sweep of csrc/emd_sweep.cuh with its
// gradient accumulators: besides the cost sum_ij plan_ij * sqrt(d_ij), the
// four contractions of W = plan * rsqrt(max(d, 1e-20)) that the backward
// needs (grow = rowsum W, gcol = colsum W, gx2t = (W . xyz2)^T,
// gx1t = (W^T . xyz1)^T). All four are linear in the plan, so each round
// adds its own share; the cumulative (n, m) plan is never formed.
//
// Bound on the card: the work is transcendental. Over the sweep each
// element needs at least 10 exps (rounds with a nonzero level) and 11
// rsqrts, 21 special-function results: 32 x 2304^2 x 21 = 3.6e9 at the
// train step's (32, 2304, 3) clouds, 0.85 ms at 16 results per clock per
// SM on an H100 SXM (132 SMs, 1980 MHz); ~230 float32 operations per
// element give 0.6 ms at 67 TFLOP/s; the clouds (1.8 MB) are negligible.
// The sweep takes two exps and two rsqrts per element and round (one each
// in the row and the column pass), and a cluster of blocks per pair
// spreads the train step's 32 pairs over most of the card's 132 SMs.

#include "emd_sweep.cuh"

// xyz1 (b, n, 3), xyz2 (b, m, 3) in; cost (b,), grow (b, n), gcol (b, m),
// gx2t (b, 3, n), gx1t (b, 3, m) out: contiguous float32. Launches on
// `stream`; returns a cudaError_t.
extern "C" int emd_loss_launch(const float* xyz1, const float* xyz2,
                               float* cost, float* grow, float* gcol,
                               float* gx2t, float* gx1t, int b, int n, int m,
                               void* stream) {
  const emd_sweep::Grads g = {grow, gcol, gx2t, gx1t};
  return emd_sweep::launch<true>(xyz1, xyz2, cost, g, b, n, m,
                                 static_cast<cudaStream_t>(stream));
}

// Blocks per cloud pair at (b, n, m) on the current device; minus a
// cudaError_t on an error
extern "C" int emd_loss_cluster_size(int b, int n, int m) {
  return emd_sweep::cluster_size<true>(b, n, m);
}

// Clusters of c blocks the current device holds at once at (b, n, m);
// minus a cudaError_t on an error
extern "C" int emd_loss_active_clusters(int b, int n, int m, int c) {
  return emd_sweep::active_clusters<true>(b, n, m, c);
}

extern "C" const char* emd_loss_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
