// K2: approximate EMD loss with its gradient accumulators, Hopper.
//
// Replaces the Pallas TPU kernel monopsr_tpu/ops/emd.py:_emd_loss_kernel
// (launched by _emd_loss_pallas_call, behind the custom VJP of
// _emd_loss_pallas, chosen by emd_distance). Same arithmetic as the plain
// PyTorch version in monopsr_torch/ops/emd.py (emd_loss_plain_accumulators):
// per cloud pair, the 11 annealing rounds of the metric-mode kernel K1
// (csrc/emd_cost_fused.cu), and besides the cost
//     sum_ij plan_ij * sqrt(d_ij)
// the four contractions of W = plan * rsqrt(max(d, 1e-20)) that the
// backward needs:
//     grow = rowsum W (n)      gx2t = (W . xyz2)^T (3, n)
//     gcol = colsum W (m)      gx1t = (W^T . xyz1)^T (3, m)
// All four are linear in the plan, so each round adds its own column-
// scaled weight's share; the cumulative (n, m) plan is never formed.
//
// Design. K1's: one block per cloud pair, O(n + m) state in shared memory
// (both clouds as float4 with their squared norms, sat_l, the row scale,
// sat_r, and the previous round's sat_r * col_scale), weights recomputed
// from the coordinates in every pass. Per round:
//   row pass    - warp per row: this round's row sum; the previous
//                 round's column-scaled weights, which give sat_l and the
//                 row-side sums grow and gx2t (the column scale of a round
//                 is known only after its column pass, so these are one
//                 round late, as in the TPU kernel);
//   column pass - thread per column: column sum, cost, and the column-
//                 side sums gcol and gx1t, which take the column scale as
//                 a common factor once it is known.
// A last row sweep adds the final round's row-side terms. The sums that
// update the saturations (row, assigned, column) are compensated, and the
// updates sat - scale * sum are rounded unfused as in the plain version:
// the capacity residues that masked points leave then match the plain
// version's. Each row and each column has one owner thread for the whole
// run, so the sums need no atomics and are the same on every run.
// sqrt(d) is d * rsqrt(max(d, 1e-20)): one special-function result serves
// the cost and W, and a pair of coincident points (masked slots at the
// origin) gives exactly 0 there. The floor 1e-20 is a normal float32 and
// the build keeps denormals (no fast math), so rsqrt(floor) = 1e10 stays
// finite.
//
// Bound on the card: the work is transcendental. Over the sweep each
// element needs at least 10 exps (rounds with a nonzero level) and 11
// rsqrts, 21 special-function results: 32 x 2304^2 x 21 = 3.6e9 at the
// train step's (32, 2304, 3) clouds, 0.85 ms at 16 results per clock per
// SM on an H100 SXM (132 SMs, 1980 MHz); ~230 float32 operations per
// element give 0.6 ms at 67 TFLOP/s; the clouds (1.8 MB) are negligible.
// This kernel recomputes each weight in three passes (two exps in the
// row pass, one in the column pass) and computes W's rsqrt in both, and
// one block per pair keeps only b of the card's 132 SMs busy (32 at the
// train step's batch of one image).

#include <cuda_runtime.h>

namespace {

constexpr int kRounds = 11;
constexpr int kMaxWarps = 32;
constexpr float kDistFloor = 1e-20f;

__device__ __forceinline__ float level_of(int r) {
  // -4^(8 - r) for rounds 0..9 (exact powers of two), 0 for the last
  return r == kRounds - 1 ? 0.0f : -ldexpf(1.0f, 2 * (8 - r));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// Compensated (Kahan) addition: the sums that feed the saturation
// bookkeeping run over up to thousands of terms in one thread. Summed
// plainly, masked points (which saturate each other in the first round,
// each term 1/count) leave capacity residues of ~count ulps, which later
// rounds hand on to real points; compensated, they stay at an ulp, as in
// the plain version's tree reductions.
struct KahanSum {
  float sum = 0.0f, carry = 0.0f;
  __device__ __forceinline__ void add(float v) {
    const float y = __fsub_rn(v, carry);
    const float t = __fadd_rn(sum, y);
    carry = __fsub_rn(__fsub_rn(t, sum), y);
    sum = t;
  }
};

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  // Unfused, in the plain version's order: (x*x + y*y) + z*z
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

__device__ __forceinline__ float sq_dist(const float4 p, const float4 q) {
  // Same grouping as the plain version: (|p|^2 + |q|^2) - 2 p.q, clamped
  // at 0. Two points at the origin (masked slots) give exactly 0.
  const float dot = fmaf(p.z, q.z, fmaf(p.y, q.y, __fmul_rn(p.x, q.x)));
  return fmaxf(__fsub_rn(__fadd_rn(p.w, q.w), 2.0f * dot), 0.0f);
}

__device__ __forceinline__ float inv_dist(float d) {
  return rsqrtf(fmaxf(d, kDistFloor));
}

// Row-side sums of one round's column-scaled weights for row p:
// sum_j exp(level * d_ij) * scale_j, and the same times rsqrt(d_ij) and
// times rsqrt(d_ij) * xyz2_j; reduced over the warp.
struct RowSums {
  float assigned, g, gx, gy, gz;
};

__device__ __forceinline__ RowSums row_sums(const float4 p, const float4* q2,
                                            const float* scale, float level,
                                            int m, int lane) {
  RowSums s = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  KahanSum assigned;
  for (int j = lane; j < m; j += 32) {
    const float4 q = q2[j];
    const float d = sq_dist(p, q);
    const float e = expf(level * d) * scale[j];
    const float wq = e * inv_dist(d);
    assigned.add(e);
    s.g += wq;
    s.gx = fmaf(wq, q.x, s.gx);
    s.gy = fmaf(wq, q.y, s.gy);
    s.gz = fmaf(wq, q.z, s.gz);
  }
  s.assigned = warp_sum(assigned.sum);
  s.g = warp_sum(s.g);
  s.gx = warp_sum(s.gx);
  s.gy = warp_sum(s.gy);
  s.gz = warp_sum(s.gz);
  return s;
}

__device__ __forceinline__ void add_row_grads(const RowSums& s, float r_scale,
                                              float* grow, float* gx2t,
                                              int i, int n) {
  grow[i] += r_scale * s.g;
  gx2t[i] += r_scale * s.gx;
  gx2t[n + i] += r_scale * s.gy;
  gx2t[2 * n + i] += r_scale * s.gz;
}

__global__ void __launch_bounds__(1024, 1)
emd_loss_kernel(const float* __restrict__ xyz1,
                const float* __restrict__ xyz2, float* __restrict__ cost,
                float* __restrict__ grow, float* __restrict__ gcol,
                float* __restrict__ gx2t, float* __restrict__ gx1t, int n,
                int m) {
  extern __shared__ float4 smem[];
  float4* p1 = smem;                                  // n: x, y, z, |p|^2
  float4* q2 = p1 + n;                                // m: x, y, z, |q|^2
  float* sat_l = reinterpret_cast<float*>(q2 + m);    // n
  float* rs = sat_l + n;                              // n: row scale
  float* sat_r = rs + n;                              // m
  float* prev = sat_r + m;                            // m: sat_r*col_scale
  __shared__ float red[kMaxWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int num_warps = blockDim.x >> 5;
  const size_t pair = blockIdx.x;
  const float* a = xyz1 + pair * n * 3;
  const float* c = xyz2 + pair * m * 3;
  grow += pair * n;
  gx2t += pair * 3 * n;
  gcol += pair * m;
  gx1t += pair * 3 * m;

  // Integer capacity factors, as the reference's C++ int division
  const int big = n > m ? n : m;
  const float factor_l = static_cast<float>(big / n);
  const float factor_r = static_cast<float>(big / m);

  // Rows are zeroed here by one thread and later summed by their warp's
  // lane 0 (visible after the barrier); each column by its owner thread.
  for (int i = tid; i < n; i += blockDim.x) {
    const float x = a[3 * i], y = a[3 * i + 1], z = a[3 * i + 2];
    p1[i] = make_float4(x, y, z, sq_norm(x, y, z));
    sat_l[i] = factor_l;
    rs[i] = 0.0f;
    grow[i] = 0.0f;
    gx2t[i] = 0.0f;
    gx2t[n + i] = 0.0f;
    gx2t[2 * n + i] = 0.0f;
  }
  for (int j = tid; j < m; j += blockDim.x) {
    const float x = c[3 * j], y = c[3 * j + 1], z = c[3 * j + 2];
    q2[j] = make_float4(x, y, z, sq_norm(x, y, z));
    sat_r[j] = factor_r;
    prev[j] = 0.0f;
    gcol[j] = 0.0f;
    gx1t[j] = 0.0f;
    gx1t[m + j] = 0.0f;
    gx1t[2 * m + j] = 0.0f;
  }
  __syncthreads();

  float total = 0.0f;
  float prev_level = 0.0f;
  for (int r = 0; r < kRounds; ++r) {
    const float level = level_of(r);

    // Row pass: the previous round's column-scaled weights update sat_l
    // and add their row-side sums; then this round's row scale is set
    for (int i = warp; i < n; i += num_warps) {
      const float4 p = p1[i];
      KahanSum row_part;
      for (int j = lane; j < m; j += 32) {
        row_part.add(expf(level * sq_dist(p, q2[j])) * sat_r[j]);
      }
      const float row = warp_sum(row_part.sum);
      RowSums s = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (r > 0) s = row_sums(p, q2, prev, prev_level, m, lane);
      if (lane == 0) {
        float sl = sat_l[i];
        if (r > 0) {
          const float r_scale = rs[i];
          sl = fmaxf(__fsub_rn(sl, __fmul_rn(r_scale, s.assigned)), 0.0f);
          add_row_grads(s, r_scale, grow, gx2t, i, n);
        }
        sat_l[i] = sl;
        rs[i] = sl / (row + 1e-9f);
      }
    }
    __syncthreads();

    // Column pass: each thread owns whole columns
    float cost_part = 0.0f;
    for (int j = tid; j < m; j += blockDim.x) {
      const float4 q = q2[j];
      KahanSum col_sum;
      float cdist = 0.0f;
      float g = 0.0f, gx = 0.0f, gy = 0.0f, gz = 0.0f;
      for (int i = 0; i < n; ++i) {
        const float4 p = p1[i];
        const float d = sq_dist(p, q);
        const float w = expf(level * d) * rs[i];
        const float wq = w * inv_dist(d);
        col_sum.add(w);
        cdist = fmaf(wq, d, cdist);       // w * sqrt(d)
        g += wq;
        gx = fmaf(wq, p.x, gx);
        gy = fmaf(wq, p.y, gy);
        gz = fmaf(wq, p.z, gz);
      }
      const float sr = sat_r[j];
      const float col = col_sum.sum * sr;
      cdist *= sr;
      const float col_scale = fminf(sr / (col + 1e-9f), 1.0f);
      const float c_scale = sr * col_scale;
      cost_part += col_scale * cdist;
      sat_r[j] = fmaxf(__fsub_rn(sr, __fmul_rn(col_scale, col)), 0.0f);
      prev[j] = c_scale;
      gcol[j] += c_scale * g;
      gx1t[j] += c_scale * gx;
      gx1t[m + j] += c_scale * gy;
      gx1t[2 * m + j] += c_scale * gz;
    }
    cost_part = warp_sum(cost_part);
    if (lane == 0) red[warp] = cost_part;
    __syncthreads();
    if (warp == 0) {
      float v = lane < num_warps ? red[lane] : 0.0f;
      v = warp_sum(v);
      total += v;
    }
    prev_level = level;
  }

  // Final row sweep: the last round's row-side sums (its column scale is
  // in prev, its row scale in rs)
  for (int i = warp; i < n; i += num_warps) {
    const RowSums s = row_sums(p1[i], q2, prev, prev_level, m, lane);
    if (lane == 0) add_row_grads(s, rs[i], grow, gx2t, i, n);
  }
  if (tid == 0) cost[pair] = total;
}

}  // namespace

// Launches one block per cloud pair on `stream`; returns a cudaError_t.
// xyz1 (b, n, 3), xyz2 (b, m, 3) in; cost (b,), grow (b, n), gcol (b, m),
// gx2t (b, 3, n), gx1t (b, 3, m) out: contiguous float32.
extern "C" int emd_loss_launch(const float* xyz1, const float* xyz2,
                               float* cost, float* grow, float* gcol,
                               float* gx2t, float* gx1t, int b, int n, int m,
                               void* stream) {
  if (b == 0) return cudaSuccess;
  if (b < 0 || n <= 0 || m <= 0) return cudaErrorInvalidValue;
  // Dynamic shared memory: two float4 clouds and four float vectors
  const long long smem = 24LL * (static_cast<long long>(n) + m);
  cudaError_t err = cudaFuncSetAttribute(
      emd_loss_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // Enough threads that each owns at most ceil(m / 1024) columns, in
  // whole warps: 768 threads (3 columns each) at m = 2304
  const int per_thread = (m + 1023) / 1024;
  const int threads = ((m + per_thread - 1) / per_thread + 31) / 32 * 32;
  emd_loss_kernel<<<b, threads, static_cast<size_t>(smem),
                    static_cast<cudaStream_t>(stream)>>>(
      xyz1, xyz2, cost, grow, gcol, gx2t, gx1t, n, m);
  return cudaGetLastError();
}

extern "C" const char* emd_loss_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
