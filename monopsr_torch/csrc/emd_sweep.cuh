// The annealing sweep shared by the EMD kernels K1 (csrc/emd_cost_fused.cu)
// and K2 (csrc/emd_loss.cu), Hopper (sm_90a).
//
// Per cloud pair, 11 annealing rounds at level -4^j for j = 8..-1, then 0;
// each round
//     w = exp(level * d) * sat_r, rows scaled to sat_l, columns capped at
//     sat_r, both saturations decremented, cost += sum(w * sqrt(d)),
// with the integer capacity factors max(n,m)/n and max(n,m)/m. The (n, m)
// plan is never stored: each pass recomputes its weights from the
// coordinates and O(n + m) state in shared memory (both clouds as float4
// with their squared norms, sat_l, the row scale sat_l / (row + 1e-9),
// sat_r, and the previous round's sat_r * col_scale): 24 (n + m) bytes.
// With kGrad (K2) the sweep also accumulates the four contractions of
// W = plan * rsqrt(max(d, 1e-20)) the backward needs,
//     grow = rowsum W (n)      gx2t = (W . xyz2)^T (3, n)
//     gcol = colsum W (m)      gx1t = (W^T . xyz1)^T (3, m),
// the column-side sums in the column pass (the column scale is a common
// factor), the row-side sums one round late in the next row pass (they
// need the finished round's column scale) and a final row sweep.
//
// Bound on the card: each element needs per round one exp (none at level
// 0) and one rsqrt, on the special-function units (16 results per clock
// per SM), and ~12 (K1) to ~21 (K2) float32 operations. The design:
//
// - A thread-block cluster per cloud pair, of c <= 8 blocks: the largest
//   with b * c <= the SM count whose b clusters fit on the card at once
//   (1 at the eval step's 128 pairs; at the train step's 32 an H100's
//   GPCs hold 32 clusters of 3 but not of 4). Each block keeps full copies of both clouds and of the
//   state, owns a contiguous slice of rows and one of columns, and writes
//   what it updates (its rows' scale after its row pass, its columns'
//   sat_r and sat_r * col_scale after its column pass) into every block
//   of the cluster (distributed shared memory), then the cluster syncs.
// - One exp per element and pass. The levels are exact powers of four,
//   so the previous round's weight exp(4 level d) is exp(level d)
//   squared twice; only the level-0 round takes its own exp(-d / 4) for
//   it, and the final sweep (level 0) none. exp is ex2.approx on the
//   level prescaled by log2(e); sqrt(d) is d * rsqrt(max(d, 1e-20)), one
//   rsqrt for the cost and W (exactly 0 for coincident points).
// - Register-tiled passes: in the row pass a warp takes kRowTile rows at
//   once, so each column's shared-memory loads serve them all; in the
//   column pass a thread takes its columns (up to kColTile) together, so
//   each row's loads serve them all.
// - The saturation sums (row, assigned, column) are compensated (Kahan)
//   and the updates sat - scale * sum rounded unfused, as the plain
//   version rounds them: masked points, which saturate each other in the
//   first round, then leave capacity residues of an ulp, not thousands.
// - Each row and each column has one owner thread, whose sums run in an
//   order that does not depend on c (a row: lane-strided over all m
//   columns, then a butterfly over the warp; a column: all n rows in
//   order). A pair's row and column outputs are bitwise the same whatever
//   c it is launched with; only the cost, summed over the cluster's
//   blocks in rank order, rounds otherwise. No atomics: every run gives
//   the same result.
//
// The floor 1e-20 is a normal float32 and the build keeps denormals (no
// fast math), so rsqrt(floor) = 1e10 stays finite.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace emd_sweep {

namespace cg = cooperative_groups;

constexpr int kRounds = 11;
constexpr int kMaxThreads = 768;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxCluster = 8;
constexpr int kRowTile = 4;    // rows per warp in the row pass
constexpr int kColTile = 3;    // columns per thread in the column pass
constexpr float kDistFloor = 1e-20f;
constexpr float kLog2e = 1.44269502162933349609375f;    // log2(e), rounded

__device__ __forceinline__ float level_of(int r) {
  // -4^(8 - r) for rounds 0..9 (exact powers of two), 0 for the last
  return r == kRounds - 1 ? 0.0f : -ldexpf(1.0f, 2 * (8 - r));
}

// 2^x on the special-function unit; results under 2^-126 flush to 0
// (they vanish beside the 1e-9 of every row and column sum)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A round's level times log2(e): exact, since the level is a power of two
__device__ __forceinline__ float level2_of(int r) {
  return __fmul_rn(level_of(r), kLog2e);
}

// exp(level * d) as 2^(d * level * log2(e)), the product rounded once.
// Its rounding moves the exponent by up to |level * d| ulps, as an ulp of
// d itself does (d is rounded, and level * d is exact): the plain version
// of K2 takes the same rounded product (emd.py, _kernel_exp). d = 0 gives
// exactly 1.
__device__ __forceinline__ float exp_level(float d, float level2) {
  return exp2_approx(__fmul_rn(d, level2));
}

// rsqrt(max(d, 1e-20)): the argument is a normal float32, so the ftz
// form gives what the full one would
__device__ __forceinline__ float inv_dist(float d) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(fmaxf(d, kDistFloor)));
  return y;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// Compensated (Kahan) addition for the sums that feed the saturations
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
  // at 0 (2 p.q is exact, so the fused form rounds as the unfused one).
  // Two points at the origin (masked slots) give exactly 0.
  const float dot = fmaf(p.z, q.z, fmaf(p.y, q.y, __fmul_rn(p.x, q.x)));
  return fmaxf(fmaf(-2.0f, dot, __fadd_rn(p.w, q.w)), 0.0f);
}

// The state in shared memory: 24 (n + m) bytes
struct State {
  float4* p1;      // n: x, y, z, |p|^2
  float4* q2;      // m: x, y, z, |q|^2
  float* sat_l;    // n (only the block's own rows are kept current)
  float* rs;       // n: row scale of the round
  float* sat_r;    // m
  float* prev;     // m: sat_r * col_scale of the previous round
};

// K2's outputs for one pair (unused by K1)
struct Grads {
  float* grow;     // n
  float* gcol;     // m
  float* gx2t;     // 3 n
  float* gx1t;     // 3 m
};

// The cluster of blocks that serves one pair
struct Team {
  int size;
  int rank;
};

// Writes v at the same shared-memory slot in every block of the team
__device__ __forceinline__ void store_all(const Team& team, float* slot,
                                          float v) {
  if (team.size == 1) {
    *slot = v;
    return;
  }
  for (int k = 0; k < team.size; ++k) {
    *cg::this_cluster().map_shared_rank(slot, k) = v;
  }
}

enum RowMode {
  kFirstRound,   // round 0: row sums only
  kSquared,      // rounds 1..9: previous weight = (e^2)^2
  kLevelZero,    // round 10: e = 1, previous weight exp(-d / 4)
  kFinalSweep,   // after round 10 (K2): the last round's row-side sums
};

// Row pass over the rows [row_lo, row_hi): warps take kRowTile rows at a
// time; lane k of the warp owns row k of its tile. Sets each row's scale
// (in every block of the team); folds the previous round's column-scaled
// weights into sat_l, and with kGrad adds their row-side sums.
template <bool kGrad, int kMode>
__device__ __forceinline__ void row_pass(const State& s, const Grads& g,
                                         const Team& team, float lvl,
                                         float prev_lvl, int row_lo,
                                         int row_hi, int n, int m) {
  constexpr bool kRow = kMode != kFinalSweep;
  constexpr bool kPrev = kMode != kFirstRound;
  constexpr bool kAssigned = kPrev && kMode != kFinalSweep;
  constexpr bool kSums = kGrad && kPrev;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int num_warps = blockDim.x >> 5;
  for (int i0 = row_lo + warp * kRowTile; i0 < row_hi;
       i0 += num_warps * kRowTile) {
    float4 p[kRowTile];
    KahanSum row[kRowTile], assigned[kRowTile];
    float sg[kRowTile], sx[kRowTile], sy[kRowTile], sz[kRowTile];
#pragma unroll
    for (int k = 0; k < kRowTile; ++k) {
      p[k] = s.p1[min(i0 + k, row_hi - 1)];
      sg[k] = sx[k] = sy[k] = sz[k] = 0.0f;
    }
    for (int j = lane; j < m; j += 32) {
      const float4 q = s.q2[j];
      const float sr = kRow ? s.sat_r[j] : 0.0f;
      const float pv = kPrev ? s.prev[j] : 0.0f;
#pragma unroll
      for (int k = 0; k < kRowTile; ++k) {
        const float d = sq_dist(p[k], q);
        float e = 1.0f;
        if (kMode == kFirstRound || kMode == kSquared) {
          e = exp_level(d, lvl);
        }
        if (kRow) row[k].add(__fmul_rn(e, sr));
        if (kPrev) {
          float ep = 1.0f;                  // the previous round's weight
          if (kMode == kSquared) {
            const float e2 = __fmul_rn(e, e);
            ep = __fmul_rn(e2, e2);
          } else if (kMode == kLevelZero) {
            ep = exp_level(d, prev_lvl);
          }
          ep = __fmul_rn(ep, pv);
          if (kAssigned) assigned[k].add(ep);
          if (kSums) {
            const float wq = __fmul_rn(ep, inv_dist(d));
            sg[k] = __fadd_rn(sg[k], wq);
            sx[k] = fmaf(wq, q.x, sx[k]);
            sy[k] = fmaf(wq, q.y, sy[k]);
            sz[k] = fmaf(wq, q.z, sz[k]);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kRowTile; ++k) {
      const float row_sum = kRow ? warp_sum(row[k].sum) : 0.0f;
      const float assigned_sum = kAssigned ? warp_sum(assigned[k].sum) : 0.0f;
      float tg = 0.0f, tx = 0.0f, ty = 0.0f, tz = 0.0f;
      if (kSums) {
        tg = warp_sum(sg[k]);
        tx = warp_sum(sx[k]);
        ty = warp_sum(sy[k]);
        tz = warp_sum(sz[k]);
      }
      const int i = i0 + k;
      if (lane != k || i >= row_hi) continue;
      const float r_scale = s.rs[i];        // the previous round's
      if (kSums) {
        g.grow[i] = __fadd_rn(g.grow[i], __fmul_rn(r_scale, tg));
        g.gx2t[i] = __fadd_rn(g.gx2t[i], __fmul_rn(r_scale, tx));
        g.gx2t[n + i] = __fadd_rn(g.gx2t[n + i], __fmul_rn(r_scale, ty));
        g.gx2t[2 * n + i] =
            __fadd_rn(g.gx2t[2 * n + i], __fmul_rn(r_scale, tz));
      }
      if (kRow) {
        float sl = s.sat_l[i];
        if (kAssigned) {
          sl = fmaxf(__fsub_rn(sl, __fmul_rn(r_scale, assigned_sum)), 0.0f);
        }
        s.sat_l[i] = sl;
        store_all(team, s.rs + i, __fdiv_rn(sl, __fadd_rn(row_sum, 1e-9f)));
      }
    }
  }
}

// One tile of kCols columns of a thread, the columns j0 + k * stride
// (those at or past col_hi are computed on a stand-in and dropped).
// Returns the tile's share of the round's cost.
template <bool kGrad, bool kExp, int kCols>
__device__ __forceinline__ float column_tile(const State& s, const Grads& g,
                                             const Team& team, float lvl,
                                             int j0, int stride, int col_hi,
                                             int n, int m) {
  int j[kCols];
  float4 q[kCols];
  KahanSum col[kCols];
  float cd[kCols], sg[kCols], sx[kCols], sy[kCols], sz[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    j[k] = j0 + k * stride;
    q[k] = s.q2[min(j[k], col_hi - 1)];
    cd[k] = sg[k] = sx[k] = sy[k] = sz[k] = 0.0f;
  }
  for (int i = 0; i < n; ++i) {
    const float4 p = s.p1[i];
    const float ri = s.rs[i];
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const float d = sq_dist(p, q[k]);
      const float w =
          kExp ? __fmul_rn(exp_level(d, lvl), ri) : ri;
      col[k].add(w);
      const float wq = __fmul_rn(w, inv_dist(d));
      cd[k] = fmaf(wq, d, cd[k]);           // w * sqrt(d)
      if (kGrad) {
        sg[k] = __fadd_rn(sg[k], wq);
        sx[k] = fmaf(wq, p.x, sx[k]);
        sy[k] = fmaf(wq, p.y, sy[k]);
        sz[k] = fmaf(wq, p.z, sz[k]);
      }
    }
  }
  float cost_part = 0.0f;
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    if (j[k] >= col_hi) continue;
    const int c = j[k];
    const float sr = s.sat_r[c];
    const float colv = __fmul_rn(col[k].sum, sr);
    const float cdist = __fmul_rn(cd[k], sr);
    const float col_scale =
        fminf(__fdiv_rn(sr, __fadd_rn(colv, 1e-9f)), 1.0f);
    const float c_scale = __fmul_rn(sr, col_scale);
    cost_part = fmaf(col_scale, cdist, cost_part);
    store_all(team, s.sat_r + c,
              fmaxf(__fsub_rn(sr, __fmul_rn(col_scale, colv)), 0.0f));
    store_all(team, s.prev + c, c_scale);
    if (kGrad) {
      g.gcol[c] = __fadd_rn(g.gcol[c], __fmul_rn(c_scale, sg[k]));
      g.gx1t[c] = __fadd_rn(g.gx1t[c], __fmul_rn(c_scale, sx[k]));
      g.gx1t[m + c] = __fadd_rn(g.gx1t[m + c], __fmul_rn(c_scale, sy[k]));
      g.gx1t[2 * m + c] =
          __fadd_rn(g.gx1t[2 * m + c], __fmul_rn(c_scale, sz[k]));
    }
  }
  return cost_part;
}

// Column pass over the columns [col_lo, col_hi): thread t owns the
// columns col_lo + t + k * blockDim.x and takes them kColTile at a time.
// Returns the thread's share of the round's cost.
template <bool kGrad, bool kExp>
__device__ __forceinline__ float column_pass(const State& s, const Grads& g,
                                             const Team& team, float lvl,
                                             int col_lo, int col_hi, int n,
                                             int m) {
  const int threads = blockDim.x;
  const int per_thread = (col_hi - col_lo + threads - 1) / threads;
  float cost_part = 0.0f;
  for (int k0 = 0; k0 < per_thread; k0 += kColTile) {
    const int j0 = col_lo + threadIdx.x + k0 * threads;
    const int cols = min(kColTile, per_thread - k0);
    if (cols == 3) {
      cost_part += column_tile<kGrad, kExp, 3>(s, g, team, lvl, j0, threads,
                                               col_hi, n, m);
    } else if (cols == 2) {
      cost_part += column_tile<kGrad, kExp, 2>(s, g, team, lvl, j0, threads,
                                               col_hi, n, m);
    } else {
      cost_part += column_tile<kGrad, kExp, 1>(s, g, team, lvl, j0, threads,
                                               col_hi, n, m);
    }
  }
  return cost_part;
}

// Sum over the block, valid in thread 0
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = 0.0f;
  if (warp == 0) {
    v = warp_sum(lane < (blockDim.x >> 5) ? red[lane] : 0.0f);
  }
  return v;
}

// One cluster of blocks per cloud pair (grid = b * cluster size).
// xyz1 (b, n, 3), xyz2 (b, m, 3) in; cost (b,) out; with kGrad also
// grow (b, n), gcol (b, m), gx2t (b, 3, n), gx1t (b, 3, m).
template <bool kGrad>
__global__ void __launch_bounds__(kMaxThreads, 1)
sweep_kernel(const float* __restrict__ xyz1, const float* __restrict__ xyz2,
             float* __restrict__ cost, Grads g, int n, int m) {
  extern __shared__ float4 smem[];
  __shared__ float red[kMaxWarps];
  __shared__ float totals[kMaxCluster];
  const Team team = {static_cast<int>(cg::this_cluster().num_blocks()),
                     static_cast<int>(cg::this_cluster().block_rank())};
  State s;
  s.p1 = smem;
  s.q2 = s.p1 + n;
  s.sat_l = reinterpret_cast<float*>(s.q2 + m);
  s.rs = s.sat_l + n;
  s.sat_r = s.rs + n;
  s.prev = s.sat_r + m;

  const int tid = threadIdx.x;
  const size_t pair = blockIdx.x / team.size;
  const float* a = xyz1 + pair * n * 3;
  const float* c = xyz2 + pair * m * 3;
  if (kGrad) {
    g.grow += pair * n;
    g.gx2t += pair * 3 * n;
    g.gcol += pair * m;
    g.gx1t += pair * 3 * m;
  }
  const int row_lo = n * team.rank / team.size;
  const int row_hi = n * (team.rank + 1) / team.size;
  const int col_lo = m * team.rank / team.size;
  const int col_hi = m * (team.rank + 1) / team.size;

  // Integer capacity factors, as the reference's C++ int division
  const int big = n > m ? n : m;
  const float factor_l = static_cast<float>(big / n);
  const float factor_r = static_cast<float>(big / m);

  for (int i = tid; i < n; i += blockDim.x) {
    const float x = a[3 * i], y = a[3 * i + 1], z = a[3 * i + 2];
    s.p1[i] = make_float4(x, y, z, sq_norm(x, y, z));
    s.sat_l[i] = factor_l;
    s.rs[i] = 0.0f;
  }
  for (int j = tid; j < m; j += blockDim.x) {
    const float x = c[3 * j], y = c[3 * j + 1], z = c[3 * j + 2];
    s.q2[j] = make_float4(x, y, z, sq_norm(x, y, z));
    s.sat_r[j] = factor_r;
    s.prev[j] = 0.0f;
  }
  if (kGrad) {
    for (int i = row_lo + tid; i < row_hi; i += blockDim.x) {
      g.grow[i] = 0.0f;
      g.gx2t[i] = 0.0f;
      g.gx2t[n + i] = 0.0f;
      g.gx2t[2 * n + i] = 0.0f;
    }
    for (int j = col_lo + tid; j < col_hi; j += blockDim.x) {
      g.gcol[j] = 0.0f;
      g.gx1t[j] = 0.0f;
      g.gx1t[m + j] = 0.0f;
      g.gx1t[2 * m + j] = 0.0f;
    }
  }
  // No block writes into a peer before the peer has set its state up
  cg::this_cluster().sync();

  float total = 0.0f;
  for (int r = 0; r < kRounds; ++r) {
    const float lvl = level2_of(r);
    const float prev_lvl = level2_of(r > 0 ? r - 1 : 0);
    if (r == 0) {
      row_pass<kGrad, kFirstRound>(s, g, team, lvl, prev_lvl, row_lo,
                                   row_hi, n, m);
    } else if (r < kRounds - 1) {
      row_pass<kGrad, kSquared>(s, g, team, lvl, prev_lvl, row_lo, row_hi,
                                n, m);
    } else {
      row_pass<kGrad, kLevelZero>(s, g, team, lvl, prev_lvl, row_lo,
                                  row_hi, n, m);
    }
    cg::this_cluster().sync();      // every row scale is in every block

    float part = 0.0f;
    if (col_lo < col_hi) {
      part = r < kRounds - 1
                 ? column_pass<kGrad, true>(s, g, team, lvl, col_lo,
                                            col_hi, n, m)
                 : column_pass<kGrad, false>(s, g, team, lvl, col_lo,
                                             col_hi, n, m);
    }
    part = block_sum(part, red);
    if (tid == 0) total += part;
    cg::this_cluster().sync();      // every sat_r and col scale is in every block
  }
  if (kGrad) {
    row_pass<kGrad, kFinalSweep>(s, g, team, 0.0f, 0.0f, row_lo,
                                 row_hi, n, m);
  }

  // The cost: the blocks' shares summed in rank order
  if (tid == 0) *cg::this_cluster().map_shared_rank(totals + team.rank, 0) = total;
  cg::this_cluster().sync();
  if (tid == 0 && team.rank == 0) {
    float sum = 0.0f;
    for (int k = 0; k < team.size; ++k) sum = __fadd_rn(sum, totals[k]);
    cost[pair] = sum;
  }
}

// Threads per block: whole warps, each thread owning at most
// ceil(slice / kMaxThreads) columns of the block's slice
inline int threads_for(int n, int m, int c) {
  const int slice = ((n > m ? n : m) + c - 1) / c;
  const int per_thread = (slice + kMaxThreads - 1) / kMaxThreads;
  return ((slice + per_thread - 1) / per_thread + 31) / 32 * 32;
}

inline cudaLaunchConfig_t launch_config(int b, int n, int m, int c,
                                        cudaLaunchAttribute* attr,
                                        cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(b) * c, 1, 1);
  cfg.blockDim = dim3(threads_for(n, m, c), 1, 1);
  cfg.dynamicSmemBytes = 24 * (static_cast<size_t>(n) + m);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool kGrad>
cudaError_t prepare(int n, int m) {
  return cudaFuncSetAttribute(
      sweep_kernel<kGrad>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(24LL * (static_cast<long long>(n) + m)));
}

// How many clusters of c blocks at (n, m) the current device holds at
// once (cudaOccupancyMaxActiveClusters); minus a cudaError_t on an error
template <bool kGrad>
int active_clusters(int b, int n, int m, int c) {
  cudaError_t err = prepare<kGrad>(n, m);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(b, n, m, c, &attr, 0);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, sweep_kernel<kGrad>, &cfg);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return clusters;
}

// Blocks per pair: the largest c <= 8 with b * c <= the SM count whose b
// clusters the card holds at once, else 1. Clusters are placed within a
// GPC (a group of 14 to 18 SMs on an H100), so at one block per SM not
// every SM count splits into clusters of 4: c = 3 can be the largest
// that fits in one wave. Negative on an error (minus the cudaError_t).
template <bool kGrad>
int cluster_size(int b, int n, int m) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return -static_cast<int>(err);
  for (int c = kMaxCluster; c > 1; --c) {
    if (static_cast<long long>(b) * c > sms) continue;
    const int clusters = active_clusters<kGrad>(b, n, m, c);
    if (clusters < 0) return clusters;
    if (clusters >= b) return c;
  }
  return 1;
}

template <bool kGrad>
cudaError_t launch(const float* xyz1, const float* xyz2, float* cost,
                   Grads g, int b, int n, int m, cudaStream_t stream) {
  if (b == 0) return cudaSuccess;
  if (b < 0 || n <= 0 || m <= 0) return cudaErrorInvalidValue;
  cudaError_t err = prepare<kGrad>(n, m);
  if (err != cudaSuccess) return err;
  const int c = cluster_size<kGrad>(b, n, m);
  if (c < 0) return static_cast<cudaError_t>(-c);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(b, n, m, c, &attr, stream);
  err = cudaLaunchKernelEx(&cfg, sweep_kernel<kGrad>, xyz1, xyz2, cost, g, n,
                           m);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace emd_sweep
