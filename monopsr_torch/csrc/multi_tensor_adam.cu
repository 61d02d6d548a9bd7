// The train step's optimizer update: global-norm clip, Adam, apply-if-
// finite, the parameter add and the EMA, as two multi-tensor passes over
// every parameter, Hopper.
//
// Replaces no TPU kernel. In the JAX package XLA fuses optax's chain
// (clip_by_global_norm -> adam -> apply_if_finite) and the EMA into the
// jitted train step's own fusions; the port ran the same arithmetic as
// ~25 torch._foreach passes (the plain twin, Optimizer.apply_plain in
// monopsr_torch/train/optimizer.py), each a fresh read and most a fresh
// write of the whole parameter list, besides a flat copy of the gradients.
//
// Bound on the card: memory. Per parameter the norm pass reads g (4 B);
// the update reads g, p, mu, nu and ema and writes p, mu, nu and ema
// (36 B with a float32 mu, 32 B with a bfloat16 one): 40 B x 100.4 M
// parameters = 4.02 GB, 1.20 ms at 3.35 TB/s. Three launches:
//
// 1. multi_tensor_apply_norm_partials: persistent blocks walk the chunk
//    table; per chunk, the sum of g*g (each square rounded to float32, as
//    the plain twin's flat * flat, then summed in float64) and whether a
//    value is not finite, written to that chunk's slot of a scratch
//    buffer. Each thread sums the same four elements in the same order
//    whether it loads them as one 16-byte vector or one by one, and the
//    block reduces in a fixed tree, so a chunk's partial does not depend
//    on where its tensor lies: no float atomics, the same bits every run.
// 2. multi_tensor_apply_adam_finalize: one block sums the partials in a
//    fixed order and takes every scalar step of the plain update on the
//    device (norm, finite, the apply-if-finite counters, keep, the clip's
//    divisor and multiplier, the count, the schedule's learning rate,
//    Adam's bias corrections) into a scalar block; nothing is read on the
//    host.
// 3. multi_tensor_apply_adam_ema: persistent blocks walk the chunk table
//    again and update each element from the scalar block, with 16-byte
//    loads and stores where a chunk's pointers allow (a scalar tail).
//
// The arithmetic is float32 with explicit round-to-nearest intrinsics and
// no contraction, in the plain twin's order, so for a given norm each
// element equals the foreach chain bit for bit: g zeroed on a skipped
// step, (g / div) * mul, mu = mu * d1 + g * (1 - b1), nu = nu * d2 +
// (g * g) * (1 - b2), u = ((mu / c1) / (sqrt(nu / c2) + eps)) * -lr,
// p = p + u, ema = ema * decay + p * (1 - decay). A bfloat16 mu is decayed
// in float32 (its decay already rounded to bfloat16 by the caller) and
// rounded to bfloat16 when stored; the update reads it unrounded.
//
// The table (built on the host by monopsr_torch/ops/multi_tensor_adam.py):
// 64-bit words, the pointers of g, p, mu, nu and ema per tensor (five
// arrays of n_tensors), padded to an even count, then one 16-byte row
// (tensor, start, length, 0) of int32 per chunk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The update's constants, as the plain twin rounds them to float32
// (outside the unnamed namespace: the C interface takes it)
struct AdamHyper {
  float clip;           // the clip's maximum norm; <= 0: no clip
  int skip_nonfinite;   // apply-if-finite on
  int max_errors;       // non-finite steps skipped in a row before one goes
  int lr_type;          // 0 constant, 1 exponential decay
  float lr;             // the constant rate, or the initial one
  float decay_steps;
  float decay_rate;
  int staircase;
  float b1, b2;         // the bases of the bias corrections
  float mu_decay;       // mu's decay as stored (b1, or b1 in bfloat16)
  float nu_decay;
  float one_minus_b1, one_minus_b2, eps;
  float ema_decay, one_minus_ema;
};

namespace {

constexpr int kThreads = 256;           // threads of a walking block
constexpr int kVec = 4;                 // elements per thread and step
constexpr int kFinalizeThreads = 1024;  // threads of the finalize block

// Slots of the scalar block the finalize writes
enum Scalar {
  kKeep, kDiv, kMul, kMuDecay, kNuDecay, kCorrect1, kCorrect2, kNegLr,
  kNorm, kNumScalars
};

__device__ __forceinline__ const int4* chunk_rows(const uint64_t* table,
                                                  int n_tensors) {
  return reinterpret_cast<const int4*>(table + ((5 * n_tensors + 1) & ~1));
}

__device__ __forceinline__ bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

__device__ __forceinline__ bool not_finite(float x) {
  return (__float_as_uint(x) & 0x7f800000u) == 0x7f800000u;
}

__device__ __forceinline__ int32_t safe_increment(int32_t n) {
  return n < INT32_MAX ? n + 1 : n;
}

__global__ void __launch_bounds__(kThreads)
multi_tensor_apply_norm_partials(const uint64_t* __restrict__ table,
                                 int n_tensors, int n_chunks,
                                 double* __restrict__ partial_sq,
                                 int* __restrict__ partial_bad) {
  __shared__ double warp_sq[kThreads / 32];
  __shared__ int warp_bad[kThreads / 32];
  const int4* rows = chunk_rows(table, n_tensors);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int4 row = rows[c];
    const float* g = reinterpret_cast<const float*>(table[row.x]) + row.y;
    const int len = row.z;
    const bool vec = aligned(g, 16);
    double sq = 0.0;
    int bad = 0;
    for (int i = threadIdx.x * kVec; i < len; i += kThreads * kVec) {
      float x[kVec];
      if (vec && i + kVec <= len) {
        const float4 v = *reinterpret_cast<const float4*>(g + i);
        x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) x[j] = i + j < len ? g[i + j] : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        sq += static_cast<double>(__fmul_rn(x[j], x[j]));
        bad |= not_finite(x[j]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sq += __shfl_down_sync(0xffffffffu, sq, off);
      bad |= __shfl_down_sync(0xffffffffu, bad, off);
    }
    if (lane == 0) {
      warp_sq[warp] = sq;
      warp_bad[warp] = bad;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      double total = 0.0;
      int any = 0;
      for (int w = 0; w < kThreads / 32; ++w) {
        total += warp_sq[w];
        any |= warp_bad[w];
      }
      partial_sq[c] = total;
      partial_bad[c] = any;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kFinalizeThreads)
multi_tensor_apply_adam_finalize(const double* __restrict__ partial_sq,
                                 const int* __restrict__ partial_bad,
                                 int n_chunks, AdamHyper h, int32_t* count,
                                 int32_t* notfinite_count,
                                 uint8_t* last_finite,
                                 int32_t* total_notfinite, float* scalars) {
  __shared__ double sums[kFinalizeThreads];
  __shared__ int bads[kFinalizeThreads];
  double sq = 0.0;
  int bad = 0;
  for (int c = threadIdx.x; c < n_chunks; c += kFinalizeThreads) {
    sq += partial_sq[c];
    bad |= partial_bad[c];
  }
  sums[threadIdx.x] = sq;
  bads[threadIdx.x] = bad;
  __syncthreads();
  for (int s = kFinalizeThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      sums[threadIdx.x] += sums[threadIdx.x + s];
      bads[threadIdx.x] |= bads[threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x != 0) return;

  const float norm = __fsqrt_rn(static_cast<float>(sums[0]));
  const bool finite = bads[0] == 0;
  bool keep = true;
  if (h.skip_nonfinite) {
    const int32_t notfinite = finite ? 0 : safe_increment(*notfinite_count);
    keep = finite || notfinite > h.max_errors;
    *notfinite_count = notfinite;
    *last_finite = finite ? 1 : 0;
    if (!finite) *total_notfinite = safe_increment(*total_notfinite);
  }
  float div = 1.0f, mul = 1.0f;
  if (h.clip > 0.0f && !(norm < h.clip || !keep)) {
    div = norm;
    mul = h.clip;
  }
  const int32_t old = *count;
  const int32_t inc = safe_increment(old);
  float lr = h.lr;
  if (h.lr_type == 1 && old > 0) {
    float p = __fdiv_rn(static_cast<float>(old), h.decay_steps);
    if (h.staircase) p = floorf(p);
    lr = __fmul_rn(h.lr, powf(h.decay_rate, p));
  }
  const float c = static_cast<float>(inc);
  scalars[kKeep] = keep ? 1.0f : 0.0f;
  scalars[kDiv] = div;
  scalars[kMul] = mul;
  scalars[kMuDecay] = keep ? h.mu_decay : 1.0f;
  scalars[kNuDecay] = keep ? h.nu_decay : 1.0f;
  scalars[kCorrect1] = __fsub_rn(1.0f, powf(h.b1, c));
  scalars[kCorrect2] = __fsub_rn(1.0f, powf(h.b2, c));
  scalars[kNegLr] = keep ? -lr : 0.0f;
  scalars[kNorm] = norm;
  if (keep) *count = inc;
}

__device__ __forceinline__ float load_mu(const float* m, int i) {
  return m[i];
}

__device__ __forceinline__ float load_mu(const __nv_bfloat16* m, int i) {
  return __bfloat162float(m[i]);
}

__device__ __forceinline__ void store_mu(float* m, int i, float x) {
  m[i] = x;
}

__device__ __forceinline__ void store_mu(__nv_bfloat16* m, int i, float x) {
  m[i] = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void load_mu4(const float* m, int i, float* x) {
  const float4 v = *reinterpret_cast<const float4*>(m + i);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

__device__ __forceinline__ void load_mu4(const __nv_bfloat16* m, int i,
                                         float* x) {
  const uint2 v = *reinterpret_cast<const uint2*>(m + i);
  x[0] = __uint_as_float(v.x << 16);
  x[1] = __uint_as_float(v.x & 0xffff0000u);
  x[2] = __uint_as_float(v.y << 16);
  x[3] = __uint_as_float(v.y & 0xffff0000u);
}

__device__ __forceinline__ void store_mu4(float* m, int i, const float* x) {
  *reinterpret_cast<float4*>(m + i) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store_mu4(__nv_bfloat16* m, int i,
                                          const float* x) {
  *reinterpret_cast<uint2*>(m + i) =
      make_uint2(bf16_bits(x[0]) | (bf16_bits(x[1]) << 16),
                 bf16_bits(x[2]) | (bf16_bits(x[3]) << 16));
}

// The update's scalars and constants, in registers
struct Step {
  bool keep;
  float div, mul, d1, d2, c1, c2, neg_lr;
  float one_minus_b1, one_minus_b2, eps, ema_decay, one_minus_ema;
};

// One element: returns the new p; updates m, v and e in place
template <bool kEma>
__device__ __forceinline__ float adam_element(const Step& s, float g,
                                              float p, float& m, float& v,
                                              float& e) {
  const float x = __fmul_rn(__fdiv_rn(s.keep ? g : 0.0f, s.div), s.mul);
  m = __fadd_rn(__fmul_rn(m, s.d1), __fmul_rn(x, s.one_minus_b1));
  v = __fadd_rn(__fmul_rn(v, s.d2),
                __fmul_rn(__fmul_rn(x, x), s.one_minus_b2));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.c2)), s.eps);
  const float u = __fmul_rn(__fdiv_rn(__fdiv_rn(m, s.c1), den), s.neg_lr);
  p = __fadd_rn(p, u);
  if (kEma) {
    e = __fadd_rn(__fmul_rn(e, s.ema_decay), __fmul_rn(p, s.one_minus_ema));
  }
  return p;
}

template <typename MuT, bool kEma>
__global__ void __launch_bounds__(kThreads)
multi_tensor_apply_adam_ema(const uint64_t* __restrict__ table,
                            int n_tensors, int n_chunks,
                            const float* __restrict__ scalars, AdamHyper h) {
  Step s;
  s.keep = scalars[kKeep] != 0.0f;
  s.div = scalars[kDiv];
  s.mul = scalars[kMul];
  s.d1 = scalars[kMuDecay];
  s.d2 = scalars[kNuDecay];
  s.c1 = scalars[kCorrect1];
  s.c2 = scalars[kCorrect2];
  s.neg_lr = scalars[kNegLr];
  s.one_minus_b1 = h.one_minus_b1;
  s.one_minus_b2 = h.one_minus_b2;
  s.eps = h.eps;
  s.ema_decay = h.ema_decay;
  s.one_minus_ema = h.one_minus_ema;
  const int4* rows = chunk_rows(table, n_tensors);
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int4 row = rows[c];
    const int t = row.x, len = row.z;
    const float* g =
        reinterpret_cast<const float*>(table[t]) + row.y;
    float* p = reinterpret_cast<float*>(table[n_tensors + t]) + row.y;
    MuT* m = reinterpret_cast<MuT*>(table[2 * n_tensors + t]) + row.y;
    float* v = reinterpret_cast<float*>(table[3 * n_tensors + t]) + row.y;
    float* e = kEma
        ? reinterpret_cast<float*>(table[4 * n_tensors + t]) + row.y
        : nullptr;
    const bool vec = aligned(g, 16) && aligned(p, 16) && aligned(v, 16) &&
                     aligned(m, kVec * sizeof(MuT)) && (!kEma || aligned(e, 16));
    for (int i = threadIdx.x * kVec; i < len; i += kThreads * kVec) {
      if (vec && i + kVec <= len) {
        const float4 g4 = *reinterpret_cast<const float4*>(g + i);
        const float4 p4 = *reinterpret_cast<const float4*>(p + i);
        const float4 v4 = *reinterpret_cast<const float4*>(v + i);
        float4 e4 = kEma ? *reinterpret_cast<const float4*>(e + i)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
        float gx[kVec] = {g4.x, g4.y, g4.z, g4.w};
        float px[kVec] = {p4.x, p4.y, p4.z, p4.w};
        float vx[kVec] = {v4.x, v4.y, v4.z, v4.w};
        float ex[kVec] = {e4.x, e4.y, e4.z, e4.w};
        float mx[kVec];
        load_mu4(m, i, mx);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          px[j] = adam_element<kEma>(s, gx[j], px[j], mx[j], vx[j], ex[j]);
        }
        *reinterpret_cast<float4*>(p + i) =
            make_float4(px[0], px[1], px[2], px[3]);
        *reinterpret_cast<float4*>(v + i) =
            make_float4(vx[0], vx[1], vx[2], vx[3]);
        store_mu4(m, i, mx);
        if (kEma) {
          *reinterpret_cast<float4*>(e + i) =
              make_float4(ex[0], ex[1], ex[2], ex[3]);
        }
      } else {
        for (int j = i; j < len && j < i + kVec; ++j) {
          float mj = load_mu(m, j), vj = v[j], ej = kEma ? e[j] : 0.0f;
          p[j] = adam_element<kEma>(s, g[j], p[j], mj, vj, ej);
          store_mu(m, j, mj);
          v[j] = vj;
          if (kEma) e[j] = ej;
        }
      }
    }
  }
}

// Blocks of `kernel` at `threads` threads the current device holds at
// once, at least 1; 0 on an error (left in cudaGetLastError)
template <typename Kernel>
int resident_blocks(Kernel kernel, int threads) {
  int device = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    0) != cudaSuccess) {
    return 0;
  }
  return sms * (per_sm > 0 ? per_sm : 1);
}

template <typename MuT, bool kEma>
cudaError_t launch_update(const uint64_t* table, int n_tensors, int n_chunks,
                          const float* scalars, const AdamHyper& h,
                          cudaStream_t stream) {
  auto kernel = multi_tensor_apply_adam_ema<MuT, kEma>;
  const int resident = resident_blocks(kernel, kThreads);
  if (resident == 0) return cudaGetLastError();
  const int grid = n_chunks < resident ? (n_chunks > 0 ? n_chunks : 1)
                                       : resident;
  kernel<<<grid, kThreads, 0, stream>>>(table, n_tensors, n_chunks, scalars,
                                        h);
  return cudaGetLastError();
}

}  // namespace

// table: the device table above (n_tensors, n_chunks); partial_sq
// (n_chunks float64), partial_bad (n_chunks int32), scalars (kNumScalars
// float32): device scratch; count, notfinite_count, total_notfinite:
// int32 device scalars, last_finite a bool one (the three null without
// apply-if-finite). mu_bf16: mu stored in bfloat16, else float32; has_ema:
// the ema pointers are read. Launches the three kernels on `stream`;
// returns a cudaError_t.
extern "C" int multi_tensor_adam_launch(
    const void* table, int n_tensors, int n_chunks, int mu_bf16, int has_ema,
    void* partial_sq, void* partial_bad, void* scalars, void* count,
    void* notfinite_count, void* last_finite, void* total_notfinite,
    AdamHyper hyper, void* stream_ptr) {
  const auto* words = static_cast<const uint64_t*>(table);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  auto* sq = static_cast<double*>(partial_sq);
  auto* bad = static_cast<int*>(partial_bad);
  auto* out = static_cast<float*>(scalars);

  const int resident =
      resident_blocks(multi_tensor_apply_norm_partials, kThreads);
  if (resident == 0) return cudaGetLastError();
  const int grid = n_chunks < resident ? (n_chunks > 0 ? n_chunks : 1)
                                       : resident;
  multi_tensor_apply_norm_partials<<<grid, kThreads, 0, stream>>>(
      words, n_tensors, n_chunks, sq, bad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  multi_tensor_apply_adam_finalize<<<1, kFinalizeThreads, 0, stream>>>(
      sq, bad, n_chunks, hyper, static_cast<int32_t*>(count),
      static_cast<int32_t*>(notfinite_count),
      static_cast<uint8_t*>(last_finite),
      static_cast<int32_t*>(total_notfinite), out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  if (mu_bf16) {
    return has_ema
        ? launch_update<__nv_bfloat16, true>(words, n_tensors, n_chunks, out,
                                             hyper, stream)
        : launch_update<__nv_bfloat16, false>(words, n_tensors, n_chunks,
                                              out, hyper, stream);
  }
  return has_ema
      ? launch_update<float, true>(words, n_tensors, n_chunks, out, hyper,
                                   stream)
      : launch_update<float, false>(words, n_tensors, n_chunks, out, hyper,
                                    stream);
}

// A device buffer of `bytes` in *out holding the host memory at `src`,
// allocated with cudaMalloc outside PyTorch's allocator and written
// before the call returns, on a stream of its own, with this thread's
// capture mode relaxed: a captured update reads a table written once, at
// capture, from memory that no other tensor of the graph's pool shares,
// and its graph holds no copy. Returns a cudaError_t.
extern "C" int multi_tensor_adam_table_create(void** out, const void* src,
                                              size_t bytes) {
  *out = nullptr;
  cudaStreamCaptureMode mode = cudaStreamCaptureModeRelaxed;
  cudaError_t err = cudaThreadExchangeStreamCaptureMode(&mode);
  if (err != cudaSuccess) return err;
  void* buffer = nullptr;
  cudaStream_t stream = nullptr;
  err = cudaMalloc(&buffer, bytes);
  if (err == cudaSuccess) {
    err = cudaStreamCreateWithFlags(&stream, cudaStreamNonBlocking);
  }
  if (err == cudaSuccess) {
    err = cudaMemcpyAsync(buffer, src, bytes, cudaMemcpyHostToDevice, stream);
    const cudaError_t synced = cudaStreamSynchronize(stream);
    if (err == cudaSuccess) err = synced;
  }
  if (stream != nullptr) {
    const cudaError_t destroyed = cudaStreamDestroy(stream);
    if (err == cudaSuccess) err = destroyed;
  }
  if (err == cudaSuccess) {
    *out = buffer;
  } else if (buffer != nullptr) {
    cudaFree(buffer);
  }
  const cudaError_t restored = cudaThreadExchangeStreamCaptureMode(&mode);
  return err == cudaSuccess ? restored : err;
}

// Frees a buffer of multi_tensor_adam_table_create. Returns a cudaError_t.
extern "C" int multi_tensor_adam_table_destroy(void* buffer) {
  cudaStreamCaptureMode mode = cudaStreamCaptureModeRelaxed;
  cudaError_t err = cudaThreadExchangeStreamCaptureMode(&mode);
  if (err != cudaSuccess) return err;
  err = cudaFree(buffer);
  const cudaError_t restored = cudaThreadExchangeStreamCaptureMode(&mode);
  return err == cudaSuccess ? restored : err;
}

extern "C" int multi_tensor_adam_num_scalars() { return kNumScalars; }

extern "C" const char* multi_tensor_adam_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
