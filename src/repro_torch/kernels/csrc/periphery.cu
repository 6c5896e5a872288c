// The digital periphery of one macro call, for sm_90a: the per-tensor
// activation quantizer in front of the GPQ matmul and the dequantizing
// epilogue behind it (core/engine.py quantized_backend).
//
// Replaces no Pallas kernel: the JAX package leaves both to XLA, which
// fuses them into its jitted step. Eager PyTorch ran them as about 23 ATen
// launches a macro call (amin, amax, the scale's scalar ops, div, round,
// add, clamp and cast over x; cast, mul, sub, mul, mul and cast over the
// output). For x [M, K] of dtype T (float32, bfloat16 or float16):
//
//   act_range         per-block partial (min, max) of x (two-pass form only)
//   act_quant         the range (reduced by the block over x itself, from
//                     act_range's partials, or read from the device scalars
//                     quant.percentile gave), the scale and zero point,
//                     then codes = clamp(round(x / scale) (+ zp), 0, qmax)
//   dequant_epilogue  y = ((y_int - f32(zp) * colsum) * f32(scale)) * wscale
//                     cast to the output dtype
//
// Bit for bit what quant.quantize_acts and the engine's epilogue give on
// CUDA: every op computes in float32 and rounds to T after it, as ATen's
// opmath does; division, product and difference are the _rn intrinsics,
// so nvcc contracts nothing into an FMA; round is rintf (half to even, as
// torch.round); the float -> int32 cast is C's (cvt.rzi, NaN reads 0), as
// ATen's copy; NaN propagates through min and max as torch.amin and
// torch.amax propagate it. kernels/periphery.py's plain versions take the
// same ops in PyTorch, which the card tests hold the kernels to.
//
// What bounds it on an H100: bytes. The quantizer reads x twice (once to
// range it, once to code it; the second read partly from L2 at prefill
// sizes) and writes 4-byte codes; the epilogue reads the float32 macro
// output and writes T. At decode and expert sizes (a few thousand
// elements) the launch is the cost, so one single-block launch does
// everything there. Above the wrapper's SINGLE_BLOCK_MAX (set by
// measurement on the card) two launches: partial ranges per block, then
// every block reduces all partials itself and writes its slice of codes;
// block 0 writes the scale and the zero point. No atomics and no counter
// to reset, so a CUDA graph replays either form.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <cstring>

#include "gpq_launch.cuh"

namespace {

constexpr int kThreads = 512;  // every kernel's block

// Element types by the codes the wrapper passes.
enum Dtype : int { kF32 = 0, kBF16 = 1, kF16 = 2 };
// Where act_quant takes the range from.
enum RangeSrc : int { kRangeSelf = 0, kRangePartials = 1, kRangeGiven = 2 };

// f: T -> float (exact); to: float -> T (round to nearest even); r: the
// float rounded to T and read back, one ATen op's result.
template <typename T>
struct Fmt;
template <>
struct Fmt<float> {
  static __device__ __forceinline__ float f(float v) { return v; }
  static __device__ __forceinline__ float to(float v) { return v; }
  static __device__ __forceinline__ float r(float v) { return v; }
};
template <>
struct Fmt<__nv_bfloat16> {
  static __device__ __forceinline__ float f(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 to(float v) {
    return __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ float r(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};
template <>
struct Fmt<__half> {
  static __device__ __forceinline__ float f(__half v) {
    return __half2float(v);
  }
  static __device__ __forceinline__ __half to(float v) {
    return __float2half_rn(v);
  }
  static __device__ __forceinline__ float r(float v) {
    return __half2float(__float2half_rn(v));
  }
};

// min and max that keep a NaN once they meet one (torch.amin/amax).
__device__ __forceinline__ float min_nan(float a, float b) {
  return (b < a || b != b) ? b : a;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (b > a || b != b) ? b : a;
}

// clamp(v, 0, hi) as ATen's clamp with scalar bounds: NaN passes.
__device__ __forceinline__ float clamp0(float v, float hi) {
  return v != v ? v : fminf(fmaxf(v, 0.0f), hi);
}

// Four consecutive elements (the pointer aligned to four of them).
template <typename T>
__device__ __forceinline__ void load4(const T* p, float (&v)[4]) {
  if constexpr (sizeof(T) == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    T e[4];
    memcpy(e, &q, sizeof(q));
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = Fmt<T>::f(e[i]);
  }
}

template <typename T>
__device__ __forceinline__ void store4(T* p, const float (&v)[4]) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    T e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) e[i] = Fmt<T>::to(v[i]);
    uint2 q;
    memcpy(&q, e, sizeof(q));
    *reinterpret_cast<uint2*>(p) = q;
  }
}

// This thread's grid-stride share of x's (min, max): four elements at a
// time where x is aligned to four, then the tail one by one.
template <typename T>
__device__ void thread_range(const T* __restrict__ x, long long n, bool vec,
                             float& lo, float& hi) {
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long n4 = vec ? n / 4 : 0;
  for (long long i = tid; i < n4; i += stride) {
    float v[4];
    load4<T>(x + 4 * i, v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      lo = min_nan(lo, v[j]);
      hi = max_nan(hi, v[j]);
    }
  }
  for (long long i = 4 * n4 + tid; i < n; i += stride) {
    const float v = Fmt<T>::f(x[i]);
    lo = min_nan(lo, v);
    hi = max_nan(hi, v);
  }
}

// The block's (min, max), left in every thread.
__device__ void block_range(float& lo, float& hi) {
  __shared__ float s_lo[32], s_hi[32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min_nan(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max_nan(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  const int warps = blockDim.x / 32;
  lo = lane < warps ? s_lo[lane] : INFINITY;
  hi = lane < warps ? s_hi[lane] : -INFINITY;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min_nan(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max_nan(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
}

struct QParams {
  float scale;  // a value of T
  float zp;     // the zero point as the code's add reads it
  int zp_code;
};

// quant.quantize_acts' scale and zero point from the range (lo, hi), op
// for op. qmax is the clamp's bound (float, as ATen's opmath takes a scalar
// bound); true_divide divides by qmax as a 0-d tensor of T, r(qmax).
template <typename T>
__device__ __forceinline__ QParams qparams(float lo, float hi, float qmax,
                                           float eps, int symmetric) {
  using F = Fmt<T>;
  const float qdiv = F::r(qmax);
  if (symmetric) {
    const float c = hi != hi ? hi : F::r(fmaxf(hi, eps));  // clamp_min
    return {F::r(__fdiv_rn(c, qdiv)), 0.0f, 0};
  }
  // lo + eps: CUDA adds a Python scalar in float32 (its original value).
  const float t = F::r(__fadd_rn(lo, eps));
  const float h = hi != hi ? hi : (t != t ? t : fmaxf(hi, t));  // maximum
  const float s = F::r(__fdiv_rn(F::r(__fsub_rn(h, lo)), qdiv));
  const float z = F::r(clamp0(rintf(F::r(__fdiv_rn(-lo, s))), qmax));
  const int zc = static_cast<int>(z);
  return {s, static_cast<float>(zc), zc};
}

template <typename T>
__device__ __forceinline__ int code_of(float x, const QParams& q, float qmax,
                                       int symmetric) {
  using F = Fmt<T>;
  float v = rintf(F::r(__fdiv_rn(x, q.scale)));
  if (!symmetric) v = F::r(__fadd_rn(v, q.zp));
  return static_cast<int>(F::r(clamp0(v, qmax)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    act_range(const T* __restrict__ x, long long n, int vec,
              float2* __restrict__ partials) {
  float lo = INFINITY, hi = -INFINITY;
  thread_range<T>(x, n, vec, lo, hi);
  block_range(lo, hi);
  if (threadIdx.x == 0) partials[blockIdx.x] = make_float2(lo, hi);
}

// One block per SM at least: without it ptxas caps the float32 instance at
// 32 registers and spills around its divisions' slow path.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    act_quant(const T* __restrict__ x, long long n, int vec, int src,
              const float2* __restrict__ partials, int n_partials,
              const T* __restrict__ lo_in, const T* __restrict__ hi_in,
              float qmax, float eps, int symmetric, int* __restrict__ codes,
              T* __restrict__ scale_out, int* __restrict__ zp_out) {
  float lo = INFINITY, hi = -INFINITY;
  if (src == kRangeSelf) {  // a single block over all of x
    thread_range<T>(x, n, vec, lo, hi);
    block_range(lo, hi);
  } else if (src == kRangePartials) {
    for (int i = threadIdx.x; i < n_partials; i += blockDim.x) {
      const float2 p = partials[i];
      lo = min_nan(lo, p.x);
      hi = max_nan(hi, p.y);
    }
    block_range(lo, hi);
  } else {
    lo = Fmt<T>::f(*lo_in);
    hi = Fmt<T>::f(*hi_in);
  }
  const QParams q = qparams<T>(lo, hi, qmax, eps, symmetric);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *scale_out = Fmt<T>::to(q.scale);
    *zp_out = q.zp_code;
  }
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long n4 = vec ? n / 4 : 0;
  for (long long i = tid; i < n4; i += stride) {
    float v[4];
    load4<T>(x + 4 * i, v);
    int4 c;
    c.x = code_of<T>(v[0], q, qmax, symmetric);
    c.y = code_of<T>(v[1], q, qmax, symmetric);
    c.z = code_of<T>(v[2], q, qmax, symmetric);
    c.w = code_of<T>(v[3], q, qmax, symmetric);
    reinterpret_cast<int4*>(codes)[i] = c;
  }
  for (long long i = 4 * n4 + tid; i < n; i += stride)
    codes[i] = code_of<T>(Fmt<T>::f(x[i]), q, qmax, symmetric);
}

// One output: ((y - f32(zp) * colsum) * scale) * wscale, every op rounded.
__device__ __forceinline__ float dequant(float y, float zp, float colsum,
                                         float scale, float wscale) {
  return __fmul_rn(__fmul_rn(__fsub_rn(y, __fmul_rn(zp, colsum)), scale),
                   wscale);
}

// y [m, n] float32; colsum, wscale [n] float32; scale a T_act scalar; zp an
// int32 scalar. With vec, four columns of one row at a time (n % 4 == 0,
// every pointer aligned); the column advances by the grid stride mod the
// row, so no thread divides in the loop.
template <typename T_act, typename T_out>
__global__ void __launch_bounds__(kThreads)
    dequant_epilogue(const float* __restrict__ y,
                     const float* __restrict__ colsum,
                     const float* __restrict__ wscale,
                     const T_act* __restrict__ scale_in,
                     const int* __restrict__ zp_in, T_out* __restrict__ out,
                     long long m, int n, int vec) {
  const float zp = static_cast<float>(*zp_in);
  const float scale = Fmt<T_act>::f(*scale_in);
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const int w = vec ? n / 4 : n;  // units of a row
  const long long total = m * w;
  const int step = static_cast<int>(stride % w);
  int col = static_cast<int>(tid % w);
  for (long long i = tid; i < total; i += stride) {
    if (vec) {
      float v[4];
      load4<float>(y + 4 * i, v);
      const float4 cs = *reinterpret_cast<const float4*>(colsum + 4 * col);
      const float4 ws = *reinterpret_cast<const float4*>(wscale + 4 * col);
      v[0] = dequant(v[0], zp, cs.x, scale, ws.x);
      v[1] = dequant(v[1], zp, cs.y, scale, ws.y);
      v[2] = dequant(v[2], zp, cs.z, scale, ws.z);
      v[3] = dequant(v[3], zp, cs.w, scale, ws.w);
      store4<T_out>(out + 4 * i, v);
    } else {
      out[i] = Fmt<T_out>::to(
          dequant(y[i], zp, colsum[col], scale, wscale[col]));
    }
    col += step;
    if (col >= w) col -= w;
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<std::uintptr_t>(p) % bytes == 0;
}

template <typename T>
cudaError_t launch_range(const void* x, long long n, int blocks,
                         void* partials, cudaStream_t st) {
  const bool vec = aligned(x, 4 * sizeof(T));
  act_range<T><<<blocks, kThreads, 0, st>>>(
      static_cast<const T*>(x), n, vec, static_cast<float2*>(partials));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_quant(const void* x, long long n, int blocks, int src,
                         const void* partials, int n_partials, const void* lo,
                         const void* hi, float qmax, float eps, int symmetric,
                         void* codes, void* scale, void* zp,
                         cudaStream_t st) {
  const bool vec = aligned(x, 4 * sizeof(T)) && aligned(codes, 16);
  act_quant<T><<<blocks, kThreads, 0, st>>>(
      static_cast<const T*>(x), n, vec, src,
      static_cast<const float2*>(partials), n_partials,
      static_cast<const T*>(lo), static_cast<const T*>(hi), qmax, eps,
      symmetric, static_cast<int*>(codes), static_cast<T*>(scale),
      static_cast<int*>(zp));
  return cudaGetLastError();
}

template <typename T_act, typename T_out>
cudaError_t launch_epilogue(const void* y, const void* colsum,
                            const void* wscale, const void* scale,
                            const void* zp, void* out, long long m, int n,
                            int blocks, cudaStream_t st) {
  const bool vec = n % 4 == 0 && aligned(y, 16) && aligned(colsum, 16) &&
                   aligned(wscale, 16) && aligned(out, 4 * sizeof(T_out));
  dequant_epilogue<T_act, T_out><<<blocks, kThreads, 0, st>>>(
      static_cast<const float*>(y), static_cast<const float*>(colsum),
      static_cast<const float*>(wscale), static_cast<const T_act*>(scale),
      static_cast<const int*>(zp), static_cast<T_out*>(out), m, n, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Partial (min, max) of x [n] into partials [blocks] (float2), on `stream`
// without synchronising; returns cudaGetLastError().
int act_range_launch(const void* x, int dtype, long long n, int blocks,
                     void* partials, void* stream) {
  if (n <= 0 || blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return static_cast<int>(launch_range<float>(x, n, blocks, partials, st));
    case kBF16:
      return static_cast<int>(
          launch_range<__nv_bfloat16>(x, n, blocks, partials, st));
    case kF16:
      return static_cast<int>(
          launch_range<__half>(x, n, blocks, partials, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Codes of x [n] into codes [n] (int32), the scale (one T) and the zero
// point (one int32), over `blocks` blocks; the range from src (kRangeSelf
// takes one block), on `stream` without synchronising; returns
// cudaGetLastError().
int act_quant_launch(const void* x, int dtype, long long n, int blocks,
                     int src, const void* partials, int n_partials,
                     const void* lo, const void* hi, float qmax, float eps,
                     int symmetric, void* codes, void* scale, void* zp,
                     void* stream) {
  if (n <= 0 || blocks <= 0 || (src == kRangeSelf && blocks != 1) ||
      (src == kRangePartials && n_partials <= 0) ||
      (src == kRangeGiven && (lo == nullptr || hi == nullptr)) || src < 0 ||
      src > kRangeGiven)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return static_cast<int>(launch_quant<float>(
          x, n, blocks, src, partials, n_partials, lo, hi, qmax, eps,
          symmetric, codes, scale, zp, st));
    case kBF16:
      return static_cast<int>(launch_quant<__nv_bfloat16>(
          x, n, blocks, src, partials, n_partials, lo, hi, qmax, eps,
          symmetric, codes, scale, zp, st));
    case kF16:
      return static_cast<int>(launch_quant<__half>(
          x, n, blocks, src, partials, n_partials, lo, hi, qmax, eps,
          symmetric, codes, scale, zp, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// out [m, n] (out_dtype: the activation dtype, or float32) from the macro
// output y [m, n] float32, over `blocks` blocks, on `stream` without
// synchronising; returns cudaGetLastError().
int dequant_epilogue_launch(const void* y, const void* colsum,
                            const void* wscale, const void* scale,
                            const void* zp, void* out, int act_dtype,
                            int out_dtype, long long m, int n, int blocks,
                            void* stream) {
  if (m <= 0 || n <= 0 || blocks <= 0 ||
      (out_dtype != act_dtype && out_dtype != kF32))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaErrorInvalidValue;
  switch (act_dtype) {
    case kF32:
      rc = launch_epilogue<float, float>(y, colsum, wscale, scale, zp, out, m,
                                         n, blocks, st);
      break;
    case kBF16:
      rc = out_dtype == kF32
               ? launch_epilogue<__nv_bfloat16, float>(
                     y, colsum, wscale, scale, zp, out, m, n, blocks, st)
               : launch_epilogue<__nv_bfloat16, __nv_bfloat16>(
                     y, colsum, wscale, scale, zp, out, m, n, blocks, st);
      break;
    case kF16:
      rc = out_dtype == kF32
               ? launch_epilogue<__half, float>(y, colsum, wscale, scale, zp,
                                                out, m, n, blocks, st)
               : launch_epilogue<__half, __half>(y, colsum, wscale, scale, zp,
                                                 out, m, n, blocks, st);
      break;
  }
  return static_cast<int>(rc);
}

}  // extern "C"
