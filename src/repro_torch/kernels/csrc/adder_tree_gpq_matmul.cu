// Adder-tree GPQ matmul: the single-ADC interface (arXiv:2212.04320),
// for sm_90a.
//
// Replaces repro/kernels/cim_mac.py::adder_tree_gpq_matmul (Pallas
// kernel _adder_tree_kernel). For x [M, K] int32 activation codes and
// w [K, N] weight bytes (int8 codes or uint8 packed-plane bytes):
//
//   merged[m, g, n] = sum_b s_b 2^b sum_{k in row group g} x[m, k] bit_b(w[k, n])
//   code            = clip(floor(merged / step (+ 1/2 if nearest)),
//                          code_min, code_max)
//   out[m, n]       = step * sum_g code
//
// with s_b = -1 on the MSB plane and (step, code_min, code_max) from
// variants.merged_quant. No bit planes are unpacked: for a two's-
// complement weight sum_b s_b 2^b bit_b(w) = w, so a group's merged
// value is the signed integer dot product of its activation codes with
// the weight codes, sign-extended from bit weight_bits - 1 of the masked
// low bits (so int8 codes and uint8 packed-plane bytes give the same
// value). That is one multiply-add per weight where the per-plane
// kernels do weight_bits of them.
//
// The codes come from integer arithmetic. step = threshold / 2^bits_eff
// (threshold of the merged range), so
//   code = floor((merged * 2^(bits_eff+1) + nearest * threshold)
//                / (2 * threshold)),
// a FLOOR division toward minus infinity: merged is signed, and C++ `/`
// truncates toward zero. The quotient is estimated in float32 (off by
// at most one at these magnitudes) and corrected with one exact int32
// remainder test. merged is first clamped to [m_lo, m_hi], the range
// outside which the code saturates anyway, which keeps the numerator in
// int32 (the wrapper checks the bound per operating point). The code
// sum is carried in int32 and scaled by step once in the epilogue, as
// the reference does; its depth guard keeps the sum below 2^24.
//
// What bounds it on an H100: the int32 x stream, as for gpq_matmul.cu
// (the same operands: 0.34 ms per ResNet forward at batch 256). The
// tiling is gpq_tile.cuh's; the arithmetic is 1/weight_bits of the
// per-plane kernels', so it runs several times faster than they do, but
// this first version is still bound by instruction issue above the byte
// bound (PERF.md).

#include "gpq_tile.cuh"

namespace {

struct MergedConversion {
  int m_lo, m_hi;      // merged clamp window (codes saturate outside)
  int scale_num;       // 2^(bits_eff + 1)
  int nearest_t;       // nearest * threshold
  int den;             // 2 * threshold
  int code_min, code_max;
  float inv_den;       // 1 / den, for the quotient estimate

  __device__ __forceinline__ int code(int merged) const {
    const int mg = min(max(merged, m_lo), m_hi);
    const int num = mg * scale_num + nearest_t;
    int q = __float2int_rd(__int2float_rn(num) * inv_den);
    const int r = num - q * den;
    if (r < 0) --q;
    else if (r >= den) ++q;
    return min(max(q, code_min), code_max);
  }
};

template <int BN>
__global__ void __launch_bounds__(gpq::kThreads)
adder_tree_kernel(const int32_t* __restrict__ x,
                  const uint8_t* __restrict__ w, float* __restrict__ out,
                  int M, int K, int N, int rows, int kc, int weight_bits,
                  MergedConversion conv, float step) {
  using T = gpq::Tile<BN>;
  constexpr int kTM = gpq::kTM;
  constexpr int kTN = gpq::kTN;
  __shared__ int32_t xs[gpq::kXTileElems + T::BM];
  // Weight codes, sign-extended into int8.
  __shared__ __align__(16) uint8_t ws[T::KC_MAX * BN];

  const int tx = threadIdx.x % T::TX;
  const int ty = threadIdx.x / T::TX;
  const int m0 = blockIdx.x * T::BM;
  const int n0 = blockIdx.y * BN;
  const int xstride = kc + 1;

  int acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += kc) {
    gpq::stage_chunk<BN, true>(xs, ws, x, w, M, K, N, m0, n0, k0, kc,
                               weight_bits);
    __syncthreads();
    const int groups = (min(kc, K - k0) + rows - 1) / rows;
    for (int g = 0; g < groups; ++g) {
      int mg[kTM][kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) mg[i][j] = 0;
      for (int r = 0; r < rows; ++r) {
        const int kk = g * rows + r;
        int xv[kTM];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
          xv[i] = xs[(ty + i * T::TY) * xstride + kk];
        const uint32_t wq =
            *reinterpret_cast<const uint32_t*>(&ws[kk * BN + tx * kTN]);
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          const int wv = static_cast<int8_t>((wq >> (8 * j)) & 0xffu);
#pragma unroll
          for (int i = 0; i < kTM; ++i) mg[i][j] += xv[i] * wv;
        }
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] += conv.code(mg[i][j]);
    }
    __syncthreads();
  }
  gpq::store_tile<BN>(acc, out, M, N, m0, n0, step);
}

template <int BN>
cudaError_t launch(const void* x, const void* w, void* out, int M, int K,
                   int N, int rows, int weight_bits,
                   const MergedConversion& conv, float step,
                   cudaStream_t stream) {
  using T = gpq::Tile<BN>;
  const int kc = gpq::chunk_rows<BN>(rows);
  if (kc < rows) return cudaErrorInvalidValue;
  const dim3 grid((M + T::BM - 1) / T::BM, (N + BN - 1) / BN);
  adder_tree_kernel<BN><<<grid, gpq::kThreads, 0, stream>>>(
      static_cast<const int32_t*>(x), static_cast<const uint8_t*>(w),
      static_cast<float*>(out), M, K, N, rows, kc, weight_bits, conv, step);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` without synchronising; returns cudaGetLastError().
// m_lo/m_hi: the merged clamp window; the wrapper has checked that
// max(|m_lo|, |m_hi|) * 2^(bits_eff+1) + threshold fits int32.
int adder_tree_gpq_matmul_launch(const void* x, const void* w, void* out,
                                 int M, int K, int N, int rows,
                                 int weight_bits, int bits_eff,
                                 int threshold, int code_min, int code_max,
                                 int m_lo, int m_hi, int nearest,
                                 float step, void* stream) {
  if (gpq::bad_shape(M, K, N, rows, weight_bits) || threshold <= 0 ||
      bits_eff < 1 || bits_eff > 29 || m_lo > m_hi)
    return static_cast<int>(cudaErrorInvalidValue);
  const MergedConversion conv{
      m_lo, m_hi, 2 << bits_eff, nearest ? threshold : 0, 2 * threshold,
      code_min, code_max, 1.0f / static_cast<float>(2 * threshold)};
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (N <= 16)
    err = launch<16>(x, w, out, M, K, N, rows, weight_bits, conv, step, st);
  else if (N <= 32)
    err = launch<32>(x, w, out, M, K, N, rows, weight_bits, conv, step, st);
  else
    err = launch<64>(x, w, out, M, K, N, rows, weight_bits, conv, step, st);
  return static_cast<int>(err);
}

}  // extern "C"
