// GPQ (grouped-partial-sum quantized) matmul of the P-8T macro, for sm_90a.
//
// Replaces repro/kernels/cim_mac.py::gpq_matmul (Pallas kernel
// _gpq_kernel with _grouped_plane_pmac). For x [M, K] int32 activation
// codes and w [K, N] weight bytes (int8 two's-complement codes or uint8
// packed-plane bytes; the low weight_bits of either are the code bits):
//
//   pMAC[m, g, b, n] = sum_{k in row group g} x[m, k] * bit_b(w[k, n])
//   code             = clip(floor(pMAC / adc_step (+ 1/2 if nearest)),
//                           0, adc_codes - 1)
//   out[m, n]        = adc_step * sum_g sum_b s_b * 2^b * code
//
// with s_b = -1 on the MSB plane. Codes come from integer arithmetic
// (adc_step = threshold / 2^adc_bits, so floor is (p << adc_bits) /
// threshold and nearest is ((2p << adc_bits) + threshold) /
// (2 threshold)); they equal the reference's float32 codes because a
// correctly rounded p / adc_step cannot cross an integer at these
// magnitudes. The shift-add sum is carried in int32 and multiplied by
// adc_step once in the epilogue: the wrapper's depth guard keeps it
// below 2^24, so the float32 result is exact, as the reference's is.
//
// What bounds it on an H100: the int32 x stream. At the ResNet's stage-0
// conv at batch 256, x is [262144, 144] int32, about 151 MB, against
// 2 KB of weights and 17 MB of output; at 3.35 TB/s the bytes alone
// take about 50 us, ten times the plane-MAC operations at the int8
// tensor-core rate. What the design does about it: one block owns an
// output tile as wide as the layer (N <= 64 on this path, BN in {16,
// 32, 64} follows N), so every x element is read from device memory
// exactly once, in coalesced rows, and staged in shared memory where
// all BN columns and all B planes reuse it. The weight tile and a
// pMAC -> code table sit in shared memory beside it (the table takes
// 1.5-1.7x less time per forward than dividing for every code, 32- or
// 64-bit; PERF.md). The plane MACs run
// on the integer ALUs, one plane at a time, so this first version is
// bound by instruction issue above the byte bound (see PERF.md); int8
// tensor-core MMA over the 0/1 planes and narrower activation codes are
// the next steps.
//
// A loop over K chunks (whole row groups) inside the block takes the
// place of the TPU's sequential k grid axis; a K tail is a short group
// whose missing rows are zero, which is the reference's zero padding.
// Ragged M and N edges are masked.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTM = 4;              // outputs per thread along M
constexpr int kTN = 4;              // outputs per thread along N
constexpr int kXTileElems = 8192;   // int32 x codes staged per K chunk
constexpr int kLutMax = 1024;       // pMAC values with a tabulated code

// The ADC code of one pMAC. A pMAC at or above the threshold reads the
// top code in both modes (its quotient is at least adc_codes), so the
// division only sees p < threshold.
__device__ __forceinline__ int adc_code(long long p, int adc_bits,
                                        int threshold, int code_max,
                                        int nearest) {
  if (p <= 0) return 0;  // floor of a non-positive pMAC clips to code 0
  if (p >= threshold) return code_max;
  const long long c =
      nearest ? (((2 * p) << adc_bits) + threshold) / (2LL * threshold)
              : (p << adc_bits) / threshold;
  return c > code_max ? code_max : static_cast<int>(c);
}

template <int BN>
__global__ void __launch_bounds__(kThreads)
gpq_kernel(const int32_t* __restrict__ x, const uint8_t* __restrict__ w,
           float* __restrict__ out, int M, int K, int N, int rows, int kc,
           int weight_bits, int adc_bits, int threshold, int code_max,
           int nearest, float adc_step) {
  constexpr int TX = BN / kTN;       // threads along N
  constexpr int TY = kThreads / TX;  // threads along M
  constexpr int BM = TY * kTM;       // tile rows
  // x tile rows have an odd stride (kc + 1) so that the TY rows a warp
  // reads at one k fall in distinct banks.
  __shared__ int32_t xs[kXTileElems + BM];
  __shared__ __align__(16) uint8_t ws[(kXTileElems / BM) * BN];
  __shared__ int32_t lut[kLutMax];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int xstride = kc + 1;
  const uint32_t mask = (1u << weight_bits) - 1u;

  // Codes of the pMACs below the threshold: every pMAC that does not
  // read code 0 or the top code, while the threshold (at most 2^q_full,
  // 256 at 16 rows of 4-bit inputs) fits the table.
  const int lut_n = min(threshold, kLutMax);
  for (int p = tid; p < lut_n; p += kThreads)
    lut[p] = adc_code(p, adc_bits, threshold, code_max, nearest);

  int acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += kc) {
    for (int idx = tid; idx < BM * kc; idx += kThreads) {
      const int r = idx / kc;
      const int c = idx - r * kc;
      const int gm = m0 + r;
      const int gk = k0 + c;
      xs[r * xstride + c] =
          (gm < M && gk < K) ? x[static_cast<size_t>(gm) * K + gk] : 0;
    }
    for (int idx = tid; idx < kc * BN; idx += kThreads) {
      const int r = idx / BN;
      const int c = idx - r * BN;
      const int gk = k0 + r;
      const int gn = n0 + c;
      ws[idx] = (gk < K && gn < N)
          ? static_cast<uint8_t>(w[static_cast<size_t>(gk) * N + gn] & mask)
          : 0;
    }
    __syncthreads();

    const int groups = (min(kc, K - k0) + rows - 1) / rows;
    for (int g = 0; g < groups; ++g) {
      for (int b = 0; b < weight_bits; ++b) {
        int pm[kTM][kTN];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) pm[i][j] = 0;
        for (int r = 0; r < rows; ++r) {
          const int kk = g * rows + r;
          int xv[kTM];
#pragma unroll
          for (int i = 0; i < kTM; ++i) xv[i] = xs[(ty + i * TY) * xstride + kk];
          const uint32_t wq =
              *reinterpret_cast<const uint32_t*>(&ws[kk * BN + tx * kTN]);
#pragma unroll
          for (int j = 0; j < kTN; ++j) {
            const int bit = static_cast<int>((wq >> (8 * j + b)) & 1u);
#pragma unroll
            for (int i = 0; i < kTM; ++i) pm[i][j] += xv[i] * bit;
          }
        }
        const bool msb = b == weight_bits - 1;
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) {
            const int p = pm[i][j];
            const int c = (p >= 0 && p < lut_n)
                ? lut[p]
                : adc_code(p, adc_bits, threshold, code_max, nearest);
            acc[i][j] += msb ? -(c << b) : (c << b);
          }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gm = m0 + ty + i * TY;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gn = n0 + tx * kTN + j;
      if (gn < N)
        out[static_cast<size_t>(gm) * N + gn] =
            static_cast<float>(acc[i][j]) * adc_step;
    }
  }
}

template <int BN>
cudaError_t launch(const int32_t* x, const uint8_t* w, float* out, int M,
                   int K, int N, int rows, int weight_bits, int adc_bits,
                   int threshold, int adc_codes, int nearest,
                   float adc_step, cudaStream_t stream) {
  constexpr int BM = (kThreads / (BN / kTN)) * kTM;
  const int kc = (kXTileElems / BM) / rows * rows;
  if (kc < rows) return cudaErrorInvalidValue;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  gpq_kernel<BN><<<grid, kThreads, 0, stream>>>(
      x, w, out, M, K, N, rows, kc, weight_bits, adc_bits, threshold,
      adc_codes - 1, nearest, adc_step);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` without synchronising; returns cudaGetLastError().
int gpq_matmul_launch(const void* x, const void* w, void* out, int M, int K,
                      int N, int rows, int weight_bits, int adc_bits,
                      int threshold, int adc_codes, int nearest,
                      float adc_step, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || rows <= 0 || weight_bits < 1 ||
      weight_bits > 8 || threshold <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xp = static_cast<const int32_t*>(x);
  const auto* wp = static_cast<const uint8_t*>(w);
  auto* op = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (N <= 16)
    err = launch<16>(xp, wp, op, M, K, N, rows, weight_bits, adc_bits,
                     threshold, adc_codes, nearest, adc_step, st);
  else if (N <= 32)
    err = launch<32>(xp, wp, op, M, K, N, rows, weight_bits, adc_bits,
                     threshold, adc_codes, nearest, adc_step, st);
  else
    err = launch<64>(xp, wp, op, M, K, N, rows, weight_bits, adc_bits,
                     threshold, adc_codes, nearest, adc_step, st);
  return static_cast<int>(err);
}

const char* gpq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
