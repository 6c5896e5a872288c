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
// tensor-core rate. What the design does about it: the tiling of
// gpq_tile.cuh reads every x element from device memory once and
// reuses it from shared memory for all BN columns and all B planes. A
// pMAC -> code table sits in shared memory beside the tiles (it takes
// 1.5-1.7x less time per forward than dividing for every code, 32- or
// 64-bit; PERF.md). The plane MACs run on the integer ALUs, one plane
// at a time, so this first version is bound by instruction issue above
// the byte bound (see PERF.md); int8 tensor-core MMA over the 0/1
// planes and narrower activation codes are the next steps.

#include "gpq_tile.cuh"

namespace {

constexpr int kLutMax = 1024;  // pMAC values with a tabulated code

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

// The coarse-fine flash as a pMAC -> code table: every pMAC that does
// not read code 0 or the top code, while the threshold (at most
// 2^q_full, 256 at 16 rows of 4-bit inputs) fits the table.
struct FlashTable {
  struct Table {
    int32_t code[kLutMax];
  };
  int adc_bits, threshold, code_max, nearest;

  __device__ __forceinline__ void fill(Table& t) const {
    for (int p = threadIdx.x; p < min(threshold, kLutMax);
         p += gpq::kThreads)
      t.code[p] = adc_code(p, adc_bits, threshold, code_max, nearest);
  }
  __device__ __forceinline__ int code(const Table& t, int p) const {
    return (p >= 0 && p < min(threshold, kLutMax))
        ? t.code[p]
        : adc_code(p, adc_bits, threshold, code_max, nearest);
  }
};

}  // namespace

extern "C" {

// Launches on `stream` without synchronising; returns cudaGetLastError().
int gpq_matmul_launch(const void* x, const void* w, void* out, int M, int K,
                      int N, int rows, int weight_bits, int adc_bits,
                      int threshold, int adc_codes, int nearest,
                      float adc_step, void* stream) {
  if (gpq::bad_shape(M, K, N, rows, weight_bits) || threshold <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const FlashTable adc{adc_bits, threshold, adc_codes - 1, nearest};
  return static_cast<int>(gpq::launch_plane_gpq(
      x, w, out, M, K, N, rows, weight_bits, adc, adc_step,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
