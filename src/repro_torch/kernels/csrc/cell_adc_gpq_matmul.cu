// Cell-embedded-ADC GPQ matmul (arXiv:2307.05944), for sm_90a.
//
// Replaces repro/kernels/cim_mac.py::cell_adc_gpq_matmul (Pallas kernel
// _cell_adc_kernel). For x [M, K] int32 activation codes and w [K, N]
// weight bytes (int8 codes or uint8 packed-plane bytes):
//
//   pMAC[m, g, b, n] = sum_{k in row group g} x[m, k] * bit_b(w[k, n])
//   code             = the adc_bits-step successive-approximation search
//                      of one comparator per column against the in-array
//                      reference levels t * adc_step: from the MSB down,
//                      keep trial = code | bit when
//                      pMAC (+ adc_step / 2 if nearest) >= trial * adc_step
//   out[m, n]        = adc_step * sum_g sum_b s_b * 2^b * code
//
// The search runs as the hardware does it, adc_bits compare/keep
// decisions per code, in integers: with adc_step = threshold /
// 2^adc_bits, a decision is
//   pMAC * 2^(adc_bits+1) + nearest * threshold >= 2 * trial * threshold.
// A pMAC is clamped to [-1, threshold] first, which changes no decision
// (at or above the threshold every trial is kept, below zero none) and
// keeps the products in int32. The codes equal the P-8T floor (or
// nearest) codes of gpq_matmul.cu on every input: the cell-ADC's ideal
// transfer is the flash's.
//
// What bounds it on an H100: as for gpq_matmul.cu, the int32 x stream
// sets the byte bound (the same operands: 0.34 ms per ResNet forward at
// batch 256), and this first version is bound by instruction issue on
// the plane MACs above it. The design is gpq_matmul.cu's tiling
// (gpq_tile.cuh); in place of its shared-memory code table each code
// costs adc_bits compare/select steps, which makes it slower than B1
// (PERF.md).

#include "gpq_tile.cuh"

namespace {

struct SarSearch {
  struct Table {};  // the references are the compare levels themselves
  int adc_bits, threshold, nearest;

  __device__ __forceinline__ void fill(Table&) const {}
  __device__ __forceinline__ int code(const Table&, int p) const {
    const int pc = min(max(p, -1), threshold);
    const int lhs = pc * (2 << adc_bits) + nearest * threshold;
    int code = 0;
    for (int bit = adc_bits - 1; bit >= 0; --bit) {
      const int trial = code | (1 << bit);
      if (lhs >= 2 * trial * threshold) code = trial;
    }
    return code;
  }
};

}  // namespace

extern "C" {

// Launches on `stream` without synchronising; returns cudaGetLastError().
int cell_adc_gpq_matmul_launch(const void* x, const void* w, void* out,
                               int M, int K, int N, int rows,
                               int weight_bits, int adc_bits, int threshold,
                               int nearest, float adc_step, void* stream) {
  if (gpq::bad_shape(M, K, N, rows, weight_bits) || threshold <= 0 ||
      adc_bits < 1 || adc_bits > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const SarSearch adc{adc_bits, threshold, nearest};
  return static_cast<int>(gpq::launch_plane_gpq(
      x, w, out, M, K, N, rows, weight_bits, adc, adc_step,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
