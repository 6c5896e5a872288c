// GPQ (grouped-partial-sum quantized) matmul of the P-8T macro, for sm_90a.
//
// Replaces repro/kernels/cim_mac.py::gpq_matmul (Pallas kernel
// _gpq_kernel with _grouped_plane_pmac). For x [M, K] int32 activation
// codes (0 .. 255) and w [K, N] weight bytes (int8 two's-complement codes
// or uint8 packed-plane bytes; the low weight_bits of either are the code
// bits):
//
//   pMAC[m, g, b, n] = sum_{k in row group g} x[m, k] * bit_b(w[k, n])
//   code             = clip(floor(pMAC / adc_step (+ 1/2 if nearest)),
//                           0, adc_codes - 1)
//   out[m, n]        = adc_step * sum_g sum_b s_b * 2^b * code
//
// with s_b = -1 on the MSB plane. Codes come from integer arithmetic:
// adc_step = threshold / 2^adc_bits, so the code is floor((c1 p + c0) /
// d) with (c1, c0, d) = (2^adc_bits, 0, threshold) in floor mode and
// (2^(adc_bits+1), threshold, 2 threshold) in nearest mode. It equals the
// reference's float32 code because a correctly rounded p / adc_step
// cannot cross an integer at these magnitudes. The shift-add sum is
// carried in int32 and multiplied by adc_step once in the epilogue: the
// wrapper's depth guard keeps it below 2^24, so the float32 result is
// exact, as the reference's is.
//
// What bounds it on an H100: the int32 x stream (151 MB at the ResNet's
// stage-0 conv at batch 256, about 50 us), with the conversion's integer
// instructions close behind (3.4 G codes per forward; PERF.md measures
// the kernel bound by them). What the design does about it: the plane
// MACs run on the int8 tensor cores and the conversion in registers
// (plane_mma.cuh). Where the step is a power-of-two number s of pMACs
// (adc_step = threshold / 2^adc_bits; the paper's points at cutoff 0.5)
// and a group's sum fits 16 bits, the flash is floor((p + h) / s) with h =
// nearest * s / 2, exact for integers, as clamp-then-mask, two pMACs per
// instruction in 16-bit halves: a Hopper DPX add-min-relu takes p + h
// into [0, adc_codes s - 1], and clearing the low bits leaves code * s
// (FlashShift2). The host checks the form against the exact division
// for every pMAC from -1 to the threshold before it launches. Any other
// point reads a pMAC -> code table in shared memory (dividing above its
// 1024 entries), one code per register: several times slower than the
// packed flash (PERF.md times both at the ResNet's operands).

#include <algorithm>

#include "gpq_launch.cuh"
#include "plane_mma.cuh"

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

// The coarse-fine flash at a step of s = 2^k pMACs, two pMACs at a time
// (a 16-bit half each): q = max(min(p + h, top), 0) per half, top =
// adc_codes s - 1, and q with its low k bits cleared is code * s, the
// dequantized code; the launch scales the sum by adc_step / s = 1.
struct FlashShift2 {
  static constexpr bool kPacked = true;
  struct Table {};
  unsigned h2, top2, keep2;  // h, top, ~(s - 1) in both halves

  __device__ __forceinline__ void fill(Table&) const {}
  __device__ __forceinline__ unsigned code2(const Table&, unsigned p2) const {
    return __viaddmin_s16x2_relu(p2, h2, top2) & keep2;
  }
};

// The flash as a pMAC -> code table: every pMAC that does not read code
// 0 or the top code, while the threshold fits the table.
struct FlashTable {
  static constexpr bool kPacked = false;
  struct Table {
    int32_t code[kLutMax];
  };
  int adc_bits, threshold, code_max, nearest;

  __device__ __forceinline__ void fill(Table& t) const {
    for (int p = threadIdx.x; p < min(threshold, kLutMax);
         p += blockDim.x)
      t.code[p] = adc_code(p, adc_bits, threshold, code_max, nearest);
  }
  __device__ __forceinline__ int code(const Table& t, int p) const {
    return (p >= 0 && p < min(threshold, kLutMax))
        ? t.code[p]
        : adc_code(p, adc_bits, threshold, code_max, nearest);
  }
};

long long floor_div(long long a, long long d) {
  const long long q = a / d;
  return (a % d != 0 && a < 0) ? q - 1 : q;  // d > 0
}

// FlashShift2's constants, where the step is a power-of-two number s =
// 2^k of pMACs, a group's shift-add sum of code * s fits a signed 16-bit
// half (255 threshold < 2^15), and the form gives the exact code of every
// pMAC in [-1, threshold] (above it both read the top code); else false.
bool flash_shift2(int adc_bits, int threshold, int code_max, int nearest,
                  FlashShift2* f) {
  if (threshold % (1 << adc_bits) != 0 || 255 * threshold >= (1 << 15))
    return false;
  const int s = threshold >> adc_bits;
  if ((s & (s - 1)) != 0) return false;
  const int h = nearest ? s / 2 : 0;
  const int top = (code_max + 1) * s - 1;
  const long long c1 = (nearest ? 2LL : 1LL) << adc_bits;
  const long long c0 = nearest ? threshold : 0;
  const long long d = nearest ? 2LL * threshold : threshold;
  for (long long p = -1; p <= threshold; ++p) {
    const long long want =
        std::min(std::max(floor_div(c1 * p + c0, d), 0LL),
                 static_cast<long long>(code_max));
    if (std::max(std::min(p + h, static_cast<long long>(top)), 0LL) / s !=
        want)
      return false;
  }
  const unsigned both = 0x00010001u;
  *f = FlashShift2{both * h, both * top,
                   both * (0xffffu & ~static_cast<unsigned>(s - 1))};
  return true;
}

}  // namespace

extern "C" {

// Launches on `stream` at column tile `bn` (16, 32 or 64; 0 picks it by
// N) without synchronising; returns cudaGetLastError().
int gpq_matmul_launch(const void* x, const void* w, void* out, int M, int K,
                      int N, int rows, int weight_bits, int adc_bits,
                      int threshold, int adc_codes, int nearest,
                      float adc_step, int bn, void* stream) {
  if (gpq::bad_shape(M, K, N, rows, weight_bits) || threshold <= 0 ||
      adc_bits < 1 || adc_bits > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  FlashShift2 shift2;
  if (flash_shift2(adc_bits, threshold, adc_codes - 1, nearest, &shift2))
    return static_cast<int>(gpq::launch_plane_gpq<gpq::BitPlanes>(
        x, w, out, M, K, N, rows, weight_bits, shift2,
        adc_step / static_cast<float>(threshold >> adc_bits), bn, st));
  const FlashTable table{adc_bits, threshold, adc_codes - 1, nearest};
  return static_cast<int>(gpq::launch_plane_gpq<gpq::BitPlanes>(
      x, w, out, M, K, N, rows, weight_bits, table, adc_step, bn, st));
}

}  // extern "C"
