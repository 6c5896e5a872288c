// Cell-embedded-ADC GPQ matmul (arXiv:2307.05944), for sm_90a.
//
// Replaces repro/kernels/cim_mac.py::cell_adc_gpq_matmul (Pallas kernel
// _cell_adc_kernel). For x [M, K] int32 activation codes (0 .. 255) and
// w [K, N] weight bytes (int8 codes or uint8 packed-plane bytes):
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
//   pMAC * 2^(adc_bits+1) + nearest * threshold >= 2 * trial * threshold,
// or, where the step is a whole number s of pMACs (every point of the
// paper's grid), pMAC + nearest * floor(s / 2) >= trial * s. A pMAC of
// byte codes is at most 255 * 32 < 2^13, so the left side fits int32
// unclamped for adc_bits <= 16 (the wrapper checks the right side); it
// is clamped at 0, where no trial is kept (a pMAC is never negative here,
// and at -1 no trial is kept either). The codes equal the P-8T floor (or
// nearest) codes of gpq_matmul.cu on every input: the cell-ADC's ideal
// transfer is the flash's.
//
// What bounds it on an H100: as for gpq_matmul.cu, the int32 x stream
// sets the byte bound (the same operands: 0.34 ms per ResNet forward at
// batch 256), and the conversion's integer instructions come next. The
// design is gpq_matmul.cu's (plane_mma.cuh: the plane MACs on the int8
// tensor cores, the conversion and the shift-add in registers). In place
// of its divide, a code costs adc_bits compare/keep steps, one DPX
// add-min each, for two codes at a time (SarSearch below). At the grid's
// and the paper's adc_bits (3, 4, 5) the step count is a compile-time
// constant, and the search unrolls into straight-line code; other points
// take the run-time loop in a scaled form, one code at a time, several
// times slower (PERF.md times both at the ResNet's operands).

#include "gpq_launch.cuh"
#include "plane_mma.cuh"

namespace {

// The search in residual form: the residual r starts at the comparator's
// input q, and at each step, from the MSB down, the comparator keeps the
// step's level when r covers it (q >= trial level, trial = code | bit,
// is r >= level of bit). Keeping subtracts the level, so a step is one
// unsigned min(r - level, r): below the level the difference wraps above
// r and r stays. That is one DPX add-min per step, and q - r is the kept
// levels' sum, code * (level of bit 0).
//
// kBits > 0, a whole step of s pMACs where a group's shift-add sum fits
// a signed 16-bit half (255 threshold < 2^15): two pMACs at a time, one
// per half (__viaddmin_u16x2 wraps each half mod 2^16, where r and the
// levels live); q = max(p + h, 0), h = nearest * floor(s / 2) (p + s/2 >=
// trial s is p + h >= trial s for whole p and s), levels s 2^bit, and
// the code's contribution is q - r = code * s, its dequantized value:
// the launch scales the sum by adc_step / s = 1.
// kBits = 0, any step, adc_bits read at run time, one pMAC at a time
// (__viaddmin_u32): q = max(p 2^(bits+1) + nearest t, 0), levels 2 t
// 2^bit, code = umulhi(q - r, ceil(2^32 / 2t)).
template <int kBits>
struct SarSearch {
  static constexpr bool kPacked = kBits > 0;
  struct Table {};  // the references are the compare levels themselves
  int adc_bits, scale_p, offset;  // q = max(p * scale_p + offset, 0)
  unsigned recip;                 // kBits = 0: ceil(2^32 / (2 threshold))
  unsigned neg_level[16];         // -(level of bit): mod 2^32, or mod
                                  // 2^16 in both halves (kBits > 0)

  __device__ __forceinline__ void fill(Table&) const {}
  // kBits > 0: code * s of both halves.
  __device__ __forceinline__ unsigned code2(const Table&, unsigned p2) const {
    const unsigned q2 = __viaddmax_s16x2(p2, static_cast<unsigned>(offset),
                                         0u);
    unsigned r2 = q2;
#pragma unroll
    for (int bit = kBits - 1; bit >= 0; --bit)
      r2 = __viaddmin_u16x2(r2, neg_level[bit], r2);
    return q2 - r2;  // per half: q >= r, no borrow
  }
  // kBits = 0: the code.
  __device__ __forceinline__ int code(const Table&, int p) const {
    const unsigned q = static_cast<unsigned>(
        __viaddmax_s32(p * scale_p, offset, 0));
    unsigned r = q;
    for (int bit = adc_bits - 1; bit >= 0; --bit)
      r = __viaddmin_u32(r, neg_level[0] << bit, r);
    return static_cast<int>(__umulhi(q - r, recip));
  }
};

template <int kBits>
cudaError_t launch_sar(const void* x, const void* w, void* out, int M,
                       int K, int N, int rows, int weight_bits, int adc_bits,
                       int threshold, int nearest, float adc_step, int bn,
                       cudaStream_t stream) {
  SarSearch<kBits> adc{adc_bits, 0, 0, 0, {}};
  float scale = adc_step;
  if constexpr (kBits > 0) {
    const int s = threshold >> adc_bits;
    const unsigned both = 0x00010001u;
    adc.offset = static_cast<int>(both * (nearest ? s / 2 : 0));
    scale = adc_step / static_cast<float>(s);  // 1
    for (int bit = 0; bit < adc_bits; ++bit)
      adc.neg_level[bit] = both * ((0u - (static_cast<unsigned>(s) << bit)) &
                                   0xffffu);
  } else {
    const unsigned level = 2u * static_cast<unsigned>(threshold);
    adc.scale_p = 2 << adc_bits;
    adc.offset = nearest ? threshold : 0;
    adc.recip = static_cast<unsigned>(((1ULL << 32) + level - 1) / level);
    adc.neg_level[0] = 0u - level;
  }
  return gpq::launch_plane_gpq<gpq::BitPlanes>(x, w, out, M, K, N, rows,
                                               weight_bits, adc, scale, bn,
                                               stream);
}

}  // namespace

extern "C" {

// Launches on `stream` at column tile `bn` (16, 32 or 64; 0 picks it by
// N) without synchronising; returns cudaGetLastError().
int cell_adc_gpq_matmul_launch(const void* x, const void* w, void* out,
                               int M, int K, int N, int rows,
                               int weight_bits, int adc_bits, int threshold,
                               int nearest, float adc_step, int bn,
                               void* stream) {
  if (gpq::bad_shape(M, K, N, rows, weight_bits) || threshold <= 0 ||
      adc_bits < 1 || adc_bits > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t (*launch)(const void*, const void*, void*, int, int, int, int,
                        int, int, int, int, float, int, cudaStream_t) =
      launch_sar<0>;
  // A whole step, and a group's shift-add sum in a signed 16-bit half.
  if (threshold % (1 << adc_bits) == 0 && 255 * threshold < (1 << 15)) {
    if (adc_bits == 3) launch = launch_sar<3>;
    if (adc_bits == 4) launch = launch_sar<4>;
    if (adc_bits == 5) launch = launch_sar<5>;
  }
  return static_cast<int>(launch(x, w, out, M, K, N, rows, weight_bits,
                                 adc_bits, threshold, nearest, adc_step, bn,
                                 st));
}

}  // extern "C"
