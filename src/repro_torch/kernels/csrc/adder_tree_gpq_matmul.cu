// Adder-tree GPQ matmul: the single-ADC interface (arXiv:2212.04320),
// for sm_90a.
//
// Replaces repro/kernels/cim_mac.py::adder_tree_gpq_matmul (Pallas
// kernel _adder_tree_kernel). For x [M, K] int32 activation codes
// (0 .. 255) and w [K, N] weight bytes (int8 codes or uint8 packed-plane
// bytes):
//
//   merged[m, g, n] = sum_b s_b 2^b sum_{k in group g} x[m, k] bit_b(w[k, n])
//   code            = clip(floor(merged / step (+ 1/2 if nearest)),
//                          code_min, code_max)
//   out[m, n]       = step * sum_g code
//
// with s_b = -1 on the MSB plane and (step, code_min, code_max) from
// variants.merged_quant. No bit planes are unpacked: for a two's-
// complement weight sum_b s_b 2^b bit_b(w) = w, so a group's merged
// value is the dot product of its activation codes with the weight
// codes, sign-extended from bit weight_bits - 1 of the masked low bits
// (int8 codes and uint8 packed-plane bytes give the same value).
//
// The code is the reference's float32 code: floor(RN(RN(merged / step)
// + half)). Where the step is not a whole number of merged units,
// merged / step can land within half an ulp of an integer, and float32
// rounds it onto that integer where exact rational arithmetic does not,
// so the quotient must be float32's correctly rounded one. The kernel
// gets it without a divide: with r = RN(1 / step), q0 = RN(merged r),
// the residual e = RN(merged - q0 step) (exact) and q = RN(q0 + e r),
// three operations and no branch (a divide carries a slow-path branch
// per call, which serialises a lane's conversions). The host checks q
// against true division for every merged value the kernel can meet
// before it launches (recip_is_exact below).
//
// What bounds it on an H100: the int32 x stream, as for gpq_matmul.cu
// (the same operands: 0.34 ms per ResNet forward at batch 256). The
// design is plane_mma.cuh's with one signed plane (SignedPlane): one
// mma.m16n8k16 u8 x s8 per (row group, 8 outputs), 1/8 of the per-plane
// kernels' tensor-core work, and one conversion per (group, output),
// 1/8 of their codes, about 10 full-rate instructions each (the int ->
// float, floor and float -> int conversions as exact magic-number adds,
// not the conversion unit's quarter-rate instructions), summed in int32
// and scaled by step once at the store (the wrapper's depth guard keeps
// the sum below 2^24).

#include <cmath>
#include <mutex>
#include <vector>

#include "gpq_launch.cuh"
#include "plane_mma.cuh"

namespace {

constexpr float kMagic = 12582912.0f;  // 1.5 * 2^23
constexpr int kMagicBits = 0x4B400000;  // its bits
constexpr int kCodeLimit = 1 << 22;     // |code| bound of the magic floor

struct MergedConversion {
  static constexpr bool kPacked = false;
  struct Table {};
  float step;  // f32(merged_quant.step)
  float recip;  // RN(1 / step)
  float half;  // 1/2 in nearest mode, else 0
  float code_min, code_max;  // within +-2^20: bits_eff <= q_merged <= 21

  __device__ __forceinline__ void fill(Table&) const {}
  __device__ __forceinline__ int code(const Table&, int merged) const {
    // bound: |merged| <= 2^(weight_bits-1) rows 255 < 2^21 (weight_bits
    // <= 8, rows <= 32), so kMagic + merged is exact with ulp 1
    const float m =
        __fsub_rn(__int_as_float(kMagicBits + merged), kMagic);
    const float q0 = __fmul_rn(m, recip);
    const float q = __fmaf_rn(__fmaf_rn(-q0, step, m), recip, q0);
    const float t = fminf(fmaxf(__fadd_rn(q, half), code_min), code_max);
    // t + kMagic rounded down is kMagic + floor(t) for |t| <= 2^22
    return __float_as_int(__fadd_rd(t, kMagic)) - kMagicBits;
  }
};

// Whether the kernel's quotient is RN(m / step) for every |m| <=
// max_abs, computed on the host as the kernel computes it (no
// contraction: the host build targets plain x86-64 SSE, and std::fma
// rounds once); cached per (step, max_abs).
bool recip_is_exact(float step, int max_abs) {
  struct Checked {
    float step;
    int max_abs;
    bool exact;
  };
  static std::mutex mu;
  static std::vector<Checked> seen;
  std::lock_guard<std::mutex> lock(mu);
  for (const Checked& c : seen)
    if (c.step == step && c.max_abs == max_abs) return c.exact;
  const float recip = 1.0f / step;
  bool exact = true;
  for (int m = -max_abs; exact && m <= max_abs; ++m) {
    const float mf = static_cast<float>(m);
    const float q0 = mf * recip;
    exact = std::fma(std::fma(-q0, step, mf), recip, q0) == mf / step;
  }
  seen.push_back({step, max_abs, exact});
  return exact;
}

}  // namespace

extern "C" {

// Launches on `stream` at column tile `bn` (16, 32 or 64; 0 picks it by
// N) without synchronising; returns cudaGetLastError(),
// or cudaErrorNotSupported where the reciprocal quotient is not float32's
// correctly rounded one for some merged value.
int adder_tree_gpq_matmul_launch(const void* x, const void* w, void* out,
                                 int M, int K, int N, int rows,
                                 int weight_bits, int code_min,
                                 int code_max, int nearest, float step,
                                 int bn, void* stream) {
  if (gpq::bad_shape(M, K, N, rows, weight_bits) || rows > 32 ||
      !(step > 0.0f) || code_min > code_max || code_min < -kCodeLimit ||
      code_max > kCodeLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  const int max_abs = (1 << (weight_bits - 1)) * rows * 255;
  if (!recip_is_exact(step, max_abs))
    return static_cast<int>(cudaErrorNotSupported);
  const MergedConversion conv{step, 1.0f / step, nearest ? 0.5f : 0.0f,
                              static_cast<float>(code_min),
                              static_cast<float>(code_max)};
  return static_cast<int>(gpq::launch_plane_gpq<gpq::SignedPlane>(
      x, w, out, M, K, N, rows, weight_bits, conv, step, bn,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
