// Shared pieces of the GPQ matmul kernels, for sm_90a: the shared-memory
// tiling of the adder-tree kernel (adder_tree_gpq_matmul.cu), the weight
// masking and the launch checks of all three. The per-plane kernels of
// B1 and B3 are in plane_mma.cuh.
//
// The adder-tree tiling computes, for x [M, K] int32 activation codes and
// w [K, N] weight bytes (int8 two's-complement codes or uint8 packed-plane
// bytes; the low weight_bits of either are the code bits), one result per
// (16-row group, output), then an ADC code of it, summed over groups:
//
//   * one block owns an output tile [BM, BN] as wide as the layer (N <= 64
//     on the ResNet path; BN in {16, 32, 64} follows N), so every x
//     element is read from device memory exactly once, in coalesced rows;
//   * a loop over K chunks of whole row groups inside the block takes the
//     place of the TPU kernel's sequential k grid axis; each chunk of x
//     (int32, odd row stride against bank conflicts) and of w (bytes) is
//     staged in shared memory, where all BN columns reuse each x code;
//   * each thread accumulates kTM x kTN outputs in int32 registers and
//     scales them to float32 once in the epilogue (the wrappers' depth
//     guards keep the sum below 2^24, so the result is exact);
//   * a K tail is a short group whose missing rows are zero (the
//     reference's zero padding); ragged M and N edges are masked.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gpq {

constexpr int kThreads = 256;
constexpr int kTM = 4;             // outputs per thread along M
constexpr int kTN = 4;             // outputs per thread along N
constexpr int kXTileElems = 8192;  // int32 x codes staged per K chunk

template <int BN>
struct Tile {
  static constexpr int TX = BN / kTN;       // threads along N
  static constexpr int TY = kThreads / TX;  // threads along M
  static constexpr int BM = TY * kTM;       // tile rows
  static constexpr int KC_MAX = kXTileElems / BM;
};

// The K chunk of a launch: whole row groups, at most KC_MAX rows of K.
template <int BN>
inline int chunk_rows(int rows) {
  return (Tile<BN>::KC_MAX / rows) * rows;
}

// w byte -> the code bits the kernel reads: the low weight_bits, and for
// kSigned their two's-complement value sign-extended into the int8 byte.
template <bool kSigned>
__device__ __forceinline__ uint8_t weight_bits_of(uint8_t v, int weight_bits) {
  const uint32_t u = v & ((1u << weight_bits) - 1u);
  if (!kSigned) return static_cast<uint8_t>(u);
  const int s = static_cast<int>(u << (32 - weight_bits)) >> (32 - weight_bits);
  return static_cast<uint8_t>(static_cast<int8_t>(s));
}

// Stage one K chunk: xs[r * (kc + 1) + c] = x[m0 + r, k0 + c] and
// ws[r * BN + c] = w[k0 + r, n0 + c] (zero outside the operands).
template <int BN, bool kSigned>
__device__ __forceinline__ void stage_chunk(
    int32_t* xs, uint8_t* ws, const int32_t* __restrict__ x,
    const uint8_t* __restrict__ w, int M, int K, int N, int m0, int n0,
    int k0, int kc, int weight_bits) {
  constexpr int BM = Tile<BN>::BM;
  const int tid = threadIdx.x;
  const int xstride = kc + 1;
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
        ? weight_bits_of<kSigned>(w[static_cast<size_t>(gk) * N + gn],
                                  weight_bits)
        : 0;
  }
}

// Write the int32 tile sums, scaled once, to out (masked at the edges).
template <int BN>
__device__ __forceinline__ void store_tile(const int (&acc)[kTM][kTN],
                                           float* __restrict__ out, int M,
                                           int N, int m0, int n0,
                                           float scale) {
  constexpr int TX = Tile<BN>::TX;
  constexpr int TY = Tile<BN>::TY;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gm = m0 + ty + i * TY;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gn = n0 + tx * kTN + j;
      if (gn < N)
        out[static_cast<size_t>(gm) * N + gn] =
            static_cast<float>(acc[i][j]) * scale;
    }
  }
}

// Arguments every launch entry point validates the same way.
inline bool bad_shape(int M, int K, int N, int rows, int weight_bits) {
  return M <= 0 || N <= 0 || K <= 0 || rows <= 0 || weight_bits < 1 ||
         weight_bits > 8;
}

}  // namespace gpq

extern "C" {

// Each kernel library carries its own copy; ctypes resolves it per library.
const char* gpq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
