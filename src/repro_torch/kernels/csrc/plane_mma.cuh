// The GPQ kernel of all three variants on the int8 tensor cores, for
// sm_90a: B1 (gpq_matmul.cu), B2 (adder_tree_gpq_matmul.cu) and B3
// (cell_adc_gpq_matmul.cu).
//
// For x [M, K] activation codes (int32 holding 0 .. 255) and w [K, N]
// weight bytes (int8 codes or uint8 packed-plane bytes; the low
// weight_bits are the code bits), each (16-row group g, plane b, output)
// gets
//
//   MAC = sum_{k in g} x[m, k] * plane_b(w[k, n]),   code = adc(MAC)
//
// and out[m, n] = scale * sum_g sum_b weight_b code. `Planes` says what
// the planes are: B1's and B3's 8 unsigned bit planes (a pMAC each,
// weight_b = s_b 2^b, s_b = -1 on the MSB plane), or B2's one signed
// plane, the two's-complement code (its MAC is the merged value sum_b
// s_b 2^b pMAC_b, weight 1). `Adc` is the conversion: B1's flash, B2's
// merged conversion, B3's SAR search.
//
// What bounds it on an H100: the int32 x stream, read once (151 MB, about
// 50 us at the ResNet's stage-0 conv at batch 256), and close behind it
// the conversion: one code per (group, plane, output), 3.4 G per ResNet
// forward for the per-plane variants (1/8 of that for B2), a few integer
// instructions each, on integer pipes that retire 64 lanes per clock per
// SM. The plane MACs are 1/10 of the bytes' time at the int8 tensor-core
// rate. What the design does about it:
//
//   * one mma.m16n8k16 (u8 x u8, or u8 x s8 for B2's signed plane ->
//     s32) per (row group, plane, 8 outputs): a group of up to 16 rows is
//     one k16 step, its missing rows zero in the weights (rows 4 and 8
//     are padded to 16 slots); up to 32 rows take two chained steps
//     before the conversion. All planes' products are issued before their
//     conversions, so the tensor cores' latency overlaps. Each lane holds
//     the same (row, column) positions of every plane's accumulator, so
//     it converts and adds weight_b code into its own int32 sums, kept
//     until one scaled store at the end. All 8 bit planes run,
//     branch-free: planes at and above weight_bits have all-zero weights,
//     whose code is 0;
//   * where the conversion allows (Adc::kPacked), two outputs share a
//     register, a 16-bit half each, so one instruction converts or
//     accumulates both; a group's sums are unpacked once per group;
//   * the weights are staged in shared memory transposed and padded per
//     group, [n][group * 16 + slot] bytes, so one 32-bit load gives a
//     lane its 4 k-consecutive bytes of one column (its B fragment of
//     every bit plane: (word >> b) & 0x01010101, two instructions; of
//     the signed plane: the word, sign-extended once when staged);
//   * x goes global -> shared with cp.async, each lane copying exactly
//     the 16-byte runs of int32 codes it reads back (rows l/4 and l/4+8
//     at k 4t .. 4t+3, one m16n8k16 A register each, packed to bytes
//     with three byte permutes), so no barrier guards them; a ring of
//     kRingSteps k16 steps per lane keeps the next groups' copies in
//     flight while the current one is converted. Each x element is read
//     from device memory once per column tile (once for N <= 64).
//
// Tiles: 4 warps per block, one 16-row m tile each (BM = 64 rows), BN in
// {16, 32, 64} columns: the caller's choice (a tuned pin), or by default
// the smallest that covers N, up to 64. A K tail is a short group whose
// missing rows read zero (the reference's zero padding); ragged M and N
// edges are masked.

#pragma once

#include "ptx.cuh"

namespace gpq {

// B1's and B3's planes: the 8 unsigned bit planes of the masked code
// bits, weighted s_b 2^b.
struct BitPlanes {
  static constexpr int kPlanes = 8;
  static __device__ __forceinline__ uint32_t staged(uint32_t u, int) {
    return u;
  }
  static __device__ __forceinline__ uint32_t fragment(uint32_t word,
                                                      int b) {
    return (word >> b) & 0x01010101u;
  }
  static __device__ __forceinline__ void mma(int (&d)[4], uint32_t a0,
                                             uint32_t a1, uint32_t b) {
    mma_u8(d, a0, a1, b);
  }
  static __device__ __forceinline__ int weight(int b, int weight_bits) {
    return b == weight_bits - 1 ? -(1 << b) : (1 << b);
  }
};

// B2's plane: the two's-complement code itself, for which sum_b s_b 2^b
// bit_b(w) = w, so a group's product is its merged value. The masked
// code bits u of each staged byte are sign-extended from bit
// weight_bits - 1: (u ^ s) - s per byte, s = 2^(weight_bits - 1) (for u
// < s that is u; else u - 2^weight_bits, mod 2^8).
struct SignedPlane {
  static constexpr int kPlanes = 1;
  static __device__ __forceinline__ uint32_t staged(uint32_t u,
                                                    int weight_bits) {
    const uint32_t s4 = (1u << (weight_bits - 1)) * 0x01010101u;
    return __vsub4(u ^ s4, s4);
  }
  static __device__ __forceinline__ uint32_t fragment(uint32_t word, int) {
    return word;
  }
  static __device__ __forceinline__ void mma(int (&d)[4], uint32_t a0,
                                             uint32_t a1, uint32_t b) {
    mma_u8s8(d, a0, a1, b);
  }
  static __device__ __forceinline__ int weight(int, int) { return 1; }
};

constexpr int kPlaneWarps = 4;
constexpr int kPlaneThreads = 32 * kPlaneWarps;
constexpr int kPlaneBM = 16 * kPlaneWarps;
constexpr int kRingSteps = 4;  // k16 steps of x in the ring, per lane

// Weight bytes staged per K chunk: kSlots k slots (whole groups) of every
// column, each column kStride bytes apart. kStride / 4 = 4 (mod 32), so
// the 32 lanes' B loads (8 columns x 4 words) hit 32 banks.
template <int BN>
struct PlaneTile {
  static constexpr int kSlots = BN == 64 ? 256 : 512;
  static constexpr int kStride = kSlots + 16;
};

// Four int32 codes (0 .. 255) -> one register of four bytes, lowest k in
// the lowest byte.
__device__ __forceinline__ uint32_t pack_codes(uint4 v) {
  const uint32_t lo = __byte_perm(v.x, v.y, 0x0040);
  const uint32_t hi = __byte_perm(v.z, v.w, 0x0040);
  return __byte_perm(lo, hi, 0x5410);
}

// Stage the weights of groups [g0, g0 + ng) as ws[n * kStride + slot]:
// slot (g - g0) * 16 kS + s holds the low weight_bits of w[g rows + s, n0
// + n] as Planes stages them, zero for s >= rows, k >= K or n0 + n >= N
// (a zero byte stages as zero in both forms). With wvec (rows % 4 ==
// N % 4 == 0, w 4-byte aligned) a task is a 4 x 4 byte block: four 32-bit
// loads of 4 columns from 4 consecutive k rows, transposed with eight
// byte permutes into 4 words of 4 k-consecutive bytes of one column;
// consecutive lanes take consecutive slot quads, so the stores fall in
// distinct banks. Otherwise each byte is loaded alone.
template <int BN, int kS, class Planes>
__device__ __forceinline__ void stage_plane_weights(
    uint8_t* ws, const uint8_t* __restrict__ w, int K, int N, int n0,
    int rows, int weight_bits, bool wvec, int g0, int ng) {
  constexpr int kGroupSlots = 16 * kS;
  constexpr int kStride = PlaneTile<BN>::kStride;
  const int quads = ng * kGroupSlots / 4;  // per column
  const uint32_t mask = ((1u << weight_bits) - 1u) * 0x01010101u;
  auto staged = [&](uint32_t word) {
    return Planes::staged(word & mask, weight_bits);
  };
  if (wvec) {
    for (int idx = threadIdx.x; idx < BN / 4 * quads;
         idx += kPlaneThreads) {
      const int q = idx % quads;
      const int c = idx / quads;
      const int s0 = (4 * q) % kGroupSlots;
      const int k0 = (g0 + 4 * q / kGroupSlots) * rows + s0;
      const int gn = n0 + 4 * c;
      uint32_t r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        r[i] = (s0 < rows && k0 + i < K && gn < N)
            ? __ldg(reinterpret_cast<const uint32_t*>(
                  w + static_cast<size_t>(k0 + i) * N + gn))
            : 0u;
      const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
      const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);
      const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);
      const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
      uint8_t* dst = ws + 4 * c * kStride + 4 * q;
      *reinterpret_cast<uint32_t*>(dst) = staged(__byte_perm(t0, t1, 0x5410));
      *reinterpret_cast<uint32_t*>(dst + kStride) =
          staged(__byte_perm(t0, t1, 0x7632));
      *reinterpret_cast<uint32_t*>(dst + 2 * kStride) =
          staged(__byte_perm(t2, t3, 0x5410));
      *reinterpret_cast<uint32_t*>(dst + 3 * kStride) =
          staged(__byte_perm(t2, t3, 0x7632));
    }
    return;
  }
  for (int idx = threadIdx.x; idx < BN * quads; idx += kPlaneThreads) {
    const int q = idx % quads;
    const int n = idx / quads;
    const int gn = n0 + n;
    uint32_t word = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int sl = 4 * q + e;
      const int s = sl % kGroupSlots;
      const int k = (g0 + sl / kGroupSlots) * rows + s;
      if (s < rows && k < K && gn < N)
        word |= static_cast<uint32_t>(
                    __ldg(&w[static_cast<size_t>(k) * N + gn]))
                << (8 * e);
    }
    *reinterpret_cast<uint32_t*>(&ws[n * kStride + 4 * q]) = staged(word);
  }
}

// At least 4 blocks (16 warps) per SM, so up to 128 registers a thread:
// left to itself, ptxas caps the registers at the occupancy that shared
// memory allows (56 at BN = 16, 80 at BN = 64) and spills the 8 planes'
// products.
template <int BN, int kS, class Planes, class Adc>
__global__ void __launch_bounds__(kPlaneThreads, 4)
plane_mma_kernel(const int32_t* __restrict__ x,
                 const uint8_t* __restrict__ w, float* __restrict__ out,
                 int M, int K, int N, int rows, int weight_bits, int vec,
                 int wvec, Adc adc, float scale) {
  constexpr int kNT = BN / 8;
  constexpr int kPlanes = Planes::kPlanes;
  constexpr int kGroupSlots = 16 * kS;
  constexpr int kRing = kRingSteps / kS;  // groups in the ring
  constexpr int kChunk = PlaneTile<BN>::kSlots / kGroupSlots;  // groups
  constexpr int kStride = PlaneTile<BN>::kStride;
  // ring[(group % kRing) * 2 kS + 2 s + h][lane of the block]: 16 bytes
  // of row (h ? l/4 + 8 : l/4), k16 step s; lane-major, so a warp's
  // 16-byte loads are conflict-free.
  __shared__ uint4 ring[kRingSteps * 2][kPlaneThreads];
  __shared__ __align__(16) uint8_t ws[BN * kStride];
  __shared__ typename Adc::Table table;

  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int m0 = blockIdx.x * kPlaneBM + (threadIdx.x >> 5) * 16;
  const int n0 = blockIdx.y * BN;
  const int groups = (K + rows - 1) / rows;
  adc.fill(table);  // visible after the first chunk's barrier

  // Start the copy of group g's x runs into its ring slot.
  auto issue = [&](int g) {
#pragma unroll
    for (int s = 0; s < kS; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + gid + 8 * h;
        const int slot = 16 * s + 4 * tig;
        const int k = g * rows + slot;
        uint4* dst = &ring[(g % kRing) * 2 * kS + 2 * s + h][threadIdx.x];
        const int32_t* src = x + static_cast<size_t>(row) * K + k;
        if (vec) {  // rows % 4 == K % 4 == 0: 4 slots all in or all out
          const bool in = row < M && slot < rows && k < K;
          cp_async_16(dst, in ? src : x, in ? 16 : 0);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool in = row < M && slot + e < rows && k + e < K;
            cp_async_4(reinterpret_cast<uint32_t*>(dst) + e,
                       in ? src + e : x, in ? 4 : 0);
          }
        }
      }
  };

  int pw[kPlanes];
#pragma unroll
  for (int b = 0; b < kPlanes; ++b) pw[b] = Planes::weight(b, weight_bits);

  int acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0;

#pragma unroll
  for (int g = 0; g < kRing - 1; ++g) {
    if (g < groups) issue(g);
    cp_async_commit();
  }
  for (int g = 0; g < groups; ++g) {
    // Refill the slot that group g - 1 left (read a whole group ago),
    // then wait for group g.
    if (g + kRing - 1 < groups) issue(g + kRing - 1);
    cp_async_commit();
    if (g % kChunk == 0) {
      __syncthreads();  // every warp is done with the previous chunk
      stage_plane_weights<BN, kS, Planes>(ws, w, K, N, n0, rows,
                                          weight_bits, wvec, g,
                                          min(kChunk, groups - g));
      __syncthreads();
    }
    cp_async_wait<kRing - 1>();
    uint32_t a[kS][2];
#pragma unroll
    for (int s = 0; s < kS; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        a[s][h] = pack_codes(ring[(g % kRing) * 2 * kS + 2 * s + h]
                                 [threadIdx.x]);
    const uint8_t* wg = ws + gid * kStride + (g % kChunk) * kGroupSlots +
                        4 * tig;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      uint32_t wq[kS];
#pragma unroll
      for (int s = 0; s < kS; ++s)
        wq[s] = *reinterpret_cast<const uint32_t*>(wg + 8 * j * kStride +
                                                   16 * s);
      int d[kPlanes][4];
#pragma unroll
      for (int b = 0; b < kPlanes; ++b) {
#pragma unroll
        for (int i = 0; i < 4; ++i) d[b][i] = 0;
#pragma unroll
        for (int s = 0; s < kS; ++s)
          Planes::mma(d[b], a[s][0], a[s][1], Planes::fragment(wq[s], b));
      }
      if constexpr (Adc::kPacked) {
        // Outputs (2k, 2k+1) in the halves of one register: a pMAC is
        // below 2^13, and a group's sum of weight_b code fits a signed
        // half (the launch checks), so sum = hi 2^16 + lo with lo in
        // [-2^15, 2^15) unpacks once per group.
        uint32_t sum2[2] = {0u, 0u};
#pragma unroll
        for (int b = 0; b < kPlanes; ++b)
#pragma unroll
          for (int k = 0; k < 2; ++k)
            sum2[k] += adc.code2(table, __byte_perm(d[b][2 * k],
                                                    d[b][2 * k + 1], 0x5410)) *
                       static_cast<uint32_t>(pw[b]);
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int hi = static_cast<int>(sum2[k] + 0x8000u) >> 16;
          acc[j][2 * k] +=
              static_cast<int>(sum2[k] - (static_cast<uint32_t>(hi) << 16));
          acc[j][2 * k + 1] += hi;
        }
      } else {
#pragma unroll
        for (int b = 0; b < kPlanes; ++b)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[j][i] += adc.code(table, d[b][i]) * pw[b];
      }
    }
  }
  cp_async_wait<0>();

  const bool pair = (N & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + gid + 8 * h;
    if (row >= M) continue;
    float* orow = out + static_cast<size_t>(row) * N;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int col = n0 + 8 * j + 2 * tig;
      const float v0 = static_cast<float>(acc[j][2 * h]) * scale;
      const float v1 = static_cast<float>(acc[j][2 * h + 1]) * scale;
      if (pair && col + 1 < N) {
        *reinterpret_cast<float2*>(orow + col) = make_float2(v0, v1);
      } else {
        if (col < N) orow[col] = v0;
        if (col + 1 < N) orow[col + 1] = v1;
      }
    }
  }
}

template <int BN, int kS, class Planes, class Adc>
cudaError_t launch_plane_tile(const void* x, const void* w, void* out,
                              int M, int K, int N, int rows,
                              int weight_bits, const Adc& adc, float scale,
                              cudaStream_t stream) {
  const int vec = rows % 4 == 0 && K % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int wvec = rows % 4 == 0 && N % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 4 == 0;
  const dim3 grid((M + kPlaneBM - 1) / kPlaneBM, (N + BN - 1) / BN);
  plane_mma_kernel<BN, kS, Planes, Adc><<<grid, kPlaneThreads, 0, stream>>>(
      static_cast<const int32_t*>(x), static_cast<const uint8_t*>(w),
      static_cast<float*>(out), M, K, N, rows, weight_bits, vec, wvec, adc,
      scale);
  return cudaGetLastError();
}

template <int kS, class Planes, class Adc>
cudaError_t launch_plane_ks(const void* x, const void* w, void* out, int M,
                            int K, int N, int rows, int weight_bits,
                            const Adc& adc, float scale, int bn,
                            cudaStream_t stream) {
  if (bn == 0) bn = N <= 16 ? 16 : N <= 32 ? 32 : 64;
  if (bn == 16)
    return launch_plane_tile<16, kS, Planes>(x, w, out, M, K, N, rows,
                                             weight_bits, adc, scale, stream);
  if (bn == 32)
    return launch_plane_tile<32, kS, Planes>(x, w, out, M, K, N, rows,
                                             weight_bits, adc, scale, stream);
  if (bn == 64)
    return launch_plane_tile<64, kS, Planes>(x, w, out, M, K, N, rows,
                                             weight_bits, adc, scale, stream);
  return cudaErrorInvalidValue;
}

// Launch plane_mma_kernel at column tile `bn` (16, 32 or 64; 0: the BN
// that covers N, up to 64; wider layers take several column tiles) and the
// k16 steps a group takes (rows <= 32).
template <class Planes, class Adc>
cudaError_t launch_plane_gpq(const void* x, const void* w, void* out, int M,
                             int K, int N, int rows, int weight_bits,
                             const Adc& adc, float scale, int bn,
                             cudaStream_t stream) {
  if (rows <= 16)
    return launch_plane_ks<1, Planes>(x, w, out, M, K, N, rows, weight_bits,
                                      adc, scale, bn, stream);
  if (rows <= 32)
    return launch_plane_ks<2, Planes>(x, w, out, M, K, N, rows, weight_bits,
                                      adc, scale, bn, stream);
  return cudaErrorInvalidValue;
}

}  // namespace gpq
