// Helpers of the one-warp-per-chunk rank walks (K2, K6).
//
// The 256-entry MTF list of a chunk lives in the 32 lanes of its warp:
// lane l holds entries 8l .. 8l+7 in two uint32 words, lo (entries 8l ..
// 8l+3, entry 8l in the low byte) and hi (8l+4 .. 8l+7).  A shift of a
// prefix of the list by one entry is then a byte shift of each lane's
// words, the byte that crosses a lane boundary taken by one shuffle, and a
// byte mask that keeps the entries past the prefix.
#pragma once

#include "common.cuh"

constexpr unsigned kFullMask = 0xFFFFFFFFu;

// Masks of the low `t` bytes of a lane's 8 entries (t clamped to [0, 8]),
// as the masks of its lo and hi words.
__device__ __forceinline__ void jt_byte_masks(int t, uint32_t& mlo,
                                              uint32_t& mhi) {
  t = jt_clamp(t, 0, 8);
  // (0 : ~0) << min(shift, 32), upper word: the low shift / 8 bytes set
  mlo = __funnelshift_lc(0xFFFFFFFFu, 0u, 8 * t);
  mhi = __funnelshift_lc(0xFFFFFFFFu, 0u, max(8 * t - 32, 0));
}

__device__ __forceinline__ uint32_t jt_pick(uint32_t a, uint32_t b,
                                            uint32_t mask_a) {
  return (a & mask_a) | (b & ~mask_a);
}

template <typename T>
__device__ __forceinline__ T jt_warp_sum(T v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFullMask, v, d);
  return v;
}

// n bytes from src to dst by the lanes of one warp: 16 bytes a lane and
// step where both pointers are 16-byte aligned, the tail byte by byte.
__device__ __forceinline__ void jt_warp_copy(uint8_t* dst, const uint8_t* src,
                                             int64_t n, int lane) {
  int64_t head = 0;
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) &
       15) == 0) {
    head = n & ~int64_t(15);
    for (int64_t i = 16 * int64_t(lane); i < head; i += 512)
      *reinterpret_cast<uint4*>(dst + i) =
          *reinterpret_cast<const uint4*>(src + i);
  }
  for (int64_t i = head + lane; i < n; i += 32) dst[i] = src[i];
}

// n zero bytes at dst by the lanes of one warp.
__device__ __forceinline__ void jt_warp_zero(uint8_t* dst, int64_t n,
                                             int lane) {
  // bytes up to the first 16-byte aligned address, then 16 a lane and
  // step, then the tail
  const int64_t pre = min(
      n, int64_t((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15));
  if (lane < pre) dst[lane] = 0;
  const int64_t head = pre + ((n - pre) & ~int64_t(15));
  for (int64_t i = pre + 16 * int64_t(lane); i < head; i += 512)
    *reinterpret_cast<uint4*>(dst + i) = make_uint4(0, 0, 0, 0);
  for (int64_t i = head + lane; i < n; i += 32) dst[i] = 0;
}

inline size_t jt_align16(int64_t n) { return size_t((n + 15) & ~int64_t(15)); }
