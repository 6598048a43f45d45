// K5: the reverse 4-state rANS emission of every chain, one launch.
//
// Replaces the lax.fori_loop of jampack_tpu/kernels/rans_encode.py::
// rans_reverse_encode_wide (all chains in lockstep over a common descending
// op index, then one per-chain packed sort that turns the dense step
// records into the backward byte buffer); reference: ans.cpp:189-208,
// rans_byte.hpp:83-110.
//
// What bounds it here: each chain is a serial walk of 2 * rlen dependent
// ops (one uint32 division each), so the walk is latency bound; the pairs
// are read once and each payload byte written once.
//
// Design: one thread per chain walks ops 2*rlen-1 .. 0 and writes its
// renorm bytes straight into its own row, back to front, so no record
// buffer and no sort are needed.  Integer rules kept exactly: uint32 state,
// x_max = ((2^23 >> 16) << 8) * fq in uint32, fq = max(freq, 1), at most
// two emissions per op, truncating / and %; the flush writes R3..R0
// little-endian (R3's most significant byte emitted first).  The payload
// is row[ptr:], ptr = size - emitted - 16; bytes before ptr are zero.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr uint32_t kRansL = 1u << 23;

__global__ void __launch_bounds__(kThreads) rans_encode_kernel(
    const uint16_t* __restrict__ lows, const uint16_t* __restrict__ fqs,
    const int32_t* __restrict__ rlens, int num_chains, int max_rlen,
    uint8_t* __restrict__ bufs, int32_t* __restrict__ ptrs) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= num_chains) return;
  const int64_t ncap = 2 * int64_t(max_rlen);
  const int64_t size = 2 * ncap + 16;
  const int64_t nops = jt_clamp<int64_t>(2 * int64_t(rlens[c]), 0, ncap);
  const uint16_t* lo_in = lows + c * ncap;
  const uint16_t* fq_in = fqs + c * ncap;
  uint8_t* row = bufs + c * size;

  uint32_t R[4] = {kRansL, kRansL, kRansL, kRansL};
  int64_t pos = size;
  for (int64_t i = nops - 1; i >= 0; --i) {
    const uint32_t fq = max(uint32_t(fq_in[i]), 1u);
    const uint32_t lo = lo_in[i];
    uint32_t x = R[3];
    const uint32_t x_max = ((kRansL >> 16) << 8) * fq;
    if (x >= x_max) {
      row[--pos] = static_cast<uint8_t>(x & 0xFF);
      x >>= 8;
    }
    if (x >= x_max) {
      row[--pos] = static_cast<uint8_t>(x & 0xFF);
      x >>= 8;
    }
    x = ((x / fq) << 16) + (x % fq) + lo;
    R[3] = R[2]; R[2] = R[1]; R[1] = R[0]; R[0] = x;
  }
  for (int j = 3; j >= 0; --j)
    for (int b = 3; b >= 0; --b) row[--pos] = static_cast<uint8_t>(R[j] >> (8 * b));
  ptrs[c] = static_cast<int32_t>(pos);
  for (int64_t k = 0; k < pos; ++k) row[k] = 0;
}

}  // namespace

// lows, fqs: (num_chains, 2 * max_rlen) uint16; rlens: (num_chains,) int32;
// bufs: (num_chains, 4 * max_rlen + 16) uint8; ptrs: (num_chains,) int32.
JT_EXPORT int jt_rans_encode(const void* lows, const void* fqs,
                             const void* rlens, int num_chains, int max_rlen,
                             void* bufs, void* ptrs, void* stream) {
  if (num_chains <= 0) return 0;
  const int blocks = (num_chains + kThreads - 1) / kThreads;
  rans_encode_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(lows), static_cast<const uint16_t*>(fqs),
      static_cast<const int32_t*>(rlens), num_chains, max_rlen,
      static_cast<uint8_t*>(bufs), static_cast<int32_t*>(ptrs));
  return cudaGetLastError();
}
