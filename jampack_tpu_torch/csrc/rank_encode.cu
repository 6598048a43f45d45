// K6: SRC rank encode, setup and walk in one launch, one warp per chunk.
//
// Replaces the lax.fori_loop of jampack_tpu/kernels/encode_stages.py::
// rank_encode_core (all chunks in lockstep, a step-major slab of packed
// (bucket position << 8 | rank) records and one final per-chunk sort that
// puts the ranks in bucket order); reference: rank.cpp:15-90.
//
// What bounds it here: each chunk is a serial MTF walk of up to a chunk's
// length in steps (16,384 for the production stream).  A step's chain is
// the search of the list for the byte, the rank it gives and the list
// update: ~100-150 cycles.  One thread per chunk (the first design)
// searched and shifted the list entry by entry, ~2 x rank dependent
// shared-memory accesses, and waited for the largest rank of 32 diverging
// chunks: ~3,000 cycles a step.
//
// Design: one warp per chunk, up to four chunks a block.  The MTF list
// lives across the warp's lanes (warp_list.cuh).  The search: each lane
// compares its 8 entries with the byte (__vcmpeq4 on each word), and four
// ballots give the one lane that matches and the three bits of the byte's
// place in it, so rank = 8 * lane + place.  The update: entries [0, rank)
// move to [1, rank] and entry 0 takes the byte, each lane shifting its
// words up a byte and taking the crossing byte from lane l-1 by
// __shfl_up_sync.  The input does not depend on the list, so it is read
// ahead: lane j loads byte g + 32 + j while the warp walks bytes g .. g+31,
// each handed out by one shuffle.  Each rank goes to its bucket cursor in
// a row staged in shared memory, written back with 16-byte stores; a row
// wider than kStageMax is written in place in device memory (the direct
// path, a template parameter picked from the width).  Cursors are int32,
// so a chunk may exceed 0x7FFF bytes.  Setup is spread over the lanes:
// counts and first appearances by one shared-memory atomic per distinct
// byte of each 32 (__match_any_sync), then each lane ranks its 8 symbols
// against the 256, for their places in first-appearance order (unseen
// symbols after, ascending) and their bucket bases (descending frequency,
// ties to the lowest symbol).  In the walk every lane makes the same
// shared-memory reads and writes, so no lane reads another lane's write.
#include <algorithm>

#include "warp_list.cuh"

namespace {

constexpr int kWarps = 4;             // chunks per block
constexpr int kStageMax = 48 << 10;   // widest rank row staged in shared memory
constexpr int32_t kUnseen = 1 << 30;  // first-appearance key of an unseen symbol
// per warp: counts, first appearances, bucket cursors (int32), the list
constexpr size_t kFixed = 3 * 256 * sizeof(int32_t) + 256;

template <bool kStaged>
__global__ void __launch_bounds__(kWarps * 32) rank_encode_kernel(
    const uint8_t* __restrict__ chunks, int64_t width,
    const int32_t* __restrict__ olens, int num_chunks,
    uint8_t* __restrict__ ranks, int32_t* __restrict__ freqs,
    size_t warp_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * (blockDim.x >> 5) + warp;
  if (c >= num_chunks) return;

  int32_t* cnt = reinterpret_cast<int32_t*>(smem + warp * warp_bytes);
  int32_t* first = cnt + 256;
  int32_t* bkt = first + 256;
  uint8_t* r2s = reinterpret_cast<uint8_t*>(bkt + 256);
  const uint8_t* in = chunks + int64_t(c) * width;
  uint8_t* row = ranks + int64_t(c) * width;
  uint8_t* out = kStaged ? r2s + 256 : row;
  const int64_t ol = olens[c];
  const int64_t n = ol <= 0 ? 0 : (ol < width ? ol : width);

  // ---- setup: counts and first appearances (rank.cpp:45-51)
  for (int s = lane; s < 256; s += 32) {
    cnt[s] = 0;
    first[s] = kUnseen + s;
  }
  jt_warp_zero(row + n, width - n, lane);
  __syncwarp();
  for (int64_t g = 0; g < n; g += 32) {
    const int64_t i = g + lane;
    const int s = i < n ? in[i] : 256 + lane;
    const unsigned peers = __match_any_sync(kFullMask, s);
    if (s < 256 && __ffs(peers) - 1 == lane) {
      atomicAdd(&cnt[s], __popc(peers));
      atomicMin(&first[s], int32_t(i));
    }
  }
  __syncwarp();
  // each lane's 8 symbols: the place in first-appearance order and the
  // bucket base (rank.cpp:15-39, 54-58)
  int fs[8], key[8], place[8], base[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    fs[k] = cnt[8 * lane + k];
    key[k] = first[8 * lane + k];
    place[k] = 0;
    base[k] = 0;
  }
  for (int u = 0; u < 256; ++u) {
    const int fu = cnt[u], ku = first[u];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      place[k] += ku < key[k];
      if (fu > fs[k] || (fu == fs[k] && u < 8 * lane + k)) base[k] += fu;
    }
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    r2s[place[k]] = static_cast<uint8_t>(8 * lane + k);
    bkt[8 * lane + k] = base[k];
  }
  int32_t* f = freqs + int64_t(c) * 256;
  for (int s = lane; s < 256; s += 32) f[s] = cnt[s];
  __syncwarp();
  const uint2 words = *reinterpret_cast<const uint2*>(r2s + 8 * lane);
  uint32_t lo = words.x, hi = words.y;

  // ---- walk (rank.cpp:60-76): rank = place of the byte in the list
  uint32_t next = lane < n ? in[lane] : 0;
  for (int64_t g = 0; g < n; g += 32) {
    const uint32_t group = next;
    if (g + 32 + lane < n) next = in[g + 32 + lane];
    const int m = int(n - g < 32 ? n - g : 32);
#pragma unroll 4
    for (int j = 0; j < m; ++j) {
      const uint32_t s = __shfl_sync(kFullMask, group, j);
      const uint32_t sx4 = s * 0x01010101u;
      const uint32_t eqlo = __vcmpeq4(lo, sx4), eqhi = __vcmpeq4(hi, sx4);
      const bool here = (eqlo | eqhi) != 0;
      const int at = eqlo ? (__ffs(eqlo) - 1) >> 3 : 4 + ((__ffs(eqhi) - 1) >> 3);
      const unsigned who = __ballot_sync(kFullMask, here);
      const unsigned b0 = __ballot_sync(kFullMask, here && (at & 1));
      const unsigned b1 = __ballot_sync(kFullMask, here && (at & 2));
      const unsigned b2 = __ballot_sync(kFullMask, here && (at & 4));
      const int rank = 8 * (__ffs(who) - 1) + (b0 != 0) + 2 * (b1 != 0) +
                       4 * (b2 != 0);
      const int32_t b = bkt[s];
      bkt[s] = b + 1;
      out[b] = static_cast<uint8_t>(rank);
      // entries [0, rank) move up one, entry 0 takes the byte
      const uint32_t from_prev = __shfl_up_sync(kFullMask, hi >> 24, 1);
      const uint32_t ulo = (lo << 8) | (lane == 0 ? s : from_prev);
      const uint32_t uhi = __funnelshift_l(lo, hi, 8);
      uint32_t mlo, mhi;
      jt_byte_masks(rank + 1 - 8 * lane, mlo, mhi);
      lo = jt_pick(ulo, lo, mlo);
      hi = jt_pick(uhi, hi, mhi);
    }
  }
  if (kStaged) {
    __syncwarp();
    jt_warp_copy(row, out, n, lane);
  }
}

}  // namespace

// 1 when K6 stages rank rows of this width in shared memory, 0 when it
// writes them in place (the direct path).
JT_EXPORT int jt_rank_encode_staged(int64_t width) {
  return width <= kStageMax;
}

// chunks, ranks: (num_chunks, width) uint8; olens: (num_chunks,) int32;
// freqs: (num_chunks, 256) int32.  width < 2^30.
JT_EXPORT int jt_rank_encode(const void* chunks, int64_t width,
                             const void* olens, int num_chunks, void* ranks,
                             void* freqs, void* stream) {
  if (num_chunks <= 0) return 0;
  if (width >= kUnseen) return cudaErrorInvalidValue;
  const bool staged = jt_rank_encode_staged(width);
  const size_t warp_bytes = kFixed + (staged ? jt_align16(width) : 0);
  const int warps = std::min(kWarps, num_chunks);
  const size_t bytes = warp_bytes * warps;
  auto kernel = staged ? rank_encode_kernel<true> : rank_encode_kernel<false>;
  cudaError_t err = jt_allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const int blocks = (num_chunks + warps - 1) / warps;
  kernel<<<blocks, warps * 32, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(chunks), width,
      static_cast<const int32_t*>(olens), num_chunks,
      static_cast<uint8_t*>(ranks), static_cast<int32_t*>(freqs), warp_bytes);
  return cudaGetLastError();
}
