// K2: SRC rank decode, setup and walk in one launch, one warp per chunk.
//
// Replaces jampack_tpu/kernels/rank_pallas.py::_rank_step_kernel (one
// lockstep step per pallas_call, driven by rank_decode_pallas) and the XLA
// loop it mirrors, device_stages.rank_decode_core with its setup
// rank_setup_core (reference: rank.cpp:96-151; native/src/jn_ans.cpp
// rank_decode).
//
// What bounds it here: each chunk is a serial MTF walk of up to a chunk's
// length in steps (16,384 for the production stream).  A step's chain is
// the bucket cursor of the current symbol (a shared-memory read), the rank
// under it (another), the decision and the next symbol: ~100-150 cycles.
// One thread per chunk (the first design) shifted `rank` list entries one
// by one, waited for the largest rank of 32 diverging chunks and read the
// rank from device memory on the chain: ~1,200 cycles a step.
//
// Design: one warp per chunk, up to four chunks a block.  The MTF list
// lives across the warp's lanes (warp_list.cuh), so a step costs the same
// few warp instructions whatever the rank: an insert at `rank` (entries
// [1, rank] move to [0, rank), the symbol goes to `rank`) and a retire (a
// do-while shift of max(1, unique) entries) are both a shift down of a
// prefix, the crossing byte from lane l+1 by __shfl_down_sync.  The next
// symbol is entry 1 from before the update when the list changed, else the
// current one; lane 0 broadcasts entry 1 after each step, a step ahead of
// its use, so no shuffle is on the chain.  The chunk's rank row is staged
// in shared memory beside the cursor and end of each of the 256 symbols
// (two int32 arrays, not the TPU kernel's packed cur | end << 16 word, so a
// chunk may be longer than 0x7FFF bytes); a row wider than kStageMax is
// read in place from device memory (the direct path, a template parameter
// picked from the width).  Decoded bytes wait in the lanes' registers, one
// a lane, and go out 32 at a time.  Setup is spread over the lanes: each
// owns 8 symbols and ranks them against the 256 (descending frequency,
// ties to the lowest symbol), which gives each its place in that order
// and its bucket base at once; the list seed takes, for each rank value,
// the symbol of the last bucket in that order whose first rank names it
// (atomicMax of the place).  In the walk every lane makes the same
// shared-memory reads and writes, so no lane reads another lane's write.
#include <algorithm>

#include "warp_list.cuh"

namespace {

constexpr int kWarps = 4;             // chunks per block
constexpr int kStageMax = 48 << 10;   // widest rank row staged in shared memory
// per warp: freqs, cursor, end, last place (int32), order, list seed (uint8)
constexpr size_t kFixed = 4 * 256 * sizeof(int32_t) + 2 * 256;

template <bool kStaged>
__global__ void __launch_bounds__(kWarps * 32) rank_decode_kernel(
    const uint8_t* __restrict__ ranks, int ranks_w,
    const int32_t* __restrict__ freqs, const int32_t* __restrict__ olens,
    int num_chunks, int out_cap, uint8_t* __restrict__ out,
    uint8_t* __restrict__ ok, size_t warp_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * (blockDim.x >> 5) + warp;
  if (c >= num_chunks) return;

  int32_t* fr = reinterpret_cast<int32_t*>(smem + warp * warp_bytes);
  int32_t* cur = fr + 256;
  int32_t* end = cur + 256;
  int32_t* last = end + 256;
  uint8_t* ord = reinterpret_cast<uint8_t*>(last + 256);
  uint8_t* r2s = ord + 256;
  const uint8_t* row = ranks + int64_t(c) * ranks_w;
  const uint8_t* rk = row;
  if (kStaged) {
    uint8_t* staged = r2s + 256;
    jt_warp_copy(staged, row, ranks_w, lane);
    rk = staged;
  }

  // ---- setup (rank.cpp:96-123)
  const int32_t* f = freqs + int64_t(c) * 256;
  for (int s = lane; s < 256; s += 32) {
    fr[s] = f[s];
    last[s] = -1;
  }
  __syncwarp();
  int fs[8], place[8];
  uint32_t base[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    fs[k] = fr[8 * lane + k];
    place[k] = 0;
    base[k] = 0;
  }
  for (int u = 0; u < 256; ++u) {
    const int fu = fr[u];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const bool before = fu > fs[k] || (fu == fs[k] && u < 8 * lane + k);
      place[k] += before;
      base[k] += before ? uint32_t(fu) : 0u;
    }
  }
  uint32_t total = 0;
  int unique = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int s = 8 * lane + k;
    total += uint32_t(fs[k]);
    unique += fs[k] > 0;
    ord[place[k]] = static_cast<uint8_t>(s);
    cur[s] = fs[k] > 0 ? int32_t(base[k] + 1) : 0;
    end[s] = fs[k] > 0 ? int32_t(base[k] + uint32_t(fs[k])) : 0;
  }
  total = jt_warp_sum(total);
  unique = jt_warp_sum(unique);
  __syncwarp();
  // the first rank of each bucket seeds the list; later buckets win
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (fs[k] > 0)
      atomicMax(&last[rk[jt_clamp<int>(int32_t(base[k]), 0, ranks_w - 1)]],
                place[k]);
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int j = last[8 * lane + k];
    r2s[8 * lane + k] = j >= 0 ? ord[j] : 0;
  }
  __syncwarp();
  const uint2 words = *reinterpret_cast<const uint2*>(r2s + 8 * lane);
  uint32_t lo = words.x, hi = words.y;
  uint32_t sym = r2s[0], e1 = r2s[1];

  // ---- walk (rank.cpp:125-150)
  const int ol = olens[c];
  const int steps = ol <= 0 ? 0 : min(ol, out_cap);
  uint8_t* o = out + int64_t(c) * out_cap;
  uint32_t mine = 0;  // lane j keeps the byte of step g + j
  for (int g = 0; g < steps; g += 32) {
    const int n = min(32, steps - g);
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      if (lane == j) mine = sym;
      const int cu = cur[sym];
      const bool has = cu < end[sym];
      const int rank = rk[jt_clamp(cu, 0, ranks_w - 1)];
      if (has) cur[sym] = cu + 1;
      const bool insert = has && rank > 0;
      const bool retire = !has && unique > 0;
      unique -= retire;
      // entries [0, shift) take the entry after them; on an insert, entry
      // `rank` takes the symbol
      const int shift = insert ? rank : (retire ? max(1, unique) : 0);
      uint32_t m1lo, m1hi, m2lo, m2hi;
      jt_byte_masks(shift - 8 * lane, m1lo, m1hi);
      jt_byte_masks(shift + insert - 8 * lane, m2lo, m2hi);
      const uint32_t from_next = __shfl_down_sync(kFullMask, lo & 0xFFu, 1);
      const uint32_t dlo = __funnelshift_r(lo, hi, 8);
      const uint32_t dhi = (hi >> 8) | (from_next << 24);
      const uint32_t sx4 = sym * 0x01010101u;
      lo = jt_pick(dlo, jt_pick(sx4, lo, m2lo), m1lo);
      hi = jt_pick(dhi, jt_pick(sx4, hi, m2hi), m1hi);
      if (insert || retire) sym = e1;
      e1 = (__shfl_sync(kFullMask, lo, 0) >> 8) & 0xFFu;
    }
    if (n == 32) o[g + lane] = static_cast<uint8_t>(mine);
  }
  // the last partial group, then zeros up to out_cap
  for (int p = (steps & ~31) + lane; p < out_cap; p += 32)
    o[p] = p < steps ? static_cast<uint8_t>(mine) : 0;
  if (lane == 0) ok[c] = (int32_t(total) == max(ol, 0)) || (ol <= 0);
}

}  // namespace

// 1 when K2 stages rank rows of this width in shared memory, 0 when it
// reads them in place (the direct path).
JT_EXPORT int jt_rank_decode_staged(int ranks_w) {
  return ranks_w <= kStageMax;
}

// ranks: (num_chunks, ranks_w) uint8; freqs: (num_chunks, 256) int32;
// olens: (num_chunks,) int32; out: (num_chunks, out_cap) uint8; ok: uint8.
JT_EXPORT int jt_rank_decode(const void* ranks, int ranks_w, const void* freqs,
                             const void* olens, int num_chunks, int out_cap,
                             void* out, void* ok, void* stream) {
  if (num_chunks <= 0) return 0;
  const bool staged = jt_rank_decode_staged(ranks_w);
  const size_t warp_bytes = kFixed + (staged ? jt_align16(ranks_w) : 0);
  const int warps = std::min(kWarps, num_chunks);
  const size_t bytes = warp_bytes * warps;
  auto kernel = staged ? rank_decode_kernel<true> : rank_decode_kernel<false>;
  cudaError_t err = jt_allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const int blocks = (num_chunks + warps - 1) / warps;
  kernel<<<blocks, warps * 32, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(ranks), ranks_w,
      static_cast<const int32_t*>(freqs), static_cast<const int32_t*>(olens),
      num_chunks, out_cap, static_cast<uint8_t*>(out),
      static_cast<uint8_t*>(ok), warp_bytes);
  return cudaGetLastError();
}
