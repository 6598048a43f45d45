// K6: SRC rank encode, setup and walk in one launch.
//
// Replaces the lax.fori_loop of jampack_tpu/kernels/encode_stages.py::
// rank_encode_core (all chunks in lockstep, a step-major slab of packed
// (bucket position << 8 | rank) records and one final per-chunk sort that
// puts the ranks in bucket order); reference: rank.cpp:15-90.
//
// What bounds it here: each chunk is a serial MTF walk of up to a chunk's
// length in steps (16,384 for the production stream); a step searches the
// MTF list for the byte and shifts `rank` entries.  The walk is latency
// bound; the chunk is read twice and each rank written once.
//
// Design: one thread per chunk.  The 256 frequency counts, the 256 bucket
// cursors and the 256-byte MTF list live in dynamic shared memory laid out
// [entry][thread].  Setup: a count pass that also builds the MTF list in
// first-appearance order; bucket bases in descending frequency, ties to
// the lowest symbol (each symbol's base is the sum of the counts ranked
// before it).  Walk: each byte's MTF rank is written straight to its
// bucket cursor, which the TPU path avoided only because scatters are slow
// there.  Cursors are int32, so a chunk may exceed 0x7FFF bytes.
#include "common.cuh"

namespace {

constexpr int kThreads = 32;  // chunks per block
constexpr size_t kSmemBytes =
    size_t(kThreads) * 256 * (2 * sizeof(int32_t) + sizeof(uint8_t));

__global__ void __launch_bounds__(kThreads) rank_encode_kernel(
    const uint8_t* __restrict__ chunks, int64_t width,
    const int32_t* __restrict__ olens, int num_chunks,
    uint8_t* __restrict__ ranks, int32_t* __restrict__ freqs) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* cnt = reinterpret_cast<int32_t*>(smem);
  int32_t* bkt = cnt + 256 * kThreads;
  uint8_t* r2s = reinterpret_cast<uint8_t*>(bkt + 256 * kThreads);

  const int t = threadIdx.x;
  const int c = blockIdx.x * kThreads + t;
  if (c >= num_chunks) return;

#define CNT(k) cnt[(k) * kThreads + t]
#define BKT(k) bkt[(k) * kThreads + t]
#define R2S(k) r2s[(k) * kThreads + t]

  const uint8_t* in = chunks + int64_t(c) * width;
  uint8_t* out = ranks + int64_t(c) * width;
  const int64_t ol = olens[c];
  const int64_t n = ol <= 0 ? 0 : (ol < width ? ol : width);

  // ---- setup: counts and first-appearance MTF order (rank.cpp:45-51)
  for (int s = 0; s < 256; ++s) CNT(s) = 0;
  int unique = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int s = in[i];
    if (CNT(s) == 0) R2S(unique++) = static_cast<uint8_t>(s);
    CNT(s) += 1;
  }
  // symbols that never appear follow in ascending order; no walk reaches
  // them (a seen symbol's rank is always below the unique count)
  for (int s = 0, u = unique; s < 256; ++s)
    if (CNT(s) == 0) R2S(u++) = static_cast<uint8_t>(s);
  int32_t* f = freqs + int64_t(c) * 256;
  for (int s = 0; s < 256; ++s) f[s] = CNT(s);
  // bucket bases (rank.cpp:15-39, 54-58): descending frequency, ties to
  // the lowest symbol
  for (int s = 0; s < 256; ++s) {
    const int fs = CNT(s);
    int32_t base = 0;
    for (int u = 0; u < 256; ++u) {
      const int fu = CNT(u);
      if (fu > fs || (fu == fs && u < s)) base += fu;
    }
    BKT(s) = base;
  }

  // ---- walk (rank.cpp:60-76): rank = position in the MTF list
  for (int64_t i = 0; i < n; ++i) {
    const int s = in[i];
    int rank = 0;
    while (R2S(rank) != s) ++rank;
    out[BKT(s)] = static_cast<uint8_t>(rank);
    BKT(s) += 1;
    for (int k = rank; k > 0; --k) R2S(k) = R2S(k - 1);
    R2S(0) = static_cast<uint8_t>(s);
  }
  for (int64_t i = n; i < width; ++i) out[i] = 0;
#undef CNT
#undef BKT
#undef R2S
}

}  // namespace

// chunks, ranks: (num_chunks, width) uint8; olens: (num_chunks,) int32;
// freqs: (num_chunks, 256) int32.
JT_EXPORT int jt_rank_encode(const void* chunks, int64_t width,
                             const void* olens, int num_chunks, void* ranks,
                             void* freqs, void* stream) {
  if (num_chunks <= 0) return 0;
  cudaError_t err = jt_allow_smem(rank_encode_kernel, kSmemBytes);
  if (err != cudaSuccess) return err;
  const int blocks = (num_chunks + kThreads - 1) / kThreads;
  rank_encode_kernel<<<blocks, kThreads, kSmemBytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(chunks), width,
      static_cast<const int32_t*>(olens), num_chunks,
      static_cast<uint8_t*>(ranks), static_cast<int32_t*>(freqs));
  return cudaGetLastError();
}
