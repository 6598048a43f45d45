// K5: the reverse 4-state rANS emission of every chain, one launch.
//
// Replaces the lax.fori_loop of jampack_tpu/kernels/rans_encode.py::
// rans_reverse_encode_wide (all chains in lockstep over a common descending
// op index, then one per-chain packed sort that turns the dense step
// records into the backward byte buffer); reference: ans.cpp:189-208,
// rans_byte.hpp:83-110.
//
// Integer rules, kept exactly: uint32 state, x_max = ((2^23 >> 16) << 8) *
// fq in uint32, fq = max(freq, 1), at most two emissions per op, truncating
// / and %; the flush writes R3..R0 little-endian (R3's most significant
// byte emitted first).  The payload is row[ptr:], ptr = size - emitted - 16;
// bytes before ptr are zero.
//
// What bounds it here: the ops of a chain are walked back to front through
// four rotating states; op i reads R[3] and pushes its result into R[0],
// so op i and op i - 4 share a state.  Each state is a serial walk of
// nops / 4 dependent ops (a renorm, a division and a multiply-add), so the
// walk is latency bound; the pairs are read once and each byte written
// once.  Only the byte addresses couple the four states, and an address is
// a prefix sum of the emission counts (0, 1 or 2 an op).
//
// Design: G lanes a chain, 32 / G chains a warp (G = kLanes on the path;
// the measuring entry jt_rans_encode_at takes 8, 16 or 32).  A chain's
// lanes take its ops in processing order (j = 0 is the chain's last op,
// i = nops - 1 - j) in tiles of 8 G:
//   1. stage: the lanes write the tile's (low, fq) and the reciprocal of fq
//      to shared memory (the tile's pairs were loaded into registers, 2
//      adjacent bytes a lane, while the lanes walked the tile before, so no
//      global read waits);
//   2. walk: lane s < 4 of the chain walks state s through the tile's ops
//      j = s mod 4, and writes each op's emission count and two bytes to
//      shared memory; the division is a multiply by the staged reciprocal
//      and one correction (divmod below), with no hardware divide on the
//      path;
//   3. place: each lane takes 8 consecutive ops, a prefix scan of their
//      counts over the chain's lanes gives every byte its place, the bytes
//      are gathered in emission order and the lanes write them down the
//      row, G adjacent bytes a store.
// Then the 16 flush bytes, ptr, and the zeros of row[:ptr], 4 bytes a
// lane a store.  No record buffer and no sort.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;   // warps a block
// lanes a chain on the path, 2 chains a warp: the fastest of 8, 16 and 32
// in chip_smoke.py's sweep (PERF.md)
constexpr int kLanes = 16;
constexpr int kPer = 8;     // ops a lane stages and places a tile
constexpr uint32_t kRansL = 1u << 23;
constexpr unsigned kFull = 0xFFFFFFFFu;

// The reciprocal of divmod: inv = floor((2^32 - 1) / fq), fq in 1..65535.
__device__ __forceinline__ uint32_t recip(uint32_t fq) {
  return 0xFFFFFFFFu / fq;
}

// q = x / fq and r = x % fq, exact for every uint32 x and fq in 1..65535.
// inv = floor((2^32 - 1) / fq) >= (2^32 - fq) / fq = 2^32 / fq - 1 and
// inv < 2^32 / fq, so x * inv / 2^32 lies in (x / fq - 1, x / fq]: the
// estimate floor(x * inv / 2^32) is q or q - 1, its remainder is below
// 2 * fq, and one step corrects it.
__device__ __forceinline__ uint32_t divmod(uint32_t x, uint32_t fq,
                                           uint32_t inv, uint32_t& r) {
  uint32_t q = __umulhi(x, inv);
  r = x - q * fq;
  if (r >= fq) {
    ++q;
    r -= fq;
  }
  return q;
}

template <int T>  // ops a tile
struct ChainTile {
  uint32_t op[T];   // low | fq << 16, fq = max(freq, 1)
  uint32_t inv[T];  // recip(fq)
  uint32_t rec[T];  // emission count | first byte << 8 | second << 16
  uint8_t out[2 * T];  // the tile's bytes in emission order
};

// G lanes a chain, 32 / G chains a warp, tiles of 8 G ops.
template <int G>
__global__ void __launch_bounds__(kWarps * 32) rans_encode_kernel(
    const uint16_t* __restrict__ lows, const uint16_t* __restrict__ fqs,
    const int32_t* __restrict__ rlens, int num_chains, int max_rlen,
    uint8_t* __restrict__ bufs, int32_t* __restrict__ ptrs) {
  constexpr int kTile = kPer * G;
  __shared__ __align__(16) ChainTile<kTile> tiles[kWarps * 32 / G];
  const int gl = threadIdx.x % G;  // lane within the chain's group
  const int first = blockIdx.x * (kWarps * 32 / G);
  if (first + (threadIdx.x >> 5) * (32 / G) >= num_chains) return;  // the warp
  ChainTile<kTile>& sm = tiles[threadIdx.x / G];
  const int c = first + threadIdx.x / G;
  const bool live = c < num_chains;
  const int64_t ncap = 2 * int64_t(max_rlen);
  const int64_t size = 2 * ncap + 16;
  const int nops =
      live ? int(jt_clamp<int64_t>(2 * int64_t(rlens[c]), 0, ncap)) : 0;
  const int steps = __reduce_max_sync(kFull, nops);  // the warp's longest
  const uint16_t* lo_in = lows + c * ncap;
  const uint16_t* fq_in = fqs + c * ncap;
  uint8_t* row = bufs + c * size;

  // this tile's pairs, slot gl + G t, loaded a tile ahead
  uint32_t pl[kPer] = {}, pf[kPer] = {};
  auto fetch = [&](int j0) {
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int j = j0 + gl + G * t;
      if (j < nops) {
        pl[t] = lo_in[nops - 1 - j];
        pf[t] = fq_in[nops - 1 - j];
      }
    }
  };
  fetch(0);

  uint32_t x = kRansL;  // lane gl < 4: state gl, the ops j = gl mod 4
  int64_t pos = size;
  for (int j0 = 0; j0 < steps; j0 += kTile) {
    const int n = max(0, min(kTile, nops - j0));
    // 1. stage
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int k = gl + G * t;
      if (k < n) {
        const uint32_t fq = max(pf[t], 1u);
        sm.op[k] = pl[t] | fq << 16;
        sm.inv[k] = recip(fq);
      }
    }
    __syncwarp();
    fetch(j0 + kTile);
    // 2. walk
    if (gl < 4) {
#pragma unroll 4
      for (int k = gl; k < n; k += 4) {
        const uint32_t p = sm.op[k], inv = sm.inv[k];
        const uint32_t fq = p >> 16;
        const uint32_t x_max = fq << 15;  // ((2^23 >> 16) << 8) * fq
        const uint32_t bytes = x & 0xFFFFu;
        uint32_t cnt = 0;
        if (x >= x_max) {
          x >>= 8;
          ++cnt;
        }
        if (x >= x_max) {
          x >>= 8;
          ++cnt;
        }
        uint32_t r;
        const uint32_t q = divmod(x, fq, inv, r);
        x = (q << 16) + r + (p & 0xFFFFu);
        sm.rec[k] = cnt | bytes << 8;
      }
    }
    __syncwarp();
    // 3. place: emission e of the tile goes to row[pos - 1 - e]
    uint32_t rc[kPer];
    uint32_t own = 0;
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int k = kPer * gl + t;
      rc[t] = k < n ? sm.rec[k] : 0u;
      own += rc[t] & 3u;
    }
    uint32_t incl = own;
#pragma unroll
    for (int d = 1; d < G; d <<= 1) {
      const uint32_t v = __shfl_up_sync(kFull, incl, d, G);
      incl += gl >= d ? v : 0u;
    }
    const int tot = int(__shfl_sync(kFull, incl, G - 1, G));
    uint32_t e = incl - own;
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const uint32_t cnt = rc[t] & 3u;
      if (cnt > 0) sm.out[e] = uint8_t(rc[t] >> 8);
      if (cnt > 1) sm.out[e + 1] = uint8_t(rc[t] >> 16);
      e += cnt;
    }
    __syncwarp();
    for (int k = gl; k < tot; k += G) row[pos - 1 - k] = sm.out[k];
    pos -= tot;
    __syncwarp();
  }

  // 4. flush: R[q] is the state of op j = nops - 1 - q (the last op pushed
  // into R[0]), a state with no op holds 2^23; emission e of the flush is
  // byte 3 - e % 4 of R[3 - e / 4]
  const uint32_t rq = __shfl_sync(kFull, x, (nops - 1 - (gl & 3)) & 3, G);
#pragma unroll
  for (int e0 = 0; e0 < 16; e0 += G) {
    const int e = e0 + gl;
    const uint32_t v = __shfl_sync(kFull, rq, 3 - ((e >> 2) & 3), G);
    if (live && e < 16) row[pos - 1 - e] = uint8_t(v >> (8 * (3 - (e & 3))));
  }
  if (!live) return;
  pos -= 16;
  if (gl == 0) ptrs[c] = static_cast<int32_t>(pos);
  // 5. zeros before ptr: whole words (rows start 4-byte aligned: size is a
  // multiple of 4), then the bytes of the word that holds ptr
  const int64_t words = pos >> 2;
  uint32_t* row32 = reinterpret_cast<uint32_t*>(row);
  for (int64_t k = gl; k < words; k += G) row32[k] = 0;
  if (gl < (pos & 3)) row[4 * words + gl] = 0;
}

template <int G>
int launch(const void* lows, const void* fqs, const void* rlens,
           int num_chains, int max_rlen, void* bufs, void* ptrs,
           void* stream) {
  const int per = kWarps * 32 / G;  // chains a block
  rans_encode_kernel<G><<<(num_chains + per - 1) / per, kWarps * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(lows), static_cast<const uint16_t*>(fqs),
      static_cast<const int32_t*>(rlens), num_chains, max_rlen,
      static_cast<uint8_t*>(bufs), static_cast<int32_t*>(ptrs));
  return cudaGetLastError();
}

__global__ void divmod_kernel(const uint32_t* __restrict__ x,
                              const uint32_t* __restrict__ fq, int64_t n,
                              uint32_t* __restrict__ q,
                              uint32_t* __restrict__ r) {
  const int64_t i = blockIdx.x * int64_t(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  uint32_t rem;
  q[i] = divmod(x[i], fq[i], recip(fq[i]), rem);
  r[i] = rem;
}

}  // namespace

// lows, fqs: (num_chains, 2 * max_rlen) uint16; rlens: (num_chains,) int32;
// bufs: (num_chains, 4 * max_rlen + 16) uint8; ptrs: (num_chains,) int32.
JT_EXPORT int jt_rans_encode(const void* lows, const void* fqs,
                             const void* rlens, int num_chains, int max_rlen,
                             void* bufs, void* ptrs, void* stream) {
  if (num_chains <= 0) return 0;
  return launch<kLanes>(lows, fqs, rlens, num_chains, max_rlen, bufs, ptrs,
                        stream);
}

// K5 with `lanes` (8, 16 or 32) lanes a chain, for measurement only.
JT_EXPORT int jt_rans_encode_at(const void* lows, const void* fqs,
                                const void* rlens, int num_chains,
                                int max_rlen, int lanes, void* bufs,
                                void* ptrs, void* stream) {
  if (num_chains <= 0) return 0;
  auto go = [&](auto run) {
    return run(lows, fqs, rlens, num_chains, max_rlen, bufs, ptrs, stream);
  };
  switch (lanes) {
    case 8: return go(launch<8>);
    case 16: return go(launch<16>);
    case 32: return go(launch<32>);
    default: return int(cudaErrorInvalidValue);
  }
}

// K5's division alone, for its exhaustive check: q = x / fq, r = x % fq for
// n uint32 pairs, fq in 1..65535.
JT_EXPORT int jt_rans_divmod(const void* x, const void* fq, int64_t n,
                             void* q, void* r, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  divmod_kernel<<<int((n + threads - 1) / threads), threads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(fq), n,
      static_cast<uint32_t*>(q), static_cast<uint32_t*>(r));
  return cudaGetLastError();
}
