// K3: the anchored inverse-BWT LF chase, by pointer jumping.
//
// Replaces the lax.fori_loop chase of
// jampack_tpu/kernels/device_stages.py::ibwt_dyn_core (:654-673) and
// ibwt.chase_combined_core; the reference runs the same loop in CUDA
// (bwt.cpp:8-19), one thread per anchor.
//
// The function: chain u (of `units`, each `step` long) visits j_0 =
// clamp(anchor_u, 1, nlen) - 1, then j_{s+1} = g(j_s) with g(j) =
// clamp(lf[j] - 1, 0, nlen - 1), and writes out[u * step + s] = sbyte[j_s].
//
// What bounds it here: the walk is a chain of dependent random reads over
// the map (8.4M entries for an 8 MiB block: 34 MB of lf plus 8.4 MB of
// bytes).  One thread an anchor gave 960 chains of 8,738 dependent L2 reads
// on 30 SMs; the anchor count is fixed by the stream, so the chains have to
// be cut.
//
// Design, three phases on the stream, with D a power of two:
//   1. the jump table G_D = g^D, by log2(D) passes of one thread an entry:
//      G_2 = g(g(j)) straight from lf, then G_2k[j] = G_k[G_k[j]],
//      ping-ponging between two scratch maps;
//   2. the anchor walk: the output is cut into sub-chains at the multiples
//      of D, so sub-chain c covers positions [c D, c D + D).  One thread a
//      chain walks single steps of g from j_0 to its first cut, then jumps
//      of G_D, and records the map entry of each sub-chain it starts;
//   3. the sub-chains: one thread each walks D steps of g from its entry,
//      restarting at the next anchor where it crosses a chain's end, keeps
//      its D bytes in registers and writes them 16 bytes at a time (the cuts
//      sit at the multiples of D, so every store is aligned; cuts at
//      u * step + t D would not be, step being 8,738 at 8 MiB).
// The sub-chains' entries go in the scratch map that the last squaring pass
// left free.  D is kJump: at 8 MiB, 262,140 sub-chains of 32 steps, not 960
// chains of 8,738.  What bounds it now is the jump table: each pass is 8.4M
// random 4-byte gathers (PERF.md).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// D.  Of 16, 32, 64 and 128, timed on an H100 at an 8 MiB block's shapes
// (chip_smoke.py, through jt_ibwt_chase_at), 32 was the fastest.
constexpr int kJump = 32;

__device__ __forceinline__ int32_t lf_step(const int32_t* __restrict__ lf,
                                           int32_t j, int32_t nlen) {
  return jt_clamp<int32_t>(lf[j] - 1, 0, nlen - 1);
}

__device__ __forceinline__ int32_t first_entry(int32_t anchor, int32_t nlen) {
  return jt_clamp<int32_t>(anchor, 1, nlen) - 1;
}

__global__ void __launch_bounds__(kThreads) jump_first(
    const int32_t* __restrict__ lf, int32_t nlen, int32_t* __restrict__ g2) {
  const int64_t j = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= nlen) return;
  g2[j] = lf_step(lf, lf_step(lf, int32_t(j), nlen), nlen);
}

__global__ void __launch_bounds__(kThreads) jump_square(
    const int32_t* __restrict__ g, int32_t nlen, int32_t* __restrict__ g2) {
  const int64_t j = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= nlen) return;
  g2[j] = g[g[j]];
}

__global__ void __launch_bounds__(kThreads) anchor_walk(
    const int32_t* __restrict__ lf, const int32_t* __restrict__ gd,
    const int32_t* __restrict__ anchors, int32_t nlen, int units,
    int32_t step, int depth, int32_t* __restrict__ entry) {
  const int u = blockIdx.x * kThreads + threadIdx.x;
  if (u >= units) return;
  const int64_t begin = int64_t(u) * step, end = begin + step;
  int64_t c = (begin + depth - 1) / depth;  // the first cut in the chain
  if (c * depth >= end) return;
  int32_t j = first_entry(anchors[u], nlen);
  for (int s = int(c * depth - begin); s > 0; --s) j = lf_step(lf, j, nlen);
  for (;;) {
    entry[c] = j;
    if (++c * depth >= end) break;
    j = gd[j];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) subchains(
    const int32_t* __restrict__ lf, const uint8_t* __restrict__ sbyte,
    const int32_t* __restrict__ anchors, const int32_t* __restrict__ entry,
    int32_t nlen, int units, int32_t step, int64_t count,
    uint8_t* __restrict__ out) {
  const int64_t c = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= count) return;
  const int64_t p0 = c * D;
  int u = int(p0 / step);
  int32_t s = int32_t(p0 - int64_t(u) * step);
  int32_t j = entry[c];
  uint32_t w[D / 4];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    if (s == step) {  // the chain ended: the next one starts at its anchor
      ++u;
      s = 0;
      if (u < units) j = first_entry(anchors[u], nlen);
    }
    const uint32_t b = sbyte[j];
    w[k / 4] = k % 4 ? w[k / 4] | (b << (8 * (k % 4))) : b;
    j = lf_step(lf, j, nlen);
    ++s;
  }
  uint8_t* o = out + p0;
  if (p0 + D <= nlen) {
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      reinterpret_cast<uint4*>(o)[k] =
          make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
  } else {  // the last sub-chain: only up to nlen
#pragma unroll
    for (int k = 0; k < D; ++k)
      if (p0 + k < nlen) o[k] = uint8_t(w[k / 4] >> (8 * (k % 4)));
  }
}

template <int D>
cudaError_t chase(const int32_t* lf, const uint8_t* sbyte,
                  const int32_t* anchors, int32_t nlen, int units,
                  int32_t step, int32_t* ga, int32_t* gb, uint8_t* out,
                  int phases, cudaStream_t stream) {
  const int map_blocks = int((int64_t(nlen) + kThreads - 1) / kThreads);
  jump_first<<<map_blocks, kThreads, 0, stream>>>(lf, nlen, ga);
  for (int k = 4; k <= D; k <<= 1) {
    jump_square<<<map_blocks, kThreads, 0, stream>>>(ga, nlen, gb);
    int32_t* t = ga;
    ga = gb;
    gb = t;
  }
  int32_t* entry = gb;  // ga holds g^D; ceil(nlen / D) entries fit in gb
  if (phases >= 2)
    anchor_walk<<<(units + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        lf, ga, anchors, nlen, units, step, D, entry);
  if (phases >= 3) {
    const int64_t count = (int64_t(nlen) + D - 1) / D;
    subchains<D><<<int((count + kThreads - 1) / kThreads), kThreads, 0,
                   stream>>>(lf, sbyte, anchors, entry, nlen, units, step,
                             count, out);
  }
  return cudaGetLastError();
}

int invalid(int32_t nlen, int units, int32_t step, const void* out) {
  return int64_t(units) * step != nlen ||
         (reinterpret_cast<uintptr_t>(out) & 15);
}

}  // namespace

// lf, sbyte: (nlen,); anchors: (units,); ga, gb: (nlen,) int32 scratch;
// out: (units * step,) uint8, 16-byte aligned.
JT_EXPORT int jt_ibwt_chase(const void* lf, const void* sbyte,
                            const void* anchors, int32_t nlen, int units,
                            int32_t step, void* ga, void* gb, void* out,
                            void* stream) {
  if (units <= 0 || step <= 0 || nlen <= 0) return 0;
  if (invalid(nlen, units, step, out)) return cudaErrorInvalidValue;
  return chase<kJump>(
      static_cast<const int32_t*>(lf), static_cast<const uint8_t*>(sbyte),
      static_cast<const int32_t*>(anchors), nlen, units, step,
      static_cast<int32_t*>(ga), static_cast<int32_t*>(gb),
      static_cast<uint8_t*>(out), 3, static_cast<cudaStream_t>(stream));
}

// For measurement only (chip_smoke.py's sweep; no path calls it): the same
// walk with D = depth (16, 32, 64 or 128), stopping after phase `phases`
// (1: the jump table, 2: the anchor walk, 3: the sub-chains; below 3 the
// output is left unwritten).
JT_EXPORT int jt_ibwt_chase_at(const void* lf, const void* sbyte,
                               const void* anchors, int32_t nlen, int units,
                               int32_t step, int depth, void* ga, void* gb,
                               void* out, int phases, void* stream) {
  if (units <= 0 || step <= 0 || nlen <= 0) return 0;
  if (invalid(nlen, units, step, out) || phases < 1 || phases > 3)
    return cudaErrorInvalidValue;
  auto run = [&](auto fn) {
    return fn(static_cast<const int32_t*>(lf),
              static_cast<const uint8_t*>(sbyte),
              static_cast<const int32_t*>(anchors), nlen, units, step,
              static_cast<int32_t*>(ga), static_cast<int32_t*>(gb),
              static_cast<uint8_t*>(out), phases,
              static_cast<cudaStream_t>(stream));
  };
  switch (depth) {
    case 16: return run(chase<16>);
    case 32: return run(chase<32>);
    case 64: return run(chase<64>);
    case 128: return run(chase<128>);
    default: return cudaErrorInvalidValue;
  }
}
