// Forward/inverse BWT with parallel-decode anchors, host path.
// Stream layout matches bwt.cpp:22-65; the inverse chases all transmitted
// anchors concurrently (OpenMP over chains) like bwt.cpp:243-276, with a
// 4-chain-per-thread interleave for out-of-order execution.
#include <omp.h>

#include "jn_common.hpp"

namespace jpt {
void suffix_array(const u8* t, i32* sa, i32 n);
}

extern "C" {

// out must hold n + units*4 bytes; units is the anchor count (120 for
// reference-compatible streams, larger for native streams)
int64_t jam_bwt_forward_u(const uint8_t* in, int64_t n, uint8_t* out,
                          int32_t units) {
  using namespace jpt;
  i64 remainder = n % units;
  i64 nlen = n - remainder;
  memcpy(out + nlen, in + nlen, remainder);
  std::vector<i32> anchors(units, 0);
  if (nlen > 0) {
    std::vector<i32> sa(nlen);
    suffix_array(in, sa.data(), i32(nlen));
    i32 step = i32(nlen / units);
    // one fused pass: anchor detection + BWT emission.  The random
    // in[sa[i]-1] load is the cost center (one cache miss per element) —
    // sa[] is read sequentially, so prefetching in[sa[i+16]] hides it.
    // Divisibility by the runtime `step` uses the multiplicative test
    // (pos % step == 0  iff  pos * M wraps below M, M = 2^64/step + 1):
    // the hardware divide cost ~8M divs per block otherwise.
    uint64_t M = step > 1 ? (~0ULL / uint64_t(step)) + 1 : 0;
    out[0] = in[nlen - 1];
    i64 off = 1;  // writes land at i+1 until the rank of suffix 0 passes
    for (i64 i = 0; i < nlen; i++) {
      if (i + 16 < nlen) __builtin_prefetch(&in[sa[i + 16]]);
      i32 pos = sa[i];
      if (step == 1 || (M * uint64_t(uint32_t(pos))) < M) {
        anchors[pos / step] = i32(i);
        if (pos == 0) { off = 0; continue; }
      }
      out[i + off] = in[pos - 1];
    }
    for (int i = 0; i < units; i++) anchors[i] += 1;
  }
  memcpy(out + n, anchors.data(), units * sizeof(i32));
  return n + i64(units) * 4;
}

int64_t jam_bwt_forward(const uint8_t* in, int64_t n, uint8_t* out) {
  return jam_bwt_forward_u(in, n, out, jpt::kBwtUnits);
}

// in holds csize bytes = payload + units*4 anchor bytes
int64_t jam_bwt_inverse_u(const uint8_t* in, int64_t csize, uint8_t* out,
                          int32_t threads, int32_t units) {
  using namespace jpt;
  i64 n = csize - i64(units) * 4;
  if (n < 0) return -1;
  std::vector<i32> anchors(units);
  memcpy(anchors.data(), in + n, units * sizeof(i32));
  i64 remainder = n % units;
  i64 nlen = n - remainder;
  memcpy(out + nlen, in + nlen, remainder);
  if (nlen == 0) return n;

  // stream-supplied anchors are untrusted: every chain start (and the
  // primary index anchors[0]) must be a valid 1-based position
  for (int j = 0; j < units; j++)
    if (anchors[j] < 1 || i64(anchors[j]) > nlen) return -1;
  i32 idx = anchors[0];
  // LF map: counting sort of BWT positions by symbol with +1 adjustment.
  // The scatter store is the miss: prefetching &map[count[in[i+D]]] with
  // TODAY's counter lands within D entries of the future slot — same cache
  // line almost always — which hides most of the store-miss latency.
  std::vector<i32> map(nlen);
  i64 count[257] = {0};
  for (i64 i = 0; i < nlen; i++) count[in[i] + 1]++;
  for (int i = 1; i < 256; i++) count[i] += count[i - 1];
  constexpr i64 kMD = 24;
  for (i64 i = 0; i < idx; i++) {
    if (i + kMD < idx) __builtin_prefetch(&map[count[in[i + kMD]]], 1);
    map[count[in[i]]++] = i32(i);
  }
  for (i64 i = idx; i < nlen; i++) {
    if (i + kMD < nlen) __builtin_prefetch(&map[count[in[i + kMD]]], 1);
    map[count[in[i]]++] = i32(i + 1);
  }

  i64 step = nlen / units;
  std::vector<i32> p(anchors);

  int nthreads = threads > 0 ? threads : omp_get_max_threads();
  if (nthreads > units / 4) nthreads = units / 4;
  if (nthreads < 1) nthreads = 1;
  while (units % nthreads != 0) nthreads--;
  int per = units / nthreads;

#pragma omp parallel for num_threads(nthreads)
  for (int t = 0; t < nthreads; t++) {
    // two passes per step: pass 1 advances every chain and prefetches both
    // this step's in[] byte and the NEXT step's map[] entry, pass 2 emits.
    // The chase is two dependent cache misses per byte; giving each load a
    // full chain-sweep of lead time keeps the miss buffers saturated where
    // the fused loop ran ~5 misses deep.
    std::vector<i32> pjs(per);
    for (i64 i = 0; i < step; i++) {
      for (int j = t * per; j < (t + 1) * per; j++) {
        // clamp the chase index so corrupt interior map values cannot read
        // out of bounds (the block crc reports the corruption afterwards);
        // map values are in [0, nlen] by construction, so in[] stays valid
        u32 q = u32(p[j]) - 1;
        if (q >= u32(nlen)) q = 0;
        i32 pj = map[q];
        p[j] = pj;
        pjs[j - t * per] = pj;
        u32 qn = u32(pj) - 1;
        if (qn >= u32(nlen)) qn = 0;
        __builtin_prefetch(&map[qn]);
        __builtin_prefetch(&in[pj - (pj >= idx)]);
      }
      u8* orow = out + i;
      for (int j = t * per; j < (t + 1) * per; j++) {
        i32 pj = pjs[j - t * per];
        orow[i64(j) * step] = in[pj - (pj >= idx)];
      }
    }
  }
  return n;
}

int64_t jam_bwt_inverse(const uint8_t* in, int64_t csize, uint8_t* out,
                        int32_t threads) {
  return jam_bwt_inverse_u(in, csize, out, threads, jpt::kBwtUnits);
}
}
