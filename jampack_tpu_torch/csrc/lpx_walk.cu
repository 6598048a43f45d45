// K10: the Lpx span walk, both directions, one thread a span.
//
// Replaces the XLA loop of jampack_tpu/kernels/lpx_tpu.py::_code_span
// (:127; its wide variant :145 and packed variant :207), vmapped over the
// spans by jampack_tpu/kernels/device_stages.py::lpx_dyn_core (:542) on
// decode and by encode_stages.encode_front_core on encode.  Reference:
// lpx.cpp:11-170.  Each span (start, len) of the flat buffer is coded on
// its own model and written in place of its input: no deal into a padded
// (spans, span_cap) grid and no sort to undeal it, which the JAX layout
// needed only for vmap.
//
// The integer rules, as stages/lpx.py and lpx_tpu._update_table give them:
// int32 arithmetic shifts in the threshold mix, uint32 wrap of the rolling
// context and of the anchor distance, the distance compared unsigned with
// 64 KiB, and the trailing threshold update made on the record of the
// order after its adjustment.  thr * thr * order is taken mod 2^32 and
// compared unsigned with the miss count, as the native engine does: the
// JAX walk compares it signed, which differs once it reaches 2^31 (a
// threshold of 26,755 or more, only in spans far over 32 KiB).
//
// What bounds it here: the serial dependency.  A span is a chain of len
// steps, and each step reads a record of its span's tables at an address
// that the step before may have just written (the order and the context
// choose it): a shared-memory load on the chain, with a few compares and
// selects after it.  The bytes (one read and one write of the buffer) take
// far less time.  So the tables live in shared memory, one thread walks
// a span, and the input bytes are loaded kGroup steps ahead, off the chain.
//
// Tables.  A span has three order tables of 256 records.  Spans of at most
// 32,767 bytes keep a record in three words (cxt | pos + hits << 16 |
// miss + thr << 16: every counter is bounded by the span length), 9 KiB a
// span; longer spans keep five words, 15 KiB.
// The bytes a run predicts from (the output while decoding, the input
// while encoding) are kept beside the tables in shared memory: the whole
// span when it is at most 64 KiB long, else a ring of the last 64 KiB (a
// run's distance is below 64 KiB and at least 2, so the byte it reads was
// written in the ring and not yet overwritten).  One index mask serves
// both: all ones for a whole span, 64 Ki - 1 for the ring.
// Banks.  The lanes of a warp step through their spans in lockstep, so at
// each step every lane writes byte i of its own span's bytes and often
// reads the same record index of its own tables.  A span's block of
// shared memory is padded by `pad` words: an odd word count puts lane l's
// copy of the same word in bank l + c, where a multiple of 32 words would
// put every lane's in one bank.
// Spans a block.  A block holds as many spans as its shared memory takes
// (20 of the 2 KiB spans of -S4096 on an 8 MiB block, 2 of the 2 MiB spans
// of -S4), and no more than the spans spread evenly over the SMs, so that a
// few long spans walk on SMs of their own.  One warp a block: a thread
// past the block's spans only helps to clear the tables.
#include "common.cuh"

namespace {

constexpr int kMaxThreshold = 128;  // lpx.hpp:14-16
constexpr int kMinThreshold = 4;
constexpr uint32_t kMaxRecord = 64u << 10;
constexpr int kRecords = 3 * 256;  // orders 1..3, 256 prefixes each
constexpr int kGroup = 16;         // input bytes loaded ahead
constexpr int kThreads = 32;
constexpr int kRing = 64 << 10;    // the ring of a span over 64 KiB

struct Rec {
  int cxt, pos, hits, miss, thr;
};

// Three words a record, for spans of at most 32,767 bytes.
struct Packed {
  static constexpr int kWords = 3;
  __device__ static void init(uint32_t* r) {
    r[0] = 0;
    r[1] = 0;
    r[2] = uint32_t(kMaxThreshold >> 1) << 16;
  }
  __device__ static Rec load(const uint32_t* r) {
    const uint32_t w1 = r[1], w2 = r[2];
    return {int(r[0]), int(w1 & 0xFFFF), int(w1 >> 16), int(w2 & 0xFFFF),
            int(w2 >> 16)};
  }
  __device__ static void run_fields(const uint32_t* r, int& pos, int& hits,
                                    int& thr) {
    const uint32_t w1 = r[1];
    pos = int(w1 & 0xFFFF);
    hits = int(w1 >> 16);
    thr = int(r[2] >> 16);
  }
  __device__ static void store(uint32_t* r, const Rec& v) {
    r[0] = uint32_t(v.cxt);
    r[1] = uint32_t(v.pos) | (uint32_t(v.hits) << 16);
    r[2] = uint32_t(v.miss) | (uint32_t(v.thr) << 16);
  }
  __device__ static void store_thr(uint32_t* r, const Rec& v) {
    r[2] = uint32_t(v.miss) | (uint32_t(v.thr) << 16);
  }
};

// Five words a record, for any span.
struct Wide {
  static constexpr int kWords = 5;
  __device__ static void init(uint32_t* r) {
    r[0] = r[1] = r[2] = r[3] = 0;
    r[4] = uint32_t(kMaxThreshold >> 1);
  }
  __device__ static Rec load(const uint32_t* r) {
    return {int(r[0]), int(r[1]), int(r[2]), int(r[3]), int(r[4])};
  }
  __device__ static void run_fields(const uint32_t* r, int& pos, int& hits,
                                    int& thr) {
    pos = int(r[1]);
    hits = int(r[2]);
    thr = int(r[4]);
  }
  __device__ static void store(uint32_t* r, const Rec& v) {
    r[0] = uint32_t(v.cxt);
    r[1] = uint32_t(v.pos);
    r[2] = uint32_t(v.hits);
    r[3] = uint32_t(v.miss);
    r[4] = uint32_t(v.thr);
  }
  __device__ static void store_thr(uint32_t* r, const Rec& v) {
    r[4] = uint32_t(v.thr);
  }
};

// The trailing threshold update of lpx.cpp:29-52 on record q, for the
// order `o` after the adjustment.
__device__ __forceinline__ void mix_threshold(Rec& q, bool match, int bound,
                                              int o) {
  if (match) {
    if (q.hits > (q.thr << 1) && q.miss == 0) q.thr += (bound - q.thr) >> o;
  } else if (q.miss > q.thr) {
    q.thr += (kMaxThreshold - q.thr) >> (4 - o);
  }
}

// lpx.cpp:11-54 on the tables of one span; returns the adjusted order.
template <class L>
__device__ __forceinline__ int update_table(uint32_t* tbl, uint32_t cxt,
                                            int pos, int o) {
  const int lp = int(cxt >> (8 * o)) & 0xFF;
  const int ls = int(cxt & ((1u << (8 * o)) - 1u));
  uint32_t* rp = tbl + ((o - 1) * 256 + lp) * L::kWords;
  Rec r = L::load(rp);
  if (pos <= o) return o;
  const int distance = pos - r.pos;
  const int upper = r.hits < kMaxThreshold
                        ? max(distance, kMinThreshold)
                        : min(distance >> o, kMaxThreshold >> o);
  const int bound =
      distance <= kMinThreshold ? kMinThreshold : min(distance, upper);
  const bool match = r.cxt == ls;
  int no = o;
  if (match) {
    r.pos = pos - o;
    r.hits += 1;
    r.miss = 0;
    if (r.hits > ((r.thr << o) << 3) && o > 1) no = o - 1;
  } else {
    r.hits >>= 2;
    r.miss += 1;
    r.cxt = ls;
    // thr * thr * order mod 2^32, compared unsigned (lpx.cpp, the native
    // engine); the JAX chain compares it signed (ROADMAP C6)
    const uint32_t sq = uint32_t(r.thr) * uint32_t(r.thr) * uint32_t(o);
    if (uint32_t(r.miss) > sq && o < 3) no = o + 1;
  }
  if (no == o) {
    mix_threshold(r, match, bound, no);
    L::store(rp, r);
  } else {
    L::store(rp, r);
    uint32_t* qp = tbl + ((no - 1) * 256 + lp) * L::kWords;
    Rec q = L::load(qp);
    mix_threshold(q, match, bound, no);
    L::store_thr(qp, q);
  }
  return no;
}

template <class L, bool kDecode>
__global__ void __launch_bounds__(kThreads) lpx_walk_kernel(
    const uint8_t* __restrict__ in, const int32_t* __restrict__ starts,
    const int32_t* __restrict__ lens, int nspans, int max_len, int per_block,
    int span_words, uint32_t ring_mask, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t smem[];
  constexpr int kTableWords = kRecords * L::kWords;
  const int first = blockIdx.x * per_block;
  const int here = min(per_block, nspans - first);
  for (int k = threadIdx.x; k < here * kRecords; k += kThreads)
    L::init(smem + (k / kRecords) * span_words + (k % kRecords) * L::kWords);
  __syncthreads();
  if (int(threadIdx.x) >= here) return;

  uint32_t* tbl = smem + threadIdx.x * span_words;
  uint8_t* hist = reinterpret_cast<uint8_t*>(tbl + kTableWords);
  const int s = first + threadIdx.x;
  // a span is cut at max_len, so a wrong max_len cannot write past the
  // span's own shared memory
  const int len = min(max(lens[s], 0), max_len);
  const uint8_t* src = in + starts[s];
  uint8_t* dst = out + starts[s];

  uint32_t cxt = 0, run_dist = 0;
  int order = 3;
  bool in_run = false;
  uint32_t next[kGroup];
#pragma unroll
  for (int k = 0; k < kGroup; ++k) next[k] = k < len ? __ldg(src + k) : 0u;
  for (int base = 0; base < len; base += kGroup) {
    uint32_t cur[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      cur[k] = next[k];
      const int at = base + kGroup + k;
      next[k] = at < len ? __ldg(src + at) : 0u;
    }
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int i = base + k;
      if (i >= len) break;
      // a run starts where the record of the last byte's prefix has hit
      // more often than its threshold, its anchor under 64 KiB back
      int pos0, hits0, thr0;
      L::run_fields(tbl + ((order - 1) * 256 + int(cxt & 0xFF)) * L::kWords,
                    pos0, hits0, thr0);
      const uint32_t dist_new = uint32_t(i) - uint32_t(pos0);
      const bool coding =
          in_run || (hits0 > thr0 && dist_new < kMaxRecord);
      const uint32_t dist = in_run ? run_dist : dist_new;
      uint32_t ref = 0;
      if (coding) {
        const int from = i - int(dist);
        ref = hist[uint32_t(from) & ring_mask];
      }
      const uint32_t c = cur[k];
      const uint32_t x = ref ^ c;
      const uint32_t emitted = coding ? x : c;
      const uint32_t orig = kDecode ? emitted : c;
      dst[i] = uint8_t(emitted);
      hist[uint32_t(i) & ring_mask] = uint8_t(orig);
      order = update_table<L>(tbl, cxt, i, order);
      cxt = (cxt << 8) | orig;
      if (coding) run_dist = dist;
      in_run = coding && (kDecode ? c : x) == 0;
    }
  }
}

template <class L, bool kDecode>
cudaError_t launch(const uint8_t* in, const int32_t* starts,
                   const int32_t* lens, int nspans, int max_len,
                   int per_block, int span_words, uint32_t ring_mask,
                   uint8_t* out, cudaStream_t st) {
  auto kernel = lpx_walk_kernel<L, kDecode>;
  const size_t smem = size_t(per_block) * span_words * 4;
  cudaError_t err = jt_allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (nspans + per_block - 1) / per_block;
  kernel<<<blocks, kThreads, smem, st>>>(in, starts, lens, nspans, max_len,
                                         per_block, span_words, ring_mask,
                                         out);
  return cudaGetLastError();
}

template <class L>
cudaError_t launch_dir(bool decode, const uint8_t* in, const int32_t* starts,
                       const int32_t* lens, int nspans, int max_len,
                       int per_block, int span_words, uint32_t ring_mask,
                       uint8_t* out, cudaStream_t st) {
  return decode ? launch<L, true>(in, starts, lens, nspans, max_len,
                                  per_block, span_words, ring_mask, out, st)
                : launch<L, false>(in, starts, lens, nspans, max_len,
                                   per_block, span_words, ring_mask, out, st);
}

}  // namespace

// in, out: (n,) uint8; starts, lens: (nspans,) int32, spans that do not
// overlap and lie inside the buffer; max_len: the longest span (a longer
// span is coded only up to max_len); decode: 0 = encode, 1 = decode; pad:
// words added to each span's block of shared memory (see Banks above).
// Bytes outside every span are not written.
JT_EXPORT int jt_lpx_walk(const void* in, const void* starts,
                          const void* lens, int nspans, int max_len,
                          int decode, int pad, void* out, void* stream) {
  if (nspans <= 0 || max_len <= 0) return 0;
  if (pad < 0) return cudaErrorInvalidValue;
  const bool packed = max_len <= 0x7FFF;
  const bool wrap = max_len > kRing;
  const int ring = wrap ? kRing : (max_len + 15) & ~15;
  const uint32_t ring_mask = wrap ? uint32_t(kRing - 1) : ~0u;
  const int words = packed ? Packed::kWords : Wide::kWords;
  const int span_words = kRecords * words + ring / 4 + pad;
  int dev = 0, optin = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int fit = optin / (span_words * 4);
  if (fit < 1) return cudaErrorInvalidValue;
  const int spread = (nspans + sms - 1) / sms;
  const int per_block = min(min(fit, kThreads), max(spread, 1));
  auto* i = static_cast<const uint8_t*>(in);
  auto* s = static_cast<const int32_t*>(starts);
  auto* l = static_cast<const int32_t*>(lens);
  auto* o = static_cast<uint8_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  return packed ? launch_dir<Packed>(decode, i, s, l, nspans, max_len,
                                     per_block, span_words, ring_mask, o, st)
                : launch_dir<Wide>(decode, i, s, l, nspans, max_len,
                                   per_block, span_words, ring_mask, o, st);
}
