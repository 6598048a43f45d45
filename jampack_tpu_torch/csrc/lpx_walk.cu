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
// What bounds it here: the serial dependency, then instruction issue.  A
// span is a chain of len steps.  A step reads two records of its span's
// tables, the run record (order, last byte) and the primary record (order,
// the byte `order` back), at addresses that the order and the context
// choose, and writes the primary record back; the next step may read what
// it wrote.  The bytes (one read and one write of the buffer) take far
// less time.  So the tables live in shared memory, one thread walks a
// span, and the design keeps the loads off the step's chain:
//
// - A record is one vector load.  A span of at most 64 KiB, held whole in
//   shared memory, has counters of at most 17 bits, so a record is four
//   words: cxt | miss.b0 << 24, pos | miss.b1 << 24, hits | miss.b2 << 24,
//   thr | byte << 24 (Rec4).  Longer spans (the ring) take eight words,
//   two loads (Rec8).  Four words hold 16 spans of -S4096 an SM against
//   eight, half the waves; at the ring's lengths the shared memory does
//   not bind, and eight words read no slower (PERF.md).  `byte` is the
//   byte at the record's pos: the byte a run that starts on this record
//   predicts from, so a run's first byte needs no load of its own.
// - A step's two records are loaded during the step before, as soon as the
//   context is known (at once on encode; after the emitted byte on
//   decode), for the order the step before keeps: orders change rarely,
//   and the step that changes one stores, then reloads them from the new
//   order's table.  The loads are issued before the step before stores its
//   primary record, and that record, kept in registers, is taken in place
//   of a load at the same index (store-to-load forwarding).
// - A span alone in its warp walks in one loop an order, in which the
//   order's shifts, masks and table are constants.  Spans that share a
//   warp walk one loop that reads the order at each step: in loops of
//   their own, lanes in different orders would walk one after another.
// - The input byte and the run's next byte (within a run its address
//   i - dist does not change) are loaded a step ahead.
// What is left is the step's own instructions, with little to overlap
// them, most of them on the integer pipe, which takes two cycles a warp
// instruction: that issue, not a load, sets its time (PERF.md), so every
// instruction cut from the step counts.
//
// Tables.  A span has three order tables of 256 records.  The bytes a run
// predicts from (the output while decoding, the input while encoding) are
// kept beside the tables in shared memory: the whole span when it is at
// most 64 KiB long, else a ring of the last 64 KiB (a run's distance is
// below 64 KiB and at least 2, so the byte it reads was written in the
// ring and not yet overwritten).  One index mask serves both: all ones for
// a whole span, 64 Ki - 1 for the ring.
// Banks.  The spans of a warp step in lockstep, so each reads the same
// record index of its own tables at once.  A span's block of shared memory
// is padded by kPad records of 16 bytes: a multiple of 128 bytes would put
// every lane's copy of a record in the same four banks.
// Spans a block.  A block holds as many spans as its shared memory takes
// (16 of the 2 KiB spans of -S4096, 2 of the 2 MiB spans of -S4), and no
// more than the spans spread evenly over the SMs, so that a few long spans
// walk on SMs of their own.  kLanes spans share a warp: a block of
// per_block spans runs ceil(per_block / kLanes) warps, spread over the
// SM's schedulers, each warp's instructions shared by its spans (the
// lanes past a warp's spans only help to clear the tables).
// jt_lpx_walk_at takes the padding, the spans a warp and the record layout
// as arguments, for the sweeps of chip_smoke.py that chose them; no path
// calls it.
#include "common.cuh"

namespace {

constexpr int kMaxThreshold = 128;  // lpx.hpp:14-16
constexpr int kMinThreshold = 4;
constexpr uint32_t kMaxRecord = 64u << 10;
constexpr int kRecords = 3 * 256;  // orders 1..3, 256 prefixes each
constexpr int kMaxWarps = 16;
constexpr int kRing = 64 << 10;    // the ring of a span over 64 KiB
constexpr uint32_t kNone = 0x100;  // no record to forward: matches no index
constexpr int kPad = 1;    // lpx.BANK_PAD
constexpr int kLanes = 5;  // lpx.SPANS_A_WARP

// Four words a record, for spans of at most 64 KiB (and, measured, of any
// length below 16 MiB): every counter is below the span length, and the
// stored context has at most 24 bits.
struct Rec4 {
  static constexpr int kBytes = 16;
  static constexpr int kMaxLen = (1 << 24) - 1;
  struct Raw {
    uint4 a;
  };
  __device__ static Raw init() {
    return {make_uint4(0, 0, 0, uint32_t(kMaxThreshold >> 1))};
  }
  __device__ static Raw load(const uint8_t* p) {
    return {*reinterpret_cast<const uint4*>(p)};
  }
  __device__ static void store(uint8_t* p, const Raw& r) {
    *reinterpret_cast<uint4*>(p) = r.a;
  }
  __device__ static void store_thr(uint8_t* p, const Raw& r) {
    reinterpret_cast<uint32_t*>(p)[3] = r.a.w;
  }
  __device__ static Raw sel(bool c, const Raw& x, const Raw& y) {
    return {make_uint4(c ? x.a.x : y.a.x, c ? x.a.y : y.a.y,
                       c ? x.a.z : y.a.z, c ? x.a.w : y.a.w)};
  }
  // the context word: its low 24 bits, compared under the order's mask
  __device__ static uint32_t cxt(const Raw& r) { return r.a.x; }
  __device__ static int pos(const Raw& r) { return int(r.a.y & 0xFFFFFFu); }
  __device__ static int hits(const Raw& r) { return int(r.a.z & 0xFFFFFFu); }
  __device__ static int thr(const Raw& r) { return int(r.a.w & 0xFFFFFFu); }
  __device__ static uint32_t byte(const Raw& r) { return r.a.w >> 24; }
  __device__ static int miss(const Raw& r) {
    return int((r.a.x >> 24) | ((r.a.y >> 16) & 0xFF00u) |
               ((r.a.z >> 8) & 0xFF0000u));
  }
  __device__ static Raw pack(uint32_t ls, int pos, int hits, int miss,
                             int thr, uint32_t byte) {
    const uint32_t m = uint32_t(miss);
    return {make_uint4(__byte_perm(ls, m, 0x4210),
                       __byte_perm(uint32_t(pos), m, 0x5210),
                       __byte_perm(uint32_t(hits), m, 0x6210),
                       __byte_perm(uint32_t(thr), byte, 0x4210))};
  }
  __device__ static Raw with_thr(const Raw& r, int thr) {
    return {make_uint4(r.a.x, r.a.y, r.a.z,
                       __byte_perm(uint32_t(thr), r.a.w, 0x7210))};
  }
};

// Eight words a record, for any span: cxt, pos, hits, miss; thr, byte.
struct Rec8 {
  static constexpr int kBytes = 32;
  struct Raw {
    uint4 a, b;
  };
  __device__ static Raw init() {
    return {make_uint4(0, 0, 0, 0),
            make_uint4(uint32_t(kMaxThreshold >> 1), 0, 0, 0)};
  }
  __device__ static Raw load(const uint8_t* p) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
    return {q[0], q[1]};
  }
  __device__ static void store(uint8_t* p, const Raw& r) {
    uint4* q = reinterpret_cast<uint4*>(p);
    q[0] = r.a;
    q[1] = r.b;
  }
  __device__ static void store_thr(uint8_t* p, const Raw& r) {
    reinterpret_cast<uint32_t*>(p)[4] = r.b.x;
  }
  __device__ static Raw sel(bool c, const Raw& x, const Raw& y) {
    return {make_uint4(c ? x.a.x : y.a.x, c ? x.a.y : y.a.y,
                       c ? x.a.z : y.a.z, c ? x.a.w : y.a.w),
            make_uint4(c ? x.b.x : y.b.x, c ? x.b.y : y.b.y, 0, 0)};
  }
  __device__ static uint32_t cxt(const Raw& r) { return r.a.x; }
  __device__ static int pos(const Raw& r) { return int(r.a.y); }
  __device__ static int hits(const Raw& r) { return int(r.a.z); }
  __device__ static int miss(const Raw& r) { return int(r.a.w); }
  __device__ static int thr(const Raw& r) { return int(r.b.x); }
  __device__ static uint32_t byte(const Raw& r) { return r.b.y; }
  __device__ static Raw pack(uint32_t ls, int pos, int hits, int miss,
                             int thr, uint32_t byte) {
    return {make_uint4(ls, uint32_t(pos), uint32_t(hits), uint32_t(miss)),
            make_uint4(uint32_t(thr), byte, 0, 0)};
  }
  __device__ static Raw with_thr(const Raw& r, int thr) {
    return {r.a, make_uint4(uint32_t(thr), r.b.y, 0, 0)};
  }
};

// The trailing threshold update of lpx.cpp:29-52 on a record's (thr,
// hits, miss), for the order `o` after the adjustment.
__device__ __forceinline__ int mix_threshold(int thr, int hits, int miss,
                                             bool match, int bound, int o) {
  if (match) {
    if (hits > (thr << 1) && miss == 0) thr += (bound - thr) >> o;
  } else if (miss > thr) {
    thr += (kMaxThreshold - thr) >> (4 - o);
  }
  return thr;
}

// A span's walk between steps.
template <class L>
struct Span {
  typename L::Raw frec;  // the record the step before stored, at fidx
  typename L::Raw R, P;  // this step's run and primary records, as loaded
  uint32_t cxt, fidx;
  uint32_t run_dist;     // read only within a run, which sets it
  uint32_t ref_run;      // hist[i - run_dist], loaded a step ahead
  uint32_t c;            // input byte i, loaded a step ahead
  int i;
  int order;
  bool in_run;
};

// The record of order `o` at index idx.
template <class L>
__device__ __forceinline__ uint8_t* rec(uint8_t* tbl, int o, uint32_t idx) {
  return tbl + ((o - 1) * 256 + int(idx)) * L::kBytes;
}

// Steps of a span.  A span alone in its warp walks in one loop an order,
// O, in which the order's shifts, masks and table are constants; it
// returns the new order when it changes, or 0 at the span's end.  Spans
// that share a warp take O = 0, one loop that reads the order at each step:
// in loops of their own, the lanes of a warp in different orders would
// walk one after another.
template <class L, bool kDecode, int O>
__device__ __forceinline__ int walk_order(Span<L>& s,
                                          const uint8_t* __restrict__ src,
                                          uint8_t* __restrict__ dst, int len,
                                          uint8_t* tbl, uint8_t* hist,
                                          uint32_t ring_mask) {
  using Raw = typename L::Raw;
#pragma unroll 2
  for (int i = s.i; i < len; ++i) {
    const int o = O ? O : s.order;
    const uint32_t mask = 0xFFFFFFu >> (24 - 8 * o);  // the order's cxt
    uint8_t* const t = rec<L>(tbl, o, 0);
    const uint32_t c = s.c;
    // unsigned offsets: an address is one add; the last step reloads its
    // own byte, so no load leaves the span
    s.c = __ldg(src + min(uint32_t(i) + 1u, uint32_t(len) - 1u));
    const uint32_t cxt = s.cxt;
    // a run starts where the record of the last byte's prefix has hit
    // more often than its threshold, its anchor under 64 KiB back
    const Raw rr = L::sel((cxt & 0xFF) == s.fidx, s.frec, s.R);
    const uint32_t dist_new = uint32_t(i) - uint32_t(L::pos(rr));
    const bool coding =
        s.in_run || (L::hits(rr) > L::thr(rr) && dist_new < kMaxRecord);
    const uint32_t dist = s.in_run ? s.run_dist : dist_new;
    const uint32_t x = (s.in_run ? s.ref_run : L::byte(rr)) ^ c;
    const uint32_t emitted = coding ? x : c;
    const uint32_t orig = kDecode ? emitted : c;
    const uint32_t cxt1 = (cxt << 8) | orig;
    // the next step's records, loaded before this step stores: the one it
    // stores is forwarded through frec
    const Raw nR = L::load(t + orig * L::kBytes);
    const Raw nP = L::load(t + ((cxt1 >> (8 * o)) & 0xFF) * L::kBytes);
    if (coding) s.run_dist = dist;
    s.in_run = coding && (kDecode ? c : x) == 0;
    s.ref_run = hist[(uint32_t(i) + 1 - s.run_dist) & ring_mask];
    dst[uint32_t(i)] = uint8_t(emitted);
    hist[uint32_t(i) & ring_mask] = uint8_t(orig);
    s.cxt = cxt1;

    // the table update (lpx.cpp:11-54) on the primary record
    const uint32_t lp = (cxt >> (8 * o)) & 0xFF;
    const Raw r = L::sel(lp == s.fidx, s.frec, s.P);
    const int pos = L::pos(r), hits = L::hits(r), thr = L::thr(r);
    const int distance = i - pos;
    const int upper = hits < kMaxThreshold
                          ? max(distance, kMinThreshold)
                          : min(distance >> o, kMaxThreshold >> o);
    const int bound =
        distance <= kMinThreshold ? kMinThreshold : min(distance, upper);
    const bool match = ((L::cxt(r) ^ cxt) & mask) == 0;
    const int hits1 = match ? hits + 1 : hits >> 2;
    const int miss1 = match ? 0 : L::miss(r) + 1;
    const int pos1 = match ? i - o : pos;
    const uint32_t byte1 = match ? (cxt >> (8 * (o - 1))) & 0xFF : L::byte(r);
    // thr * thr * order mod 2^32, compared unsigned (lpx.cpp, the native
    // engine); the JAX chain compares it signed (ROADMAP C6)
    const bool down =
        o > 1 && match && hits1 > int(uint32_t(thr) << (o + 3));
    const bool up = o < 3 && !match &&
                    uint32_t(miss1) > uint32_t(thr) * uint32_t(thr) * o;
    uint8_t* const rp = t + lp * L::kBytes;
    if (!down && !up) {
      s.frec = L::pack(cxt & mask, pos1, hits1, miss1,
                       mix_threshold(thr, hits1, miss1, match, bound, o),
                       byte1);
      L::store(rp, s.frec);
      s.fidx = lp;
      s.R = nR;
      s.P = nP;
      continue;
    }
    // the order changes: the trailing threshold update on the new order's
    // record, then the next step's records from its table
    L::store(rp, L::pack(cxt & mask, pos1, hits1, miss1, thr, byte1));
    const int no = down ? o - 1 : o + 1;
    uint8_t* const qp = rec<L>(tbl, no, lp);
    const Raw q = L::load(qp);
    L::store_thr(qp, L::with_thr(q, mix_threshold(L::thr(q), L::hits(q),
                                                  L::miss(q), match, bound,
                                                  no)));
    s.R = L::load(rec<L>(tbl, no, orig));
    s.P = L::load(rec<L>(tbl, no, (cxt1 >> (8 * no)) & 0xFF));
    s.fidx = kNone;
    s.order = no;
    if (O) {
      s.i = i + 1;
      return no;
    }
  }
  return 0;
}

// One span: len steps over src into dst, its tables at tbl and its
// predicted bytes at hist; kSolo: the span is alone in its warp.
template <class L, bool kDecode, bool kSolo>
__device__ __forceinline__ void walk(const uint8_t* __restrict__ src,
                                     uint8_t* __restrict__ dst, int len,
                                     uint8_t* tbl, uint8_t* hist,
                                     uint32_t ring_mask) {
  // steps 0-3 copy their byte: the run test reads empty records (no hits)
  // and lpx.cpp's table update is gated off while pos <= order (3)
  uint32_t cxt = 0;
  for (int i = 0; i < min(len, 4); ++i) {
    const uint32_t c = __ldg(src + i);
    dst[i] = uint8_t(c);
    hist[i] = uint8_t(c);
    cxt = (cxt << 8) | c;
  }
  if (len <= 4) return;
  Span<L> s;
  s.frec = L::init();
  s.R = L::load(rec<L>(tbl, 3, cxt & 0xFF));
  s.P = L::load(rec<L>(tbl, 3, cxt >> 24));
  s.cxt = cxt;
  s.fidx = kNone;
  s.run_dist = 1;  // keeps the prefetch of a run's next byte in the span
  s.ref_run = 0;
  s.c = __ldg(src + 4);
  s.i = 4;
  s.order = 3;
  s.in_run = false;
  if (!kSolo) {
    walk_order<L, kDecode, 0>(s, src, dst, len, tbl, hist, ring_mask);
    return;
  }
  int order = 3;
  while (order) {
    if (order == 3)
      order = walk_order<L, kDecode, 3>(s, src, dst, len, tbl, hist,
                                        ring_mask);
    else if (order == 2)
      order = walk_order<L, kDecode, 2>(s, src, dst, len, tbl, hist,
                                        ring_mask);
    else
      order = walk_order<L, kDecode, 1>(s, src, dst, len, tbl, hist,
                                        ring_mask);
  }
}

template <class L, bool kDecode, bool kSolo>
__global__ void __launch_bounds__(32 * kMaxWarps) lpx_walk_kernel(
    const uint8_t* __restrict__ in, const int32_t* __restrict__ starts,
    const int32_t* __restrict__ lens, int nspans, int max_len, int per_block,
    int lanes, int span_bytes, uint32_t ring_mask, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int first = blockIdx.x * per_block;
  const int here = min(per_block, nspans - first);
  for (int k = threadIdx.x; k < here * kRecords; k += blockDim.x)
    L::store(smem + (k / kRecords) * span_bytes +
                 (k % kRecords) * L::kBytes,
             L::init());
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int slot = (threadIdx.x >> 5) * lanes + lane;
  if (lane >= lanes || slot >= here) return;

  // the span's offset, opaque to the compiler: otherwise it rebuilds it
  // from threadIdx.x at every step
  uint32_t off = uint32_t(slot) * uint32_t(span_bytes);
  asm volatile("" : "+r"(off));
  uint8_t* tbl = smem + off;
  const int s = first + slot;
  // a span is cut at max_len, so a wrong max_len cannot write past the
  // span's own shared memory
  const int len = min(max(lens[s], 0), max_len);
  walk<L, kDecode, kSolo>(in + starts[s], out + starts[s], len, tbl,
                          tbl + kRecords * L::kBytes, ring_mask);
}

struct Shape {
  int nspans, max_len, per_block, lanes, span_bytes;
  uint32_t ring_mask;
};

template <class L, bool kDecode, bool kSolo>
cudaError_t launch(const uint8_t* in, const int32_t* starts,
                   const int32_t* lens, const Shape& sh, uint8_t* out,
                   cudaStream_t st) {
  auto kernel = lpx_walk_kernel<L, kDecode, kSolo>;
  const size_t smem = size_t(sh.per_block) * sh.span_bytes;
  cudaError_t err = jt_allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (sh.nspans + sh.per_block - 1) / sh.per_block;
  const int threads = 32 * ((sh.per_block + sh.lanes - 1) / sh.lanes);
  kernel<<<blocks, threads, smem, st>>>(in, starts, lens, sh.nspans,
                                        sh.max_len, sh.per_block, sh.lanes,
                                        sh.span_bytes, sh.ring_mask, out);
  return cudaGetLastError();
}

// A span is alone in its warp when a warp takes one span or a block holds
// one.
template <class L>
cudaError_t launch_as(bool decode, const uint8_t* in, const int32_t* starts,
                      const int32_t* lens, const Shape& sh, uint8_t* out,
                      cudaStream_t st) {
  const bool solo = sh.lanes == 1 || sh.per_block == 1;
  if (decode)
    return solo ? launch<L, true, true>(in, starts, lens, sh, out, st)
                : launch<L, true, false>(in, starts, lens, sh, out, st);
  return solo ? launch<L, false, true>(in, starts, lens, sh, out, st)
              : launch<L, false, false>(in, starts, lens, sh, out, st);
}

// The launch of every entry: `pad` records added to each span's shared
// memory, `lanes` spans a warp, eight-word records when `eight` or when
// four do not hold the span.
int walk_spans(const void* in, const void* starts, const void* lens,
               int nspans, int max_len, int decode, int pad, int lanes,
               bool eight, void* out, void* stream) {
  if (nspans <= 0 || max_len <= 0) return 0;
  if (pad < 0 || lanes < 1 || lanes > 32) return cudaErrorInvalidValue;
  eight = eight || max_len > Rec4::kMaxLen;
  const bool ring_mode = max_len > kRing;
  Shape sh;
  sh.nspans = nspans;
  sh.max_len = max_len;
  sh.lanes = lanes;
  sh.ring_mask = ring_mode ? uint32_t(kRing - 1) : ~0u;
  sh.span_bytes = kRecords * (eight ? Rec8::kBytes : Rec4::kBytes) +
                  (ring_mode ? kRing : (max_len + 15) & ~15) + 16 * pad;
  int dev = 0, optin = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int fit = optin / sh.span_bytes;
  if (fit < 1) return cudaErrorInvalidValue;
  const int spread = (nspans + sms - 1) / sms;
  sh.per_block = min(min(fit, 32), min(spread, kMaxWarps * lanes));
  auto* i = static_cast<const uint8_t*>(in);
  auto* s = static_cast<const int32_t*>(starts);
  auto* l = static_cast<const int32_t*>(lens);
  auto* o = static_cast<uint8_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  return eight ? launch_as<Rec8>(decode, i, s, l, sh, o, st)
               : launch_as<Rec4>(decode, i, s, l, sh, o, st);
}

}  // namespace

// in, out: (n,) uint8; starts, lens: (nspans,) int32, spans that do not
// overlap and lie inside the buffer; max_len: the longest span (a longer
// span is coded only up to max_len); decode: 0 = encode, 1 = decode.
// Four-word records up to 64 KiB, eight past it.  Bytes outside every span
// are not written.
JT_EXPORT int jt_lpx_walk(const void* in, const void* starts,
                          const void* lens, int nspans, int max_len,
                          int decode, void* out, void* stream) {
  return walk_spans(in, starts, lens, nspans, max_len, decode, kPad, kLanes,
                    max_len > kRing, out, stream);
}

// For measurement only: jt_lpx_walk with `pad` records of 16 bytes added
// to each span's shared memory (see Banks above), `lanes` spans a warp
// (1-32) and eight-word records when `wide`, else four where they hold
// the span (below 16 MiB).
JT_EXPORT int jt_lpx_walk_at(const void* in, const void* starts,
                             const void* lens, int nspans, int max_len,
                             int decode, int pad, int lanes, int wide,
                             void* out, void* stream) {
  return walk_spans(in, starts, lens, nspans, max_len, decode, pad, lanes,
                    wide != 0, out, stream);
}
