// Lpx localized prefix model and the delta/LPC/inline-delta filter stage.
// Stream-exact with lpx.cpp:11-170 and filters.cpp:21-490; the -f1/-f2
// entropy scoring replicates the reference's LUT-based estimators closely
// enough to pick the same configurations on real data (selection is
// encoder-side freedom; the emitted (type,width) headers are the format).
#include <omp.h>

#include <cmath>

#include "jn_common.hpp"

namespace jpt {

// ================= Lpx =================
namespace lpx {

constexpr int kMaxThreshold = 128;
constexpr int kMinThreshold = 4;
constexpr u32 kMaxRecord = 64 << 10;

struct Record {
  u32 cxt = 0, pos = 0, hits = 0, miss = 0;
  i32 threshold = kMaxThreshold >> 1;
};

struct Tables {
  std::vector<Record> t[3];
  Tables() { for (auto& v : t) v.assign(256, Record()); }
};

static inline void update(Tables& tb, u32 cxt, u32 pos, u8* order) {
  u8 o = *order;
  u32 lp = (cxt >> (o * 8)) & 0xFF;
  u32 ls = cxt & ((1u << (o * 8)) - 1);
  Record& r = tb.t[o - 1][lp];
  i32 distance = i32(pos - r.pos);

  i32 upper;
  if (r.hits < u32(kMaxThreshold))
    upper = distance > kMinThreshold ? distance : kMinThreshold;
  else {
    i32 a = distance >> o, b = kMaxThreshold >> o;
    upper = a < b ? a : b;
  }
  i32 bound = (distance <= kMinThreshold)
                  ? kMinThreshold
                  : (distance > upper ? upper : distance);

  // The reference re-dereferences *order at every use (lpx.cpp:29-52):
  // after order changes, the trailing threshold update reads/writes the
  // NEW order's record for the same leading prefix, shifted by the new
  // order.  Replicated exactly.
  if (pos > o) {
    if (r.cxt == ls) {
      r.pos = pos - o;
      r.hits++;
      r.miss = 0;
      if (r.hits > u32((r.threshold << o) << 3) && o > 1 && o <= 3) (*order)--;
      u8 on = *order;
      Record& rn = tb.t[on - 1][lp];
      if (rn.hits > u32(rn.threshold << 1) && rn.miss == 0)
        rn.threshold += (bound - rn.threshold) >> on;
    } else {
      r.hits >>= 2;
      r.miss++;
      r.cxt = ls;
      if (r.miss > u32(r.threshold * r.threshold * o) && o >= 1 && o < 3)
        (*order)++;
      u8 on = *order;
      Record& rn = tb.t[on - 1][lp];
      if (rn.miss > u32(rn.threshold))
        rn.threshold += (kMaxThreshold - rn.threshold) >> (4 - on);
    }
  }
}

template <bool kDecode>
static void code_block(const u8* in, u8* out, i32 len) {
  Tables tb;
  u32 cxt = 0;
  u8 order = 3;
  const u8* orig = kDecode ? out : in;  // prediction source
  i32 i = 0;
  while (i < len) {
    Record& r = tb.t[order - 1][cxt & 0xFF];
    u32 dist = u32(i) - r.pos;
    if (r.hits > u32(r.threshold) && dist < kMaxRecord) {
      u8 err;
      do {
        if (kDecode) {
          err = in[i];
          out[i] = orig[i - dist] ^ err;
        } else {
          err = orig[i - dist] ^ in[i];
          out[i] = err;
        }
        update(tb, cxt, i, &order);
        cxt = (cxt << 8) | orig[i];
        i++;
      } while (err == 0 && i < len);
    } else {
      out[i] = in[i];
      update(tb, cxt, i, &order);
      cxt = (cxt << 8) | out[i];
      i++;
    }
  }
}

template <bool kDecode>
static void run(const u8* in, u8* out, i64 n, int threads, i32 spans) {
  if (spans < 1) spans = 4;
  i64 span = n / spans;
  if (span == 0) {
    if (n > 0) code_block<kDecode>(in, out, i32(n));
    return;
  }
  struct Piece { i64 off, len; };
  std::vector<Piece> pieces;
  for (i64 i = 0; i < n; i += span) {
    i64 len = ((i + span) < n) ? span : (n - i);
    pieces.push_back({i, len});
  }
#pragma omp parallel for num_threads(threads > 0 ? threads : omp_get_max_threads())
  for (i64 k = 0; k < i64(pieces.size()); k++)
    code_block<kDecode>(in + pieces[k].off, out + pieces[k].off,
                        i32(pieces[k].len));
}

}  // namespace lpx

// ================= filters =================
namespace filt {

constexpr int kTypes = 3;

static void delta_enc(u8* b, i32 n) {
  u8 prev = 0;
  for (i32 i = 0; i < n; i++) {
    u8 cur = b[i];
    b[i] = cur - prev;
    prev = cur;
  }
}
static void delta_dec(u8* b, i32 n) {
  u8 prev = 0;
  for (i32 i = 0; i < n; i++) prev = b[i] += prev;
}

static void lpc_enc(u8* b, i32 n) {
  i32 w = 0;
  u8 p1 = 0, p2 = 0;
  for (i32 i = 0; i < n; i++) {
    u8 cur = b[i];
    u8 err = u8(w + (((i32(p1) - i32(p2)) + i32(p1)) - i32(cur)));
    b[i] = err;
    w += (err - w) >> 6;
    p2 = p1;
    p1 = cur;
  }
}
static void lpc_dec(u8* b, i32 n) {
  i32 w = 0;
  u8 p1 = 0, p2 = 0;
  for (i32 i = 0; i < n; i++) {
    u8 err = b[i];
    u8 cur = u8(w + (((i32(p1) - i32(p2)) + i32(p1)) - i32(err)));
    b[i] = cur;
    w += (err - w) >> 6;
    p2 = p1;
    p1 = cur;
  }
}

static void reorder(const u8* in, u8* out, int width, i32 n) {
  i32 pos = 0;
  for (int i = 0; i < width; i++)
    for (i32 j = i; j < n; j += width) out[pos++] = in[j];
}
static void unreorder(const u8* in, u8* out, int width, i32 n) {
  i32 pos = 0;
  for (int i = 0; i < width; i++)
    for (i32 j = i; j < n; j += width) out[j] = in[pos++];
}

static void inline_delta(const u8* in, u8* out, int width, i32 n) {
  u8 p[kMaxWidth] = {0};
  i32 i = 0, align = n % width;
  for (; i < align; i++) out[i] = in[i];
  while (i < n) {
    for (int j = 0; j < width; j++) {
      out[i + j] = in[i + j] - p[j];
      p[j] = in[i + j];
    }
    i += width;
  }
}
static void inline_undelta(const u8* in, u8* out, int width, i32 n) {
  u8 p[kMaxWidth] = {0};
  i32 i = 0, align = n % width;
  for (; i < align; i++) out[i] = in[i];
  while (i < n) {
    for (int j = 0; j < width; j++) {
      out[i + j] = in[i + j] + p[j];
      p[j] = out[i + j];
    }
    i += width;
  }
}

// entropy estimators (utils.cpp:92-202 semantics, shared log LUT)
struct EntLut {
  std::vector<double> lg;
  EntLut() : lg(1 << 16, 0.0) {
    for (int i = 1; i < (1 << 16); i++)
      lg[i] = -std::log(double(i) / (1 << 16)) / std::log(2.0);
  }
};
static const EntLut kEnt;

// p == 1.0 would index one past the LUT; its entropy contribution is 0.
// (The reference reads EntLog[EntScale] out of bounds there, utils.cpp:158
// with utils.hpp:25 — UB, so its filter choice on single-symbol chunks is
// unstable; we define the estimator deterministically instead.)
static inline double ent_term(i64 f, i64 total) {
  int pi = int((double(f) / double(total)) * (1 << 16));
  return (pi >= (1 << 16)) ? 0.0 : kEnt.lg[pi] * double(f);
}

static double entropy_o0(const u8* p, i32 len) {
  i64 freqs[256] = {0};
  for (i32 i = 0; i < len; i++) freqs[p[i]]++;
  double e = 0;
  for (int i = 0; i < 256; i++) e += ent_term(freqs[i], len);
  return e / double(len);
}

static double entropy_o1(const u8* p, i32 len) {
  // the 512 KB joint table is reused across calls and re-zeroed only on
  // rows that were touched (rows j with total[j] > 0) — allocating and
  // zeroing it per 64 KB chunk dominated the -f1 sweep
  static thread_local std::vector<i64> freqs(256 * 256, 0);
  i64 total[256] = {0};
  int j = 0;
  for (i32 i = 0; i < len; i++) {
    freqs[j * 256 + p[i]]++;
    total[j]++;
    j = p[i];
  }
  double e = 0;
  for (j = 0; j < 256; j++) {
    if (!total[j]) continue;
    for (int i = 0; i < 256; i++) {
      i64 f = freqs[j * 256 + i];
      if (!f) continue;
      e += ent_term(f, total[j]);
    }
    memset(&freqs[j * 256], 0, 256 * sizeof(i64));
  }
  return e / double(len);
}

static double entropy_mixed(const u8* p, i32 len) {
  return (entropy_o0(p, len) + entropy_o1(p, len)) / 2;
}

static double entropy_sorted(const u8* p, i32 len) {
  std::vector<u8> sbuf(len);
  i32 bucket[257] = {0};
  for (i32 i = 0; i < len; i++) bucket[p[i] + 1]++;
  for (i32 i = 1; i < 256; ++i) bucket[i] += bucket[i - 1];
  for (i32 i = 0; i < len; i++)
    sbuf[bucket[p[i]]++] = p[i ? i - 1 : len - 1];  // no per-byte modulo
  return entropy_o1(sbuf.data(), len);
}

static int find_stride(const u8* in, i32 len) {
  i64 dist[256] = {0};
  i64 hist[kMaxWidth + 1] = {0};
  for (i32 i = 0; i < len; i++) {
    u8 sym = in[i];
    i64 stride = i - dist[sym];
    dist[sym] = i;
    hist[stride % (kMaxWidth + 1)]++;
  }
  i64 average = 0;
  for (int j = 0; j <= kMaxWidth; j++) average += hist[j];
  average /= (kMaxWidth + 1);
  int smallest = 0;
  double mn = double(hist[0]);
  for (int j = 1; j <= kMaxWidth; j++)
    if (hist[j] > average * 2 && hist[j] > mn) {
      mn = double(hist[j]);
      smallest = j;
    }
  return smallest;
}

static int find_projection(const u8* in, i32 len) {
  i64 dist0[256] = {0}, dist1[256] = {0};
  i64 hist[kMaxWidth + 1] = {0};
  for (i32 i = 0; i < len; i++) {
    u8 sym = in[i];
    i64 stride = i - dist0[sym];
    i64 projection = i - dist1[stride % 256];
    dist1[stride % 256] = i;
    dist0[sym] = i;
    hist[projection % (kMaxWidth + 1)]++;
  }
  i64 average = 0;
  for (int j = 0; j <= kMaxWidth; j++) average += hist[j];
  average /= (kMaxWidth + 1);
  int smallest = 0;
  double mn = double(hist[0]);
  for (int j = 1; j <= kMaxWidth; j++)
    if (hist[j] > average * 2 && hist[j] > mn) {
      mn = double(hist[j]);
      smallest = j;
    }
  return smallest;
}

static void apply(const u8* in, u8* buf, int type, int width, i32 len) {
  switch (type) {
    case 0:
      reorder(in, buf, width, len);
      delta_enc(buf, len);
      break;
    case 1:
      reorder(in, buf, width, len);
      lpc_enc(buf, len);
      break;
    case 2:
      inline_delta(in, buf, width, len);
      break;
  }
}

static i64 encode(const u8* in, i64 n, u8* out, int mode, int threads) {
  if (mode < 0) mode = 0;
  if (mode > 2) mode = 2;
  i64 op = 0;
  int prev_type = 0, prev_width = 0;
  std::vector<u8> buf(kFilterChunk);
  for (i64 i = 0; i < n;) {
    i32 len = i32(((i + kFilterChunk) < n) ? kFilterChunk : (n - i));
    double scores[kTypes][kMaxWidth + 1];
    for (int t = 0; t < kTypes; t++)
      for (int w = 0; w <= kMaxWidth; w++) scores[t][w] = 8.0f;

    if (mode == 2) {
#pragma omp parallel for num_threads(threads > 0 ? threads : omp_get_max_threads()) schedule(dynamic)
      for (int ch = 0; ch <= kMaxWidth; ch++) {
        if (ch == 0) {
          scores[0][0] = entropy_mixed(in + i, len);
          continue;
        }
        std::vector<u8> d(kFilterChunk), l(kFilterChunk), b(kFilterChunk);
        reorder(in + i, d.data(), ch, len);
        memcpy(l.data(), d.data(), len);
        delta_enc(d.data(), len);
        lpc_enc(l.data(), len);
        inline_delta(in + i, b.data(), ch, len);
        scores[0][ch] = entropy_mixed(d.data(), len);
        scores[1][ch] = entropy_mixed(l.data(), len);
        scores[2][ch] = entropy_mixed(b.data(), len);
      }
    } else if (mode == 1) {
      double pconfig = 8.0f;
      // sections 2 and 4 both need the stride; compute it once up front
      // (identical inputs -> identical result, so scores are unchanged)
      const int stride_ch = find_stride(in + i, len);
#pragma omp parallel sections num_threads(threads > 0 ? threads : omp_get_max_threads())
      {
#pragma omp section
        { scores[0][0] = entropy_sorted(in + i, len); }
#pragma omp section
        {
          int ch = stride_ch;
          if (ch > 0) {
            std::vector<u8> d(kFilterChunk);
            reorder(in + i, d.data(), ch, len);
            delta_enc(d.data(), len);
            scores[0][ch] = entropy_sorted(d.data(), len);
          }
        }
#pragma omp section
        {
          int ch = find_projection(in + i, len);
          if (ch > 0) {
            std::vector<u8> l(kFilterChunk);
            reorder(in + i, l.data(), ch, len);
            lpc_enc(l.data(), len);
            scores[1][ch] = entropy_sorted(l.data(), len);
          }
        }
#pragma omp section
        {
          int ch = stride_ch;
          if (ch > 0) {
            std::vector<u8> b(kFilterChunk);
            inline_delta(in + i, b.data(), ch, len);
            scores[2][ch] = entropy_sorted(b.data(), len);
          }
        }
#pragma omp section
        {
          std::vector<u8> pb(kFilterChunk, 0);
          if (prev_width > 0) reorder(in + i, pb.data(), prev_width, len);
          if (prev_type)
            lpc_enc(pb.data(), len);
          else
            delta_enc(pb.data(), len);
          pconfig = entropy_sorted(pb.data(), len);
        }
      }
      if (scores[prev_type][prev_width] == 8.0f)
        scores[prev_type][prev_width] = pconfig;
    }

    int best_t = 0, best_w = 0;
    double mn = scores[0][0];
    for (int t = 0; t < kTypes; t++)
      for (int w = 1; w <= kMaxWidth; w++)
        if (scores[t][w] < mn) {
          mn = scores[t][w];
          best_t = t;
          best_w = w;
        }

    if (best_w > 0) {
      apply(in + i, buf.data(), best_t, best_w, len);
      out[op++] = u8(best_t);
      out[op++] = u8(best_w);
      memcpy(out + op, buf.data(), len);
    } else {
      out[op++] = 0;
      out[op++] = 0;
      memcpy(out + op, in + i, len);
    }
    prev_type = best_t;
    prev_width = best_w;
    op += len;
    i += len;
  }
  return op;
}

static i64 decode(const u8* in, i64 n, u8* out) {
  std::vector<u8> buf(kFilterChunk);
  i64 op = 0;
  for (i64 i = 0; i < n;) {
    u8 type = in[i++];
    u8 width = in[i++];
    if (type >= kTypes || width > kMaxWidth) return -1;
    i32 len = i32(((i + kFilterChunk) < n) ? kFilterChunk : (n - i));
    if (width > 0) {
      switch (type) {
        case 0:
          memcpy(buf.data(), in + i, len);
          delta_dec(buf.data(), len);
          unreorder(buf.data(), out + op, width, len);
          break;
        case 1:
          memcpy(buf.data(), in + i, len);
          lpc_dec(buf.data(), len);
          unreorder(buf.data(), out + op, width, len);
          break;
        case 2:
          inline_undelta(in + i, out + op, width, len);
          break;
      }
    } else {
      memcpy(out + op, in + i, len);
    }
    op += len;
    i += len;
  }
  return op;
}

}  // namespace filt
}  // namespace jpt

extern "C" {

// spans: Lpx sub-block count — 4 for reference-compatible streams
// (lpx.cpp:150-169); a JTX/JT3 stream parameter otherwise (model state
// resets per span, so span count scales intra-block decode parallelism)
int64_t jam_lpx_encode(const uint8_t* in, int64_t n, uint8_t* out,
                       int32_t threads, int32_t spans) {
  jpt::lpx::run<false>(in, out, n, threads, spans);
  return n;
}

int64_t jam_lpx_decode(const uint8_t* in, int64_t n, uint8_t* out,
                       int32_t threads, int32_t spans) {
  jpt::lpx::run<true>(in, out, n, threads, spans);
  return n;
}

int64_t jam_filters_encode(const uint8_t* in, int64_t n, uint8_t* out,
                           int32_t mode, int32_t threads) {
  return jpt::filt::encode(in, n, out, mode, threads);
}

int64_t jam_filters_decode(const uint8_t* in, int64_t n, uint8_t* out) {
  return jpt::filt::decode(in, n, out);
}
}
