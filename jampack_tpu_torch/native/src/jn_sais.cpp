// Suffix-array construction via SA-IS (induced sorting of LMS substrings,
// Nong/Zhang/Chan 2009).  Fills the role the vendored divsufsort plays in
// the reference (bwt.cpp:41) with a different, linear-time algorithm; the
// output suffix array is identical by definition.
#include "jn_common.hpp"

namespace jpt {

namespace {

// T has values in [0, K); a virtual sentinel smaller than everything is
// assumed at position n.  SA receives the lexicographic suffix order.
template <typename Char>
void sais_core(const Char* T, i32* SA, i32 n, i32 K) {
  if (n == 0) return;
  if (n == 1) { SA[0] = 0; return; }

  // ts[i] = (T[i] << 1) | is_s[i]: ONE random load per induced element
  // where the textbook form pays two (type byte + text byte) — the induce
  // passes are cache-miss bound on exactly these loads.  u16 at the byte
  // level; recursion symbols can exceed 2^15 so those levels pack in u32.
  using TS = typename std::conditional<sizeof(Char) == 1, u16, u32>::type;
  std::vector<TS> ts(n);
  {
    u8 s = 0;  // last suffix is L-type vs the sentinel
    ts[n - 1] = TS(u32(T[n - 1]) << 1);
    for (i32 i = n - 2; i >= 0; i--) {
      s = (T[i] < T[i + 1]) || (T[i] == T[i + 1] && s);
      ts[i] = TS((u32(T[i]) << 1) | s);
    }
  }
  auto is_s_at = [&](i32 i) { return ts[i] & 1u; };
  auto is_lms = [&](i32 i) { return i > 0 && (ts[i] & 1u) && !(ts[i - 1] & 1u); };

  std::vector<i32> bkt(K), head(K), tail(K);
  for (i32 i = 0; i < n; i++) bkt[T[i]]++;
  auto reset_heads = [&] {
    i32 acc = 0;
    for (i32 c = 0; c < K; c++) { head[c] = acc; acc += bkt[c]; }
  };
  auto reset_tails = [&] {
    i32 acc = 0;
    for (i32 c = 0; c < K; c++) { acc += bkt[c]; tail[c] = acc; }
  };

  // The induce passes stream SA but hit ts[] at a random position per
  // element — a dependent cache miss that dominates the whole build.  The
  // NEXT few SA slots are already known (sequential read, and slots ahead
  // written earlier in the same pass stay visible), so prefetching
  // ts[SA[i+PD]-1] hides most of that latency.
  constexpr i32 PD = 32;  // measured sweep 16/32/64/96: 32 is ~7% faster
                          // than 16 on 8 MB text (DRAM latency ~ 30 iters)
  auto induce = [&] {
    // L-pass: seed with the predecessor of the sentinel suffix
    reset_heads();
    {
      u32 w = ts[n - 1];
      if (!(w & 1u)) SA[head[w >> 1]++] = n - 1;
    }
    for (i32 i = 0; i < n; i++) {
      if (i + PD < n) {
        i32 pf = SA[i + PD];
        if (pf > 0) __builtin_prefetch(&ts[pf - 1]);
      }
      i32 j = SA[i] - 1;
      if (SA[i] > 0) {
        u32 w = ts[j];
        if (!(w & 1u)) SA[head[w >> 1]++] = j;
      }
    }
    // S-pass
    reset_tails();
    for (i32 i = n - 1; i >= 0; i--) {
      if (i - PD >= 0) {
        i32 pf = SA[i - PD];
        if (pf > 0) __builtin_prefetch(&ts[pf - 1]);
      }
      i32 j = SA[i] - 1;
      if (SA[i] > 0) {
        u32 w = ts[j];
        if (w & 1u) SA[--tail[w >> 1]] = j;
      }
    }
  };

  // 1) place LMS suffixes at bucket tails (arbitrary order), induce once;
  // collect text-order LMS positions here too (step 3 reuses them, saving
  // a second full is_lms pass over ts)
  std::fill(SA, SA + n, -1);
  reset_tails();
  std::vector<i32> lms_pos;
  lms_pos.reserve(n / 3 + 1);
  for (i32 i = 1; i < n; i++)
    if (is_lms(i)) { SA[--tail[T[i]]] = i; lms_pos.push_back(i); }
  i32 n_lms = i32(lms_pos.size());
  induce();

  // 2) compact sorted LMS suffixes, name LMS substrings.  Adjacent LMS
  // positions are >= 2 apart, so names index by i >> 1 (half the array
  // and half the cache traffic of an n-sized table).
  std::vector<i32> lms_sorted;
  lms_sorted.reserve(n_lms);
  for (i32 i = 0; i < n; i++) {
    if (i + PD < n) {
      i32 pf = SA[i + PD];
      if (pf > 0) __builtin_prefetch(&ts[pf]);
    }
    if (SA[i] > 0 && is_lms(SA[i])) lms_sorted.push_back(SA[i]);
  }

  std::vector<i32> name_of((n >> 1) + 1, -1);
  i32 names = 0;
  i32 prev = -1;
  for (i32 idx = 0; idx < n_lms; idx++) {
    if (idx + 4 < n_lms) {
      __builtin_prefetch(&T[lms_sorted[idx + 4]]);
      __builtin_prefetch(&ts[lms_sorted[idx + 4]]);
      __builtin_prefetch(&name_of[lms_sorted[idx + 4] >> 1], 1);
    }
    i32 cur = lms_sorted[idx];
    bool same = false;
    if (prev >= 0) {
      same = true;
      for (i32 d = 0;; d++) {
        bool end_p = (prev + d == n) || (d > 0 && is_lms(prev + d));
        bool end_c = (cur + d == n) || (d > 0 && is_lms(cur + d));
        if (end_p && end_c) break;
        if (end_p != end_c || prev + d >= n || cur + d >= n ||
            T[prev + d] != T[cur + d]) { same = false; break; }
      }
    }
    if (!same) names++;
    name_of[cur >> 1] = names - 1;
    prev = cur;
  }

  // 3) build the reduced string in text order; recurse if names repeat.
  // u16 names halve the recursion's memory traffic when they fit.
  std::vector<i32> lms_order(n_lms);
  if (names < n_lms) {
    std::vector<i32> sub_sa(n_lms);
    if (names <= 0xFFFF) {
      std::vector<u16> reduced(n_lms);
      for (i32 i = 0; i < n_lms; i++) {
        if (i + PD < n_lms) __builtin_prefetch(&name_of[lms_pos[i + PD] >> 1]);
        reduced[i] = u16(name_of[lms_pos[i] >> 1]);
      }
      sais_core<u16>(reduced.data(), sub_sa.data(), n_lms, names);
    } else {
      std::vector<i32> reduced(n_lms);
      for (i32 i = 0; i < n_lms; i++) reduced[i] = name_of[lms_pos[i] >> 1];
      sais_core<i32>(reduced.data(), sub_sa.data(), n_lms, names);
    }
    for (i32 i = 0; i < n_lms; i++) {
      if (i + PD < n_lms) __builtin_prefetch(&lms_pos[sub_sa[i + PD]]);
      lms_order[i] = lms_pos[sub_sa[i]];
    }
  } else {
    for (i32 i = 0; i < n_lms; i++)
      lms_order[name_of[lms_pos[i] >> 1]] = lms_pos[i];
  }

  // 4) final induce from correctly ordered LMS suffixes
  std::fill(SA, SA + n, -1);
  reset_tails();
  for (i32 i = n_lms - 1; i >= 0; i--) {
    if (i - 8 >= 0) __builtin_prefetch(&T[lms_order[i - 8]]);
    SA[--tail[T[lms_order[i]]]] = lms_order[i];
  }
  induce();
}

}  // namespace

void suffix_array(const u8* t, i32* sa, i32 n) { sais_core<u8>(t, sa, n, 256); }

}  // namespace jpt

extern "C" int32_t jam_sais(const uint8_t* t, int32_t* sa, int32_t n) {
  if (n < 0) return -1;
  jpt::suffix_array(t, sa, n);
  return 0;
}
