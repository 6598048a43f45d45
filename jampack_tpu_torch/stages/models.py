"""Adaptive and quasi-static CDF models for the structured rANS coder.

AdaptiveModel: the CDF is mixed toward a per-symbol target table after every
symbol, `CumFreqs[i] += (Mix[sym][i] - CumFreqs[i]) >> 5` (arithmetic shift).
QuasiModel: frequency counts accumulate and the whole table is rescaled
(scale-down, +1 floor, stretch to 2^16, remainder folded into symbol 0)
every EXP symbols, EXP doubling 8 -> 64K.

Both are replicated with exact int32 semantics; they are the decode-time
contract of the format (no tables are transmitted — encoder and decoder must
adapt identically).

Reference behavior: model.cpp:11-235, model.hpp:23-57.
"""

import numpy as np

from ..format.constants import PROB_BITS, PROB_SCALE

RATE = 5  # model.hpp:34
UPDATE_RATE = 64 << 10  # model.hpp:46


class AdaptiveModel:
    __slots__ = ("alpha", "mix", "cum_freqs")

    def __init__(self, alpha: int):
        if alpha <= 0:
            raise ValueError("alphabet size must be at least 1")
        self.alpha = alpha
        # Mixing target rows: row[sym][state], state 0..alpha.
        rows = np.ones((alpha, alpha + 1), dtype=np.int64)
        rows[:, 0] = 0
        for sym in range(alpha):
            rows[sym, sym + 1] += PROB_SCALE - alpha  # rm jump at state==sym
        self.mix = np.cumsum(rows, axis=1).astype(np.int32)
        self.cum_freqs = np.zeros(alpha + 1, dtype=np.int32)

    def reset(self):
        scale = PROB_SCALE // self.alpha
        freqs = np.full(self.alpha, scale, dtype=np.int32)
        freqs[0] += PROB_SCALE - scale * self.alpha
        self.cum_freqs[0] = 0
        np.cumsum(freqs, out=self.cum_freqs[1:])

    def sym_to_low(self, sym: int) -> int:
        return int(self.cum_freqs[sym])

    def sym_to_freq(self, sym: int) -> int:
        return int(self.cum_freqs[sym + 1] - self.cum_freqs[sym])

    def range_to_sym(self, rng: int) -> int:
        # equivalent to the reference's first-match linear scan
        return int(np.searchsorted(self.cum_freqs, rng, side="right")) - 1

    def update(self, sym: int):
        cf = self.cum_freqs
        cf[1 : self.alpha] += (self.mix[sym, 1 : self.alpha] - cf[1 : self.alpha]) >> RATE


class QuasiModel:
    __slots__ = ("alpha", "freqs", "cum_freqs", "range_to_symbol", "seen", "exp")

    def __init__(self, alpha: int):
        if alpha <= 0:
            raise ValueError("alphabet size must be at least 1")
        self.alpha = alpha
        self.freqs = np.zeros(alpha, dtype=np.int32)
        self.cum_freqs = np.zeros(alpha + 1, dtype=np.int32)
        self.range_to_symbol = np.zeros(PROB_SCALE, dtype=np.uint16)
        self.seen = 0
        self.exp = 8

    def _rebuild_luts(self):
        self.cum_freqs[0] = 0
        np.cumsum(self.freqs, out=self.cum_freqs[1:])
        assert self.cum_freqs[self.alpha] == PROB_SCALE
        self.range_to_symbol = np.repeat(
            np.arange(self.alpha, dtype=np.uint16), self.freqs
        )

    def reset(self):
        self.seen = 0
        self.exp = 8
        scale = PROB_SCALE // self.alpha
        self.freqs[:] = scale
        self.freqs[0] += PROB_SCALE - scale * self.alpha
        self._rebuild_luts()
        self.freqs[:] = 0

    def sym_to_low(self, sym: int) -> int:
        return int(self.cum_freqs[sym])

    def sym_to_freq(self, sym: int) -> int:
        return int(self.cum_freqs[sym + 1] - self.cum_freqs[sym])

    def range_to_sym(self, rng: int) -> int:
        return int(self.range_to_symbol[rng])

    def update(self, sym: int):
        self.freqs[sym] += PROB_BITS
        self.seen += 1
        if self.seen > self.exp:
            total = int(self.freqs.sum())
            log = 0
            while ((total >> log) + self.alpha) > PROB_SCALE:
                log += 1
            f = (self.freqs >> log) + 1
            total = int(f.sum())
            # Stretch up (model.cpp:183): ProbScale is unsigned int in the
            # reference, so ProbScale * Freqs[i] / Total is UNSIGNED 32-bit
            # arithmetic — and since every scaled f <= ProbScale - alpha + 1,
            # the product never exceeds 2^32: plain exact integer math.
            # Every stretched frequency is >= 1 (f >= 1, total <= ProbScale).
            q = (f.astype(np.int64) << PROB_BITS) // total
            f = q.astype(np.int32)
            f[0] += PROB_SCALE - int(f.sum())
            self.freqs = f
            self._rebuild_luts()
            self.freqs = np.zeros(self.alpha, dtype=np.int32)
            self.seen = 0
            self.exp = self.exp << 1 if self.exp < UPDATE_RATE else UPDATE_RATE
