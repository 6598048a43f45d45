"""Prose: words of a fixed vocabulary drawn with Zipf frequencies.

A stand-in for the Silesia corpus's dickens and webster (Deorowicz),
which cannot be fetched here.  The vocabulary comes from `layout`, the
same for every seed, and the run's seed draws the words.  Its word
lengths come from a Poisson law and its letters from English letter
frequencies; the words are ranked by length plus Gaussian jitter, so the
most frequent tend to be the shortest, as in English (Zipf's law of
abbreviation).  Each word is followed by one separator: a space, a comma
and a space, a period and a space, or a line break.  Every number is a
parameter of the traffic file (`params`)."""

import numpy as np

# English letter frequencies, a..z, in percent (Lewand, Cryptological
# Mathematics, 2000)
LETTERS = np.array([8.167, 1.492, 2.782, 4.253, 12.702, 2.228, 2.015, 6.094,
                    6.966, 0.153, 0.772, 4.025, 2.406, 6.749, 7.507, 1.929,
                    0.095, 5.987, 6.327, 9.056, 2.758, 0.978, 2.360, 0.150,
                    1.974, 0.074])
SEPARATORS = (b" ", b", ", b". ", b"\n")


def _pieces(words, separators):
    """(flat bytes, offsets, lengths) of a list of byte strings."""
    pieces = list(words) + list(separators)
    lens = np.array([len(p) for p in pieces], np.int64)
    offs = np.cumsum(lens) - lens
    return np.frombuffer(b"".join(pieces), np.uint8), offs, lens


def _gather(flat, offs, lens, ids) -> np.ndarray:
    """The pieces `ids` of (flat, offs, lens), joined."""
    size = lens[ids]
    starts = np.cumsum(size) - size
    return flat[np.repeat(offs[ids] - starts, size) + np.arange(size.sum())]


def generate(n: int, rng: np.random.Generator, layout: np.random.Generator,
             *, vocab: int, exponent: float, mean_word_letters: float,
             length_jitter: float, separator_shares: list) -> np.ndarray:
    words = {}
    while len(words) < vocab:  # distinct words, as a vocabulary's are
        lens = 1 + layout.poisson(mean_word_letters - 1, vocab)
        letters = (layout.choice(26, int(lens.sum()),
                                 p=LETTERS / LETTERS.sum())
                   + ord("a")).astype(np.uint8).tobytes()
        ends = np.cumsum(lens)
        words.update(dict.fromkeys(letters[e - k:e] for e, k in
                                   zip(ends.tolist(), lens.tolist())))
    words = list(words)[:vocab]
    lens = np.array([len(w) for w in words])
    rank = np.argsort(lens + layout.normal(0, length_jitter, vocab))
    flat, offs, lens = _pieces([words[i] for i in rank], SEPARATORS)
    p = 1.0 / np.arange(1, vocab + 1) ** exponent
    shares = np.asarray(separator_shares, float)
    out = np.zeros(0, np.uint8)
    count = n // 4 + 16
    while out.size < n:
        ids = np.empty(2 * count, np.int64)
        ids[0::2] = rng.choice(vocab, count, p=p / p.sum())
        ids[1::2] = vocab + rng.choice(len(SEPARATORS), count,
                                       p=shares / shares.sum())
        out = np.concatenate([out, _gather(flat, offs, lens, ids)])
    return out[:n].copy()
