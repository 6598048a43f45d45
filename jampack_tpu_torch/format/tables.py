"""Exponent/log/mantissa lookup tables for the structured entropy coder.

The 16-bit post-RLE0 symbol alphabet (0..256) is split into an exponent class
(8 classes with boundaries {0,2,4,8,16,32,64,128,257}) and a mantissa within
the class.  Generated programmatically rather than spelled out; values are
identical to the reference LUTs (reference: tables.hpp:10-30).
"""

import numpy as np

# Class boundaries: class e covers symbols [EXPONENT[e], EXPONENT[e+1]).
EXPONENT = np.array([0, 2, 4, 8, 16, 32, 64, 128, 257], dtype=np.int32)

_sym = np.arange(257, dtype=np.int32)
# LOG[s] = e such that EXPONENT[e] <= s < EXPONENT[e+1]
LOG = (np.searchsorted(EXPONENT, _sym, side="right") - 1).astype(np.int32)
MANTISSA = (_sym - EXPONENT[LOG]).astype(np.int32)

# Alphabet size of the mantissa model for each exponent class.
MODEL_ALPHABET = (EXPONENT[1:] - EXPONENT[:-1]).astype(np.int32)


def sym_to_exp_mant(sym):
    """Split 16-bit structured symbol(s) into (exponent, mantissa)."""
    return LOG[sym], MANTISSA[sym]


def exp_mant_to_sym(e, m):
    """Rebuild the structured symbol from exponent class and mantissa."""
    return EXPONENT[e] + m
