"""Format-level constants of the Jampack block format (the port's copy of
jampack_tpu/format/constants.py; tests hold the two equal).

These values are format-visible: both the reference implementation and this
framework must agree on them bit-for-bit for archives to interoperate.

Reference: format.hpp:19-30, ans.hpp:21-29, tables.hpp:10-30,
lz77.hpp:35-40, filters.hpp:28-30, lpx.hpp:14-16.
"""

JAM_VERSION = 0.80

MAGIC = b"JAM"  # format.hpp:29

DEFAULT_BLOCKSIZE = 8 << 20  # format.hpp:20
MIN_BLOCKSIZE = 1 << 20  # format.hpp:21
MAX_BLOCKSIZE = 1000 << 20  # format.hpp:22

# Number of independent parallel units planted into each BWT block by the
# forward transform (format.hpp:26).  This is the reference-compatible value;
# the native stream layout of this framework treats the anchor count as a
# stream parameter (see kernels/ibwt.py) but defaults to this for interop.
BWT_UNITS = 120

# Entropy-coder chunking (ans.hpp:21): models reset every StackSize input
# bytes, which is what makes chunks independently decodable.
ANS_CHUNK_SIZE = 1 << 20

# Structured-symbol model split (ans.hpp:28-29).
MAX_MODELS = 8
MODEL_SWITCH_THRESHOLD = 2  # exponents 0..1 adaptive, 2..7 quasi-static

PROB_BITS = 16  # model.hpp:23,53
PROB_SCALE = 1 << PROB_BITS

RANS_BYTE_L = 1 << 23  # rans_byte.hpp:50

# LZ77 (lz77.hpp:35-40)
LZ_MIN_MATCH = 4
LZ_DUPE_MATCH = 256
LZ_TOKEN_BUFFER_SIZE = 1 << 16
LZ_HASH_BITS = 22
LZ_HASH_SIZE = 1 << LZ_HASH_BITS

# Filters (filters.hpp:28-30)
FILTER_MAX_TYPES = 3
FILTER_MAX_WIDTH = 32
FILTER_BLOCK_SIZE = 64 << 10

# Lpx local prefix model (lpx.hpp:14-16)
LPX_MAX_THRESHOLD = 128
LPX_MIN_THRESHOLD = 4
LPX_MAX_RECORD_SIZE = 64 << 10

GOLDEN_PRIME = 0x9E3779B1  # used by checksum, lz77 hashing, chhm hashing
