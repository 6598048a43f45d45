"""The LZ77 match finders on the host, bound with ctypes.

src/ holds the native engine's LZ stage (jn_lz.cpp: the m0 dedupe, m1
hash-chain and m2 suffix-array finders; jn_sais.cpp, the suffix array the
m2 finder walks; jn_common.hpp), copied byte for byte from the JAX
package's native engine, whose parse is the byte contract.  g++ builds
them, with that engine's flags, into build/torch_native/libjamlz.so at
first use; a digest of the sources and flags sits beside it, and a
changed source rebuilds.  Nothing builds at import time, and a failed
build raises.
"""

import ctypes
import functools
import hashlib
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "src")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "torch_native")
LIB = os.path.join(BUILD_DIR, "libjamlz.so")
GXX_FLAGS = ["-std=c++17", "-O3", "-fPIC", "-shared", "-fopenmp",
             "-march=native"]


def _sources():
    return sorted(os.path.join(SRC, f) for f in os.listdir(SRC)
                  if f.endswith((".cpp", ".hpp")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def build() -> dict:
    """Compile the library unless it matches the sources.  Returns
    {"built": bool, "seconds": float}; raises RuntimeError when g++
    fails."""
    import time

    digest = _digest()
    stamp = LIB + ".sha256"
    if os.path.exists(LIB) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == digest:
                return {"built": False, "seconds": 0.0}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB}.{os.getpid()}.tmp"
    srcs = [s for s in _sources() if s.endswith(".cpp")]
    t0 = time.perf_counter()
    res = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, *srcs],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed ({res.returncode}) on the LZ "
                           f"sources:\n{res.stdout}{res.stderr}")
    os.replace(tmp, LIB)
    with open(stamp + ".tmp", "w") as f:
        f.write(digest)
    os.replace(stamp + ".tmp", stamp)
    return {"built": True, "seconds": time.perf_counter() - t0}


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The LZ library, built first when needed (once per process)."""
    build()
    lib = ctypes.CDLL(LIB)
    u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
    lib.jam_lz_encode.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int32]
    lib.jam_lz_encode.restype = ctypes.c_int64
    return lib


def lz_encode(data, mode: int) -> np.ndarray:
    """The LZ77 token stream of `data` by finder `mode` (0 dedupe, 1
    hash-chain, 2 and up suffix array), as the native engine writes it."""
    a = np.ascontiguousarray(np.asarray(data, dtype=np.uint8))
    # worst case: no token accepted -> the end token, the raw bytes, headroom
    out = np.empty(a.size + (a.size >> 3) + 64, dtype=np.uint8)
    n = load().jam_lz_encode(a, a.size, out, mode)
    if n < 0:
        raise RuntimeError(f"LZ encode (mode {mode}) ran out of space")
    return out[:n]
