"""The native host engine, bound with ctypes.

src/ holds the JAX package's native engine, copied byte for byte: the
LZ77 stage (jn_lz.cpp: the m0 dedupe, m1 hash-chain and m2 suffix-array
finders, and the decoder; jn_sais.cpp, the suffix array), the entropy
stage and the checksum (jn_ans.cpp), Lpx and the filters (jn_stages.cpp),
the BWT both ways (jn_transform.cpp) and jn_common.hpp.  Its archives are
the byte contract.  g++ builds them, with that engine's flags, one process
a source, all started together, then one link, into
build/torch_native/libjamnative.so at first use; a digest of the sources
and flags sits beside it, and a changed source rebuilds.  Nothing builds
at import time, a failed build raises, and the first callers of load()
wait for one build.

The functions below are those of jampack_tpu/native/__init__.py, with the
same signatures; every entry point releases the GIL, so threads give
block-level parallelism.
"""

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
import time

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "src")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "torch_native")
LIB = os.path.join(BUILD_DIR, "libjamnative.so")
GXX_FLAGS = ["-std=c++17", "-O3", "-fPIC", "-fopenmp", "-march=native"]
_LOAD_LOCK = threading.Lock()


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
    digest = _digest()
    stamp = LIB + ".sha256"
    if os.path.exists(LIB) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == digest:
                return {"built": False, "seconds": 0.0}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.{threading.get_ident()}.tmp"
    srcs = [s for s in _sources() if s.endswith(".cpp")]
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(s)}.{tag}.o")
            for s in srcs]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(["g++", *GXX_FLAGS, "-c", "-o", obj, src],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(srcs, objs)]
    log = "".join(p.communicate()[0] for p in procs)
    failed = [os.path.basename(s) for s, p in zip(srcs, procs)
              if p.returncode != 0]
    tmp = f"{LIB}.{tag}"
    if not failed:
        res = subprocess.run(["g++", *GXX_FLAGS, "-shared", "-o", tmp, *objs],
                             capture_output=True, text=True)
        log += res.stdout + res.stderr
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError(f"g++ failed on {', '.join(failed)}:\n{log}")
    if res.returncode != 0:
        raise RuntimeError(f"g++ link failed ({res.returncode}):\n{log}")
    os.replace(tmp, LIB)
    with open(stamp + ".tmp", "w") as f:
        f.write(digest)
    os.replace(stamp + ".tmp", stamp)
    return {"built": True, "seconds": time.perf_counter() - t0}


def load() -> ctypes.CDLL:
    """The native library, built first when needed (once per process)."""
    with _LOAD_LOCK:
        return _load()


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    build()
    lib = ctypes.CDLL(LIB)
    u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
    c = ctypes.c_int32
    c64 = ctypes.c_int64
    for name, args, res in (
            ("jam_checksum", [u8p, c64], ctypes.c_uint32),
            ("jam_sais", [u8p, i32p, c], c),
            ("jam_bwt_forward_u", [u8p, c64, u8p, c], c64),
            ("jam_bwt_inverse_u", [u8p, c64, u8p, c, c], c64),
            ("jam_ans_encode_c", [u8p, c64, u8p, c64, c, c], c64),
            ("jam_ans_decode", [u8p, c64, u8p, c64, c, c], c64),
            ("jam_lpx_encode", [u8p, c64, u8p, c, c], c64),
            ("jam_lpx_decode", [u8p, c64, u8p, c, c], c64),
            ("jam_filters_encode", [u8p, c64, u8p, c, c], c64),
            ("jam_filters_decode", [u8p, c64, u8p], c64),
            ("jam_lz_encode", [u8p, c64, u8p, c], c64),
            ("jam_lz_decode", [u8p, c64, u8p, c64], c64)):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = res
    return lib


def _as_u8(data) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(data, dtype=np.uint8))


def checksum(data) -> int:
    """format/checksum.integrity_check in C++: the block checksum of the
    bytes of any bytes-like object or array, read in place where they are
    contiguous.  The fused paths' block CRC."""
    if isinstance(data, np.ndarray):
        a = np.ascontiguousarray(data).reshape(-1).view(np.uint8)
    else:
        a = np.frombuffer(memoryview(data), np.uint8)
    return int(load().jam_checksum(a, a.size))


def sais(data) -> np.ndarray:
    a = _as_u8(data)
    sa = np.empty(a.size, dtype=np.int32)
    if load().jam_sais(a, sa, a.size) != 0:
        raise RuntimeError("sais failed")
    return sa


def bwt_forward(data, units: int = 120) -> np.ndarray:
    a = _as_u8(data)
    out = np.empty(a.size + units * 4, dtype=np.uint8)
    n = load().jam_bwt_forward_u(a, a.size, out, units)
    if n != out.size:
        raise RuntimeError("BWT forward wrote a short stream")
    return out


def bwt_inverse(data, threads: int = 0, units: int = 120) -> np.ndarray:
    a = _as_u8(data)
    out = np.empty(max(a.size - units * 4, 0), dtype=np.uint8)
    n = load().jam_bwt_inverse_u(a, a.size, out, threads, units)
    if n < 0:
        raise ValueError("corrupt BWT stream")
    return out[:n]


def ans_encode(data, chunk: int = 0, lanes: int = 0) -> np.ndarray:
    a = _as_u8(data)
    cap = (a.size + (a.size >> 2) + 8192
           + 2048 * (a.size // max(chunk, 1) if chunk else 0)
           + 24 * max(lanes, 0) * (a.size // max(chunk or (1 << 20), 1) + 1))
    out = np.empty(cap, dtype=np.uint8)
    n = load().jam_ans_encode_c(a, a.size, out, cap, chunk, lanes)
    if n == -1:
        raise ValueError("model failure (CDF): chunk not encodable in ref-compat mode")
    if n < 0:
        raise ValueError("ans encode out of space")
    return out[:n]


def ans_decode(data, cap: int, threads: int = 0, lanes: int = 0) -> np.ndarray:
    a = _as_u8(data)
    out = np.empty(cap, dtype=np.uint8)
    n = load().jam_ans_decode(a, a.size, out, cap, threads, lanes)
    if n < 0:
        raise ValueError("invalid rANS state or corrupt chunk header")
    return out[:n]


def lpx_encode(data, threads: int = 0, spans: int = 4) -> np.ndarray:
    a = _as_u8(data)
    out = np.empty(a.size, dtype=np.uint8)
    load().jam_lpx_encode(a, a.size, out, threads, spans)
    return out


def lpx_decode(data, threads: int = 0, spans: int = 4) -> np.ndarray:
    a = _as_u8(data)
    out = np.empty(a.size, dtype=np.uint8)
    load().jam_lpx_decode(a, a.size, out, threads, spans)
    return out


def filters_encode(data, mode: int = 1, threads: int = 0) -> np.ndarray:
    a = _as_u8(data)
    nchunks = (a.size + (64 << 10) - 1) // (64 << 10)
    out = np.empty(a.size + 2 * max(nchunks, 1), dtype=np.uint8)
    n = load().jam_filters_encode(a, a.size, out, mode, threads)
    return out[:n]


def filters_decode(data) -> np.ndarray:
    a = _as_u8(data)
    out = np.empty(a.size, dtype=np.uint8)
    n = load().jam_filters_decode(a, a.size, out)
    if n < 0:
        raise ValueError("unsupported filter configuration")
    return out[:n]


def lz_encode(data, mode: int = 0) -> np.ndarray:
    """The LZ77 token stream of `data` by finder `mode` (0 dedupe, 1
    hash-chain, 2 and up suffix array), as the native engine writes it."""
    a = _as_u8(data)
    # worst case: no token accepted -> the end token, the raw bytes, headroom
    out = np.empty(a.size + (a.size >> 3) + 64, dtype=np.uint8)
    n = load().jam_lz_encode(a, a.size, out, mode)
    if n < 0:
        raise RuntimeError(f"LZ encode (mode {mode}) ran out of space")
    return out[:n]


def lz_decode(data, cap: int) -> np.ndarray:
    a = _as_u8(data)
    out = np.empty(cap, dtype=np.uint8)
    n = load().jam_lz_decode(a, a.size, out, cap)
    if n < 0:
        raise ValueError("invalid lz77 token stream")
    return out[:n]
