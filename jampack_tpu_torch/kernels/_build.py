"""Build and bind the hand-written CUDA kernels.

Every source under csrc/ compiles with its own nvcc, all started together,
and the objects link into one shared library with a plain C interface,
build/torch_kernels/libjamtorch.so, at first use.  A digest of the sources
sits beside it; a changed source rebuilds.  The
library is bound with ctypes: pointers and the stream go as c_void_p (a
plain int would be cut to 32 bits).  Nothing here runs at import time, so
the CPU tests can import every module of the package.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
LIB = os.path.join(BUILD_DIR, "libjamtorch.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_SIGNATURES = {
    "jt_rans_decode": [_P, _I64, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                       _P, _P],
    "jt_rank_decode": [_P, _I, _P, _P, _I, _I, _P, _P, _P],
    "jt_ibwt_chase": [_P, _P, _P, ctypes.c_int32, _I, ctypes.c_int32, _P, _P,
                      _P, _P],
    "jt_ibwt_chase_at": [_P, _P, _P, ctypes.c_int32, _I, ctypes.c_int32, _I,
                         _P, _P, _P, _I, _P],
    "jt_model_pairs": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "jt_rans_encode": [_P, _P, _P, _I, _I, _P, _P, _P],
    "jt_rans_encode_at": [_P, _P, _P, _I, _I, _I, _P, _P, _P],
    "jt_rans_divmod": [_P, _P, _I64, _P, _P, _P],
    "jt_rank_encode": [_P, _I64, _P, _I, _P, _P, _P],
    "jt_joint_hist": [_P, _I64, _P, _I, _P, _P],
    "jt_lpc": [_P, _I64, _P, _I, _I, _P, _P],
    "jt_block_scatter": [_P, _P, _I, _I64, _P, _P],
    "jt_lpx_walk": [_P, _P, _P, _I, _I, _I, _P, _P],
    "jt_lpx_walk_at": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
    "jt_lz_parse": [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    "jt_lz_parse_chain": [_P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                          _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "jt_lz_parse_chain_at": [_P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                             _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "jt_rank_decode_staged": [_I],
    "jt_rank_encode_staged": [_I64],
    "jt_set_device": [_I],
}


def _sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def build() -> dict:
    """Compile the kernels unless the library matches the sources.  Returns
    {"built": bool, "seconds": float, "log": nvcc's ptxas report}."""
    digest = _digest()
    stamp = LIB + ".sha256"
    log_path = os.path.join(BUILD_DIR, "build.log")
    if os.path.exists(LIB) and os.path.exists(stamp):
        with open(stamp) as f:
            current = f.read().strip() == digest
        if current:
            log = ""
            if os.path.exists(log_path):
                with open(log_path) as f:
                    log = f.read()
            return {"built": False, "seconds": 0.0, "log": log}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    srcs = [src for src in _sources() if src.endswith(".cu")]
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
            for src in srcs]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(srcs, objs)]
    outs = [p.communicate()[0] for p in procs]
    log = "".join(outs)
    failed = [os.path.basename(src) for src, p in zip(srcs, procs)
              if p.returncode != 0]
    tmp = f"{LIB}.{tag}"
    if not failed:
        res = subprocess.run(
            [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", tmp, *objs],
            capture_output=True, text=True)
        log += res.stdout + res.stderr
    seconds = time.perf_counter() - t0
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{log}")
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{log}")
    os.replace(tmp, LIB)
    with open(stamp + ".tmp", "w") as f:
        f.write(digest)
    os.replace(stamp + ".tmp", stamp)
    with open(log_path, "w") as f:
        f.write(log)
    return {"built": True, "seconds": seconds, "log": log}


_LOAD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def load() -> ctypes.CDLL:
    """The kernel library, built first when needed (once per process; the
    first callers on several threads wait for one build)."""
    with _LOAD_LOCK:
        return _load()


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    build()
    lib = ctypes.CDLL(LIB)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.jt_error_string.argtypes = [ctypes.c_int]
    lib.jt_error_string.restype = ctypes.c_char_p
    return lib


class Kernel:
    """One hand-written kernel: its C entry point, where it came from, and a
    count of its launches (bumped only where the kernel is enqueued, under
    a lock, so that launches from several host threads all count).  Every
    kernel made is in KERNELS."""

    def __init__(self, name: str, symbol: str, source: str, replaces: str):
        self.name = name
        self.symbol = symbol
        self.source = source
        self.replaces = replaces
        self.launches = 0
        KERNELS.append(self)

    def launch(self, *args) -> None:
        """Enqueue the kernel.  The stream argument (stream_of) names the
        card: the library's current device is set to it first, in this
        host thread, since the library's CUDA runtime keeps its own."""
        lib = load()
        for arg in args:
            if isinstance(arg, Stream):
                err = lib.jt_set_device(arg.device)
                if err != 0:
                    raise RuntimeError(
                        f"{self.name}: cannot select cuda:{arg.device}: "
                        f"CUDA error {err} "
                        f"({lib.jt_error_string(err).decode()})")
        err = getattr(lib, self.symbol)(*args)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error {err} "
                               f"({lib.jt_error_string(err).decode()})")
        with _COUNT_LOCK:
            self.launches += 1


KERNELS = []


def launched() -> int:
    """The launches of every kernel so far, summed."""
    return sum(k.launches for k in KERNELS)


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a contiguous tensor, for a ctypes argument."""
    if not t.is_contiguous():
        raise ValueError("kernel arguments must be contiguous")
    return ctypes.c_void_p(t.data_ptr())


class Stream(ctypes.c_void_p):
    """A CUDA stream handle for a ctypes argument, with the index of its
    card in `device`."""


def stream_of(t) -> Stream:
    """PyTorch's current stream on the tensor's card, carrying the card's
    index: Kernel.launch makes that card the library's current device
    before it enqueues.  A tensor on an index this machine lacks raises."""
    import torch

    index = t.device.index
    if index is None:
        index = torch.cuda.current_device()
    if not 0 <= index < torch.cuda.device_count():
        raise ValueError(f"no CUDA device cuda:{index} on this machine")
    stream = Stream(torch.cuda.current_stream(index).cuda_stream)
    stream.device = index
    return stream
