"""Engine implementations for the block pipeline (the port's counterpart
of jampack_tpu/runtime/engines.py).

- Engine (runtime.pipeline): the pure Python/numpy executable spec.
- NativeEngine: the native C++ host engine (native/, a copy of the JAX
  package's); the class is a copy, line for line.
- HybridEngine: the native host stages, and the BWT both ways on the card
  where the block fits (the reference's -g mode).
- GpuEngine: the per-stage engine on the card, the counterpart of the JAX
  package's TpuEngine: each stage one call through the port's kernels
  (K1 rANS decode, K3 inverse-BWT chase, K4/K5 rANS encode, K7/K8 the
  -f1/-f2 filter search, K8 the LPC filter decode, K10 Lpx, K11 the LZ
  token parse), the forward BWT on torch.sort and the -f3 search in torch
  ops; the stages that
  TpuEngine inherits from the spec engine (checksum, lz_encode, the -f0
  filter stage, and the rank and RLE0 halves of the entropy stage) it
  inherits too.

Stage inputs and outputs are numpy uint8 arrays, as in every engine; the
GPU and hybrid engines move each stage's bytes to the card and back.  They
take a device, "cuda" by default: without a card they raise, and "cpu"
runs the plain PyTorch versions of the kernels, for the tests.
"""

import threading
from collections import Counter

import numpy as np
import torch

from ..device import resolve
from ..format.constants import ANS_CHUNK_SIZE
from ..format.varint import encode_leb128
from ..runtime.pipeline import Engine
from ..stages.ans import (
    interleave_lanes,
    lane_rlen,
    read_chunk_header,
    read_lane_table,
    write_chunk_header,
)
from ..stages.rank import rank_decode, rank_encode
from ..stages.rle0 import rle0_decode, rle0_encode

# the LZ parse's output bound when a stage call gives no cap (the JAX
# per-stage decode has none): the largest the int32 slots hold
_NO_CAP = 2**31 - 2


class NativeEngine(Engine):
    """Host C++ engine (libjamtpu.so): the fast encode path and the CPU
    decode baseline.  Same stream contract as the spec engine."""

    name = "native"

    def __init__(self, threads: int = 0):
        from .. import native

        self._n = native
        self.threads = threads

    def checksum(self, data):
        return self._n.checksum(data)

    def lz_encode(self, data, mode: int):
        from .pipeline import LZ_MODE_STORE

        if mode == LZ_MODE_STORE:
            from ..stages.lz77 import lz77_store_encode

            return lz77_store_encode(data)  # trivial; no native leg needed
        return self._n.lz_encode(data, mode)

    def lz_decode(self, data, cap=None):
        cap = cap or (np.asarray(data).size * 4 + (1 << 20))
        return self._n.lz_decode(data, cap)

    def filters_encode(self, data, mode: int):
        return self._n.filters_encode(data, mode, self.threads)

    def filters_decode(self, data):
        return self._n.filters_decode(data)

    def lpx_encode(self, data, spans=4):
        return self._n.lpx_encode(data, self.threads, spans)

    def lpx_decode(self, data, spans=4):
        return self._n.lpx_decode(data, self.threads, spans)

    def bwt_forward(self, data, units=120):
        return self._n.bwt_forward(data, units)

    def bwt_inverse(self, data, units=120):
        return self._n.bwt_inverse(data, self.threads, units)

    def ans_encode(self, data, chunk=1 << 20, lanes=0):
        return self._n.ans_encode(data, chunk, lanes)

    def ans_decode(self, data, cap=None, lanes=0):
        cap = cap or (np.asarray(data).size * 8 + (1 << 20))
        return self._n.ans_decode(data, cap, self.threads, lanes)


class HybridEngine(NativeEngine):
    """The native C++ host engine for the serial stages (entropy chains,
    rank/RLE, Lpx, LZ match finding), and the BWT both ways on the card
    (the forward suffix sort on torch.sort, the inverse chase K3), where
    the block passes the reference's GPU-offload gate (bwt.cpp:102-114):
    a block too large for 80% of the card's memory takes the native BWT.
    Archives are the native engine's byte for byte.  `routes` counts the
    BWT calls each route took ("device" or "host")."""

    name = "hybrid"

    def __init__(self, threads: int = 0, device="cuda"):
        super().__init__(threads)
        self.device = resolve(device)
        self.routes = Counter()
        self._lock = threading.Lock()

    def _device_fits(self, nbytes: int) -> bool:
        # the reference's gate: ~6 bytes of working set per input byte
        # must fit in 80% of device memory; on the CPU (tests) every
        # block takes the device route, through the plain versions
        if self.device.type == "cpu":
            return True
        from .sysinfo import fits_on_device

        return fits_on_device(nbytes, device=self.device)

    def _route(self, nbytes: int) -> bool:
        fits = self._device_fits(nbytes)
        with self._lock:
            self.routes["device" if fits else "host"] += 1
        return fits

    def bwt_forward(self, data, units=120):
        if not self._route(np.asarray(data).size):
            return super().bwt_forward(data, units)
        return _bwt_forward(data, units, self.device)

    def bwt_inverse(self, data, units=120):
        if not self._route(np.asarray(data).size):
            return super().bwt_inverse(data, units)
        return _bwt_inverse(data, units, self.device)


def _to_device(data, dev) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(data, dtype=np.uint8))
    return torch.from_numpy(a.copy()).to(dev)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _bwt_forward(data, units: int, dev) -> np.ndarray:
    """stages.bwt.forward_bwt on `dev` (kernels/sa.py: prefix doubling on
    torch.sort), as JAX's forward_bwt_tpu."""
    from ..kernels.sa import forward_bwt

    return _host(forward_bwt(_to_device(data, dev), units))


def _bwt_inverse(data, units: int, dev) -> np.ndarray:
    """stages.bwt.inverse_bwt on `dev` (the LF map and K3), as JAX's
    inverse_bwt_tpu: a stream with no full row is its raw tail, and a bad
    anchor raises."""
    from ..kernels.device_stages import ibwt_dyn

    buf = np.asarray(data, dtype=np.uint8)
    n = buf.size - units * 4
    if n <= 0 or n - (n % units) <= 0:
        return buf[:max(n, 0)].copy()
    out, _, ok = ibwt_dyn(_to_device(buf, dev), buf.size, units)
    if not bool(ok):
        raise ValueError("invalid anchor table")
    return _host(out)


class GpuEngine(Engine):
    """The per-stage engine on the card: TpuEngine's stages, method by
    method, on the port's kernels.  Safe on several host threads: the
    kernels build once under a lock, launch counts are taken under one,
    and every call allocates its own buffers."""

    name = "gpu"

    def __init__(self, device="cuda"):
        self.device = resolve(device)

    def _t(self, data) -> torch.Tensor:
        return _to_device(data, self.device)

    def lz_decode(self, data, cap=None):
        """K11's parse and the pointer-doubling expansion, with slots for
        any stream (a token takes at least 2 bytes)."""
        from ..kernels.device_stages import lz_decode_dyn

        buf = self._t(data)
        n = buf.numel()
        out, _, ok = lz_decode_dyn(buf, n, max(n // 2, 4096), cap or _NO_CAP)
        if not ok:
            raise ValueError("invalid lz77 token")
        return _host(out)

    def lpx_encode(self, data, spans=4):
        return self._lpx(data, spans, False)

    def lpx_decode(self, data, spans=4):
        return self._lpx(data, spans, True)

    def _lpx(self, data, spans: int, decode: bool) -> np.ndarray:
        from ..kernels.lpx import lpx_dyn

        buf = self._t(data)
        if buf.numel() == 0:
            return np.zeros(0, dtype=np.uint8)
        return _host(lpx_dyn(buf, buf.numel(), spans, decode))

    def filters_encode(self, data, mode: int):
        if mode < 1:
            return super().filters_encode(data, mode)
        from ..kernels import filters, filters_search

        fn = {1: filters_search.filters_encode_f1_device,
              2: filters_search.filters_encode_f2_device}.get(
                  mode, filters.filters_encode_f3)
        return _host(fn(self._t(data)))

    def filters_decode(self, data):
        """The fused decode's filter stage (K8 on the LPC chunks, the
        inline deltas and the reorders in torch ops)."""
        from ..kernels.device_stages import filters_decode_dyn

        buf = self._t(data)
        out, _, ok = filters_decode_dyn(buf, buf.numel(), buf.numel())
        if not bool(ok):
            raise ValueError("unsupported filter configuration")
        return _host(out)

    def bwt_forward(self, data, units=120):
        return _bwt_forward(data, units, self.device)

    def bwt_inverse(self, data, units=120):
        return _bwt_inverse(data, units, self.device)

    def ans_encode(self, data, chunk=1 << 20, lanes=0):
        """The host spec's rank and RLE0 of each chunk, then every chain
        of the block (a chunk, or a chunk's lanes) in one K4 model pass
        and one K5 reverse rANS; the chunk headers and lane tables on the
        host."""
        data = np.asarray(data, dtype=np.uint8)
        chunk = min(max(int(chunk), 1), ANS_CHUNK_SIZE)
        eff = lanes if lanes >= 2 else 1
        heads, chains = [], []
        for base in range(0, data.size, chunk):
            part = data[base : base + chunk].copy()
            ranked, freqs = rank_encode(part)
            syms = rle0_encode(ranked)
            heads.append((freqs, part.size, int(syms.size)))
            chains += [syms[l::eff] for l in range(eff)]
        payloads = self._encode_chains(chains)
        out = bytearray()
        for c, (freqs, olen, rlen) in enumerate(heads):
            mine = payloads[c * eff:(c + 1) * eff]
            if lanes >= 2:
                table = b"".join(encode_leb128(len(p)) for p in mine)
                payload = table + b"".join(mine)
            else:
                payload = mine[0]
            out += write_chunk_header(freqs, olen, len(payload), rlen)
            out += payload
        return bytes(out)

    def _encode_chains(self, chains) -> list:
        from ..kernels.rans_encode import (model_pairs_wide,
                                           rans_reverse_encode_wide)

        if not chains:
            return []
        L = len(chains)
        max_rlen = max(max(s.size for s in chains), 1)
        pad = np.zeros((L, max_rlen), dtype=np.uint16)
        rlens = np.zeros(L, dtype=np.int32)
        for l, s in enumerate(chains):
            pad[l, : s.size] = s
            rlens[l] = s.size
        syms = torch.from_numpy(pad).to(self.device)
        rl = torch.from_numpy(rlens).to(self.device)
        lows, fqs, ok = model_pairs_wide(syms, rl, max_rlen)
        if not bool(ok.all()):
            raise ValueError(
                "model failure (CDF): chunk not encodable in ref-compat mode")
        bufs, ptrs = rans_reverse_encode_wide(lows, fqs, rl, max_rlen)
        bufs, ptrs = _host(bufs), _host(ptrs)
        return [bufs[l, int(ptrs[l]):].tobytes() for l in range(L)]

    def ans_decode(self, data, cap=None, lanes=0):
        """Every chain of the stream (one per chunk, or one per chunk x
        lane) in one K1 launch, then the host spec's RLE0 and rank decode
        of each chunk."""
        from ..kernels.rans import decode_lanes_wide

        buf = np.asarray(data, dtype=np.uint8)
        view = memoryview(buf.tobytes())
        pos = 0
        chunks = []  # (freqs, olen, rlen, [chain rows])
        starts, rlens = [], []
        while pos < len(view):
            freqs, olen, clen, rlen, pos = read_chunk_header(view, pos)
            if lanes >= 2:
                lane_clens, p = read_lane_table(view, pos, rlen, lanes)
                if sum(lane_clens) != clen - (p - pos):
                    raise ValueError("corrupt lane table")
                rows = list(range(len(starts), len(starts) + lanes))
                starts.extend(np.cumsum([p] + lane_clens[:-1]).tolist())
                rlens.extend(lane_rlen(rlen, lanes, l) for l in range(lanes))
            else:
                rows = [len(starts)]
                starts.append(pos)
                rlens.append(rlen)
            chunks.append((freqs, olen, rlen, rows))
            pos += clen
        if not chunks:
            return np.zeros(0, dtype=np.uint8)
        max_rlen = max(rlens)
        syms, ok = decode_lanes_wide(
            self._t(buf),
            torch.tensor(starts, dtype=torch.int32, device=self.device),
            torch.tensor(rlens, dtype=torch.int32, device=self.device),
            max_rlen)
        if not bool(ok.all()):
            raise ValueError("invalid rANS state")
        all_syms = _host(syms).astype(np.uint16)
        parts = []
        for freqs, olen, rlen, rows in chunks:
            if lanes >= 2:
                syms = interleave_lanes(
                    [all_syms[r, : rlens[r]] for r in rows], rlen, lanes
                )
            else:
                syms = all_syms[rows[0], :rlen]
            ranked = rle0_decode(syms, olen)
            parts.append(rank_decode(ranked, freqs))
        return np.concatenate(parts)
