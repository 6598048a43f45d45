"""Encode blocks on the GPU.

The encode mirror of device_decode.py.  Every O(n) stage of a block runs on
the device (kernels/encode_stages.encode_block_core); the host computes the
CRC (the shared format.checksum, as decode checks it) and splices format
metadata (chunk headers, lane tables) around the device-made chain
payloads, which are compacted on the device and fetched once.

Supported configuration: match_finder=3 (store), filters 0, 1 or 2 (the
-f1/-f2 config search runs on the device, kernels/filters_search.py), any
Lpx span count, with or without the per-block gate (lpx_auto), at every
block length from 0 up; archives are byte-identical to the host engines'
at the same Options.  Anything else raises NotImplementedError naming the
stage that is not ported yet; there is no host route, and asking for CUDA
without a card raises RuntimeError.
"""

import time

import numpy as np
import torch

from ..format import framing
from ..format.checksum import integrity_check
from ..format.constants import ANS_CHUNK_SIZE, FILTER_BLOCK_SIZE
from ..format.varint import encode_leb128
from ..stages.ans import write_chunk_header
from .options import LZ_MODE_STORE, Options

from ..device import resolve
from ..kernels.encode_stages import END_TOKEN, ceil_div, encode_block_core
from ..kernels.filters_search import pick_f1_configs, pick_f2_configs


def _add(times, key, seconds):
    if times is not None:
        times[key] = times.get(key, 0.0) + seconds


def filter_configs(s1: torch.Tensor, filters: int):
    """The (F, 2) int32 per-64 KiB-chunk (type, width) picks of the filter
    stage over the stage-1 bytes s1 (on their device), or None for -f0.
    The picks are the host engines' (the device search re-scores its
    near-ties in float64)."""
    if filters == 0:
        return None
    pick = pick_f1_configs if filters == 1 else pick_f2_configs
    return np.asarray(pick(s1), np.int32).reshape(-1, 2)


def encode_block_device(data: np.ndarray, opt: Options, device="cuda",
                        times: dict = None):
    """Encode one block on `device`; returns (crc, payload bytes).
    opt.lpx_auto is refused here (the span choice must reach the framing
    word): use encode_block_device_ex."""
    if getattr(opt, "lpx_auto", False):
        raise ValueError(
            "lpx_auto chooses per-block spans; use encode_block_device_ex")
    crc, payload, _ = encode_block_device_ex(data, opt, device, times)
    return crc, payload


def encode_block_device_ex(data: np.ndarray, opt: Options, device="cuda",
                           times: dict = None):
    """(crc, payload bytes, lpx_spans_used): the device mirror of
    pipeline.compress_block_ex.  lpx_spans_used is opt.lpx_spans, or 0
    where opt.lpx_auto's gate dropped the Lpx stage; the block's span word
    must carry it.  With a dict `times`, per-stage wall seconds are added
    to it: host_crc, h2d, search (the -f1/-f2 config search), the
    synchronized device stages of encode_block_core, then d2h and
    splice."""
    if opt.match_finder != LZ_MODE_STORE:
        raise NotImplementedError(
            "device encode runs -m3 (store) only: the host-LZ route for "
            "-m0/-m1/-m2 is not ported yet")
    if opt.filters not in (0, 1, 2):
        raise NotImplementedError(
            "device encode runs -f0/-f1/-f2: the -f3 device filter search "
            "is not ported yet")
    dev = resolve(device)
    data = np.ascontiguousarray(np.asarray(data, dtype=np.uint8))
    n = int(data.size)
    units = int(opt.anchor_units)
    chunk = min(max(int(opt.ans_chunk), 1), ANS_CHUNK_SIZE)
    lanes = int(opt.rans_lanes)
    t0 = time.perf_counter()
    crc = integrity_check(data)
    t1 = time.perf_counter()
    x = torch.from_numpy(data.copy()).to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    _add(times, "host_crc", t1 - t0)
    t2 = time.perf_counter()
    _add(times, "h2d", t2 - t1)
    fc = filter_configs(torch.cat([torch.as_tensor(END_TOKEN, device=dev), x]),
                        opt.filters)
    if fc is not None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        _add(times, "search", time.perf_counter() - t2)
    spans = int(opt.lpx_spans)
    bufs, ptrs, oks, freqs, rlens, kept = encode_block_core(
        x, fc, units=units, chunk=chunk, lanes=lanes, lpx_spans=spans,
        lpx_auto=bool(opt.lpx_auto), times=times)
    payload = _fetch_and_splice(bufs, ptrs, oks, freqs, rlens,
                                stage4_len(n, units), chunk, lanes, times)
    return crc, payload, spans if kept else 0


def stage4_len(n: int, units: int) -> int:
    """Entropy-stage input length for a block of n raw bytes in the store
    configuration (the same arithmetic as the core; neither a filter config
    nor the Lpx stage changes lengths)."""
    n1 = n + END_TOKEN.size
    n2 = n1 + 2 * ceil_div(n1, FILTER_BLOCK_SIZE)
    return n2 + END_TOKEN.size + 4 * units


def _compact_chains(bufs: torch.Tensor, ptrs: torch.Tensor) -> torch.Tensor:
    """Every chain's payload tail bufs[i, ptrs[i]:] packed densely at
    exclusive-cumsum offsets, on the device: one cumsum and one masked
    index_put_."""
    NL, cap = bufs.shape
    p = ptrs.long()[:, None]
    lens = cap - p
    offs = torch.cumsum(lens, 0) - lens
    col = torch.arange(cap, device=bufs.device)[None, :]
    valid = col >= p
    dst = torch.where(valid, offs + (col - p), NL * cap)
    out = torch.zeros(NL * cap + 1, dtype=torch.uint8, device=bufs.device)
    out.index_put_((dst.reshape(-1),), bufs.reshape(-1))
    return out[:-1]


def _fetch_and_splice(bufs, ptrs, oks, freqs, rlens, n4: int, chunk: int,
                      lanes: int, times: dict = None) -> bytes:
    """Compact the chain payloads on the device, fetch them with one
    metadata transfer, and splice the block payload.  A chain whose model
    pass hit a zero-frequency op raises ValueError."""
    t0 = time.perf_counter()
    NL, blen = bufs.shape
    C = freqs.shape[0]
    dense = _compact_chains(bufs, ptrs)
    meta = torch.cat([ptrs, oks.int(), freqs.reshape(-1), rlens]).cpu().numpy()
    ptrs = meta[:NL]
    oks = meta[NL:2 * NL]
    freqs = meta[2 * NL:2 * NL + C * 256].reshape(C, 256)
    rlens = meta[2 * NL + C * 256:]
    if not bool(oks.all()):
        raise ValueError(
            "model failure (CDF): chunk not encodable in ref-compat mode")
    lens = blen - ptrs.astype(np.int64)
    dense = dense[:int(lens.sum())].cpu().numpy()
    t1 = time.perf_counter()
    payload = splice_dense(dense, lens, freqs, rlens, n4, chunk, lanes)
    _add(times, "d2h", t1 - t0)
    _add(times, "splice", time.perf_counter() - t1)
    return payload


def splice_dense(dense, lens, freqs, rlens, n4: int, chunk: int,
                 lanes: int) -> bytes:
    """Assemble one block's payload from densely packed chain payloads
    (chain i's bytes at [offs[i], offs[i]+lens[i]), offs = exclusive
    cumsum): per chunk, header + (lane table +) chain payloads — the same
    format path as stages/ans.py ans_encode (a copy of
    jampack_tpu.runtime.device_encode.splice_dense)."""
    eff = max(lanes, 1)
    C = rlens.size
    assert C == ceil_div(n4, chunk)
    offs = np.concatenate([[0], np.cumsum(lens)])
    out = bytearray()
    for c in range(C):
        olen = min(chunk, n4 - chunk * c)
        i0 = c * eff
        if lanes >= 2:
            table = b"".join(encode_leb128(int(lens[i0 + l]))
                             for l in range(eff))
            body = table + dense[offs[i0]:offs[i0 + eff]].tobytes()
        else:
            body = dense[offs[i0]:offs[i0 + 1]].tobytes()
        out += write_chunk_header(freqs[c], olen, len(body), int(rlens[c]))
        out += body
    return bytes(out)


def compress_stream_device(inp, out, opt: Options, device="cuda"):
    """Encode a whole stream from file object `inp` into `out`, one block at
    a time on `device` — the single-device counterpart of
    jampack_tpu.runtime.sharding.encode_archive_sharded.  Keeps the
    reference's feof rule (jampack.cpp:205-214): an input of K * blocksize
    bytes, K = 0 included, gets a trailing empty block.
    Returns (raw bytes, compressed bytes)."""
    dev = resolve(device)
    raw = comp = 0
    pending_empty = True
    while True:
        block = inp.read(opt.blocksize)
        if len(block) == 0 and not pending_empty:
            break
        data = np.frombuffer(block, dtype=np.uint8)
        crc, payload, spans = encode_block_device_ex(data, opt, dev)
        framing.write_block(out, crc, payload, opt.blocksize,
                            opt.anchor_units, opt.rans_lanes, spans)
        raw += len(block)
        comp += len(payload) + framing.header_size(
            opt.anchor_units, opt.rans_lanes, spans)
        if len(block) == 0:
            break
        pending_empty = len(block) == opt.blocksize
    return raw, comp
