"""Encode blocks on the GPU.

The encode mirror of device_decode.py.  The filters, Lpx, the forward BWT
and the entropy stage run on the device (kernels/encode_stages.py); the
host computes the CRC (native.checksum, the C++ twin of
format/checksum.integrity_check, as decode checks it),
runs the LZ match finders of -m0/-m1/-m2 (serial hash-chain walks, as in
the JAX package's encode_block_device_lz; in the store configuration -m3
both LZ stages are a framing the device writes) and splices format
metadata (chunk headers, lane tables) around the device-made chain
payloads, which are compacted on the device and fetched once.  Several
same-length -m3 blocks encode in one pass (encode_blocks_device: their
Lpx spans, chunk rows and chains in one launch a kernel).

Supported configuration: match_finder 0, 1, 2 or 3, filters 0, 1 or 2 (the
-f1/-f2 config search runs on the device, kernels/filters_search.py), any
Lpx span count, with or without the per-block gate (lpx_auto), at every
block length from 0 up; archives are byte-identical to the native host
engine's at the same Options.  -f3 raises NotImplementedError, as the JAX
package's fused encode does: its device filter search runs on the
per-stage engine (runtime/engines.GpuEngine); there is no host route for
any block,
and asking for CUDA without a card raises RuntimeError.
"""

import numpy as np
import torch

from ..format.constants import ANS_CHUNK_SIZE
from ..format.varint import encode_leb128
from ..native import checksum as integrity_check
from ..stages.ans import write_chunk_header
from .engines import NativeEngine
from .options import LZ_MODE_STORE, Options, validate_match_finder

from ..device import resolve
from ..kernels.encode_stages import (
    END_TOKEN,
    ceil_div,
    encode_back,
    encode_back_blocks,
    encode_front,
    encode_front_blocks,
)
from ..kernels.filters_search import pick_f1_configs, pick_f2_configs
from .metrics import Marks, span


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
    must carry it.

    The LZ stages follow compress_block_ex's rule: under -m3 (store) both
    are the store framing, one end token ahead of the bytes, written on the
    device (encode_blocks_device on one block).  -m0/-m1/-m2 run the LZ
    match finders on the host around the device front and back, as
    jampack_tpu's encode_block_device_lz does: the dedupe pre-pass, the
    h2d of its stream, the filter search and encode_front, one d2h of the
    stage-2 stream, the configured finder on it, the h2d of its stream and
    encode_back.

    With a dict `times`, per-stage wall seconds are added to it: host_crc,
    (-m0/-m1/-m2: lz_pre, the host dedupe pre-pass), h2d, search (the
    -f1/-f2 config search), the synchronized device stages of encode_front,
    (-m0/-m1/-m2: d2h_s2, lz, the host stage-4 finder, and h2d_s3), those
    of encode_back, then d2h and splice."""
    _check_filters(opt)
    mode = validate_match_finder(int(opt.match_finder))
    if mode == LZ_MODE_STORE:
        return encode_blocks_device([data], opt, device, times)[0]
    dev = resolve(device)
    data = np.ascontiguousarray(np.asarray(data, dtype=np.uint8))
    units = int(opt.anchor_units)
    chunk = min(max(int(opt.ans_chunk), 1), ANS_CHUNK_SIZE)
    lanes = int(opt.rans_lanes)
    with span("block.batch", blocks=1):
        mark = Marks(dev, times)
        crc = integrity_check(data)
        mark("host_crc", bytes=data.size)
        s1 = NativeEngine().lz_encode(data, 0)
        mark("lz_pre")
        s1 = _h2d(s1, dev)
        mark("h2d", bytes=s1.numel())
        fc = filter_configs(s1, opt.filters)
        if fc is not None:
            mark("search")
        s2, kept = encode_front(s1, fc, lpx_spans=int(opt.lpx_spans),
                                lpx_auto=bool(opt.lpx_auto), mark=mark)
        s2 = s2.cpu().numpy()
        mark("d2h_s2", bytes=s2.size)
        s3 = NativeEngine().lz_encode(s2, mode)
        mark("lz")
        s3 = _h2d(s3, dev)
        mark("h2d_s3", bytes=s3.numel())
        chain = encode_back(s3, units=units, chunk=chunk, lanes=lanes,
                            mark=mark)
        payload = _fetch_and_splice(*chain, s3.numel() + 4 * units, chunk,
                                    lanes, mark)
    return crc, payload, int(opt.lpx_spans) if kept else 0


def encode_blocks_device(blocks, opt: Options, device="cuda",
                         times: dict = None):
    """Encode B same-length blocks in one pass of the device chain on one
    card: [(crc, payload bytes, lpx_spans_used)] in block order, each
    byte-identical to encode_block_device_ex on that block.  The
    counterpart of jampack_tpu.runtime.device_encode.encode_blocks_device
    (-m3 with -f0/-f1/-f2): the filter search and the filters run block by
    block, every block's Lpx spans in one K10 launch (with opt.lpx_auto a
    gate a block), the forward BWT block by block, then the chunk rows of
    every block in one K6 launch and their chains in one K4 and one K5
    launch (kernels/encode_stages.encode_front_blocks,
    encode_back_blocks).  Unlike the JAX function, every block length and
    every Lpx split runs on the card.  -m0/-m1/-m2 raise
    NotImplementedError, as in JAX: their host finders run block by block
    (encode_block_device_ex).  `times` as in encode_block_device_ex, a
    batched stage once for the batch."""
    _check_filters(opt)
    if validate_match_finder(int(opt.match_finder)) != LZ_MODE_STORE:
        raise NotImplementedError(
            "the batched device encode runs -m3 (store); -m0/-m1/-m2 run "
            "their host LZ finders block by block (encode_block_device_ex)")
    blocks = [np.ascontiguousarray(np.asarray(b, dtype=np.uint8))
              for b in blocks]
    if not blocks:
        return []
    if len({b.size for b in blocks}) > 1:
        raise NotImplementedError("batched encode needs same-length blocks")
    dev = resolve(device)
    units = int(opt.anchor_units)
    chunk = min(max(int(opt.ans_chunk), 1), ANS_CHUNK_SIZE)
    lanes = int(opt.rans_lanes)
    with span("block.batch", blocks=len(blocks)):
        mark = Marks(dev, times)
        crcs = [integrity_check(b) for b in blocks]
        mark("host_crc", bytes=sum(b.size for b in blocks))
        tok = torch.as_tensor(END_TOKEN, device=dev)
        flat = _h2d(np.concatenate(blocks), dev)
        n = blocks[0].size
        s1s = [torch.cat([tok, flat[k * n:(k + 1) * n]])
               for k in range(len(blocks))]
        mark("h2d", bytes=flat.numel())
        fcs = [filter_configs(s1, opt.filters) for s1 in s1s]
        if opt.filters:
            mark("search")
        s2s, kept = encode_front_blocks(
            s1s, fcs, lpx_spans=int(opt.lpx_spans),
            lpx_auto=bool(opt.lpx_auto), mark=mark)
        s3s = [torch.cat([tok, s2]) for s2 in s2s]
        chains = encode_back_blocks(s3s, units=units, chunk=chunk,
                                    lanes=lanes, mark=mark)
        return [(crc, _fetch_and_splice(*chain, s3.numel() + 4 * units,
                                        chunk, lanes, mark),
                 int(opt.lpx_spans) if k else 0)
                for crc, chain, s3, k in zip(crcs, chains, s3s, kept)]


def _check_filters(opt: Options) -> None:
    if opt.filters not in (0, 1, 2):
        raise NotImplementedError(
            "device encode runs -f0/-f1/-f2: the -f3 device filter search "
            "runs on the per-stage engine (runtime.engines.GpuEngine)")


def _h2d(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.uint8)).to(dev)


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
                      lanes: int, mark) -> bytes:
    """Compact the chain payloads on the device, fetch them with one
    metadata transfer, and splice the block payload (mark: the block's
    Marks).  A chain whose model pass hit a zero-frequency op raises
    ValueError."""
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
    mark("d2h", bytes=dense.size + meta.nbytes)
    payload = splice_dense(dense, lens, freqs, rlens, n4, chunk, lanes)
    mark("splice")
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
    """Encode a whole stream from file object `inp` into `out` on `device`
    (sharding.encode_archive_sharded on a mesh of one device), with the
    reference's feof rule (jampack.cpp:205-214): an input of K * blocksize
    bytes, K = 0 included, gets a trailing empty block.  Returns (raw
    bytes, compressed bytes)."""
    from .sharding import encode_archive_sharded

    return encode_archive_sharded(inp, out, opt, [device])
