"""Decode framed blocks on the GPU.

The host parses only format metadata (chunk headers, lane tables:
block_meta below, the port's copy of jampack_tpu/runtime/device_decode.py's);
every O(n) stage runs on the device (kernels/device_stages.
decode_blocks_core), over a batch of blocks where the caller gives one.
The CRC is checked on the host after the fetch, as the reference checks
after its chain (jampack.cpp:56-57), by the native engine's C++ checksum
(native.checksum, equal to format/checksum.integrity_check).

There is no fallback: a corrupt block raises ValueError, and asking for
CUDA without a card raises RuntimeError.
"""

import numpy as np
import torch

from ..device import resolve
from ..format.constants import ANS_CHUNK_SIZE
from ..kernels.device_stages import decode_blocks_core
from ..native import checksum as integrity_check
from ..stages.ans import lane_rlen, read_chunk_header, read_lane_table
from .metrics import Marks, span


def _pow2(x: int, lo: int = 8) -> int:
    n = lo
    while n < x:
        n <<= 1
    return n


def block_meta(payload: bytes, lanes: int):
    """Parse every chunk header + lane table out of a block payload.

    Returns dict of unpadded numpy arrays: starts/rlens per chain (for
    lanes >= 2, chunk c owns chain rows [c*lanes, (c+1)*lanes)), per-chunk
    olen/rlen, and the (C, 256) rank frequency tables.
    """
    view = memoryview(payload)
    pos = 0
    starts, rlens = [], []
    olens, crlens, ftabs = [], [], []
    while pos < len(view):
        freqs, olen, clen, rlen, pos = read_chunk_header(view, pos)
        if lanes >= 2:
            lane_clens, p = read_lane_table(view, pos, rlen, lanes)
            if sum(lane_clens) != clen - (p - pos):
                raise ValueError("corrupt lane table")
            starts.extend(np.cumsum([p] + lane_clens[:-1]).tolist())
            rlens.extend(lane_rlen(rlen, lanes, l) for l in range(lanes))
        else:
            starts.append(pos)
            rlens.append(rlen)
        olens.append(olen)
        crlens.append(rlen)
        ftabs.append(freqs)
        pos += clen
    return {
        "starts": np.asarray(starts, np.int32),
        "rlens": np.asarray(rlens, np.int32),
        "chunk_olens": np.asarray(olens, np.int32),
        "chunk_rlens": np.asarray(crlens, np.int32),
        "freqs": np.asarray(ftabs, np.int32).reshape(len(olens), 256),
    }


def plan_shapes(metas, payload_lens, blocksize: int, lanes: int):
    """The JAX chain's capacities for a batch of blocks (pow2-bucketed
    there to bound its jit variants).  The port sizes its buffers by
    actual lengths and reads only out_cap, the bound of the LZ and filter
    stages (the reference's 1.05x stage buffers, MB-rounded); its LZ token
    slots come from token_slots, not from max_tokens."""
    cmax = _pow2(max((m["chunk_olens"].size for m in metas), default=1), 1)
    lmax = cmax * max(lanes, 1)
    rmax = _pow2(max((int(m["rlens"].max()) if m["rlens"].size else 1)
                     for m in metas), 16)
    ocap = _pow2(max((int(m["chunk_olens"].max()) if m["chunk_olens"].size
                      else 1) for m in metas), 16)
    ocap = min(ocap, _pow2(ANS_CHUNK_SIZE))
    pcap = _pow2(max(payload_lens), 64)
    need = int(blocksize * 1.05) + 1024
    mb = 1 << 20
    out_cap = _pow2(need) if need < mb else ((need + mb - 1) // mb) * mb
    max_tokens = max(out_cap // 256, 4096)
    return dict(cmax=cmax, lmax=lmax, rmax=rmax, ocap=ocap, pcap=pcap,
                out_cap=out_cap, max_tokens=max_tokens)


def token_slots(total: int, out_cap: int) -> int:
    """max_tokens for both LZ parses of a block whose entropy stage holds
    `total` bytes.  plan_shapes' max(out_cap // 256, 4096) counts the
    dedupe pass's matches of >= 256 B, but -m1/-m2 emit a token for every
    match of >= 4 B (8 MiB of 61-byte log lines at -m1 hold 70,522 against
    its 36,864).  A token takes at least 2 bytes (its tag and an offset
    varint), so a stream of n bytes holds at most n // 2 tokens.  The
    first parse reads at most `total` bytes, the second at most out_cap
    (the bound of the first's output, which Lpx and the filters do not
    lengthen), so max(total, out_cap) // 2 slots hold any stream that can
    decode: 4.7 M for an 8 MiB block, 94 MB of K11 slots and at most 170
    MB of its scratch on an 80 GB card.  A bound, not K11's own count, so
    that the slots are known before the parse and its head kernel fills
    them in the same launch."""
    return max(max(total, out_cap) // 2, 4096)


def decode_block_device(payload: bytes, crc: int, blocksize: int,
                        units: int = 120, lanes: int = 0,
                        lpx_spans: int = 4, device="cuda",
                        times: dict = None) -> np.ndarray:
    """Decode one framed block's payload on `device` and CRC-check it:
    decode_blocks_device on one block.  Same contract as
    jampack_tpu.runtime.device_decode.decode_block_device."""
    if np.ndim(lpx_spans) != 0:
        raise TypeError("one block takes one lpx_spans value")
    return decode_blocks_device([payload], [crc], blocksize, units, lanes,
                                int(lpx_spans), device, times)[0]


def decode_blocks_device(payloads, crcs, blocksize: int, units: int = 120,
                         lanes: int = 0, lpx_spans=4, device="cuda",
                         times: dict = None, _idx_map=None):
    """Decode B framed blocks on one card and CRC-check each on the host;
    returns their arrays in block order.  The counterpart of
    jampack_tpu.runtime.device_decode.decode_blocks_device: units and
    lanes are shared; lpx_spans is an int or one span word a block (-Sa
    archives mix 0 and S), and each span-word group runs as one batch of
    kernels/device_stages.decode_blocks_core (its chains in one K1 launch,
    its chunk rows in one K2 launch, its Lpx spans in one K10 launch).  A
    corrupt block raises ValueError naming its index in the caller's list
    (_idx_map: the caller's indices of these blocks); there is no host
    route.  The caller sizes the batch: its payloads together stay under
    2^31 bytes (K1's and K10's offsets are int32), and its working set
    within the card's memory (sharding.batch_blocks).

    A group is one span "block.batch"; a metrics.Marks clock ends its
    stages: block.meta, block.plan, block.upload, block.chain (the call of
    decode_blocks_core), then block.fetch and block.crc a block.  With a
    dict `times`, per-stage wall seconds are added to it (device stages
    synchronized on the calling thread's stream, a batched stage once for
    its batch; host_meta (meta, plan, upload), d2h and host_crc around
    them)."""
    dev = resolve(device)
    B = len(payloads)
    spans = ([int(lpx_spans)] * B if np.ndim(lpx_spans) == 0
             else [int(s) for s in lpx_spans])
    if len(spans) != B:
        raise ValueError("lpx_spans sequence length != block count")
    idx_map = list(range(B)) if _idx_map is None else list(_idx_map)
    results = [None] * B
    for word in sorted(set(spans)):
        group = [i for i in range(B) if spans[i] == word]
        with span("block.batch", blocks=len(group)):
            mark = Marks(dev, times)
            metas = []
            for i in group:
                try:
                    metas.append(block_meta(payloads[i], lanes))
                except ValueError as e:
                    raise ValueError(
                        f"corrupt block {idx_map[i]}: {e}") from e
            mark("meta", "host_meta")
            shapes = plan_shapes(metas, [len(payloads[i]) for i in group],
                                 blocksize, lanes)
            tokens = [token_slots(int(m["chunk_olens"].sum()),
                                  shapes["out_cap"]) for m in metas]
            mark("plan", "host_meta")
            host = np.frombuffer(b"".join(payloads[i] for i in group),
                                 np.uint8)
            flat = torch.from_numpy(host.copy()).to(dev)
            offs = np.cumsum([0] + [len(payloads[i]) for i in group])
            mark("upload", "host_meta", bytes=host.size)
            outs, ns, oks = decode_blocks_core(flat, offs, metas, lanes,
                                               units, shapes["out_cap"],
                                               tokens, word, times)
            mark("chain", None)
            for j, i in enumerate(group):
                if not oks[j]:
                    raise ValueError(f"device decode failed (corrupt "
                                     f"stream) at block {idx_map[i]}")
                data = outs[j][:ns[j]].cpu().numpy()
                mark("fetch", "d2h", bytes=data.size)
                if integrity_check(data) != (crcs[i] & 0xFFFFFFFF):
                    raise ValueError(f"detected corrupt block {idx_map[i]}")
                mark("crc", "host_crc", bytes=data.size)
                results[i] = data
    return results


def decompress_stream_device(inp, out, device="cuda"):
    """Decode a whole archive from file object `inp` into `out` on
    `device` (sharding.decode_archive_to on a mesh of one device).  Returns
    (compressed bytes, raw bytes)."""
    from .sharding import decode_archive_to

    raw, comp = decode_archive_to(inp, out, [device])
    return comp, raw
