"""The per-block encode chain on the device, stage by stage.

Counterpart of jampack_tpu/kernels/encode_stages.py:

    [LZ stage 1] -> encode_front: filters (-f0 headers, or the picked
    -f1/-f2 configs applied per 64 KiB chunk) -> Lpx (spans > 0; with
    lpx_auto kept only when the gate passes) -> [LZ stage 4]
    -> encode_back: forward BWT + anchors -> per chunk: SRC rank -> RLE0
    -> lane deal -> per chain: model pass -> reverse interleaved rANS

The LZ stages are runtime/device_encode.py's: the host's match finders,
or in the store configuration (-m3) an end token the device writes ahead
of the bytes.  Within the front and the back, a filter config or the Lpx
stage changes bytes, not lengths.  Tensors are sized by those lengths (the
JAX chain's pow2 capacities bound its jit variants; PyTorch runs
eagerly).  The serial walks are hand-written CUDA kernels:
the SRC rank encode (K6, here), the LPC filter recurrence (K8, lpc.py), the
Lpx span walk (K10, lpx.py), the model pass (K4) and the reverse rANS (K5)
in rans_encode.py; the rest is plain PyTorch.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..format.constants import FILTER_BLOCK_SIZE, LZ_MIN_MATCH
from ..runtime.pipeline import gain_gate
from ..stages.lz77 import write_token

from ._build import Kernel, load, ptr, stream_of
from .lpc import lpc
from .lpx import lpx_blocks
from .rans_encode import model_pairs_wide, rans_reverse_encode_wide
from .sa import forward_bwt

RANK_KERNEL = Kernel("rank_encode", "jt_rank_encode",
                     "jampack_tpu_torch/csrc/rank_encode.cu",
                     "jampack_tpu/kernels/encode_stages.py:69")

_FBS = FILTER_BLOCK_SIZE
END_TOKEN = np.frombuffer(write_token(LZ_MIN_MATCH, LZ_MIN_MATCH, 0),
                          np.uint8).copy()


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# RLE0 encode (rle.cpp:22-47): scans and one masked index_put_


def rle0_encode(data: torch.Tensor, olens: torch.Tensor):
    """data: (C, W) uint8 rows; olens: (C,) int32 valid lengths.
    Returns (syms (C, W) uint16, rlens (C,) int32).

    A run of R zeros emits the binary expansion of R+1 without its leading
    bit, the j-th bit attributed to the run's j-th zero; a nonzero byte v
    emits v+1.  Run bounds come from a reverse cummin and a cummax, and one
    masked index_put_ lays out every row's symbols (rle0_encode_core, one
    row per chunk)."""
    C, W = data.shape
    dev = data.device
    idx = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    valid = idx < olens[:, None]
    v = data.to(torch.int32)
    z = valid & (v == 0)
    no = torch.zeros(C, 1, dtype=torch.bool, device=dev)
    run_start = z & ~torch.cat([no, z[:, :-1]], 1)
    run_end = z & ~torch.cat([z[:, 1:], no], 1)
    endi = torch.cummin(torch.where(run_end, idx, W).flip(1), 1).values.flip(1)
    starti = torch.cummax(torch.where(run_start, idx, -1), 1).values
    lv = endi - starti + 2  # run length + 1 (>= 2 at zero positions)
    msb = torch.zeros_like(lv)
    for k in range(1, 25):  # bit_length(lv) - 1; chunks are < 2^24 bytes
        msb += (lv >= (1 << k)).int()
    j = idx - starti
    nonzero = valid & (v > 0)
    emit = nonzero | (z & (j < msb))
    cnt = emit.int()
    csum = torch.cumsum(cnt, 1, dtype=torch.int32)
    pos = csum - cnt
    rlens = csum[:, -1] if W else torch.zeros(C, dtype=torch.int32, device=dev)
    bit = (lv >> (msb - 1 - j).clamp(0, 31)) & 1
    val = torch.where(nonzero, v + 1, bit)
    rows = torch.arange(C, device=dev)[:, None] * W
    flat = torch.where(emit, rows + pos, C * W).reshape(-1)
    out = torch.zeros(C * W + 1, dtype=torch.int32, device=dev)
    out.index_put_((flat,), val.reshape(-1))
    return out[:-1].view(C, W).to(torch.uint16), rlens


# ---------------------------------------------------------------------------
# SRC rank encode (rank.cpp:15-90): kernel K6 and its plain version


def _check_rank(chunks, olens):
    if chunks.dtype != torch.uint8 or chunks.dim() != 2:
        raise ValueError("chunks must be a (C, W) uint8 tensor")
    if olens.dtype != torch.int32 or olens.shape != chunks.shape[:1]:
        raise ValueError("olens must be (C,) int32")
    if chunks.device != olens.device:
        raise ValueError("all inputs must be on one device")
    return chunks.shape[0]


def rank_encode(chunks: torch.Tensor, olens: torch.Tensor):
    """SRC rank encode of C chunks.

    chunks: (C, W) uint8 rows; olens: (C,) int32 lengths (<= 0 marks
    padding).  Returns (ranks (C, W) uint8, bucket-ordered and zero past
    each olen; freqs (C, 256) int32)."""
    C = _check_rank(chunks, olens)
    if not chunks.is_cuda:
        return rank_encode_plain(chunks, olens)
    W = chunks.shape[1]
    ranks = torch.empty(C, W, dtype=torch.uint8, device=chunks.device)
    freqs = torch.empty(C, 256, dtype=torch.int32, device=chunks.device)
    if C == 0:
        return ranks, freqs
    chunks, olens = chunks.contiguous(), olens.contiguous()
    RANK_KERNEL.launch(ptr(chunks), W, ptr(olens), C, ptr(ranks), ptr(freqs),
                       stream_of(chunks))
    return ranks, freqs


def rank_encode_path(width: int) -> str:
    """The path K6 takes for chunk rows of this width: "staged" (the rank
    row in shared memory) or "direct" (written in place).  Needs the
    kernels."""
    return "staged" if load().jt_rank_encode_staged(width) else "direct"


def rank_encode_plain(chunks, olens):
    """Plain PyTorch version of K6: setup by scatters and sorts, then a
    Python loop over steps, all chunks in lockstep with masked tensor ops.
    Same contract as rank_encode."""
    C = _check_rank(chunks, olens)
    dev = chunks.device
    W = chunks.shape[1]
    idx = torch.arange(W, device=dev)[None, :].expand(C, W)
    valid = idx < olens[:, None]
    c64 = chunks.long()
    tgt = torch.where(valid, c64, 256)  # padding -> overflow bin
    freqs = torch.zeros(C, 257, dtype=torch.int32, device=dev).scatter_add_(
        1, tgt, torch.ones_like(tgt, dtype=torch.int32))[:, :256]
    # MTF list in first-appearance order; unseen symbols trail in order
    first = torch.full((C, 257), W, dtype=torch.long, device=dev)
    first.scatter_reduce_(1, tgt, idx, reduce="amin")
    r2s = torch.sort(first[:, :256], dim=1, stable=True).indices
    # bucket bases in descending frequency, ties to the lowest symbol
    negs, sorted_sym = torch.sort(-freqs, dim=1, stable=True)
    base = torch.cumsum(-negs, 1) + negs
    bucket = torch.zeros(C, 256, dtype=torch.long, device=dev).scatter_(
        1, sorted_sym, base.long())
    out = torch.zeros(C, W + 1, dtype=torch.uint8, device=dev)
    rows = torch.arange(C, device=dev)
    cols = torch.arange(256, device=dev)[None, :]
    steps = min(max(int(olens.max()) if C else 0, 0), W)
    for i in range(steps):
        active = i < olens
        sym = c64[:, i]
        rank = (r2s == sym[:, None]).long().argmax(1)
        bpos = bucket[rows, sym]
        out[rows, torch.where(active, bpos, W)] = rank.to(torch.uint8)
        bucket[rows, sym] = bpos + active.long()
        shifted = torch.cat([r2s[:, :1], r2s[:, :-1]], 1)
        take = active[:, None] & (cols <= rank[:, None]) & (cols >= 1)
        head = active[:, None] & (cols == 0)
        r2s = torch.where(head, sym[:, None], torch.where(take, shifted, r2s))
    return out[:, :W], freqs.contiguous()


# ---------------------------------------------------------------------------
# The fused block encode


def reorder_idx(lens: torch.Tensor, w: torch.Tensor, W: int) -> torch.Tensor:
    """(B, W) gather indices of the channel reorder of each row's first
    lens[b] bytes at width w[b] (filters.cpp:85-99): reordered[j] =
    row[src[j]], channel-major; 0 past the length (_reorder_idx, one row
    per lane).  lens, w: (B,) int tensors, w >= 1."""
    j = torch.arange(W, device=lens.device)[None, :]
    L, w = lens.long()[:, None], w.long()[:, None]
    per = torch.div(L, w, rounding_mode="floor")  # full rows per channel
    extra = L - per * w  # channels with one extra element
    boundary = extra * (per + 1)
    head = j < boundary
    q = torch.where(head, per + 1, per).clamp(min=1)
    k = torch.where(head, j, j - extra)
    c = torch.div(k, q, rounding_mode="floor")
    src = (k - c * q) * w + c
    return torch.where(j < L, src.clamp(0, W - 1), 0)


def filters_apply_rows(rows: torch.Tensor, plens: torch.Tensor,
                       ftype: torch.Tensor, width: torch.Tensor):
    """Apply each chunk row's (type, width) filter config, every row at once
    (filters.cpp:21-142, encode direction; _filters_apply_rows).

    rows: (F, W) uint8; plens, ftype, width: (F,) int32 on rows' device.
    Width 0 is raw; type 0 is delta and type 1 LPC (K8), both over the
    channel-reordered row and stored reordered; type 2 is the in-place
    per-channel delta, its first align + w bytes raw.  Returns (F, W)
    uint8, zero past each row's length."""
    W = rows.shape[1]
    r32 = rows.to(torch.int32)
    w = width.clamp(min=1)
    j = torch.arange(W, device=rows.device)[None, :]
    inb = j < plens[:, None]
    reordered = torch.where(inb, r32.gather(1, reorder_idx(plens, w, W)), 0)
    delta = (reordered - F.pad(reordered, (1, 0))[:, :-1]) & 0xFF
    is_lpc = (ftype == 1) & (width > 0)
    lpc_out = reordered
    if bool(is_lpc.any()):
        lpc_out = lpc(reordered.to(torch.uint8),
                      torch.where(is_lpc, plens, 0).to(torch.int32),
                      False).to(torch.int32)
    align = (plens % w)[:, None]
    back = j - w[:, None]
    prev = r32.gather(1, back.clamp(0, W - 1))
    inline = (r32 - torch.where(back >= align, prev, 0)) & 0xFF
    t = ftype[:, None]
    out = torch.where(t == 2, inline, torch.where(t == 1, lpc_out, delta))
    out = torch.where(width[:, None] > 0, out, r32)
    return torch.where(inb, out, 0).to(torch.uint8)


def filter_rows(data: torch.Tensor):
    """data's 64 KiB filter chunks as zero-padded (F, FBS) uint8 rows,
    F >= 1, with their (F,) int32 lengths on the device and as numpy."""
    n = data.numel()
    nf = max(ceil_div(n, _FBS), 1)
    rows = F.pad(data, (0, nf * _FBS - n)).view(nf, _FBS)
    lens_np = np.clip(n - _FBS * np.arange(nf), 0, _FBS).astype(np.int32)
    return rows, torch.as_tensor(lens_np, device=data.device), lens_np


def filter_stage(s1: torch.Tensor, fconfigs=None) -> torch.Tensor:
    """Stage 2: the stage-1 bytes (n1 >= 1) dealt into 64 KiB chunk rows,
    each row behind its (type, width) header and transformed by its config
    (filters.cpp:416-427).  fconfigs: None for -f0 (zero headers, rows as
    they are), else the (F, 2) int32 picks of the filter search.  Returns
    the (n1 + 2 F,) uint8 stage."""
    dev = s1.device
    rows1, plens, _ = filter_rows(s1)
    nf = rows1.shape[0]
    if fconfigs is None:
        hdr = torch.zeros(nf, 2, dtype=torch.uint8, device=dev)
    else:
        fc = torch.as_tensor(np.asarray(fconfigs, np.int32).reshape(nf, 2),
                             device=dev)
        ftype, width = fc[:, 0], fc[:, 1]
        rows1 = filters_apply_rows(rows1, plens, ftype, width)
        hdr = torch.stack([torch.where(width > 0, ftype, 0), width],
                          1).to(torch.uint8)
    return torch.cat([hdr, rows1], 1).reshape(-1)[:s1.numel() + 2 * nf]


def chunk_rows(s4: torch.Tensor, chunk: int):
    """The entropy input cut into (C, chunk) rows, zero-padded, with the
    (C,) int32 chunk lengths."""
    n4 = s4.numel()
    C = ceil_div(n4, chunk)
    olens = torch.as_tensor(
        np.minimum(chunk, n4 - chunk * np.arange(C)).astype(np.int32),
        device=s4.device)
    return F.pad(s4, (0, C * chunk - n4)).view(C, chunk), olens


def deal(syms: torch.Tensor, rlens: torch.Tensor, lanes: int):
    """Round-robin lane deal (JTX wide interleave): chain (c, l) owns chunk
    c's symbols l, l + lanes, ...  Returns (chains (C * eff, max_rlen)
    uint16, crlens (C * eff,) int32, max_rlen), eff = max(lanes, 1)."""
    C, chunk = syms.shape
    eff = max(lanes, 1)
    max_rlen = ceil_div(chunk, eff)
    chains = F.pad(syms.int(), (0, max_rlen * eff - chunk)).view(
        C, max_rlen, eff).transpose(1, 2).reshape(C * eff, max_rlen)
    lane_ids = torch.arange(eff, dtype=torch.int32, device=syms.device)[None, :]
    crlens = torch.div(rlens[:, None] - lane_ids + eff - 1, eff,
                       rounding_mode="floor").reshape(-1).int()
    return chains.to(torch.uint16), crlens, max_rlen


def _no_mark(name, **_):
    pass


def encode_front(s1: torch.Tensor, fconfigs=None, *, lpx_spans: int = 0,
                 lpx_auto: bool = False, mark=_no_mark):
    """Stages 2 and 3 of a block on s1's device: filters, then Lpx
    (encode_front_core); encode_front_blocks on one block.

    s1: (n1,) uint8, any stage-1 stream, n1 >= 1.  fconfigs: None for -f0,
    else the (F, 2) int32 (type, width) picks of the filter search over
    s1.  lpx_spans > 0 runs the Lpx stage on that many spans; with
    lpx_auto it is kept only where pipeline._lpx_gain_gate's integer
    compare passes.  Returns (s2 (n2,) uint8, lpx_kept), n2 = n1 + 2 *
    ceil(n1 / 65,536); lpx_kept says whether the block carries the Lpx
    stage (its span word is lpx_spans, else 0).  mark: the block's
    runtime.metrics.Marks, called after each stage with layer "chain"."""
    s2s, kept = encode_front_blocks([s1], [fconfigs], lpx_spans=lpx_spans,
                                    lpx_auto=lpx_auto, mark=mark)
    return s2s[0], kept[0]


def encode_front_blocks(s1s, fconfigs, *, lpx_spans: int = 0,
                        lpx_auto: bool = False, mark=_no_mark):
    """encode_front over B blocks' stage-1 streams on one device: the
    filters block by block (fconfigs: each block's picks or None), then
    every block's Lpx spans in one K10 launch, and with lpx_auto one fetch
    of the zero counts the gates compare.  Returns (the B stage-2 streams,
    the B lpx_kept flags)."""
    s2s = [filter_stage(s1, fc) for s1, fc in zip(s1s, fconfigs)]
    mark("filters", layer="chain")
    kept = [lpx_spans > 0] * len(s2s)
    if lpx_spans > 0:
        s2ls = lpx_blocks(s2s, [s2.numel() for s2 in s2s], lpx_spans,
                          decode=False)
        if lpx_auto:
            zeros = torch.stack([torch.stack([(a == 0).sum(), (b == 0).sum()])
                                 for a, b in zip(s2s, s2ls)]).tolist()
            kept = [gain_gate(z0, z1, s2.numel())
                    for (z0, z1), s2 in zip(zeros, s2s)]
        s2s = [b if k else a for a, b, k in zip(s2s, s2ls, kept)]
        mark("lpx", layer="chain")
    return s2s, kept


def encode_back(s3: torch.Tensor, *, units: int, chunk: int, lanes: int,
                mark=_no_mark):
    """Stages 5 and 6 of a block on s3's device: the forward BWT with its
    anchors, then per chunk SRC rank (K6) -> RLE0 -> lane deal, per chain
    the model pass (K4) and the reverse interleaved rANS (K5)
    (encode_back_core); encode_back_blocks on one block.

    s3: (n3,) uint8, the stage-4 LZ stream, any n3 >= 0.  Returns (bufs
    (NL, 4*max_rlen+16) uint8, ptrs (NL,) int32, oks (NL,) bool, freqs (C,
    256) int32, rlens (C,) int32) for the host splicer: C = ceil((n3 + 4 *
    units) / chunk) chunks, NL = C * max(lanes, 1) chains in chunk-major
    order, chain payload l = bufs[l, ptrs[l]:].  mark as in
    encode_front."""
    return encode_back_blocks([s3], units=units, chunk=chunk, lanes=lanes,
                              mark=mark)[0]


def encode_back_blocks(s3s, *, units: int, chunk: int, lanes: int,
                       mark=_no_mark):
    """encode_back over B blocks' stage-4 streams on one device: the
    forward BWT block by block, then the chunk rows of every block in one
    K6 launch, one RLE0 pass and one lane deal, and their chains in one K4
    and one K5 launch.  Returns encode_back's tuple for each block."""
    eff = max(lanes, 1)
    s4s = [forward_bwt(s3, units) for s3 in s3s]
    mark("bwt", layer="chain")
    # entropy, every chunk of every block at once: rank -> RLE0 -> deal
    cut = [chunk_rows(s4, chunk) for s4 in s4s]
    offs = np.cumsum([0] + [r.shape[0] for r, _ in cut]).tolist()
    if len(cut) == 1:
        rows, olens = cut[0]
    else:
        rows = torch.cat([r for r, _ in cut])
        olens = torch.cat([o for _, o in cut])
    ranks, freqs = rank_encode(rows, olens)
    mark("rank", layer="chain")
    syms, rlens = rle0_encode(ranks, olens)
    mark("rle0", layer="chain")
    chains, crlens, max_rlen = deal(syms, rlens, lanes)
    mark("deal", layer="chain")
    # model pass, then the reverse interleaved rANS
    lows, fqs, oks = model_pairs_wide(chains, crlens, max_rlen)
    mark("model", layer="chain")
    bufs, ptrs = rans_reverse_encode_wide(lows, fqs, crlens, max_rlen)
    mark("rans", layer="chain")
    return [(bufs[a * eff:b * eff], ptrs[a * eff:b * eff],
             oks[a * eff:b * eff], freqs[a:b], rlens[a:b])
            for a, b in zip(offs[:-1], offs[1:])]
