"""The Lpx span walk, both directions: kernel K10 and its plain version,
and the Lpx stage over a flat buffer.

Counterpart of jampack_tpu/kernels/lpx_tpu.py::_code_span (its wide
variant :145 and packed variant :207) vmapped over the spans by
jampack_tpu/kernels/device_stages.py::lpx_dyn_core (:542).  lpx.cpp:11-170:
order-1..3 context tables of 256 records (cxt, pos, hits, miss, thr) a
span; while a record's hits exceed its threshold and the anchor distance
is under 64 KiB, the coder emits byte[i - dist] ^ byte[i] until the first
nonzero prediction error.

The integer rules (jampack_tpu/stages/lpx.py:38-83, _update_table of
lpx_tpu.py:45-124): int32 arithmetic shifts in the threshold mix, uint32
wrap of the rolling context and of the anchor distance, the distance
compared unsigned with LPX_MAX_RECORD_SIZE, and the trailing threshold
update made on the record of the order after its adjustment (the
reference re-reads *order).  thr * thr * order is taken mod 2^32 and
compared unsigned with the miss count, as the native engine
(jampack_tpu/native/src/jn_stages.cpp:66) does; the JAX walk compares it
as a signed int32, which differs once it reaches 2^31 (ROADMAP C6: a
threshold of 26,755 or more, reached only in spans far over 32 KiB).

lpx_walk launches K10 (csrc/lpx_walk.cu) for a CUDA tensor and runs
lpx_walk_plain for a CPU tensor.
"""

import numpy as np
import torch

from ..format.constants import (
    LPX_MAX_RECORD_SIZE,
    LPX_MAX_THRESHOLD,
    LPX_MIN_THRESHOLD,
)
from ..runtime.metrics import span
from ..stages.lpx import _split_spans

from ._build import Kernel, ptr, stream_of

KERNEL = Kernel("lpx_walk", "jt_lpx_walk", "jampack_tpu_torch/csrc/lpx_walk.cu",
                "jampack_tpu/kernels/lpx_tpu.py:127")
# K10 with its layout as arguments, for the tests and the sweeps of
# chip_smoke.py, through _lpx_walk_at; no path launches it.
_MEASURE = Kernel("lpx_walk_at", "jt_lpx_walk_at",
                  "jampack_tpu_torch/csrc/lpx_walk.cu",
                  "jampack_tpu/kernels/lpx_tpu.py:127")

# K10's layout, kPad and kLanes in csrc/lpx_walk.cu, fixed there (PERF.md
# has the sweeps that chose them).  BANK_PAD: records of 16 bytes added to
# each span's block of shared memory, which spreads the lanes of a warp
# over the banks (Banks).  SPANS_A_WARP: spans that share a warp; a block
# runs its spans in ceil(spans / SPANS_A_WARP) warps (Spans a block): 16
# spans of -S4096 a block in four warps, one a scheduler.  Spans longer
# than RING take eight-word records, shorter ones four.
BANK_PAD = 1
SPANS_A_WARP = 5
RING = 64 << 10

_CXT, _POS, _HITS, _MISS, _THR = range(5)
_M32 = 0xFFFFFFFF


def _check(buf, starts, lens):
    if buf.dtype != torch.uint8 or buf.dim() != 1:
        raise ValueError("buf must be a (n,) uint8 tensor")
    if (starts.dtype != torch.int32 or lens.dtype != torch.int32
            or starts.dim() != 1 or starts.shape != lens.shape):
        raise ValueError("starts and lens must be (S,) int32")
    if not (buf.device == starts.device == lens.device):
        raise ValueError("all inputs must be on one device")
    return starts.shape[0]


def lpx_walk(buf: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor,
             decode: bool, max_len: int) -> torch.Tensor:
    """Code each span buf[starts[s] : starts[s] + lens[s]] on its own model
    (decode=False: Lpx encode, True: decode).  The spans must not overlap.
    Returns a (n,) uint8 tensor holding each span's output in place of its
    input, zero where no span lies.  max_len is the longest span, which
    the caller knows on the host: it chooses K10's record layout and the
    shared memory a span takes (a longer span is coded only up to
    max_len)."""
    S = _check(buf, starts, lens)
    if not buf.is_cuda:
        return lpx_walk_plain(buf, starts, lens, decode)
    return _walk(KERNEL, buf, starts, lens, S, decode, max_len)


def _lpx_walk_at(buf: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor,
                 decode: bool, max_len: int, pad: int = BANK_PAD,
                 lanes: int = SPANS_A_WARP,
                 wide: bool | None = None) -> torch.Tensor:
    """For the tests and measurement only: lpx_walk on CUDA tensors with
    `pad` records of padding (see BANK_PAD), `lanes` spans a warp (1-32)
    and eight-word records if `wide`, else four where they hold the span
    (below 16 MiB); None takes lpx_walk's choice.  The output is
    lpx_walk's."""
    S = _check(buf, starts, lens)
    if not buf.is_cuda:
        raise ValueError("K10 runs on CUDA tensors only")
    if wide is None:
        wide = max_len > RING
    return _walk(_MEASURE, buf, starts, lens, S, decode, max_len, pad, lanes,
                 int(wide))


def _walk(kernel: Kernel, buf, starts, lens, S: int, decode: bool,
          max_len: int, *layout) -> torch.Tensor:
    out = torch.zeros_like(buf)
    if S == 0 or buf.numel() == 0 or max_len <= 0:
        return out
    buf, starts, lens = buf.contiguous(), starts.contiguous(), lens.contiguous()
    kernel.launch(ptr(buf), ptr(starts), ptr(lens), S, max_len, int(decode),
                  *layout, ptr(out), stream_of(buf))
    return out


def lpx_walk_plain(buf: torch.Tensor, starts: torch.Tensor,
                   lens: torch.Tensor, decode: bool) -> torch.Tensor:
    """Plain PyTorch version of K10: every span in lockstep, one Python step
    per byte up to the longest span, the tables of all spans in one
    (S * 1024, 5) int32 tensor (orders 1..3 and a scratch slice a span, as
    lpx_tpu._code_span_wide keeps them).  A step gathers the four records
    it reads before it writes any (the run row, the primary row and both
    rows the trailing threshold update may name) and writes two rows.  Same
    contract as lpx_walk."""
    S = _check(buf, starts, lens)
    dev = buf.device
    n = buf.numel()
    out = torch.zeros_like(buf)
    lens = lens.clamp(min=0)
    steps = int(lens.max()) if S else 0
    if steps == 0 or n == 0:
        return out
    st = starts.long()
    ln = lens.long()
    j = torch.arange(steps, device=dev)
    at = (st[None, :] + j[:, None]).clamp(0, n - 1)
    x = buf[at].long()  # (steps, S): the input bytes by step
    coded = torch.zeros(steps, S, dtype=torch.int64, device=dev)
    # the bytes a run predicts from: the output while decoding
    orig_t = coded if decode else x
    lanes = torch.arange(S, device=dev)
    # a span's table: five slices of 256 records, orders 1..3 in slices
    # 1..3 between two scratch slices, so that the rows of order +- 1 need
    # no clamp (a read of a scratch slice is never used)
    tbl = torch.zeros(S * 1280, 5, dtype=torch.int64, device=dev)
    tbl[:, _THR] = LPX_MAX_THRESHOLD >> 1
    sbase = lanes * 1280
    step4 = torch.tensor([0, 0, -256, 256], device=dev)[:, None]
    # int64 throughout: one dtype keeps every step free of casts.  A span
    # past its length walks on unmasked: nothing it computes there is read
    cxt = torch.zeros(S, dtype=torch.int64, device=dev)
    order = torch.full((S,), 3, dtype=torch.int64, device=dev)
    in_run = torch.zeros(S, dtype=torch.bool, device=dev)
    run_dist = torch.zeros(S, dtype=torch.int64, device=dev)
    for i in range(steps):
        cur = x[i]
        o8 = order * 8
        base = sbase + (order << 8)
        lp = (cxt >> o8) & 0xFF
        ls = cxt & ((1 << o8) - 1)
        rows = torch.stack([cxt & 0xFF, lp, lp, lp]) + (base + step4)
        r0, row, dn, up = tbl[rows].unbind(0)  # (S, 5) each
        # run detection on the record of the last byte's prefix
        _, p0, h0, _, t0 = r0.unbind(1)
        dist_new = (i - p0) & _M32
        coding = in_run | ((h0 > t0) & (dist_new < LPX_MAX_RECORD_SIZE))
        if bool(coding.any()):
            dist = torch.where(in_run, run_dist, dist_new)
            xor = orig_t[torch.where(coding, i - dist, 0), lanes] ^ cur
            emitted = torch.where(coding, xor, cur)
            run_dist = torch.where(coding, dist, run_dist)
            in_run = coding & ((cur if decode else xor) == 0)
        else:
            emitted = cur
            in_run = coding
        coded[i] = emitted
        # the table update (stages/lpx.py::_update_table); from step 4 on
        # every order is below the position, so the gate is open
        r_cxt, r_pos, hits, miss, thr = row.unbind(1)
        eq = r_cxt == ls
        if i > 3:
            match, mismatch = eq, ~eq
            new_hits = torch.where(eq, hits + 1, hits >> 2)
            new_miss = torch.where(eq, 0, miss + 1)
        else:
            gate = order < i
            match, mismatch = gate & eq, gate & ~eq
            new_hits = torch.where(
                gate, torch.where(eq, hits + 1, hits >> 2), hits)
            new_miss = torch.where(gate, torch.where(eq, 0, miss + 1), miss)
        # thr * thr * order mod 2^32, compared unsigned (ROADMAP C6)
        sq = (thr * thr * order) & _M32
        down = match & (new_hits > (thr << (order + 3))) & (order > 1)
        up_o = mismatch & (new_miss > sq) & (order < 3)
        distance = i - r_pos
        upper = torch.where(
            hits < LPX_MAX_THRESHOLD, distance.clamp(min=LPX_MIN_THRESHOLD),
            torch.minimum(distance >> order, LPX_MAX_THRESHOLD >> order))
        bound = torch.where(distance <= LPX_MIN_THRESHOLD, LPX_MIN_THRESHOLD,
                            torch.minimum(distance, upper))
        new_cxt = torch.where(mismatch, ls, r_cxt)
        new_pos = torch.where(match, i - order, r_pos)
        # the trailing threshold update, on the new order's record
        if bool((down | up_o).any()):
            new_order = order - down.long() + up_o.long()
            same = new_order == order
            pre2 = torch.where((new_order < order)[:, None], dn, up)
            _, _, h2, m2, th2 = torch.where(
                same[:, None], torch.stack([r_cxt, r_pos, new_hits, new_miss,
                                            thr], 1), pre2).unbind(1)
        else:
            new_order, same = order, None
            h2, m2, th2 = new_hits, new_miss, thr
        new_thr = torch.where(
            match & (h2 > (th2 << 1)) & (m2 == 0),
            th2 + ((bound - th2) >> new_order),
            torch.where(mismatch & (m2 > th2),
                        th2 + ((LPX_MAX_THRESHOLD - th2) >> (4 - new_order)),
                        th2))
        if same is None:
            tbl[rows[1]] = torch.stack([new_cxt, new_pos, new_hits, new_miss,
                                        new_thr], 1)
        else:
            row_a = torch.stack([new_cxt, new_pos, new_hits, new_miss,
                                 torch.where(same, new_thr, thr)], 1)
            row_b = torch.cat([pre2[:, :_THR], new_thr[:, None]], 1)
            # a row_b for the same order is parked in scratch slice 0
            tb = torch.where(same, sbase, base + ((new_order - order) << 8))
            tbl[torch.cat([rows[1], tb + lp])] = torch.cat([row_a, row_b])
            order = new_order
        cxt = ((cxt << 8) | (emitted if decode else cur)) & _M32
    keep = j[:, None] < ln[None, :]
    dst = torch.where(keep, st[None, :] + j[:, None], n)
    res = torch.zeros(n + 1, dtype=torch.uint8, device=dev)
    res[dst.reshape(-1)] = coded.to(torch.uint8).reshape(-1)
    return res[:n]


def lpx_dyn(buf: torch.Tensor, n: int, spans: int, decode: bool):
    """The Lpx stage over the first n bytes of buf, cut into spans by the
    format's split (any n >= 0, spans >= 1, the tiny n < spans and the
    splits of more than spans + 1 pieces included).  Returns (n,) uint8."""
    return lpx_blocks([buf], [n], spans, decode)[0]


def lpx_blocks(bufs, ns, spans: int, decode: bool):
    """The Lpx stage over several blocks' stages in one launch of K10: the
    first ns[i] bytes of bufs[i] (tensors on one device), each cut into
    spans by the format's split, laid end to end, every span of every
    block a walk of its own.  Returns the list of (ns[i],) uint8 outputs.
    K10's span offsets are int32, so the blocks' bytes together stay under
    2^31."""
    offs = np.cumsum([0, *ns]).tolist()
    if offs[-1] >= 2**31:
        raise ValueError("an Lpx batch holds 2^31 bytes or more")
    flat = (bufs[0][:ns[0]].contiguous() if len(bufs) == 1
            else torch.cat([b[:n] for b, n in zip(bufs, ns)]))
    sp = torch.tensor([(s + o, ln) for n, o in zip(ns, offs)
                       for s, ln in _split_spans(n, spans)],
                      dtype=torch.int32).reshape(-1, 2)
    max_len = int(sp[:, 1].max()) if sp.numel() else 0
    with span("sync.lpx"):  # a copy from pageable memory waits
        sp = sp.to(flat.device)
    out = lpx_walk(flat, sp[:, 0].contiguous(), sp[:, 1].contiguous(), decode,
                   max_len)
    return [out[a:b] for a, b in zip(offs[:-1], offs[1:])]
