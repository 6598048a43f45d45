"""The per-block decode chain on the device, stage by stage.

Counterpart of jampack_tpu/kernels/device_stages.py.  Each function takes
the JAX function's inputs and gives its outputs bit for bit on the valid
part, with two differences that follow from PyTorch running eagerly:

* Buffers are sized by the actual lengths the block metadata gives, not by
  static capacities (JAX needs those to bound its jit variants).  A stage
  buffer holds exactly its valid bytes; reads past it see zeros, as the
  zero-padded JAX buffers do.
* Lengths known on the host (chunk sizes, stage lengths, the LZ token
  parse) stay host ints; per-stage ok flags stay device tensors until the
  block's one final check.

The chain's serial walks are hand-written CUDA kernels (rans.py, rank.py,
ibwt.py, lpc.py for the LPC filter recurrence of the chunks that chose
LPC, lpx.py for the Lpx span walk, and K11 here for the LZ token parse);
the rest is plain PyTorch.
"""

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ..format.constants import FILTER_BLOCK_SIZE, LZ_MIN_MATCH
from ..format.varint import CONSTANTS as _VARINT_CONSTANTS
from ..runtime.metrics import Marks, span

from ._build import Kernel, ptr, stream_of
from .ibwt import chase, combined_map
from .lpc import lpc
from .lpx import lpx_blocks
from .rank import rank_decode
from .rans import decode_lanes_wide

LZ_KERNEL = Kernel("lz_parse", "jt_lz_parse",
                   "jampack_tpu_torch/csrc/lz_parse.cu",
                   "jampack_tpu/kernels/device_stages.py:269")
# K11's phases after its head, when the stream goes on: the same kernel, so
# its launches are not counted apart (LZ_KERNEL counts one a parse)
_LZ_CHAIN = Kernel("lz_parse_chain", "jt_lz_parse_chain",
                   "jampack_tpu_torch/csrc/lz_parse.cu",
                   "jampack_tpu/kernels/device_stages.py:269")
# the chain phases ending after any of them, for the phase times of
# chip_smoke.py through _lz_parse_at; no path launches it
_LZ_CHAIN_AT = Kernel("lz_parse_chain_at", "jt_lz_parse_chain_at",
                      "jampack_tpu_torch/csrc/lz_parse.cu",
                      "jampack_tpu/kernels/device_stages.py:269")

# K11: the tokens its head walks serially (a stream that ends within them
# runs nothing else), and D, the sub-chain length of its pointer jumping.
# PERF.md has the sweep that chose D.
LZ_HEAD = 16
LZ_JUMP = 32

_FBS = FILTER_BLOCK_SIZE
_I32_MAX = 2**31 - 1


def _i32(x: int) -> int:
    """Python int wrapped to int32, as JAX's int32 arithmetic does."""
    return ((x + 2**31) & 0xFFFFFFFF) - 2**31


# ---------------------------------------------------------------------------
# RLE0 decode (rle.cpp:52-74): scans only


def rle0_decode(syms: torch.Tensor, rlens: torch.Tensor, olens: torch.Tensor,
                out_cap: int):
    """syms: (C, S) int symbols per chunk; rlens/olens: (C,) int32.
    Returns (out (C, out_cap) uint8, ok (C,) bool).

    Runs of {0, 1} symbols are segmented with scans: each run's binary value
    is a prefix-sum difference of its bits scaled by position, the nearest
    run end comes from a reverse cummin, and each nonzero symbol lands at
    its exclusive-scan output position (the zeros between them ARE the
    decoded zero runs).  int32 throughout, as in rle0_decode_core."""
    C, S = syms.shape
    dev = syms.device
    out = torch.zeros(C * out_cap + 1, dtype=torch.uint8, device=dev)
    if S == 0:
        return out[:-1].view(C, out_cap), olens == 0
    idx = torch.arange(S, dtype=torch.int32, device=dev)[None, :]
    valid = idx < rlens[:, None]
    v = syms.to(torch.int32)
    is_bit = valid & (v <= 1)
    no = torch.zeros(C, 1, dtype=torch.bool, device=dev)
    prev_bit = torch.cat([no, is_bit[:, :-1]], 1)
    next_bit = torch.cat([is_bit[:, 1:], no], 1)
    run_start = is_bit & ~prev_bit
    run_end = is_bit & ~next_bit

    def rev_cummin(x):
        return torch.cummin(x.flip(1), 1).values.flip(1)

    endi = rev_cummin(torch.where(run_end, idx, S))
    shift = (endi - idx).clamp(0, 31)
    contrib = torch.where(is_bit, v << shift, 0)
    prefix = torch.cumsum(contrib, 1, dtype=torch.int32)
    pend = rev_cummin(torch.where(run_end, prefix, _I32_MAX))
    run_len = endi - idx + 1
    run_bits = pend - (prefix - contrib)
    overflow = (run_start & (run_len > 30)).any(1)
    run_val = (torch.ones_like(run_len) << run_len.clamp(0, 30)) | run_bits
    zeros_out = (run_val - 1).clamp(min=0)
    nz = valid & (v > 1)
    here = torch.where(nz, 1, torch.where(run_start, zeros_out, 0))
    csum = torch.cumsum(here, 1, dtype=torch.int32)
    pos = csum - here
    total = csum[:, -1]
    keep = nz & (pos >= 0) & (pos < out_cap)
    rows = torch.arange(C, device=dev)[:, None] * out_cap
    flat = torch.where(keep, rows + pos, C * out_cap).reshape(-1)
    out.index_put_((flat,), (v - 1).to(torch.uint8).reshape(-1))
    ok = (total == olens) & ~overflow
    return out[:-1].view(C, out_cap), ok


# ---------------------------------------------------------------------------
# LZ77 decode (lz77.cpp:678-714)


def _leb_from(win, base: int, q: int, n: int):
    """One LEB128-with-carry varint at offset q of a 16-byte token window
    (device_stages._leb_from semantics, int32).  Returns (value, nbytes,
    bad)."""
    bs = [win[q + i] for i in range(5)]
    d = 4
    for i in range(3, -1, -1):
        if bs[i] & 0x80:
            d = i
    bad = base + q + d >= n
    val = 0
    for i in range(d):
        val = _i32((val << 7) | bs[i])
    val = _i32((val << 7) | (bs[d] & 0x7F))
    val = _i32(val + ((0,) + _VARINT_CONSTANTS)[d])
    return val, d + 1, bad


def _token_window(data: bytes, pos: int) -> list:
    """The 16-byte token window at `pos` as lz_parse_core reads it: byte k
    is data[clip(pos + k, 0, N - 1)] where pos + k < N, else 0.  A pos that
    wrapped negative reads byte 0 for every index below 0."""
    N = len(data)
    if N == 0:
        return [0] * 16
    head = min(max(-pos, 0), 16)  # indices below 0, clipped to byte 0
    end = min(pos + 16, N)
    w = [data[0]] * head
    if pos + head < end:
        w += data[pos + head:end]
    return w + [0] * (16 - len(w))


def lz_parse(buf: torch.Tensor, n: int, max_tokens: int, out_cap: int):
    """LZ77 token-stream parse of the first n bytes of buf (lz_parse_core
    semantics).  Returns the int32 tensors (dst, src, lit, off, match) of
    length max_tokens + 1 on buf's device (unused dst = out_cap + 1), then
    the token count, the output length and a bad flag as host values.
    Launches K11 (csrc/lz_parse.cu) for a CUDA tensor: its head walks the
    first LZ_HEAD tokens and fills the other slots, and one fetch of its
    status follows; a stream that goes on runs the chain phases, with
    sub-chains of LZ_JUMP tokens, and a second fetch: one call is the head
    and up to 9 chain launches, counted as one.  Runs lz_parse_plain for a
    CPU tensor."""
    if buf.dtype != torch.uint8 or buf.dim() != 1:
        raise ValueError("buf must be a (N,) uint8 tensor")
    if not buf.is_cuda:
        *arrays, t, out_len, bad = lz_parse_plain(buf, n, max_tokens, out_cap)
        return (*(torch.from_numpy(a) for a in arrays), t, out_len, bad)
    return _lz_parse_at(buf, n, max_tokens, out_cap)


def _lz_parse_at(buf: torch.Tensor, n: int, max_tokens: int, out_cap: int,
                 jump: int = LZ_JUMP, head: int = LZ_HEAD, stop: int = 5):
    """lz_parse on a CUDA tensor with a head of `head` tokens and
    sub-chains of `jump` (a power of two); lz_parse takes LZ_HEAD and
    LZ_JUMP, the tests and the D sweep of chip_smoke.py others.  For the
    phase times, stop < 5 ends the walk after the head (0) or after a
    chain phase (1 candidates, 2 jump table, 3 hops, 4 sub-chains) and
    returns None."""
    if buf.dtype != torch.uint8 or buf.dim() != 1 or not buf.is_cuda:
        raise ValueError("buf must be a (N,) uint8 CUDA tensor")
    if jump < 1 or jump & (jump - 1) or head < 0 or stop not in range(6):
        raise ValueError("jump must be a power of two, head >= 0, stop 0-5")
    buf = buf.contiguous()
    MT = max_tokens + 1
    out = torch.empty(5 * MT + 5, dtype=torch.int32, device=buf.device)
    # the head; its status: (tokens, output length, bad, whether the stream
    # goes on, its position)
    LZ_KERNEL.launch(ptr(buf), buf.numel(), n, MT, out_cap, head,
                     *(_addr(out, k * MT) for k in range(6)), stream_of(buf))
    with span("sync.lz_head"):
        t, out_len, bad, go_on, pos = out[5 * MT:].tolist()
    if go_on and stop:
        _lz_chain(buf, n, MT, out_cap, out, (pos, t, out_len), jump, stop)
    if stop < 5:
        return None
    if go_on:
        with span("sync.lz_chain"):
            t, out_len, bad = out[5 * MT:5 * MT + 3].tolist()
    return (*out[:5 * MT].view(5, MT).unbind(0), t, out_len, bool(bad))


def _addr(t: torch.Tensor, words: int = 0) -> ctypes.c_void_p:
    """The device address `words` int32 into a contiguous tensor."""
    return ctypes.c_void_p(t.data_ptr() + 4 * words)


def _lz_chain(buf, n: int, MT: int, out_cap: int, out, more, jump: int,
              stop: int) -> None:
    """K11's phases after its head, from more = (position, tokens, output
    length), up to phase `stop` (5: all of them, out's slots and status
    written).  Its scratch is one allocation: two jump tables over
    [position, n), the hops, five rows of token fields and two counts."""
    pos, t, out_len = more
    cap = MT - t + 1
    span = n - pos if 0 <= pos < n else 1
    nhops = cap // jump + 2
    scratch = torch.empty(2 * span + nhops + 5 * cap + 2, dtype=torch.int32,
                          device=buf.device)
    at = [0, span, 2 * span, 2 * span + nhops, 2 * span + nhops + 5 * cap]
    args = (*(_addr(scratch, a) for a in at),
            *(_addr(out, k * MT) for k in range(6)), stream_of(buf))
    if stop == 5:
        _LZ_CHAIN.launch(ptr(buf), buf.numel(), n, MT, out_cap, pos, t,
                         out_len, jump, *args)
    else:
        _LZ_CHAIN_AT.launch(ptr(buf), buf.numel(), n, MT, out_cap, pos, t,
                            out_len, jump, stop, *args)


class _Walk:
    """The serial parse's carry (lz_parse_core's loop state)."""

    def __init__(self):
        self.pos = self.t = self.out_len = 0
        self.done = self.bad = False

    def finished(self, n: int) -> bool:
        return self.done or self.bad or self.pos >= n

    def status(self, n: int):
        """(tokens, output length, bad) once finished: a stream that ran
        out without the end token is truncated."""
        return self.t, self.out_len, self.bad or (
            not self.done and self.t > 0 and self.pos >= n and n > 0)


def _unused_slots(MT: int, out_cap: int):
    return (np.full(MT, out_cap + 1, np.int32),
            *(np.zeros(MT, np.int32) for _ in range(4)))


def _walk(data: bytes, n: int, out_cap: int, slots, w: _Walk,
          limit: int = None) -> None:
    """lz_parse_core's token loop from w, for at most `limit` tokens (None:
    until it finishes), writing the numpy slots (dst, src, lit, off,
    match) and advancing w."""
    d_, s_, l_, o_, m_ = slots
    MT = d_.size
    k = 0
    while not w.finished(n) and (limit is None or k < limit):
        pos = w.pos
        win = _token_window(data, pos)
        token = win[0]
        q = 1
        off, nb, b1 = _leb_from(win, pos, q, n)
        q += nb
        match = token >> 3
        ext1, nb1, b2 = _leb_from(win, pos, q, n)
        has_mext = match == 31
        if has_mext:
            q += nb1
        match = _i32((ext1 + 31 if has_mext else match) + LZ_MIN_MATCH)
        lit = token & 7
        ext2, nb2, b3 = _leb_from(win, pos, q, n)
        has_lext = lit == 7
        if has_lext:
            q += nb2
        lit = _i32(ext2 + 7) if has_lext else lit
        p = pos + q
        bad = (b1 or (has_mext and b2) or (has_lext and b3) or match < 0
               or lit < 0 or off < 0 or w.t >= MT)
        ts = min(max(w.t, 0), MT - 1)
        is_end = off == 0
        rec_lit = _i32(n - p) if is_end else lit
        rec_match = 0 if is_end else match
        new_out = _i32(w.out_len + rec_lit + rec_match)
        bad = bad or new_out > out_cap
        bad = bad or (not is_end and (_i32(p + lit) >= n
                                      or _i32(w.out_len + lit - off) < 0))
        if not bad:
            d_[ts] = w.out_len
        s_[ts] = p
        l_[ts] = rec_lit
        o_[ts] = 0 if is_end else off
        m_[ts] = rec_match
        w.pos = n if is_end else _i32(p + lit)
        if not bad:
            w.out_len = new_out
        w.t += 1
        w.bad = bad
        w.done = is_end
        k += 1


def lz_parse_plain(buf: torch.Tensor, n: int, max_tokens: int, out_cap: int):
    """Plain version of K11: the token loop in Python over the buffer's
    bytes, fetched once (_token_window: bytes past the buffer read as 0,
    indices below 0 as byte 0).  Returns numpy int32 arrays (dst, src,
    lit, off, match) of length max_tokens + 1 (unused dst = out_cap + 1),
    the token count, the output length and a bad flag."""
    slots = _unused_slots(max_tokens + 1, out_cap)
    w = _Walk()
    _walk(buf.cpu().numpy().tobytes(), n, out_cap, slots, w)
    return (*slots, *w.status(n))


_M32 = 0xFFFFFFFF


def _i32t(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor wrapped to int32 values, as _i32."""
    return ((x + 2**31) & _M32) - 2**31


def _tokens_at(x: torch.Tensor, n: int, pos: torch.Tensor):
    """The token that would start at each position of pos (int64, in [0,
    n)) of the int64 bytes x, by _walk's rules in tensor ops.  Returns
    (src, lit, off, match, end, is_end, bad): bad holds the conditions that
    make a token bad on its own."""
    N = x.numel()
    at = pos[:, None] + torch.arange(16)
    win = torch.where(at < N, x[at.clamp(0, max(N - 1, 0))] if N else 0, 0)
    adds = torch.tensor((0,) + _VARINT_CONSTANTS)

    def leb(q):
        b = win.gather(1, q[:, None] + torch.arange(5))
        top = (b[:, :4] & 0x80) != 0
        d = torch.where(top.any(1), top.long().argmax(1), 4)
        val = torch.zeros_like(d)
        for k in range(4):
            val = torch.where(k < d, ((val << 7) | b[:, k]) & _M32, val)
        last = b.gather(1, d[:, None])[:, 0]
        val = _i32t((((val << 7) | (last & 0x7F)) + adds[d]) & _M32)
        return val, d + 1, pos + q + d >= n

    token = win[:, 0]
    q = torch.ones_like(pos)
    off, nb, b1 = leb(q)
    q = q + nb
    ext1, nb1, b2 = leb(q)
    mext = (token >> 3) == 31
    q = torch.where(mext, q + nb1, q)
    match = _i32t(torch.where(mext, ext1 + 31, token >> 3) + LZ_MIN_MATCH)
    ext2, nb2, b3 = leb(q)
    lext = (token & 7) == 7
    q = torch.where(lext, q + nb2, q)
    lit = torch.where(lext, _i32t(ext2 + 7), token & 7)
    src = pos + q
    end = _i32t(src + lit)
    is_end = off == 0
    bad = (b1 | (mext & b2) | (lext & b3) | (match < 0) | (lit < 0)
           | (off < 0) | (~is_end & (end >= n)))
    return src, lit, off, match, end, is_end, bad


def lz_parse_jump_plain(buf: torch.Tensor, n: int, max_tokens: int,
                        out_cap: int, depth: int = LZ_JUMP,
                        head: int = LZ_HEAD):
    """K11's decomposition in tensor ops, for the CPU tests: the serial
    head of `head` tokens; then, from its position p0 when that lies in [0,
    n), the candidate token at every position of [p0, n), the jump table
    next^depth by squaring, the hop walk from p0, the sub-chains of depth
    tokens in lockstep and the scan that finds the first token at which
    the walk stops and writes the slots up to it; a chain that leaves [0,
    n) by a wrapped end is walked on serially.  Same contract as
    lz_parse_plain."""
    if depth < 1 or depth & (depth - 1) or head < 0:
        raise ValueError("depth must be a power of two and head >= 0")
    data = buf.cpu().numpy().tobytes()
    MT = max_tokens + 1
    slots = _unused_slots(MT, out_cap)
    w = _Walk()
    _walk(data, n, out_cap, slots, w, head)
    if not w.finished(n) and 0 <= w.pos < n:
        _chain_plain(buf.cpu().long(), n, out_cap, slots, w, depth)
    _walk(data, n, out_cap, slots, w)
    return (*slots, *w.status(n))


def _chain_plain(x, n: int, out_cap: int, slots, w: _Walk, depth: int):
    """The chain phases of lz_parse_jump_plain from w (its position in [0,
    n)), advancing w past the token at which the walk stops."""
    d_, s_, l_, o_, m_ = slots
    MT = d_.size
    p0, t0, out0 = w.pos, w.t, w.out_len
    # 1. the candidates; a chain stops at the end token, at a token bad on
    # its own and at an end that wrapped below 0
    src, lit, off, match, end, is_end, bad = _tokens_at(
        x, n, torch.arange(p0, n))
    stop = bad | is_end | (end < 0)
    # 2. next^depth: the position depth tokens on, or ~(the first stop)
    jump = torch.where(stop, ~torch.arange(p0, n), end)
    for _ in range(depth.bit_length() - 1):
        jump = torch.where(jump < 0, jump, jump[(jump - p0).clamp(min=0)])
    # 3. the hops, up to the token of index MT, the first with no slot
    hops, h = [], p0
    while True:
        hops.append(h - p0)
        if t0 + len(hops) * depth > MT:
            break
        h = int(jump[h - p0])
        if h < 0:
            break
    # 4. the sub-chains in lockstep: token u = j * depth + k
    cur = torch.tensor(hops)
    live = torch.ones(len(hops), dtype=torch.bool)
    steps = []
    for _ in range(depth):
        steps.append(torch.where(live, cur, -1))
        live = live & ~stop[cur]
        cur = torch.where(live, end[cur] - p0, 0)
    idx = torch.stack(steps, 1).reshape(-1)
    gone = torch.nonzero(idx < 0)
    idx = idx[:int(gone[0]) if gone.numel() else idx.numel()]
    stopped = torch.nonzero(stop[idx])
    T = min(int(stopped[0]) + 1 if stopped.numel() else idx.numel(),
            MT - t0 + 1)
    idx = idx[:T]
    # 5. the scan: each token's output length before it, its badness by
    # the prefix, the first token at which the walk stops
    e = is_end[idx]
    rl = torch.where(e, _i32t(n - src[idx]), lit[idx])
    rm = torch.where(e, 0, match[idx])
    ro = torch.where(e, 0, off[idx])
    ln = (rl + rm) & _M32
    out = _i32t(out0 + torch.cumsum(ln, 0) - ln)
    new_out = _i32t(out + ln)
    t = t0 + torch.arange(T)
    bad_u = (bad[idx] | (t >= MT) | (new_out > out_cap)
             | (~e & (_i32t(out + rl - ro) < 0)))
    u = int(torch.nonzero(bad_u | e | (end[idx] < 0))[0])
    # the slots up to it; slot MT - 1 takes src, lit, off and match from
    # the token of index MT when the walk reaches it
    ts = t[:u + 1].clamp(max=MT - 1).numpy()
    ok = ~bad_u[:u + 1].numpy()
    d_[ts[ok]] = out[:u + 1].numpy()[ok]
    keep = ~((t[:u + 1] == MT - 1) & (t0 + u == MT)).numpy()
    for a, v in ((s_, src[idx]), (l_, rl), (o_, ro), (m_, rm)):
        a[ts[keep]] = v[:u + 1].numpy()[keep]
    w.pos = n if bool(e[u]) else int(end[idx[u]])
    w.t = t0 + u + 1
    w.out_len = int(out[u] if bad_u[u] else new_out[u])
    w.done = bool(e[u])
    w.bad = bool(bad_u[u])


def lz_expand(buf: torch.Tensor, d_, s_, l_, o_, out_len: int):
    """Region fill + pointer-doubling resolve over parsed tokens
    (lz_expand_core semantics), sized by the output length."""
    dev = buf.device
    N = buf.shape[0]
    if out_len <= 0:
        return torch.zeros(0, dtype=torch.uint8, device=dev)
    d_, s_, l_, o_ = (torch.as_tensor(a, dtype=torch.long, device=dev)
                      for a in (d_, s_, l_, o_))
    MT = d_.shape[0]
    starts = torch.stack([d_, d_ + l_], 1).reshape(-1)
    p = torch.arange(out_len, device=dev)
    marks = torch.zeros(out_len + 1, dtype=torch.long, device=dev)
    marks.index_add_(0, starts.clamp(0, out_len), torch.ones_like(starts))
    r = (torch.cumsum(marks[:out_len], 0) - 1).clamp(0, 2 * MT - 1)
    tok = r >> 1
    is_lit = (r & 1) == 0
    src = (s_[tok] + (p - d_[tok])).clamp(0, max(N - 1, 0))
    val = torch.where(is_lit, buf[src] if N else 0, 0).to(torch.uint8)
    ptr = torch.where(is_lit, p, p - o_[tok]).clamp(0, out_len - 1)
    with span("sync.lz_expand"):
        if not bool((~is_lit).any()):
            return val
        # a valid stream's pointers only go back, so doubling settles
        # within log2(out_len) + 1 rounds; the cap ends the cycles a
        # corrupt token (already flagged bad by the parse) can make
        for _ in range(64):
            nxt = ptr[ptr]
            if torch.equal(nxt, ptr):
                break
            ptr = nxt
    return val[ptr]


def lz_decode_dyn(buf: torch.Tensor, n: int, max_tokens: int, out_cap: int):
    """Full LZ77 decode of the first n bytes of buf.
    Returns (out (out_len,) uint8, out_len, ok) with ok a host bool."""
    d_, s_, l_, o_, _, t, out_len, bad = lz_parse(buf, n, max_tokens,
                                                  out_cap)
    N = buf.shape[0]
    if t == 1 and out_len > 0 and N > 0:
        # single end-token stream (store mode, or m0 with no >= 256-byte
        # dupes): the output is one contiguous literal run from s_[0]
        # (clipped to [0, 16]), zero past the buffer; gathered on the
        # device, so its start is never fetched
        at = s_[:1].long().clamp(0, 16) + torch.arange(out_len,
                                                       device=buf.device)
        out = torch.where(at < N, buf[at.clamp(max=N - 1)], 0).to(
            torch.uint8)
    elif t == 1:
        out = torch.zeros(max(out_len, 0), dtype=torch.uint8,
                          device=buf.device)
    else:
        out = lz_expand(buf, d_, s_, l_, o_, out_len)
    return out, out_len, not bad


# ---------------------------------------------------------------------------
# Filters decode (filters.cpp:442-490)


def filters_decode_dyn(buf: torch.Tensor, m: int, out_cap: int):
    """Inverse filter stage over the first m bytes of buf.

    Chunk k's (type, width) header sits at k * (FBS + 2); its payload
    length is min(FBS, m - hdr - 2).  Delta is a cumsum, inline delta a
    stride-doubling prefix sum, the channel unreorder a gather; the serial
    LPC recurrence (K8, decode direction) runs over the chunks that chose
    LPC, when there are any.
    out_cap bounds the output as the JAX stage does.
    Returns (out (out_len,) uint8, out_len, ok (0-d bool tensor))."""
    dev = buf.device
    K = min(-(-m // (_FBS + 2)), out_cap // (_FBS + 2) + 2) if m > 0 else 0
    if K == 0:
        return (torch.zeros(0, dtype=torch.uint8, device=dev), 0,
                torch.tensor(True, device=dev))
    need = K * (_FBS + 2)
    bp = F.pad(buf[:need], (0, need - min(buf.shape[0], need))).view(
        K, _FBS + 2)
    hdr = np.arange(K, dtype=np.int64) * (_FBS + 2)
    plen_np = np.minimum(_FBS, m - hdr - 2)
    short = bool(np.any(m - hdr < 2))
    with span("sync.filters"):  # a copy from pageable memory waits
        plen = torch.as_tensor(plen_np, device=dev)[:, None]
    ftype = bp[:, 0].to(torch.int32)[:, None]
    width = bp[:, 1].to(torch.int32)[:, None]
    ok = ~((ftype >= 3) | (width > 32)).any() & (not short)

    jj = torch.arange(_FBS, device=dev)[None, :]
    inb = jj < plen
    C8 = torch.where(inb, bp[:, 2:], 0)
    C = C8.to(torch.int32)
    w = width.clamp(min=1)
    with span("sync.filters"):
        flags = torch.stack([((ftype <= 1) & (width > 0)).any(),
                             ((ftype == 1) & (width > 0)).any(),
                             ((ftype == 2) & (width > 0)).any()]).tolist()
    any_01, any_lpc, any_inline = flags

    dec01 = C
    if any_01:
        dec_delta = torch.cumsum(C, 1, dtype=torch.int32) & 0xFF
        if any_lpc:
            lpc_lens = torch.where((ftype == 1) & (width > 0), plen, 0)
            dec_lpc = lpc(C8, lpc_lens[:, 0].to(torch.int32), True).to(
                torch.int32)
        else:
            dec_lpc = C
        # unreorder: original position p came from reordered index
        # base(p % w) + p // w with base(c) = c * (L // w) + min(c, L % w)
        ch = jj % w
        ro = (ch * torch.div(plen, w, rounding_mode="floor")
              + torch.minimum(ch, plen % w)
              + torch.div(jj, w, rounding_mode="floor")).clamp(0, _FBS - 1)
        dec01 = torch.where(ftype == 1, dec_lpc, dec_delta).gather(1, ro)

    dec2 = C
    if any_inline:
        align = plen % w
        body = jj >= align
        acc = torch.where(body, C, 0)
        for k in range(17):  # 2^17 > FBS: stride-w Hillis-Steele prefix sum
            back = jj - (w << k)
            add = acc.gather(1, back.clamp(0, _FBS - 1))
            acc = acc + torch.where(back >= align, add, 0)
        dec2 = torch.where(body, acc & 0xFF, C)

    dec = torch.where(width > 0, torch.where(ftype == 2, dec2, dec01), C)
    out_len = int(plen_np.sum())
    flat = torch.where(inb, dec, 0).to(torch.uint8).reshape(-1)
    return flat[:max(out_len, 0)], out_len, ok


# ---------------------------------------------------------------------------
# Inverse BWT


def read_anchors(buf: torch.Tensor, n: int, units: int) -> torch.Tensor:
    """The units little-endian int32 anchors stored at buf[n + 4u]."""
    N = buf.shape[0]
    u = torch.arange(units, device=buf.device)
    if N == 0:
        return torch.zeros(units, dtype=torch.int32, device=buf.device)
    ab = [buf[(n + 4 * u + i).clamp(0, N - 1)].to(torch.int64)
          for i in range(4)]
    return (ab[0] | (ab[1] << 8) | (ab[2] << 16) | (ab[3] << 24)).to(
        torch.int32)


def ibwt_dyn(buf: torch.Tensor, total: int, units: int):
    """Inverse BWT of a stage buffer (BWT body + raw tail + units anchors,
    ibwt_dyn_core semantics).  Returns (out (n,) uint8, n, ok 0-d bool)."""
    dev = buf.device
    n = total - units * 4
    rem = n % units if n > 0 else 0
    nlen = max(n - rem, 0)
    anchors = read_anchors(buf, n, units)
    with span("sync.ibwt"):  # a copy from pageable memory waits
        ok = torch.tensor(n >= 0, device=dev)
    out = torch.zeros(max(n, 0), dtype=torch.uint8, device=dev)
    if nlen > 0:
        ok = ok & ((anchors >= 1) & (anchors <= nlen)).all()
        lf, sbyte = combined_map(buf[:nlen], anchors[0])
        out[:nlen] = chase(lf, sbyte, anchors, units)
    if n > nlen:
        out[nlen:n] = buf[nlen:n]
    return out, max(n, 0), ok


# ---------------------------------------------------------------------------
# The fused block decode


def decode_block_core(payload: torch.Tensor, meta: dict, lanes: int,
                      units: int, out_cap: int, max_tokens: int,
                      lpx_spans: int = 0, times: dict = None):
    """decode_blocks_core on one block: returns (out (n,) uint8, n, ok)."""
    outs, ns, oks = decode_blocks_core(payload, [0, payload.numel()], [meta],
                                       lanes, units, out_cap, [max_tokens],
                                       lpx_spans, times)
    return outs[0], ns[0], oks[0]


def decode_blocks_core(payload, offsets, metas, lanes: int, units: int,
                       out_cap: int, max_tokens, lpx_spans: int = 0,
                       times: dict = None):
    """The whole decode chain over B blocks of one span word, on their
    device:

        wide-interleaved rANS -> RLE0 -> SRC rank -> chunk concat
        -> inverse BWT -> LZ77 (configured mode) -> Lpx (lpx_spans > 0)
        -> filters -> LZ77 (dedupe)

    payload: the B payloads end to end, one (P,) uint8 tensor on the
    blocks' device, block i at offsets[i]:offsets[i + 1]; metas: their
    device_decode.block_meta dicts (chain starts/rlens; per-chunk
    olens/rlens/freqs); max_tokens: the LZ token slots, one int for every
    block or one a block.  out_cap bounds the LZ and filter stages as in
    the JAX chain.

    The stages that walk few chains a block (8 on a JAM block, 4 Lpx
    spans) run once for the batch, so that the blocks' walks share the
    card: every block's chains in one K1 launch (chain starts shifted by
    each payload's offset), RLE0 and K2 over every
    chunk row, and every block's Lpx spans in one K10 launch.  The concat,
    the inverse BWT, both LZ parses (a stream's walk is its own) and the
    filters run block by block.  Each stage ends at a mark of one
    metrics.Marks clock (span "chain.<stage>"; sync.* spans around the
    host's reads of device data); with a dict `times`, each stage is
    synchronized on the calling thread's stream and its wall seconds added
    under its name (a batched stage once for the batch).  Returns (outs,
    ns, oks): per block its (n,) uint8 output, n and ok, from one status
    fetch for the batch.  A block without chunks is not valid (every
    block carries its BWT anchors): its ok is False."""
    B = len(metas)
    dev = payload.device
    if np.ndim(max_tokens) == 0:
        max_tokens = [int(max_tokens)] * B
    outs = [torch.zeros(0, dtype=torch.uint8, device=dev)] * B
    ns, oks = [0] * B, [False] * B
    live = [i for i in range(B) if np.size(metas[i]["chunk_olens"]) > 0]
    if not live:
        return outs, ns, oks
    mark = Marks(dev, times, "chain")

    def dt(a, dtype=torch.int32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    ms = [metas[i] for i in live]
    if payload.numel() >= 2**31:
        raise ValueError("a decode batch's payloads hold 2^31 bytes or more")
    pay_offs = [int(offsets[i]) for i in live]
    chain_offs = np.cumsum([0] + [np.size(m["starts"]) for m in ms])
    chunk_offs = np.cumsum([0] + [np.size(m["chunk_olens"]) for m in ms])
    starts_np = np.concatenate([np.asarray(m["starts"], np.int64) + o
                                for m, o in zip(ms, pay_offs)])
    rlens_np = np.concatenate([m["rlens"] for m in ms])
    olens_np = np.concatenate([m["chunk_olens"] for m in ms]).astype(np.int64)
    C = olens_np.size
    starts, rlens = dt(starts_np), dt(rlens_np)
    olens = dt(olens_np)
    crlens = dt(np.concatenate([m["chunk_rlens"] for m in ms]))
    freqs = dt(np.concatenate([np.asarray(m["freqs"]).reshape(-1, 256)
                               for m in ms]))
    rmax = max(int(np.max(rlens_np)), 1)
    ocap = max(int(olens_np.max()), 1)
    mark("h2d")

    # 1+2. entropy chains of every block, emitted straight into chunk rows
    if lanes >= 2:
        chunk_syms, eok = decode_lanes_wide(payload, starts, rlens, rmax,
                                            groups=C)
    else:
        chunk_syms, eok = decode_lanes_wide(payload, starts, rlens, rmax)
    mark("rans")
    # 3. RLE0 per chunk
    ranks, rle_ok = rle0_decode(chunk_syms, crlens, olens, ocap)
    mark("rle0")
    # 4. SRC rank decode
    chunk_bytes, rank_ok = rank_decode(ranks, freqs, olens, ocap)
    mark("rank")
    # 5. each block's chunks concatenated: a reshape when every nonempty
    # chunk starts at c * ocap, else the valid prefix of each row in order
    stages, totals = [], []
    for c0, c1 in zip(chunk_offs[:-1], chunk_offs[1:]):
        ol = olens_np[c0:c1]
        total = int(ol.sum())
        base = np.cumsum(ol) - ol
        rows = chunk_bytes[c0:c1]
        if np.all((base == np.arange(c1 - c0) * ocap) | (ol <= 0)):
            stages.append(rows.reshape(-1)[:total])
        else:
            keep = (torch.arange(ocap, device=dev)[None, :]
                    < olens[c0:c1, None])
            with span("sync.concat"):
                stages.append(rows[keep])
        totals.append(total)
    mark("concat")
    # 6..7. inverse BWT and LZ (mode), block by block
    ns_live, flags, lz_oks = [], [], []
    for j, i in enumerate(live):
        stage, n, ib_ok = ibwt_dyn(stages[j], totals[j], units)
        mark("ibwt")
        stage, n, lz1_ok = lz_decode_dyn(stage, n, max_tokens[i], out_cap)
        mark("lz")
        stages[j] = stage
        ns_live.append(n)
        flags.append(ib_ok)
        lz_oks.append(lz1_ok)
    # 8. Lpx, every block's spans in one launch (spans 0: the encoder
    # skipped the stage, the JT3 span word)
    if lpx_spans > 0:
        stages = lpx_blocks(stages, ns_live, lpx_spans, decode=True)
        mark("lpx")
    # 9..10. filters and LZ (dedupe), block by block
    for j, i in enumerate(live):
        stage, n, f_ok = filters_decode_dyn(stages[j], ns_live[j], out_cap)
        mark("filters")
        outs[i], ns[i], lz0_ok = lz_decode_dyn(stage, n, max_tokens[i],
                                               out_cap)
        mark("lz_dedupe")
        l0, l1 = chain_offs[j], chain_offs[j + 1]
        c0, c1 = chunk_offs[j], chunk_offs[j + 1]
        flags[j] = ((eok[l0:l1] | (rlens[l0:l1] < 0)).all()
                    & (rle_ok[c0:c1] | (olens[c0:c1] <= 0)).all()
                    & rank_ok[c0:c1].all() & flags[j] & f_ok)
        lz_oks[j] = lz_oks[j] and lz0_ok
    with span("sync.status"):
        status = torch.stack(flags).tolist()
    for i, flag, lz_ok in zip(live, status, lz_oks):
        oks[i] = bool(flag) and lz_ok
    mark("status")
    return outs, ns, oks
