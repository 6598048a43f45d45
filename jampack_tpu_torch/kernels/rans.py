"""Wide-interleaved rANS chain decode: kernel K1 and its plain version.

Counterpart of jampack_tpu/kernels/rans_wide.py::decode_lanes_wide (the
spec) and rans_pallas.py::decode_lanes_wide_pallas (the TPU kernel).  Each
chain is an independent 4-state rANS stream with its own 9-model bank; a
step decodes one 16-bit RLE0 symbol (an exponent op and a mantissa op).

decode_lanes_wide launches K1 (csrc/rans_decode.cu) for a CUDA tensor and
runs decode_lanes_wide_plain for a CPU tensor.
"""

import torch
import torch.nn.functional as F

from ..format.constants import PROB_BITS, PROB_SCALE, RANS_BYTE_L

from . import rans_common as rc
from ._build import Kernel, ptr, stream_of

KERNEL = Kernel("rans_decode", "jt_rans_decode",
                "jampack_tpu_torch/csrc/rans_decode.cu",
                "jampack_tpu/kernels/rans_pallas.py:262")

_M32 = 0xFFFFFFFF


def _check(buf, starts, rlens, max_rlen, groups):
    if buf.dtype != torch.uint8 or buf.dim() != 1:
        raise ValueError("buf must be a 1-D uint8 tensor")
    if starts.dtype != torch.int32 or rlens.dtype != torch.int32:
        raise ValueError("starts and rlens must be int32")
    if starts.shape != rlens.shape or starts.dim() != 1:
        raise ValueError("starts and rlens must be (L,)")
    if not (buf.device == starts.device == rlens.device):
        raise ValueError("all inputs must be on one device")
    if max_rlen < 0:
        raise ValueError("max_rlen must be >= 0")
    L = starts.shape[0]
    if groups and L % groups:
        raise ValueError("groups must divide the chain count")
    return L


def decode_lanes_wide(buf: torch.Tensor, starts: torch.Tensor,
                      rlens: torch.Tensor, max_rlen: int, groups: int = 0):
    """Decode L independent chains.

    buf: (n,) uint8 payload; starts/rlens: (L,) int32 chain offsets and
    symbol counts (rlens < 0 marks padding chains).  Returns
    (syms int32, ok (L,) bool).  syms is (L, max_rlen), or with groups = G
    the chunk slab (G, max_rlen * L // G) in which chunk g's symbol j sits
    at column j (chain l of the chunk owns columns j with j % (L/G) == l).
    """
    L = _check(buf, starts, rlens, max_rlen, groups)
    if not buf.is_cuda:
        return decode_lanes_wide_plain(buf, starts, rlens, max_rlen, groups)
    shape = (groups, max_rlen * (L // groups)) if groups else (L, max_rlen)
    syms = torch.empty(shape, dtype=torch.int32, device=buf.device)
    ok = torch.empty(L, dtype=torch.uint8, device=buf.device)
    if L == 0:
        return syms, ok.bool()
    t = rc.to_device(buf.device)
    buf, starts, rlens = buf.contiguous(), starts.contiguous(), rlens.contiguous()
    KERNEL.launch(ptr(buf), buf.numel(), ptr(starts), ptr(rlens), L,
                  max_rlen, (L // groups) if groups else 0,
                  ptr(t["bank_init"]), ptr(t["exp_mix"]), ptr(t["ma_mix"]),
                  ptr(t["boff"]), ptr(t["exp_base"]), ptr(syms), ptr(ok),
                  stream_of(buf))
    return syms, ok.bool()


def _lookup(bank, boff, midx, m):
    """(low, freq) of symbol m in model midx, per chain."""
    b0 = boff[midx]
    width = boff[midx + 1] - b0
    lo = torch.where(m > 0, bank.gather(1, (b0 + m - 1).clamp(0, 255)[:, None])[:, 0], 0)
    hi = torch.where(m < width,
                     bank.gather(1, (b0 + m).clamp(0, 255)[:, None])[:, 0],
                     PROB_SCALE)
    return lo, hi - lo


def decode_lanes_wide_plain(buf, starts, rlens, max_rlen: int,
                            groups: int = 0):
    """Plain PyTorch version of K1: a Python loop over steps, all chains in
    lockstep with masked tensor ops, state in int64.  Same contract as
    decode_lanes_wide."""
    L = _check(buf, starts, rlens, max_rlen, groups)
    dev = buf.device
    n = buf.numel()
    t = rc.to_device(dev)
    boff = t["boff"].long()
    exp_base = t["exp_base"].long()
    seg0 = (t["seg_id"] == 0)[None, :]
    seg_idx = t["seg_id"][None, :].expand(L, 256)

    b = buf.long()
    bp = F.pad(b, (0, 3))
    win = bp[:-3] | (bp[1:-2] << 8) | (bp[2:-1] << 16) | (bp[3:] << 24)
    st = starts.long()
    rl = rlens.long()

    def byte_at(p):
        return b[p.clamp(0, n - 1)] if n else torch.zeros_like(p)

    R = torch.stack([byte_at(st + 4 * k) | (byte_at(st + 4 * k + 1) << 8)
                     | (byte_at(st + 4 * k + 2) << 16)
                     | (byte_at(st + 4 * k + 3) << 24) for k in range(4)], 1)
    ptr_ = st + 16
    bank, qf, seen, qexp = rc.model_state(t, L)
    syms = torch.zeros(L, max_rlen, dtype=torch.int32, device=dev)

    def renorm(x, w, kb, active):
        for _ in range(2):
            need = active & (x < RANS_BYTE_L)
            byte = (w >> (kb << 3)) & 0xFF
            x = torch.where(need, ((x << 8) | byte) & _M32, x)
            kb = torch.where(need, kb + 1, kb)
        return x, kb

    def advance(x, lo, fq):
        return (fq * (x >> PROB_BITS) + (x & (PROB_SCALE - 1)) - lo) & _M32

    steps = min(max(int(rl.max()) if L else 0, 0), max_rlen)
    for i in range(steps):
        active = i < rl
        w = win[ptr_.clamp(0, n - 1)] if n else torch.zeros_like(ptr_)
        kb = torch.zeros_like(ptr_)
        rng1 = R[:, 0] & (PROB_SCALE - 1)
        rng2 = R[:, 1] & (PROB_SCALE - 1)
        le = bank <= torch.where(seg0, rng1[:, None], rng2[:, None])
        m_all = torch.zeros(L, 9, dtype=torch.long, device=dev).scatter_add_(
            1, seg_idx, le.long())

        e = m_all[:, 0]
        lo, fq = _lookup(bank, boff, torch.zeros_like(e), e)
        x, kb = renorm(advance(R[:, 0], lo, fq), w, kb, active)
        R = torch.cat([R[:, 1:], torch.where(active, x, R[:, 0])[:, None]], 1)

        midx = 1 + e  # adaptive 1..2 for e < 2, quasi 3..8 for e >= 2
        m = m_all.gather(1, midx[:, None])[:, 0]
        lo, fq = _lookup(bank, boff, midx, m)
        x, kb = renorm(advance(R[:, 0], lo, fq), w, kb, active)
        ptr_ = ptr_ + kb
        R = torch.cat([R[:, 1:], torch.where(active, x, R[:, 0])[:, None]], 1)

        rc.model_update(t, bank, qf, seen, qexp, active, e, m)
        syms[:, i] = torch.where(active, exp_base[e] + m, 0).int()

    ok = (R == RANS_BYTE_L).all(1) | (rl < 0)
    if groups:
        per = L // groups
        syms = syms.reshape(groups, per, max_rlen).transpose(1, 2).reshape(
            groups, max_rlen * per)
    return syms, ok
