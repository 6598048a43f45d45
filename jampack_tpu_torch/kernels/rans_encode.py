"""Wide rANS chain encode: the model pass (kernel K4) and the reverse 4-state
emission (kernel K5), each with its plain version.

Counterparts of jampack_tpu/kernels/rans_wide.py::model_pairs_wide (the
spec of the TPU kernel rans_pallas._model_pairs_kernel) and
rans_encode.py::rans_reverse_encode_wide.  A chain is one lane of a chunk's
RLE0 symbols (round-robin dealt); each symbol becomes two ops, the exponent
class and the mantissa, whose (low, freq) come from the chain's model bank,
and the ops are then pushed backward through 4 interleaved rANS states.

model_pairs_wide launches K4 (csrc/model_pairs.cu) and
rans_reverse_encode_wide launches K5 (csrc/rans_encode.cu) for a CUDA
tensor; each runs its plain version for a CPU tensor.  K4 walks one chain
a warp on the model of csrc/rans_warp_model.cuh, the one device copy of
the model update, which K1 (the decode) shares; K5 walks a chain's four
interleaved states at once, one lane each, 16 lanes a chain, and places
the bytes by a prefix scan over the chain's lanes.
"""

import torch

from ..format.constants import PROB_BITS, PROB_SCALE, RANS_BYTE_L

from . import rans_common as rc
from ._build import Kernel, ptr, stream_of

PAIRS_KERNEL = Kernel("model_pairs", "jt_model_pairs",
                      "jampack_tpu_torch/csrc/model_pairs.cu",
                      "jampack_tpu/kernels/rans_pallas.py:531")
REVERSE_KERNEL = Kernel("rans_encode", "jt_rans_encode",
                        "jampack_tpu_torch/csrc/rans_encode.cu",
                        "jampack_tpu/kernels/rans_encode.py:169")

# K5 with another number of lanes a chain, for chip_smoke.py's measurement
# of the packing (_encode_at); no path launches it.
_MEASURE = Kernel("rans_encode_at", "jt_rans_encode_at",
                  "jampack_tpu_torch/csrc/rans_encode.cu",
                  "jampack_tpu/kernels/rans_encode.py:169")

# K5's lanes a chain (32 / LANES chains a warp): kLanes in
# csrc/rans_encode.cu, fixed there (PERF.md has the sweep that chose it).
LANES = 16

# K5's division alone, for its exhaustive check on the card (_divmod); no
# path launches it.
_DIVMOD = Kernel("rans_divmod", "jt_rans_divmod",
                 "jampack_tpu_torch/csrc/rans_encode.cu",
                 "jampack_tpu/kernels/rans_encode.py:214")

_M32 = 0xFFFFFFFF


def _check_chains(chains, rlens, max_rlen):
    if chains.dtype != torch.uint16 or chains.dim() != 2:
        raise ValueError("chains must be a (L, max_rlen) uint16 tensor")
    if rlens.dtype != torch.int32 or rlens.shape != chains.shape[:1]:
        raise ValueError("rlens must be (L,) int32")
    if chains.shape[1] != max_rlen:
        raise ValueError("chains must have max_rlen columns")
    if chains.device != rlens.device:
        raise ValueError("all inputs must be on one device")
    return chains.shape[0]


def model_pairs_wide(chains: torch.Tensor, rlens: torch.Tensor,
                     max_rlen: int):
    """The encode model pass of L chains.

    chains: (L, max_rlen) uint16 RLE0 symbols; rlens: (L,) int32 symbol
    counts.  Returns (lows (L, 2*max_rlen) uint16, fqs (L, 2*max_rlen)
    uint16, ok (L,) bool): op 2i is symbol i's exponent op and 2i+1 its
    mantissa op; slots past 2 * rlen are zero.  ok is False where a
    zero-frequency op was hit (the wrap regime: not encodable)."""
    L = _check_chains(chains, rlens, max_rlen)
    if not chains.is_cuda:
        return model_pairs_wide_plain(chains, rlens, max_rlen)
    dev = chains.device
    lows = torch.empty(L, 2 * max_rlen, dtype=torch.uint16, device=dev)
    fqs = torch.empty(L, 2 * max_rlen, dtype=torch.uint16, device=dev)
    ok = torch.empty(L, dtype=torch.uint8, device=dev)
    if L == 0:
        return lows, fqs, ok.bool()
    t = rc.to_device(dev)
    chains, rlens = chains.contiguous(), rlens.contiguous()
    PAIRS_KERNEL.launch(ptr(chains), ptr(rlens), L, max_rlen,
                        ptr(t["bank_init"]), ptr(t["exp_mix"]),
                        ptr(t["ma_mix"]), ptr(t["boff"]), ptr(t["exp_base"]),
                        ptr(lows), ptr(fqs), ptr(ok), stream_of(chains))
    return lows, fqs, ok.bool()


def _pair(bank, boff, midx, m):
    """(low, freq, nonzero) of the known symbol m in model midx, per chain,
    with the bank's arithmetic mod 2^16 (model_pairs_wide's uint16 sums)."""
    b0 = boff[midx]
    w = boff[midx + 1] - b0
    mm = torch.minimum(m, w)
    lo = torch.where(mm > 0, bank.gather(1, (b0 + mm - 1).clamp(0, 255)[:, None])[:, 0], 0)
    hi = bank.gather(1, (b0 + m).clamp(0, 255)[:, None])[:, 0]
    f = torch.where(m < w, (hi - lo) & 0xFFFF, 0)
    last = m == w
    fq = torch.where(last, (PROB_SCALE - lo) & 0xFFFF, f)
    return lo, fq, last | (f != 0)


def model_pairs_wide_plain(chains, rlens, max_rlen: int):
    """Plain PyTorch version of K4: a Python loop over steps, all chains in
    lockstep with masked tensor ops, state in int64.  Same contract as
    model_pairs_wide."""
    L = _check_chains(chains, rlens, max_rlen)
    dev = chains.device
    t = rc.to_device(dev)
    boff = t["boff"].long()
    exp_base = t["exp_base"].long()
    bank, qf, seen, qexp = rc.model_state(t, L)
    lows = torch.zeros(L, 2 * max_rlen, dtype=torch.long, device=dev)
    fqs = torch.zeros(L, 2 * max_rlen, dtype=torch.long, device=dev)
    ok = torch.ones(L, dtype=torch.bool, device=dev)
    rl = rlens.long()
    syms = chains.long()
    steps = min(max(int(rl.max()) if L else 0, 0), max_rlen)
    for i in range(steps):
        active = i < rl
        sym = syms[:, i]
        e = (sym[:, None] >= exp_base[None, 1:]).sum(1)
        m = sym - exp_base[e]
        lo_e, fq_e, good_e = _pair(bank, boff, torch.zeros_like(e), e)
        lo_m, fq_m, good_m = _pair(bank, boff, 1 + e, m)
        ok &= (good_e & good_m) | ~active
        lows[:, 2 * i] = torch.where(active, lo_e, 0)
        lows[:, 2 * i + 1] = torch.where(active, lo_m, 0)
        fqs[:, 2 * i] = torch.where(active, fq_e, 0)
        fqs[:, 2 * i + 1] = torch.where(active, fq_m, 0)
        rc.model_update(t, bank, qf, seen, qexp, active, e, m)
    return lows.to(torch.uint16), fqs.to(torch.uint16), ok


def _check_pairs(lows, fqs, rlens, max_rlen):
    if lows.dtype != torch.uint16 or fqs.dtype != torch.uint16:
        raise ValueError("lows and fqs must be uint16")
    if lows.dim() != 2 or lows.shape != fqs.shape:
        raise ValueError("lows and fqs must be (L, 2*max_rlen)")
    if lows.shape[1] != 2 * max_rlen:
        raise ValueError("lows must have 2*max_rlen columns")
    if rlens.dtype != torch.int32 or rlens.shape != lows.shape[:1]:
        raise ValueError("rlens must be (L,) int32")
    if not (lows.device == fqs.device == rlens.device):
        raise ValueError("all inputs must be on one device")
    return lows.shape[0]


def rans_reverse_encode_wide(lows: torch.Tensor, fqs: torch.Tensor,
                             rlens: torch.Tensor, max_rlen: int):
    """Reverse rANS of L chains: ops [0, 2*rlen) encoded back to front
    through 4 rotating states, bytes emitted backward.

    lows/fqs: (L, 2*max_rlen) uint16 op pairs; rlens: (L,) int32.  Returns
    (bufs (L, 4*max_rlen+16) uint8, ptrs (L,) int32): chain l's payload is
    bufs[l, ptrs[l]:], and bufs[l, :ptrs[l]] is zero."""
    L = _check_pairs(lows, fqs, rlens, max_rlen)
    if not lows.is_cuda:
        return rans_reverse_encode_wide_plain(lows, fqs, rlens, max_rlen)
    dev = lows.device
    bufs = torch.empty(L, 4 * max_rlen + 16, dtype=torch.uint8, device=dev)
    ptrs = torch.empty(L, dtype=torch.int32, device=dev)
    if L == 0:
        return bufs, ptrs
    lows, fqs, rlens = lows.contiguous(), fqs.contiguous(), rlens.contiguous()
    REVERSE_KERNEL.launch(ptr(lows), ptr(fqs), ptr(rlens), L, max_rlen,
                          ptr(bufs), ptr(ptrs), stream_of(lows))
    return bufs, ptrs


def _encode_at(lows, fqs, rlens, max_rlen: int, lanes: int):
    """For measurement only: K5 on CUDA tensors with `lanes` (8, 16 or 32)
    lanes a chain.  Same contract as rans_reverse_encode_wide."""
    L = _check_pairs(lows, fqs, rlens, max_rlen)
    if lanes not in (8, 16, 32):
        raise ValueError("lanes must be 8, 16 or 32")
    if not lows.is_cuda:
        raise ValueError("K5 runs on CUDA tensors only")
    dev = lows.device
    bufs = torch.empty(L, 4 * max_rlen + 16, dtype=torch.uint8, device=dev)
    ptrs = torch.empty(L, dtype=torch.int32, device=dev)
    if L:
        lows, fqs, rlens = lows.contiguous(), fqs.contiguous(), rlens.contiguous()
        _MEASURE.launch(ptr(lows), ptr(fqs), ptr(rlens), L, max_rlen, lanes,
                        ptr(bufs), ptr(ptrs), stream_of(lows))
    return bufs, ptrs


def rans_reverse_encode_wide_plain(lows, fqs, rlens, max_rlen: int):
    """Plain PyTorch version of K5: a Python loop over a common descending
    op index (chains with fewer ops join late), each emission written at
    its chain's pointer.  Same contract as rans_reverse_encode_wide."""
    L = _check_pairs(lows, fqs, rlens, max_rlen)
    dev = lows.device
    size = 4 * max_rlen + 16
    ncap = 2 * max_rlen
    # column `size` is a dump slot for the chains that emit nothing
    bufs = torch.zeros(L, size + 1, dtype=torch.uint8, device=dev)
    rows = torch.arange(L, device=dev)
    pos = torch.full((L,), size, dtype=torch.long, device=dev)
    R = torch.full((L, 4), RANS_BYTE_L, dtype=torch.long, device=dev)
    nops = (2 * rlens.long()).clamp(0, ncap)
    lo_all, fq_all = lows.long(), fqs.long()
    x_unit = (RANS_BYTE_L >> PROB_BITS) << 8

    def emit(need, x):
        nonlocal pos
        pos = pos - need.long()
        bufs[rows, torch.where(need, pos, size)] = (x & 0xFF).to(torch.uint8)

    steps = int(nops.max()) if L else 0
    for k in range(steps - 1, -1, -1):
        active = k < nops
        fq = fq_all[:, k].clamp(min=1)
        lo = lo_all[:, k]
        x = R[:, 3]
        x_max = x_unit * fq
        for _ in range(2):
            need = active & (x >= x_max)
            emit(need, x)
            x = torch.where(need, x >> 8, x)
        x = (((x // fq) << PROB_BITS) + (x % fq) + lo) & _M32
        rot = torch.cat([x[:, None], R[:, :3]], 1)
        R = torch.where(active[:, None], rot, R)
    for j in range(3, -1, -1):
        for b in range(3, -1, -1):
            emit(torch.ones(L, dtype=torch.bool, device=dev), R[:, j] >> (8 * b))
    return bufs[:, :size], pos.to(torch.int32)


def _divmod(x: torch.Tensor, fq: torch.Tensor):
    """For the check only: K5's division, q = x // fq and r = x % fq, for
    int64 tensors of uint32 values x and fq in 1..65535.  Returns (q, r)
    int64.  On CUDA tensors it launches K5's helper, else plain ops."""
    if x.dtype != torch.int64 or fq.dtype != torch.int64 or x.shape != fq.shape:
        raise ValueError("x and fq must be int64 tensors of one shape")
    if not x.is_cuda:
        return x // fq, x % fq

    def bits(t):  # the uint32 values as int32 bit patterns
        t = torch.where(t >= 1 << 31, t - (1 << 32), t)
        return t.to(torch.int32).contiguous()

    xs, fs = bits(x), bits(fq)
    q, r = torch.empty_like(xs), torch.empty_like(xs)
    _DIVMOD.launch(ptr(xs), ptr(fs), xs.numel(), ptr(q), ptr(r), stream_of(xs))
    return q.long() & _M32, r.long() & _M32
