"""SRC rank decode: kernel K2 and its plain version.

Counterpart of jampack_tpu/kernels/device_stages.py::rank_setup_core and
rank_decode_core (the spec) and rank_pallas.py::rank_decode_pallas (the TPU
kernel).  Each chunk's ranks decode through a serial MTF walk over its
symbol buckets (rank.cpp:96-151).

rank_decode launches K2 (csrc/rank_decode.cu, setup and walk in one
launch, one warp per chunk) for a CUDA tensor and runs rank_decode_plain
for a CPU tensor.
"""

import torch

from ._build import Kernel, load, ptr, stream_of

KERNEL = Kernel("rank_decode", "jt_rank_decode",
                "jampack_tpu_torch/csrc/rank_decode.cu",
                "jampack_tpu/kernels/rank_pallas.py:36")


def _check(ranks, freqs, olens, out_cap):
    if ranks.dtype != torch.uint8 or ranks.dim() != 2:
        raise ValueError("ranks must be a (L, W) uint8 tensor")
    L = ranks.shape[0]
    if freqs.dtype != torch.int32 or freqs.shape != (L, 256):
        raise ValueError("freqs must be (L, 256) int32")
    if olens.dtype != torch.int32 or olens.shape != (L,):
        raise ValueError("olens must be (L,) int32")
    if not (ranks.device == freqs.device == olens.device):
        raise ValueError("all inputs must be on one device")
    if ranks.shape[1] < 1 or out_cap < 0:
        raise ValueError("ranks rows must be non-empty and out_cap >= 0")
    return L


def rank_decode(ranks: torch.Tensor, freqs: torch.Tensor,
                olens: torch.Tensor, out_cap: int):
    """Decode L chunks.

    ranks: (L, W) uint8 rank rows; freqs: (L, 256) int32 frequency tables;
    olens: (L,) int32 chunk lengths (<= 0 marks padding).  Returns
    (out (L, out_cap) uint8, zero past each olen; ok (L,) bool).
    """
    L = _check(ranks, freqs, olens, out_cap)
    if not ranks.is_cuda:
        return rank_decode_plain(ranks, freqs, olens, out_cap)
    out = torch.empty(L, out_cap, dtype=torch.uint8, device=ranks.device)
    ok = torch.empty(L, dtype=torch.uint8, device=ranks.device)
    if L == 0:
        return out, ok.bool()
    ranks, freqs, olens = ranks.contiguous(), freqs.contiguous(), olens.contiguous()
    KERNEL.launch(ptr(ranks), ranks.shape[1], ptr(freqs), ptr(olens), L,
                  out_cap, ptr(out), ptr(ok), stream_of(ranks))
    return out, ok.bool()


def rank_decode_path(ranks_w: int) -> str:
    """The path K2 takes for rank rows of width ranks_w: "staged" (the row
    in shared memory) or "direct" (read in place).  Needs the kernels."""
    return "staged" if load().jt_rank_decode_staged(ranks_w) else "direct"


def rank_setup(ranks: torch.Tensor, freqs: torch.Tensor):
    """Per-chunk decoder state (rank.cpp:96-123): buckets laid out in
    descending frequency (ties to the lowest symbol), r2s seeded with the
    first rank of each bucket in that order (later buckets win).
    Returns (r2s, bucket, bucket_end, unique, sym0, total), int32/int64."""
    L, W = ranks.shape
    f = freqs.int()
    negs, sorted_sym = torch.sort(-f, dim=1, stable=True)
    sorted_freq = -negs
    base = torch.cumsum(sorted_freq, 1, dtype=torch.int32) - sorted_freq
    has = sorted_freq > 0
    bucket = torch.zeros_like(f).scatter_(
        1, sorted_sym, torch.where(has, base + 1, 0))
    bucket_end = torch.zeros_like(f).scatter_(
        1, sorted_sym, torch.where(has, base + sorted_freq, 0))
    unique = has.sum(1).int()
    # r2s[ranks[base_j]] = sym_j in sorted order, later j wins: the last j
    # that names each rank value
    r = ranks.gather(1, base.clamp(0, W - 1).long()).long()
    key = torch.where(has, r, 256)
    j = torch.arange(256, device=ranks.device).expand(L, 256)
    last = torch.full((L, 257), -1, dtype=torch.long, device=ranks.device)
    last.scatter_reduce_(1, key, j, reduce="amax")
    r2s = torch.where(last >= 0, sorted_sym.gather(1, last.clamp(min=0)),
                      0)[:, :256]
    total = f.sum(1).int()
    return r2s, bucket, bucket_end, unique, r2s[:, 0], total


def rank_decode_plain(ranks, freqs, olens, out_cap: int):
    """Plain PyTorch version of K2: a Python loop over steps, all chunks in
    lockstep with masked tensor ops.  Same contract as rank_decode."""
    L = _check(ranks, freqs, olens, out_cap)
    dev = ranks.device
    W = ranks.shape[1]
    r2s, bucket, bucket_end, unique, sym, total = rank_setup(ranks, freqs)
    ok = (total == olens.clamp(min=0)) | (olens <= 0)
    out = torch.zeros(L, out_cap, dtype=torch.uint8, device=dev)
    cols = torch.arange(256, device=dev)[None, :]
    steps = min(max(int(olens.max()) if L else 0, 0), out_cap)
    for i in range(steps):
        active = i < olens
        out[:, i] = torch.where(active, sym, 0).to(torch.uint8)
        s = sym[:, None]
        cur = bucket.gather(1, s)[:, 0]
        has = active & (cur < bucket_end.gather(1, s)[:, 0])
        rank = ranks.gather(1, cur.clamp(0, W - 1).long()[:, None])[:, 0].long()
        do_mtf = has & (rank > 0)
        fall = active & ~has & (unique > 0)
        unique = torch.where(fall, unique - 1, unique)
        m = unique.clamp(min=1)
        shifted = torch.cat([r2s[:, 1:], r2s[:, -1:]], 1)
        shift_mask = torch.where(do_mtf[:, None], cols < rank[:, None],
                                 fall[:, None] & (cols < m[:, None]))
        set_mask = do_mtf[:, None] & (cols == rank[:, None])
        r2s = torch.where(set_mask, s, torch.where(shift_mask, shifted, r2s))
        bucket.scatter_add_(1, s, has[:, None].int())
        sym = torch.where(do_mtf | fall, r2s[:, 0], sym)
    return out, ok
