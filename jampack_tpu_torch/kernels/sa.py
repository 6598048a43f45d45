"""Forward BWT: the suffix array by prefix doubling on torch.sort.

Counterpart of jampack_tpu/kernels/sa.py (_pack4, _sa_doubling_sorted,
sa_doubling_core, bwt_from_prev_sorted, forward_bwt_tpu).  Sorts, scans and
gathers only, plain PyTorch on either device.

The JAX version sorts with a multi-key lax.sort because JAX runs without
64-bit integers; here every round sorts one int64 key:

* the initial key packs a suffix's first 7 bytes big-endian (zeros past
  the end) above min(remaining, 7), so a suffix that is a prefix of another
  sorts first, as the reference's rotation order requires;
* a doubling round's key is rank[i] << 32 | (rank[i + k] + 1), with 0 for
  i + k past the end (the JAX version's -1).

Every suffix is distinct, so the final order is the one suffix array
whatever the sort does with ties on the way.  Tensors are sized by the
actual length; there are no capacity variants.
"""

import torch
import torch.nn.functional as F

_K0 = 7  # bytes in the initial key


def _pack(t: torch.Tensor, n: int, nbytes: int) -> torch.Tensor:
    """Big-endian pack of bytes [i, i+nbytes) per position as int64, zeros
    past the end (the JAX _pack4, widened to one int64 key)."""
    t64 = t.long()
    words = torch.zeros(n, dtype=torch.long, device=t.device)
    for j in range(nbytes):
        shifted = F.pad(t64[j:], (0, min(j, n)))
        words |= shifted << (8 * (nbytes - 1 - j))
    return words


def _rank_of_sorted(keys_sorted: torch.Tensor) -> torch.Tensor:
    """Dense rank of each entry of a sorted key array (equal keys, equal
    rank)."""
    bound = torch.ones_like(keys_sorted)
    bound[1:] = (keys_sorted[1:] != keys_sorted[:-1]).long()
    return torch.cumsum(bound, 0) - 1


def _sa_doubling_sorted(t: torch.Tensor, n: int, stats: dict = None):
    """Prefix doubling.  Returns (order, rank_sorted): order is the suffix
    array and rank_sorted[j] = j once every rank is distinct.  With a dict
    `stats`, stats["rounds"] is the number of doubling rounds (each ends in
    one host sync, the fetch of the largest rank)."""
    dev = t.device
    pos = torch.arange(n, dtype=torch.long, device=dev)
    rem = torch.clamp(n - pos, max=_K0)
    keys, order = torch.sort((_pack(t, n, _K0) << 3) | rem)
    rank_sorted = _rank_of_sorted(keys)
    k = _K0
    rounds = 0
    while int(rank_sorted[-1]) != n - 1 and k < 2 * n:
        rank = torch.empty_like(rank_sorted)
        rank[order] = rank_sorted
        second = F.pad(rank[k:] + 1, (0, min(k, n)))
        keys, order = torch.sort((rank << 32) | second)
        rank_sorted = _rank_of_sorted(keys)
        k *= 2
        rounds += 1
    if stats is not None:
        stats["rounds"] = rounds
    return order, rank_sorted


def sa_doubling_core(t: torch.Tensor, n: int, stats: dict = None):
    """(order, isa, prev_sorted) of t[:n]: the suffix array, its inverse,
    and prev_sorted[j] = t[(order[j] - 1) mod n], the BWT payload.  `stats`
    as in _sa_doubling_sorted."""
    order, rank_sorted = _sa_doubling_sorted(t, n, stats)
    isa = torch.empty_like(order)
    isa[order] = rank_sorted
    prev_sorted = t[(order - 1) % n]
    return order, isa, prev_sorted


def bwt_from_prev_sorted(prev_sorted: torch.Tensor, idx: torch.Tensor,
                         nlen: int) -> torch.Tensor:
    """BWT emission (bwt.cpp:50-58): the primary row dropped by a shift and
    select.  out[0] = t[nlen-1] = prev_sorted[idx] (the row of suffix 0)."""
    pos = torch.arange(nlen, device=prev_sorted.device)
    shifted = torch.cat([prev_sorted[:1], prev_sorted[:-1]])
    out = torch.where(pos <= idx, shifted, prev_sorted)
    out[0] = prev_sorted[idx]
    return out.to(torch.uint8)


def forward_bwt(data: torch.Tensor, units: int = 120) -> torch.Tensor:
    """Forward BWT of a (n,) uint8 tensor on its device, format-identical to
    stages.bwt.forward_bwt: the BWT of the first n - n % units bytes, the
    trailing n % units bytes raw, then `units` little-endian int32 anchors
    ISA[u * step] + 1 (zeros when no full row exists)."""
    n = data.numel()
    out = torch.zeros(n + 4 * units, dtype=torch.uint8, device=data.device)
    nlen = n - n % units
    out[nlen:n] = data[nlen:n]
    if nlen > 0:
        _, isa, prev_sorted = sa_doubling_core(data[:nlen], nlen)
        out[:nlen] = bwt_from_prev_sorted(prev_sorted, isa[0], nlen)
        step = nlen // units
        anchors = isa[: units * step: step] + 1  # bwt.cpp:44-48
        shifts = torch.tensor([0, 8, 16, 24], device=data.device)
        out[n:] = ((anchors[:, None] >> shifts) & 0xFF).to(torch.uint8).reshape(-1)
    return out
