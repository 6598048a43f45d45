"""Inverse BWT: the LF map and the anchored chase (kernel K3).

Counterpart of jampack_tpu/kernels/ibwt.py::combined_map_core and
chase_combined_core and of the fori_loop chase inside
device_stages.ibwt_dyn_core.  The map is one stable sort (outside any
kernel, as the JAX package leaves it to lax.sort); the chase walks `units`
independent LF chains (the reference's anchored decode units, bwt.cpp:8-19).

The map is two arrays, lf (int32) and the value-sorted bytes, instead of
JAX's (lf << 8 | byte) uint32 pack, which existed only because JAX runs
without 64-bit integers and capped blocks at 2^24 bytes.

chase launches K3 (csrc/ibwt_chase.cu) for a CUDA tensor and runs
chase_plain for a CPU tensor.  K3 walks by pointer jumping: a jump table
g^JUMP, an anchor walk that records where each JUMP-long sub-chain of the
output starts, and one thread a sub-chain; chase_jump_plain is the same
three phases in tensor ops.
"""

import torch

from ._build import Kernel, ptr, stream_of

KERNEL = Kernel("ibwt_chase", "jt_ibwt_chase",
                "jampack_tpu_torch/csrc/ibwt_chase.cu",
                "jampack_tpu/kernels/device_stages.py:654")

# K3 at other sub-chain lengths, stopping after any phase: chip_smoke.py's
# measurement of D, through _chase_at; no path launches it.
_MEASURE = Kernel("ibwt_chase_at", "jt_ibwt_chase_at",
                  "jampack_tpu_torch/csrc/ibwt_chase.cu",
                  "jampack_tpu/kernels/device_stages.py:654")

# K3's sub-chain length D: the jump table is g^JUMP and the output is cut
# into sub-chains of JUMP steps.  It is kJump in csrc/ibwt_chase.cu, fixed
# there (PERF.md has the sweep that chose it); chase_jump_plain takes it.
JUMP = 32


def combined_map(bwt: torch.Tensor, idx: torch.Tensor):
    """LF map of a BWT body with primary index `idx` (0-d tensor).

    Returns (lf (nlen,) int32, sbyte (nlen,) uint8): stepping through entry
    j emits sbyte[j] and moves to lf[j] (bwt.cpp:141-174 semantics).  The
    value-sorted BWT is exactly the byte each entry emits, so one stable
    sort gives both."""
    sbyte, order = torch.sort(bwt, stable=True)
    lf = (order + (order >= idx).long()).to(torch.int32)
    return lf, sbyte


def _check(lf, sbyte, anchors, units):
    if lf.dtype != torch.int32 or sbyte.dtype != torch.uint8:
        raise ValueError("lf must be int32 and sbyte uint8")
    if lf.dim() != 1 or lf.shape != sbyte.shape:
        raise ValueError("lf and sbyte must be (nlen,)")
    if anchors.dtype != torch.int32 or anchors.shape != (units,):
        raise ValueError("anchors must be (units,) int32")
    if not (lf.device == sbyte.device == anchors.device):
        raise ValueError("all inputs must be on one device")
    nlen = lf.shape[0]
    if units < 1 or nlen % units:
        raise ValueError("nlen must be a multiple of units >= 1")
    if nlen >= 1 << 31:
        raise ValueError("nlen must be below 2^31")
    return nlen


def chase(lf: torch.Tensor, sbyte: torch.Tensor, anchors: torch.Tensor,
          units: int) -> torch.Tensor:
    """Walk `units` LF chains of nlen // units steps from their anchors.
    Returns the BWT body (nlen,) uint8: chain u's step s lands at
    u * step + s.  On the card K3 takes 2 * nlen int32 of scratch for its
    jump tables and sub-chain entries (67 MB for an 8 MiB block)."""
    nlen = _check(lf, sbyte, anchors, units)
    if not lf.is_cuda:
        return chase_plain(lf, sbyte, anchors, units)
    out, args = _launch_args(lf, sbyte, anchors, units, nlen)
    if nlen:
        KERNEL.launch(*args, stream_of(lf))
    return out


def _launch_args(lf, sbyte, anchors, units, nlen):
    out = torch.empty(nlen, dtype=torch.uint8, device=lf.device)
    lf, sbyte, anchors = lf.contiguous(), sbyte.contiguous(), anchors.contiguous()
    ga = torch.empty(nlen, dtype=torch.int32, device=lf.device)
    gb = torch.empty_like(ga)
    return out, [ptr(lf), ptr(sbyte), ptr(anchors), nlen, units,
                 nlen // units, ptr(ga), ptr(gb), ptr(out)]


def _chase_at(lf, sbyte, anchors, units: int, depth: int,
              phases: int = 3) -> torch.Tensor:
    """For measurement only: K3 on CUDA tensors with sub-chains of `depth`
    (16, 32, 64 or 128) steps; phases < 3 stops after the jump table (1)
    or the anchor walk (2) and leaves the output unwritten."""
    nlen = _check(lf, sbyte, anchors, units)
    if depth not in (16, 32, 64, 128) or phases not in (1, 2, 3):
        raise ValueError("depth must be 16, 32, 64 or 128 and phases 1-3")
    if not lf.is_cuda:
        raise ValueError("K3 runs on CUDA tensors only")
    out, args = _launch_args(lf, sbyte, anchors, units, nlen)
    if nlen:
        _MEASURE.launch(*args[:6], depth, *args[6:], phases, stream_of(lf))
    return out


def chase_plain(lf, sbyte, anchors, units: int) -> torch.Tensor:
    """Plain PyTorch version of K3: a Python loop over steps, all chains in
    lockstep.  Same contract as chase."""
    nlen = _check(lf, sbyte, anchors, units)
    step = nlen // units
    out = torch.zeros(units, step, dtype=torch.uint8, device=lf.device)
    p = anchors.long().clamp(1, max(nlen, 1))
    lf64 = lf.long()
    for s in range(step):
        j = (p - 1).clamp(0, nlen - 1)
        out[:, s] = sbyte[j]
        p = lf64[j]
    return out.reshape(-1)


def chase_jump_plain(lf, sbyte, anchors, units: int,
                     depth: int = JUMP) -> torch.Tensor:
    """K3's decomposition in tensor ops, for the CPU tests: the jump table
    g^depth by squaring, the anchor walk that records the map entry at
    every multiple of depth in the output, and the sub-chains of depth
    steps, all in lockstep.  Same contract as chase."""
    nlen = _check(lf, sbyte, anchors, units)
    if depth < 2 or depth & (depth - 1):
        raise ValueError("depth must be a power of two >= 2")
    dev = lf.device
    if nlen == 0:
        return torch.zeros(0, dtype=torch.uint8, device=dev)
    step = nlen // units
    g = (lf.long() - 1).clamp(0, nlen - 1)
    j0 = anchors.long().clamp(1, nlen) - 1
    # 1. the jump table G = g^depth
    G = g[g]
    for _ in range(depth.bit_length() - 2):
        G = G[G]
    # 2. the anchor walk: single steps to each chain's first cut, then jumps
    begin = torch.arange(units, device=dev) * step
    c = (begin + depth - 1) // depth
    lead = c * depth - begin
    j = j0.clone()
    for k in range(depth - 1):
        j = torch.where(k < lead, g[j], j)
    count = -(-nlen // depth)
    entry = torch.zeros(count, dtype=torch.long, device=dev)
    while True:
        live = c * depth < begin + step
        if not bool(live.any()):
            break
        entry[c[live]] = j[live]
        j, c = G[j], c + 1
    # 3. the sub-chains, restarting at the next anchor past a chain's end
    p0 = torch.arange(count, device=dev) * depth
    u = p0 // step
    s = p0 - u * step
    j = entry
    out = torch.zeros(count, depth, dtype=torch.uint8, device=dev)
    for k in range(depth):
        cross = s == step
        u = u + cross.long()
        s = torch.where(cross, 0, s)
        j = torch.where(cross & (u < units), j0[u.clamp(max=units - 1)], j)
        out[:, k] = sbyte[j]
        j, s = g[j], s + 1
    return out.reshape(-1)[:nlen]
