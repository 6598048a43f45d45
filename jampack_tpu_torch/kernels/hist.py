"""Order-1 joint histograms of filter lanes: kernel K7 and its plain version.

Counterpart of jampack_tpu/kernels/pallas_hist.py::joint_hist_pallas (the
TPU kernel, B4) and filters_search._group_joint_xla (its spec).  Lane b's
table counts the pairs (prev, cur) of its first lens[b] bytes, the context
starting at 0; the counts are exact int32 (the JAX functions give the same
integers as f32).

joint_hist launches K7 (csrc/joint_hist.cu) for a CUDA tensor and runs
joint_hist_plain for a CPU tensor.
"""

import torch

from ._build import Kernel, ptr, stream_of

KERNEL = Kernel("joint_hist", "jt_joint_hist",
                "jampack_tpu_torch/csrc/joint_hist.cu",
                "jampack_tpu/kernels/pallas_hist.py:27")


def _check(streams, lens):
    if streams.dtype != torch.uint8 or streams.dim() != 2:
        raise ValueError("streams must be a (B, W) uint8 tensor")
    if lens.dtype != torch.int32 or lens.shape != streams.shape[:1]:
        raise ValueError("lens must be (B,) int32")
    if streams.device != lens.device:
        raise ValueError("all inputs must be on one device")
    return streams.shape[0]


def joint_hist(streams: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """streams: (B, W) uint8 lanes; lens: (B,) int32 valid lengths (clamped
    to [0, W]).  Returns (B, 256, 256) int32 counts [prev][cur]."""
    B = _check(streams, lens)
    if not streams.is_cuda:
        return joint_hist_plain(streams, lens)
    W = streams.shape[1]
    if W % 16 or W > 65536:
        raise ValueError("the kernel takes lanes of a multiple of 16 bytes, "
                         "at most 65,536 (its counters hold up to 2^16)")
    out = torch.empty(B, 256, 256, dtype=torch.int32, device=streams.device)
    if B == 0:
        return out
    streams, lens = streams.contiguous(), lens.contiguous()
    if streams.data_ptr() % 16:
        raise ValueError("the kernel takes 16-byte aligned lanes")
    KERNEL.launch(ptr(streams), W, ptr(lens), B, ptr(out), stream_of(streams))
    return out


def pair_keys(streams: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """lane * 65536 + prev * 256 + cur of every position, the positions at
    or past their lane's length mapped to B * 65536 (one bin past the
    last table)."""
    B, W = streams.shape
    s = streams.long()
    prev = torch.cat([torch.zeros(B, 1, dtype=torch.long, device=s.device),
                      s[:, :-1]], 1)
    j = torch.arange(W, device=s.device)[None, :]
    lane = torch.arange(B, device=s.device)[:, None]
    return torch.where(j < lens[:, None], lane * 65536 + prev * 256 + s,
                       B * 65536).reshape(-1)


def joint_hist_plain(streams: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K7: one scatter_add_ over the pair keys.
    Same contract as joint_hist."""
    B = _check(streams, lens)
    keys = pair_keys(streams, lens)
    out = torch.zeros(B * 65536 + 1, dtype=torch.int32, device=streams.device)
    out.scatter_add_(0, keys, torch.ones_like(keys, dtype=torch.int32))
    return out[:-1].view(B, 256, 256)
