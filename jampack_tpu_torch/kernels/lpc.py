"""The LPC filter recurrence, both directions: kernel K8 and its plain
version.

Counterpart of jampack_tpu/kernels/filters_search.py::_lpc_all (encode:
every (chunk, width) lane of the -f2 sweep, and the LPC rows of
encode_stages._filters_apply_rows) and of the recurrence inside
device_stages.filters_decode_dyn_core (decode).  filters.cpp:49-65.

lpc launches K8 (csrc/lpc.cu) for a CUDA tensor and runs lpc_plain for a
CPU tensor.
"""

import torch

from ._build import Kernel, ptr, stream_of

KERNEL = Kernel("lpc", "jt_lpc", "jampack_tpu_torch/csrc/lpc.cu",
                "jampack_tpu/kernels/filters_search.py:125")

_WEIGHT_RATE = 6  # filters.cpp:44


def _check(rows, lens):
    if rows.dtype != torch.uint8 or rows.dim() != 2:
        raise ValueError("rows must be a (B, W) uint8 tensor")
    if lens.dtype != torch.int32 or lens.shape != rows.shape[:1]:
        raise ValueError("lens must be (B,) int32")
    if rows.device != lens.device:
        raise ValueError("all inputs must be on one device")
    return rows.shape[0]


def lpc(rows: torch.Tensor, lens: torch.Tensor, decode: bool) -> torch.Tensor:
    """The order-2 adaptive-weight predictor over each row's first lens[b]
    bytes (clamped to [0, W]): residuals (decode=False) or the bytes back
    from residuals (decode=True).  rows: (B, W) uint8; lens: (B,) int32.
    Returns (B, W) uint8, zero past each length."""
    B = _check(rows, lens)
    if not rows.is_cuda:
        return lpc_plain(rows, lens, decode)
    W = rows.shape[1]
    if W % 16:
        raise ValueError("the kernel takes rows of a multiple of 16 bytes")
    out = torch.empty_like(rows)
    if B == 0:
        return out
    rows, lens = rows.contiguous(), lens.contiguous()
    if rows.data_ptr() % 16:
        raise ValueError("the kernel takes 16-byte aligned rows")
    KERNEL.launch(ptr(rows), W, ptr(lens), B, int(decode), ptr(out),
                  stream_of(rows))
    return out


def encode_step(weight: torch.Tensor, b: torch.Tensor):
    """One encode step in three-op form: b = (2 p1 - p2 - cur) & 0xFF,
    weight in [0, 255].  Returns (err, next weight); the weight's chain is
    an add, a shift and a multiply-add (the spec's is five ops:
    err = (weight + b) & 0xFF, weight += (err - weight) >> 6).  K8 carries
    S = weight + b instead, two ops a step (csrc/lpc.cu)."""
    s = weight + b
    return s & 0xFF, weight + (b >> _WEIGHT_RATE) - 4 * (s >> 8)


def lpc_plain(rows: torch.Tensor, lens: torch.Tensor, decode: bool):
    """Plain PyTorch version of K8: every row in lockstep, one Python step
    per position up to the longest length, int32 state; the encode's
    weight step in three-op form (encode_step).  A row's state
    runs on past its length unfrozen: nothing after that position reads
    it, and those outputs are zeroed.  Same contract as lpc."""
    B = _check(rows, lens)
    W = rows.shape[1]
    dev = rows.device
    lens = lens.clamp(0, W)
    steps = int(lens.max()) if B else 0
    x = rows[:, :steps].to(torch.int32).t().contiguous()  # (steps, B)
    out = torch.zeros(steps, B, dtype=torch.int32, device=dev)
    weight = torch.zeros(B, dtype=torch.int32, device=dev)
    if decode:
        p1 = torch.zeros_like(weight)
        p2 = torch.zeros_like(weight)
        for i in range(steps):
            err = x[i]
            cur = (weight + ((p1 - p2) + p1) - err) & 0xFF
            out[i] = cur
            weight += (err - weight) >> _WEIGHT_RATE
            p2, p1 = p1, cur
    else:
        # p1, p2 are the input bytes themselves: only weight is carried
        zero = torch.zeros(1, B, dtype=torch.int32, device=dev)
        p1 = torch.cat([zero, x])[:steps]
        p2 = torch.cat([zero, zero, x])[:steps]
        base = ((p1 - p2) + p1 - x) & 0xFF
        for i in range(steps):
            out[i], weight = encode_step(weight, base[i])
    res = torch.zeros(B, W, dtype=torch.uint8, device=dev)
    j = torch.arange(steps, device=dev)[None, :]
    res[:, :steps] = torch.where(j < lens[:, None], out.t(), 0).to(torch.uint8)
    return res
