"""The -f3 filter stage: the per-stage engine's device config search, in
torch ops.

Counterpart of jampack_tpu/kernels/filters.py (score_delta_configs,
pick_config_tpu, inline_delta_tpu), which the JAX per-stage engine runs
for -f3 (jampack_tpu/runtime/engines.py:138-158).  There is no serial
loop here, so no kernel: every 64 KiB chunk is scored for the order-0
entropy of its shifted differences at every width 1..32, all chunks at
once, and the picks, inline deltas, are applied by the filter stage of
the fused encode (encode_stages.filter_stage).  The chunk format is the
-f1/-f2 one, (type, width) ahead of each chunk, so the reference decodes
it.  The native engine has no -f3 (it clamps the mode to 2), so the picks
are this search's own.

The scores are computed in float64 where JAX sums float32 terms: equal
scores stay equal whatever the summation order, and a pick can differ
from JAX's only where the least score of a chunk and the next (or the
least and the raw score less PICK_MARGIN) lie within float32 rounding of
each other (ROADMAP C8).
"""

import numpy as np
import torch

from ..format.constants import FILTER_MAX_WIDTH
from .encode_stages import filter_rows, filter_stage

# a width must beat the raw entropy by this many bits a byte: the order-0
# entropy of shifted differences fluctuates by a few centibits on
# incompressible data (pick_config_tpu)
PICK_MARGIN = 0.05


def _entropy(counts: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Order-0 entropy in bits a byte of each row of (F, 256) counts."""
    p = counts.double() / lens.clamp(min=1).double()[:, None]
    return -torch.where(counts > 0, p * torch.log2(p.clamp(min=1e-300)),
                        0.0).sum(1)


def score_delta_configs(rows: torch.Tensor, lens: torch.Tensor):
    """(F, 33) float64 scores of the (F, FBS) chunk rows (lens bytes
    valid): column 0 the raw order-0 entropy, column w that of the width-w
    differences (chunk[i] - chunk[i - w], the first w bytes raw), as JAX's
    score_delta_configs."""
    F, fbs = rows.shape
    dev = rows.device
    rows = rows.long()
    lens = lens.long()
    valid = torch.arange(fbs, device=dev)[None, :] < lens[:, None]
    base = torch.arange(F, device=dev)[:, None] * 256
    dump = F * 256

    def counts(v):
        idx = torch.where(valid, base + v, dump).reshape(-1)
        return torch.bincount(idx, minlength=dump + 1)[:dump].view(F, 256)

    scores = [_entropy(counts(rows), lens)]
    for w in range(1, FILTER_MAX_WIDTH + 1):
        prev = torch.zeros_like(rows)
        prev[:, w:] = rows[:, :-w]
        scores.append(_entropy(counts((rows - prev) & 0xFF), lens))
    return torch.stack(scores, 1)


def pick_configs(scores: np.ndarray, lens) -> list:
    """(type, width) of each chunk, as JAX's pick_config_tpu: the width of
    the least score (the first on ties), inline delta (type 2), unless it
    is raw or fails to beat the raw score by PICK_MARGIN; (0, 0) for an
    empty chunk."""
    picks = []
    for s, n in zip(scores, lens):
        w = int(np.argmin(s))
        if n == 0 or w == 0 or s[w] >= s[0] - PICK_MARGIN:
            picks.append((0, 0))
        else:
            picks.append((2, w))
    return picks


def filters_encode_f3(data: torch.Tensor) -> torch.Tensor:
    """The -f3 filter stage of a (n,) uint8 tensor on its device: every
    chunk's (type, width) ahead of its bytes, byte-identical to
    TpuEngine().filters_encode(data, 3) wherever no near-tie decides a
    pick."""
    if data.numel() == 0:
        return torch.zeros(0, dtype=torch.uint8, device=data.device)
    rows, lens, lens_np = filter_rows(data)
    picks = pick_configs(score_delta_configs(rows, lens).cpu().numpy(),
                         lens_np)
    return filter_stage(data, picks)
