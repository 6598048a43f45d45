"""Cases of the inverse-BWT chase (K3) that its pointer-jumping walk has to
get right, shared by the CPU and GPU tests.

stage(name) gives (stage buffer: BWT body + raw tail + anchors, units) for
the cases made by a real forward BWT, or None; chase_inputs(name) gives the
chase's inputs (lf int32, sbyte uint8, anchors int32, units) as CPU
tensors."""

import numpy as np
import torch

from jampack_tpu.runtime.engines import NativeEngine
from jampack_tpu_torch.kernels import device_stages, ibwt

CASES = ["short_chains", "ragged", "one_unit", "lf_zero", "corrupt_anchors",
         "period2", "all_equal", "past_2_23"]


def _text(n, seed):
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b" etaoinshrdlu.,\n", np.uint8)
    return alpha[rng.integers(0, alpha.size, n)]


def source(name: str):
    """(data, units) of the cases made by a forward BWT, else None."""
    if name == "short_chains":  # 5 steps a chain: shorter than any D
        return _text(120 * 5 + 7, 1), 120
    if name == "ragged":  # 1,000 steps a chain: not a multiple of D
        return _text(8 * 1000 + 3, 2), 8
    if name == "one_unit":
        return _text(5000, 3), 1
    if name == "corrupt_anchors":
        return _text(24 * 333, 4), 24
    if name == "period2":
        return np.tile(np.frombuffer(b"ab", np.uint8), 3000), 24
    if name == "all_equal":
        return np.full(7000, ord("x"), np.uint8), 24
    if name == "past_2_23":  # a body of more than 2^23 entries
        return _text((1 << 23) + 240, 9), 960
    return None


def stage(name: str):
    src = source(name)
    if src is None:
        return None
    data, units = src
    buf = np.asarray(NativeEngine().bwt_forward(data, units), np.uint8).copy()
    if name == "corrupt_anchors":  # anchors 0, past the body, negative
        n = buf.size - 4 * units
        for u, v in ((3, 0), (7, n + 50), (11, -5)):
            buf[n + 4 * u:n + 4 * u + 4] = np.frombuffer(
                np.int32(v).tobytes(), np.uint8)
    return buf, units


def chase_inputs(name: str):
    if name == "lf_zero":  # a map with many lf = 0 entries (the clamp)
        rng = np.random.default_rng(5)
        units, step = 7, 300
        nlen = units * step
        lf = rng.integers(0, nlen + 1, nlen)
        lf[rng.random(nlen) < 0.2] = 0
        return (torch.from_numpy(lf.astype(np.int32)),
                torch.from_numpy(rng.integers(0, 256, nlen).astype(np.uint8)),
                torch.from_numpy(rng.integers(1, nlen + 1, units).astype(
                    np.int32)), units)
    buf, units = stage(name)
    t = torch.from_numpy(buf)
    m = t.numel() - 4 * units
    nlen = m - m % units
    anchors = device_stages.read_anchors(t, m, units)
    lf, sbyte = ibwt.combined_map(t[:nlen], anchors[0])
    return lf, sbyte, anchors, units
