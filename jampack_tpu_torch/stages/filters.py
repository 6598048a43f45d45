"""The filter transforms and their float64 entropy scorers, in numpy: the
port's copy of the encode half of jampack_tpu/stages/filters.py
(filters.cpp:21-142 transforms, utils.cpp:111-141 scorers).

The device search (kernels/filters_search.py) scores every config in f32
on the card; these scorers re-score the near-ties in float64 so that the
picks, and with them the archive bytes, are the reference's.
"""

import numpy as np

_WEIGHT_RATE = 6  # filters.cpp:44


def delta_encode(buf: np.ndarray) -> np.ndarray:
    out = np.empty_like(buf)
    out[0:1] = buf[0:1]
    out[1:] = buf[1:] - buf[:-1]
    return out


def lpc_encode(buf: np.ndarray) -> np.ndarray:
    """Order-2 adaptive-weight predictor, serial (filters.cpp:49-65)."""
    out = np.empty_like(buf)
    weight = 0
    p1 = p2 = 0
    for i, cur in enumerate(buf.tolist()):
        err = (weight + (((p1 - p2) + p1) - cur)) & 0xFF
        out[i] = err
        weight += (err - weight) >> _WEIGHT_RATE
        p2 = p1
        p1 = cur
    return out


def lpc_decode(buf: np.ndarray) -> np.ndarray:
    out = np.empty_like(buf)
    weight = 0
    p1 = p2 = 0
    for i, err in enumerate(buf.tolist()):
        cur = (weight + (((p1 - p2) + p1) - err)) & 0xFF
        out[i] = cur
        weight += (err - weight) >> _WEIGHT_RATE
        p2 = p1
        p1 = cur
    return out


def reorder(buf: np.ndarray, width: int) -> np.ndarray:
    n = buf.size
    idx = np.concatenate([np.arange(i, n, width) for i in range(width)])
    return buf[idx]


def inline_delta(buf: np.ndarray, width: int) -> np.ndarray:
    """Per-channel delta without reordering (filters.cpp:101-120)."""
    n = buf.size
    out = np.empty_like(buf)
    align = n % width
    out[:align] = buf[:align]
    body = buf[align:].reshape(-1, width)
    if body.shape[0]:
        d = np.empty_like(body)
        d[0] = body[0]
        d[1:] = body[1:] - body[:-1]
        out[align:] = d.reshape(-1)
    return out


def _apply(buf: np.ndarray, ftype: int, width: int) -> np.ndarray:
    if width == 0:
        return buf
    if ftype == 0:
        return delta_encode(reorder(buf, width))
    if ftype == 1:
        return lpc_encode(reorder(buf, width))
    if ftype == 2:
        return inline_delta(buf, width)
    raise ValueError("unsupported filter type")


def order0_entropy(buf: np.ndarray) -> float:
    if buf.size == 0:
        return 0.0
    freqs = np.bincount(buf, minlength=256)
    p = freqs[freqs > 0] / buf.size
    return float(-(p * np.log2(p)).sum())


def mixed_entropy(buf: np.ndarray) -> float:
    """(order0 + order1) / 2, the -f2 scoring metric (utils.cpp:111-116)."""
    if buf.size == 0:
        return 0.0
    o0 = order0_entropy(buf)
    ctx = np.zeros(buf.size, dtype=np.int64)
    ctx[1:] = buf[:-1]
    joint = np.bincount(ctx * 256 + buf, minlength=65536).reshape(256, 256)
    tot = joint.sum(axis=1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        p = joint / np.maximum(tot, 1)
        h = np.where(joint > 0, -np.log2(np.maximum(p, 1e-300)) * joint, 0.0)
    o1 = float(h.sum() / buf.size)
    return (o0 + o1) / 2


def sorted_entropy(buf: np.ndarray) -> float:
    """Order-1 entropy of a counting-sort-induced generalized BWT, the -f1
    scoring metric (utils.cpp:122-141)."""
    n = buf.size
    if n == 0:
        return 0.0
    prev = np.roll(buf, 1)  # sbuf[bucket[ptr[i]]++] = ptr[(i-1) % len]
    order = np.argsort(buf, kind="stable")
    sbuf = prev[order]
    ctx = np.zeros(n, dtype=np.int64)
    ctx[1:] = sbuf[:-1]
    joint = np.bincount(ctx * 256 + sbuf, minlength=65536).reshape(256, 256)
    tot = joint.sum(axis=1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        p = joint / np.maximum(tot, 1)
        h = np.where(joint > 0, -np.log2(np.maximum(p, 1e-300)) * joint, 0.0)
    return float(h.sum() / n)
