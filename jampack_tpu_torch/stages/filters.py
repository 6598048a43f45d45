"""Structure filters: delta / LPC / inline-delta over 1..32-wide channels.

Per 64 KB chunk the encoder picks one of 96 (type,width) configs or raw and
emits a 2-byte (type,width) chunk header followed by the transformed bytes.
The transforms and the header layout are format-visible and exact; the
*selection* heuristics are encoder-side freedom (any config decodes), so the
scoring here is a vectorized reformulation of the reference's entropy
heuristics rather than a float-exact replica.

Reference behavior: filters.cpp:21-142 (transforms), 147-218 (width
detection), 223-440 (selection + framing), 442-490 (decode).
"""

import numpy as np

from ..format.constants import FILTER_BLOCK_SIZE, FILTER_MAX_TYPES, FILTER_MAX_WIDTH

_WEIGHT_RATE = 6  # filters.cpp:44


def delta_encode(buf: np.ndarray) -> np.ndarray:
    out = np.empty_like(buf)
    out[0:1] = buf[0:1]
    out[1:] = buf[1:] - buf[:-1]
    return out


def delta_decode(buf: np.ndarray) -> np.ndarray:
    return np.cumsum(buf, dtype=np.uint8).astype(np.uint8) if buf.size else buf.copy()


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


def unreorder(buf: np.ndarray, width: int) -> np.ndarray:
    n = buf.size
    idx = np.concatenate([np.arange(i, n, width) for i in range(width)])
    out = np.empty_like(buf)
    out[idx] = buf
    return out


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


def inline_undelta(buf: np.ndarray, width: int) -> np.ndarray:
    n = buf.size
    out = np.empty_like(buf)
    align = n % width
    out[:align] = buf[:align]
    body = buf[align:].reshape(-1, width)
    out[align:] = np.cumsum(body, axis=0, dtype=np.uint8).reshape(-1)
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


def _unapply(buf: np.ndarray, ftype: int, width: int) -> np.ndarray:
    if width == 0:
        return buf
    if ftype == 0:
        return unreorder(delta_decode(buf), width)
    if ftype == 1:
        return unreorder(lpc_decode(buf), width)
    if ftype == 2:
        return inline_undelta(buf, width)
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


def find_stride(buf: np.ndarray) -> int:
    """Distance histogram channel-width detector (filters.cpp:147-178)."""
    n = buf.size
    hist = np.zeros(FILTER_MAX_WIDTH + 1, dtype=np.int64)
    dist = np.zeros(256, dtype=np.int64)
    for i, sym in enumerate(buf.tolist()):
        stride = i - dist[sym]
        dist[sym] = i
        hist[stride % (FILTER_MAX_WIDTH + 1)] += 1
    average = int(hist.sum()) // (FILTER_MAX_WIDTH + 1)
    smallest = 0
    mn = hist[0]
    for j in range(1, FILTER_MAX_WIDTH + 1):
        if hist[j] > average * 2 and hist[j] > mn:
            mn = hist[j]
            smallest = j
    return smallest


def find_projection(buf: np.ndarray) -> int:
    """Second-order stride detector for LPC channels (filters.cpp:183-218)."""
    hist = np.zeros(FILTER_MAX_WIDTH + 1, dtype=np.int64)
    dist0 = np.zeros(256, dtype=np.int64)
    dist1 = np.zeros(256, dtype=np.int64)
    for i, sym in enumerate(buf.tolist()):
        stride = i - dist0[sym]
        projection = i - dist1[stride % 256]
        dist1[stride % 256] = i
        dist0[sym] = i
        hist[projection % (FILTER_MAX_WIDTH + 1)] += 1
    average = int(hist.sum()) // (FILTER_MAX_WIDTH + 1)
    smallest = 0
    mn = hist[0]
    for j in range(1, FILTER_MAX_WIDTH + 1):
        if hist[j] > average * 2 and hist[j] > mn:
            mn = hist[j]
            smallest = j
    return smallest


def filters_encode(data: np.ndarray, mode: int = 1) -> np.ndarray:
    """mode: 0 = raw pass-through, 1 = heuristic, 2 = brute force."""
    data = np.asarray(data, dtype=np.uint8)
    mode = min(max(mode, 0), 2)
    out = bytearray()
    prev_type, prev_width = 0, 0
    for i in range(0, data.size, FILTER_BLOCK_SIZE):
        chunk = data[i : i + FILTER_BLOCK_SIZE]
        scores = np.full((FILTER_MAX_TYPES, FILTER_MAX_WIDTH + 1), 8.0)

        if mode == 2:
            scores[0][0] = mixed_entropy(chunk)
            for ch in range(1, FILTER_MAX_WIDTH + 1):
                r = reorder(chunk, ch)
                scores[0][ch] = mixed_entropy(delta_encode(r))
                scores[1][ch] = mixed_entropy(lpc_encode(r))
                scores[2][ch] = mixed_entropy(inline_delta(chunk, ch))
        elif mode == 1:
            scores[0][0] = sorted_entropy(chunk)
            ch = find_stride(chunk)
            if ch > 0:
                scores[0][ch] = sorted_entropy(delta_encode(reorder(chunk, ch)))
                scores[2][ch] = sorted_entropy(inline_delta(chunk, ch))
            chp = find_projection(chunk)
            if chp > 0:
                scores[1][chp] = sorted_entropy(lpc_encode(reorder(chunk, chp)))
            if scores[prev_type][prev_width] == 8.0:
                scores[prev_type][prev_width] = sorted_entropy(
                    _apply(chunk, prev_type, prev_width)
                )

        # pick best config: raw (0,0) wins ties, scan order type-major
        best_t, best_w = 0, 0
        mn = scores[0][0]
        for t in range(FILTER_MAX_TYPES):
            for w in range(1, FILTER_MAX_WIDTH + 1):
                if scores[t][w] < mn:
                    mn = scores[t][w]
                    best_t, best_w = t, w

        out.append(best_t if best_w > 0 else 0)
        out.append(best_w)
        out += _apply(chunk, best_t, best_w).tobytes()
        prev_type, prev_width = best_t, best_w
    return np.frombuffer(bytes(out), dtype=np.uint8)


def filters_decode(data: np.ndarray) -> np.ndarray:
    data = np.asarray(data, dtype=np.uint8)
    out = []
    i = 0
    n = data.size
    while i < n:
        ftype = int(data[i])
        width = int(data[i + 1])
        i += 2
        if ftype >= FILTER_MAX_TYPES or width > FILTER_MAX_WIDTH:
            raise ValueError("unsupported filter configuration")
        ln = FILTER_BLOCK_SIZE if (i + FILTER_BLOCK_SIZE) < n else (n - i)
        out.append(_unapply(data[i : i + ln], ftype, width))
        i += ln
    return np.concatenate(out) if out else np.zeros(0, dtype=np.uint8)
