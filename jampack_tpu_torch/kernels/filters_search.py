"""The filter-config search of -f1 and -f2 on the device.

Counterpart of jampack_tpu/kernels/filters_search.py.  The reference picks
one (type, width) config per 64 KiB chunk (filters.cpp:223-440):

* -f2 scores raw and all 96 configs (delta, LPC, inline delta x widths
  1..32) by mixed entropy, (order-0 + order-1) / 2;
* -f1 scores raw and the configs its stride and projection detectors
  suggest, plus the previous chunk's pick, by sorted entropy.

Here every candidate transform of a block runs at once on the device (the
channel reorder as dense transposes or a gather, LPC as one K8 launch over
all its lanes), the order-1 joint histograms come from K7 in groups of
_GROUP lanes, and the entropies are reduced to f32 scores on the device.
The f32 scores only nominate: every config within SCORE_EPS of the f32
winner is re-scored in float64 by the spec scorers (stages/filters.py) on
its exact transformed bytes, and the reference's scan picks among them
(raw wins ties, type-major order, a strict improvement to win), so the
picks, and the archive bytes, are the reference's.

The functions take and give tensors on their input's device.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..format.constants import FILTER_BLOCK_SIZE, FILTER_MAX_WIDTH
from ..stages.filters import mixed_entropy, sorted_entropy
from .encode_stages import (
    filter_rows,
    filter_stage,
    filters_apply_rows,
    reorder_idx,
)
from .hist import joint_hist
from .lpc import lpc

_FBS = FILTER_BLOCK_SIZE
_W = FILTER_MAX_WIDTH  # 32

# score margin (bits/sym) below which a config is re-scored in float64;
# the f32 sums err by ~1e-5 at most over 64 Ki terms
SCORE_EPS = 1e-3

# lanes per histogram group: (2048, 256, 256) int32 is 512 MiB, a bound on
# the sweep's transient memory (the 12,513 tables of an 8 MiB block would
# take 3.3 GB at once)
_GROUP = 2048


def _xlogx(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v > 0, v * torch.log2(v.clamp(min=1.0)), 0.0)


def _scores_from_joint(joint: torch.Tensor, lens: torch.Tensor):
    """(order0 + order1) / 2 mixed entropy in f32 from exact joint counts
    (stages.filters.mixed_entropy's formulas)."""
    n = lens.float().clamp(min=1.0)
    j = joint.float()
    h0 = (_xlogx(n) - _xlogx(j.sum(1)).sum(1)) / n
    h1 = (_xlogx(j.sum(2)).sum(1) - _xlogx(j).sum((1, 2))) / n
    return (h0 + h1) / 2.0


def _grouped(fn, lanes: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """fn(joint_hist(group), lens of group) over groups of _GROUP lanes,
    concatenated: one table group in memory at a time."""
    return torch.cat([fn(joint_hist(lanes[g:g + _GROUP], lens[g:g + _GROUP]),
                         lens[g:g + _GROUP])
                      for g in range(0, lanes.shape[0], _GROUP)])


# ---------------------------------------------------------------------------
# -f2: the brute-force sweep (filters.cpp:256-286)


def _reorder_dense(chunks: torch.Tensor, w: int) -> torch.Tensor:
    """Channel reorder of FULL (len == FBS) rows as dense ops: pad, view as
    (per + 1, w), transpose, and the two channel groups (per + 1 elements
    for c < extra, per for the rest) concatenated channel-major."""
    nf = chunks.shape[0]
    per, extra = _FBS // w, _FBS % w
    t = F.pad(chunks, (0, (per + 1) * w - _FBS)).view(nf, per + 1, w)
    t = t.transpose(1, 2)  # (F, w, per + 1)
    if extra:
        return torch.cat([t[:, :extra, :].reshape(nf, -1),
                          t[:, extra:, :per].reshape(nf, -1)], 1)
    return t[:, :, :per].reshape(nf, -1)


def _inline_all(c32: torch.Tensor, lens: torch.Tensor, w: int):
    """Inline per-channel delta of every row at width w (filters.cpp:
    101-120): positions j >= align + w get row[j] - row[j - w]."""
    j = torch.arange(_FBS, device=c32.device)[None, :]
    align = (lens % w)[:, None]
    shifted = F.pad(c32, (w, 0))[:, :_FBS]
    return torch.where((j - w >= align) & (j < lens[:, None]),
                       (c32 - shifted) & 0xFF, c32)


def _lane(nf: int, i: int, t: int, w: int) -> int:
    """Lane of chunk i's config (t, w) in score_all_configs_core's layout."""
    if w == 0:
        return i
    if t == 1:
        return nf + 2 * _W * nf + (w - 1) * nf + i
    return nf + (w - 1) * 2 * nf + (nf if t == 2 else 0) + i


def sweep_inputs(rows: torch.Tensor, lens: torch.Tensor,
                 lens_np: np.ndarray):
    """The -f2 sweep's transforms of rows ((F, FBS) uint8 chunks of (F,)
    int32 lengths) but LPC: (bands, the 65 (F, FBS) uint8 lane bands raw,
    then delta and inline for each width 1..32; the (32 F, FBS) uint8
    channel-reordered rows that LPC takes, width-major; their (32 F,)
    int32 lengths)."""
    c32 = rows.to(torch.int32)
    ragged = bool(lens_np[-1] != _FBS)
    bands, lpc_in = [rows], []
    for w in range(1, _W + 1):
        # dense transposes for full rows; the (at most one) ragged last
        # row takes the index gather
        ro8 = _reorder_dense(rows, w)
        if ragged:
            ri = reorder_idx(lens[-1:], torch.full_like(lens[-1:], w), _FBS)
            ro8[-1] = rows[-1][ri[0]]
        ro = ro8.to(torch.int32)
        bands.append(((ro - F.pad(ro, (1, 0))[:, :-1]) & 0xFF).to(torch.uint8))
        bands.append(_inline_all(c32, lens, w).to(torch.uint8))
        lpc_in.append(ro8)
    return bands, torch.cat(lpc_in), lens.repeat(_W)


def score_all_configs_core(rows: torch.Tensor, lens: torch.Tensor,
                           lens_np: np.ndarray):
    """rows: (F, FBS) uint8 chunks; lens: (F,) int32 lengths.

    Lane layout (97 F lanes): raw 0..F-1, then for each width w = 1..32 a
    band of F delta lanes and a band of F inline lanes, then the 32 F LPC
    lanes, width-major, all made by one K8 launch.  Returns (scores
    (F, 3, 33) f32 [type, width] mixed entropies, raw at [0, 0] and +inf
    in the unused width-0 slots; the lanes (97 F, FBS) uint8)."""
    nf = rows.shape[0]
    bands, lpc_in, lpc_lens = sweep_inputs(rows, lens, lens_np)
    lanes = torch.cat(bands + [lpc(lpc_in, lpc_lens, False)])
    lane_lens = torch.cat([lens.repeat(1 + 2 * _W), lpc_lens])
    flat = _grouped(_scores_from_joint, lanes, lane_lens)

    scores = torch.full((nf, 3, _W + 1), float("inf"), device=rows.device)
    scores[:, 0, 0] = flat[:nf]
    for w in range(1, _W + 1):
        for t in range(3):
            k = _lane(nf, 0, t, w)
            scores[:, t, w] = flat[k:k + nf]
    return scores, lanes


def score_all_configs(data: torch.Tensor) -> torch.Tensor:
    """(F, 3, 33) f32 scores of raw and the 96 configs of every 64 KiB chunk
    of data ((n,) uint8)."""
    rows, lens, lens_np = filter_rows(data)
    return score_all_configs_core(rows, lens, lens_np)[0]


def pick_f2_configs(data: torch.Tensor):
    """The reference's -f2 picks [(type, width)] per chunk of data: the
    device sweep nominates, float64 mixed entropy decides the near-ties."""
    rows, lens, lens_np = filter_rows(data)
    nf = rows.shape[0]
    scores, lanes = score_all_configs_core(rows, lens, lens_np)
    grids = scores.cpu().numpy()
    cands = []
    for i in range(nf):
        mn = np.min(grids[i])
        near = {(0, 0)}
        for t in range(3):
            for w in range(1, _W + 1):
                if grids[i, t, w] <= mn + SCORE_EPS:
                    near.add((t, w))
        cands.append(sorted(near))
    # one fetch of every near-tie lane; the spec scorer on its exact bytes
    keys = [(i, t, w) for i in range(nf) for t, w in cands[i]]
    ids = torch.as_tensor([_lane(nf, *k) for k in keys], device=rows.device)
    host = lanes.index_select(0, ids).cpu().numpy()
    exact = {k: mixed_entropy(host[r, :lens_np[k[0]]])
             for r, k in enumerate(keys)}
    picks = []
    for i in range(nf):
        best_t, best_w = 0, 0
        best = exact[(i, 0, 0)]
        for t in range(3):
            for w in range(1, _W + 1):
                s = exact.get((i, t, w), grids[i, t, w])
                if s < best:
                    best, best_t, best_w = s, t, w
        picks.append((best_t, best_w))
    return picks


def filters_encode_f2_device(data: torch.Tensor) -> torch.Tensor:
    """-f2 filter stage of data ((n,) uint8): byte-identical to
    stages.filters.filters_encode(data, 2)."""
    return filter_stage(data, pick_f2_configs(data))


# ---------------------------------------------------------------------------
# -f1: stride/projection candidates scored by sorted entropy
# (filters.cpp:287-369)


def _prev_occurrence(keys: torch.Tensor, valid: torch.Tensor):
    """prev[b, i] = last j < i with keys[b, j] == keys[b, i], else 0 (the
    reference's dist[] tables, initialised to 0), over the valid positions;
    one stable sort per row.  keys: (B, W) int64 >= 0."""
    k = torch.where(valid, keys, 1 << 40)  # padding sorts last, apart
    ks, order = torch.sort(k, dim=1, stable=True)
    same = ks[:, 1:] == ks[:, :-1]
    prev = torch.zeros_like(order)
    prev.scatter_(1, order[:, 1:], torch.where(same, order[:, :-1], 0))
    return prev


def _pick_peak(hist: np.ndarray) -> int:
    """The reference's peak pick (filters.cpp:167-178): hist[j] must beat
    2x the average AND the running max seeded from hist[0]."""
    average = int(hist.sum()) // (_W + 1)
    smallest = 0
    mn = hist[0]
    for j in range(1, _W + 1):
        if hist[j] > average * 2 and hist[j] > mn:
            mn = hist[j]
            smallest = j
    return smallest


def find_stride_projection_fast(rows: torch.Tensor, lens: torch.Tensor):
    """find_stride (filters.cpp:147-178) and find_projection (:183-218) of
    every row's first lens[b] bytes: the per-symbol last-occurrence
    distance histogram, and the histogram of the distance to the last
    occurrence of (stride % 256).  Returns two (B,) numpy int arrays."""
    B, W = rows.shape
    i = torch.arange(W, device=rows.device)[None, :]
    valid = i < lens[:, None]
    stride = i - _prev_occurrence(rows.long(), valid)
    projection = i - _prev_occurrence(stride % 256, valid)

    def hist(dist):
        idx = torch.where(valid, dist % (_W + 1), _W + 1)
        h = torch.zeros(B, _W + 2, dtype=torch.long, device=rows.device)
        return h.scatter_add_(1, idx, torch.ones_like(idx))[:, :_W + 1]

    hs = torch.cat([hist(stride), hist(projection)]).cpu().numpy()
    peaks = np.asarray([_pick_peak(h) for h in hs], np.int64)
    return peaks[:B], peaks[B:]


def _sorted_from_joint(joint: torch.Tensor, lens: torch.Tensor):
    jf = joint.float()
    n = lens.float().clamp(min=1.0)
    return (_xlogx(jf.sum(2)).sum(1) - _xlogx(jf).sum((1, 2))) / n


def sorted_lanes(lanes: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """The counting-sort-induced generalized BWT of each lane's first
    lens[b] bytes (utils.cpp:122-141): one stable sort per lane by byte,
    carrying prev (prev[0] is the lane's last byte, as the spec's roll of
    the unpadded lane).  (B, W) uint8; padding sorts last."""
    W = lanes.shape[1]
    s = lanes.long()
    last = s.gather(1, (lens.long().clamp(min=1) - 1)[:, None])
    prev = torch.cat([last, s[:, :-1]], 1)
    j = torch.arange(W, device=lanes.device)[None, :]
    keys = torch.where(j < lens[:, None], s, 256)  # padding sorts last
    order = torch.sort(keys, dim=1, stable=True).indices
    return prev.gather(1, order).to(torch.uint8)


def sorted_entropy_scores(lanes: torch.Tensor, lens: torch.Tensor):
    """Sorted entropy (stages.filters.sorted_entropy) of each lane's first
    lens[b] bytes, f32: the order-1 entropy of sorted_lanes, from K7."""
    return _grouped(_sorted_from_joint, sorted_lanes(lanes, lens), lens)


def f1_candidates(rows: torch.Tensor, lens: torch.Tensor):
    """The -f1 candidates of every chunk row and their transforms: (the
    per-chunk lists [(type, width)], raw first; the owners [(chunk, type,
    width)] of the lanes; the (B, FBS) uint8 lanes; their (B,) int32
    lengths)."""
    nf = rows.shape[0]
    strides, projections = find_stride_projection_fast(rows, lens)
    cand_sets = []
    for i in range(nf):
        cands = [(0, 0)]
        if strides[i] > 0:
            cands += [(0, int(strides[i])), (2, int(strides[i]))]
        if projections[i] > 0:
            cands += [(1, int(projections[i]))]
        cand_sets.append(cands)
    owners = [(i, t, w) for i, cands in enumerate(cand_sets)
              for t, w in cands]
    cfg = torch.as_tensor(np.asarray(owners, np.int32).reshape(-1, 3),
                          device=rows.device)
    idx = cfg[:, 0].long()
    lane_lens = lens[idx]
    lanes = filters_apply_rows(rows[idx], lane_lens, cfg[:, 1], cfg[:, 2])
    return cand_sets, owners, lanes, lane_lens


def pick_f1_configs(data: torch.Tensor):
    """The reference's -f1 picks [(type, width)] per chunk of data: the
    device scores every candidate, float64 sorted entropy decides the
    near-ties and scores the previous chunk's pick where it is not a
    candidate."""
    rows, lens, lens_np = filter_rows(data)
    cand_sets, owners, lanes, lane_lens = f1_candidates(rows, lens)
    dev_scores = sorted_entropy_scores(lanes, lane_lens).cpu().numpy()
    row_of = {k: r for r, k in enumerate(owners)}
    scored = {k: float(dev_scores[r]) for k, r in row_of.items()}
    # one fetch of the lanes near their chunk's f32 minimum (the previous
    # pick can only lower it, so these hold every near tie but that pick)
    near = []
    for i, cands in enumerate(cand_sets):
        if len(cands) > 1:
            mn = min(scored[(i, t, w)] for t, w in cands)
            near += [row_of[(i, t, w)] for t, w in cands
                     if scored[(i, t, w)] <= mn + SCORE_EPS]
    host = {}
    if near:
        ids = torch.as_tensor(near, device=rows.device)
        host = dict(zip(near, lanes.index_select(0, ids).cpu().numpy()))
    exact_cache = {}

    def exact_score(i, t, w):
        key = (i, t, w)
        if key not in exact_cache:
            if key in row_of:
                r = row_of[key]
                buf = host[r] if r in host else lanes[r].cpu().numpy()
            else:  # the previous pick, not a candidate here: made on the
                # device like the candidates (LPC through K8)
                cfg = torch.tensor([t, w], dtype=torch.int32,
                                   device=rows.device)
                buf = filters_apply_rows(rows[i:i + 1], lens[i:i + 1],
                                         cfg[:1], cfg[1:])[0].cpu().numpy()
            exact_cache[key] = sorted_entropy(buf[:lens_np[i]])
        return exact_cache[key]

    picks = []
    prev_t, prev_w = 0, 0
    for i, cands in enumerate(cand_sets):
        if cands == [(0, 0)] and (prev_t, prev_w) == (0, 0):
            picks.append((0, 0))  # raw alone: raw, whatever its score
            continue
        grid = {(t, w): scored[(i, t, w)] for t, w in cands}
        if (prev_t, prev_w) not in grid:
            grid[(prev_t, prev_w)] = exact_score(i, prev_t, prev_w)
        mn = min(grid.values())
        for key in list(grid):
            if grid[key] <= mn + SCORE_EPS:
                grid[key] = exact_score(i, *key)
        best_t, best_w = 0, 0
        best = grid.get((0, 0), 8.0)
        for t in range(3):
            for w in range(1, _W + 1):
                s = grid.get((t, w), 8.0)
                if s < best:
                    best, best_t, best_w = s, t, w
        picks.append((best_t, best_w))
        prev_t, prev_w = best_t, best_w
    return picks


def filters_encode_f1_device(data: torch.Tensor) -> torch.Tensor:
    """-f1 filter stage of data ((n,) uint8): byte-identical to
    stages.filters.filters_encode(data, 1)."""
    return filter_stage(data, pick_f1_configs(data))
