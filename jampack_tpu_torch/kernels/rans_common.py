"""The rANS entropy coder's constant tables, built without JAX, and the
plain PyTorch model update that the decode and encode passes share.

The codec has no weights; the state it carries across chunks is these
tables, rebuilt here from the port's format/ alone (the JAX package keeps
them in kernels/rans_common.py and kernels/rans_wide.py).

Model bank layout (rans_wide's): the 9 models of a chain (1 exponent, 2
adaptive mantissa, 6 quasi mantissa; alphabets 8/2/2/4/8/16/32/64/129) keep
only their INTERIOR cumulative entries cum[1..alpha-1] (cum[0] = 0 and
cum[alpha] = 2^16 are constants) in one 256-entry bank; model k's segment
is bank[BOFF[k]:BOFF[k+1]].  The quasi counts take QOFF[k]:QOFF[k+1] of a
253-entry count row.
"""

import functools

import numpy as np
import torch

from ..format.constants import (
    MAX_MODELS,
    MODEL_SWITCH_THRESHOLD,
    PROB_BITS,
    PROB_SCALE,
)
from ..format.tables import EXPONENT, MODEL_ALPHABET

RATE = 5                    # model.hpp:34 mixing shift
UPDATE_RATE = 64 << 10      # model.hpp:46 largest quasi rescale period
NQ = MAX_MODELS - MODEL_SWITCH_THRESHOLD   # 6 quasi models (e = 2..7)
NSW = MODEL_SWITCH_THRESHOLD               # 2 adaptive mantissa models
QALPHA = 129                # widest quasi alphabet
QALPHAS = np.asarray(MODEL_ALPHABET[MODEL_SWITCH_THRESHOLD:], dtype=np.int32)


def _adaptive_mix(alpha: int) -> np.ndarray:
    rows = np.ones((alpha, alpha + 1), dtype=np.int64)
    rows[:, 0] = 0
    for sym in range(alpha):
        rows[sym, sym + 1] += PROB_SCALE - alpha
    return np.cumsum(rows, axis=1).astype(np.int32)


def _adaptive_init(alpha: int) -> np.ndarray:
    scale = PROB_SCALE // alpha
    freqs = np.full(alpha, scale, dtype=np.int64)
    freqs[0] += PROB_SCALE - scale * alpha
    return np.concatenate([[0], np.cumsum(freqs)]).astype(np.int32)


def _quasi_init_cum() -> np.ndarray:
    out = np.full((NQ, QALPHA + 1), 1 << 30, dtype=np.int32)
    for i, alpha in enumerate(QALPHAS):
        out[i, : alpha + 1] = _adaptive_init(int(alpha))
    return out


EXP_MIX = _adaptive_mix(MAX_MODELS)                        # (8, 9)
EXP_INIT = _adaptive_init(MAX_MODELS)                      # (9,)
MANT_ADAPT_MIX = np.stack([_adaptive_mix(int(MODEL_ALPHABET[e]))
                           for e in range(NSW)])           # (2, 2, 3)
MANT_ADAPT_INIT = np.stack([_adaptive_init(int(MODEL_ALPHABET[e]))
                            for e in range(NSW)])          # (2, 3)
QUASI_INIT_CUM = _quasi_init_cum()                         # (6, 130)

ALPHAS = [MAX_MODELS] + [int(MODEL_ALPHABET[e]) for e in range(NSW)] + [
    int(a) for a in QALPHAS]
BOFF = np.concatenate([[0], np.cumsum([a - 1 for a in ALPHAS])])  # (10,)
SEG_ID = np.repeat(np.arange(9), [a - 1 for a in ALPHAS])          # (256,)
SEG_START = np.zeros(int(BOFF[-1]), bool)
SEG_START[BOFF[:-1]] = True
QOFF = np.concatenate([[0], np.cumsum(QALPHAS)])                  # (7,)
BANK_INIT = np.concatenate(
    [EXP_INIT[1:MAX_MODELS]]
    + [MANT_ADAPT_INIT[k][1:2] for k in range(NSW)]
    + [QUASI_INIT_CUM[k, 1:int(QALPHAS[k])] for k in range(NQ)]
).astype(np.uint16)                                                # (256,)
if BANK_INIT.shape != (256,) or int(QOFF[-1]) != 253:
    raise AssertionError("model bank layout must be 256 bank / 253 counts")


def to_device(device) -> dict:
    """The tables the model passes read, as int tensors on `device`: the
    plain versions and the CUDA kernels take the same ones.  Made once a
    device (a launch would otherwise wait on five small copies), keyed by
    the card's index: "cuda" alone names whichever card is current in the
    calling thread.  Callers only read them."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return _tables(str(dev))


@functools.lru_cache(maxsize=None)
def _tables(device: str) -> dict:
    dev = torch.device(device)

    def t(a, dtype=torch.int32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    return {
        "bank_init": t(BANK_INIT.astype(np.int32)),       # (256,)
        "exp_mix": t(EXP_MIX[:, 1:MAX_MODELS]),           # (8, 7) interior
        "ma_mix": t(MANT_ADAPT_MIX[:, :, 1]),             # (2, 2) [model][m01]
        "boff": t(BOFF),                                  # (10,)
        "exp_base": t(EXPONENT[:MAX_MODELS]),             # (8,)
        "seg_id": t(SEG_ID, torch.int64),                 # (256,)
        "qoff": t(QOFF, torch.int64),                     # (7,)
        "qalpha": t(QALPHAS, torch.int64),                # (6,)
    }


def model_state(t: dict, L: int):
    """Fresh model state of L chains, int64 on the tables' device:
    (bank (L, 256), quasi counts (L, 253), seen (L, 6), thresholds (L, 6))."""
    dev = t["bank_init"].device
    bank = t["bank_init"].long()[None, :].repeat(L, 1)
    qf = torch.zeros(L, int(QOFF[-1]), dtype=torch.long, device=dev)
    seen = torch.zeros(L, NQ, dtype=torch.long, device=dev)
    qexp = torch.full((L, NQ), 8, dtype=torch.long, device=dev)
    return bank, qf, seen, qexp


def _rescale(bank, qf, seen, qexp, pred, k):
    """Quasi rescale (model.cpp:160-204, unsigned stretch) of model k of
    every chain with `pred` set; updates the state in place."""
    for kk in range(NQ):
        rows = pred & (k == kk)
        alpha = int(QALPHAS[kk])
        q0, b0 = int(QOFF[kk]), int(BOFF[3 + kk])
        qfk = qf[:, q0:q0 + alpha]
        total = qfk.sum(1)
        logv = torch.zeros_like(total)
        for _ in range(21):  # smallest log with (total >> log) + alpha <= 2^16
            logv += ((total >> logv) + alpha) > PROB_SCALE
        f = (qfk >> logv[:, None]) + 1
        t2 = f.sum(1, keepdim=True)
        q = ((f << PROB_BITS) & 0xFFFFFFFF) // t2
        q[:, 0] += PROB_SCALE - q.sum(1)
        cum = q[:, :alpha - 1].cumsum(1) & 0xFFFF
        seg = bank[:, b0:b0 + alpha - 1]
        bank[:, b0:b0 + alpha - 1] = torch.where(rows[:, None], cum, seg)
        qf[:, q0:q0 + alpha] = torch.where(rows[:, None], 0, qfk)
        seen[:, kk] = torch.where(rows, 0, seen[:, kk])
        grown = torch.where(qexp[:, kk] < UPDATE_RATE, qexp[:, kk] << 1,
                            UPDATE_RATE)
        qexp[:, kk] = torch.where(rows, grown, qexp[:, kk])


def model_update(t: dict, bank, qf, seen, qexp, active, e, m):
    """The model update after one symbol per chain (exponent e, mantissa
    m; chains with `active` false hold still), in place: adaptive CDF
    mixing (arithmetic >> RATE) of the exponent model and of an adaptive
    mantissa model, or the quasi count and the periodic rescale.  A
    mantissa past its quasi model's alphabet (an invalid encode symbol)
    counts nothing, as model_pairs_wide's one-hot does."""
    rows = torch.arange(bank.shape[0], device=bank.device)
    head = bank[:, :7]
    bank[:, :7] = torch.where(active[:, None],
                              head + ((t["exp_mix"][e] - head) >> RATE),
                              head)
    adaptive = active & (e < NSW)
    ei = e.clamp(max=NSW - 1)
    col = 7 + ei
    cur = bank[rows, col]
    mix = t["ma_mix"][ei, m.clamp(0, 1)]
    bank[rows, col] = torch.where(adaptive, cur + ((mix - cur) >> RATE), cur)
    quasi = active & (e >= NSW)
    k = (e - NSW).clamp(0, NQ - 1)
    counted = quasi & (m < t["qalpha"][k])
    qcol = (t["qoff"][k] + m).clamp(0, qf.shape[1] - 1)
    qf[rows, qcol] += torch.where(counted, PROB_BITS, 0)
    seen[rows, k] += quasi.long()
    pred = quasi & (seen[rows, k] > qexp[rows, k])
    if bool(pred.any()):
        _rescale(bank, qf, seen, qexp, pred, k)
