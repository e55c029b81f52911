"""CTC post-processing and forced alignment.  Counterpart of
wenet_tpu/utils/ctc_utils.py.

`force_align` is a Viterbi over the blank-interleaved label lattice, a
loop over frames on the device of the log-probs it is given (the JAX
package's `lax.scan`), with the same tie rule (stay, then the previous
state, then the skip) and the same end-state choice."""

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1.0e30


def topk_host_rows(logp: torch.Tensor, k: int, blank: int) -> torch.Tensor:
    """(..., T, 2k + 1) on logp's device from CTC log-probs (..., T, V):
    the top-k values, their ids (as floats, exact below 2**24) and the
    blank column, packed for one device-to-host copy (what a streaming
    decoder's prefix beam and endpoint read)."""
    logp = logp.float()
    vals, ids = torch.topk(logp, k, dim=-1)
    return torch.cat([vals, ids.float(), logp[..., blank:blank + 1]], dim=-1)


def remove_duplicates_and_blank(hyp: List[int],
                                blank_id: int = 0) -> List[int]:
    """Collapse repeats, then drop blanks."""
    out: List[int] = []
    prev = None
    for t in hyp:
        if t != prev and t != blank_id:
            out.append(int(t))
        prev = t
    return out


def replace_duplicates_with_blank(hyp: List[int],
                                  blank_id: int = 0) -> List[int]:
    """Keep the first frame of each run of a token, blank the others."""
    out: List[int] = []
    cur = 0
    while cur < len(hyp):
        out.append(int(hyp[cur]))
        prev = cur
        cur += 1
        while cur < len(hyp) and hyp[cur] == hyp[prev] \
                and hyp[cur] != blank_id:
            out.append(blank_id)
            cur += 1
    return out


def gen_ctc_peak_time(hyp: List[int], blank_id: int = 0) -> List[int]:
    """The frame at which each non-blank run starts."""
    times: List[int] = []
    prev = None
    for i, t in enumerate(hyp):
        if t != prev and t != blank_id:
            times.append(i)
        prev = t
    return times


def gen_timestamps_from_peak(
    peaks: List[int],
    max_duration: float,
    frame_rate: float = 0.04,
    max_token_duration: float = 1.0,
) -> List[Tuple[float, float]]:
    """(start, end) seconds of each token around its peak frame."""
    times = []
    half_max = max_token_duration / 2
    for i in range(len(peaks)):
        if i == 0:
            start = max(0, peaks[0] * frame_rate - half_max)
        else:
            start = max((peaks[i - 1] + peaks[i]) / 2 * frame_rate,
                        peaks[i] * frame_rate - half_max)
        if i == len(peaks) - 1:
            end = min(max_duration, peaks[-1] * frame_rate + half_max)
        else:
            end = min((peaks[i] + peaks[i + 1]) / 2 * frame_rate,
                      peaks[i] * frame_rate + half_max)
        times.append((start, end))
    return times


def insert_blank(label: np.ndarray, blank_id: int = 0) -> np.ndarray:
    """Blank-interleave: [a, b] -> [blank, a, blank, b, blank]."""
    label = np.asarray(label).reshape(-1, 1)
    blanks = np.full((label.shape[0], 1), blank_id, np.int64)
    lattice = np.concatenate([blanks, label], axis=1).reshape(-1)
    return np.append(lattice, blank_id)


def _viterbi_align(logp: torch.Tensor, lattice: torch.Tensor) -> np.ndarray:
    """Viterbi over the lattice: logp (T, V) float32, lattice (S,) ids on
    logp's device -> the best path's state per frame (T,), on the host.

    Per frame each state takes the best of staying, coming from the state
    before it and (for a label that differs from the one two back) skipping
    the blank between them; on a tie stay wins, then the state before.
    The path ends in the last state or the blank before it, the last on a
    tie."""
    T = logp.shape[0]
    S = lattice.shape[0]
    neg = logp.new_full((), NEG_INF)
    skip_ok = torch.zeros(S, dtype=torch.bool, device=logp.device)
    if S > 2:
        skip_ok[2:] = (lattice[2:] != lattice[:-2]) & \
            (lattice[2:] != lattice[0])
    skip_ok &= lattice != lattice[0]
    emit = logp[:, lattice]  # (T, S)
    alpha = torch.full((S,), NEG_INF, dtype=logp.dtype, device=logp.device)
    alpha[0] = emit[0, 0]
    if S > 1:
        alpha[1] = emit[0, 1]
    bps = []
    for t in range(1, T):
        stay = alpha
        diag = F.pad(alpha[:-1], (1, 0), value=NEG_INF)
        skip = torch.where(skip_ok, F.pad(alpha[:-2], (2, 0),
                                          value=NEG_INF)[:S], neg)
        best = torch.maximum(torch.maximum(stay, diag), skip)
        bps.append(torch.where(best == stay, 0,
                               torch.where(best == diag, 1, 2)))
        alpha = best + emit[t]
    last = float(alpha[S - 1])
    prev = float(alpha[S - 2]) if S > 1 else NEG_INF
    state = S - 1 if last >= prev else S - 2
    bps = torch.stack(bps).cpu().numpy() if bps else np.zeros((0, S))
    states = np.empty(T, np.int64)
    states[T - 1] = state
    for t in range(T - 2, -1, -1):
        state -= int(bps[t, state])
        states[t] = state
    return states


def force_align(ctc_probs, y, blank_id: int = 0) -> List[int]:
    """CTC forced alignment of the label `y` to (T, V) log-probs (a tensor,
    run on its device, or an array) -> T frame-level token ids, blanks
    included."""
    logp = torch.as_tensor(ctc_probs).float()
    lattice = insert_blank(np.asarray(y), blank_id)
    states = _viterbi_align(logp, torch.as_tensor(lattice,
                                                  device=logp.device))
    return [int(lattice[s]) for s in states]


def get_blank_id(configs, symbol_table):
    """-> (configs with ctc_conf.ctc_blank_id set, the blank id): the
    symbol table's <blank>, which must agree with the config's, or the
    config's alone."""
    if 'ctc_conf' not in configs:
        configs['ctc_conf'] = {}
    if '<blank>' in symbol_table:
        if 'ctc_blank_id' in configs['ctc_conf']:
            assert (configs['ctc_conf']['ctc_blank_id'] ==
                    symbol_table['<blank>'])
        else:
            configs['ctc_conf']['ctc_blank_id'] = symbol_table['<blank>']
    else:
        assert 'ctc_blank_id' in configs['ctc_conf'], \
            "PLZ set ctc_blank_id in yaml"
    return configs, configs['ctc_conf']['ctc_blank_id']
