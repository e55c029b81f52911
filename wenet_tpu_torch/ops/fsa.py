"""The total score of frame posteriors through a fixed scoring FSA (the
LF-MMI denominator).  Counterpart of wenet_tpu/ops/fsa.py, whose
`lax.scan` becomes one loop over frames for the whole batch, in plain
PyTorch (no Pallas kernel stands behind it):

    alpha_{t+1}[dst] = logsumexp over emit arcs (src, dst, l, w) of
                       alpha_t[src] + w + logp[t, l]

with a bounded epsilon closure after each frame, in the log semiring.
The arc tables are built on the host once per graph (`fst_to_dense_arcs`
over a `TextFst`).  A state no path reaches holds NEG_INF = -1e30, and
the segment logsumexp keeps such values away from `exp` on both sides
of a `where` ("double where"), so that its gradient stays finite."""

from typing import NamedTuple

import numpy as np
import torch

from wenet_tpu_torch.lm.fst import TextFst

NEG_INF = -1.0e30


class DenseFsa(NamedTuple):
    """Epsilon-split arc tables of a scoring FSA.

    Emit arcs consume one frame with CTC label `label` (the TextFst's
    ilabel - 1); eps arcs are free moves between frames, taken up to
    `eps_depth` times.  Weights are log-domain (-cost)."""
    emit_src: np.ndarray  # (A,) int32
    emit_dst: np.ndarray
    emit_label: np.ndarray
    emit_weight: np.ndarray  # (A,) float32
    eps_src: np.ndarray  # (E,) int32
    eps_dst: np.ndarray
    eps_weight: np.ndarray
    final_weight: np.ndarray  # (S,) log-domain, NEG_INF if not final
    num_states: int
    start: int
    eps_depth: int


def fst_to_dense_arcs(fst: TextFst) -> DenseFsa:
    """Split a TextFst (tropical costs, ilabel = CTC id + 1, 0 = eps) into
    dense arc tables, its states renumbered in sorted order; eps_depth is
    the longest eps chain.  Raises on an eps cycle."""
    emit, eps = [], []
    states = sorted(set(fst.arcs) | set(fst.finals) | {fst.start} |
                    {a.nextstate for arcs in fst.arcs.values()
                     for a in arcs})
    remap = {s: i for i, s in enumerate(states)}
    for s, arcs in fst.arcs.items():
        for a in arcs:
            if a.ilabel == 0:
                eps.append((remap[s], remap[a.nextstate], -a.weight))
            else:
                emit.append((remap[s], remap[a.nextstate], a.ilabel - 1,
                             -a.weight))
    S = len(states)
    final_weight = np.full((S,), NEG_INF, np.float32)
    for s, c in fst.finals.items():
        final_weight[remap[s]] = -c

    eps_adj = {}
    for src, dst, _ in eps:
        eps_adj.setdefault(src, []).append(dst)
    depth = {}

    def longest(s, stack):
        if s in stack:
            raise ValueError('epsilon cycle in scoring FSA')
        if s in depth:
            return depth[s]
        stack.add(s)
        d = 0
        for nxt in eps_adj.get(s, ()):
            d = max(d, 1 + longest(nxt, stack))
        stack.discard(s)
        depth[s] = d
        return d

    eps_depth = max((longest(s, set()) for s in eps_adj), default=0)

    def col(rows, i, dtype):
        return (np.asarray([r[i] for r in rows], dtype) if rows else
                np.zeros((0,), dtype))

    return DenseFsa(
        emit_src=col(emit, 0, np.int32), emit_dst=col(emit, 1, np.int32),
        emit_label=col(emit, 2, np.int32),
        emit_weight=col(emit, 3, np.float32),
        eps_src=col(eps, 0, np.int32), eps_dst=col(eps, 1, np.int32),
        eps_weight=col(eps, 2, np.float32),
        final_weight=final_weight, num_states=S,
        start=remap[fst.start], eps_depth=eps_depth)


def seg_logsumexp(vals: torch.Tensor, seg: torch.Tensor,
                  num: int) -> torch.Tensor:
    """(B, A) values, (A,) segment of each -> (B, num) logsumexp per
    segment; NEG_INF where a segment has no live member.  The segment max
    is only a shift and is taken detached."""
    B = vals.shape[0]
    idx = seg[None, :].expand(B, -1)
    m = torch.full((B, num), NEG_INF, dtype=vals.dtype,
                   device=vals.device).scatter_reduce(
                       1, idx, vals.detach(), 'amax')
    empty = m <= NEG_INF
    m_safe = torch.where(empty, 0.0, m)
    # double where: a dead member's -1e30 must not reach exp, or the
    # backward pass carries NaN
    dead = vals <= NEG_INF / 2
    arg = torch.where(dead, -100.0, vals - m_safe[:, seg])
    s = torch.zeros(B, num, dtype=vals.dtype,
                    device=vals.device).index_add_(1, seg, torch.exp(arg))
    out = m_safe + torch.log(s.clamp(min=1e-38))
    return torch.where(empty, NEG_INF, out)


def fsa_forward_score(log_probs: torch.Tensor, lengths: torch.Tensor,
                      fsa: DenseFsa) -> torch.Tensor:
    """Log total probability of (posteriors x FSA) over all paths, per row.

    log_probs: (B, T, V); lengths: (B,) frames (a row's frames past its
    length leave its state as it was).  -> (B,) scores in log_probs's
    dtype, on its device; differentiable in log_probs.  One step a frame
    for the whole batch, each followed by `eps_depth` closure steps.

    The recursion runs in float64.  In float32 the gradient drifts with
    the frames (each frame's occupancies, which sum to 1, were off by
    4.8e-4 after 300 frames of a 4233-unit den graph): enough to move the
    training gradient by 2.4e-4 of its largest between the card and the
    CPU.  The loop is bound by its launches, not its arithmetic."""
    device = log_probs.device
    B, T, _ = log_probs.shape
    S = fsa.num_states
    f64 = torch.float64

    def table(a, dtype=torch.int64):
        return torch.as_tensor(np.asarray(a)).to(device, dtype)

    e_src, e_dst = table(fsa.emit_src), table(fsa.emit_dst)
    e_w = table(fsa.emit_weight, f64)
    p_src, p_dst = table(fsa.eps_src), table(fsa.eps_dst)
    p_w = table(fsa.eps_weight, f64)

    def eps_close(alpha):
        # frontier form: delta carries the mass of paths with exactly k
        # eps hops, so each eps path counts once (relaxing alpha itself
        # would count a k-hop path once per subset of the steps)
        delta = alpha
        for _ in range(fsa.eps_depth):
            delta = seg_logsumexp(delta[:, p_src] + p_w, p_dst, S)
            alpha = torch.logaddexp(alpha, delta)
        return alpha

    alpha = torch.full((B, S), NEG_INF, dtype=f64, device=device)
    alpha[:, fsa.start] = 0.0
    alpha = eps_close(alpha)
    # each frame's emission of every arc, gathered once and unbound (one
    # backward op: a select a frame would zero-fill the whole gradient
    # each frame)
    emit = (log_probs.double().index_select(2, table(fsa.emit_label)) +
            e_w).unbind(1)
    valid = (torch.arange(T, device=device)[None, :] <
             lengths.to(device)[:, None])
    for t in range(T):
        new = seg_logsumexp(alpha[:, e_src] + emit[t], e_dst, S)
        new = eps_close(new)
        alpha = torch.where(valid[:, t, None], new, alpha)
    total = torch.logsumexp(alpha + table(fsa.final_weight, f64)[None, :],
                            dim=-1)
    return total.to(log_probs.dtype)
