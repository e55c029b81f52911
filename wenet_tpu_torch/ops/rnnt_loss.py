"""RNN-T loss.  Counterpart of wenet_tpu/ops/rnnt_loss.py (which replaces
torchaudio.functional.rnnt_loss; there is no torchaudio here either).

The (T, U+1) alpha lattice is swept along its anti-diagonals, batched over
the utterances: every cell of diagonal d depends only on diagonal d-1, so
the whole grid is T+U-1 steps of small (B, U+1) tensor ops with no host
sync.  The blank and label log-probs each diagonal reads are gathered once
into (B, D, U+1) skewed tables before the sweep.  Gradients flow through
the sweep by autograd.  Each diagonal is held relative to its largest
cell, the offsets summed in float64: the same loss as the JAX package's
to float32's resolution, and a gradient float32 keeps to ~1e-6 of its
size at any length.  NEG_INF, the terminal cell alpha[T-1, U] +
blank[T-1, U] and the forbidden emission beyond the true U are the JAX
package's."""

import torch
import torch.nn.functional as F

NEG_INF = -1.0e30


def rnnt_loss(log_probs: torch.Tensor, labels: torch.Tensor,
              logit_lengths: torch.Tensor, label_lengths: torch.Tensor,
              blank: int = 0, reduction: str = 'mean') -> torch.Tensor:
    """-log P(labels | encoder) of (B, T, U+1, V) log-softmaxed joint
    outputs, labels (B, U), true lengths (B,) each; reduced by 'mean',
    'sum' or 'none' (per utterance)."""
    B, Tmax, Up1, _ = log_probs.shape
    Umax = Up1 - 1
    dev = log_probs.device
    T = logit_lengths.long()
    U = label_lengths.long()
    u_idx = torch.arange(Up1, device=dev)
    bl = log_probs[..., blank]  # (B, T, U+1)
    lab = labels.long().clamp(min=0)[:, None, :, None].expand(B, Tmax,
                                                              Umax, 1)
    em = torch.gather(log_probs[:, :, :Umax], 3, lab)[..., 0]  # (B, T, U)
    # forbid emitting beyond the true label length; column u holds the
    # emission that arrives at u (from u - 1), column 0 none
    em = torch.where(torch.arange(Umax, device=dev)[None, None] <
                     U[:, None, None], em, NEG_INF)
    em = F.pad(em, (1, 0), value=NEG_INF)  # (B, T, U+1)

    # skewed tables: row d, column u is cell (t = d - u, u) of diagonal d
    D = Tmax + Umax
    t = torch.arange(D, device=dev)[:, None] - u_idx[None, :]  # (D, U+1)
    on_grid = (t >= 0) & (t < Tmax)
    blank_in = torch.gather(  # from (t - 1, u)
        bl, 1, (t - 1).clamp(0, Tmax - 1)[None].expand(B, D, Up1))
    blank_in = torch.where(on_grid & (t >= 1), blank_in, NEG_INF)
    emit_in = torch.gather(  # from (t, u - 1)
        em, 1, t.clamp(0, Tmax - 1)[None].expand(B, D, Up1))
    emit_in = torch.where(on_grid, emit_in, NEG_INF)

    # each diagonal is kept relative to its largest cell (detached, so
    # the gradient is unchanged): alpha itself reaches -T log V, where
    # float32's absolute error would carry into the gradient, exp(alpha +
    # beta - ll), at 1e-4 of its size over a 15 s utterance
    A = torch.full((B, Up1), NEG_INF, device=dev, dtype=log_probs.dtype)
    A[:, 0] = 0.0
    diagonals, shifts = [A], [torch.zeros(B, device=dev, dtype=A.dtype)]
    for d in range(1, D):
        from_blank = A + blank_in[:, d]
        from_emit = F.pad(A[:, :-1], (1, 0), value=NEG_INF) + emit_in[:, d]
        A = torch.logaddexp(from_blank, from_emit)
        shift = A.detach().amax(-1).clamp(min=NEG_INF / 2)
        # an off-grid or unreachable cell sums NEG_INF terms: clamp to it
        A = (A - shift[:, None]).clamp(min=NEG_INF)
        diagonals.append(A)
        shifts.append(shift)
    alphas = torch.stack(diagonals, dim=1)  # (B, D, U+1)
    offset = torch.stack(shifts, dim=1).double().cumsum(1)  # (B, D)
    rows = torch.arange(B, device=dev)
    d_star = (T - 1 + U).clamp(0, D - 1)
    last_t = (T - 1).clamp(0, Tmax - 1)
    per = -((alphas[rows, d_star, U] + bl[rows, last_t, U]).double() +
            offset[rows, d_star]).to(log_probs.dtype)
    if reduction == 'mean':
        return per.mean()
    if reduction == 'sum':
        return per.sum()
    return per


def rnnt_loss_logits(logits: torch.Tensor, labels: torch.Tensor,
                     logit_lengths: torch.Tensor,
                     label_lengths: torch.Tensor, blank: int = 0,
                     reduction: str = 'mean') -> torch.Tensor:
    """`rnnt_loss` of raw joint logits, log-softmaxed in float32."""
    log_probs = F.log_softmax(logits.float(), dim=-1)
    return rnnt_loss(log_probs, labels, logit_lengths, label_lengths,
                     blank, reduction)
