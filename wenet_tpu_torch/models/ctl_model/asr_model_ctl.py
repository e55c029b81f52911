"""CTL: contrastive training of one encoder in full-context and chunked
mode.  Counterpart of wenet_tpu/models/ctl_model/asr_model_ctl.py.

The reference's Dual*Encoder classes only add a full-context forward;
here, as in the JAX package, the plain encoder is called twice: with
`full_context=True`, and with its dynamic or static chunk mask.  The
loss is loss_full + loss_chunk + ctl_weight * loss_ctl, where loss_ctl
asks each chunked frame to pick its full-context frame out of
`n_negatives` other full-context frames of its utterance (cosine logits
over `logit_temp`).  The negatives' uniforms are a host draw
(`negative_uniforms`), or the `draws` a caller passes: a test hands in
the JAX key's, so both packages pick the same negatives."""

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from wenet_tpu_torch.models.transformer.asr_model import ASRModel


def sample_negatives(y: torch.Tensor, uniforms: torch.Tensor,
                     n_negatives: int,
                     lengths: torch.Tensor) -> torch.Tensor:
    """y: (B, T, F); uniforms: (B, T * n_negatives) in [0, 1) ->
    (n_negatives, B, T, F): for frame t, frames drawn uniformly from the
    first max(len - 1, 1) + 1 of its row other than t (the index is
    shifted past t), never from the padding."""
    B, T, Fd = y.shape
    high = (lengths - 1).clamp(min=1).float()[:, None]
    idx = (uniforms.to(y.device) * high).to(torch.int64)
    pos = torch.arange(T, device=y.device).repeat_interleave(
        n_negatives)[None, :]
    idx = torch.where(idx >= pos, idx + 1, idx).clamp(0, T - 1)
    idx = idx + (torch.arange(B, device=y.device) * T)[:, None]
    negs = y.reshape(-1, Fd)[idx.reshape(-1)].reshape(B, T, n_negatives, Fd)
    return negs.permute(2, 0, 1, 3)


def ctl_loss(x: torch.Tensor, y: torch.Tensor, negatives: torch.Tensor,
             mask: torch.Tensor, logit_temp: float) -> torch.Tensor:
    """Cross entropy of picking y (B, T, F) for x among [y, negatives],
    cosine logits / logit_temp in fp32, a negative equal to y masked at
    -1e9; the mean over mask (B, 1, T)'s frames."""
    neg_is_pos = (y[None] == negatives).all(-1)  # (N, B, T)
    targets = torch.cat([y[None], negatives], 0).float()
    xf = x[None].float()
    logits = (xf * targets).sum(-1) / (
        xf.norm(dim=-1) * targets.norm(dim=-1) + 1e-8) / logit_temp
    logits = logits.masked_fill(
        torch.cat([torch.zeros_like(neg_is_pos[:1]), neg_is_pos], 0), -1e9)
    per = -F.log_softmax(logits, dim=0)[0]  # (B, T)
    m = mask[:, 0, :].to(per.dtype)
    return (per * m).sum() / m.sum().clamp(min=1)


class CTLModel(ASRModel):
    """`ASRModel` whose loss is the CTL sum (module docstring)."""

    def __init__(self, *args, logit_temp: float = 0.1, n_negatives: int = 0,
                 ctl_weight: float = 1.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.logit_temp = logit_temp
        self.n_negatives = n_negatives
        self.ctl_weight = ctl_weight

    def _joint_loss(self, encoder_out, encoder_mask, target, target_lengths,
                    row_valid) -> torch.Tensor:
        loss_ctc = loss_att = None
        if self.ctc_weight != 0.0 and self.ctc is not None:
            loss_ctc, _ = self.ctc(encoder_out, encoder_mask[:, 0, :].sum(-1),
                                   target, target_lengths, row_valid)
        if self.ctc_weight != 1.0:
            loss_att, _ = self._calc_att_loss(encoder_out, encoder_mask,
                                              target, target_lengths,
                                              row_valid)
        if loss_ctc is None:
            return loss_att
        if loss_att is None:
            return loss_ctc
        return self.ctc_weight * loss_ctc + (1 - self.ctc_weight) * loss_att

    def negative_uniforms(self, B: int, T: int,
                          generator: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
        """(B, T * n_negatives) host uniforms from `generator` (a fixed
        seed without one: cv and eval draw alike every time)."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        return torch.rand(B, T * self.n_negatives, generator=generator)

    def forward(self, feats: torch.Tensor, feats_lengths: torch.Tensor,
                target: torch.Tensor, target_lengths: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                dynamic_chunk: Optional[Tuple[int, int]] = None,
                draws: Optional[torch.Tensor] = None
                ) -> Dict[str, Optional[torch.Tensor]]:
        """-> {loss, loss_full, loss_chunk, loss_ctl}.  `generator` and
        `dynamic_chunk` as `ASRModel.forward` (the chunked pass draws its
        chunk first, then the negatives' uniforms, unless `draws` gives
        them)."""
        row_valid = feats_lengths > 0
        enc_full, mask_full = self.encoder(feats, feats_lengths,
                                           generator=generator,
                                           full_context=True)
        loss_full = self._joint_loss(enc_full, mask_full, target,
                                     target_lengths, row_valid)
        enc_chunk, mask_chunk = self.encoder(feats, feats_lengths,
                                             generator=generator,
                                             dynamic_chunk=dynamic_chunk)
        loss_chunk = self._joint_loss(enc_chunk, mask_chunk, target,
                                      target_lengths, row_valid)
        loss_ctl = enc_full.new_zeros(())
        if self.ctl_weight > 0 and self.n_negatives > 0:
            B, T = enc_full.shape[:2]
            if draws is None:
                draws = self.negative_uniforms(B, T, generator)
            negs = sample_negatives(enc_full, draws, self.n_negatives,
                                    mask_chunk[:, 0, :].sum(-1))
            loss_ctl = ctl_loss(enc_chunk, enc_full, negs, mask_chunk,
                                self.logit_temp)
        loss = loss_full + loss_chunk + self.ctl_weight * loss_ctl
        return {'loss': loss, 'loss_full': loss_full,
                'loss_chunk': loss_chunk, 'loss_ctl': loss_ctl}
