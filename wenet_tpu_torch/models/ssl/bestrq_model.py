"""BEST-RQ: BERT-style pretraining on the codes of a frozen random-projection
quantizer.  Counterpart of wenet_tpu/models/ssl/bestrq_model.py.

The quantizer's `projection` (input_dim, embedding_dim * num_codebooks)
and codebook `embeddings` (num_embeddings, num_codebooks, embedding_dim,
each code of unit norm) are buffers: saved in the state dict under the
reference's names, in the JAX package's layout, and never seen by the
optimizer.  The host draws of a forward (the span uniforms and the mask
embedding's N(0, 1) vector) come from `host_draws`, or from the `draws`
the caller passes."""

import math
from typing import Dict, List, Optional

import torch
from torch import nn
import torch.nn.functional as F

from wenet_tpu_torch.models.ssl.mask import (compute_mask_indices,
                                             mask_uniforms)
from wenet_tpu_torch.parallel.mesh import data_denominator
from wenet_tpu_torch.utils.mask import make_pad_mask

# flax's truncated_normal(stddev): a unit normal cut at +-2, scaled by
# stddev over the cut normal's own standard deviation
_TRUNC_STD = 0.87962566103423978


def truncated_normal_(t: torch.Tensor, stddev: float,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
    """Fill `t` with flax's truncated_normal(stddev) by inverting the CDF
    of uniforms drawn from `generator`."""
    lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, (1 + math.erf(
        2 / math.sqrt(2))) / 2
    t.uniform_(2 * lo - 1, 2 * hi - 1, generator=generator)
    t.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    return t.mul_(stddev / _TRUNC_STD)


def full_context(T: int):
    """The `dynamic_chunk` that keeps a dynamic-chunk encoder at full
    context, as the JAX encoder runs without a chunk key."""
    return (max(T, 1), -1)


def quantize_codes(latent: torch.Tensor,
                   codebook: torch.Tensor) -> torch.Tensor:
    """latent: (N, D); codebook: (C, G, D/G) -> the nearest code of each
    group, (N, G), by the expanded distance |a|^2 - 2 a.c + |c|^2 (the
    first of equal distances)."""
    N, D = latent.shape
    C, G, _ = codebook.shape
    lat = latent.reshape(N, G, D // G)
    distance = (lat.pow(2).sum(-1, keepdim=True) -
                2 * torch.einsum('ngd,cgd->ngc', lat, codebook) +
                codebook.permute(2, 1, 0).pow(2).sum(0, keepdim=True))
    return distance.argmin(-1)


class BestRQModel(nn.Module):

    def __init__(self, encoder: nn.Module, num_mel_bins: int = 80,
                 embedding_dim: int = 16, num_embeddings: int = 8192,
                 num_codebooks: int = 1, mask_prob: float = 0.01,
                 mask_length: int = 10, min_masks: int = 2,
                 out_bias: bool = False,
                 features_regularization_weight: float = 0.01):
        super().__init__()
        self.encoder = encoder
        self.num_mel_bins = num_mel_bins
        self.embedding_dim = embedding_dim
        self.num_embeddings = num_embeddings
        self.num_codebooks = num_codebooks
        self.mask_prob = mask_prob
        self.mask_length = mask_length
        self.min_masks = min_masks
        self.features_regularization_weight = features_regularization_weight
        odim = encoder.output_size()
        self.encoder_top_n_out = nn.Parameter(
            torch.empty(num_codebooks, odim, num_embeddings))
        self.encoder_top_n_out_bias = (nn.Parameter(
            torch.empty(num_codebooks, num_embeddings)) if out_bias else None)
        self.register_buffer('projection', torch.empty(
            num_mel_bins * self.stride, embedding_dim * num_codebooks))
        self.register_buffer('embeddings', torch.empty(
            num_embeddings, num_codebooks, embedding_dim))

    @property
    def stack_frames(self) -> int:
        return self.encoder.right_context + 1

    @property
    def stride(self) -> int:
        return self.encoder.subsampling_rate

    @torch.no_grad()
    def init_own(self, generator: Optional[torch.Generator] = None
                 ) -> List[torch.Tensor]:
        """Draw the head (truncated normal 0.02, zero bias) and the
        quantizer (glorot-uniform projection, unit-norm N(0, 1) codes)
        from `generator` -> the tensors filled."""
        truncated_normal_(self.encoder_top_n_out, 0.02, generator)
        done = [self.encoder_top_n_out, self.projection, self.embeddings]
        if self.encoder_top_n_out_bias is not None:
            self.encoder_top_n_out_bias.zero_()
            done.append(self.encoder_top_n_out_bias)
        limit = math.sqrt(6.0 / sum(self.projection.shape))
        self.projection.uniform_(-limit, limit, generator=generator)
        e = self.embeddings.normal_(generator=generator)
        e.div_(torch.linalg.norm(e, dim=-1, keepdim=True) + 1e-8)
        return done

    def host_draws(self, B: int, T: int,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        """The forward's draws on the host's CPU for B rows of T subsampled
        frames: `mask_count` (B,) and `mask_start` (B, max masks)
        uniforms, `mask_emb` (num_mel_bins,) N(0, 1).  Without a generator
        (cv), a fixed one, as the JAX model takes PRNGKey(0)."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        count, start = mask_uniforms(B, T, self.mask_prob, self.mask_length,
                                     self.min_masks, generator)
        return {'mask_count': count, 'mask_start': start,
                'mask_emb': torch.randn(self.num_mel_bins,
                                        generator=generator)}

    def forward(self, feats: torch.Tensor, feats_lengths: torch.Tensor,
                target: Optional[torch.Tensor] = None,
                target_lengths: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                draws: Optional[Dict[str, torch.Tensor]] = None
                ) -> Dict[str, torch.Tensor]:
        """Masked prediction of the codes of the unmasked features ->
        {loss, codes_acc, features_l2, num_codes, th_accuracy}.  The loss
        is the code's cross entropy (fp32 log-softmax) over the masked
        valid frames and codebooks, plus features_regularization_weight x
        mean(feats^2) over the padded tensor.  `generator` feeds
        `host_draws` and the encoder's dropout seeds; `draws` replaces
        `host_draws`.  The targets are computed in fp32 under autocast."""
        del target, target_lengths
        xs = feats
        B, T, _ = xs.shape
        features_pen = xs.pow(2).mean()
        padding = make_pad_mask(feats_lengths, T)
        n_win = max(0, (T - self.stack_frames) // self.stride + 1)
        if draws is None:
            draws = self.host_draws(B, n_win, generator)
        masked_xs, code_ids_mask = self._apply_mask_signal(xs, padding,
                                                           n_win, draws)
        with torch.autocast(xs.device.type, enabled=False):
            target_ids = self._nearest_embedding_idx(
                self._stack_features(xs, padding))
        out, out_mask = self.encoder(masked_xs, feats_lengths,
                                     generator=generator,
                                     dynamic_chunk=full_context(T))
        Tn = min(out.shape[1], code_ids_mask.shape[1], target_ids.shape[1])
        out = out[:, :Tn]
        code_ids_mask = code_ids_mask[:, :Tn]
        tgt = target_ids[:, :Tn].transpose(1, 2)  # (B, G, T)

        logits = torch.einsum('btd,gdv->bgtv', out, self.encoder_top_n_out)
        if self.encoder_top_n_out_bias is not None:
            logits = logits + self.encoder_top_n_out_bias[None, :, None, :]
        masks = (out_mask[:, 0, :Tn] & code_ids_mask).to(torch.float32)
        logp = F.log_softmax(logits.float(), dim=-1)
        true_lp = torch.gather(logp, -1, tgt[..., None])[..., 0]
        num_codes = masks.sum() * self.num_codebooks
        loss = (-true_lp * masks[:, None, :]).sum() / data_denominator(num_codes)
        if self.features_regularization_weight != 0.0:
            loss = loss + self.features_regularization_weight * features_pen
        ids_corr = logits.argmax(-1) == tgt
        codes_acc = (ids_corr * masks[:, None, :]).sum() / data_denominator(
            num_codes)
        return {'loss': loss, 'codes_acc': codes_acc,
                'features_l2': features_pen, 'num_codes': num_codes,
                'th_accuracy': codes_acc}

    def _apply_mask_signal(self, xs: torch.Tensor, padding: torch.Tensor,
                           n_win: int, draws: Dict[str, torch.Tensor]):
        """Span masks over the subsampled frames (a frame is padding if any
        raw frame of its stacked window is), each expanded to its first
        `stride` raw frames, which take 0.1 x the drawn mask embedding ->
        (masked xs, (B, n_win) mask)."""
        B, T, _ = xs.shape
        idx = (torch.arange(n_win, device=xs.device)[:, None] * self.stride +
               torch.arange(self.stack_frames, device=xs.device)[None, :])
        pad_stride = padding[:, idx].any(-1)
        masks = compute_mask_indices(pad_stride, self.mask_prob,
                                     self.mask_length, self.min_masks,
                                     draws['mask_count'], draws['mask_start'])
        raw = masks.repeat_interleave(self.stride, dim=1)[:, :T]
        full = torch.zeros(B, T, dtype=torch.bool, device=xs.device)
        full[:, :raw.shape[1]] = raw
        mask_emb = 0.1 * draws['mask_emb'].to(xs.device, xs.dtype)
        return torch.where(full[:, :, None], mask_emb, xs), masks

    def _stack_features(self, xs: torch.Tensor,
                        padding: torch.Tensor) -> torch.Tensor:
        """Stacks of `stride` frames, normalized per utterance over its
        valid stacks (mean, std + 1e-5)."""
        B, T, D = xs.shape
        n = T // self.stride
        stack = xs[:, :n * self.stride].reshape(B, n, self.stride * D)
        vw = (~padding[:, :n * self.stride]).reshape(B, n, self.stride)
        smask = vw.all(-1).to(xs.dtype)
        stack = stack * smask[:, :, None]
        denom = smask.sum(1, keepdim=True).clamp(min=1)[..., None]
        mean = stack.sum(1, keepdim=True) / denom
        std = torch.sqrt((stack - mean).pow(2).sum(1, keepdim=True) / denom)
        return (stack - mean) / (std + 1e-5)

    def _nearest_embedding_idx(self, xs: torch.Tensor) -> torch.Tensor:
        z = xs @ self.projection.to(xs.dtype)
        z = z / (torch.linalg.norm(z, dim=-1, keepdim=True) + 1e-8)
        B, T, C = z.shape
        return quantize_codes(z.reshape(B * T, C),
                              self.embeddings).reshape(B, T, -1)
