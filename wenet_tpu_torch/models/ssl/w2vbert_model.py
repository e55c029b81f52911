"""W2V-BERT: a contrastive loss on the first `contrastive_blocks` encoder
blocks and masked prediction of the quantizer's codes (MLM) on the rest.
Counterpart of wenet_tpu/models/ssl/w2vbert_model.py, with the SSL
registry (`SSL_MODEL_CLASSES`, under the JAX package's names).

Masked frames take 0.1 x N(0, 1) noise, a host draw like the others
(`host_draws`, or the caller's `draws`).  The JAX trainer passes no
`steps`: the gumbel temperature stays at its maximum and the MLM weight
at its warm-up start, 0.1, in training."""

from typing import Dict, Optional

import torch
from torch import nn
import torch.nn.functional as F

from wenet_tpu_torch.models.ssl.bestrq_model import (BestRQModel,
                                                     truncated_normal_)
from wenet_tpu_torch.models.ssl.mask import (compute_mask_indices,
                                             sample_negative_indices)
from wenet_tpu_torch.models.ssl.wav2vec2_model import (
    Wav2vec2Model, compute_contrastive_loss)
from wenet_tpu_torch.parallel.mesh import data_denominator


class W2VBERTModel(Wav2vec2Model):

    def __init__(self, encoder: nn.Module, embedding_dim: int = 256,
                 num_embeddings: int = 320, num_codebooks: int = 1,
                 mask_prob: float = 0.065, mask_length: int = 10,
                 min_masks: int = 2, num_negatives: int = 100,
                 features_regularization_weight: float = 0.01,
                 max_gumbel_temperature: float = 2.0,
                 min_gumbel_temperature: float = 0.1,
                 gumbel_temperature_decay: float = 0.999995,
                 contrastive_logits_temperature: float = 0.1,
                 diversity_weight: float = 0.0, bias: bool = True,
                 contrastive_blocks: int = 6, masked_blocks: int = 6,
                 contrastive_weight: float = 1.0, mlm_weight: float = 1.0,
                 warmup_steps: int = 25000):
        super().__init__(encoder, embedding_dim, num_embeddings,
                         num_codebooks, mask_prob, mask_length, min_masks,
                         num_negatives, features_regularization_weight,
                         max_gumbel_temperature, min_gumbel_temperature,
                         gumbel_temperature_decay,
                         contrastive_logits_temperature, diversity_weight)
        assert (contrastive_blocks > 0 and masked_blocks > 0 and
                contrastive_blocks + masked_blocks == len(encoder.encoders))
        del self.mask_emb  # masked frames take noise
        self.contrastive_blocks = contrastive_blocks
        self.contrastive_weight = contrastive_weight
        self.mlm_weight = mlm_weight
        self.warmup_steps = warmup_steps
        odim = encoder.output_size()
        self.encoder_top_n_out = nn.Parameter(
            torch.empty(num_codebooks, odim, num_embeddings))
        self.encoder_top_n_out_bias = (nn.Parameter(
            torch.empty(num_codebooks, num_embeddings)) if bias else None)

    @torch.no_grad()
    def init_own(self, generator: Optional[torch.Generator] = None):
        """The MLM head: truncated normal 0.02, zero bias."""
        truncated_normal_(self.encoder_top_n_out, 0.02, generator)
        if self.encoder_top_n_out_bias is None:
            return [self.encoder_top_n_out]
        self.encoder_top_n_out_bias.zero_()
        return [self.encoder_top_n_out, self.encoder_top_n_out_bias]

    def host_draws(self, B: int, T: int,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        """wav2vec 2.0's draws and `noise` (B, T, D) N(0, 1), D the
        encoder's width."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        draws = super().host_draws(B, T, generator)
        draws['noise'] = torch.randn(B, T, self.encoder.output_size(),
                                     generator=generator)
        return draws

    def mlm_weight_at(self, steps: int) -> float:
        """The MLM weight warms from 0.1 to mlm_weight over warmup_steps."""
        if steps >= self.warmup_steps:
            return self.mlm_weight
        return 0.1 + 0.9 * steps / max(self.warmup_steps, 1)

    def forward(self, feats: torch.Tensor, feats_lengths: torch.Tensor,
                target: Optional[torch.Tensor] = None,
                target_lengths: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                draws: Optional[Dict[str, torch.Tensor]] = None,
                steps: int = 0) -> Dict[str, Optional[torch.Tensor]]:
        """-> {loss, loss_contrastive, loss_mlm, loss_diversity, code_ppl,
        features_l2, th_accuracy}: contrastive_weight x the contrastive
        loss + the MLM weight x the masked code cross entropy (fp32) on the
        last block's output."""
        del target, target_lengths
        xs, pos_emb, masks = self.encoder.embed_input(feats, feats_lengths)
        B, Tn, _ = xs.shape
        if draws is None:
            draws = self.host_draws(B, Tn, generator)
        span_mask = compute_mask_indices(
            ~masks[:, 0, :], self.mask_prob, self.mask_length,
            self.min_masks, draws['mask_count'], draws['mask_start'])
        noise = draws['noise'].to(xs.device, xs.dtype) * 0.1
        x = torch.where(span_mask[:, :, None], noise, xs)
        layers = self.encoder.encoders
        contrastive_out = self._forward_blocks(
            x, masks, pos_emb, masks, generator,
            layers[:self.contrastive_blocks])
        mlm_out = self._forward_blocks(contrastive_out, masks, pos_emb,
                                       masks, generator,
                                       layers[self.contrastive_blocks:])
        quantized, perplexity, target_ids = self.quantizer(
            xs, masks[:, 0, :], self.gumbel_temperature(steps),
            draws['gumbel'])
        neg_idx = sample_negative_indices(span_mask, self.num_negatives,
                                          draws['negatives'])
        sample_size = data_denominator(span_mask.sum())
        loss_contrastive = compute_contrastive_loss(
            quantized, contrastive_out, neg_idx, span_mask,
            self.contrastive_logits_temperature,
            self.num_negatives) / sample_size

        logits = torch.einsum('btd,gdv->bgtv', mlm_out,
                              self.encoder_top_n_out)
        if self.encoder_top_n_out_bias is not None:
            logits = logits + self.encoder_top_n_out_bias[None, :, None, :]
        logp = F.log_softmax(logits.float(), dim=-1)
        tgt = target_ids.transpose(1, 2)  # (B, G, T)
        true_lp = torch.gather(logp, -1, tgt[..., None])[..., 0]
        m = (span_mask[:, None, :] & masks[:, 0, None, :]).to(torch.float32)
        loss_mlm = -(true_lp * m).sum() / m.sum().clamp(min=1.0) / \
            self.num_codebooks
        loss = (self.contrastive_weight * loss_contrastive +
                self.mlm_weight_at(steps) * loss_mlm)
        loss_diversity = None
        if self.diversity_weight != 0.0:
            n = self.num_codebooks * self.num_embeddings
            loss_diversity = (n - perplexity) / n
            loss = loss + self.diversity_weight * loss_diversity
        features_pen = xs.pow(2).mean()
        if self.features_regularization_weight != 0.0:
            loss = loss + self.features_regularization_weight * features_pen
        ids_corr = logits.argmax(-1) == tgt
        acc = (ids_corr * m).sum() / (m.sum() * self.num_codebooks).clamp(
            min=1)
        return {'loss': loss, 'loss_contrastive': loss_contrastive,
                'loss_mlm': loss_mlm, 'loss_diversity': loss_diversity,
                'code_ppl': perplexity, 'features_l2': features_pen,
                'th_accuracy': acc}


# model name in train.yaml -> class (the JAX package's names)
SSL_MODEL_CLASSES = {'bestrq_model': BestRQModel,
                     'wav2vec_model': Wav2vec2Model,
                     'w2vbert_model': W2VBERTModel}
