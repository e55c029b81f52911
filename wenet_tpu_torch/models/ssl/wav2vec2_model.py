"""wav2vec 2.0: contrastive pretraining against a gumbel-softmax quantizer.
Counterpart of wenet_tpu/models/ssl/wav2vec2_model.py.

The gumbel noise, the span uniforms and the negatives' uniforms are host
draws (`host_draws`, or the `draws` the caller passes).  The JAX trainer
never passes `steps`, so the gumbel temperature stays at
`max_gumbel_temperature` in training, here too."""

from typing import Dict, Optional

import torch
from torch import nn
import torch.nn.functional as F

from wenet_tpu_torch.models.ssl.mask import (compute_mask_indices,
                                             mask_uniforms, negative_uniforms,
                                             sample_negative_indices)
from wenet_tpu_torch.parallel.mesh import data_denominator


def gumbel_uniforms(shape, generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """U[1e-20, 1) on the host's CPU, as the JAX quantizer draws them."""
    return torch.rand(shape, generator=generator).clamp_(min=1e-20)


class Wav2vecGumbelVectorQuantizer(nn.Module):

    def __init__(self, features_dim: int = 256, num_codebooks: int = 2,
                 num_embeddings: int = 8192, embedding_dim: int = 16,
                 hard: bool = False):
        super().__init__()
        assert embedding_dim % num_codebooks == 0
        self.num_codebooks = num_codebooks
        self.num_embeddings = num_embeddings
        self.hard = hard
        self.embeddings = nn.Parameter(torch.empty(
            1, num_codebooks * num_embeddings,
            embedding_dim // num_codebooks))
        self.weight_proj = nn.Linear(features_dim,
                                     num_codebooks * num_embeddings)

    @torch.no_grad()
    def init_own(self, generator: Optional[torch.Generator] = None):
        """The codebook ~ U[0, 1), as flax's uniform(1.0)."""
        self.embeddings.uniform_(0.0, 1.0, generator=generator)
        return [self.embeddings]

    @staticmethod
    def _perplexity(probs: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """exp of each codebook's entropy of the mean code distribution over
        the valid frames, summed over the codebooks."""
        if mask is not None:
            m = mask.reshape(-1)[:, None, None].expand(probs.shape)
            probs = torch.where(m, probs, 0.0)
            marginal = probs.sum(0) / mask.sum().clamp(min=1)
        else:
            marginal = probs.mean(0)
        return torch.exp(-(marginal * torch.log(marginal + 1e-7)).sum(-1)
                         ).sum()

    def forward(self, input: torch.Tensor, input_mask: torch.Tensor,
                temperature: float = 1.0,
                gumbel_u: Optional[torch.Tensor] = None):
        """-> (codevectors (b, t, embedding_dim), perplexity, code ids (b, t,
        G)).  Soft (the default): softmax((logits + gumbel) / temperature),
        the gumbel noise -log(-log(u)) from `gumbel_u`, (b*t*G, V)."""
        b, t, _ = input.shape
        G, V = self.num_codebooks, self.num_embeddings
        hidden = self.weight_proj(input).reshape(b * t * G, -1)
        if not self.hard:
            g = -torch.log(-torch.log(gumbel_u.to(hidden.device,
                                                  hidden.dtype)))
            probs = F.softmax((hidden + g) / temperature, dim=-1)
            soft = F.softmax(hidden.reshape(b * t, G, -1), dim=-1)
            perplexity = self._perplexity(soft, input_mask)
        else:
            probs = F.one_hot(hidden.argmax(-1), hidden.shape[-1]).to(
                hidden.dtype)
            perplexity = self._perplexity(probs.reshape(b * t, G, -1),
                                          input_mask)
        targets_idx = probs.reshape(b * t, G, -1).argmax(-1).reshape(b, t, -1)
        vecs = probs.reshape(b * t, -1)[:, :, None] * self.embeddings
        codevectors = vecs.reshape(b * t, G, V, -1).sum(-2).reshape(b, t, -1)
        return codevectors, perplexity, targets_idx


def compute_contrastive_loss(quantized: torch.Tensor, features: torch.Tensor,
                             negative_indices: torch.Tensor,
                             mask_time_indices: torch.Tensor,
                             logits_temp: float,
                             num_negatives: int) -> torch.Tensor:
    """Summed -log softmax of the positive (class 0) among itself and the
    negatives, by cosine similarity / logits_temp, over the masked frames;
    a negative equal to the positive is ruled out (-1e9)."""
    B, T, H = quantized.shape
    flat = quantized.reshape(-1, H)
    negs = flat[negative_indices.reshape(-1)].reshape(
        B, T, num_negatives, H).permute(2, 0, 1, 3)
    targets = torch.cat([quantized[None], negs], 0)  # (1+N, B, T, H)

    def cos(a, b):
        num = (a * b).sum(-1)
        return num / (torch.linalg.norm(a, dim=-1) *
                      torch.linalg.norm(b, dim=-1) + 1e-8)

    logits = cos(features[None], targets) / logits_temp
    neg_is_pos = (quantized[None] == negs).all(-1)
    neg_is_pos = torch.cat([torch.zeros(1, B, T, dtype=torch.bool,
                                        device=quantized.device),
                            neg_is_pos], 0)
    logits = logits.masked_fill(neg_is_pos, -1e9)
    logp = F.log_softmax(logits.float(), dim=0)
    return (-logp[0] * mask_time_indices).sum()


class Wav2vec2Model(nn.Module):

    def __init__(self, encoder: nn.Module, embedding_dim: int = 256,
                 num_embeddings: int = 320, num_codebooks: int = 1,
                 mask_prob: float = 0.065, mask_length: int = 10,
                 min_masks: int = 2, num_negatives: int = 100,
                 features_regularization_weight: float = 0.01,
                 max_gumbel_temperature: float = 2.0,
                 min_gumbel_temperature: float = 0.1,
                 gumbel_temperature_decay: float = 0.999995,
                 contrastive_logits_temperature: float = 0.1,
                 diversity_weight: float = 0.0):
        super().__init__()
        self.encoder = encoder
        self.num_embeddings = num_embeddings
        self.num_codebooks = num_codebooks
        self.mask_prob = mask_prob
        self.mask_length = mask_length
        self.min_masks = min_masks
        self.num_negatives = num_negatives
        self.features_regularization_weight = features_regularization_weight
        self.max_gumbel_temperature = max_gumbel_temperature
        self.min_gumbel_temperature = min_gumbel_temperature
        self.gumbel_temperature_decay = gumbel_temperature_decay
        self.contrastive_logits_temperature = contrastive_logits_temperature
        self.diversity_weight = diversity_weight
        self.quantizer = Wav2vecGumbelVectorQuantizer(
            encoder.output_size(), num_codebooks, num_embeddings,
            embedding_dim, hard=False)
        self.mask_emb = nn.Parameter(torch.empty(encoder.output_size()))
        # the blocks run without the encoder's final norm: the JAX model
        # has no parameters for it
        encoder.after_norm = nn.Identity()

    @torch.no_grad()
    def init_own(self, generator: Optional[torch.Generator] = None):
        """mask_emb ~ U[0, 1), as flax's uniform(1.0)."""
        self.mask_emb.uniform_(0.0, 1.0, generator=generator)
        return [self.mask_emb]

    def host_draws(self, B: int, T: int,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        """The forward's draws on the host's CPU for B rows of T subsampled
        frames: the span uniforms, the gumbel uniforms (B*T*G, V) and the
        negatives' (B, T, num_negatives); a fixed generator without one."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        count, start = mask_uniforms(B, T, self.mask_prob, self.mask_length,
                                     self.min_masks, generator)
        return {'mask_count': count, 'mask_start': start,
                'gumbel': gumbel_uniforms(
                    (B * T * self.num_codebooks, self.num_embeddings),
                    generator),
                'negatives': negative_uniforms(B, T, self.num_negatives,
                                               generator)}

    def gumbel_temperature(self, steps: int) -> float:
        return max(self.max_gumbel_temperature *
                   self.gumbel_temperature_decay ** steps,
                   self.min_gumbel_temperature)

    def _forward_blocks(self, xs, att_mask, pos_emb, mask_pad, generator,
                        layers):
        for layer in layers:
            xs, _, _ = layer(xs, att_mask, pos_emb, mask_pad, generator)
        return xs

    def forward(self, feats: torch.Tensor, feats_lengths: torch.Tensor,
                target: Optional[torch.Tensor] = None,
                target_lengths: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                draws: Optional[Dict[str, torch.Tensor]] = None,
                steps: int = 0) -> Dict[str, Optional[torch.Tensor]]:
        """-> {loss, loss_contrastive, loss_diversity, code_ppl,
        features_l2}: the subsampled frames, spans replaced by mask_emb,
        through the blocks (no final norm), against the
        quantized unmasked frames and their negatives."""
        del target, target_lengths
        xs, pos_emb, masks = self.encoder.embed_input(feats, feats_lengths)
        B, T, _ = xs.shape
        if draws is None:
            draws = self.host_draws(B, T, generator)
        span_mask = compute_mask_indices(
            ~masks[:, 0, :], self.mask_prob, self.mask_length,
            self.min_masks, draws['mask_count'], draws['mask_start'])
        masked_xs = torch.where(span_mask[:, :, None], self.mask_emb, xs)
        out = self._forward_blocks(masked_xs, masks, pos_emb, masks,
                                   generator, self.encoder.encoders)
        quantized, perplexity, _ = self.quantizer(
            xs, masks[:, 0, :], self.gumbel_temperature(steps),
            draws['gumbel'])
        neg_idx = sample_negative_indices(span_mask, self.num_negatives,
                                          draws['negatives'])
        loss_contrastive = compute_contrastive_loss(
            quantized, out, neg_idx, span_mask,
            self.contrastive_logits_temperature, self.num_negatives)
        loss = loss_contrastive
        sample_size = data_denominator(span_mask.sum())
        loss_diversity = None
        if self.diversity_weight != 0.0:
            n = self.num_codebooks * self.num_embeddings
            loss_diversity = (n - perplexity) / n
            loss = loss + self.diversity_weight * loss_diversity * \
                sample_size
        loss = loss / sample_size
        features_pen = xs.pow(2).mean()
        if self.features_regularization_weight != 0.0:
            loss = loss + self.features_regularization_weight * features_pen
        return {'loss': loss,
                'loss_contrastive': loss_contrastive / sample_size,
                'loss_diversity': loss_diversity, 'code_ppl': perplexity,
                'features_l2': features_pen}
