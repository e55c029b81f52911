"""FireRed AED: a conformer encoder with its own subsampling, relative
position encoding and rel-pos attention (q/k/v layer norms and the
legacy Transformer-XL shift), and the transformer decoder.  Counterpart
of wenet_tpu/models/firered/model.py.  The JAX package computes this
attention outside any kernel, with einsums (model.py:88-104), so here it
is plain PyTorch too and takes no rel-pos kernel."""

import math
from typing import Optional, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from wenet_tpu_torch.models.transformer.asr_model import ASRModel
from wenet_tpu_torch.models.transformer.attention import NEG_INF
from wenet_tpu_torch.models.transformer.cmvn import GlobalCMVN
from wenet_tpu_torch.models.transformer.convolution import ConvolutionModule
from wenet_tpu_torch.models.transformer.positionwise_feed_forward import (
    PositionwiseFeedForward)
from wenet_tpu_torch.utils.mask import make_pad_mask


def firered_rel_pos_emb(T: int, d_model: int, device=None) -> torch.Tensor:
    """Interleaved sin/cos of the relative positions T-1 .. -(T-1) ->
    (1, 2T-1, d)."""
    r = (T - 1) - torch.arange(2 * T - 1, device=device, dtype=torch.float32)
    div = torch.exp(torch.arange(0, d_model, 2, device=device,
                                 dtype=torch.float32) *
                    (-math.log(10000.0) / d_model))
    ang = r[:, None] * div
    return torch.stack([torch.sin(ang), torch.cos(ang)], -1).reshape(
        1, 2 * T - 1, d_model)


def firered_rel_shift(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, 2T-1) -> (B, H, T, T): the legacy XL shift (a zero
    column in front, the rows re-read one place on)."""
    B, H, T1, T2 = x.shape
    x = torch.cat([x.new_zeros(B, H, T1, 1), x], -1)
    x = x.reshape(B, H, T2 + 1, T1)[:, :, 1:].reshape(B, H, T1, T2)
    return x[:, :, :, :T2 // 2 + 1]


class FireRedRelPosAttention(nn.Module):
    """Rel-pos MHA over layer-normed q, k and v inputs (eps 1e-6)."""

    def __init__(self, n_head: int, n_feat: int):
        super().__init__()
        self.h = n_head
        self.d_k = n_feat // n_head
        self.layer_norm_q = nn.LayerNorm(n_feat, eps=1e-6)
        self.layer_norm_k = nn.LayerNorm(n_feat, eps=1e-6)
        self.layer_norm_v = nn.LayerNorm(n_feat, eps=1e-6)
        self.linear_q = nn.Linear(n_feat, n_feat)
        self.linear_k = nn.Linear(n_feat, n_feat)
        self.linear_v = nn.Linear(n_feat, n_feat)
        self.linear_pos = nn.Linear(n_feat, n_feat, bias=False)
        self.linear_out = nn.Linear(n_feat, n_feat)
        self.pos_bias_u = nn.Parameter(torch.empty(n_head, self.d_k))
        self.pos_bias_v = nn.Parameter(torch.empty(n_head, self.d_k))

    def _heads(self, t: torch.Tensor) -> torch.Tensor:
        return t.view(t.shape[0], t.shape[1], self.h, -1).transpose(1, 2)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                pos_emb: torch.Tensor) -> torch.Tensor:
        """x (B, T, D); mask (B, T|1, T) bool; pos_emb (1, 2T-1, D)."""
        B, T, _ = x.shape
        q = self._heads(self.linear_q(self.layer_norm_q(x)))
        k = self._heads(self.linear_k(self.layer_norm_k(x)))
        v = self._heads(self.linear_v(self.layer_norm_v(x)))
        p = self._heads(self.linear_pos(pos_emb))
        u = self.pos_bias_u.to(q.dtype)[None, :, None, :]
        w = self.pos_bias_v.to(q.dtype)[None, :, None, :]
        ac = torch.matmul((q + u).float(), k.float().transpose(-1, -2))
        bd = torch.matmul((q + w).float(), p.float().transpose(-1, -2))
        scores = (ac + firered_rel_shift(bd)) / math.sqrt(self.d_k)
        if mask is not None:
            m = mask.unsqueeze(1)
            scores = scores.masked_fill(~m, NEG_INF)
        attn = torch.softmax(scores, dim=-1)
        if mask is not None:
            attn = attn.masked_fill(~m, 0.0)
        ctx = torch.matmul(attn.to(v.dtype), v)
        return self.linear_out(ctx.transpose(1, 2).reshape(B, T, -1))


class FireRedConformerLayer(nn.Module):
    """The conformer block without `norm_mha` (the attention normalizes
    its own inputs): macaron FFN (x 1/2), rel-pos MHSA, conv module, FFN
    (x 1/2), `norm_final`.  Swish activations."""

    def __init__(self, size: int, attention_heads: int, linear_units: int,
                 dropout_rate: float = 0.1, cnn_module_kernel: int = 33,
                 cnn_module_norm: str = 'batch_norm',
                 conv_norm_eps: float = 1e-5):
        super().__init__()
        self.self_attn = FireRedRelPosAttention(attention_heads, size)
        self.feed_forward = PositionwiseFeedForward(
            size, linear_units, dropout_rate, F.silu)
        self.feed_forward_macaron = PositionwiseFeedForward(
            size, linear_units, dropout_rate, F.silu)
        self.conv_module = ConvolutionModule(size, cnn_module_kernel,
                                             cnn_module_norm, False,
                                             conv_norm_eps)
        self.norm_ff_macaron = nn.LayerNorm(size, eps=1e-5)
        self.norm_conv = nn.LayerNorm(size, eps=1e-5)
        self.norm_ff = nn.LayerNorm(size, eps=1e-5)
        self.norm_final = nn.LayerNorm(size, eps=1e-5)
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                pos_emb: torch.Tensor, mask_pad: torch.Tensor
                ) -> torch.Tensor:
        x = x + 0.5 * self.dropout(self.feed_forward_macaron(
            self.norm_ff_macaron(x)))
        x = x + self.dropout(self.self_attn(x, mask, pos_emb))
        y, _ = self.conv_module(self.norm_conv(x), mask_pad)
        x = x + self.dropout(y)
        x = x + 0.5 * self.dropout(self.feed_forward(self.norm_ff(x)))
        return self.norm_final(x)


class FireRedSubsampling(nn.Module):
    """Two 3x3 stride-2 convs (relu) over the features right-padded by
    `right_context` zero frames, then a linear layer; the relative
    position encoding of the output frames."""

    subsampling_rate = 4
    right_context = 6

    def __init__(self, idim: int, d_model: int, odim: int = 32):
        super().__init__()
        self.conv = nn.Sequential(nn.Conv2d(1, odim, 3, 2), nn.ReLU(),
                                  nn.Conv2d(odim, odim, 3, 2), nn.ReLU())
        f = ((idim - 1) // 2 - 1) // 2
        self.out = nn.Sequential(nn.Linear(odim * f, d_model))
        self.d_model = d_model

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor):
        """x (B, T, F); x_mask (B, 1, T) -> (x (B, T', D), pos_emb (1,
        2T'-1, D), mask (B, 1, T'))."""
        lens = x_mask[:, 0, :].sum(-1) + self.right_context
        x = F.pad(x, (0, 0, 0, self.right_context))
        x_mask = ~make_pad_mask(lens, x.shape[1])[:, None, :]
        x = self.conv(x[:, None])  # (B, C, T', F')
        b, c, t, f = x.shape
        x = self.out[0](x.transpose(1, 2).reshape(b, t, c * f))
        pos_emb = firered_rel_pos_emb(t, self.d_model, x.device).to(x.dtype)
        return x, pos_emb, x_mask[:, :, :-2:2][:, :, :-2:2]


class FireRedConformerEncoder(nn.Module):
    """Optional global cmvn, `FireRedSubsampling` (`embed`) and the
    FireRed conformer blocks; no final norm."""

    def __init__(self, input_size: int, output_size: int = 256,
                 attention_heads: int = 4, linear_units: int = 2048,
                 num_blocks: int = 6, dropout_rate: float = 0.1,
                 positional_dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0,
                 cnn_module_kernel: int = 33,
                 cnn_module_norm: str = 'batch_norm',
                 conv_norm_eps: float = 1e-5, odim_conv: int = 32,
                 use_cmvn: bool = False):
        super().__init__()
        self._output_size = output_size
        self.global_cmvn = GlobalCMVN(input_size) if use_cmvn else None
        self.embed = FireRedSubsampling(input_size, output_size, odim_conv)
        self.encoders = nn.ModuleList(
            FireRedConformerLayer(output_size, attention_heads,
                                  linear_units, dropout_rate,
                                  cnn_module_kernel, cnn_module_norm,
                                  conv_norm_eps)
            for _ in range(num_blocks))

    def output_size(self) -> int:
        return self._output_size

    @property
    def subsampling_rate(self) -> int:
        return self.embed.subsampling_rate

    @property
    def right_context(self) -> int:
        return self.embed.right_context

    def forward(self, xs: torch.Tensor, xs_lens: torch.Tensor,
                decoding_chunk_size: int = 0,
                num_decoding_left_chunks: int = -1,
                generator: Optional[torch.Generator] = None,
                dynamic_chunk=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full context (an AED encoder: the chunk arguments are not
        read, as in the JAX package) -> (xs (B, T', D), masks (B, 1,
        T'))."""
        masks = ~make_pad_mask(xs_lens, xs.shape[1])[:, None, :]
        if self.global_cmvn is not None:
            xs = self.global_cmvn(xs)
        xs, pos_emb, masks = self.embed(xs, masks)
        for layer in self.encoders:
            xs = layer(xs, masks, pos_emb, masks)
        return xs, masks


class FireRedModel(ASRModel):
    """The attention-decoder model; sos and eos are the special tokens
    `sos` and `eos`."""

    default_decode_method = 'attention'

    def __init__(self, vocab_size: int, encoder: nn.Module,
                 decoder: nn.Module, ctc: nn.Module,
                 special_tokens: dict, **kwargs):
        super().__init__(vocab_size, encoder, decoder, ctc,
                         special_tokens=special_tokens, **kwargs)
        self.sos = special_tokens['sos']
        self.eos = special_tokens['eos']
