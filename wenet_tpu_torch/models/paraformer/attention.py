"""SAN-M attention: multi-head attention plus an FSMN memory (a depthwise
conv over the values).  Counterpart of
wenet_tpu/models/paraformer/attention.py `MultiHeadedAttentionSANM`,
`DummyMultiHeadSANM` (the FSMN alone: the paraformer decoder's
"self-attention") and `MultiHeadAttentionCross`.

The attentions call `attention_core` with no dropout on the weights, as
the JAX package does (its `attention_dropout_rate` reaches the FSMN
memory only), so on CUDA tensors above the flash gate they run K4, and
in training K4 with lse, K5 and K6 (the `FlashAttention` Function)."""

import math
from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from wenet_tpu_torch.models.transformer.attention import attention_core


class _Fsmn(nn.Module):
    """The FSMN memory: x·m, a depthwise conv with no padding of its own
    over x padded by (left, right), + x·m, dropout, ·m (m the valid
    frames)."""

    def __init__(self, n_feat: int, dropout_rate: float, kernel_size: int,
                 sanm_shfit: int):
        super().__init__()
        self.fsmn_block = nn.Conv1d(n_feat, n_feat, kernel_size,
                                    groups=n_feat, bias=False)
        left = (kernel_size - 1) // 2 + sanm_shfit
        self.paddings = (left, kernel_size - 1 - left)
        self.dropout = nn.Dropout(dropout_rate)

    def fsmn(self, x: torch.Tensor,
             mask_pad: Optional[torch.Tensor]) -> torch.Tensor:
        """x: (B, T, C); mask_pad: (B, 1, T) bool valid or None."""
        m = None
        if mask_pad is not None:
            m = mask_pad.transpose(1, 2).to(x.dtype)
            x = x * m
        y = self.fsmn_block(F.pad(x.transpose(1, 2), self.paddings))
        y = self.dropout(y.transpose(1, 2) + x)
        return y if m is None else y * m


def _heads(t: torch.Tensor, h: int) -> torch.Tensor:
    """(B, T, h*d) -> (B, h, T, d) view."""
    B, T, _ = t.shape
    return t.view(B, T, h, -1).transpose(1, 2)


class MultiHeadedAttentionSANM(_Fsmn):
    """Fused q/k/v projection from `in_feat`, attention over `n_head`
    heads, plus the FSMN memory of the values."""

    def __init__(self, n_head: int, in_feat: int, n_feat: int,
                 dropout_rate: float = 0.0, kernel_size: int = 11,
                 sanm_shfit: int = 0):
        super().__init__(n_feat, dropout_rate, kernel_size, sanm_shfit)
        self.h = n_head
        self.d_k = n_feat // n_head
        self.linear_q_k_v = nn.Linear(in_feat, 3 * n_feat)
        self.linear_out = nn.Linear(n_feat, n_feat)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                mask_pad: Optional[torch.Tensor]) -> torch.Tensor:
        """x: (B, T, in_feat); mask: (B, T|1, T) bool attention mask;
        mask_pad: (B, 1, T) bool valid frames -> (B, T, n_feat)."""
        B, T, _ = x.shape
        q, k, v = self.linear_q_k_v(x).chunk(3, dim=-1)
        memory = self.fsmn(v, mask_pad)
        m = None if mask is None else mask.unsqueeze(1)
        ctx = attention_core(_heads(q, self.h), _heads(k, self.h),
                             _heads(v, self.h), m,
                             1.0 / math.sqrt(self.d_k))
        return self.linear_out(ctx.transpose(1, 2).reshape(B, T, -1)) + \
            memory


class DummyMultiHeadSANM(_Fsmn):
    """The FSMN memory alone (the paraformer decoder's self-attention)."""

    def forward(self, x: torch.Tensor,
                mask_pad: Optional[torch.Tensor]) -> torch.Tensor:
        return self.fsmn(x, mask_pad)


class MultiHeadAttentionCross(nn.Module):
    """Cross attention with a fused k/v projection of the memory."""

    def __init__(self, n_head: int, n_feat: int):
        super().__init__()
        self.h = n_head
        self.d_k = n_feat // n_head
        self.linear_q = nn.Linear(n_feat, n_feat)
        self.linear_k_v = nn.Linear(n_feat, 2 * n_feat)
        self.linear_out = nn.Linear(n_feat, n_feat)

    def forward(self, query: torch.Tensor, memory: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
        """query: (B, T1, F); memory: (B, T2, F); mask: (B, T1|1, T2)."""
        B, T1, _ = query.shape
        k, v = self.linear_k_v(memory).chunk(2, dim=-1)
        m = None if mask is None else mask.unsqueeze(1)
        ctx = attention_core(_heads(self.linear_q(query), self.h),
                             _heads(k, self.h), _heads(v, self.h), m,
                             1.0 / math.sqrt(self.d_k))
        return self.linear_out(ctx.transpose(1, 2).reshape(B, T1, -1))
