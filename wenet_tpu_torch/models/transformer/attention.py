"""Multi-head attention: plain MHA, cross attention and rel-pos MHA.
Counterpart of wenet_tpu/models/transformer/attention.py.

Rel-pos self-attention always goes through `flash_attention_relpos`: the
Hopper kernels for CUDA tensors, their plain versions for CPU tensors,
with the backward kernels behind autograd.  In training its
attention-weight dropout runs inside the kernels (a counter hash seeded
per call from the host generator the train step passes down), as the JAX
package's flash training path does.  The decoder's attention stays plain
PyTorch, with `nn.Dropout` on the weights.
"""

import math
from typing import Optional, Tuple

import torch
from torch import nn

from wenet_tpu_torch.ops.flash_attention import (NEG_INF,
                                                 flash_attention_relpos)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: Optional[torch.Tensor], scale: float,
                   dropout: nn.Module) -> torch.Tensor:
    """softmax(q·kᵀ·scale masked) · v with fp32 scores.

    q: (..., h, T1, d); k, v: (..., h, T2, d); mask: bool broadcastable
    to (..., 1|h, T1|1, T2), True == attend.  Fully masked rows give 0."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    attn = torch.softmax(scores, dim=-1)
    if mask is not None:
        attn = attn.masked_fill(~mask, 0.0)
    attn = dropout(attn).to(v.dtype)
    return torch.matmul(attn, v)


class MultiHeadedAttention(nn.Module):
    """Multi-head attention with biased q/k/v/out projections."""

    def __init__(self, n_head: int, n_feat: int, dropout_rate: float = 0.0):
        super().__init__()
        assert n_feat % n_head == 0
        self.h = n_head
        self.d_k = n_feat // n_head
        self.linear_q = nn.Linear(n_feat, n_feat)
        self.linear_k = nn.Linear(n_feat, n_feat)
        self.linear_v = nn.Linear(n_feat, n_feat)
        self.linear_out = nn.Linear(n_feat, n_feat)
        self.dropout = nn.Dropout(dropout_rate)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, h*d) -> (B, h, T, d) view."""
        return x.view(x.shape[0], x.shape[1], self.h, self.d_k).transpose(1, 2)

    def project_q(self, x: torch.Tensor) -> torch.Tensor:
        return self._heads(self.linear_q(x))

    def project_kv(self, key: torch.Tensor, value: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._heads(self.linear_k(key)), self._heads(self.linear_v(value))

    def _finish(self, ctx: torch.Tensor) -> torch.Tensor:
        B, _, T, _ = ctx.shape
        return self.linear_out(ctx.transpose(1, 2).reshape(B, T, -1))

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """mask: (B, T1|1, T2) bool."""
        q = self.project_q(query)
        k, v = self.project_kv(key, value)
        m = None if mask is None else mask.unsqueeze(1)
        ctx = attention_core(q, k, v, m, 1.0 / math.sqrt(self.d_k),
                             self.dropout)
        return self._finish(ctx)


class MultiHeadedCrossAttention(MultiHeadedAttention):
    """Decoder-to-encoder attention.  Queries may be beam-expanded:
    (B*N, T1, F) against keys of (B, T2, F)."""

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        q = self.project_q(query)
        k, v = self.project_kv(key, value)
        m = None if mask is None else mask.unsqueeze(1)
        Bq, Bk = q.shape[0], k.shape[0]
        scale = 1.0 / math.sqrt(self.d_k)
        if Bq != Bk:
            q = q.reshape((Bk, Bq // Bk) + q.shape[1:])
            ctx = attention_core(q, k.unsqueeze(1), v.unsqueeze(1),
                                 None if m is None else m.unsqueeze(1),
                                 scale, self.dropout)
            ctx = ctx.reshape((Bq,) + ctx.shape[2:])
        else:
            ctx = attention_core(q, k, v, m, scale, self.dropout)
        return self._finish(ctx)


class RelPositionMultiHeadedAttention(MultiHeadedAttention):
    """Transformer-XL relative-position MHA (no rel_shift), computed by
    the fused rel-pos attention kernels."""

    def __init__(self, n_head: int, n_feat: int, dropout_rate: float = 0.0):
        super().__init__(n_head, n_feat, dropout_rate)
        self.linear_pos = nn.Linear(n_feat, n_feat, bias=False)
        self.pos_bias_u = nn.Parameter(torch.empty(n_head, self.d_k))
        self.pos_bias_v = nn.Parameter(torch.empty(n_head, self.d_k))

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor, mask: Optional[torch.Tensor],
                pos_emb: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """mask: (B, T1|1, T2) bool; pos_emb: (1|B, T2, F).

        In training with attention dropout, each call draws a uint32
        dropout seed from `generator` (a host generator, so no device
        sync; None takes torch's default CPU generator)."""
        rate = self.dropout.p if self.training else 0.0
        seed = None
        if rate > 0.0:
            seed = int(torch.randint(0, 1 << 32, (), generator=generator))
        q = self.project_q(query)
        k, v = self.project_kv(key, value)
        p = self._heads(self.linear_pos(pos_emb))  # (1|B, h, T2, d)
        u = self.pos_bias_u.to(q.dtype)[None, :, None, :]
        w = self.pos_bias_v.to(q.dtype)[None, :, None, :]
        ctx = flash_attention_relpos(q + u, q + w, k, p, v, mask,
                                     1.0 / math.sqrt(self.d_k), rate, seed)
        return self._finish(ctx)
