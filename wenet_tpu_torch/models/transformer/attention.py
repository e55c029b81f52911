"""Multi-head attention: plain MHA (with the decoder's incremental step),
cross attention and rel-pos MHA.  Counterpart of
wenet_tpu/models/transformer/attention.py.

Rel-pos self-attention always goes through `flash_attention_relpos`: the
Hopper kernels for CUDA tensors, their plain versions for CPU tensors,
with the backward kernels behind autograd.  In training its
attention-weight dropout runs inside the kernels (a counter hash seeded
per call from the host generator the train step passes down), as the JAX
package's flash training path does.

`attention_core` (plain MHA and cross attention) goes through
`flash_attention` on CUDA tensors that pass the JAX package's gate
(`_flash_eligible`, attention.py:70-82: both lengths >= 512, or both >=
128 with B·h·T1·T2 >= 24M scores) when no attention dropout is active:
K4 in inference; K4 with lse, then K5 and K6 in the backward, when
autograd records (whisper's encoder in training).  The kernels raise on a
dtype or head dim they have no instance for.  Active attention dropout,
shapes below the gate and CPU tensors take the plain
matmul-softmax-matmul path, with `nn.Dropout` on the weights, as the JAX
package sends every call with a dropout function to XLA
(attention.py:115).

The q/k/v/out projections are `LoRALinear` where a lora conf lists them
(`make_attention_linear`, the JAX `make_attention_dense`).
"""

import math
from typing import Optional, Tuple

import torch
from torch import nn

from wenet_tpu_torch.models.finetune.lora import make_attention_linear
from wenet_tpu_torch.ops.flash_attention import (NEG_INF, flash_attention,
                                                 flash_attention_relpos)

T_CACHE = Tuple[torch.Tensor, torch.Tensor]  # (k, v): (B, h, T, d)

# the JAX package's inference gate for the flash kernel (`_FLASH`)
FLASH_GATE = {'min_len': 512, 'score_elems': 24 * 1024 * 1024}


def flash_eligible(q: torch.Tensor, k: torch.Tensor) -> bool:
    """True where `attention_core` takes the flash kernels: CUDA
    (B, h, T, d) inputs long enough to pass the gate, whatever their dtype
    and head dim."""
    if q.device.type != 'cuda' or q.dim() != 4 or q.shape[1] != k.shape[1]:
        return False
    T1, T2 = q.shape[2], k.shape[2]
    if T1 >= FLASH_GATE['min_len'] and T2 >= FLASH_GATE['min_len']:
        return True
    return (T1 >= 128 and T2 >= 128 and
            q.shape[0] * q.shape[1] * T1 * T2 >= FLASH_GATE['score_elems'])


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: Optional[torch.Tensor], scale: float,
                   dropout: Optional[nn.Module] = None,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax((q·kᵀ + bias)·scale, masked) · v with fp32 scores.

    q: (..., h, T1, d); k, v: (..., h, T2, d); mask: bool broadcastable
    to (..., 1|h, T1|1, T2), True == attend; bias: additive, added before
    the scale.  Fully masked rows give 0.  CUDA tensors above the gate
    with no active `dropout` run the flash kernels (with their backward
    when autograd records); everything else the plain path."""
    drop = dropout is not None and dropout.training and dropout.p > 0.0
    if not drop and flash_eligible(q, k):
        return flash_attention(q, k, v, mask, bias, scale)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if bias is not None:
        scores = scores + bias.float()
    scores = scores * scale
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    attn = torch.softmax(scores, dim=-1)
    if mask is not None:
        attn = attn.masked_fill(~mask, 0.0)
    if dropout is not None:
        attn = dropout(attn)
    return torch.matmul(attn.to(v.dtype), v)


class MultiHeadedAttention(nn.Module):
    """Multi-head attention; `linear_out` has a bias when `query_bias`
    does (whisper: no key bias).  lora_conf: {'lora_rank', 'lora_alpha',
    'lora_dropout', 'lora_list'} or None."""

    def __init__(self, n_head: int, n_feat: int, dropout_rate: float = 0.0,
                 query_bias: bool = True, key_bias: bool = True,
                 value_bias: bool = True, lora_conf: Optional[dict] = None):
        super().__init__()
        assert n_feat % n_head == 0
        self.h = n_head
        self.d_k = n_feat // n_head

        def linear(bias, key):
            return make_attention_linear(n_feat, n_feat, bias, key, lora_conf)
        self.linear_q = linear(query_bias, 'q')
        self.linear_k = linear(key_bias, 'k')
        self.linear_v = linear(value_bias, 'v')
        self.linear_out = linear(query_bias, 'o')
        self.dropout = nn.Dropout(dropout_rate)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, h*d) -> (B, h, T, d) view."""
        return x.view(x.shape[0], x.shape[1], self.h, self.d_k).transpose(1, 2)

    def project_q(self, x: torch.Tensor) -> torch.Tensor:
        return self._heads(self.linear_q(x))

    def project_kv(self, key: torch.Tensor, value: torch.Tensor) -> T_CACHE:
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

    def forward_self(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                     pos_emb: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     cache: Optional[T_CACHE] = None
                     ) -> Tuple[torch.Tensor, Optional[T_CACHE]]:
        """An encoder layer's self-attention over x (B, T, F), the call
        every `ATTENTION_CLASSES` entry shares: mask (B, T|1, T2) bool;
        `pos_emb` and `generator` are not read here (absolute positions
        are in x; attention dropout is `nn.Dropout`).  With `cache`, the
        cached (k, v) of (B, h, cache_t, d) go in front of this chunk's
        and come back with them; without, the new cache is None."""
        q = self.project_q(x)
        k, v = self.project_kv(x, x)
        if cache is not None:
            k = torch.cat([cache[0], k], dim=2)
            v = torch.cat([cache[1], v], dim=2)
        m = None if mask is None else mask.unsqueeze(1)
        ctx = attention_core(q, k, v, m, 1.0 / math.sqrt(self.d_k),
                             self.dropout)
        return self._finish(ctx), None if cache is None else (k, v)

    def decode_step(self, x_q: torch.Tensor, cache: T_CACHE,
                    step: int) -> torch.Tensor:
        """One decoder step.  x_q: (B, 1, F); cache: (k, v) buffers of
        (B, h, L_max, d), updated IN PLACE at position `step`, and the
        query attends positions <= step.  The JAX package masks the
        positions after `step` out of the full buffer; here they are not
        read at all, which gives the same weights."""
        q = self.project_q(x_q)
        k_new, v_new = self.project_kv(x_q, x_q)
        k_buf, v_buf = cache
        k_buf[:, :, step] = k_new[:, :, 0].to(k_buf.dtype)
        v_buf[:, :, step] = v_new[:, :, 0].to(v_buf.dtype)
        ctx = attention_core(q, k_buf[:, :, :step + 1],
                             v_buf[:, :, :step + 1], None,
                             1.0 / math.sqrt(self.d_k))
        return self._finish(ctx)


class MultiHeadedCrossAttention(MultiHeadedAttention):
    """Decoder-to-encoder attention.  Queries may be beam-expanded:
    (B*N, T1, F) against keys of (B, T2, F)."""

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor, mask: Optional[torch.Tensor] = None,
                cache: Optional[T_CACHE] = None) -> torch.Tensor:
        """mask: (B, 1|T1, T2) bool.  With `cache`, the precomputed
        encoder (k, v) (`project_kv` of the memory), key and value are not
        read.  Beam-expanded queries are folded into the query rows of
        their utterance, (B, h, N*T1, d), so each utterance's keys are
        read once for all its beams (a broadcast batch dim would make
        `torch.matmul` copy them N times)."""
        q = self.project_q(query)
        k, v = cache if cache is not None else self.project_kv(key, value)
        m = None if mask is None else mask.unsqueeze(1)
        Bq, Bk = q.shape[0], k.shape[0]
        scale = 1.0 / math.sqrt(self.d_k)
        if Bq == Bk:
            return self._finish(attention_core(q, k, v, m, scale,
                                               self.dropout))
        N = Bq // Bk
        _, H, T1, D = q.shape
        q = q.reshape(Bk, N, H, T1, D).transpose(1, 2).reshape(
            Bk, H, N * T1, D)
        if m is not None and m.shape[-2] != 1:
            m = m.repeat(1, 1, N, 1)  # rows n*T1 + t, as the queries
        ctx = attention_core(q, k, v, m, scale, self.dropout)
        ctx = ctx.reshape(Bk, H, N, T1, D).transpose(1, 2).reshape(
            Bq, H, T1, D)
        return self._finish(ctx)


class RelPositionMultiHeadedAttention(MultiHeadedAttention):
    """Transformer-XL relative-position MHA (no rel_shift), computed by
    the fused rel-pos attention kernels."""

    def __init__(self, n_head: int, n_feat: int, dropout_rate: float = 0.0,
                 lora_conf: Optional[dict] = None):
        super().__init__(n_head, n_feat, dropout_rate, lora_conf=lora_conf)
        self.linear_pos = nn.Linear(n_feat, n_feat, bias=False)
        self.pos_bias_u = nn.Parameter(torch.empty(n_head, self.d_k))
        self.pos_bias_v = nn.Parameter(torch.empty(n_head, self.d_k))

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor, mask: Optional[torch.Tensor],
                pos_emb: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                cache: Optional[T_CACHE] = None
                ) -> Tuple[torch.Tensor, Optional[T_CACHE]]:
        """mask: (B, T1|1, T2) bool; pos_emb: (1|B, T2, F) -> (out, new
        cache).

        In training with attention dropout, each call draws a uint32
        dropout seed from `generator` (a host generator, so no device
        sync; None takes torch's default CPU generator).

        With `cache`, a streaming chunk step: the cached (k, v), each
        (B, h, cache_t, d), go in front of this chunk's, so T2 = cache_t
        + T1 keys, and the new cache is (k, v) with the T2 keys; the
        caller keeps the window it wants.  Without, the new cache is
        None."""
        rate = self.dropout.p if self.training else 0.0
        seed = None
        if rate > 0.0:
            seed = int(torch.randint(0, 1 << 32, (), generator=generator))
        q = self.project_q(query)
        k, v = self.project_kv(key, value)
        if cache is not None:
            k = torch.cat([cache[0], k], dim=2)
            v = torch.cat([cache[1], v], dim=2)
        p = self._heads(self.linear_pos(pos_emb))  # (1|B, h, T2, d)
        u = self.pos_bias_u.to(q.dtype)[None, :, None, :]
        w = self.pos_bias_v.to(q.dtype)[None, :, None, :]
        ctx = flash_attention_relpos(q + u, q + w, k, p, v, mask,
                                     1.0 / math.sqrt(self.d_k), rate, seed)
        return self._finish(ctx), None if cache is None else (k, v)

    def forward_self(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                     pos_emb: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     cache: Optional[T_CACHE] = None
                     ) -> Tuple[torch.Tensor, Optional[T_CACHE]]:
        return self(x, x, x, mask, pos_emb, generator, cache)


# the encoder self-attentions a config may name
# (`selfattention_layer_type`); Shaw's and RoPE's are not ported
# (ROADMAP.md, queue 1 item 8)
ATTENTION_CLASSES = {'selfattn': MultiHeadedAttention,
                     'rel_selfattn': RelPositionMultiHeadedAttention}


def make_self_attention(kind: str, n_head: int, n_feat: int,
                        dropout_rate: float = 0.0,
                        lora_conf: Optional[dict] = None, **bias) -> nn.Module:
    """`ATTENTION_CLASSES[kind]`; `bias` (query_bias, key_bias,
    value_bias) goes to plain MHA only."""
    if kind not in ATTENTION_CLASSES:
        raise NotImplementedError(f'selfattention_layer_type={kind!r} is '
                                  'not ported (ROADMAP.md, queue 1 item 8)')
    if kind == 'selfattn':
        return MultiHeadedAttention(n_head, n_feat, dropout_rate,
                                    lora_conf=lora_conf, **bias)
    if not all(bias.values()):
        raise NotImplementedError('rel_selfattn without a q/k/v bias is not '
                                  'ported')
    return RelPositionMultiHeadedAttention(n_head, n_feat, dropout_rate,
                                           lora_conf)
