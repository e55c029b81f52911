"""Multi-head attention: plain MHA (with the decoder's incremental step),
cross attention, rel-pos MHA, Shaw's clipped relative keys and RoPE, each
with grouped or multi-query key/value heads (`n_kv_head`) and a head dim
of its own (`head_dim`).  Counterpart of
wenet_tpu/models/transformer/attention.py.

With `n_kv_head` < `n_head` (GQA; 1 is MQA) k and v have `n_kv_head`
heads, and so do the caches; they are repeated to `n_head` heads
(`repeat_kv`: query head i reads kv head i // n_rep) before the
attention core, as the JAX package repeats them, so the kernels see
`n_head` heads.

Rel-pos self-attention always goes through `flash_attention_relpos`: the
Hopper kernels for CUDA tensors, their plain versions for CPU tensors,
with the backward kernels behind autograd.  In training its
attention-weight dropout runs inside the kernels (a counter hash seeded
per call from the host generator the train step passes down), as the JAX
package's flash training path does.

`attention_core` (plain MHA and cross attention) goes through
`flash_attention` on CUDA tensors that pass the JAX package's gate
(`_flash_eligible`, attention.py:70-82: both lengths >= 512, or both >=
128 with B·h·T1·T2 >= 24M scores; `flash_gate`) when no attention
dropout is active and `torch.export` is not tracing:
K4 in inference; K4 with lse, then K5 and K6 in the backward, when
autograd records (whisper's encoder in training).  The kernels raise on a
dtype or head dim they have no instance for.  Active attention dropout,
shapes below the gate and CPU tensors take the plain
matmul-softmax-matmul path, with `nn.Dropout` on the weights, as the JAX
package sends every call with a dropout function to XLA
(attention.py:115).

The q/k/v/out projections are `LoRALinear` where a lora conf lists them
(`make_attention_linear`, the JAX `make_attention_dense`).  An encoder
with `gradient_checkpointing: 'selective'` sets `recompute_scores` on its
attention modules: in training the plain path then keeps no (T1, T2)
tensor and recomputes the weights in the backward (the JAX policy's
'attn_scores'); the flash kernels keep none anyway.
"""

import math
from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from wenet_tpu_torch.models.finetune.lora import make_attention_linear
from wenet_tpu_torch.parallel.mesh import rank_seed
from wenet_tpu_torch.ops.flash_attention import (NEG_INF, flash_attention,
                                                 flash_attention_relpos)

T_CACHE = Tuple[torch.Tensor, torch.Tensor]  # (k, v): (B, h_kv, T, d)

# the JAX package's inference gate for the flash kernel (`_FLASH`)
FLASH_GATE = {'min_len': 512, 'score_elems': 24 * 1024 * 1024}


def flash_gate(B, h, T1, T2) -> bool:
    """The gate's length rule: both lengths >= 512, or both >= 128 with
    B·h·T1·T2 >= 24M scores.  A symbolic length (a `torch.SymInt` while
    `torch.export` traces) fails it: a branch on it would become a guard
    of the exported program, and the JAX package's export never takes the
    flash path either (its `_FLASH` switch is on only in `AsrRunner` and
    bin/train.py, and `_flash_eligible` takes the TPU only,
    attention.py:70-75)."""
    if any(isinstance(n, torch.SymInt) for n in (B, h, T1, T2)):
        return False
    if T1 >= FLASH_GATE['min_len'] and T2 >= FLASH_GATE['min_len']:
        return True
    return T1 >= 128 and T2 >= 128 and \
        B * h * T1 * T2 >= FLASH_GATE['score_elems']


def flash_eligible(q: torch.Tensor, k: torch.Tensor) -> bool:
    """True where `attention_core` takes the flash kernels: CUDA
    (B, h, T, d) inputs whose lengths pass `flash_gate`, whatever their
    dtype and head dim, outside `torch.export` (an exported program is
    the plain path, as the JAX package's is, whatever its shapes)."""
    if q.device.type != 'cuda' or q.dim() != 4 or q.shape[1] != k.shape[1]:
        return False
    if torch.compiler.is_exporting():
        return False
    return flash_gate(q.shape[0], q.shape[1], q.shape[2], k.shape[2])


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, h_kv, T, d) -> (B, h_kv * n_rep, T, d), each head repeated
    n_rep times in place (`jnp.repeat(axis=1)`)."""
    return x if n_rep == 1 else x.repeat_interleave(n_rep, dim=1)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: Optional[torch.Tensor], scale: float,
                   dropout: Optional[nn.Module] = None,
                   bias: Optional[torch.Tensor] = None,
                   recompute: bool = False) -> torch.Tensor:
    """softmax((q·kᵀ + bias)·scale, masked) · v with fp32 scores.

    q: (..., h, T1, d); k, v: (..., h, T2, d); mask: bool broadcastable
    to (..., 1|h, T1|1, T2), True == attend; bias: additive, added before
    the scale.  Fully masked rows give 0.  CUDA tensors above the gate
    with no active `dropout` run the flash kernels (with their backward
    when autograd records); everything else the plain path.  `recompute`
    (`gradient_checkpointing: 'selective'`): where autograd records, the
    plain path keeps no (T1, T2) tensor for the backward and recomputes
    the scores, softmax and dropout there (the flash kernels keep none
    anyway)."""
    drop = dropout is not None and dropout.training and dropout.p > 0.0
    if not drop and flash_eligible(q, k):
        return flash_attention(q, k, v, mask, bias, scale)
    if recompute and torch.is_grad_enabled():
        return checkpoint(_plain_attention, q, k, v, mask, scale, dropout,
                          bias, use_reentrant=False)
    return _plain_attention(q, k, v, mask, scale, dropout, bias)


def _plain_attention(q, k, v, mask, scale, dropout, bias) -> torch.Tensor:
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
    does (whisper: no key bias).  q has n_head heads of d_k = head_dim (or
    n_feat // n_head), k and v n_kv_head (or n_head) heads.  lora_conf:
    {'lora_rank', 'lora_alpha', 'lora_dropout', 'lora_list'} or None."""

    def __init__(self, n_head: int, n_feat: int, dropout_rate: float = 0.0,
                 query_bias: bool = True, key_bias: bool = True,
                 value_bias: bool = True, lora_conf: Optional[dict] = None,
                 n_kv_head: Optional[int] = None,
                 head_dim: Optional[int] = None):
        super().__init__()
        self.h = n_head
        self.h_kv = n_head if n_kv_head is None else n_kv_head
        if self.h % self.h_kv:
            raise ValueError(f'n_kv_head {self.h_kv} does not divide '
                             f'{n_head} heads')
        self.d_k = n_feat // n_head if head_dim is None else head_dim
        inner, inner_kv = self.d_k * self.h, self.d_k * self.h_kv

        def linear(n_in, n_out, bias, key):
            return make_attention_linear(n_in, n_out, bias, key, lora_conf)
        self.linear_q = linear(n_feat, inner, query_bias, 'q')
        self.linear_k = linear(n_feat, inner_kv, key_bias, 'k')
        self.linear_v = linear(n_feat, inner_kv, value_bias, 'v')
        self.linear_out = linear(inner, n_feat, query_bias, 'o')
        self.dropout = nn.Dropout(dropout_rate)

    # set by an encoder with gradient_checkpointing 'selective'
    recompute_scores = False

    @property
    def n_rep(self) -> int:
        return self.h // self.h_kv

    def _heads(self, x: torch.Tensor, h: int) -> torch.Tensor:
        """(B, T, h*d) -> (B, h, T, d) view."""
        return x.view(x.shape[0], x.shape[1], h, self.d_k).transpose(1, 2)

    def project_q(self, x: torch.Tensor) -> torch.Tensor:
        return self._heads(self.linear_q(x), self.h)

    def project_kv(self, key: torch.Tensor, value: torch.Tensor) -> T_CACHE:
        """-> (k, v), each (B, h_kv, T, d)."""
        return (self._heads(self.linear_k(key), self.h_kv),
                self._heads(self.linear_v(value), self.h_kv))

    def _core(self, q, k, v, mask, bias=None, dropout=True):
        """attention_core over k and v repeated to the query heads; mask
        (B, T1|1, T2) bool or None."""
        m = None if mask is None else mask.unsqueeze(1)
        return attention_core(q, repeat_kv(k, self.n_rep),
                              repeat_kv(v, self.n_rep), m,
                              1.0 / math.sqrt(self.d_k),
                              self.dropout if dropout else None, bias,
                              self.recompute_scores and self.training)

    def _finish(self, ctx: torch.Tensor) -> torch.Tensor:
        B, _, T, _ = ctx.shape
        return self.linear_out(ctx.transpose(1, 2).reshape(B, T, -1))

    @staticmethod
    def _with_cache(k, v, cache: Optional[T_CACHE]):
        if cache is None:
            return k, v
        return (torch.cat([cache[0], k], dim=2),
                torch.cat([cache[1], v], dim=2))

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """mask: (B, T1|1, T2) bool."""
        q = self.project_q(query)
        k, v = self.project_kv(key, value)
        return self._finish(self._core(q, k, v, mask))

    def forward_self(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                     pos_emb: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     cache: Optional[T_CACHE] = None
                     ) -> Tuple[torch.Tensor, Optional[T_CACHE]]:
        """An encoder layer's self-attention over x (B, T, F), the call
        every `ATTENTION_CLASSES` entry shares: mask (B, T|1, T2) bool;
        `pos_emb` and `generator` are not read here (absolute positions
        are in x; attention dropout is `nn.Dropout`).  With `cache`, the
        cached (k, v) of (B, h_kv, cache_t, d) go in front of this chunk's
        and come back with them; without, the new cache is None."""
        q = self.project_q(x)
        k, v = self._with_cache(*self.project_kv(x, x), cache)
        return (self._finish(self._core(q, k, v, mask)),
                None if cache is None else (k, v))

    def decode_step(self, x_q: torch.Tensor, cache: T_CACHE,
                    step: int) -> torch.Tensor:
        """One decoder step.  x_q: (B, 1, F); cache: (k, v) buffers of
        (B, h_kv, L_max, d), updated IN PLACE at position `step`, and the
        query attends positions <= step.  The JAX package masks the
        positions after `step` out of the full buffer; here they are not
        read at all, which gives the same weights."""
        q = self.project_q(x_q)
        k_new, v_new = self.project_kv(x_q, x_q)
        k_buf, v_buf = cache
        k_buf[:, :, step] = k_new[:, :, 0].to(k_buf.dtype)
        v_buf[:, :, step] = v_new[:, :, 0].to(v_buf.dtype)
        return self._finish(self._core(q, k_buf[:, :, :step + 1],
                                       v_buf[:, :, :step + 1], None,
                                       dropout=False))


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
        Bq, Bk = q.shape[0], k.shape[0]
        if Bq == Bk:
            return self._finish(self._core(q, k, v, mask))
        N = Bq // Bk
        _, H, T1, D = q.shape
        q = q.reshape(Bk, N, H, T1, D).transpose(1, 2).reshape(
            Bk, H, N * T1, D)
        if mask is not None and mask.shape[-2] != 1:
            mask = mask.repeat(1, N, 1)  # rows n*T1 + t, as the queries
        ctx = self._core(q, k, v, mask)
        ctx = ctx.reshape(Bk, H, N, T1, D).transpose(1, 2).reshape(
            Bq, H, T1, D)
        return self._finish(ctx)


class RelPositionMultiHeadedAttention(MultiHeadedAttention):
    """Transformer-XL relative-position MHA (no rel_shift), computed by
    the fused rel-pos attention kernels."""

    def __init__(self, n_head: int, n_feat: int, dropout_rate: float = 0.0,
                 query_bias: bool = True, key_bias: bool = True,
                 value_bias: bool = True, lora_conf: Optional[dict] = None,
                 n_kv_head: Optional[int] = None,
                 head_dim: Optional[int] = None):
        super().__init__(n_head, n_feat, dropout_rate, query_bias, key_bias,
                         value_bias, lora_conf, n_kv_head, head_dim)
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
        sync; None takes torch's default CPU generator), the data rank's
        own in a data-parallel step (`rank_seed`).

        With `cache`, a streaming chunk step: the cached (k, v), each
        (B, h_kv, cache_t, d), go in front of this chunk's, so T2 =
        cache_t + T1 keys, and the new cache is (k, v) with the T2 keys;
        the caller keeps the window it wants.  Without, the new cache is
        None.  The kernels read k and v repeated to the query heads."""
        rate = self.dropout.p if self.training else 0.0
        seed = None
        if rate > 0.0:
            seed = rank_seed(int(torch.randint(0, 1 << 32, (),
                                               generator=generator)))
        q = self.project_q(query)
        k, v = self._with_cache(*self.project_kv(key, value), cache)
        p = self._heads(self.linear_pos(pos_emb), self.h)  # (1|B, h, T2, d)
        u = self.pos_bias_u.to(q.dtype)[None, :, None, :]
        w = self.pos_bias_v.to(q.dtype)[None, :, None, :]
        ctx = flash_attention_relpos(
            q + u, q + w, repeat_kv(k, self.n_rep), p,
            repeat_kv(v, self.n_rep), mask, 1.0 / math.sqrt(self.d_k), rate,
            seed)
        return self._finish(ctx), None if cache is None else (k, v)

    def forward_self(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                     pos_emb: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     cache: Optional[T_CACHE] = None
                     ) -> Tuple[torch.Tensor, Optional[T_CACHE]]:
        return self(x, x, x, mask, pos_emb, generator, cache)


class ShawRelPositionMultiHeadedAttention(MultiHeadedAttention):
    """Shaw's learned relative keys, clipped to [-max_left_rel_pos,
    max_right_rel_pos]: the bias q·rel_k of each query and key, in fp32,
    goes to `attention_core` as its pre-scale bias (a full (B, h, T1, T2)
    bias through K4 above the gate, and K5's dbias in training)."""

    max_left, max_right = 64, 8  # the JAX module's clip

    def __init__(self, n_head: int, n_feat: int, dropout_rate: float = 0.0,
                 query_bias: bool = True, key_bias: bool = True,
                 value_bias: bool = True, lora_conf: Optional[dict] = None,
                 n_kv_head: Optional[int] = None,
                 head_dim: Optional[int] = None):
        super().__init__(n_head, n_feat, dropout_rate, query_bias, key_bias,
                         value_bias, lora_conf, n_kv_head, head_dim)
        self.rel_k_embed = nn.Embedding(self.max_left + self.max_right + 1,
                                        self.d_k)

    def rel_bias(self, q: torch.Tensor, T2: int) -> torch.Tensor:
        """(B, h, T1, T2) fp32 q·rel_k: the T1 queries are the last T1 of
        the T2 keys' positions (a chunk step's keys are cache + chunk)."""
        T1 = q.shape[2]
        idx = torch.arange(T2, device=q.device)
        rel = (idx[None, :] - idx[T2 - T1:, None]).clamp(
            -self.max_left, self.max_right) + self.max_left  # (T1, T2)
        rel_k = self.rel_k_embed(rel)  # (T1, T2, d)
        return torch.einsum('bhld,lrd->bhlr', q.float(),
                            rel_k.float()).contiguous()

    def forward_self(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                     pos_emb: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     cache: Optional[T_CACHE] = None
                     ) -> Tuple[torch.Tensor, Optional[T_CACHE]]:
        q = self.project_q(x)
        k, v = self._with_cache(*self.project_kv(x, x), cache)
        ctx = self._core(q, k, v, mask, self.rel_bias(q, k.shape[2]))
        return self._finish(ctx), None if cache is None else (k, v)


def apply_rotary_emb(x: torch.Tensor, ang: torch.Tensor,
                     style: str = 'google') -> torch.Tensor:
    """Rotate x (B, T, h, d) by the angles ang (1|B, T, d/2), in fp32:
    'google' pairs the halves (i, i + d/2), 'llama' the neighbours
    (2i, 2i + 1)."""
    cos = torch.cos(ang.float())[..., None, :]
    sin = torch.sin(ang.float())[..., None, :]
    xf = x.float()
    if style == 'google':
        a, b = xf.chunk(2, dim=-1)
        out = torch.cat([a * cos - b * sin, a * sin + b * cos], dim=-1)
    else:
        a, b = xf[..., 0::2], xf[..., 1::2]
        out = torch.stack([a * cos - b * sin, a * sin + b * cos],
                          dim=-1).reshape(xf.shape)
    return out.to(x.dtype)


class RopeMultiHeadedAttention(MultiHeadedAttention):
    """MHA over rotated q and k (RoPE, the JAX module's 'google' pairs).
    pos_emb holds the angles of the keys' positions; the new tokens (the
    last T of them) are rotated, the cached keys were rotated when they
    were new."""

    def forward_self(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                     pos_emb: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     cache: Optional[T_CACHE] = None
                     ) -> Tuple[torch.Tensor, Optional[T_CACHE]]:
        """pos_emb: RoPE angles (1|B, T2, d/2)."""
        B, T = x.shape[0], x.shape[1]
        ang = pos_emb[:, pos_emb.shape[1] - T:]
        q = apply_rotary_emb(self.linear_q(x).view(B, T, self.h, self.d_k),
                             ang).transpose(1, 2)
        k = apply_rotary_emb(
            self.linear_k(x).view(B, T, self.h_kv, self.d_k),
            ang).transpose(1, 2)
        v = self._heads(self.linear_v(x), self.h_kv)
        k, v = self._with_cache(k, v, cache)
        return (self._finish(self._core(q, k, v, mask)),
                None if cache is None else (k, v))


# the encoder self-attentions a config may name (`selfattention_layer_type`)
ATTENTION_CLASSES = {'selfattn': MultiHeadedAttention,
                     'rel_selfattn': RelPositionMultiHeadedAttention,
                     'shaw_rel_selfattn': ShawRelPositionMultiHeadedAttention,
                     'rope_abs_selfattn': RopeMultiHeadedAttention}


def make_self_attention(kind: str, n_head: int, n_feat: int,
                        dropout_rate: float = 0.0,
                        lora_conf: Optional[dict] = None,
                        n_kv_head: Optional[int] = None,
                        head_dim: Optional[int] = None,
                        **bias) -> nn.Module:
    """`ATTENTION_CLASSES[kind]`; `bias`: query_bias, key_bias,
    value_bias."""
    if kind not in ATTENTION_CLASSES:
        raise ValueError(f'unknown selfattention_layer_type {kind!r}')
    return ATTENTION_CLASSES[kind](n_head, n_feat, dropout_rate,
                                   lora_conf=lora_conf, n_kv_head=n_kv_head,
                                   head_dim=head_dim, **bias)
