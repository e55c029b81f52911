"""The encoder trunk shared by the encoder zoo, and the conformer and
transformer encoders.  Counterpart of
wenet_tpu/models/transformer/encoder.py: `BaseEncoder` (front end and
position encoding, the pad and chunk masks, the full-sequence forward,
the streaming chunk step `forward_chunk` with fixed-size caches,
`zero_cache`), `ConformerEncoder` and `TransformerEncoder`, with the
JAX encoders' options: the attention, position, norm and FFN types,
`n_kv_head` / `head_dim`, pre- or post-norm, `static_chunk_size`,
`cmvn_norm_var`, `final_norm`, and a full-context forward
(`full_context`, the CTL model's).  `lora_conf` makes the attention
projections LoRA layers, as the JAX encoders' field does, and
`gradient_checkpointing` (true: each layer recomputed in the backward;
'selective': only the plain attention's weights) trades memory for
compute and changes no result, as the JAX encoders' remat does.

Every layer of a `BaseEncoder` is called as
`layer(x, mask, pos_emb, mask_pad, generator, att_cache, cnn_cache)` and
returns (x, new att cache, new cnn cache); a cache not passed comes back
as None."""

from typing import List, Optional, Tuple, Union

import torch
from torch import nn

from wenet_tpu_torch.models.transformer.attention import MultiHeadedAttention
from wenet_tpu_torch.models.transformer.cmvn import GlobalCMVN
from wenet_tpu_torch.models.transformer.embedding import make_pos_enc
from wenet_tpu_torch.models.transformer.encoder_layer import (
    ConformerEncoderLayer, TransformerEncoderLayer,
    layer_options as layer_options_of)
from wenet_tpu_torch.models.transformer.norm import get_norm
from wenet_tpu_torch.models.transformer.recompute import recompute
from wenet_tpu_torch.models.transformer.subsampling import make_subsampling
from wenet_tpu_torch.utils.mask import (add_optional_chunk_mask,
                                        make_pad_mask)


class BaseEncoder(nn.Module):
    """Front end (optional global cmvn, subsampling with its position
    encoding), the layers a subclass puts in `self.encoders`, and a final
    norm (`layer_norm_type`; none when post-norm or without
    `final_norm`, as the JAX encoder has none then).  `layer_options`:
    the layers' options (`LAYER_OPTIONS`), which a subclass passes on to
    each layer as `self.layer_options`."""

    def __init__(self, input_size: int, output_size: int = 256,
                 attention_heads: int = 4, dropout_rate: float = 0.1,
                 positional_dropout_rate: float = 0.1,
                 input_layer: str = 'conv2d',
                 pos_enc_layer_type: str = 'abs_pos',
                 use_dynamic_chunk: bool = False,
                 use_dynamic_left_chunk: bool = False,
                 static_chunk_size: int = 0, use_cmvn: bool = False,
                 norm_eps: float = 1e-5, cmvn_norm_var: bool = True,
                 final_norm: bool = True,
                 gradient_checkpointing: Union[bool, str] = False,
                 **layer_options):
        super().__init__()
        self.gradient_checkpointing = gradient_checkpointing
        self.layer_options = options = layer_options_of(layer_options)
        self._output_size = output_size
        self.attention_heads = attention_heads
        self.n_kv_head = options['n_kv_head']
        self.d_k = (output_size // attention_heads
                    if options['head_dim'] is None else options['head_dim'])
        self.use_dynamic_chunk = use_dynamic_chunk
        self.use_dynamic_left_chunk = use_dynamic_left_chunk
        self.static_chunk_size = static_chunk_size
        self.global_cmvn = (GlobalCMVN(input_size, cmvn_norm_var)
                            if use_cmvn else None)
        pos_enc = make_pos_enc(pos_enc_layer_type, output_size,
                               positional_dropout_rate, attention_heads)
        self._fp32_pos = getattr(pos_enc, 'fp32_angles', False)
        self.embed = make_subsampling(input_layer, input_size, output_size,
                                      dropout_rate, pos_enc)
        self.after_norm = (get_norm(options['layer_norm_type'], output_size,
                                    norm_eps)
                           if options['normalize_before'] and final_norm
                           else None)
        self.encoders = nn.ModuleList()

    def _recompute_scores(self) -> None:
        """`gradient_checkpointing: 'selective'`: the layers' plain
        attention recomputes its (T1, T2) weights in the backward (the
        JAX policy's 'attn_scores', attention.py:126-133); call once the
        layers are built."""
        if self.gradient_checkpointing == 'selective':
            for m in self.encoders.modules():
                if isinstance(m, MultiHeadedAttention):
                    m.recompute_scores = True

    def _final(self, xs: torch.Tensor) -> torch.Tensor:
        return xs if self.after_norm is None else self.after_norm(xs)

    def output_size(self) -> int:
        return self._output_size

    @property
    def subsampling_rate(self) -> int:
        return self.embed.subsampling_rate

    @property
    def right_context(self) -> int:
        return self.embed.right_context

    # base-resolution frames per output frame of a chunk step (the
    # efficient conformer downsamples inside the trunk)
    output_downsampling_factor = 1

    @property
    def cnn_lorder(self) -> int:
        """Left context of each layer's causal conv: the frames its cnn
        cache holds (0: no cache)."""
        return 0

    @property
    def cnn_cache_channels(self) -> int:
        return self._output_size

    def embed_input(self, xs: torch.Tensor, xs_lens: torch.Tensor):
        """cmvn + subsampling -> (xs (B, T', D), pos_emb, masks (B, 1, T'))."""
        masks = ~make_pad_mask(xs_lens, xs.shape[1])[:, None, :]
        if self.global_cmvn is not None:
            xs = self.global_cmvn(xs)
        return self.embed(xs, masks)

    def forward(self, xs: torch.Tensor, xs_lens: torch.Tensor,
                decoding_chunk_size: int = 0,
                num_decoding_left_chunks: int = -1,
                generator: Optional[torch.Generator] = None,
                dynamic_chunk: Optional[Tuple[int, int]] = None,
                full_context: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """xs: (B, T, F) features; xs_lens: (B,) -> (xs (B, T', D),
        masks (B, 1, T') bool valid).

        Training passes its host `generator`: the dynamic-chunk draw
        (once per forward) and the attention-dropout seeds come from it;
        with `gradient_checkpointing` true each layer's activations are
        recomputed in the backward (`recompute`), with 'selective' only
        the plain attention's weights (`attention_core`);
        `dynamic_chunk` = (chunk_size, num_left_chunks) replaces the draw;
        the drawn chunk is at most 100 // subsampling_rate frames, as in
        the JAX package.  `full_context` attends every valid frame,
        whatever the dynamic or static chunk (the reference's
        Dual*Encoder.forward_full)."""
        xs, pos_emb, masks = self.embed_input(xs, xs_lens)
        if full_context:
            chunk_masks = masks & masks.transpose(1, 2)
        else:
            chunk_masks = add_optional_chunk_mask(
                masks, self.use_dynamic_chunk, self.use_dynamic_left_chunk,
                decoding_chunk_size, num_decoding_left_chunks, generator,
                dynamic_chunk, 100 // self.subsampling_rate,
                self.static_chunk_size)
        whole = self.gradient_checkpointing not in (False, 'selective')
        for layer in self.encoders:
            args = (xs, chunk_masks, pos_emb, masks, generator)
            xs, _, _ = (recompute(layer, args, generator) if whole
                        else layer(*args))
        return self._final(xs), masks

    def forward_chunk(self, xs: torch.Tensor,
                      offset: Union[int, torch.Tensor],
                      att_cache: Tuple[torch.Tensor, torch.Tensor],
                      cnn_cache: Optional[torch.Tensor],
                      att_mask: Optional[torch.Tensor] = None):
        """One streaming chunk step with fixed-size, right-aligned caches.

        xs: (B, time, F) features of the chunk, time = (chunk - 1) *
        subsampling_rate + right_context + 1; offset: the position of the
        chunk's first output frame, an int for every row or a (B,) integer
        tensor on the device with one per row (a batch of streams, each at
        its own point: the rel-pos encoding and K1's p are then per row,
        (B, h, cache_t1 + chunk, d_k); RoPE's angles are per row too);
        att_cache: (k, v), each (num_blocks, B, h_kv, cache_t1, d_k),
        whose leading slots `att_mask` marks
        invalid until the cache fills; cnn_cache: (num_blocks, B, lorder,
        cnn_cache_channels) or None; att_mask: (B, 1, cache_t1 + chunk)
        bool, the valid cache slots followed by the chunk's valid frames
        (fewer than the chunk in a zero-padded tail).  Every rel-pos block
        attends the cache_t1 + chunk keys through K1 on the card.

        Returns (ys (B, chunk, D), new att_cache, new cnn_cache), with the
        shapes of the caches given: each keeps the last cache_t1 keys."""
        B = xs.shape[0]
        ones = torch.ones(B, 1, xs.shape[1], dtype=torch.bool,
                          device=xs.device)
        if self.global_cmvn is not None:
            xs = self.global_cmvn(xs)
        xs, _, _ = self.embed(xs, ones, offset)
        k_cache, v_cache = att_cache
        cache_t1 = k_cache.shape[-2]
        # the keys' positions run from offset - cache_t1 (negative before
        # the cache fills: those slots are masked and read position 0)
        pos_emb = self.embed.position_encoding(
            offset - cache_t1, cache_t1 + xs.shape[1], xs.device)
        if not self._fp32_pos:
            pos_emb = pos_emb.to(xs.dtype)
        mask_pad = att_mask[:, :, cache_t1:] if att_mask is not None else None
        new_k: List[torch.Tensor] = []
        new_v: List[torch.Tensor] = []
        new_cnn: List[torch.Tensor] = []
        for i, layer in enumerate(self.encoders):
            xs, (k, v), cnn = layer(
                xs, att_mask, pos_emb, mask_pad,
                att_cache=(k_cache[i], v_cache[i]),
                cnn_cache=None if cnn_cache is None else cnn_cache[i])
            new_k.append(k[:, :, k.shape[2] - cache_t1:])
            new_v.append(v[:, :, v.shape[2] - cache_t1:])
            new_cnn.append(cnn)
        xs = self._final(xs)
        return (xs, (torch.stack(new_k), torch.stack(new_v)),
                None if cnn_cache is None else torch.stack(new_cnn))

    def zero_cache(self, batch_size: int, required_cache_size: int,
                   dtype=torch.float32, device=None):
        """The caches before the first chunk: ((k, v), cnn), k and v of
        (num_blocks, B, h_kv, required_cache_size, d_k), all slots
        invalid, and `zero_cnn_cache`."""
        h_kv = self.n_kv_head or self.attention_heads
        k = torch.zeros(len(self.encoders), batch_size, h_kv,
                        required_cache_size, self.d_k, dtype=dtype,
                        device=device)
        return (k, k), self.zero_cnn_cache(batch_size, dtype, device)

    def zero_cnn_cache(self, batch_size: int, dtype=torch.float32,
                       device=None) -> Optional[torch.Tensor]:
        """(num_blocks, B, cnn_lorder, cnn_cache_channels) zeros, or None
        where no layer has a causal conv (no left context to carry)."""
        if not self.cnn_lorder:
            return None
        return torch.zeros(len(self.encoders), batch_size, self.cnn_lorder,
                           self.cnn_cache_channels, dtype=dtype,
                           device=device)


class ConformerEncoder(BaseEncoder):
    """Conformer blocks: rel-pos attention unless the config names
    another (with its position encoding), conv2d x4 subsampling unless
    it names another front end (openasr's conv2d6); the JAX encoder's
    `activation_type`, `macaron_style`, `use_cnn_module` (no conv module:
    no cnn cache), `conv_bias` and `conv_inner_factor`."""

    def __init__(self, input_size: int, output_size: int = 256,
                 attention_heads: int = 4, linear_units: int = 2048,
                 num_blocks: int = 6, dropout_rate: float = 0.1,
                 positional_dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0,
                 input_layer: str = 'conv2d',
                 pos_enc_layer_type: str = 'rel_pos',
                 selfattention_layer_type: str = 'rel_selfattn',
                 use_dynamic_chunk: bool = False,
                 use_dynamic_left_chunk: bool = False,
                 static_chunk_size: int = 0, use_cmvn: bool = False,
                 cmvn_norm_var: bool = True, norm_eps: float = 1e-5,
                 cnn_module_kernel: int = 15, causal: bool = False,
                 cnn_module_norm: str = 'batch_norm',
                 conv_norm_eps: float = 1e-5, final_norm: bool = True,
                 activation_type: str = 'swish', macaron_style: bool = True,
                 use_cnn_module: bool = True, conv_bias: bool = True,
                 conv_inner_factor: int = 2,
                 lora_conf: Optional[dict] = None,
                 gradient_checkpointing: Union[bool, str] = False,
                 **layer_options):
        super().__init__(input_size, output_size, attention_heads,
                         dropout_rate, positional_dropout_rate, input_layer,
                         pos_enc_layer_type, use_dynamic_chunk,
                         use_dynamic_left_chunk, static_chunk_size, use_cmvn,
                         norm_eps, cmvn_norm_var, final_norm,
                         gradient_checkpointing, **layer_options)
        self._lorder = (cnn_module_kernel - 1
                        if causal and use_cnn_module else 0)
        self.encoders.extend(
            ConformerEncoderLayer(
                output_size, attention_heads, linear_units, dropout_rate,
                attention_dropout_rate, norm_eps, cnn_module_kernel, causal,
                cnn_module_norm, conv_norm_eps, lora_conf,
                selfattention_layer_type, activation_type, macaron_style,
                use_cnn_module, conv_bias, conv_inner_factor,
                **self.layer_options)
            for _ in range(num_blocks))
        self._recompute_scores()

    @property
    def cnn_lorder(self) -> int:
        return self._lorder


class TransformerEncoder(BaseEncoder):
    """Transformer blocks with a final norm: whisper's encoder (the
    `conv1d2` front end and `abs_pos_whisper` encoding), the conv2d
    transformers of aishell and timit (`conv2d`, `abs_pos`), and the RoPE
    and Shaw transformers; plain, Shaw and RoPE self-attention go through
    `attention_core` (K4 above the gate on the card)."""

    def __init__(self, input_size: int, output_size: int = 256,
                 attention_heads: int = 4, linear_units: int = 2048,
                 num_blocks: int = 6, dropout_rate: float = 0.1,
                 positional_dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0,
                 input_layer: str = 'conv2d',
                 pos_enc_layer_type: str = 'abs_pos',
                 selfattention_layer_type: str = 'selfattn',
                 use_dynamic_chunk: bool = False,
                 use_dynamic_left_chunk: bool = False,
                 static_chunk_size: int = 0, use_cmvn: bool = False,
                 cmvn_norm_var: bool = True, norm_eps: float = 1e-5,
                 activation_type: str = 'relu', final_norm: bool = True,
                 lora_conf: Optional[dict] = None,
                 gradient_checkpointing: Union[bool, str] = False,
                 **layer_options):
        super().__init__(input_size, output_size, attention_heads,
                         dropout_rate, positional_dropout_rate, input_layer,
                         pos_enc_layer_type, use_dynamic_chunk,
                         use_dynamic_left_chunk, static_chunk_size, use_cmvn,
                         norm_eps, cmvn_norm_var, final_norm,
                         gradient_checkpointing, **layer_options)
        self.encoders.extend(
            TransformerEncoderLayer(
                output_size, attention_heads, linear_units, dropout_rate,
                attention_dropout_rate, norm_eps, activation_type,
                lora_conf=lora_conf,
                selfattention_layer_type=selfattention_layer_type,
                **self.layer_options)
            for _ in range(num_blocks))
        self._recompute_scores()
