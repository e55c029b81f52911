"""Config-driven model construction.  Counterpart of the `asr_model` and
`whisper` entries of wenet_tpu/utils/init_model.py: an encoder of the
zoo (conformer, transformer, branchformer, E-Branchformer, Squeezeformer,
efficient conformer), a (bi)transformer decoder and a CTC head, from the
same train.yaml schema (the efficient conformer's `efficient_conf`
section merged into its encoder_conf, as the JAX package does), with
LoRA attention projections when `lora_conf.use_lora` is set (the
conformer's and transformer's encoder always, the decoder's with
`lora_decoder`).

`gradient_checkpointing` (activation recomputation, which trades memory
and changes no result) and `use_sdpa` are accepted and ignored.  Options
this package implements at one value only (the value every example
config uses) must have that value; any other option raises
NotImplementedError."""

import inspect
import math
from typing import Optional

import torch
from torch import nn

from wenet_tpu_torch.models.finetune.lora import LoRALinear
from wenet_tpu_torch.models.transformer.asr_model import ASRModel
from wenet_tpu_torch.models.transformer.cmvn import GlobalCMVN
from wenet_tpu_torch.models.transformer.ctc import CTC
from wenet_tpu_torch.models.transformer.decoder import (BiTransformerDecoder,
                                                        TransformerDecoder,
                                                        _OutputBias)
from wenet_tpu_torch.models.transformer.embedding import (
    LearnablePositionalEncoding)
from wenet_tpu_torch.models.branchformer.encoder import BranchformerEncoder
from wenet_tpu_torch.models.e_branchformer.encoder import EBranchformerEncoder
from wenet_tpu_torch.models.efficient_conformer.encoder import (
    EfficientConformerEncoder)
from wenet_tpu_torch.models.squeezeformer.encoder import SqueezeformerEncoder
from wenet_tpu_torch.models.transformer.encoder import (ConformerEncoder,
                                                        TransformerEncoder)
from wenet_tpu_torch.models.whisper.convert import default_special_tokens
from wenet_tpu_torch.models.whisper.whisper import Whisper

ENCODER_CLASSES = {
    'conformer': ConformerEncoder,
    'transformer': TransformerEncoder,
    'branchformer': BranchformerEncoder,
    'e_branchformer': EBranchformerEncoder,
    'squeezeformer': SqueezeformerEncoder,
    'efficientConformer': EfficientConformerEncoder,
    # the reference's aliases (ctl_model's encoders, built here as the
    # plain ones for an asr_model)
    'dual_transformer': TransformerEncoder,
    'dual_conformer': ConformerEncoder,
}
ENCODER_TYPE_OF = {'dual_transformer': 'transformer',
                   'dual_conformer': 'conformer'}
DECODER_CLASSES = {'transformer': TransformerDecoder,
                   'bitransformer': BiTransformerDecoder}
MODEL_CLASSES = {'asr_model': ASRModel, 'whisper': Whisper}
# the ROADMAP.md queue 1 item of each model family not ported (item 8,
# the rest of the encoder zoo, for any other name)
UNPORTED_ITEM = {'paraformer': 9, 'sanm_encoder': 9,
                 'sanm_encoder_with_tp': 9, 'sensevoice_small': 9,
                 'firered': 9, 'firered_conformer': 9, 'transducer': 10,
                 'k2_model': 11, 'bestrq_model': 11, 'w2vbert_model': 11,
                 'wav2vec2_model': 11}
# accepted and ignored (remat is not ported; it changes no result)
_IGNORED = {'gradient_checkpointing', 'use_sdpa'}
# options each encoder implements at one value only (the value every
# example config uses): another value raises
_FIXED_ALL = {'cmvn_norm_var': True, 'static_chunk_size': 0,
              'layer_norm_type': 'layer_norm', 'final_norm': True,
              'normalize_before': True, 'query_bias': True,
              'key_bias': True, 'value_bias': True, 'mlp_bias': True,
              'mlp_type': 'position_wise_feed_forward'}
_CONFORMER_FIXED = {'pos_enc_layer_type': 'rel_pos',
                    'selfattention_layer_type': 'rel_selfattn',
                    'activation_type': 'swish', 'macaron_style': True,
                    'use_cnn_module': True, 'conv_bias': True,
                    'conv_inner_factor': 2}
_ENCODER_FIXED_BY_TYPE = {
    'conformer': _CONFORMER_FIXED,
    'transformer': {},
    'branchformer': {},
    'e_branchformer': {'stochastic_depth_rate': 0.0},
    'efficientConformer': {'pos_enc_layer_type': 'rel_pos',
                           'use_cnn_module': True},
    'squeezeformer': {'pos_enc_layer_type': 'rel_pos',
                      'time_reduction_layer_type': 'conv1d',
                      'concat_after': False},
}
_DECODER_FIXED = {'normalize_before': True, 'use_output_layer': True,
                  'src_attention': True}


def _params(fn) -> set:
    """The constructor's options a config section may set (the LoRA
    settings come from `lora_conf`, not from a section)."""
    return set(inspect.signature(fn).parameters) - {'lora_conf'}


def _conf(conf: dict, accepted: set, what: str, fixed=None) -> dict:
    """The options of `conf` that the constructor takes (`accepted`);
    ignored options and options at their `fixed` value are dropped,
    anything else raises."""
    fixed = fixed or {}
    out = {}
    for key, value in conf.items():
        if key in accepted:
            out[key] = value
        elif not (key in _IGNORED or key in fixed and fixed[key] == value):
            raise NotImplementedError(f'{what} option {key}={value!r} is '
                                      'not ported (ROADMAP.md, queue 1 '
                                      'item 8)')
    return out


def lora_conf_of(configs: dict) -> Optional[dict]:
    """The LoRA settings of `configs['lora_conf']` with the JAX package's
    defaults (rank 8, alpha 8, dropout 0, list o/q/k/v), or None when
    `use_lora` is not set."""
    lc = configs.get('lora_conf') or {}
    if not lc.get('use_lora', False):
        return None
    return {'lora_rank': lc.get('lora_rank', 8),
            'lora_alpha': lc.get('lora_alpha', 8),
            'lora_dropout': lc.get('lora_dropout', 0.0),
            'lora_list': tuple(lc.get('lora_list', ['o', 'q', 'k', 'v']))}


def init_model(configs: dict, generator: Optional[torch.Generator] = None,
               device='cuda') -> ASRModel:
    """Build the model from a wenet-style config (with `input_dim` and
    `output_dim` set) on `device` (the card unless the caller asks for
    'cpu'), weights drawn from `generator` (a generator of that device).
    device='meta' builds the shapes only, with no storage and no weights
    drawn.

    Load trained or converted weights with `load_state_dict`; set the
    cmvn buffers (`encoder.global_cmvn.mean` / `istd`) from the stats."""
    encoder_type = configs.get('encoder', 'conformer')
    model_type = configs.get('model', 'asr_model')
    for key, value, ported in (('model', model_type, MODEL_CLASSES),
                               ('encoder', encoder_type, ENCODER_CLASSES),
                               ('ctc', configs.get('ctc', 'ctc'), ('ctc',))):
        if value not in ported:
            item = UNPORTED_ITEM.get(value, 8)
            raise NotImplementedError(f'{key}={value!r} is not ported '
                                      f'(ROADMAP.md, queue 1 item {item})')
    lora_conf = lora_conf_of(configs)
    dec_lora = (lora_conf if (configs.get('lora_conf') or {}).get(
        'lora_decoder', False) else None)
    enc_cls = ENCODER_CLASSES[encoder_type]
    vocab_size = configs['output_dim']
    decoder_type = configs.get('decoder', 'bitransformer')
    if decoder_type not in DECODER_CLASSES:
        raise NotImplementedError(f'decoder={decoder_type!r} is not ported')
    dec_cls = DECODER_CLASSES[decoder_type]
    dec_params = _params(TransformerDecoder.__init__)
    if dec_cls is BiTransformerDecoder:
        dec_params.add('r_num_blocks')
    dec_conf = _conf(configs.get('decoder_conf', {}), dec_params, 'decoder',
                     _DECODER_FIXED)

    special_tokens = configs.get('tokenizer_conf', {}).get('special_tokens')
    if special_tokens is None and model_type == 'whisper':
        special_tokens = default_special_tokens(vocab_size)

    enc_conf = dict(configs['encoder_conf'])
    enc_conf.update(enc_conf.pop('efficient_conf', None) or {})
    enc_params = inspect.signature(enc_cls.__init__).parameters
    enc_kw = {'lora_conf': lora_conf} if 'lora_conf' in enc_params else {}
    if lora_conf is not None and not enc_kw:
        raise NotImplementedError(f'LoRA on the {encoder_type} encoder is '
                                  'not ported')
    fixed = dict(_FIXED_ALL, **_ENCODER_FIXED_BY_TYPE[
        ENCODER_TYPE_OF.get(encoder_type, encoder_type)])
    with torch.device('meta'):
        encoder = enc_cls(
            configs['input_dim'],
            use_cmvn=configs.get('cmvn') == 'global_cmvn', **enc_kw,
            **_conf(enc_conf, _params(enc_cls.__init__), 'encoder', fixed))
        decoder = dec_cls(vocab_size, encoder.output_size(),
                          lora_conf=dec_lora, **dec_conf)
        ctc = CTC(vocab_size, encoder.output_size(),
                  configs.get('ctc_conf', {}).get('ctc_blank_id', 0))
        model = MODEL_CLASSES[model_type](
            vocab_size, encoder, decoder, ctc,
            special_tokens=special_tokens,
            **_conf(configs.get('model_conf', {}),
                    _params(ASRModel.__init__), 'model'))
    if torch.device(device).type != 'meta':
        model.to_empty(device=device)
        init_weights(model, generator)
    return model


def init_weights(model: nn.Module,
                 generator: Optional[torch.Generator] = None) -> None:
    """Fill every parameter and buffer: fan-in uniform for Linear/Conv,
    N(0, 1) embeddings, N(0, 0.02) learnable positions, zero tied-output
    biases, Xavier-uniform rel-pos biases, identity norms and cmvn; LoRA
    lora_A kaiming-uniform (fan-in uniform, torch's `a=sqrt(5)`) and
    lora_B zero, so a fresh LoRA layer adds nothing.  Raises if a tensor
    is left unset."""
    done = set()

    def fill(t, fn):
        with torch.no_grad():
            fn(t)
        done.add(id(t))

    def uniform(bound):
        return lambda t: t.uniform_(-bound, bound, generator=generator)

    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            fill(m.weight, uniform(bound))
            if m.bias is not None:
                fill(m.bias, uniform(bound))
            if isinstance(m, LoRALinear):
                fill(m.lora_A, uniform(1.0 / math.sqrt(m.lora_A.shape[1])))
                fill(m.lora_B, nn.init.zeros_)
        elif isinstance(m, nn.Embedding):
            fill(m.weight, lambda t: t.normal_(generator=generator))
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm1d)):
            fill(m.weight, nn.init.ones_)
            fill(m.bias, nn.init.zeros_)
            if isinstance(m, nn.BatchNorm1d):
                fill(m.running_mean, nn.init.zeros_)
                fill(m.running_var, nn.init.ones_)
                fill(m.num_batches_tracked, nn.init.zeros_)
        elif isinstance(m, GlobalCMVN):
            fill(m.mean, nn.init.zeros_)
            fill(m.istd, nn.init.ones_)
        elif isinstance(m, LearnablePositionalEncoding):
            fill(m.pe, lambda t: t.normal_(0.0, 0.02, generator=generator))
        elif isinstance(m, _OutputBias):
            fill(m.bias, nn.init.zeros_)
        if isinstance(getattr(m, 'pos_bias_u', None), nn.Parameter):
            # the rel-pos attentions' (h, d) biases, (h, d·g) grouped
            h, d = m.pos_bias_u.shape
            for t in (m.pos_bias_u, m.pos_bias_v):
                fill(t, uniform(math.sqrt(6.0 / (h + d))))
        if isinstance(getattr(m, 'ada_scale', None), nn.Parameter):
            fill(m.ada_scale, nn.init.ones_)  # Squeezeformer's
            fill(m.ada_bias, nn.init.zeros_)
    missed = [n for n, t in list(model.named_parameters()) +
              list(model.named_buffers()) if id(t) not in done]
    if missed:
        raise RuntimeError(f'init_weights left tensors unset: {missed[:5]}')
