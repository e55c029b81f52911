"""Config-driven model construction.  Counterpart of the `asr_model`
entry of wenet_tpu/utils/init_model.py: a conformer encoder, a
(bi)transformer decoder and a CTC head, from the same train.yaml schema.

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

from wenet_tpu_torch.models.transformer.asr_model import ASRModel
from wenet_tpu_torch.models.transformer.attention import (
    RelPositionMultiHeadedAttention)
from wenet_tpu_torch.models.transformer.cmvn import GlobalCMVN
from wenet_tpu_torch.models.transformer.ctc import CTC
from wenet_tpu_torch.models.transformer.decoder import (BiTransformerDecoder,
                                                        TransformerDecoder)
from wenet_tpu_torch.models.transformer.encoder import ConformerEncoder

DECODER_CLASSES = {'transformer': TransformerDecoder,
                   'bitransformer': BiTransformerDecoder}
# accepted and ignored (remat is not ported; it changes no result)
_IGNORED = {'gradient_checkpointing', 'use_sdpa'}
_ENCODER_FIXED = {'input_layer': 'conv2d', 'pos_enc_layer_type': 'rel_pos',
                  'selfattention_layer_type': 'rel_selfattn',
                  'activation_type': 'swish', 'normalize_before': True,
                  'macaron_style': True, 'use_cnn_module': True,
                  'final_norm': True, 'static_chunk_size': 0,
                  'cmvn_norm_var': True}
_DECODER_FIXED = {'input_layer': 'embed', 'activation_type': 'relu',
                  'normalize_before': True}


def _params(fn) -> set:
    return set(inspect.signature(fn).parameters)


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
                                      'not ported')
    return out


def init_model(configs: dict,
               generator: Optional[torch.Generator] = None) -> ASRModel:
    """Build the model on the CPU from a wenet-style config (with
    `input_dim` and `output_dim` set), weights drawn from `generator`.

    Load trained or converted weights with `load_state_dict`; set the
    cmvn buffers (`encoder.global_cmvn.mean` / `istd`) from the stats."""
    for key, ported in (('encoder', 'conformer'), ('ctc', 'ctc'),
                        ('model', 'asr_model')):
        if configs.get(key, ported) != ported:
            raise NotImplementedError(f'{key}={configs[key]!r} is not ported')
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

    with torch.device('meta'):
        encoder = ConformerEncoder(
            configs['input_dim'],
            use_cmvn=configs.get('cmvn') == 'global_cmvn',
            **_conf(configs['encoder_conf'],
                    _params(ConformerEncoder.__init__), 'encoder',
                    _ENCODER_FIXED))
        decoder = dec_cls(vocab_size, encoder.output_size(), **dec_conf)
        ctc = CTC(vocab_size, encoder.output_size(),
                  configs.get('ctc_conf', {}).get('ctc_blank_id', 0))
        model = ASRModel(
            vocab_size, encoder, decoder, ctc,
            special_tokens=configs.get('tokenizer_conf',
                                       {}).get('special_tokens'),
            **_conf(configs.get('model_conf', {}),
                    _params(ASRModel.__init__), 'model'))
    model.to_empty(device='cpu')
    init_weights(model, generator)
    return model


def init_weights(model: nn.Module,
                 generator: Optional[torch.Generator] = None) -> None:
    """Fill every parameter and buffer: fan-in uniform for Linear/Conv,
    N(0, 1) embeddings, Xavier-uniform rel-pos biases, identity norms and
    cmvn.  Raises if a tensor is left unset."""
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
        elif isinstance(m, RelPositionMultiHeadedAttention):
            h, d = m.pos_bias_u.shape
            for t in (m.pos_bias_u, m.pos_bias_v):
                fill(t, uniform(math.sqrt(6.0 / (h + d))))
    missed = [n for n, t in list(model.named_parameters()) +
              list(model.named_buffers()) if id(t) not in done]
    if missed:
        raise RuntimeError(f'init_weights left tensors unset: {missed[:5]}')
