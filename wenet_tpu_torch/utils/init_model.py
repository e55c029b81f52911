"""Config-driven model construction.  Counterpart of
wenet_tpu/utils/init_model.py (`asr_model`, `ctl_model`, `transducer`,
`whisper`, `paraformer`, `sensevoice_small`, `firered`, `k2_model` and the
SSL models `bestrq_model`, `wav2vec_model` and `w2vbert_model`): an encoder
of the zoo (conformer, transformer, branchformer, E-Branchformer,
Squeezeformer, efficient conformer, the SAN-M encoders, FireRed's
conformer), a (bi)transformer or SAN-M decoder (none for SenseVoice)
and a CTC head, a transducer's predictor (rnn, embedding, conv) and
joint, and a paraformer's CIF predictor (`predictor_conf`, the JAX
package's defaults; `cif_predictor_conf` is not read, as there), from
the same train.yaml schema: `input_dim` is the LFR features' width where the
config has an `lfr_conf`, and the efficient conformer's `efficient_conf`
section is merged into its encoder_conf, as the JAX package does; with
LoRA attention projections when `lora_conf.use_lora` is set (the
conformer's and transformer's encoder always, the decoder's with
`lora_decoder`).

An SSL model is its encoder and its own heads (no decoder, no CTC head),
its options read from `model_conf` as the JAX package reads them: the
ones its constructor takes, the rest ignored.

`gradient_checkpointing` (activation recomputation, which trades memory
for compute and changes no result) recomputes each layer of the
conformer and transformer encoders and of the (bi)transformer decoder in
the backward ('selective': the encoders' plain attention weights only),
as the JAX package does; the other encoders and the SAN-M decoder, which
never read it there, refuse it.  `use_sdpa` is accepted and ignored.  Options
this package implements at one value only (the value every example
config uses) must have that value; any other option raises
NotImplementedError."""

import inspect
import logging
import math
from typing import Optional

import torch
from torch import nn

from wenet_tpu_torch.models.ctl_model.asr_model_ctl import CTLModel
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
from wenet_tpu_torch.models.firered.model import (FireRedConformerEncoder,
                                                  FireRedModel)
from wenet_tpu_torch.models.k2.model import K2Model
from wenet_tpu_torch.models.paraformer.layers import SanmDecoder, SanmEncoder
from wenet_tpu_torch.models.paraformer.paraformer import Paraformer, Predictor
from wenet_tpu_torch.models.sensevoice.sensevoice_small_model import (
    SanmEncoderWithTp, SenseVoiceSmall)
from wenet_tpu_torch.models.squeezeformer.encoder import SqueezeformerEncoder
from wenet_tpu_torch.models.ssl.w2vbert_model import SSL_MODEL_CLASSES
from wenet_tpu_torch.models.transducer.joint import JOINT_CLASSES
from wenet_tpu_torch.models.transducer.predictor import PREDICTOR_CLASSES
from wenet_tpu_torch.models.transducer.transducer import Transducer
from wenet_tpu_torch.models.transformer.encoder import (ConformerEncoder,
                                                        TransformerEncoder)
from wenet_tpu_torch.models.transformer.encoder_layer import LAYER_OPTIONS
from wenet_tpu_torch.models.whisper.convert import default_special_tokens
from wenet_tpu_torch.models.whisper.whisper import Whisper

ENCODER_CLASSES = {
    'conformer': ConformerEncoder,
    'transformer': TransformerEncoder,
    'branchformer': BranchformerEncoder,
    'e_branchformer': EBranchformerEncoder,
    'squeezeformer': SqueezeformerEncoder,
    'efficientConformer': EfficientConformerEncoder,
    # the reference's aliases: ctl_model's encoders, the plain ones here
    # (the CTL model calls them with full_context for the full pass)
    'dual_transformer': TransformerEncoder,
    'dual_conformer': ConformerEncoder,
    'sanm_encoder': SanmEncoder,
    'sanm_encoder_with_tp': SanmEncoderWithTp,
    'firered_conformer': FireRedConformerEncoder,
}
ENCODER_TYPE_OF = {'dual_transformer': 'transformer',
                   'dual_conformer': 'conformer'}
DECODER_CLASSES = {'transformer': TransformerDecoder,
                   'bitransformer': BiTransformerDecoder,
                   'sanm_decoder': SanmDecoder}
MODEL_CLASSES = {'asr_model': ASRModel, 'ctl_model': CTLModel,
                 'whisper': Whisper,
                 'transducer': Transducer, 'paraformer': Paraformer,
                 'sensevoice_small': SenseVoiceSmall,
                 'firered': FireRedModel, 'k2_model': K2Model,
                 **SSL_MODEL_CLASSES}
# accepted and ignored (the attention is chosen by device and shape)
_IGNORED = {'use_sdpa'}
# options ported at one value: another raises with the why given
_ONE_VALUE = 'the port implements this model at that value only'
_SANM_FIXED = {'input_layer': ('paraformer_dummy', _ONE_VALUE),
               'pos_enc_layer_type': ('abs_pos_paraformer', _ONE_VALUE),
               'use_dynamic_chunk': (False, _ONE_VALUE)}
# options an encoder of the zoo does not take, at the value that changes
# nothing: another value raises, naming the JAX code that has no such
# option or never reads it (the JAX init_model drops the option or the
# layer ignores it)
_NO_FIELD = dict({k: v for k, v in LAYER_OPTIONS.items()
                  if k != 'normalize_before'}, final_norm=True,
                 gradient_checkpointing=False)
_NO_REMAT = 'the JAX encoder never reads it: only the transformer and ' \
    'conformer encoders recompute their layers ' \
    '(wenet_tpu/models/transformer/encoder.py:292, :339)'
_ENCODER_FIXED_BY_TYPE = {
    'conformer': {},
    'transformer': {},
    'branchformer': {'gradient_checkpointing': (False, _NO_REMAT)},
    'e_branchformer': {'stochastic_depth_rate': (
        0.0, 'the JAX E-Branchformer layer never reads it '
        '(wenet_tpu/models/e_branchformer/encoder.py:40)'),
        'gradient_checkpointing': (False, _NO_REMAT)},
    'efficientConformer': {k: (v, 'the JAX EfficientConformerEncoder has '
                               'no such field (wenet_tpu/models/'
                               'efficient_conformer/encoder.py:284-312)')
                           for k, v in _NO_FIELD.items()},
    'squeezeformer': dict(
        {k: (v, 'the JAX SqueezeformerEncoder has no such field '
             '(wenet_tpu/models/squeezeformer/encoder.py:361-390)')
         for k, v in _NO_FIELD.items()},
        pos_enc_layer_type=('rel_pos', 'the JAX encoder never reads it: '
                            'its attention is rel-pos '
                            '(wenet_tpu/models/squeezeformer/encoder.py:373)'),
        time_reduction_layer_type=(
            'conv1d', 'only TimeReductionLayer1D exists '
            '(wenet_tpu/models/squeezeformer/encoder.py:247)'),
        concat_after=(False, 'the JAX layer never reads it '
                      '(wenet_tpu/models/squeezeformer/encoder.py:292)')),
    'sanm_encoder': dict(_SANM_FIXED,
                         gradient_checkpointing=(False, _NO_REMAT)),
    'sanm_encoder_with_tp': dict(_SANM_FIXED,
                                 gradient_checkpointing=(False, _NO_REMAT)),
    'firered_conformer': dict({k: (v, _ONE_VALUE) for k, v in dict(
        activation_type='swish', macaron_style=True, use_cnn_module=True,
        conv_bias=True, conv_inner_factor=2, input_layer='conv2d',
        pos_enc_layer_type='rel_pos_firered',
        selfattention_layer_type='firered_rel_selfattn',
        causal=False).items()}, gradient_checkpointing=(False, _NO_REMAT)),
}
_SANM_DECODER_FIXED = {'gradient_checkpointing': (
    False, 'the JAX SanmDecoder has no such field '
    '(wenet_tpu/models/paraformer/layers.py:256-270)')}
# model options implemented at one value only
_MODEL_FIXED = {'paraformer': {'predictor_weight': 1.0, 'predictor_bias': 1}}


def _params(fn) -> set:
    """The constructor's options a config section may set: its named
    parameters and, where it takes `**layer_options`, `LAYER_OPTIONS`
    (the LoRA settings come from `lora_conf`, not from a section)."""
    params = inspect.signature(fn).parameters
    names = {name for name, p in params.items()
             if p.kind is not p.VAR_KEYWORD}
    if 'layer_options' in params:
        names |= set(LAYER_OPTIONS)
    return names - {'lora_conf'}


def _conf(conf: dict, accepted: set, what: str, fixed=None) -> dict:
    """The options of `conf` that the constructor takes (`accepted`);
    ignored options and options at their `fixed` value (`fixed`: {key:
    (value, why another value raises)}) are dropped, anything else
    raises."""
    fixed = fixed or {}
    out = {}
    for key, value in conf.items():
        want, why = fixed.get(key, (None, None))
        if key in accepted:
            out[key] = value
        elif not (key in _IGNORED or key in fixed and want == value):
            raise NotImplementedError(
                f'{what} option {key}={value!r} is not ported' +
                (f': {why}' if why else ''))
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
            raise NotImplementedError(f'{key}={value!r} is not ported')
    lora_conf = lora_conf_of(configs)
    dec_lora = (lora_conf if (configs.get('lora_conf') or {}).get(
        'lora_decoder', False) else None)
    enc_cls = ENCODER_CLASSES[encoder_type]
    vocab_size = configs['output_dim']
    ssl = model_type in SSL_MODEL_CLASSES
    decoder_type = None if ssl else configs.get('decoder', 'bitransformer')
    if decoder_type is not None and decoder_type not in DECODER_CLASSES:
        raise NotImplementedError(f'decoder={decoder_type!r} is not ported')
    dec_cls = DECODER_CLASSES.get(decoder_type)
    dec_kw, dec_params = {}, set()
    if dec_cls is SanmDecoder:
        dec_params = _params(SanmDecoder.__init__)
        if dec_lora is not None:
            raise NotImplementedError('LoRA on the sanm decoder is not '
                                      'ported')
    elif dec_cls is not None:
        dec_params = _params(TransformerDecoder.__init__)
        if dec_cls is BiTransformerDecoder:
            dec_params.add('r_num_blocks')
        dec_kw = {'lora_conf': dec_lora}
    dec_conf = _conf(configs.get('decoder_conf', {}), dec_params, 'decoder',
                     _SANM_DECODER_FIXED if dec_cls is SanmDecoder else None)

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
    fixed = _ENCODER_FIXED_BY_TYPE[ENCODER_TYPE_OF.get(encoder_type,
                                                        encoder_type)]
    # SenseVoice's cmvn is the model's, after LFR (JAX init_model.py:131)
    use_cmvn = (configs.get('cmvn') == 'global_cmvn' and
                model_type != 'sensevoice_small')
    model_conf = dict(configs.get('model_conf', {}))
    if model_type == 'transducer':
        # accepted and ignored, as the JAX package's Transducer does:
        # the attention loss weighs 1 - transducer_weight - ctc_weight
        model_conf.pop('attention_weight', None)
    for key, value in _MODEL_FIXED.get(model_type, {}).items():
        if model_conf.get(key, value) != value:
            raise NotImplementedError(f'model option {key}='
                                      f'{model_conf[key]!r} is not ported')
        model_conf.pop(key, None)
    with torch.device('meta'):
        encoder = enc_cls(
            configs['input_dim'], use_cmvn=use_cmvn, **enc_kw,
            **_conf(enc_conf, _params(enc_cls.__init__), 'encoder', fixed))
        decoder = (dec_cls(vocab_size, encoder.output_size(), **dec_kw,
                           **dec_conf) if dec_cls is not None else None)
        model_cls = MODEL_CLASSES[model_type]
        if ssl:
            params = _params(model_cls.__init__)
            model = model_cls(encoder, **{k: v for k, v in model_conf.items()
                                          if k in params})
        else:
            model = _asr_model(configs, model_cls, model_conf, vocab_size,
                               encoder, decoder, special_tokens)
    if torch.device(device).type != 'meta':
        model.to_empty(device=device)
        init_weights(model, generator)
    return model


def _asr_model(configs: dict, model_cls, model_conf: dict, vocab_size: int,
               encoder: nn.Module, decoder: Optional[nn.Module],
               special_tokens: Optional[dict]) -> nn.Module:
    """A model of the ASRModel family around `encoder` and `decoder`: the
    CTC head, the transducer's or paraformer's own parts, model_conf."""
    ctc = CTC(vocab_size, encoder.output_size(),
              configs.get('ctc_conf', {}).get('ctc_blank_id', 0))
    extra = {}
    if model_cls is Transducer:
        extra = _transducer_parts(configs, vocab_size, encoder.output_size())
    elif model_cls is Paraformer:
        extra = {'predictor': _cif_predictor(configs, encoder.output_size())}
        if model_conf.get('ctc_weight', 0.5) == 0.0:
            ctc = None  # no CTC parameters, as in the JAX package
    return model_cls(
        vocab_size, encoder, decoder, ctc, special_tokens=special_tokens,
        **extra, **_conf(model_conf, _params(ASRModel.__init__) |
                         _params(model_cls.__init__), 'model'))


def _cif_predictor(configs: dict, enc_output_size: int) -> Predictor:
    """The paraformer's CIF predictor from `predictor_conf`, with the JAX
    package's defaults (idim the encoder's width, l_order and r_order
    1).  `cif_predictor_conf`, which the paraformer yaml sets, is not
    read, as in the JAX package (its values are the defaults)."""
    if 'cif_predictor_conf' in configs and 'predictor_conf' not in configs:
        logging.warning('cif_predictor_conf is not read: the paraformer '
                        'predictor takes predictor_conf (here the '
                        'defaults), as the JAX package does')
    pred_conf = _conf(configs.get('predictor_conf', {}),
                      _params(Predictor.__init__), 'predictor')
    pred_conf.setdefault('idim', enc_output_size)
    pred_conf.setdefault('l_order', 1)
    pred_conf.setdefault('r_order', 1)
    return Predictor(**pred_conf)


def _transducer_parts(configs: dict, vocab_size: int,
                      enc_output_size: int) -> dict:
    """The transducer's predictor and joint from `predictor` /
    `predictor_conf` and `joint` / `joint_conf`, with the JAX package's
    defaults (the joint's widths: the encoder's, the predictor's output
    or 256, join_dim 256), and its blank, 0."""
    kinds = (('predictor', 'rnn', PREDICTOR_CLASSES),
             ('joint', 'transducer_joint', JOINT_CLASSES))
    for key, default, classes in kinds:
        if configs.get(key, default) not in classes:
            raise ValueError(f'unknown {key}: {configs[key]!r}')
    pred_cls = PREDICTOR_CLASSES[configs.get('predictor', 'rnn')]
    pred_conf = _conf(configs.get('predictor_conf', {}),
                      _params(pred_cls.__init__), 'predictor')
    joint_cls = JOINT_CLASSES[configs.get('joint', 'transducer_joint')]
    joint_conf = _conf(configs.get('joint_conf', {}),
                       _params(joint_cls.__init__), 'joint')
    joint_conf.setdefault('enc_output_size', enc_output_size)
    joint_conf.setdefault('pred_output_size',
                          pred_conf.get('output_size', 256))
    joint_conf.setdefault('join_dim', 256)
    return {'predictor': pred_cls(voca_size=vocab_size, **pred_conf),
            'joint': joint_cls(vocab_size=vocab_size, **joint_conf),
            'blank': 0}


def init_weights(model: nn.Module,
                 generator: Optional[torch.Generator] = None) -> None:
    """Fill every parameter and buffer: fan-in uniform for Linear/Conv,
    N(0, 1) embeddings, N(0, 0.02) learnable positions, zero tied-output
    biases, Xavier-uniform rel-pos biases, identity norms and cmvn; LoRA
    lora_A kaiming-uniform (fan-in uniform, torch's `a=sqrt(5)`) and
    lora_B zero, so a fresh LoRA layer adds nothing; a module with an
    `init_own(generator)` method (the SSL heads and quantizers) fills its
    own tensors and returns them.  Raises if a tensor is left unset."""
    done = set()

    def fill(t, fn):
        with torch.no_grad():
            fn(t)
        done.add(id(t))

    def uniform(bound):
        return lambda t: t.uniform_(-bound, bound, generator=generator)

    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d,
                          nn.ConvTranspose1d)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            fill(m.weight, uniform(bound))
            if m.bias is not None:
                fill(m.bias, uniform(bound))
            if isinstance(m, LoRALinear):
                fill(m.lora_A, uniform(1.0 / math.sqrt(m.lora_A.shape[1])))
                fill(m.lora_B, nn.init.zeros_)
        elif isinstance(m, nn.LSTM):
            # torch's own LSTM init: U(-1/sqrt(H), 1/sqrt(H)) for all
            for t in m.parameters():
                fill(t, uniform(1.0 / math.sqrt(m.hidden_size)))
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
        own = getattr(m, 'init_own', None)
        if own is not None:  # a model's own parameters and buffers
            for t in own(generator):
                done.add(id(t))
    missed = [n for n, t in list(model.named_parameters()) +
              list(model.named_buffers()) if id(t) not in done]
    if missed:
        raise RuntimeError(f'init_weights left tensors unset: {missed[:5]}')
