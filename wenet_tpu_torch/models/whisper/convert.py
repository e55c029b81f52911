"""Whisper configs and OpenAI checkpoints for the port.  The port's own
copy of `convert_state_dict`, `build_config` and `default_special_tokens`
of wenet_tpu/models/whisper/convert.py.

    from wenet_tpu_torch.models.whisper.convert import (
        build_config, convert_state_dict, default_special_tokens)
    from wenet_tpu_torch.utils.init_model import init_model
    ckpt = torch.load('large-v3.pt', map_location='cpu')
    configs = build_config(ckpt['dims'],
                           default_special_tokens(ckpt['dims']['n_vocab']))
    model = init_model(configs, device='cpu')
    model.load_state_dict(convert_state_dict(ckpt['model_state_dict']),
                          strict=False)  # ctc.* is not in the checkpoint
"""

from typing import Dict

from wenet_tpu_torch.models.whisper.tokens import special_token_ids


def convert_state_dict(sd) -> Dict:
    """OpenAI whisper state dict -> the wenet keys of this package."""
    out = {}
    for name, v in sd.items():
        orig = name
        name = name.replace('encoder.conv1', 'encoder.embed.conv.0')
        name = name.replace('encoder.conv2', 'encoder.embed.conv.2')
        name = name.replace('decoder.token_embedding', 'decoder.embed.0')
        name = name.replace('encoder.blocks', 'encoder.encoders')
        name = name.replace('decoder.blocks', 'decoder.decoders')
        name = name.replace('.cross_attn.query', '.src_attn.linear_q')
        name = name.replace('.cross_attn.key', '.src_attn.linear_k')
        name = name.replace('.cross_attn.value', '.src_attn.linear_v')
        name = name.replace('.cross_attn.out', '.src_attn.linear_out')
        name = name.replace('.attn.query', '.self_attn.linear_q')
        name = name.replace('.attn.key', '.self_attn.linear_k')
        name = name.replace('.attn.value', '.self_attn.linear_v')
        name = name.replace('.attn.out', '.self_attn.linear_out')
        name = name.replace('mlp.0', 'feed_forward.w_1')
        name = name.replace('mlp.2', 'feed_forward.w_2')
        if 'decoder' in name:
            name = name.replace('cross_attn_ln', 'norm2')
            name = name.replace('mlp_ln', 'norm3')
        else:
            name = name.replace('mlp_ln', 'norm2')
        name = name.replace('attn_ln', 'norm1')
        name = name.replace('encoder.ln_post', 'encoder.after_norm')
        name = name.replace('decoder.ln', 'decoder.after_norm')
        if orig == 'decoder.positional_embedding':
            out['decoder.embed.1.pe'] = v.unsqueeze(0).float()
            continue
        if orig == 'encoder.positional_embedding':
            continue  # the sinusoid is recomputed on the fly
        if name != orig:
            out[name] = v.float()
    return out


def build_config(dims: Dict, special_tokens: Dict) -> Dict:
    """A wenet-style config for an OpenAI checkpoint's `dims`."""
    is_multi = dims['n_vocab'] >= 51865
    return {
        'input_dim': dims['n_mels'],
        'output_dim': dims['n_vocab'],
        'encoder': 'transformer',
        'encoder_conf': {
            'input_layer': 'conv1d2',
            'output_size': dims['n_audio_state'],
            'attention_heads': dims['n_audio_head'],
            'linear_units': dims['n_audio_state'] * 4,
            'num_blocks': dims['n_audio_layer'],
            'dropout_rate': 0.1,
            'positional_dropout_rate': 0.1,
            'attention_dropout_rate': 0.0,
            'normalize_before': True,
            'use_dynamic_chunk': False,
            'pos_enc_layer_type': 'abs_pos_whisper',
            'static_chunk_size': -1,
            'key_bias': False,
            'activation_type': 'gelu',
        },
        'decoder': 'transformer',
        'decoder_conf': {
            'tie_word_embedding': True,
            'attention_heads': dims['n_text_head'],
            'linear_units': dims['n_text_state'] * 4,
            'num_blocks': dims['n_text_layer'],
            'dropout_rate': 0.1,
            'positional_dropout_rate': 0.1,
            'self_attention_dropout_rate': 0.0,
            'src_attention_dropout_rate': 0.0,
            'input_layer': 'embed_learnable_pe',
            'learnable_pe_max_len': dims['n_text_ctx'],
            'use_output_layer': True,
            'normalize_before': True,
            'src_attention': True,
            'key_bias': False,
            'src_key_bias': False,
            'activation_type': 'gelu',
        },
        'tokenizer': 'whisper',
        'tokenizer_conf': {
            'is_multilingual': is_multi,
            'num_languages': dims['n_vocab'] - 51765 - int(is_multi),
            'special_tokens': special_tokens,
        },
        'ctc_conf': {'ctc_blank_id': special_tokens['no_speech']},
        'cmvn': None,
        'model': 'whisper',
        'model_conf': {'ctc_weight': 0.0, 'lsm_weight': 0.1,
                       'length_normalized_loss': False},
        'dataset_conf': {
            'filter_conf': {'max_length': dims['n_audio_ctx'] * 2,
                            'min_length': 0,
                            'token_max_length': dims['n_text_ctx'],
                            'token_min_length': 1},
            'resample_conf': {'resample_rate': 16000},
            'speed_perturb': False,
            'spec_aug': True,
            'spec_aug_conf': {'num_t_mask': 2, 'num_f_mask': 2,
                              'max_t': 50, 'max_f': 10},
            'spec_sub': True,
            'spec_sub_conf': {'num_t_sub': 3, 'max_t': 30},
            'feats_type': 'log_mel_spectrogram',
            'log_mel_spectrogram_conf': {
                'n_fft': 400, 'hop_length': 160,
                'num_mel_bins': dims['n_mels'], 'padding': 0,
            },
            'batch_conf': {'batch_type': 'dynamic',
                           'max_frames_in_batch': 12000},
        },
        'grad_clip': 5,
        'accum_grad': 4,
        'max_epoch': 100,
        'log_interval': 100,
        'optim': 'adam',
        'optim_conf': {'lr': 0.0005},
        'scheduler': 'warmuplr',
        'scheduler_conf': {'warmup_steps': 12000},
    }


def default_special_tokens(n_vocab: int) -> Dict[str, int]:
    """Token ids implied by the whisper vocab layout (multilingual when
    n_vocab >= 51865)."""
    is_multi = n_vocab >= 51865
    num_lang = n_vocab - 51765 - int(is_multi)
    # n_vocab = base + 2 + num_lang + 6 + 1501
    t = special_token_ids(n_vocab - (2 + num_lang + 6 + 1501), num_lang)
    return {
        'sot': t['<|startoftranscript|>'],
        'eot': t['<|endoftext|>'],
        'sot_prev': t['<|startofprev|>'],
        'transcribe': t['<|transcribe|>'],
        'translate': t['<|translate|>'],
        'no_timestamps': t['<|notimestamps|>'],
        'no_speech': t['<|nospeech|>'],
        'timestamp_begin': t['<|0.00|>'],
    }
