"""FunASR SenseVoice-small checkpoint and config -> a model directory of
this package.  Counterpart of wenet_tpu/models/sensevoice/convert.py:
the released state dict already has the reference wenet keys (BatchNorm
step counts dropped); the yaml becomes a `sanm_encoder_with_tp` + LFR +
sentencepiece train.yaml:

    python -m wenet_tpu_torch.models.sensevoice.convert \\
        --sensevoice_model model.pt --sensevoice_config config.yaml \\
        --tokenizer_path chn_jpn_yue_eng_ko_spectok.bpe.model \\
        --output_dir exp/sensevoice
"""

import argparse
import os
from typing import Dict


def build_config(funasr_conf: Dict, tokenizer_path: str) -> Dict:
    enc = dict(funasr_conf.get('encoder_conf', {}))
    for k in ('selfattention_layer_type', 'pos_enc_class'):
        enc.pop(k, None)
    enc['input_layer'] = 'paraformer_dummy'
    enc['pos_enc_layer_type'] = 'abs_pos_paraformer'
    return {
        'encoder': 'sanm_encoder_with_tp',
        'encoder_conf': enc,
        'decoder': None,
        'lfr_conf': {'lfr_m': 7, 'lfr_n': 6},
        'input_dim': 7 * 80,
        'model': 'sensevoice_small',
        'model_conf': {'ctc_weight': 1.0, 'lsm_weight': 0.1,
                       'length_normalized_loss': False},
        'ctc_conf': {'ctc_blank_id': 0},
        'tokenizer': 'sentencepiece',
        'tokenizer_conf': {
            'model_path': tokenizer_path,
            'special_tokens': {'<blank>': 0, '<unk>': 0, '<s>': 1,
                               '</s>': 2},
        },
        'dataset_conf': {
            'filter_conf': {'max_length': 20000, 'min_length': 0,
                            'token_max_length': 200,
                            'token_min_length': 1},
            'resample_conf': {'resample_rate': 16000},
            'fbank_conf': {'num_mel_bins': 80, 'frame_shift': 10,
                           'frame_length': 25, 'dither': 0.1,
                           'window_type': 'hamming'},
            'batch_conf': {'batch_type': 'dynamic',
                           'max_frames_in_batch': 12000},
        },
    }


def convert_state_dict(sd: Dict) -> Dict:
    """Names already match: a pass-through without step counts."""
    return {k: v for k, v in sd.items()
            if not k.endswith('num_batches_tracked')}


def main():
    import torch
    import yaml
    p = argparse.ArgumentParser()
    p.add_argument('--sensevoice_model', required=True)
    p.add_argument('--sensevoice_config', required=True)
    p.add_argument('--tokenizer_path', required=True)
    p.add_argument('--output_dir', required=True)
    args = p.parse_args()
    os.makedirs(args.output_dir, exist_ok=True)
    sd = torch.load(args.sensevoice_model, map_location='cpu')
    torch.save(convert_state_dict(sd),
               os.path.join(args.output_dir, 'final.pt'))
    with open(args.sensevoice_config, encoding='utf-8') as f:
        fconf = yaml.safe_load(f)
    cfg = build_config(fconf, args.tokenizer_path)
    with open(os.path.join(args.output_dir, 'train.yaml'), 'w') as f:
        yaml.dump(cfg, f)
    print('wrote', args.output_dir)


if __name__ == '__main__':
    main()
