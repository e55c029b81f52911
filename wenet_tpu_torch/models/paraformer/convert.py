"""FunASR paraformer checkpoint and config -> a model directory of this
package.  Counterpart of wenet_tpu/models/paraformer/convert.py:
FunASR's module names become the reference wenet keys that the port's
`Paraformer` loads with `strict=True` (`final.pt`), its yaml a train.yaml
and its cmvn (am.mvn or JSON stats) wenet's JSON cmvn:

    python -m wenet_tpu_torch.models.paraformer.convert \\
        --paraformer_model model.pt --paraformer_config config.yaml \\
        --paraformer_cmvn am.mvn --symbol_table units.txt \\
        --seg_dict seg_dict --output_dir exp/paraformer
"""

import argparse
import json
import os
from typing import Dict


def convert_state_dict(sd: Dict) -> Dict:
    """FunASR names -> wenet names."""
    out = {}
    for name, w in sd.items():
        wn = name
        if wn.startswith('predictor.cif_output2'):
            wn = wn.replace('predictor.cif_output2.',
                            'predictor.tp_output.')
        elif wn.startswith('predictor.cif'):
            wn = wn.replace('predictor.cif', 'predictor.predictor.cif')
        elif wn.startswith('predictor.upsample') or \
                wn.startswith('predictor.blstm'):
            wn = wn.replace('predictor.', 'predictor.tp_')
        elif wn == 'decoder.embed.0.weight':
            wn = 'embed.weight'
        out[wn] = w
    return out


def build_config(funasr_conf: Dict, symbol_table_path: str,
                 seg_dict_path: str, cmvn_path: str,
                 output_dim: int) -> Dict:
    """FunASR config -> train.yaml dict."""
    enc = dict(funasr_conf.get('encoder_conf', {}))
    dec = dict(funasr_conf.get('decoder_conf', {}))
    pred = dict(funasr_conf.get('predictor_conf', {}))
    for k in ('selfattention_layer_type', 'pos_enc_class'):
        enc.pop(k, None)
    for k in ('upsample_type', 'use_cif1_cnn'):
        pred.pop(k, None)
    enc['input_layer'] = 'paraformer_dummy'
    enc['pos_enc_layer_type'] = 'abs_pos_paraformer'
    return {
        'encoder': 'sanm_encoder',
        'encoder_conf': enc,
        'decoder': 'sanm_decoder',
        'decoder_conf': dec,
        'cif_predictor_conf': pred,
        'lfr_conf': {'lfr_m': 7, 'lfr_n': 6},
        'input_dim': 7 * 80,
        'output_dim': output_dim,
        'model': 'paraformer',
        'model_conf': {
            'ctc_weight': 0.0, 'lsm_weight': 0.1,
            'length_normalized_loss': True,
            'predictor_weight': 1.0, 'predictor_bias': 1,
            'sampling_ratio': 0.75,
        },
        'ctc_conf': {'ctc_blank_id': 0},
        'cmvn': 'global_cmvn',
        'cmvn_conf': {'cmvn_file': cmvn_path, 'is_json_cmvn': True},
        'tokenizer': 'paraformer',
        'tokenizer_conf': {
            'symbol_table_path': symbol_table_path,
            'seg_dict_path': seg_dict_path,
            'special_tokens': {'<blank>': 0, '<unk>': 1, '<sos>': 2,
                               '<eos>': 2},
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
                           'max_frames_in_batch': 8000},
        },
    }


def convert_funasr_cmvn(cmvn_json_path: str, out_path: str):
    """FunASR am.mvn (kaldi text) or JSON stats -> wenet JSON cmvn."""
    with open(cmvn_json_path, encoding='utf-8') as f:
        text = f.read()
    try:
        obj = json.loads(text)
        mean, var = obj['mean_stat'], obj['var_stat']
        count = obj['frame_num']
    except (json.JSONDecodeError, KeyError):
        # FunASR am.mvn (kaldi nnet text): the stats live on the
        # '<LearnRateCoef> 0 [ v1 ... vD ]' line FOLLOWING the
        # '<AddShift>' / '<Rescale>' headers
        lines = text.splitlines()
        neg_mean, inv_std = None, None
        for i, line in enumerate(lines):
            item = line.split()
            if not item:
                continue
            if item[0] in ('<AddShift>', '<Rescale>') and \
                    i + 1 < len(lines):
                nxt = lines[i + 1].split()
                if nxt and nxt[0] == '<LearnRateCoef>':
                    vals = [float(x) for x in nxt[3:len(nxt) - 1]]
                    if item[0] == '<AddShift>':
                        neg_mean = vals
                    else:
                        inv_std = vals
        assert neg_mean is not None and inv_std is not None, \
            'unrecognized cmvn format'
        count = 1.0
        # paraformer stores (-mean) and (1/std): invert to stats
        mean = [-m for m in neg_mean]
        var = [1.0 / (s * s) + m * m for s, m in zip(inv_std, mean)]
    with open(out_path, 'w', encoding='utf-8') as f:
        json.dump({'mean_stat': mean, 'var_stat': var,
                   'frame_num': count}, f)


def main():
    import torch
    import yaml
    p = argparse.ArgumentParser()
    p.add_argument('--paraformer_model', required=True)
    p.add_argument('--paraformer_config', required=True)
    p.add_argument('--paraformer_cmvn', required=True)
    p.add_argument('--symbol_table', required=True)
    p.add_argument('--seg_dict', required=True)
    p.add_argument('--output_dir', required=True)
    args = p.parse_args()
    os.makedirs(args.output_dir, exist_ok=True)
    sd = torch.load(args.paraformer_model, map_location='cpu')
    sd = convert_state_dict(sd)
    torch.save(sd, os.path.join(args.output_dir, 'final.pt'))
    with open(args.paraformer_config, encoding='utf-8') as f:
        fconf = yaml.safe_load(f)
    vocab = sum(1 for _ in open(args.symbol_table, encoding='utf-8'))
    cmvn_out = os.path.join(args.output_dir, 'global_cmvn')
    convert_funasr_cmvn(args.paraformer_cmvn, cmvn_out)
    cfg = build_config(fconf, args.symbol_table, args.seg_dict,
                       cmvn_out, vocab)
    with open(os.path.join(args.output_dir, 'train.yaml'), 'w') as f:
        yaml.dump(cfg, f)
    print('wrote', args.output_dir)


if __name__ == '__main__':
    main()
