"""Global CMVN statistics of a wav.scp's fbank features, the recipe's
stage 1.  Counterpart of tools/compute_cmvn_stats.py; writes the same
JSON (`mean_stat`, `var_stat`: sums of each dimension and of its squares;
`frame_num`), which `utils/cmvn.load_cmvn` reads:

    python -m wenet_tpu_torch.bin.compute_cmvn_stats \\
        --train_config conf/train_u2pp_conformer.yaml \\
        --in_scp data/train/wav.scp --out_cmvn data/train/global_cmvn

Features are the train config's fbank (its `num_mel_bins`, at its
`resample_rate`) without dither, computed on the host.  --num_workers is
taken and ignored, as there."""

import argparse
import json
import logging

import numpy as np
import yaml

from wenet_tpu_torch.dataset.audio import read_audio, resample
from wenet_tpu_torch.ops.fbank import compute_fbank_np


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description='compute cmvn stats')
    p.add_argument('--num_workers', type=int, default=1)
    p.add_argument('--train_config', default='')
    p.add_argument('--in_scp', required=True)
    p.add_argument('--out_cmvn', default='global_cmvn')
    p.add_argument('--log_interval', type=int, default=1000)
    return p


def main(argv=None) -> dict:
    """-> the stats written."""
    args = get_parser().parse_args(argv)
    feat_dim, resample_rate = 80, 16000
    if args.train_config:
        with open(args.train_config) as f:
            dc = (yaml.safe_load(f) or {}).get('dataset_conf', {})
        feat_dim = dc.get('fbank_conf', {}).get('num_mel_bins', 80)
        resample_rate = dc.get('resample_conf', {}).get('resample_rate',
                                                        16000)
    mean_stat = np.zeros(feat_dim, np.float64)
    var_stat = np.zeros(feat_dim, np.float64)
    frames = 0
    with open(args.in_scp, encoding='utf8') as f:
        for i, line in enumerate(f):
            arr = line.strip().split()
            if len(arr) != 2:
                continue
            wav, sr = read_audio(arr[1])
            wav = resample(wav, sr, resample_rate)
            feat = compute_fbank_np(wav[0] * (1 << 15),
                                    num_mel_bins=feat_dim,
                                    sample_rate=resample_rate)
            mean_stat += feat.sum(0)
            var_stat += (feat ** 2).sum(0)
            frames += feat.shape[0]
            if (i + 1) % args.log_interval == 0:
                logging.info('processed %d utts, %d frames', i + 1, frames)
    stats = {'mean_stat': mean_stat.tolist(), 'var_stat': var_stat.tolist(),
             'frame_num': frames}
    with open(args.out_cmvn, 'w') as f:
        json.dump(stats, f)
    return stats


if __name__ == '__main__':
    main()
