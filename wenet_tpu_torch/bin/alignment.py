"""CTC forced alignment of a data list's transcripts, with Praat
TextGrids.  Counterpart of wenet_tpu/bin/alignment.py, on --device
(default cuda):

    python -m wenet_tpu_torch.bin.alignment --config exp/u2pp/train.yaml \\
        --input_file data/test/data.list --checkpoint exp/u2pp/final.pt \\
        --result_file ali.txt --gen_praat

writes `key t0 t1 ...` lines (one token id a frame, blanks included) and,
with --gen_praat, `<result_file stem>.<key>.TextGrid` per utterance.  The
encoder and the CTC log-probs run on the device, and so does the Viterbi
(`utils/ctc_utils.force_align`)."""

import argparse
import logging
import os

import torch

from wenet_tpu_torch.bin.recognize import decode_dataset_conf
from wenet_tpu_torch.dataset.dataset import Dataset
from wenet_tpu_torch.utils.checkpoint import load_model
from wenet_tpu_torch.utils.config import load_config
from wenet_tpu_torch.utils.ctc_utils import (force_align, gen_ctc_peak_time,
                                             get_blank_id)
from wenet_tpu_torch.utils.init_tokenizer import init_tokenizer


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description='use ctc to generate alignment')
    parser.add_argument('--config', required=True)
    parser.add_argument('--input_file', required=True)
    parser.add_argument('--data_type', default='raw',
                        choices=['raw', 'shard'])
    parser.add_argument('--checkpoint', required=True)
    parser.add_argument('--result_file', required=True)
    parser.add_argument('--gen_praat', action='store_true')
    parser.add_argument('--batch_size', type=int, default=1,
                        help='read, as in the JAX package; one at a time')
    parser.add_argument('--device', default='cuda')
    return parser


def generator_textgrid(maxtime, lines, output):
    """A one-tier Praat TextGrid of `lines` ('start end token')."""
    interval = len(lines)
    with open(output, 'w', encoding='utf8') as f:
        f.write('File type = "ooTextFile"\n')
        f.write('Object class = "TextGrid"\n\n')
        f.write('xmin = 0\nxmax = %.2f\n' % maxtime)
        f.write('tiers? <exists>\nsize = 1\nitem []:\n')
        f.write('    item [1]:\n')
        f.write('        class = "IntervalTier"\n')
        f.write('        name = "token"\n')
        f.write('        xmin = 0\n        xmax = %.2f\n' % maxtime)
        f.write('        intervals: size = %d\n' % interval)
        for i, line in enumerate(lines):
            s, e, t = line.split()
            f.write('        intervals [%d]:\n' % (i + 1))
            f.write('            xmin = %s\n            xmax = %s\n' %
                    (s, e))
            f.write('            text = "%s"\n' % t)


def main(argv=None):
    """Align and write -> {key: frame-level token ids}."""
    args = get_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    configs = load_config(args.config)
    tokenizer = init_tokenizer(configs)
    # the yaml's length filters stay, as in the JAX package
    conf = dict(decode_dataset_conf(configs, 1), filter_conf=configs[
        'dataset_conf'].get('filter_conf', {}))
    configs.setdefault('input_dim', conf.get('fbank_conf', {}).get(
        'num_mel_bins', 80))
    configs.setdefault('output_dim', tokenizer.vocab_size())
    configs, blank_id = get_blank_id(configs, tokenizer.symbol_table)
    dataset = Dataset(args.data_type, args.input_file, tokenizer, conf,
                      partition=False)
    model = load_model(configs, args.checkpoint, args.device)
    frame_shift_s = 0.01 * model.encoder.subsampling_rate
    out = {}
    with open(args.result_file, 'w', encoding='utf8') as fout:
        for batch in dataset:
            key = batch['keys'][0]
            with torch.inference_mode():
                enc, mask = model.forward_encoder(
                    torch.as_tensor(batch['feats'], device=args.device),
                    torch.as_tensor(batch['feats_lengths'],
                                    device=args.device))
                ctc_probs = model.ctc_logprobs(enc, blank_id=blank_id)
                n = int(mask[0, 0].sum())
                label = batch['target'][0][:batch['target_lengths'][0]]
                alignment = force_align(ctc_probs[0, :n], label, blank_id)
            out[key] = alignment
            fout.write('{} {}\n'.format(
                key, ' '.join(str(x) for x in alignment)))
            if args.gen_praat:
                peaks = gen_ctc_peak_time(alignment, blank_id)
                tokens = tokenizer.detokenize([int(x) for x in label])[1]
                lines = []
                prev = 0.0
                for tok, peak in zip(tokens, peaks):
                    end = (peak + 1) * frame_shift_s
                    lines.append(f'{prev:.2f} {end:.2f} {tok}')
                    prev = end
                textgrid_path = os.path.splitext(
                    args.result_file)[0] + f'.{key}.TextGrid'
                generator_textgrid(n * frame_shift_s, lines, textgrid_path)
    return out


if __name__ == '__main__':
    main()
