"""Batch decode of a data list: the recipe's decode stage.  Counterpart of
wenet_tpu/bin/recognize.py, on --device (default cuda):

    python -m wenet_tpu_torch.bin.recognize --config exp/u2pp/train.yaml \\
        --test_data data/test/data.list --checkpoint exp/u2pp/avg_5.pt \\
        --result_dir exp/u2pp/test --batch_size 16 --beam_size 10 \\
        --ctc_weight 0.3 --reverse_weight 0.5 \\
        --modes ctc_greedy_search ctc_prefix_beam_search \\
        attention_rescoring attention

(a transducer's train.yaml also takes rnnt_greedy_search and
rnnt_beam_search, whose beam is --beam_size; a paraformer's takes
paraformer_greedy_search, paraformer_beam_search and, with a CTC head,
the two CTC modes; a model with a CTC head and an attention decoder, as
the k2 model has, takes hlg_onebest and hlg_rescore over an HLG.txt:

    python -m wenet_tpu_torch.bin.recognize --config exp/k2/train.yaml \
        --test_data data/test/data.list --checkpoint exp/k2/avg_5.pt \
        --result_dir exp/k2/test --hlg data/local/hlg/HLG.txt \
        --word data/local/hlg/words.txt --lm_scale 0.7 \
        --decoder_scale 0.1 --r_decoder_scale 0.7 \
        --modes hlg_onebest hlg_rescore

which run beside the runner's modes, through `models/k2/model.py`, both
over one encoder pass and search a batch)

writes `<result_dir>/<mode>/text` (`key text` lines) for each mode.  The
test set goes through the port's `Dataset` without augmentation,
filters, shuffles or sorting, in static batches, each decoded by
`AsrRunner.decode` in every mode asked for.  The JAX package's pipelined
branches for one mode are not ported: on an H100 the CTC and rescoring
ones were no faster than this loop, whose pace the Dataset's host work
sets (PERF.md), and its transducer greedy branch
(`decode_rnnt_greedy_batches`) is left out for the same reason.
--context_list_path biases the prefix beam (the C++ searcher);
--lm_path re-ranks each n-best with an ARPA LM (score + lm_weight * LM).
--timestamps (a whisper-family model: its special tokens hold
timestamp_begin) ends the decode prompt with <|0.00|>, so that the beam
applies the timestamp grammar, and writes `<result_dir>/<mode>/segments`
(`key start end text` lines, end '-' for a segment the decode ended
inside) beside each text file.  The checkpoint is the port's `.pt` (as
bin/average_model writes it).  A config with an `lfr_conf` (paraformer,
SenseVoice) has an input_dim of the mel bins times lfr_m, as in the JAX
package."""

import argparse
import dataclasses
import logging
import os
import time

import torch

from wenet_tpu_torch.dataset.dataset import Dataset
from wenet_tpu_torch.models.k2.model import (hlg_onebest, hlg_rescore,
                                             hlg_search)
from wenet_tpu_torch.models.runner import MODES, AsrRunner
from wenet_tpu_torch.models.transformer.search import DecodeResult
from wenet_tpu_torch.models.whisper.tokens import whisper_tokens_to_segments
from wenet_tpu_torch.utils.checkpoint import load_model
from wenet_tpu_torch.utils.config import load_config
from wenet_tpu_torch.utils.ctc_utils import get_blank_id
from wenet_tpu_torch.utils.init_tokenizer import init_tokenizer

HLG_MODES = ('hlg_onebest', 'hlg_rescore')


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description='recognize with model')
    parser.add_argument('--config', required=True)
    parser.add_argument('--test_data', required=True)
    parser.add_argument('--data_type', default='raw',
                        choices=['raw', 'shard'])
    parser.add_argument('--checkpoint', required=True)
    parser.add_argument('--beam_size', type=int, default=10)
    parser.add_argument('--length_penalty', type=float, default=0.0)
    parser.add_argument('--blank_penalty', type=float, default=0.0)
    parser.add_argument('--result_dir', required=True)
    parser.add_argument('--batch_size', type=int, default=16)
    parser.add_argument('--modes', dest='modes', nargs='+',
                        default=['attention_rescoring'],
                        help='decoding modes')
    parser.add_argument('--ctc_weight', type=float, default=0.0)
    parser.add_argument('--reverse_weight', type=float, default=0.0)
    parser.add_argument('--decoding_chunk_size', type=int, default=-1)
    parser.add_argument('--num_decoding_left_chunks', type=int,
                        default=-1)
    parser.add_argument('--simulate_streaming', action='store_true')
    parser.add_argument('--timestamps', action='store_true',
                        help='whisper-family attention decode with '
                        'timestamp tokens; segments go to a "segments" '
                        'file beside each text file')
    parser.add_argument('--override_config', action='append', default=[])
    parser.add_argument('--context_list_path', default=None)
    parser.add_argument('--context_graph_score', type=float, default=6.0)
    parser.add_argument('--lm_path', default=None,
                        help='ARPA n-gram for n-best rescoring')
    parser.add_argument('--lm_weight', type=float, default=0.5)
    # the hlg modes: an HLG.txt (lm/build_graph.py build_hlg, or the JAX
    # package's tools/k2/make_hlg.sh) and its words.txt
    parser.add_argument('--hlg', default='',
                        help='HLG.txt, only used for hlg decode')
    parser.add_argument('--word', default='',
                        help='words.txt, only used for hlg decode')
    parser.add_argument('--lm_scale', type=float, default=0.0)
    parser.add_argument('--decoder_scale', type=float, default=0.0)
    parser.add_argument('--r_decoder_scale', type=float, default=0.0)
    parser.add_argument('--device', default='cuda')
    return parser


def _check_modes(args) -> None:
    for mode in args.modes:
        if mode in HLG_MODES:
            if not (args.hlg and args.word):
                raise ValueError(f'mode {mode} needs --hlg and --word')
        elif mode not in MODES:
            raise ValueError(f'unknown mode {mode}')
    if args.simulate_streaming and args.decoding_chunk_size > 0 and \
            args.batch_size != 1:
        raise ValueError('--simulate_streaming decodes one utterance at a '
                         'time: --batch_size 1')


def decode_dataset_conf(configs: dict, batch_size: int) -> dict:
    """The train.yaml's dataset_conf for decoding: no filters,
    augmentation, shuffles or sort, one pass, dither 0, static batches."""
    conf = dict(configs['dataset_conf'])
    conf['filter_conf'] = {
        'max_length': 102400, 'min_length': 0,
        'token_max_length': 102400, 'token_min_length': 0,
        'max_output_input_ratio': 102400,
        'min_output_input_ratio': 0,
    }
    conf.update(speed_perturb=False, spec_aug=False, spec_sub=False,
                spec_trim=False, shuffle=False, list_shuffle=False,
                sort=False, cycle=1)
    if 'fbank_conf' in conf:
        conf['fbank_conf'] = dict(conf['fbank_conf'], dither=0.0)
    conf['batch_conf'] = {'batch_type': 'static', 'batch_size': batch_size}
    return conf


def _lm_rescore(result, lm, lm_weight, id2sym):
    """Re-rank an n-best by score + lm_weight * the LM's sentence score."""
    best, best_score, best_idx = None, -float('inf'), 0
    for idx, (toks, ac) in enumerate(zip(result.nbest,
                                         result.nbest_scores)):
        words = [id2sym.get(int(t), str(int(t))) for t in toks]
        score = ac + lm_weight * lm.score_sequence(words)
        if score > best_score:
            best, best_score, best_idx = toks, score, idx
    times = (result.nbest_times[best_idx]
             if result.nbest_times else result.times)
    return dataclasses.replace(result, tokens=list(best),
                               score=best_score, times=times)


def hlg_decode(runner: AsrRunner, modes, batch: dict, args,
               symbol_table: dict) -> dict:
    """One batch in the hlg `modes` on the runner's model and device, over
    one encoder pass and search -> {mode: each row's unit ids}."""
    if not modes:
        return {}
    speech = torch.as_tensor(batch['feats']).to(runner.device)
    lengths = torch.as_tensor(batch['feats_lengths']).to(runner.device)
    search = hlg_search(runner.model, speech, lengths, args.hlg, args.word)
    out = {}
    for mode in modes:
        if mode == 'hlg_onebest':
            out[mode] = hlg_onebest(runner.model, speech, lengths, args.hlg,
                                    args.word, symbol_table, search)
        else:
            out[mode] = hlg_rescore(
                runner.model, speech, lengths, args.hlg, args.word,
                symbol_table, lm_scale=args.lm_scale,
                decoder_scale=args.decoder_scale,
                r_decoder_scale=args.r_decoder_scale, search=search)
    return out


def build(args):
    """-> (configs, tokenizer, blank id, test Dataset, AsrRunner over the
    checkpoint's model on args.device)."""
    configs = load_config(args.config, args.override_config)
    _check_modes(args)
    test_conf = decode_dataset_conf(configs, args.batch_size)
    tokenizer = init_tokenizer(configs)
    configs['input_dim'] = test_conf.get(
        'fbank_conf', test_conf.get('mfcc_conf', test_conf.get(
            'log_mel_spectrogram_conf', {}))).get('num_mel_bins', 80)
    if 'lfr_conf' in configs:
        configs['input_dim'] *= configs['lfr_conf'].get('lfr_m', 7)
    configs['output_dim'] = tokenizer.vocab_size()
    configs, blank_id = get_blank_id(configs, tokenizer.symbol_table)
    dataset = Dataset(args.data_type, args.test_data, tokenizer, test_conf,
                      partition=False)
    model = load_model(configs, args.checkpoint, args.device)
    return configs, tokenizer, blank_id, dataset, AsrRunner(model,
                                                            args.device)


def main(argv=None):
    """Decode and write the text files -> {'lines': {mode: lines written},
    'seconds': the decode's wall time through the Dataset (the model's
    load excluded), 'audio_seconds': the valid frames' duration}."""
    args = get_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format='%(asctime)s %(levelname)s %(message)s')
    configs, tokenizer, blank_id, dataset, runner = build(args)
    t0 = time.perf_counter()

    lm = id2sym = None
    if args.lm_path:
        from wenet_tpu_torch.lm.arpa import read_arpa
        lm = read_arpa(args.lm_path)
        id2sym = {v: k for k, v in tokenizer.symbol_table.items()}
    context_graph = None
    if args.context_list_path:
        from wenet_tpu_torch.utils.context_graph import ContextGraph
        context_graph = ContextGraph(args.context_list_path,
                                     tokenizer.symbol_table,
                                     context_score=args.context_graph_score)

    ts_begin = None
    if args.timestamps:
        st = dict(getattr(runner.model, 'special_tokens', None) or {})
        if 'timestamp_begin' not in st:
            raise SystemExit('--timestamps needs a whisper-family '
                             'model (special_tokens.timestamp_begin)')
        ts_begin = int(st['timestamp_begin'])
    files, seg_files = {}, {}
    for mode in args.modes:
        d = os.path.join(args.result_dir, mode)
        os.makedirs(d, exist_ok=True)
        files[mode] = open(os.path.join(d, 'text'), 'w', encoding='utf8')
        if ts_begin is not None:
            seg_files[mode] = open(os.path.join(d, 'segments'), 'w',
                                   encoding='utf8')
    counts = dict.fromkeys(args.modes, 0)

    def write_results(keys, mode, hyps):
        for key, hyp in zip(keys, hyps):
            if lm is not None and hyp.nbest:
                hyp = _lm_rescore(hyp, lm, args.lm_weight, id2sym)
            tokens = [int(t) for t in hyp.tokens]
            if ts_begin is not None:
                tokens, segments = whisper_tokens_to_segments(tokens,
                                                              ts_begin)
                for start, end, seg in segments:
                    seg_files[mode].write('{} {:.2f} {} {}\n'.format(
                        key, start,
                        '-' if end is None else '{:.2f}'.format(end),
                        tokenizer.detokenize(seg)[0]))
            line = '{} {}'.format(key, tokenizer.detokenize(tokens)[0])
            logging.info('%s %s', mode, line)
            files[mode].write(line + '\n')
            counts[mode] += 1

    hlg_modes = [m for m in args.modes if m in HLG_MODES]
    runner_modes = [m for m in args.modes if m not in HLG_MODES]
    frames = 0
    try:
        for batch in dataset:
            frames += int(batch['feats_lengths'].sum())
            for mode, hyps in hlg_decode(runner, hlg_modes, batch, args,
                                         tokenizer.symbol_table).items():
                write_results(batch['keys'], mode,
                              [DecodeResult(h) for h in hyps])
            if not runner_modes:
                continue
            results = runner.decode(
                runner_modes, batch['feats'], batch['feats_lengths'],
                beam_size=args.beam_size,
                decoding_chunk_size=args.decoding_chunk_size,
                num_decoding_left_chunks=args.num_decoding_left_chunks,
                ctc_weight=args.ctc_weight,
                simulate_streaming=args.simulate_streaming,
                reverse_weight=args.reverse_weight, blank_id=blank_id,
                blank_penalty=args.blank_penalty,
                length_penalty=args.length_penalty,
                infos={'tasks': batch['tasks'], 'langs': batch['langs'],
                       'no_timestamp': not args.timestamps},
                context_graph=context_graph)
            for mode, hyps in results.items():
                write_results(batch['keys'], mode, hyps)
    finally:
        for f in [*files.values(), *seg_files.values()]:
            f.close()
    shift_ms = configs['dataset_conf'].get('fbank_conf', {}).get(
        'frame_shift', 10)
    return {'lines': counts, 'seconds': time.perf_counter() - t0,
            'audio_seconds': frames * shift_ms / 1000}


if __name__ == '__main__':
    main()
