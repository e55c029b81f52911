"""Decode wavs from a model directory through the streaming decoder and
report the real-time factor.  Counterpart of wenet_tpu/bin/decoder_main.py.

Reads one wav (--wav_path) or a kaldi-style wav.scp (--wav_scp), decodes
each through `AsrDecoder` (the servers' path) in pieces of
--streaming_interval_ms, sleeping that long before each piece with
--simulate_streaming, writes `key text` lines to --result_file and logs
each utterance's decode time and the total RTF (decode time, sleeps
excluded, over audio time).  Runs on --device (default cuda).  Beside
the JAX main's options it takes --ctc_weight (the rescoring's weight of
the CTC score; 0.5 there).

    python -m wenet_tpu_torch.bin.decoder_main --model_dir exp/u2pp \\
        --wav_scp data/test/wav.scp --result_file text --device cuda

Reads RIFF wav and FLAC.  --lm_path takes an ARPA n-gram, fused into the
prefix beam with --lm_weight.  --fst_path takes a TLG in text form
(lm/build_graph.py `build_tlg`), decoded by the C++ lattice WFST decoder
(runtime/native_wfst.py) in place of the prefix beam, and --dict_path its
words.txt, whose words the results then hold:

    python -m wenet_tpu_torch.bin.decoder_main --model_dir exp/u2pp \\
        --wav_scp data/test/wav.scp --fst_path lang_test/TLG.txt \\
        --dict_path lang_test/words.txt --result_file text --device cuda"""

import argparse
import logging
import time
import types

logger = logging.getLogger(__name__)


def build_decoder(args):
    """The decoder over `args.model_dir`'s model on `args.device`, with
    the lowercasing post-processor (unless `args.no_lowercase`)."""
    from wenet_tpu_torch.runtime.asr_decoder import AsrDecoder, DecodeOptions
    from wenet_tpu_torch.runtime.feature_pipeline import (
        FeaturePipelineConfig)
    from wenet_tpu_torch.runtime.post_processor import (PostProcessOptions,
                                                        PostProcessor)
    from wenet_tpu_torch.utils.checkpoint import load_model_dir
    if args.dict_path and not args.fst_path:
        raise ValueError('--dict_path is the words of a TLG: it needs '
                         '--fst_path')
    lm = words = None
    if args.lm_path:
        from wenet_tpu_torch.lm.arpa import read_arpa
        lm = read_arpa(args.lm_path)
    if args.dict_path:
        from wenet_tpu_torch.lm.fst import read_symbol_table
        words = read_symbol_table(args.dict_path)
    model, configs, tokenizer = load_model_dir(args.model_dir, args.device)
    opts = DecodeOptions(chunk_size=args.chunk_size,
                         num_left_chunks=args.num_left_chunks,
                         beam_size=args.beam_size,
                         ctc_weight=args.ctc_weight,
                         reverse_weight=args.reverse_weight)
    pp = PostProcessor(PostProcessOptions(lowercase=not args.no_lowercase))
    return AsrDecoder(model, tokenizer, opts,
                      FeaturePipelineConfig.from_configs(configs), lm=lm,
                      lm_weight=args.lm_weight, tlg_fst=args.fst_path or None,
                      word_table=words, post_processor=pp,
                      device=args.device)


def decoder_args(**kw) -> types.SimpleNamespace:
    """`build_decoder`'s arguments at `main`'s defaults, with `kw` set."""
    args = vars(get_parser().parse_args(['--model_dir', '']))
    args.update(kw)
    return types.SimpleNamespace(**args)


def decode_utt(decoder, wav_path, simulate_streaming, interval_ms):
    """-> (text, audio seconds, decode seconds)."""
    from wenet_tpu_torch.dataset.audio import read_audio
    pcm, rate = read_audio(wav_path)
    pcm = pcm[0]  # the first channel
    wave_dur = len(pcm) / rate
    samples_per_chunk = int(rate * interval_ms / 1000)
    decoder.reset()
    # time the decode work only, not the simulated real-time sleeps
    dt = 0.0
    for i in range(0, len(pcm), samples_per_chunk):
        if simulate_streaming:
            time.sleep(interval_ms / 1000.0)
        t0 = time.perf_counter()
        decoder.accept_waveform(pcm[i:i + samples_per_chunk])
        decoder.decode()
        dt += time.perf_counter() - t0
    t0 = time.perf_counter()
    decoder.set_input_finished()
    decoder.decode()
    decoder.rescoring()
    dt += time.perf_counter() - t0
    text = decoder.result[0].sentence if decoder.result else ''
    return text, wave_dur, dt


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument('--model_dir', required=True)
    p.add_argument('--wav_path')
    p.add_argument('--wav_scp')
    p.add_argument('--result_file')
    p.add_argument('--chunk_size', type=int, default=16)
    p.add_argument('--num_left_chunks', type=int, default=-1)
    p.add_argument('--beam_size', type=int, default=10)
    p.add_argument('--ctc_weight', type=float, default=0.5)
    p.add_argument('--reverse_weight', type=float, default=0.0)
    p.add_argument('--simulate_streaming', action='store_true')
    p.add_argument('--streaming_interval_ms', type=int, default=500)
    p.add_argument('--lm_path', default='')
    p.add_argument('--lm_weight', type=float, default=0.5)
    p.add_argument('--fst_path', default='')
    p.add_argument('--dict_path', default='')
    p.add_argument('--no_lowercase', action='store_true')
    p.add_argument('--device', default='cuda')
    return p


def main(argv=None):
    args = get_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    utts = []
    if args.wav_path:
        utts.append(('utt', args.wav_path))
    if args.wav_scp:
        with open(args.wav_scp, encoding='utf-8') as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    utts.append((parts[0], parts[1]))
    if not utts:
        raise SystemExit('need --wav_path or --wav_scp')

    decoder = build_decoder(args)
    out = open(args.result_file, 'w', encoding='utf-8') \
        if args.result_file else None
    total_audio = total_time = 0.0
    try:
        for key, path in utts:
            text, dur, dt = decode_utt(decoder, path,
                                       args.simulate_streaming,
                                       args.streaming_interval_ms)
            total_audio += dur
            total_time += dt
            logger.info('%s %s (dur %.2fs decode %.3fs)', key, text, dur, dt)
            if out:
                out.write(f'{key} {text}\n')
    finally:
        if out:
            out.close()
    logger.info('decoded %.2fs audio in %.3fs, RTF %.4f', total_audio,
                total_time, total_time / max(total_audio, 1e-9))


if __name__ == '__main__':
    main()
