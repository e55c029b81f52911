"""The `wenet` command: transcribe (or force-align) one audio file.
Counterpart of wenet_tpu/cli/transcribe.py, on --device (default cuda):

    python -m wenet_tpu_torch.cli.transcribe a.wav -m exp/u2pp -t
    python -m wenet_tpu_torch.cli.transcribe a.wav -m exp/u2pp --align \\
        --label '...'

A model directory (-m) is read where it lies; a language (-l) or a name
looks under $WENET_TPU_MODEL_HOME (cli/hub.py: no download)."""

import argparse


def get_args(argv=None):
    parser = argparse.ArgumentParser(description='transcribe audio')
    parser.add_argument('audio_file', help='audio file to transcribe')
    parser.add_argument('-l', '--language',
                        choices=['chinese', 'english'], default=None)
    parser.add_argument('-m', '--model_dir', default=None,
                        help='model directory (train.yaml + final ckpt)')
    parser.add_argument('-t', '--show_tokens_info', action='store_true')
    parser.add_argument('--beam', type=int, default=5)
    parser.add_argument('--context_path', default=None)
    parser.add_argument('--context_score', type=float, default=6.0)
    parser.add_argument('--align', action='store_true',
                        help='force align the input label to the audio')
    parser.add_argument('--label', type=str, default=None,
                        help='label text for --align')
    parser.add_argument('--punc', action='store_true',
                        help='punctuation restoration (needs a punc '
                             'model dir + jieba)')
    parser.add_argument('--pm', type=str, default=None,
                        help='punc model dir for --punc')
    parser.add_argument('--device', default='cuda')
    return parser.parse_args(argv)


def main(argv=None):
    """Print and return the result dict."""
    args = get_args(argv)
    from wenet_tpu_torch.cli.model import load_model
    model = load_model(args.language, args.model_dir, beam=args.beam,
                       context_path=args.context_path,
                       context_score=args.context_score, device=args.device)
    if args.align:
        if not args.label:
            raise SystemExit('--align needs --label')
        result = model.align(args.audio_file, args.label)
    else:
        result = model.transcribe(args.audio_file,
                                  tokens_info=args.show_tokens_info)
        if args.punc:
            from wenet_tpu_torch.cli.punc_model import load_punc_model
            punc = load_punc_model(args.pm)
            result['text_with_punc'] = punc(result['text'])
    print(result)
    return result


if __name__ == '__main__':
    main()
