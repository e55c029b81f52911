"""Check transcripts against audio by CTC forced alignment.  Counterpart
of wenet_tpu/bin/label_checker.py, on --device (default cuda):

    python -m wenet_tpu_torch.bin.label_checker --model_dir exp/u2pp \\
        --wav_scp data/test/wav.scp --text data/test/text \\
        --result_file check.txt

For each utterance with a transcript: the host fbank, the encoder and the
CTC log-probs on the device, the transcript force-aligned to them
(`utils/ctc_utils.force_align`); its score is the mean negative log-prob
along the alignment, and above --is_penalty the utterance is SUSPICIOUS.
A transcript of no token, or too long for the frames (2 L + 1 > T), is
TOO_SHORT.  The greedy hypothesis is printed beside the reference."""

import argparse
import logging

import numpy as np
import torch

logger = logging.getLogger(__name__)


def main(argv=None):
    """Check and write -> the report lines."""
    p = argparse.ArgumentParser()
    p.add_argument('--model_dir', required=True)
    p.add_argument('--wav_scp', required=True)
    p.add_argument('--text', required=True)
    p.add_argument('--result_file', default='')
    p.add_argument('--is_penalty', type=float, default=3.0,
                   help='flag threshold: -score/len above this is '
                        'suspicious')
    p.add_argument('--device', default='cuda')
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from wenet_tpu_torch.dataset.audio import read_wav
    from wenet_tpu_torch.ops.fbank import compute_fbank_np
    from wenet_tpu_torch.runtime.feature_pipeline import (
        FeaturePipelineConfig)
    from wenet_tpu_torch.utils.checkpoint import load_model_dir
    from wenet_tpu_torch.utils.ctc_utils import (force_align,
                                                 remove_duplicates_and_blank)
    model, configs, tokenizer = load_model_dir(args.model_dir, args.device)
    num_mel = FeaturePipelineConfig.from_configs(configs).num_mel_bins

    texts = {}
    with open(args.text, encoding='utf-8') as f:
        for line in f:
            parts = line.strip().split(None, 1)
            if len(parts) == 2:
                texts[parts[0]] = parts[1]

    lines = []
    with open(args.wav_scp, encoding='utf-8') as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2 or parts[0] not in texts:
                continue
            key, path = parts[0], parts[1]
            wav, rate = read_wav(path)
            feats = compute_fbank_np(wav[0] * (1 << 15),
                                     num_mel_bins=num_mel, sample_rate=rate)
            with torch.inference_mode():
                enc, _ = model.forward_encoder(
                    torch.as_tensor(feats, device=args.device)[None],
                    torch.tensor([feats.shape[0]], device=args.device))
                logp_dev = model.ctc_activation(enc)[0]
            logp = logp_dev.cpu().numpy()
            _, label = tokenizer.tokenize(texts[key])
            label = np.asarray(label, np.int32)
            if len(label) == 0 or len(label) * 2 + 1 > logp.shape[0]:
                status = 'TOO_SHORT'
                score = float('inf')
            else:
                ali = force_align(logp_dev, label)
                score = -float(np.mean(
                    [logp[t, u] for t, u in enumerate(ali)]))
                status = 'SUSPICIOUS' if score > args.is_penalty else 'OK'
            # repeats collapse before blanks go: [a, blank, a] is 'a a'
            greedy = remove_duplicates_and_blank(
                [int(t) for t in np.argmax(logp, -1)], blank_id=0)
            hyp_text, _ = tokenizer.detokenize(greedy)
            msg = f'{key} {status} score={score:.3f} ref={texts[key]} ' \
                  f'hyp={hyp_text}'
            logger.info(msg)
            lines.append(msg)
    if args.result_file:
        with open(args.result_file, 'w', encoding='utf-8') as out:
            out.writelines(m + '\n' for m in lines)
    return lines


if __name__ == '__main__':
    main()
