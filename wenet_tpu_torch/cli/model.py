"""The Python API: `load_model(model_dir=...).transcribe(wav)` and
`.align(wav, label)`.  Counterpart of wenet_tpu/cli/model.py, on `device`
('cuda' unless the caller asks for the CPU): the host fbank (or whisper's
log-mel) of the file, `AsrRunner.decode` in the model's default mode
(biased by a context file when given), and CTC forced alignment."""

import os
from typing import Optional

import numpy as np
import torch

from wenet_tpu_torch.cli.hub import Hub
from wenet_tpu_torch.models.runner import AsrRunner
from wenet_tpu_torch.utils.checkpoint import load_model_dir


def _make_compute_feature(conf: dict):
    """wav path -> (T, F) features, from train.yaml's dataset_conf."""
    from wenet_tpu_torch.dataset.audio import read_wav, resample
    from wenet_tpu_torch.ops.fbank import (compute_fbank_np,
                                           compute_log_mel_spectrogram_np)
    feats_type = conf.get('feats_type', 'fbank')

    def compute(wav_path):
        wav, sr = read_wav(wav_path)
        if sr != 16000:
            wav = resample(wav, sr, 16000)
        if feats_type == 'log_mel_spectrogram':
            c = conf.get('log_mel_spectrogram_conf', {})
            return compute_log_mel_spectrogram_np(
                wav[0], num_mel_bins=c.get('num_mel_bins', 80))
        c = conf.get('fbank_conf', {})
        return compute_fbank_np(
            wav[0] * (1 << 15),
            num_mel_bins=c.get('num_mel_bins', 80),
            frame_length_ms=c.get('frame_length', 25),
            frame_shift_ms=c.get('frame_shift', 10),
            dither=0.0, sample_rate=16000)

    return compute


class Model:

    def __init__(self, model_dir: str, beam: int = 5,
                 context_path: Optional[str] = None,
                 context_score: float = 6.0, device='cuda'):
        model, configs, self.tokenizer = load_model_dir(model_dir, device)
        self.runner = AsrRunner(model, device)
        self.compute_feature = _make_compute_feature(
            configs.get('dataset_conf', {}))
        self.beam = beam
        self.context_graph = None
        if context_path is not None:
            from wenet_tpu_torch.utils.context_graph import ContextGraph
            self.context_graph = ContextGraph(
                context_path, self.tokenizer.symbol_table,
                context_score=context_score)

    def transcribe(self, audio_file: str, tokens_info: bool = False):
        """-> {'text'} and with `tokens_info` {'tokens': [{token, start
        (seconds), confidence}]}."""
        method = self.runner.model.default_decode_method
        feats = self.compute_feature(audio_file)
        res = self.runner.decode(
            [method], feats[None], [feats.shape[0]], beam_size=self.beam,
            context_graph=self.context_graph)[method][0]
        text, tokens = self.tokenizer.detokenize([int(t)
                                                  for t in res.tokens])
        result = {'text': text}
        if tokens_info:
            times = res.times or [0] * len(tokens)
            confs = res.tokens_confidence or [1.0] * len(tokens)
            # a frame is 10 ms times the encoder's subsampling
            period = 0.01 * self.runner.model.encoder.subsampling_rate
            result['tokens'] = [{'token': t, 'start': round(tm * period, 3),
                                 'confidence': round(float(c), 3)}
                                for t, tm, c in zip(tokens, times, confs)]
        return result

    def align(self, audio_file: str, label: str):
        """CTC forced alignment of `label` to the audio -> {'text',
        'tokens': [{token, start}]}, one entry per label token (a repeated
        token gets its own span)."""
        from wenet_tpu_torch.utils.ctc_utils import force_align
        feats = self.compute_feature(audio_file)
        model = self.runner.model
        device = self.runner.device
        with torch.inference_mode():
            enc, _ = model.forward_encoder(
                torch.as_tensor(feats, device=device)[None],
                torch.tensor([feats.shape[0]], device=device))
            logp = model.ctc_logprobs(enc)[0]
            _, ids = self.tokenizer.tokenize(label)
            ali = force_align(logp, np.asarray(ids, np.int32))
        sub = model.encoder.subsampling_rate
        tokens = self.tokenizer.detokenize(list(ids))[1]
        # each new non-blank run that is the next expected token starts
        # that occurrence
        info = []
        expected = [int(t) for t in ids]
        idx = 0
        prev = -1
        for t, a in enumerate(ali):
            if a != 0 and a != prev and idx < len(expected) \
                    and a == expected[idx]:
                info.append({'token': tokens[idx],
                             'start': round(t * 0.01 * sub, 3)})
                idx += 1
            prev = a
        while idx < len(expected):  # degenerate alignments
            info.append({'token': tokens[idx],
                         'start': info[-1]['start'] if info else 0.0})
            idx += 1
        return {'text': label, 'tokens': info}

    def transcribe_wav(self, audio_file, **kw):
        return self.transcribe(audio_file, **kw)


def load_model(language: Optional[str] = None,
               model_dir: Optional[str] = None,
               gpu: int = -1,
               beam: int = 5,
               context_path: Optional[str] = None,
               context_score: float = 6.0,
               device='cuda') -> Model:
    """A model directory (`model_dir`, or by `language` through the hub) on
    `device`.  `gpu` is the reference API's and is not read."""
    if model_dir is None:
        if language is None:
            raise ValueError('load_model needs a language or a model_dir')
        model_dir = Hub.get_model_by_lang(language)
    elif not os.path.isdir(model_dir):
        model_dir = Hub.download_model(model_dir)
    return Model(model_dir, beam, context_path, context_score, device)
