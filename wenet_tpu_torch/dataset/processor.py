"""Per-sample processors of the host data pipeline, with numpy.
Counterpart of wenet_tpu/dataset/processor.py: decode, resample, speed
perturb, features (fbank, w2v-bert fbank, MFCC, whisper log-mel), tokens,
filters, SpecAugment / SpecSub / SpecTrim, and the batch collate with
bucketed padding.

The random processors take `rng`, a numpy Generator (the Dataset gives
each its own, seeded from the run's seed and the epoch), where the JAX
package draws from the global `random` and `np.random`.
"""

from typing import Dict, List, Optional

import numpy as np

from wenet_tpu_torch.dataset.audio import (read_audio, read_wav, wav_info,
                                           resample as _resample)
from wenet_tpu_torch.dataset.audio import speed_perturb as _speed
from wenet_tpu_torch.ops.fbank import (compute_fbank_np,
                                       compute_log_mel_spectrogram_np,
                                       compute_mfcc_np)


class WenetTpuError(Exception):
    pass


def decode_wav(sample: dict) -> dict:
    """Reads sample['wav'] (a path) or sample['wav_bytes'] (from a tar
    shard), RIFF wav or FLAC by their first bytes; honors start / end
    seconds."""
    if 'wav_bytes' in sample:
        fmt = sample.get('wav_format', 'wav')
        if fmt not in ('wav', 'flac'):
            raise WenetTpuError(f'unsupported codec {fmt} '
                                '(no mp3/opus decoder in base image)')
        wav, rate = read_audio(sample.pop('wav_bytes'))
    else:
        path = sample['wav']
        if 'start' in sample:
            with open(path, 'rb') as f:
                is_flac = f.read(4) == b'fLaC'
            if is_flac:
                # no cheap frame seek in flac: decode, then slice
                wav, rate = read_audio(path)
                s = int(sample['start'] * rate)
                e = int(sample['end'] * rate)
                wav = wav[:, s:e]
            else:
                rate0, _, _ = wav_info(path)
                start = int(sample['start'] * rate0)
                end = int(sample['end'] * rate0)
                wav, rate = read_wav(path, start, end - start)
        else:
            wav, rate = read_audio(path)
    sample['wav'] = wav  # (C, S) float32
    sample['sample_rate'] = rate
    return sample


def single_channel(sample: dict, channel: int = 0) -> dict:
    """Keep one channel of a multi-channel waveform."""
    if sample['wav'].shape[0] > 1:
        sample['wav'] = sample['wav'][channel:channel + 1]
    return sample


def resample(sample: dict, resample_rate: int = 16000) -> dict:
    """Resample to `resample_rate` where the sample differs."""
    if sample['sample_rate'] != resample_rate:
        sample['wav'] = _resample(sample['wav'], sample['sample_rate'],
                                  resample_rate)
        sample['sample_rate'] = resample_rate
    return sample


def speed_perturb(sample: dict, speeds: Optional[List[float]] = None,
                  *, rng: np.random.Generator) -> dict:
    """sox's speed effect at a speed drawn from `speeds`."""
    if speeds is None:
        speeds = [0.9, 1.0, 1.1]
    speed = float(speeds[rng.integers(len(speeds))])
    if speed != 1.0:
        sample['wav'] = _speed(sample['wav'], sample['sample_rate'],
                               speed)
    return sample


def _dither_rng(dither: float, rng):
    if dither != 0.0 and rng is None:
        raise ValueError('dither needs a generator (rng=)')
    return rng


def compute_fbank(sample: dict, num_mel_bins: int = 23,
                  frame_length: int = 25, frame_shift: int = 10,
                  dither: float = 0.0, *,
                  rng: Optional[np.random.Generator] = None) -> dict:
    """Kaldi fbank of the waveform scaled by 1 << 15; dither draws from
    `rng`."""
    wav = sample['wav'][0] * (1 << 15)
    sample['feat'] = compute_fbank_np(
        wav, num_mel_bins=num_mel_bins, frame_length_ms=frame_length,
        frame_shift_ms=frame_shift, dither=dither,
        sample_rate=sample['sample_rate'], rng=_dither_rng(dither, rng))
    return sample


def raw_wav_feats(sample: dict) -> dict:
    """The on-device front end's stage: the waveform itself as the
    'feat', (S, 1) float32, so that sorting, batching and padding run
    unchanged (a dynamic batch counts its samples as frames, as the JAX
    package's does); the train step computes fbank and SpecAugment on
    the card (utils/train_utils.py `make_frontend`)."""
    sample['feat'] = np.asarray(sample['wav'][0], np.float32)[:, None]
    return sample


def compute_w2vbert_fbank(sample: dict, num_mel_bins: int = 23,
                          frame_length: int = 25, frame_shift: int = 10,
                          dither: float = 0.0, *,
                          rng: Optional[np.random.Generator] = None
                          ) -> dict:
    """fbank with utterance-level mean and variance normalization."""
    sample = compute_fbank(sample, num_mel_bins, frame_length,
                           frame_shift, dither, rng=rng)
    mat = sample['feat']
    std, mean = mat.std(0), mat.mean(0)
    sample['feat'] = (mat - mean) / (std + 1e-5)
    return sample


def compute_mfcc(sample: dict, num_mel_bins: int = 23,
                 frame_length: int = 25, frame_shift: int = 10,
                 dither: float = 0.0, num_ceps: int = 40,
                 high_freq: float = 0.0, low_freq: float = 20.0, *,
                 rng: Optional[np.random.Generator] = None) -> dict:
    """Kaldi MFCC of the waveform scaled by 1 << 15."""
    wav = sample['wav'][0] * (1 << 15)
    sample['feat'] = compute_mfcc_np(
        wav, num_mel_bins=num_mel_bins, num_ceps=num_ceps,
        frame_length_ms=frame_length, frame_shift_ms=frame_shift,
        dither=dither, sample_rate=sample['sample_rate'],
        low_freq=low_freq, high_freq=high_freq,
        rng=_dither_rng(dither, rng))
    return sample


def compute_log_mel_spectrogram(sample: dict, n_fft: int = 400,
                                hop_length: int = 160,
                                num_mel_bins: int = 80,
                                padding: int = 0,
                                pad_or_trim: bool = False,
                                max_duration: int = 30) -> dict:
    """Whisper's log-mel front end."""
    wav = sample['wav'][0]
    rate = sample['sample_rate']
    if pad_or_trim:
        length = max_duration * rate
        if wav.shape[0] >= length:
            wav = wav[:length]
        else:
            wav = np.pad(wav, (0, length - wav.shape[0]))
    sample['feat'] = compute_log_mel_spectrogram_np(
        wav, n_fft=n_fft, hop_length=hop_length,
        num_mel_bins=num_mel_bins, sample_rate=rate, padding=padding)
    return sample


def tokenize(sample: dict, tokenizer) -> dict:
    """Text -> tokens and label ids."""
    tokens, label = tokenizer.tokenize(sample['txt'])
    sample['tokens'] = tokens
    sample['label'] = label
    return sample


def detect_language(sample: dict, limited_langs: List[str]) -> dict:
    """langid restricted to `limited_langs` where it is installed,
    otherwise a CJK-ratio heuristic that never leaves `limited_langs` (a
    wrong <|lang|> token corrupts whisper-style targets)."""
    txt = sample.get('txt', '')
    try:
        import langid
        langid.set_languages(limited_langs)
        sample['lang'] = langid.classify(txt)[0]
        return sample
    except Exception:  # noqa: BLE001 - absent OR stubbed langid
        pass
    cjk = sum('一' <= ch <= '鿿' for ch in txt)
    guess = 'zh' if cjk > len(txt) // 4 else 'en'
    if guess not in limited_langs:
        # heuristic can't separate the configured languages: take the
        # first (the reference would defer to langid here)
        guess = limited_langs[0] if limited_langs else 'en'
    sample['lang'] = guess
    return sample


def detect_task(sample: dict) -> dict:
    """Default task: transcribe."""
    sample['task'] = sample.get('task', 'transcribe')
    return sample


def filter(sample: dict, max_length: int = 10240, min_length: int = 10,
           token_max_length: int = 200, token_min_length: int = 1,
           min_output_input_ratio: float = 0.0005,
           max_output_input_ratio: float = 1.0) -> bool:
    """Keep samples whose length (in 10 ms frames), label length and
    their ratio lie within the bounds."""
    num_frames = sample['wav'].shape[1] / sample['sample_rate'] * 100
    if num_frames < min_length or num_frames > max_length:
        return False
    if 'label' in sample:
        n = len(sample['label'])
        if n < token_min_length or n > token_max_length:
            return False
        if num_frames != 0:
            r = n / num_frames
            if r < min_output_input_ratio or r > max_output_input_ratio:
                return False
    return True


def spec_aug(sample: dict, num_t_mask: int = 2, num_f_mask: int = 2,
             max_t: int = 50, max_f: int = 10, max_w: int = 80, *,
             rng: np.random.Generator) -> dict:
    """SpecAugment: zero `num_t_mask` time and `num_f_mask` frequency
    bands of up to `max_t` / `max_f` (`max_w`, time warp, is not used)."""
    y = np.array(sample['feat'])
    max_frames, max_freq = y.shape
    for _ in range(num_t_mask):
        start = int(rng.integers(0, max_frames))
        length = int(rng.integers(1, max_t + 1))
        y[start:start + length, :] = 0
    for _ in range(num_f_mask):
        start = int(rng.integers(0, max_freq))
        length = int(rng.integers(1, max_f + 1))
        y[:, start:start + length] = 0
    sample['feat'] = y
    return sample


def spec_sub(sample: dict, max_t: int = 20, num_t_sub: int = 3, *,
             rng: np.random.Generator) -> dict:
    """U2++'s SpecSub: `num_t_sub` bands of up to `max_t` frames replaced
    by the frames some distance before them."""
    x = sample['feat']
    y = np.array(x)
    max_frames = y.shape[0]
    for _ in range(num_t_sub):
        start = int(rng.integers(0, max_frames))
        length = int(rng.integers(1, max_t + 1))
        end = min(max_frames, start + length)
        pos = int(rng.integers(0, start + 1))
        y[start:end, :] = x[start - pos:end - pos, :]
    sample['feat'] = y
    return sample


def spec_trim(sample: dict, max_t: int = 20, *,
               rng: np.random.Generator) -> dict:
    """TrimTail: drop up to `max_t` frames from the end (when that is
    less than half the sample)."""
    x = sample['feat']
    max_frames = x.shape[0]
    length = int(rng.integers(1, max_t + 1))
    if length < max_frames / 2:
        sample['feat'] = np.array(x[:max_frames - length])
    return sample


def sort_by_feats(sample: dict) -> int:
    return sample['feat'].shape[0]


def feats_length_fn(sample: dict) -> int:
    return sample['feat'].shape[0]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def padding(data: List[dict], pad_to_multiple: int = 1,
            label_pad_to_multiple: int = 1) -> Dict[str, np.ndarray]:
    """Batch collate, sorted by length, longest first.  pad_to_multiple
    (label_pad_to_multiple) rounds the padded frames (labels) up to a
    multiple, so that a bounded set of shapes reaches the device."""
    feats_length = np.asarray([x['feat'].shape[0] for x in data],
                              np.int32)
    order = np.argsort(-feats_length, kind='stable')
    data = [data[i] for i in order]
    feats_lengths = np.asarray([x['feat'].shape[0] for x in data],
                               np.int32)
    label_lengths = np.asarray(
        [len(x.get('label', ())) for x in data], np.int32)
    wav_lengths = np.asarray([x['wav'].shape[1] for x in data], np.int32)

    T = _round_up(int(feats_lengths.max()), pad_to_multiple)
    U = max(_round_up(int(label_lengths.max()), label_pad_to_multiple), 1)
    W = int(wav_lengths.max())
    dim = data[0]['feat'].shape[1]
    feats = np.zeros((len(data), T, dim), np.float32)
    labels = np.full((len(data), U), -1, np.int64)
    wavs = np.zeros((len(data), W), np.float32)
    for i, x in enumerate(data):
        feats[i, :x['feat'].shape[0]] = x['feat']
        if 'label' in x:
            labels[i, :len(x['label'])] = x['label']
        wavs[i, :x['wav'].shape[1]] = x['wav'][0]
    batch = {
        'keys': [x.get('key') for x in data],
        'feats': feats,
        'target': labels,
        'feats_lengths': feats_lengths,
        'target_lengths': label_lengths,
        'pcm': wavs,
        'pcm_length': wav_lengths,
        'langs': [x.get('lang', 'zh') for x in data],
        'tasks': [x.get('task', 'transcribe') for x in data],
    }
    if 'speaker' in data[0]:
        batch['speaker'] = np.asarray([x['speaker'] for x in data],
                                      np.int32)
    return batch


class DynamicBatchWindow:
    """Closes a batch before the sample that would take its padded
    frames (longest x count) past `max_frames_in_batch`."""

    def __init__(self, max_frames_in_batch: int = 12000):
        self.longest_frames = 0
        self.max_frames_in_batch = max_frames_in_batch

    def __call__(self, sample, buffer_size):
        new = sample['feat'].shape[0]
        self.longest_frames = max(self.longest_frames, new)
        if self.longest_frames * (buffer_size + 1) > \
                self.max_frames_in_batch:
            self.longest_frames = new
            return True
        return False
