"""The data pipeline from train.yaml's `dataset_conf`.  Counterpart of
wenet_tpu/dataset/dataset.py: the same stages in the same order, `raw`
(JSON lines) and `shard` (tar) lists, `static`, `bucket` and `dynamic`
batches, `pad_conf` and `speaker_conf`.  With `on_device_frontend` a
batch's 'feats' are the waveforms, (B, S, 1) with lengths in samples
(`processor.raw_wav_feats`), and the host computes no features and no
SpecAugment, SpecSub or SpecTrim: the train step does (utils/
train_utils.py `make_frontend`).

Randomness: every random stage (the list shuffle, the speed choice,
dither, SpecAugment, SpecSub, SpecTrim and the sample shuffle) draws
from its own numpy Generator, made at the start of each pass from
(seed, epoch, stage).  So a seed fixes each epoch's batches, `set_epoch`
gives each epoch its own, and the list shuffle before `shard` is the same
on every host of a run.
"""

from functools import partial
from typing import Optional

import numpy as np

from wenet_tpu_torch.dataset import processor
from wenet_tpu_torch.dataset.datapipes import (DataPipe, parse_json_line,
                                               tar_source, text_line_source)
from wenet_tpu_torch.text.base_tokenizer import BaseTokenizer
from wenet_tpu_torch.utils.file_utils import read_symbol_table

# the stream of each random stage: (seed, epoch, stage) seeds its generator
_LIST_SHUFFLE, _SPEED, _DITHER, _SPEC_AUG, _SPEC_SUB, _SPEC_TRIM, \
    _SHUFFLE = range(7)


class Dataset(DataPipe):
    """A re-iterable pipeline of padded numpy batch dicts (`padding`).

    num_shards / shard_id partition the source lists between hosts and
    workers (partition=False replicates them, as cv does).  The seed is
    `seed`, else `conf['seed']`, else 777."""

    def __init__(self, data_type: str, data_list_file,
                 tokenizer: Optional[BaseTokenizer] = None,
                 conf: Optional[dict] = None, partition: bool = True,
                 num_shards: int = 1, shard_id: int = 0,
                 seed: Optional[int] = None):
        if conf is None:
            raise ValueError('Dataset needs a dataset_conf')
        if data_type not in ('raw', 'shard'):
            raise ValueError(f'data_type {data_type!r}: raw or shard')
        self.seed = conf.get('seed', 777) if seed is None else seed
        self.epoch = 0
        self.source = self._build(data_type, data_list_file, tokenizer,
                                  conf, partition, num_shards, shard_id)

    def set_epoch(self, epoch: int) -> None:
        """Draw the next passes as epoch `epoch`."""
        self.epoch = epoch

    def _rng(self, stage: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, self.epoch, stage])

    def _build(self, data_type, data_list_file, tokenizer, conf, partition,
               num_shards, shard_id) -> DataPipe:
        files = (data_list_file if isinstance(data_list_file, list) else
                 [data_list_file])
        dataset = text_line_source(files)
        if conf.get('list_shuffle', True):
            # the whole list by default; (seed, epoch) are the same on
            # every host, so the shards below partition the list
            dataset = dataset.shuffle(
                partial(self._rng, _LIST_SHUFFLE),
                conf.get('list_shuffle_conf', {}).get('shuffle_size',
                                                      1 << 62))
        dataset = dataset.repeat(conf.get('cycle', 1))
        dataset = dataset.shard(num_shards, shard_id, partition)
        if data_type == 'raw':
            dataset = dataset.map(parse_json_line)
        else:
            dataset = tar_source(dataset)
        dataset = dataset.map_ignore_error(processor.decode_wav)
        dataset = dataset.map(
            partial(processor.single_channel,
                    **conf.get('singal_channel_conf', {})))

        speaker_conf = conf.get('speaker_conf', None)
        if speaker_conf is not None:
            table = read_symbol_table(speaker_conf['speaker_table_path'])

            def parse_speaker(sample):
                # unknown speakers -> 0 (-1 would gather the last row)
                sample['speaker'] = table.get(sample.get('speaker'), 0)
                return sample

            dataset = dataset.map(parse_speaker)

        if tokenizer is not None:
            dataset = dataset.map(
                partial(processor.tokenize, tokenizer=tokenizer))
        dataset = dataset.filter(
            partial(processor.filter, **conf.get('filter_conf', {})))
        dataset = dataset.map(
            partial(processor.resample, **conf.get('resample_conf', {})))
        if conf.get('speed_perturb', False):
            dataset = dataset.map_random(processor.speed_perturb,
                                         partial(self._rng, _SPEED))

        on_device_frontend = conf.get('on_device_frontend', False)
        feats_type = conf.get('feats_type', 'fbank')
        features = {'fbank': (processor.compute_fbank, 'fbank_conf'),
                    'mfcc': (processor.compute_mfcc, 'mfcc_conf')}
        if feats_type not in (*features, 'log_mel_spectrogram'):
            raise ValueError(f'feats_type {feats_type!r}')
        if on_device_frontend:
            # fbank and the augmentations run in the train step
            dataset = dataset.map(processor.raw_wav_feats)
        elif feats_type in features:
            fn, key = features[feats_type]
            dataset = dataset.map_random(fn, partial(self._rng, _DITHER),
                                         **conf.get(key, {}))
        else:
            dataset = dataset.map(
                partial(processor.compute_log_mel_spectrogram,
                        **conf.get('log_mel_spectrogram_conf', {})))

        for flag, default, fn, stage in (
                ('spec_aug', True, processor.spec_aug, _SPEC_AUG),
                ('spec_sub', False, processor.spec_sub, _SPEC_SUB),
                ('spec_trim', False, processor.spec_trim, _SPEC_TRIM)):
            if conf.get(flag, default) and not on_device_frontend:
                dataset = dataset.map_random(fn, partial(self._rng, stage),
                                             **conf.get(f'{flag}_conf', {}))

        dataset = dataset.map(
            partial(processor.detect_language,
                    **conf.get('language_conf',
                               {'limited_langs': ['zh', 'en']})))
        dataset = dataset.map(processor.detect_task)

        if conf.get('shuffle', True):
            dataset = dataset.shuffle(
                partial(self._rng, _SHUFFLE),
                conf.get('shuffle_conf', {}).get('shuffle_size', 1500))
        if conf.get('sort', True):
            dataset = dataset.sort(
                conf.get('sort_conf', {}).get('sort_size', 500),
                key_func=processor.sort_by_feats)

        pad_conf = conf.get('pad_conf', {})
        pad = partial(processor.padding,
                      pad_to_multiple=pad_conf.get('pad_to_multiple', 1),
                      label_pad_to_multiple=pad_conf.get(
                          'label_pad_to_multiple', 1))
        batch_conf = conf.get('batch_conf', {})
        batch_type = batch_conf.get('batch_type', 'static')
        if batch_type == 'static':
            dataset = dataset.batch(batch_conf.get('batch_size', 16),
                                    wrapper=pad)
        elif batch_type == 'bucket':
            dataset = dataset.bucket_by_sequence_length(
                processor.feats_length_fn,
                batch_conf['bucket_boundaries'],
                batch_conf['bucket_batch_sizes']).map(pad)
        elif batch_type == 'dynamic':
            dataset = dataset.dynamic_batch(
                processor.DynamicBatchWindow(
                    batch_conf.get('max_frames_in_batch', 12000)),
                wrapper=pad)
        else:
            raise ValueError(f'batch_type {batch_type!r}')
        prefetch = conf.get('prefetch', 2)
        if prefetch:
            dataset = dataset.prefetch(prefetch)
        return dataset
