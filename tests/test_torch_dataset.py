"""The port's data pipeline against the JAX package's, on wavs, FLACs, tars,
arks and stats files the tests write: audio IO, resampling and the speed
perturbation (exact), FLAC (exact PCM), MFCC (atol 1e-4), kaldi_io and
load_cmvn (exact), and `Dataset` batches equal key for key and array for
array with augmentation off (raw and shard lists; static, bucket and
dynamic batches; pad_to_multiple, filters, speaker_conf).  The random
stages draw from seeded numpy Generators in the port and from the global
`random` / `np.random` in the JAX package, so they are held to their
statistics.  Also the prefetch thread's two hang cases and each epoch's
own order."""

import json
import random
import tarfile
import threading
import time

import numpy as np
import pytest

SYMS = {'<blank>': 0, '<unk>': 1, '你': 2, '好': 3, '世': 4, '界': 5,
        'a': 6, 'b': 7, '<sos/eos>': 8}
# (seconds, rate, channels, text, speaker): one 8 kHz and one stereo
# utterance, one too short for the filter and one with too many tokens
UTTS = [(0.9, 16000, 1, '你好', 'spk1'), (1.3, 16000, 1, '世界a', 'spk2'),
        (0.6, 8000, 1, 'ab', 'spk1'), (1.7, 16000, 2, '你好世界', 'spk3'),
        (0.05, 16000, 1, 'a', 'spk2'), (1.1, 16000, 1, 'b' * 60, 'spk1'),
        (0.75, 16000, 1, '好a', 'nobody'), (1.45, 22050, 1, '界b你', 'spk3')]


def _speech(rng, n):
    t = np.arange(n) / 16000
    x = 0.1 * rng.randn(n) + 0.2 * np.sin(2 * np.pi * 300 * t)
    return (np.round(np.clip(x, -1, 1) * 32767) / 32768).astype(np.float32)


@pytest.fixture(scope='module')
def data_dir(tmp_path_factory):
    from wenet_tpu_torch.dataset.audio import write_wav
    d = tmp_path_factory.mktemp('torch_data')
    rng = np.random.RandomState(0)
    entries = []
    for i, (sec, sr, ch, txt, spk) in enumerate(UTTS):
        wav = np.stack([_speech(rng, int(sec * sr)) for _ in range(ch)])
        path = d / f'utt{i}.wav'
        write_wav(str(path), wav, sr)
        entries.append({'key': f'utt{i}', 'wav': str(path), 'txt': txt})
    with open(d / 'data.list', 'w', encoding='utf8') as f:
        for e in entries:
            f.write(json.dumps(e, ensure_ascii=False) + '\n')
    with open(d / 'speaker.list', 'w', encoding='utf8') as f:
        for e, utt in zip(entries, UTTS):
            f.write(json.dumps(dict(e, speaker=utt[4]),
                               ensure_ascii=False) + '\n')
    shards = []
    for s in range(2):
        tar_path = d / f'shard{s}.tar'
        with tarfile.open(tar_path, 'w') as tar:
            for e in entries[s::2]:
                tar.add(e['wav'], arcname=e['key'] + '.wav')
                txt = d / 'tmp.txt'
                txt.write_text(e['txt'], encoding='utf8')
                tar.add(str(txt), arcname=e['key'] + '.txt')
        shards.append(str(tar_path))
    (d / 'shard.list').write_text('\n'.join(shards) + '\n')
    (d / 'spk.txt').write_text('spk1 1\nspk2 2\nspk3 3\n')
    return d


def _conf(batch_conf, **kw):
    conf = {'list_shuffle': False, 'shuffle': False, 'sort': True,
            'spec_aug': False,
            'filter_conf': {'max_length': 2000, 'min_length': 10,
                            'token_max_length': 40},
            'resample_conf': {'resample_rate': 16000},
            'fbank_conf': {'num_mel_bins': 40, 'dither': 0.0},
            'batch_conf': batch_conf,
            'pad_conf': {'pad_to_multiple': 16, 'label_pad_to_multiple': 4}}
    conf.update(kw)
    return conf


def _batches(pkg, data_type, path, conf):
    if pkg == 'jax':
        from wenet_tpu.dataset.dataset import Dataset
        from wenet_tpu.text.char_tokenizer import CharTokenizer
    else:
        from wenet_tpu_torch.dataset.dataset import Dataset
        from wenet_tpu_torch.text.char_tokenizer import CharTokenizer
    return list(Dataset(data_type, str(path), CharTokenizer(dict(SYMS)),
                        dict(conf)))


def _assert_same_batches(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k


BATCHES = {
    'static': {'batch_type': 'static', 'batch_size': 2},
    'bucket': {'batch_type': 'bucket', 'bucket_boundaries': [100, 150],
               'bucket_batch_sizes': [2, 2, 1]},
    'dynamic': {'batch_type': 'dynamic', 'max_frames_in_batch': 400},
}


@pytest.mark.parametrize('data_type', ['raw', 'shard'])
@pytest.mark.parametrize('batch_type', sorted(BATCHES))
def test_dataset_batches_equal_jax(data_dir, data_type, batch_type):
    path = data_dir / ('data.list' if data_type == 'raw' else 'shard.list')
    conf = _conf(BATCHES[batch_type])
    got = _batches('port', data_type, path, conf)
    _assert_same_batches(got, _batches('jax', data_type, path, conf))
    keys = {k for b in got for k in b['keys']}
    # the 0.05 s and the 60-token utterances are filtered out
    assert keys == {f'utt{i}' for i in (0, 1, 2, 3, 6, 7)}
    assert all(b['feats'].shape[1] % 16 == 0 for b in got)
    assert all(b['target'].shape[1] % 4 == 0 for b in got)


def test_dataset_speakers_and_mfcc_equal_jax(data_dir):
    conf = _conf(BATCHES['static'], feats_type='mfcc',
                 mfcc_conf={'num_mel_bins': 23, 'num_ceps': 13},
                 speaker_conf={'speaker_table_path':
                               str(data_dir / 'spk.txt')})
    got = _batches('port', 'raw', data_dir / 'speaker.list', conf)
    _assert_same_batches(got, _batches('jax', 'raw',
                                       data_dir / 'speaker.list', conf))
    speakers = {k: s for b in got for k, s in zip(b['keys'],
                                                  b['speaker'])}
    assert speakers['utt6'] == 0 and speakers['utt3'] == 3
    assert got[0]['feats'].shape[2] == 13


def test_dataset_reads_flac_lists_as_wavs(data_dir, tmp_path):
    """A list of FLACs gives the batches of the same audio as wavs."""
    from test_flac import encode_flac
    from wenet_tpu_torch.dataset.audio import read_wav
    lines = []
    for line in (data_dir / 'data.list').read_text().splitlines():
        e = json.loads(line)
        wav, sr = read_wav(e['wav'])
        pcm = np.round(wav * 32768).astype(np.int64)
        n = pcm.shape[1]
        plan = [(4096, 'verbatim')] * (n // 4096)
        if n % 4096:
            plan.append((n % 4096, 'verbatim'))
        e['wav'] = str(tmp_path / (e['key'] + '.flac'))
        with open(e['wav'], 'wb') as f:
            f.write(encode_flac([list(c) for c in pcm], rate=sr,
                                frame_plan=plan))
        lines.append(json.dumps(e, ensure_ascii=False))
    (tmp_path / 'flac.list').write_text('\n'.join(lines) + '\n')
    conf = _conf(BATCHES['dynamic'])
    _assert_same_batches(_batches('port', 'raw', tmp_path / 'flac.list',
                                  conf),
                         _batches('port', 'raw', data_dir / 'data.list',
                                  conf))


def test_on_device_frontend_raises(data_dir):
    """The port took `on_device_frontend` only to raise; now its batches
    are the JAX Dataset's: (B, S, 1) waveforms, lengths in samples, the
    host augmentations skipped (spec_aug, spec_sub and spec_trim on)."""
    conf = _conf(BATCHES['static'], on_device_frontend=True, spec_aug=True,
                 spec_sub=True, spec_trim=True)
    got = _batches('port', 'raw', data_dir / 'data.list', conf)
    assert all(b['feats'].ndim == 3 and b['feats'].shape[2] == 1
               for b in got)
    _assert_same_batches(got, _batches('jax', 'raw',
                                       data_dir / 'data.list', conf))


# ---------------------------------------------------------------------------
# audio
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('start,num', [(0, -1), (1000, 4000), (5000, 99999)])
def test_read_wav_window_matches_jax(data_dir, start, num):
    from wenet_tpu.dataset import audio as J
    from wenet_tpu_torch.dataset import audio as P
    path = str(data_dir / 'utt3.wav')  # stereo
    got, rate = P.read_wav(path, start, num)
    want, jrate = J.read_wav(path, start, num)
    assert rate == jrate and got.shape[0] == 2
    np.testing.assert_array_equal(got, want)
    assert P.wav_info(path) == J.wav_info(path)


def test_read_audio_sniffs_like_jax(data_dir):
    """RIFF bytes and paths read as wavs, `fLaC` ones through the FLAC
    decoder (the encoder's PCM exactly; the JAX decoder's output where its
    library built)."""
    from test_flac import encode_flac, ref_int16
    from wenet_tpu.dataset import audio as J
    from wenet_tpu_torch.dataset import audio as P
    path = data_dir / 'utt1.wav'
    np.testing.assert_array_equal(P.read_audio(path.read_bytes())[0],
                                  J.read_audio(str(path))[0])
    pcm = ref_int16(300, seed=9, smooth=True)
    raw = encode_flac([pcm], frame_plan=[(200, 'fixed2'), (100, 'lpc2')])
    wav, rate = P.read_audio(raw)
    assert rate == 16000
    np.testing.assert_array_equal(
        np.round(wav[0] * 32768.0).astype(np.int64), pcm)
    if J._load_flac() is not None:
        np.testing.assert_array_equal(wav, J.read_audio(raw)[0])
    flac = data_dir / 'x.flac'
    flac.write_bytes(raw)
    assert P.flac_info(str(flac)) == (16000, 300, 1)
    with pytest.raises(ValueError):
        P.read_audio(b'RIFF' + bytes(40))


@pytest.mark.parametrize('mode', ['left_side', 'mid_side'])
def test_flac_stereo_is_exact(mode):
    from test_flac import encode_flac, ref_int16
    from wenet_tpu_torch.dataset.audio import read_flac
    left = ref_int16(160, seed=7, smooth=True)
    right = ref_int16(160, seed=8, smooth=True)
    raw = encode_flac([left, right], rate=8000,
                      frame_plan=[(96, 'fixed3'), (64, 'fixed1',
                                                   {'method': 1})],
                      ch_mode=mode)
    wav, rate = read_flac(raw)
    assert rate == 8000 and wav.shape == (2, 160)
    for got, want in zip(wav, (left, right)):
        np.testing.assert_array_equal(
            np.round(got * 32768.0).astype(np.int64), want)


@pytest.mark.parametrize('rates', [(8000, 16000), (22050, 16000),
                                   (16000, 16000), (16000, 8000)])
def test_resample_matches_jax(rates):
    from wenet_tpu.dataset import audio as J
    from wenet_tpu_torch.dataset import audio as P
    x = _speech(np.random.RandomState(1), 7000)[None]
    np.testing.assert_array_equal(P.resample(x, *rates),
                                  J.resample(x, *rates))


@pytest.mark.parametrize('speed', [0.9, 1.0, 1.1])
def test_speed_perturb_matches_jax(speed):
    from wenet_tpu.dataset import audio as J
    from wenet_tpu_torch.dataset import audio as P
    x = _speech(np.random.RandomState(2), 9000)[None]
    got = P.speed_perturb(x, 16000, speed)
    np.testing.assert_array_equal(got, J.speed_perturb(x, 16000, speed))
    assert abs(got.shape[1] - 9000 / speed) <= 1


# ---------------------------------------------------------------------------
# features, kaldi_io, cmvn
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('kw', [{'num_mel_bins': 23, 'num_ceps': 13},
                                {'num_mel_bins': 40, 'num_ceps': 40,
                                 'low_freq': 40.0, 'high_freq': -400.0,
                                 'cepstral_lifter': 0.0}])
def test_mfcc_matches_jax(kw):
    """Host MFCC equal to the JAX package's host MFCC; the torch one
    (float64 FFT) within 1e-4 of both of the JAX package's."""
    import jax.numpy as jnp
    import torch
    from wenet_tpu.ops import fbank as J
    from wenet_tpu_torch.ops import fbank as P
    w = _speech(np.random.RandomState(3), 16000) * 32768
    want = J.compute_mfcc_np(w, **kw)
    np.testing.assert_array_equal(P.compute_mfcc_np(w, **kw), want)
    got = P.compute_mfcc(torch.from_numpy(w), **kw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(
        got, np.asarray(J.compute_mfcc(jnp.asarray(w), **kw)), atol=1e-4,
        rtol=0)
    np.testing.assert_array_equal(P.dct_matrix(13, 23), J.dct_matrix(13, 23))


def _compressed_matrix(rows, cols, rng):
    """Bytes of a kaldi CompressedMatrix (format 1) and its values."""
    import struct
    min_value, rnge = -3.0, 7.0
    headers = np.sort(rng.randint(0, 65536, size=(cols, 4)),
                      axis=1).astype('<u2')
    data = rng.randint(0, 256, size=(cols, rows)).astype('u1')
    raw = (b'CM ' + struct.pack('<ff', min_value, rnge) +
           struct.pack('<ii', rows, cols) + headers.tobytes() +
           data.tobytes())
    return raw


def test_kaldi_io_matches_jax(tmp_path):
    from wenet_tpu.dataset import kaldi_io as J
    from wenet_tpu_torch.dataset import kaldi_io as P
    rng = np.random.RandomState(4)
    mats = {f'k{i}': rng.randn(3 + i, 5).astype(np.float32)
            for i in range(3)}
    ark, scp = str(tmp_path / 'p.ark'), str(tmp_path / 'p.scp')
    assert P.write_ark_scp(ark, mats, scp) == 3
    for reader in (J.read_mat_scp, P.read_mat_scp):
        got = dict(reader(scp))
        assert sorted(got) == sorted(mats)
        for k in mats:
            np.testing.assert_array_equal(got[k], mats[k])
    jark = str(tmp_path / 'j.ark')
    J.write_ark_scp(jark, mats)
    assert open(jark, 'rb').read() == open(ark, 'rb').read()
    for (gk, g), (wk, w) in zip(P.read_mat_ark(ark), J.read_mat_ark(ark)):
        assert gk == wk
        np.testing.assert_array_equal(g, w)
    with open(tmp_path / 'v.ark', 'wb') as f:
        off = P.write_vec_flt(f, np.arange(4, dtype=np.float32), 'v0')
    vec = f'{tmp_path / "v.ark"}:{off}'
    np.testing.assert_array_equal(P.read_vec_flt(vec), J.read_vec_flt(vec))
    cm = tmp_path / 'cm.ark'
    cm.write_bytes(b'\0B' + _compressed_matrix(6, 4, rng))
    np.testing.assert_array_equal(P.read_mat(str(cm)), J.read_mat(str(cm)))
    assert P.read_mat(str(cm)).shape == (6, 4)
    cm.write_bytes(b'\0BXM ')
    with pytest.raises(ValueError, match='matrix type'):
        P.read_mat(str(cm))


def _write_stats(tmp_path, kind, rng):
    dim, count = 6, 500.0
    mean = rng.randn(dim) * count
    var = (rng.rand(dim) + 1.0) * count + mean ** 2 / count
    path = tmp_path / f'cmvn_{kind}'
    if kind == 'json':
        path.write_text(json.dumps({'mean_stat': mean.tolist(),
                                    'var_stat': var.tolist(),
                                    'frame_num': count}))
    elif kind == 'kaldi_text':
        row1 = ' '.join(f'{x:.6f}' for x in mean) + f' {count}'
        row2 = ' '.join(f'{x:.6f}' for x in var) + ' 0'
        path.write_text(f'[ {row1}\n  {row2} ]\n')
    else:
        from wenet_tpu_torch.dataset.kaldi_io import write_mat
        stats = np.stack([np.append(mean, count), np.append(var, 0.0)])
        with open(path, 'wb') as f:
            write_mat(f, stats)
    return str(path)


@pytest.mark.parametrize('kind', ['json', 'kaldi_text', 'kaldi_binary'])
def test_load_cmvn_matches_jax(tmp_path, kind):
    from wenet_tpu.utils.cmvn import load_cmvn as jax_load
    from wenet_tpu_torch.utils.cmvn import load_cmvn
    path = _write_stats(tmp_path, kind, np.random.RandomState(5))
    got = load_cmvn(path, kind == 'json')
    want = jax_load(path, kind == 'json')
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the random stages, by their statistics
# ---------------------------------------------------------------------------
def _feat_sample(T=300, F=80):
    return {'feat': np.arange(T * F, dtype=np.float32).reshape(T, F) + 1}


def _masked(fn, jax_fn, n, **kw):
    """Per draw (time frames, frequency bins) zeroed, for the port under
    one Generator and the JAX package under the seeded global random."""
    gen = np.random.default_rng(0)
    random.seed(0)
    out = []
    for f, extra in ((fn, {'rng': gen}), (jax_fn, {})):
        rows = []
        for _ in range(n):
            y = f(_feat_sample(), **kw, **extra)['feat']
            rows.append(((y == 0).all(1).sum(), (y == 0).all(0).sum()))
        out.append(np.asarray(rows, float))
    return out


def test_spec_aug_statistics():
    from wenet_tpu.dataset import processor as J
    from wenet_tpu_torch.dataset import processor as P
    got, want = _masked(P.spec_aug, J.spec_aug, 600, num_t_mask=2,
                        num_f_mask=2, max_t=50, max_f=10)
    assert got[:, 0].max() <= 100 and got[:, 1].max() <= 20
    # expected masked frames ~ 2 x 25.5 less overlap and the tail
    np.testing.assert_allclose(got.mean(0), want.mean(0), rtol=0.08)
    np.testing.assert_allclose(got.std(0), want.std(0), rtol=0.15)
    a = P.spec_aug(_feat_sample(), rng=np.random.default_rng(7))['feat']
    b = P.spec_aug(_feat_sample(), rng=np.random.default_rng(7))['feat']
    np.testing.assert_array_equal(a, b)


def test_spec_sub_statistics():
    """Frames replaced per draw: same mean as the JAX package's."""
    from wenet_tpu.dataset import processor as J
    from wenet_tpu_torch.dataset import processor as P
    gen = np.random.default_rng(1)
    random.seed(1)
    x = _feat_sample()
    counts = []
    for f, extra in ((P.spec_sub, {'rng': gen}), (J.spec_sub, {})):
        counts.append(np.asarray([
            (f(dict(x), max_t=30, num_t_sub=3, **extra)['feat'] !=
             x['feat']).any(1).sum() for _ in range(600)], float))
    assert counts[0].max() <= 90 and counts[0].mean() > 20
    np.testing.assert_allclose(counts[0].mean(), counts[1].mean(),
                               rtol=0.08)


def test_spec_trim_statistics():
    from wenet_tpu.dataset import processor as J
    from wenet_tpu_torch.dataset import processor as P
    gen = np.random.default_rng(2)
    random.seed(2)
    lens = [[f(_feat_sample(T=100), max_t=20, **extra)['feat'].shape[0]
             for _ in range(800)]
            for f, extra in ((P.spec_trim, {'rng': gen}), (J.spec_trim, {}))]
    got, want = np.asarray(lens, float)
    assert got.min() >= 80 and got.max() == 99
    np.testing.assert_allclose(got.mean(), want.mean(), rtol=0.01)


def test_speed_choice_and_dither_statistics():
    """Each speed drawn about a third of the time, as by the JAX package;
    dither moves the fbank by as much as the JAX package's does, and one
    generator seed gives one result."""
    from wenet_tpu.dataset import processor as J
    from wenet_tpu_torch.dataset import processor as P
    gen = np.random.default_rng(3)
    wav = _speech(np.random.RandomState(4), 3200)[None]
    lens = [P.speed_perturb({'wav': wav, 'sample_rate': 16000},
                            rng=gen)['wav'].shape[1] for _ in range(600)]
    shares = np.asarray([np.mean(np.asarray(lens) == n)
                         for n in (3556, 3200, 2909)])
    np.testing.assert_allclose(shares, 1 / 3, atol=0.06)
    sample = {'wav': wav, 'sample_rate': 16000}
    clean = P.compute_fbank(dict(sample), num_mel_bins=40)['feat']
    moved = [np.abs(P.compute_fbank(dict(sample), num_mel_bins=40,
                                    dither=1.0, rng=gen)['feat'] - clean
                    ).mean() for _ in range(20)]
    np.random.seed(0)
    jmoved = [np.abs(J.compute_fbank(dict(sample), num_mel_bins=40,
                                     dither=1.0)['feat'] - clean).mean()
              for _ in range(20)]
    np.testing.assert_allclose(np.mean(moved), np.mean(jmoved), rtol=0.05)
    a, b = (P.compute_fbank(dict(sample), num_mel_bins=40, dither=1.0,
                            rng=np.random.default_rng(9))['feat']
            for _ in range(2))
    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match='generator'):
        P.compute_fbank(dict(sample), dither=1.0)


def test_augmented_dataset_statistics(data_dir):
    """The flagship's augmentation (speed perturb, dither, SpecAugment,
    SpecSub, shuffles) through both pipelines: the same utterances, padded
    frames within 10% over the epoch; the port's epoch is fixed by its
    seed and epoch."""
    conf = _conf(BATCHES['static'], speed_perturb=True, spec_aug=True,
                 spec_sub=True, shuffle=True, list_shuffle=True,
                 fbank_conf={'num_mel_bins': 40, 'dither': 1.0})
    got = _batches('port', 'raw', data_dir / 'data.list', conf)
    want = _batches('jax', 'raw', data_dir / 'data.list', conf)

    def keys(bs):
        return sorted(k for b in bs for k in b['keys'])

    def frames(bs):
        return sum(int(b['feats_lengths'].sum()) for b in bs)

    assert keys(got) == keys(want)
    np.testing.assert_allclose(frames(got), frames(want), rtol=0.1)
    zero = np.mean([(b['feats'] == 0).all(2)[0, :b['feats_lengths'][0]]
                    .mean() for b in got])
    assert 0.0 < zero < 0.9  # SpecAugment zeroed some frames
    again = _batches('port', 'raw', data_dir / 'data.list', conf)
    _assert_same_batches(again, got)


# ---------------------------------------------------------------------------
# datapipes
# ---------------------------------------------------------------------------
def test_prefetch_survives_abandoned_iterator():
    """Abandoning a prefetch iterator mid-stream releases its thread."""
    from wenet_tpu_torch.dataset.datapipes import _Gen

    def src():
        yield from range(10000)

    before = threading.active_count()
    for _ in range(5):
        it = iter(_Gen(src).prefetch(2))
        for _, x in zip(range(3), it):
            pass
        it.close()
    time.sleep(1.2)  # the workers see the stop flag within 0.5 s
    assert threading.active_count() <= before + 1


def test_prefetch_delivers_done_with_slow_consumer():
    """The end-of-data marker reaches a consumer slower than the
    producer (a dropped marker would hang the epoch)."""
    from wenet_tpu_torch.dataset.datapipes import _Gen

    def src():
        yield from range(6)

    out = []
    for x in _Gen(src).prefetch(2):
        time.sleep(0.05)
        out.append(x)
    assert out == list(range(6))


def test_each_epoch_has_its_own_order(data_dir):
    """One (seed, epoch) gives one order; another epoch another; the
    list shuffle is the same on every host, so two shards partition the
    list."""
    from wenet_tpu_torch.dataset.dataset import Dataset
    from wenet_tpu_torch.text.char_tokenizer import CharTokenizer
    conf = _conf({'batch_type': 'static', 'batch_size': 1}, sort=False,
                 list_shuffle=True, shuffle=True)

    def order(epoch, seed=5, **kw):
        ds = Dataset('raw', str(data_dir / 'data.list'),
                     CharTokenizer(dict(SYMS)), dict(conf), seed=seed, **kw)
        ds.set_epoch(epoch)
        return [b['keys'][0] for b in ds]

    assert order(0) == order(0)
    orders = {tuple(order(e)) for e in range(4)}
    assert len(orders) > 1
    assert all(sorted(o) == sorted(order(0)) for o in orders)
    shards = [set(order(1, num_shards=2, shard_id=i)) for i in range(2)]
    assert not shards[0] & shards[1]
    assert shards[0] | shards[1] == set(order(1))


def test_tar_source_skips_a_bad_member(tmp_path):
    """A member that cannot be read drops its sample, not the shard."""
    from wenet_tpu_torch.dataset.datapipes import tar_source
    tar_path = tmp_path / 'bad.tar'
    with tarfile.open(tar_path, 'w') as tar:
        for key, data in (('a', b'1'), ('b', b'\xff\xfe'), ('c', b'2')):
            txt = tmp_path / 'x'
            txt.write_bytes(data)
            tar.add(str(txt), arcname=f'{key}.txt')
    out = list(tar_source([str(tar_path)]))
    assert [x['key'] for x in out] == ['a', 'c']
    assert [x['txt'] for x in out] == ['1', '2']
