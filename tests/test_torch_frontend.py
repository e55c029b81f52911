"""The port's on-device front end (ops/spec_augment.py, utils/train_utils.py
`make_frontend`, the `on_device_frontend` Dataset) against the JAX
package, on the CPU.

- `spec_aug`, `spec_sub` and `spec_trim` given the JAX functions' own
  draws (the test repeats their `jax.random.split` / `randint` /
  `uniform` on the same key): equal exactly.
- The train step's front end on a tiny flagship-shaped conformer
  (tests/torch_port_utils.py's, 40 mel bins) with dither 0 and the JAX
  draws replayed, against the JAX `_frontend` (train_utils.py:142-173,
  repeated here step for step on the same key): the features within the
  fbank bar of tests/test_torch_fbank.py (1e-3: the JAX FFT is float32,
  the port's float64), the masks and lengths equal, the loss (rtol 1e-5)
  and gradients (2e-4) of the model on them.
- `make_train_step(frontend_conf=...)` draws from its own host generator
  (`frontend_seed`) and gives the loss of the front end run by hand.
- A `Dataset` with `on_device_frontend` yields the JAX Dataset's batches:
  (B, S, 1) waveforms with lengths in samples, dynamic batches counting
  samples as frames, no host augmentation."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_utils import IDIM, jax_model, tiny_config

FBANK_ATOL = 1e-3  # tests/test_torch_fbank.py
SR = 16000


# -- the JAX draws, repeated ---------------------------------------------------
def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def jax_spec_aug_draws(rng, B, T, F, num_t_mask=2, num_f_mask=2, max_t=50,
                       max_f=10):
    """The draws `wenet_tpu.ops.spec_augment.spec_aug` makes from rng."""
    out = {}
    for axis, n, size, max_w in (('t', num_t_mask, T, max_t),
                                 ('f', num_f_mask, F, max_f)):
        starts, widths = [], []
        for _ in range(n):
            rng, r1, r2 = jax.random.split(rng, 3)
            starts.append(jax.random.randint(r1, (B,), 0, max(size, 1)))
            widths.append(jax.random.randint(r2, (B,), 1, max_w + 1))
        out[f'{axis}_start'] = _t(np.stack(starts).reshape(n, B))
        out[f'{axis}_width'] = _t(np.stack(widths).reshape(n, B))
    return out


def jax_spec_sub_draws(rng, B, T, max_t=20, num_t_sub=3):
    start, width, pos = [], [], []
    for _ in range(num_t_sub):
        rng, r1, r2, r3 = jax.random.split(rng, 4)
        s = jax.random.randint(r1, (B,), 0, T)
        start.append(s)
        width.append(jax.random.randint(r2, (B,), 1, max_t + 1))
        u = jax.random.uniform(r3, (B,))
        pos.append(jnp.floor(u * (s + 1).astype(jnp.float32)).astype(
            jnp.int32))
    return {k: _t(np.stack(v).reshape(num_t_sub, B))
            for k, v in (('start', start), ('width', width), ('pos', pos))}


def _feats(seed, B=3, T=57, F=24):
    return np.random.RandomState(seed).randn(B, T, F).astype(np.float32) + 3


@pytest.mark.parametrize('conf', [{}, dict(num_t_mask=3, num_f_mask=1,
                                           max_t=20, max_f=30)])
def test_spec_aug_with_the_jax_draws_equals_jax(conf):
    from wenet_tpu.ops.spec_augment import spec_aug as jax_spec_aug
    from wenet_tpu_torch.ops.spec_augment import spec_aug_apply
    x = _feats(0)
    rng = jax.random.PRNGKey(11)
    want = np.asarray(jax_spec_aug(rng, jnp.asarray(x), **conf))
    got = spec_aug_apply(torch.from_numpy(x),
                         jax_spec_aug_draws(rng, *x.shape, **conf))
    assert (want == 0).any()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('conf', [{}, dict(max_t=40, num_t_sub=5)])
def test_spec_sub_with_the_jax_draws_equals_jax(conf):
    from wenet_tpu.ops.spec_augment import spec_sub as jax_spec_sub
    from wenet_tpu_torch.ops.spec_augment import spec_sub_apply
    x = _feats(1)
    rng = jax.random.PRNGKey(12)
    want = np.asarray(jax_spec_sub(rng, jnp.asarray(x), **conf))
    got = spec_sub_apply(torch.from_numpy(x),
                         jax_spec_sub_draws(rng, x.shape[0], x.shape[1],
                                            **conf))
    assert (want != x).any()
    np.testing.assert_array_equal(got.numpy(), want)


def test_spec_trim_with_the_jax_draws_equals_jax():
    from wenet_tpu.ops.spec_augment import spec_trim as jax_spec_trim
    from wenet_tpu_torch.ops.spec_augment import spec_trim_apply
    x = _feats(2, B=6)
    lens = np.asarray([57, 40, 30, 12, 3, 1], np.int32)
    rng = jax.random.PRNGKey(13)
    want_x, want_l = jax_spec_trim(rng, jnp.asarray(x), jnp.asarray(lens))
    trim = jax.random.randint(rng, (6,), 1, 21)
    got_x, got_l = spec_trim_apply(torch.from_numpy(x),
                                   torch.from_numpy(lens), {'trim': _t(trim)})
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))


def test_own_draws_are_the_generators_and_in_range():
    from wenet_tpu_torch.ops import spec_augment as sa
    x = torch.from_numpy(_feats(3, B=64))
    d = [sa.spec_aug_draws(64, 57, 24, generator=torch.Generator()
                           .manual_seed(5)) for _ in range(2)]
    for k in d[0]:
        assert torch.equal(d[0][k], d[1][k])
    assert 0 <= d[0]['t_start'].min() and d[0]['t_start'].max() < 57
    assert 1 <= d[0]['f_width'].min() and d[0]['f_width'].max() <= 10
    s = sa.spec_sub_draws(64, 57, generator=torch.Generator().manual_seed(6))
    assert (s['pos'] >= 0).all() and (s['pos'] <= s['start']).all()
    assert (s['pos'] > 0).any()
    y = sa.spec_aug(x, torch.Generator().manual_seed(5))
    assert torch.equal(y, sa.spec_aug_apply(x, d[0]))


# -- the train step's front end -----------------------------------------------------
FRONTEND = {'num_mel_bins': IDIM, 'frame_length': 25, 'frame_shift': 10,
            'dither': 0.0, 'sample_rate': SR, 'spec_aug': True,
            'spec_aug_conf': {'num_t_mask': 2, 'num_f_mask': 2, 'max_t': 10,
                              'max_f': 8},
            'spec_sub': True, 'spec_sub_conf': {'max_t': 8, 'num_t_sub': 3}}


def _waves(seed, lens):
    """Tones over noise in [-1, 1], zero-padded: (B, S, 1), lengths."""
    rng = np.random.RandomState(seed)
    S = max(lens)
    out = np.zeros((len(lens), S, 1), np.float32)
    t = np.arange(S) / SR
    for i, n in enumerate(lens):
        f = rng.uniform(100, 3000)
        x = 0.3 * np.sin(2 * np.pi * f * t[:n]) + 0.05 * rng.randn(n)
        out[i, :n, 0] = x
    return out, np.asarray(lens, np.int64)


def jax_frontend(batch, rng, fc):
    """The JAX package's `_frontend` (train_utils.py:142-173) on `rng`."""
    from wenet_tpu.ops.fbank import compute_fbank
    from wenet_tpu.ops.spec_augment import spec_aug, spec_sub
    wav = jnp.asarray(batch['feats'])[..., 0]
    _, r_aug, r_sub = jax.random.split(rng, 3)
    feats = compute_fbank(wav * (1 << 15), num_mel_bins=fc['num_mel_bins'],
                          frame_length_ms=fc['frame_length'],
                          frame_shift_ms=fc['frame_shift'],
                          sample_rate=fc['sample_rate'], dither=0.0)
    shift = fc['sample_rate'] * fc['frame_shift'] // 1000
    flen = fc['sample_rate'] * fc['frame_length'] // 1000
    lens = jnp.maximum((jnp.asarray(batch['feats_lengths']) - flen) //
                       shift + 1, 0)
    feats = spec_aug(r_aug, feats, **fc['spec_aug_conf'])
    feats = spec_sub(r_sub, feats, **fc['spec_sub_conf'])
    draws = {'spec_aug': jax_spec_aug_draws(r_aug, *feats.shape,
                                            **fc['spec_aug_conf']),
             'spec_sub': jax_spec_sub_draws(r_sub, *feats.shape[:2],
                                            **fc['spec_sub_conf'])}
    return dict(batch, feats=feats, feats_lengths=lens), draws


def _batch(seed=4):
    wav, lens = _waves(seed, [12000, 9000, 7300])
    rng = np.random.RandomState(seed)
    tl = np.asarray([6, 4, 3])
    tgt = np.full((3, 6), -1, np.int64)
    for i, n in enumerate(tl):
        tgt[i, :n] = rng.randint(3, 30, size=n)
    return dict(feats=wav, feats_lengths=lens, target=tgt, target_lengths=tl)


@pytest.fixture(scope='module')
def conformer():
    cfg = tiny_config(dropout_rate=0.0, positional_dropout_rate=0.0,
                      attention_dropout_rate=0.0, use_dynamic_chunk=False)
    for k in cfg['decoder_conf']:
        if k.endswith('dropout_rate'):
            cfg['decoder_conf'][k] = 0.0
    return cfg, jax_model(cfg, seed=51)


def test_frontend_step_with_the_jax_draws_matches_jax(conformer):
    from wenet_tpu_torch.utils.checkpoint import state_dict_from_jax
    from wenet_tpu_torch.utils.init_model import init_model
    from wenet_tpu_torch.utils.train_utils import make_frontend
    cfg, (jmodel, variables) = conformer
    b = _batch()
    want, draws = jax_frontend(b, jax.random.PRNGKey(17), FRONTEND)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    got = make_frontend(FRONTEND)(tb, None, draws=draws)
    np.testing.assert_array_equal(got['feats_lengths'].numpy(),
                                  np.asarray(want['feats_lengths']))
    wf = np.asarray(want['feats'])
    assert got['feats'].dtype == torch.float32
    assert got['feats'].shape == wf.shape
    # the masked bins are zero in both
    np.testing.assert_array_equal(got['feats'].numpy() == 0, wf == 0)
    np.testing.assert_allclose(got['feats'].numpy(), wf, atol=FBANK_ATOL,
                               rtol=0)
    # the model on each package's features
    args = [jnp.asarray(want[k]) for k in ('feats', 'feats_lengths',
                                           'target', 'target_lengths')]

    def loss_fn(params):
        out = jmodel.apply({**variables, 'params': params}, *args,
                           train=True)
        return out['loss'], out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables['params'])
    model = init_model(copy.deepcopy(cfg), device='cpu')
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    model.train()
    out = model(got['feats'], got['feats_lengths'], tb['target'],
                tb['target_lengths'])
    out['loss'].backward()
    for k in ('loss', 'loss_att', 'loss_ctc'):
        np.testing.assert_allclose(out[k].item(), float(jout[k]), rtol=1e-5,
                                   err_msg=k)
    want_grads = state_dict_from_jax({'params': jgrads})
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[n].numpy(),
                                   atol=2e-4, err_msg=n)


def test_train_step_runs_the_frontend_on_its_own_draws(conformer):
    from wenet_tpu_torch.utils.init_model import init_model
    from wenet_tpu_torch.utils.train_utils import (
        TrainState, frontend_seed, init_optimizer_and_scheduler,
        make_frontend, make_train_step)
    cfg = copy.deepcopy(conformer[0])
    cfg.update(optim='adam', optim_conf={'lr': 1e-3},
               scheduler='NoamHoldAnnealing',
               scheduler_conf={'warmup_ratio': 0.1, 'hold_ratio': 0.2,
                               'max_steps': 100})
    b = _batch()
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    model = init_model(copy.deepcopy(cfg), torch.Generator().manual_seed(0),
                       device='cpu')
    ref = copy.deepcopy(model).train()
    fe = make_frontend(FRONTEND)(
        tb, torch.Generator().manual_seed(frontend_seed(777, 0, 0)))
    want = ref(fe['feats'], fe['feats_lengths'], tb['target'],
               tb['target_lengths'])['loss'].item()
    opt, schedule = init_optimizer_and_scheduler(cfg, model)
    step = make_train_step(model, opt, schedule, frontend_conf=FRONTEND)
    _, metrics = step(TrainState(model, opt), tb, (777, 0))
    np.testing.assert_allclose(float(metrics['loss']), want, rtol=1e-6)
    assert metrics['lr'] == schedule(0)


def test_frontend_conf_of_reads_the_yaml_as_the_jax_trainer():
    from wenet_tpu_torch.utils.train_utils import frontend_conf_of
    dc = {'on_device_frontend': True,
          'fbank_conf': {'num_mel_bins': 80, 'dither': 1.0},
          'resample_conf': {'resample_rate': 8000},
          'spec_aug_conf': {'num_t_mask': 2, 'max_t': 50, 'max_w': 80},
          'spec_sub': True, 'spec_sub_conf': {'max_t': 30}}
    assert frontend_conf_of(dc) == {
        'num_mel_bins': 80, 'dither': 1.0, 'sample_rate': 8000,
        'spec_aug': True, 'spec_aug_conf': {'num_t_mask': 2, 'max_t': 50},
        'spec_sub': True, 'spec_sub_conf': {'max_t': 30}}
    assert frontend_conf_of(dict(dc, on_device_frontend=False)) is None


# -- the Dataset ---------------------------------------------------------------------
@pytest.mark.parametrize('batch_conf', [
    {'batch_type': 'static', 'batch_size': 2},
    {'batch_type': 'dynamic', 'max_frames_in_batch': 60000}])
def test_on_device_frontend_dataset_yields_the_jax_batches(tmp_path,
                                                           batch_conf):
    import json
    from wenet_tpu.dataset.dataset import Dataset as JaxDataset
    from wenet_tpu.text.char_tokenizer import CharTokenizer as JaxTok
    from wenet_tpu_torch.dataset.audio import write_wav
    from wenet_tpu_torch.dataset.dataset import Dataset
    from wenet_tpu_torch.text.char_tokenizer import CharTokenizer
    syms = {'<blank>': 0, '<unk>': 1, 'a': 2, 'b': 3, 'c': 4,
            '<sos/eos>': 5}
    rng = np.random.RandomState(8)
    lines = []
    for i, sec in enumerate((0.9, 1.6, 0.7, 1.2, 2.0)):
        x = 0.1 * rng.randn(int(sec * SR))
        write_wav(str(tmp_path / f'u{i}.wav'),
                  (np.round(x.clip(-1, 1) * 32767) / 32768)[None]
                  .astype(np.float32), SR)
        lines.append(json.dumps({'key': f'u{i}', 'txt': 'abc'[:i % 3 + 1],
                                 'wav': str(tmp_path / f'u{i}.wav')}))
    (tmp_path / 'data.list').write_text('\n'.join(lines) + '\n')
    conf = {'on_device_frontend': True, 'list_shuffle': False,
            'shuffle': False, 'spec_aug': True, 'spec_sub': True,
            'spec_trim': True, 'fbank_conf': {'num_mel_bins': 40},
            'batch_conf': batch_conf}
    got = list(Dataset('raw', str(tmp_path / 'data.list'),
                       CharTokenizer(dict(syms)), copy.deepcopy(conf)))
    want = list(JaxDataset('raw', str(tmp_path / 'data.list'),
                           JaxTok(dict(syms)), copy.deepcopy(conf)))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert g['feats'].ndim == 3 and g['feats'].shape[2] == 1
        for k in ('feats', 'feats_lengths', 'target', 'target_lengths'):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert g['keys'] == w['keys']
