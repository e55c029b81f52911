"""SSL pretraining in the PyTorch port against the JAX package's, on the
CPU, at a tiny width (2 conformer blocks of 32, 2 heads, 8-32 codes), from
numpy seeds, on one set of weights carried across with
`state_dict_from_jax` (the BEST-RQ quantizer's `bestrq` collection
included): the span masks and negative samples, exactly, on the uniforms
the JAX key draws; `quantize_codes` and the feature stacking; the
BEST-RQ, wav2vec 2.0 and W2V-BERT losses, metrics and gradients on the
same host draws; and the recipe's entry points on a wav-only data list
(`dataset: ssl`): `bin/train.py` against the JAX trainer, the checkpoint
and `average_model` round trip of the quantizer's buffers.

Bars: masks and samples identical; the stacked features and distances
within 1e-5, codes identical outside a band where the best two distances
lie within 1e-5; losses and metrics within rtol 1e-4, gradients within
1e-3; per-step train losses within rtol 1e-4 and each weight within 1e-6
+ 1% of its largest change (tests/test_torch_train_main.py's bars).

The JAX trainer runs in a subprocess on one CPU device, with the
threefry PRNG (`--prng_impl threefry2x32`), so that the test can draw
its step keys again: the port's trainer takes the same masks through a
patched `host_draws`.  The cuda-marked tests hold phase 17a's checks of
chip_smoke.py on the card (BEST-RQ at the yaml's width, card against
CPU) and skip here."""

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from test_torch_train_main import (_JAX_TRAIN, _captured, _env, _parse,
                                   _speech)
from torch_port_utils import jax_model, torch_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BESTRQ_YAML = os.path.join(REPO,
                           'examples/librispeech/ssl/conf/train_bestrq.yaml')
MEL = 40
LOSS_RTOL = 1e-4
GRAD_ATOL = 1e-3
CODE_BAND = 1e-5
N_UTTS = 8  # two static batches of four
SEED = 777  # bin/train.py's --seed default
JAX_TRAINERS = {}

ENCODER = {'output_size': 32, 'attention_heads': 2, 'linear_units': 64,
           'num_blocks': 2, 'dropout_rate': 0.0,
           'positional_dropout_rate': 0.0, 'attention_dropout_rate': 0.0,
           'input_layer': 'conv2d', 'pos_enc_layer_type': 'rel_pos',
           'selfattention_layer_type': 'rel_selfattn',
           'cnn_module_kernel': 7, 'cnn_module_norm': 'layer_norm',
           'activation_type': 'swish'}


def ssl_config(model='bestrq_model', **model_conf):
    """The BEST-RQ yaml's encoder, narrow and without dropout, with `model`
    and its model_conf (8-32 codes)."""
    conf = {'bestrq_model': dict(num_mel_bins=MEL, embedding_dim=8,
                                 num_embeddings=32, num_codebooks=2,
                                 mask_prob=0.2, mask_length=4, min_masks=2,
                                 features_regularization_weight=0.01),
            'wav2vec_model': dict(embedding_dim=32, num_embeddings=16,
                                  num_codebooks=2, mask_prob=0.2,
                                  mask_length=4, num_negatives=4,
                                  diversity_weight=0.1),
            'w2vbert_model': dict(embedding_dim=32, num_embeddings=16,
                                  num_codebooks=2, mask_prob=0.2,
                                  mask_length=4, num_negatives=4,
                                  diversity_weight=0.1, contrastive_blocks=1,
                                  masked_blocks=1)}[model]
    conf.update(model_conf)
    return {'input_dim': MEL, 'output_dim': 1, 'dataset': 'ssl',
            'encoder': 'conformer', 'encoder_conf': dict(ENCODER),
            'model': model, 'model_conf': conf}


def _inputs(seed=0, B=3, T=96):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, MEL).astype(np.float32)
    lens = np.asarray([T] + list(rng.randint(T // 2, T, size=B - 1)),
                      np.int32)
    return x, lens


# --- the JAX key's draws, as the JAX models take them ----------------------
def jax_mask_draws(key, B, T, conf):
    """`compute_mask_indices`'s uniforms from its key: (count, starts)."""
    import jax
    from wenet_tpu_torch.models.ssl.mask import num_max_masks
    r_count, r_start = jax.random.split(key)
    M = num_max_masks(T, conf['mask_prob'], conf['mask_length'],
                      conf.get('min_masks', 2))
    return (np.asarray(jax.random.uniform(r_count, (B,))),
            np.asarray(jax.random.uniform(r_start, (B, M))))


def jax_draws(model, key, B, T):
    """The host draws of one forward of the port's `model` (its class's
    `host_draws` keys) as the JAX model draws them from `key`, for B rows
    of T subsampled frames."""
    import jax
    from wenet_tpu_torch.models.ssl.bestrq_model import BestRQModel
    from wenet_tpu_torch.models.ssl.w2vbert_model import W2VBERTModel
    conf = dict(mask_prob=model.mask_prob, mask_length=model.mask_length,
                min_masks=model.min_masks)
    if isinstance(model, BestRQModel):
        r_mask, r_emb = jax.random.split(key)
        count, start = jax_mask_draws(r_mask, B, T, conf)
        D = model.num_mel_bins
        emb = jax.random.normal(r_emb, (1, 1, D), np.float32)
        return {'mask_count': count, 'mask_start': start,
                'mask_emb': np.asarray(emb).reshape(D)}
    w2v_bert = isinstance(model, W2VBERTModel)
    keys = jax.random.split(key, 4 if w2v_bert else 3)
    count, start = jax_mask_draws(keys[0], B, T, conf)
    G, V = model.num_codebooks, model.num_embeddings
    draws = {'mask_count': count, 'mask_start': start,
             'gumbel': np.asarray(jax.random.uniform(
                 keys[1], (B * T * G, V), minval=1e-20, maxval=1.0)),
             'negatives': np.asarray(jax.random.uniform(
                 keys[2], (B, T, model.num_negatives)))}
    if w2v_bert:
        draws['noise'] = np.asarray(jax.random.normal(
            keys[3], (B, T, model.encoder.output_size()), np.float32))
    return draws


def _torch_draws(draws):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in draws.items()}


# --- masks and negatives ----------------------------------------------------
@pytest.mark.parametrize('B,T,prob,length,min_masks,pads', [
    (4, 50, 0.2, 5, 2, (0, 20, 0, 44)),
    (3, 200, 0.065, 10, 2, (0, 150, 7)),
    (2, 31, 0.01, 10, 2, (0, 29)),  # min_masks spans, hi clamped at 1
    (5, 120, 0.5, 3, 1, (0, 1, 60, 100, 119)),
])
def test_compute_mask_indices_matches_jax(B, T, prob, length, min_masks,
                                          pads):
    """The span mask equals the JAX package's, bit for bit, given the
    uniforms its key draws: ragged rows, a row almost all padding."""
    import jax
    import jax.numpy as jnp
    from wenet_tpu.models.ssl.mask import compute_mask_indices as jax_fn
    from wenet_tpu_torch.models.ssl.mask import compute_mask_indices
    pad = np.arange(T)[None, :] >= (T - np.asarray(pads))[:, None]
    key = jax.random.PRNGKey(B * 1000 + T)
    want = np.asarray(jax_fn(key, jnp.asarray(pad), prob, length,
                             min_masks))
    count, start = jax_mask_draws(key, B, T, dict(
        mask_prob=prob, mask_length=length, min_masks=min_masks))
    got = compute_mask_indices(torch.from_numpy(pad), prob, length,
                               min_masks, torch.from_numpy(count),
                               torch.from_numpy(start))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not (want & pad).any()


@pytest.mark.parametrize('seed,B,T,N', [(0, 3, 40, 5), (1, 2, 64, 1),
                                        (2, 4, 17, 3)])
def test_sample_negative_indices_matches_jax(seed, B, T, N):
    """Negatives equal the JAX package's on the same uniforms: rows with
    many, one and no masked frames."""
    import jax
    import jax.numpy as jnp
    from wenet_tpu.models.ssl.mask import sample_negative_indices as jax_fn
    from wenet_tpu_torch.models.ssl.mask import sample_negative_indices
    rng = np.random.RandomState(seed)
    mask = rng.rand(B, T) < 0.4
    mask[-1] = False
    mask[0, :] = False
    mask[0, T // 2] = True  # one masked frame: its negatives are itself
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax_fn(key, B, T, N, jnp.asarray(mask)))
    r = np.asarray(jax.random.uniform(key, (B, T, N)))
    got = sample_negative_indices(torch.from_numpy(mask), N,
                                  torch.from_numpy(r))
    np.testing.assert_array_equal(got.numpy(), want)


def test_quantize_codes_and_stacking_match_jax():
    """`_stack_features` within 1e-5 of the JAX model's; `quantize_codes`
    picks the JAX package's code wherever the best two distances are
    further apart than CODE_BAND (the frames inside it are counted)."""
    import jax.numpy as jnp
    from wenet_tpu.models.ssl.bestrq_model import quantize_codes as jax_q
    from wenet_tpu_torch.models.ssl.bestrq_model import quantize_codes
    from wenet_tpu_torch.utils.mask import make_pad_mask
    cfg = ssl_config()
    model, variables = jax_model(cfg, seed=1)
    tmodel = torch_model(cfg, variables)
    x, lens = _inputs(3)
    want = np.asarray(model.apply(variables, jnp.asarray(x),
                                  jnp.asarray(lens),
                                  method=model._stack_features))
    got = tmodel._stack_features(torch.from_numpy(x),
                                 make_pad_mask(torch.from_numpy(lens),
                                               x.shape[1]))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    rng = np.random.RandomState(4)
    lat = rng.randn(500, 16).astype(np.float32)
    lat /= np.linalg.norm(lat, axis=-1, keepdims=True)
    book = rng.randn(32, 2, 8).astype(np.float32)
    book /= np.linalg.norm(book, axis=-1, keepdims=True)
    want = np.asarray(jax_q(jnp.asarray(lat), jnp.asarray(book)))
    got = quantize_codes(torch.from_numpy(lat), torch.from_numpy(book))
    dist = ((lat.reshape(500, 2, 1, 8) -
             book.transpose(1, 0, 2)[None]) ** 2).sum(-1)
    top2 = np.sort(dist, -1)[..., :2]
    outside = top2[..., 1] - top2[..., 0] > CODE_BAND
    assert outside.mean() > 0.99
    np.testing.assert_array_equal(got.numpy()[outside], want[outside])


# --- the three models' losses and gradients ---------------------------------
def _jax_loss_and_grads(model, variables, x, lens, key):
    import jax
    import jax.numpy as jnp

    def loss_fn(params):
        out = model.apply(dict(variables, params=params), jnp.asarray(x),
                          jnp.asarray(lens), train=True, chunk_rng=key,
                          rngs={'dropout': jax.random.PRNGKey(9)})
        return out['loss'], out

    (_, out), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables['params'])
    return out, grads


@pytest.mark.parametrize('name,metrics', [
    ('bestrq_model', ('loss', 'codes_acc', 'features_l2', 'num_codes',
                      'th_accuracy')),
    ('wav2vec_model', ('loss', 'loss_contrastive', 'loss_diversity',
                       'code_ppl', 'features_l2')),
    ('w2vbert_model', ('loss', 'loss_contrastive', 'loss_mlm',
                       'loss_diversity', 'code_ppl', 'features_l2',
                       'th_accuracy')),
])
def test_ssl_loss_and_gradients_match_jax(name, metrics):
    """Each model's loss dict within rtol 1e-4 and every parameter's
    gradient within 1e-3 of the JAX package's, on its weights and the
    draws of its key (BEST-RQ: codes compared first, so that a code near
    a tie would show as such and not as a loss gap)."""
    import jax
    from wenet_tpu_torch.utils.checkpoint import state_dict_from_jax
    cfg = ssl_config(name)
    model, variables = jax_model(cfg, seed=2)
    tmodel = torch_model(cfg, variables).train()
    x, lens = _inputs(5)
    key = jax.random.PRNGKey(11)
    out, grads = _jax_loss_and_grads(model, variables, x, lens, key)
    T = x.shape[1]
    if name == 'bestrq_model':
        n = (T - tmodel.stack_frames) // tmodel.stride + 1
    else:
        n = ((T - 1) // 2 - 1) // 2  # conv2d subsampling
    draws = _torch_draws(jax_draws(tmodel, key, x.shape[0], n))
    got = tmodel(torch.from_numpy(x), torch.from_numpy(lens), draws=draws)
    for k in metrics:
        np.testing.assert_allclose(got[k].item(), float(out[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    got['loss'].backward()
    want = state_dict_from_jax({'params': grads})
    params = dict(tmodel.named_parameters())
    assert set(want) == set(params)
    worst = 0.0
    for k, w in want.items():
        g = params[k].grad
        assert g is not None and torch.isfinite(g).all(), k
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=GRAD_ATOL, err_msg=k)
        worst = max(worst, (g - w).abs().max().item())
    print(f'\n{name}: loss {got["loss"].item():.6f}, max grad gap '
          f'{worst:.3g}')


def test_ssl_models_build_with_their_buffers():
    """init_model builds each SSL model without a decoder or CTC head; the
    BEST-RQ quantizer lives in buffers (not parameters: the optimizer
    never sees them) under the reference's names, and the JAX package's
    `bestrq` collection loads into them strictly, both ways through the
    JAX converters."""
    from wenet_tpu.utils.checkpoint import (convert_to_torch_state_dict,
                                            convert_torch_state_dict)
    cfg = ssl_config()
    _, variables = jax_model(cfg, seed=3)
    tmodel = torch_model(cfg, variables)
    buffers = dict(tmodel.named_buffers())
    params = dict(tmodel.named_parameters())
    assert {'projection', 'embeddings'} <= set(buffers)
    assert not {'projection', 'embeddings'} & set(params)
    assert not any(k.startswith(('decoder.', 'ctc.')) for k in
                   tmodel.state_dict())
    np.testing.assert_array_equal(buffers['embeddings'].numpy(),
                                  variables['bestrq']['embeddings'])
    ref = convert_to_torch_state_dict(variables)
    sd = tmodel.state_dict()
    assert set(ref) == set(sd)
    back = convert_torch_state_dict(sd, variables, strict=True)
    np.testing.assert_array_equal(back['bestrq']['projection'],
                                  variables['bestrq']['projection'])
    from wenet_tpu_torch.utils.init_model import init_model
    for name in ('wav2vec_model', 'w2vbert_model'):
        m = init_model(ssl_config(name), torch.Generator().manual_seed(0),
                       device='cpu')
        assert not any(k.startswith(('decoder.', 'ctc.'))
                       for k in m.state_dict())


# --- the recipe's entry points on a wav-only data list ----------------------
def recipe_config(d):
    cfg = ssl_config('bestrq_model', num_embeddings=16)
    del cfg['input_dim'], cfg['output_dim']
    cfg['encoder_conf']['num_blocks'] = 1
    cfg['dataset_conf'] = {
        'filter_conf': {'max_length': 4000, 'min_length': 0},
        'fbank_conf': {'num_mel_bins': MEL, 'dither': 0.0},
        'batch_conf': {'batch_type': 'static', 'batch_size': 4},
        'pad_conf': {'pad_to_multiple': 64},
        'shuffle': False, 'list_shuffle': False, 'sort': False,
        'spec_aug': False}
    # Adam's eps 1e-3, as tests/test_torch_train_main.py sets it
    cfg.update(grad_clip=5.0, accum_grad=1, max_epoch=2, log_interval=1,
               optim='adam', optim_conf={'lr': 0.002, 'eps': 1e-3},
               scheduler='warmuplr', scheduler_conf={'warmup_steps': 4})
    return cfg


@pytest.fixture(scope='module')
def recipe(tmp_path_factory):
    """Wav-only data list (no txt), train.yaml, the JAX initial weights as
    init.pt; the JAX trainer started on them in the background."""
    from wenet_tpu.utils.checkpoint import save_torch_checkpoint
    from wenet_tpu_torch.dataset.audio import write_wav
    d = tmp_path_factory.mktemp('ssl_recipe')
    rng = np.random.RandomState(0)
    with open(d / 'data.list', 'w') as f:
        for i in range(N_UTTS):
            path = d / f's{i}.wav'
            write_wav(str(path), _speech(rng, 0.7 + 0.11 * i), 16000)
            f.write(json.dumps({'key': f's{i}', 'wav': str(path)}) + '\n')
    cfg = recipe_config(d)
    with open(d / 'train.yaml', 'w') as f:
        yaml.safe_dump(cfg, f)
    _, variables = jax_model(dict(copy.deepcopy(cfg), input_dim=MEL,
                                  output_dim=1), seed=6)
    save_torch_checkpoint(variables, str(d / 'init.pt'))
    env = dict(_env(), XLA_FLAGS='--xla_force_host_platform_device_count=1',
               WENET_TPU_NO_COMPILE_CACHE='1')
    JAX_TRAINERS['ssl'] = subprocess.Popen(
        [sys.executable, '-c', _JAX_TRAIN] + _train_args(d, d / 'jax') +
        ['--prng_impl', 'threefry2x32'],
        env=env, cwd=str(d), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    yield d
    for proc in JAX_TRAINERS.values():
        proc.kill()
        proc.communicate()


@pytest.fixture(autouse=True)
def start_jax_trainer(request):
    """Start the JAX trainer at the file's first test, so that it trains
    while the others run (not for the card's tests: no JAX there)."""
    if not request.node.get_closest_marker('cuda'):
        request.getfixturevalue('recipe')


def _train_args(d, model_dir):
    return ['--config', str(d / 'train.yaml'), '--train_data',
            str(d / 'data.list'), '--cv_data', str(d / 'data.list'),
            '--model_dir', str(model_dir), '--checkpoint',
            str(d / 'init.pt')]


@pytest.fixture(scope='module')
def runs(recipe, monkeypatch_module):
    """The port's bin/train.py, its BEST-RQ drawing what the JAX trainer's
    keys draw (fold_in(PRNGKey(seed + epoch), step), then split: the
    chunk key; PRNGKey(0) in cv), and the JAX trainer's log."""
    import jax
    from wenet_tpu_torch.bin.train import main
    from wenet_tpu_torch.models.ssl.bestrq_model import BestRQModel
    steps = []

    def draws(self, B, T, generator=None):
        if generator is None:
            key = jax.random.PRNGKey(0)
        else:
            step = len(steps)
            steps.append(step)
            key = jax.random.split(jax.random.fold_in(
                jax.random.PRNGKey(SEED + step // 2), step))[1]
        return _torch_draws(jax_draws(self, key, B, T))

    monkeypatch_module.setattr(BestRQModel, 'host_draws', draws)
    with _captured() as lines:
        main(_train_args(recipe, recipe / 'port') + ['--device', 'cpu'])
    log, _ = JAX_TRAINERS['ssl'].communicate(timeout=900)
    assert JAX_TRAINERS['ssl'].returncode == 0, log[-3000:]
    return _parse('\n'.join(lines)), _parse(log)


@pytest.fixture(scope='module')
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_train_matches_jax_trainer(recipe, runs):
    """Two epochs of two steps from the same init.pt: per-step losses,
    code accuracies and lrs, and the cv losses, within rtol 1e-4 of the
    JAX trainer's; each epoch's weights within 1e-6 + 1% of each
    tensor's largest change; the quantizer's buffers untouched."""
    from test_torch_train_main import _jax_weights
    (gsteps, gcv), (wsteps, wcv) = runs
    assert [s[:2] for s in gsteps] == [(0, 1), (0, 2), (1, 3), (1, 4)]
    assert [s[:2] for s in gsteps] == [s[:2] for s in wsteps]
    for (_, step, g), (_, _, w) in zip(gsteps, wsteps):
        for k in ('loss', 'th_accuracy', 'lr'):
            np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL,
                                       err_msg=f'step {step} {k}')
        assert g['codes_acc'] == g['th_accuracy']
    assert len(gcv) == len(wcv) == 2
    for g, w in zip(gcv, wcv):
        np.testing.assert_allclose(g['loss'], w['loss'], rtol=LOSS_RTOL)
    init = torch.load(recipe / 'init.pt', weights_only=True)
    for epoch in (0, 1):
        got = torch.load(recipe / 'port' / f'epoch_{epoch}.pt',
                         weights_only=True)
        want = _jax_weights(recipe / 'jax' / f'epoch_{epoch}')
        assert set(got) == set(want)
        for k, w in want.items():
            change = (w - init[k]).abs().max().item()
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                       atol=1e-6 + 0.01 * change, err_msg=k)
        for k in ('projection', 'embeddings'):
            assert torch.equal(got[k], init[k]), k


def test_checkpoint_and_average_carry_the_buffers(recipe, runs, tmp_path):
    """`average_model` over both epochs keeps the quantizer's buffers as
    they were; the average loads strictly, resumes through bin/train.py
    (one more epoch) and its cv loss is finite."""
    from wenet_tpu_torch.bin.average_model import main as average
    from wenet_tpu_torch.bin.train import main as train
    from wenet_tpu_torch.utils.checkpoint import load_checkpoint
    from wenet_tpu_torch.utils.init_model import init_model
    avg = tmp_path / 'avg.pt'
    assert len(average(['--src_path', str(recipe / 'port'), '--dst_model',
                        str(avg), '--num', '2'])) == 2
    state = torch.load(avg, weights_only=True)
    init = torch.load(recipe / 'init.pt', weights_only=True)
    for k in ('projection', 'embeddings'):
        assert torch.equal(state[k], init[k]), k
    cfg = dict(recipe_config(recipe), input_dim=MEL, output_dim=1)
    model = init_model(cfg, device='cpu')
    load_checkpoint(model, str(avg))
    assert torch.equal(model.embeddings, init['embeddings'])
    with _captured() as lines:
        summary = train(_train_args(recipe, tmp_path / 'resumed')[:-1] +
                        [str(recipe / 'port' / 'epoch_0.pt'), '--device',
                         'cpu'])
    assert [e['epoch'] for e in summary['epochs']] == [1]
    assert np.isfinite(summary['epochs'][0]['cv']['loss'])
    assert 'codes_acc' in '\n'.join(lines)


def test_yaml_builds_at_full_width():
    """examples/librispeech/ssl/conf/train_bestrq.yaml as written builds
    (meta device): 12 blocks of 256, 8192 codes of 16, the buffers."""
    from wenet_tpu_torch.utils.init_model import init_model
    with open(BESTRQ_YAML) as f:
        cfg = yaml.safe_load(f)
    cfg.update(input_dim=80, output_dim=1)
    model = init_model(cfg, device='meta')
    assert len(model.encoder.encoders) == 12
    assert tuple(model.embeddings.shape) == (8192, 1, 16)
    assert tuple(model.projection.shape) == (320, 16)
    assert tuple(model.encoder_top_n_out.shape) == (1, 256, 8192)


# --- phase 17a's checks on the card ------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device to run the Hopper kernels')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.cuda
def test_cuda_bestrq_step_matches_cpu(cuda):
    """BEST-RQ at the yaml's width (2 of its 12 blocks, B=4 x 6 s): one
    train step on the card against the CPU on the same host draws (loss
    rtol 1e-4, gradients 1e-3 + 2e-4 of each tensor's largest), codes
    equal outside the 1e-5 band, one launch of K1-train, K2 and K3 per
    block."""
    sys.path.insert(0, REPO)
    import chip_smoke as c
    from wenet_tpu_torch.ops import flash_attention as fa
    cfg = c.bestrq_configs(num_blocks=2, dropout=False)
    cpu_model = c.ssl_model(cfg)
    model = copy.deepcopy(cpu_model).cuda()
    feats, lens = c.speech_features(np.random.RandomState(0), 4, 3.0, 6.0)
    feats = c.pad_to(feats, 64)
    fa.reset_launches()
    outs, band = c.bestrq_step_pair(model, cpu_model, feats, lens)
    for k in ('relpos_attention_fwd_train', 'relpos_attention_bwd_dq',
              'relpos_attention_bwd_dkpv'):
        assert fa.LAUNCHES[k] == 2, k
    np.testing.assert_allclose(outs[0]['loss'], outs[1]['loss'],
                               rtol=LOSS_RTOL)
    c.hold_gradients('test', model, cpu_model)
    assert band['differ_outside'] == 0
