"""Multi-process training of the port (wenet_tpu_torch/parallel/mesh.py) on
the CPU: gloo ranks started as processes (tests/torch_parallel_worker.py,
file:// rendezvous under tmp_path, 60 s collective timeouts, one thread
each), at the tiny width of tests/torch_port_utils.py, with the JAX
package's initial weights.

Each data rank trains on its own batch (rows, frames and label length
differ between ranks, `rank_batch`).  A step over N ranks is held to the
one-process port's step on the padded, concatenated batch (losses within
rtol 1e-5, weights after the step within 1e-6) for data=2 (also with
accum_grad 2 and a batch_norm yaml), zero2, model=2 and data=2,model=2,
and to the JAX package's loss and gradients on that batch (loss rtol
1e-4, gradients within 2e-4, the torch-import bar).  Adam's eps is 1e-3,
as in tests/test_torch_train_main.py: its first update is about
lr * sign(g), which turns float32 rounding noise in a near-zero gradient
into steps of +-lr.  Resume from a checkpoint of the whole model and
optimizer continues bit for bit under zero2 and model=2.  Uneven shards
end every rank at the shorter one's end; dropout draws differ between
data ranks while the chunk draw is shared; bin/train.py runs under two
ranks end to end."""

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from torch_port_utils import IDIM, TINY_CONFIG, jax_model, rank_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, 'tests', 'torch_parallel_worker.py')
OPTIM = dict(optim='adam', optim_conf={'lr': 0.002, 'eps': 1e-3},
             scheduler='warmuplr', scheduler_conf={'warmup_steps': 5})
RNG = (777, 0)
GRAD_ATOL = 2e-4
# scenario -> ranks
SCENARIOS = {'data2': 2, 'model2': 2, 'data2_model2': 4}
TIMEOUT_S = 300


def _config(dropout=False, **encoder):
    cfg = copy.deepcopy(TINY_CONFIG)
    cfg['encoder_conf'].update(encoder)
    if not dropout:
        cfg['encoder_conf'].update(use_dynamic_chunk=False)
        for conf in (cfg['encoder_conf'], cfg['decoder_conf']):
            for k in conf:
                if k.endswith('dropout_rate'):
                    conf[k] = 0.0
    cfg.update(OPTIM)
    return cfg


CONFIGS = {'plain': _config(), 'bn': _config(cnn_module_norm='batch_norm'),
           'dropout': _config(dropout=True)}


def _env():
    env = dict(os.environ, OMP_NUM_THREADS='1')
    env['PYTHONPATH'] = os.pathsep.join([REPO, env.get('PYTHONPATH', '')])
    for k in ('WORLD_SIZE', 'RANK', 'LOCAL_RANK', 'MASTER_ADDR',
              'MASTER_PORT', 'JAX_COORDINATOR'):
        env.pop(k, None)
    return env


def _wait(procs, timeout_s=TIMEOUT_S):
    """Each process's output; every one is killed if any outlives the
    timeout, or fails."""
    deadline = time.monotonic() + timeout_s
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(),
                                               1))
            outs.append(out)
    except subprocess.TimeoutExpired:
        pytest.fail(f'ranks still running after {timeout_s} s')
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


@pytest.fixture(scope='module')
def work(tmp_path_factory):
    """The configs and initial weights (the JAX package's, carried across;
    the dropout config's are the port's own) -> (dir, {name: (JAX model,
    variables)})."""
    from wenet_tpu_torch.utils.checkpoint import state_dict_from_jax
    from wenet_tpu_torch.utils.init_model import init_model
    d = tmp_path_factory.mktemp('parallel')
    jax_models = {}
    for name, cfg in CONFIGS.items():
        (d / f'{name}.json').write_text(json.dumps(cfg))
        if name == 'dropout':
            model = init_model(copy.deepcopy(cfg),
                               torch.Generator().manual_seed(5),
                               device='cpu')
            torch.save(model.state_dict(), d / f'{name}.pt')
            continue
        jax_models[name] = jax_model(cfg, seed=31)
        torch.save(state_dict_from_jax(jax_models[name][1]),
                   d / f'{name}.pt')
    return d, jax_models


@pytest.fixture(scope='module')
def ranks(work):
    """Every scenario's ranks, started together -> {scenario: [each
    rank's results]}."""
    d, _ = work
    procs = {s: [subprocess.Popen(
        [sys.executable, WORKER, s, str(r), str(n), str(d / f'{s}.init'),
         str(d)], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]
        for s, n in SCENARIOS.items()}
    out = {}
    for s, ps in procs.items():
        _wait(ps)
        out[s] = [torch.load(d / f'{s}_rank{r}.pt')
                  for r in range(len(ps))]
    return out


def _concat(data_ranks, step=0):
    """The one-process batch of `data_ranks` ranks' batches at `step`:
    each padded to the agreed rows, frames and labels, rows in rank
    order."""
    from wenet_tpu_torch.parallel.mesh import pad_batch
    bs = [rank_batch(r, step) for r in range(data_ranks)]
    dims = [max(len(b['feats_lengths']) for b in bs),
            max(b['feats'].shape[1] for b in bs),
            max(b['target'].shape[1] for b in bs)]
    bs = [pad_batch(b, *dims) for b in bs]
    return {k: np.concatenate([b[k] for b in bs]) for k in bs[0]}


def _one_process(work, name, data_ranks, steps=1, accum=1):
    """The port's one-process run on the concatenated batches -> (last
    metrics, gradients, state_dict)."""
    from wenet_tpu_torch.utils.executor import to_device_batch
    from wenet_tpu_torch.utils.init_model import init_model
    from wenet_tpu_torch.utils.train_utils import (
        TrainState, init_optimizer_and_scheduler, make_train_step)
    d, _ = work
    cfg = CONFIGS[name]
    model = init_model(copy.deepcopy(cfg), device='cpu')
    model.load_state_dict(torch.load(d / f'{name}.pt'), strict=True)
    opt, schedule = init_optimizer_and_scheduler(cfg, model)
    state = TrainState(model, opt)
    step = make_train_step(model, opt, schedule, None, accum, 5.0)
    for s in range(steps):
        state, metrics = step(
            state, to_device_batch(_concat(data_ranks, s), 'cpu'), RNG)
    return ({k: float(v) for k, v in metrics.items()},
            {n: p.grad.clone() for n, p in model.named_parameters()},
            model.state_dict())


def _assert_step(got, want_metrics, want_weights):
    for k in ('loss', 'loss_att', 'loss_ctc', 'th_accuracy', 'grad_norm'):
        np.testing.assert_allclose(got['metrics'][k], want_metrics[k],
                                   rtol=1e-5, err_msg=k)
    assert set(got['weights']) == set(want_weights)
    for k, w in want_weights.items():
        np.testing.assert_allclose(got['weights'][k].float().numpy(),
                                   w.float().numpy(), atol=1e-6, err_msg=k)


def _jax_loss_and_grads(work, name, batch):
    """The JAX package's loss dict and clipped gradients (clip 5, as the
    port's step) on `batch`, as a state dict of the port's keys."""
    import jax
    import jax.numpy as jnp
    from wenet_tpu_torch.utils.checkpoint import state_dict_from_jax
    _, jax_models = work
    model, variables = jax_models[name]
    args = [jnp.asarray(batch[k]) for k in ('feats', 'feats_lengths',
                                            'target', 'target_lengths')]

    def loss_fn(params):
        v = {**variables, 'params': params}
        if 'batch_stats' in variables:
            out, _ = model.apply(v, *args, train=True,
                                 mutable=['batch_stats'])
        else:
            out = model.apply(v, *args, train=True)
        return out['loss'], out

    (_, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables['params'])
    norm = float(jnp.sqrt(sum(jnp.sum(g.astype(jnp.float32) ** 2)
                              for g in jax.tree_util.tree_leaves(grads))))
    scale = min(1.0, 5.0 / norm)
    grads = jax.tree_util.tree_map(lambda g: np.asarray(g) * scale, grads)
    return ({k: float(v) for k, v in out.items() if v is not None},
            state_dict_from_jax({'params': grads}))


def _assert_like_jax(work, name, got, data_ranks):
    want, grads = _jax_loss_and_grads(work, name, _concat(data_ranks))
    for k in ('loss', 'loss_att', 'loss_ctc', 'th_accuracy'):
        np.testing.assert_allclose(got['metrics'][k], want[k], rtol=1e-4,
                                   err_msg=k)
    assert set(got['grads']) == set(grads)
    for k, g in grads.items():
        np.testing.assert_allclose(got['grads'][k].numpy(), g.numpy(),
                                   atol=GRAD_ATOL, err_msg=k)


# -- data=2 -------------------------------------------------------------------
def test_data2_step_is_the_concatenated_batch_step(work, ranks):
    metrics, _, weights = _one_process(work, 'plain', 2)
    for r in ranks['data2']:
        _assert_step(r['step'], metrics, weights)


def test_data2_step_matches_jax(work, ranks):
    _assert_like_jax(work, 'plain', ranks['data2'][0]['step'], 2)


def test_data2_accum_grad_2(work, ranks):
    """accum_grad 2: DDP averages each micro-step's gradients before the
    running mean, so the window's update is the global one."""
    _, _, weights = _one_process(work, 'plain', 2, steps=2, accum=2)
    for r in ranks['data2']:
        for k, w in weights.items():
            np.testing.assert_allclose(r['accum'][k].numpy(), w.numpy(),
                                       atol=1e-6, err_msg=k)


def test_zero2_step_is_the_concatenated_batch_step(work, ranks):
    metrics, _, weights = _one_process(work, 'plain', 2)
    a, b = (r['zero2'] for r in ranks['data2'])
    for r in (a, b):
        _assert_step(r, metrics, weights)
    # each rank holds the moments of its part of the parameters only
    assert a['moments'] > 0 and b['moments'] > 0
    assert a['moments'] + b['moments'] == a['params']


def test_batch_norm_data2_takes_global_statistics(work, ranks):
    """A batch_norm yaml: the statistics (and the running ones) of the
    global batch, as the JAX BatchNorm under GSPMD."""
    metrics, _, weights = _one_process(work, 'bn', 2)
    assert any(k.endswith('running_var') for k in weights)
    for r in ranks['data2']:
        _assert_step(r['bn'], metrics, weights)


def test_batch_norm_data2_matches_jax(work, ranks):
    _assert_like_jax(work, 'bn', ranks['data2'][0]['bn'], 2)


# -- model=2 and data=2,model=2 -------------------------------------------------
def test_model2_shards_what_the_jax_rule_shards(work, ranks):
    """The parameters cut over `model` are the JAX `_rule_single`'s
    column-parallel leaves (min_dim 64), each with half its columns."""
    import jax
    from jax.sharding import PartitionSpec as P
    from wenet_tpu.parallel.mesh import make_mesh, state_shardings
    from wenet_tpu_torch.utils.checkpoint import torch_key
    _, jax_models = work
    params = jax_models['plain'][1]['params']
    mesh = make_mesh({'data': 1, 'model': 2}, jax.devices()[:2])
    specs = state_shardings({'params': params}, mesh,
                            shard_model_axis=True, min_dim=64)
    want = set()
    for path, s in jax.tree_util.tree_flatten_with_path(specs)[0]:
        if s.spec == P(None, 'model'):
            key = torch_key(tuple(str(getattr(k, 'key', k)) for k in path))
            want.add(key)
    got = ranks['model2'][0]
    assert {k for k in got['sharded'] if k.endswith('weight')} == want
    full = torch.load(work[0] / 'plain.pt')
    for k, dim in got['sharded'].items():
        shape = list(full[k].shape)
        shape[dim] //= 2
        assert got['local_shapes'][k] == tuple(shape), k


def test_model2_step_is_the_one_process_step(work, ranks):
    metrics, _, weights = _one_process(work, 'plain', 1)
    for r in ranks['model2']:
        _assert_step(r['step'], metrics, weights)


def test_model2_step_matches_jax(work, ranks):
    _assert_like_jax(work, 'plain', ranks['model2'][1]['step'], 1)


def test_data2_model2_step_is_the_concatenated_batch_step(work, ranks):
    metrics, _, weights = _one_process(work, 'plain', 2)
    places = sorted((r['data_rank'], r['model_rank'])
                    for r in ranks['data2_model2'])
    assert places == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in ranks['data2_model2']:
        _assert_step(r['step'], metrics, weights)


def test_data2_model2_step_matches_jax(work, ranks):
    _assert_like_jax(work, 'plain', ranks['data2_model2'][3]['step'], 2)


# -- checkpoints -----------------------------------------------------------------
@pytest.mark.parametrize('layout', ['zero2', 'model2'])
def test_resume_continues_bit_for_bit(ranks, layout):
    """Two steps, a checkpoint of the whole model and optimizer state, a
    fresh model that loads it and takes its shards, a third step: the
    weights equal the uninterrupted run's bit for bit."""
    scenario, key = {'zero2': ('data2', 'zero2_resume'),
                     'model2': ('model2', 'resume')}[layout]
    for r in ranks[scenario]:
        res = r[key]
        for k, w in res['uninterrupted'].items():
            assert torch.equal(res['resumed'][k], w), k


@pytest.mark.parametrize('layout', ['zero2', 'model2'])
def test_checkpoint_has_the_one_process_keys_and_shapes(work, ranks,
                                                        layout):
    scenario, key = {'zero2': ('data2', 'zero2_resume'),
                     'model2': ('model2', 'resume')}[layout]
    want = {k: tuple(v.shape) for k, v in
            torch.load(work[0] / 'plain.pt').items()}
    assert ranks[scenario][0][key]['checkpoint_shapes'] == want


# -- the epoch and the random draws ------------------------------------------------
def test_uneven_shards_end_every_rank_together(ranks):
    """5 batches on rank 0 and 3 on rank 1: both take 3 steps (a rank
    that went on alone would wait in DDP's all-reduce)."""
    assert [r['uneven_steps'] for r in ranks['data2']] == [3, 3]


def test_dropout_draws_differ_between_ranks(ranks):
    """Same batch, same step: the chunk draw is shared, the attention
    dropout seeds (and so the masks) and the losses are each rank's."""
    a, b = (r['dropout'] for r in ranks['data2'])
    assert a['chunks'] == b['chunks'] and len(a['chunks']) == 1
    assert len(a['seeds']) == len(b['seeds']) == 2
    assert all(x != y for x, y in zip(a['seeds'], b['seeds']))
    assert a['mask'].shape == b['mask'].shape
    assert not torch.equal(a['mask'], b['mask'])
    assert a['loss'] != b['loss']


def test_rank0_draws_as_one_process(work, ranks):
    """Data rank 0 keeps the one-process draws: its seeds are those of the
    same forward in one process."""
    from wenet_tpu_torch.utils.executor import to_device_batch
    from wenet_tpu_torch.utils.init_model import init_model
    from wenet_tpu_torch.utils.train_utils import step_seeds
    import wenet_tpu_torch.models.transformer.attention as att
    model = init_model(copy.deepcopy(CONFIGS['dropout']), device='cpu')
    model.load_state_dict(torch.load(work[0] / 'dropout.pt'))
    model.train()
    seeds = []
    real = att.flash_attention_relpos

    def record(*args):
        seeds.append(args[-1])
        return real(*args)

    att.flash_attention_relpos = record
    try:
        device_seed, host_seed = step_seeds(*RNG, 0)
        torch.manual_seed(device_seed)
        b = to_device_batch(rank_batch(0, 0), 'cpu')
        out = model(b['feats'], b['feats_lengths'], b['target'],
                    b['target_lengths'],
                    generator=torch.Generator().manual_seed(host_seed))
    finally:
        att.flash_attention_relpos = real
    got = ranks['data2'][0]['dropout']
    assert seeds == got['seeds']
    assert float(out['loss'].detach()) == got['loss']


# -- mesh shapes and the refusals -----------------------------------------------------
@pytest.mark.parametrize('spec,world,want', [
    ('data=2,model=2', 4, (2, 2)), ('data=-1,model=2', 8, (4, 2)),
    (None, 3, (3, 1)), ('model=-1', 2, (1, 2)),
    ('data=2', 4, None), ('data=2,model=2', 2, None)])
def test_mesh_sizes(spec, world, want):
    from wenet_tpu_torch.parallel.mesh import mesh_sizes, parse_mesh
    if want is None:
        with pytest.raises(ValueError, match='WORLD_SIZE'):
            mesh_sizes(parse_mesh(spec), world)
    else:
        assert mesh_sizes(parse_mesh(spec), world) == want


@pytest.mark.parametrize('case', ['jax_coordinator', 'no_master',
                                  'no_card', 'sharding_key'])
def test_what_the_ranks_refuse(monkeypatch, case):
    from wenet_tpu_torch.parallel import mesh as pm
    if case == 'sharding_key':
        with pytest.raises(ValueError, match='fsdp'):
            pm.TrainLayout(pm.TrainMesh(pm.Ranks()), torch.nn.Linear(2, 2),
                           {'fsdp': True})
        return
    for k in ('JAX_COORDINATOR', 'MASTER_ADDR', 'MASTER_PORT'):
        monkeypatch.delenv(k, raising=False)
    if case == 'jax_coordinator':
        monkeypatch.setenv('JAX_COORDINATOR', 'localhost:1234')
        match, device = 'torchrun', 'cpu'
    elif case == 'no_master':
        monkeypatch.setenv('WORLD_SIZE', '2')
        monkeypatch.setenv('RANK', '0')
        monkeypatch.setenv('LOCAL_RANK', '0')
        match, device = 'MASTER_ADDR', 'cpu'
    else:
        monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
        match, device = 'no CUDA device', 'cuda'
    with pytest.raises((ValueError, RuntimeError), match=match):
        pm.init_distributed(device)


# -- bin/train.py under two ranks -------------------------------------------------------
_TRAIN_RANK = '''
import json, sys
from wenet_tpu_torch.bin.train import main
steps = []
summary = main(sys.argv[1:], on_step=lambda r: steps.append(r['step']))
print('SUMMARY ' + json.dumps({'steps': [e['steps'] for e in
                                          summary['epochs']]}))
'''


def _recipe(d):
    """Wavs, units, a data list of 12 utterances and a yaml (zero2)."""
    import yaml
    from wenet_tpu_torch.dataset.audio import write_wav
    rng = np.random.RandomState(0)
    chars = '你好世界天地人和'
    syms = ['<blank>', '<unk>', '<sos/eos>'] + list(chars)
    (d / 'units.txt').write_text(''.join(f'{s} {i}\n' for i, s in
                                         enumerate(syms)), encoding='utf-8')
    lines = []
    for i in range(12):
        path = d / f'u{i}.wav'
        write_wav(str(path), (0.1 * rng.randn(int(16000 * (0.5 + 0.05 * i))
                                              )).astype(np.float32), 16000)
        txt = ''.join(rng.choice(list(chars), size=2 + i % 3))
        lines.append(json.dumps({'key': f'u{i}', 'wav': str(path),
                                 'txt': txt}, ensure_ascii=False))
    (d / 'data.list').write_text('\n'.join(lines) + '\n', encoding='utf-8')
    cfg = _config()
    for k in ('input_dim', 'output_dim', 'cmvn'):
        cfg.pop(k)
    cfg['encoder_conf']['num_blocks'] = 1
    cfg['decoder_conf'].update(num_blocks=1, r_num_blocks=1)
    cfg['tokenizer'] = 'char'
    cfg['tokenizer_conf'].update(symbol_table_path=str(d / 'units.txt'),
                                 non_lang_syms_path=None)
    cfg['dataset_conf'] = {
        'filter_conf': {'max_length': 4000, 'min_length': 0,
                        'token_min_length': 1},
        'resample_conf': {'resample_rate': 16000},
        'fbank_conf': {'num_mel_bins': IDIM, 'dither': 0.0},
        'batch_conf': {'batch_type': 'static', 'batch_size': 3},
        'shuffle': False, 'list_shuffle': False, 'sort': False,
        'spec_aug': False}
    cfg.update(grad_clip=5.0, accum_grad=1, max_epoch=2, log_interval=1,
               sharding_conf={'zero2': True})
    with open(d / 'train.yaml', 'w', encoding='utf-8') as f:
        yaml.safe_dump(cfg, f, allow_unicode=True)


def test_train_main_under_two_ranks(tmp_path):
    """bin/train.py with --mesh data=2 and zero2 on two gloo ranks: both
    take the same steps, the first step's loss is the one-process step's
    on the two shards' padded, concatenated first batches, and rank 0's
    epoch checkpoint has a one-process model's keys and shapes."""
    from wenet_tpu_torch.bin import train
    from wenet_tpu_torch.utils.executor import to_device_batch
    from wenet_tpu_torch.utils.train_utils import (
        TrainState, init_optimizer_and_scheduler, make_train_step)
    from wenet_tpu_torch.parallel.mesh import pad_batch
    _recipe(tmp_path)
    argv = ['--config', str(tmp_path / 'train.yaml'), '--train_data',
            str(tmp_path / 'data.list'), '--cv_data',
            str(tmp_path / 'data.list'), '--model_dir',
            str(tmp_path / 'exp'), '--device', 'cpu', '--mesh', 'data=2',
            '--init_method', f'file://{tmp_path / "rdv"}']
    procs = []
    for r in range(2):
        env = dict(_env(), WORLD_SIZE='2', RANK=str(r), LOCAL_RANK=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, '-c', _TRAIN_RANK] + argv, env=env,
            cwd=str(tmp_path), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = _wait(procs)
    summaries = [json.loads(o.split('SUMMARY ')[-1].splitlines()[0])
                 for o in outs]
    assert summaries[0] == summaries[1] == {'steps': [2, 2]}
    first = float(outs[0].split('TRAIN | epoch 0 step 1 | loss ')[1].split()
                  [0])
    # the one-process step on the padded, concatenated first batches
    args = train.get_parser().parse_args(argv[:-4])
    run = train.build(args)
    batches = []
    for r in range(2):
        tr, _ = train.datasets(args, run.configs, run.tokenizer, 2, r)
        tr.set_epoch(0)
        batches.append(next(iter(tr)))
    dims = [max(len(b['feats_lengths']) for b in batches),
            max(b['feats'].shape[1] for b in batches),
            max(b['target'].shape[1] for b in batches)]
    batches = [pad_batch(b, *dims) for b in batches]
    batch = {k: np.concatenate([b[k] for b in batches])
             for k in ('feats', 'feats_lengths', 'target', 'target_lengths')}
    model = run.model
    opt, schedule = init_optimizer_and_scheduler(run.configs, model)
    step = make_train_step(model, opt, schedule, None, 1, 5.0)
    _, metrics = step(TrainState(model, opt), to_device_batch(batch, 'cpu'),
                      (777, 0))
    np.testing.assert_allclose(first, float(metrics['loss']), rtol=1e-5)
    saved = torch.load(tmp_path / 'exp' / 'epoch_1.pt')
    assert {k: v.shape for k, v in saved.items()} == \
        {k: v.shape for k, v in model.state_dict().items()}
    assert (tmp_path / 'exp' / 'final.pt').exists()
