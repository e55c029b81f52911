"""The port's training entry point, the paths tests/test_torch_train_main.py
leaves to this file (on its recipe fixture, built anew here, so that the
two files run on two workers), on the CPU:

- Resume from `epoch_0`: without optimizer state (SGD) the resumed epoch
  equals the unbroken one.
- The repair of a resume inside an accumulation window:
  `restore_optimizer_step` + `apply_gradients` against optax's
  MultiSteps at a resume step inside a window.
- `average_model` against the JAX tool on the same weights, selection
  included.
- The profiler window, bf16 autocast, and a jax-free subprocess of the
  port's recipe."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import yaml

from test_torch_train_main import (REPO, _config, _jax_weights,
                                   _port_train, _train_args, _write_yaml,
                                   recipe)  # noqa: F401 (a fixture)


def test_resume_without_optimizer_state_equals_unbroken(recipe):
    """SGD without momentum keeps no optimizer state, so epoch 1 resumed
    from epoch_0 (step, lr position, data order, seeds) equals epoch 1 of
    the unbroken run; with Adam its moments start afresh (as in the JAX
    package), so only the first resumed step and the lrs agree."""
    d = recipe
    steps = {}
    for optim, conf in (('sgd', {'lr': 0.05, 'momentum': 0.0}),
                        ('adam', {'lr': 0.002})):
        name = f'{optim}.yaml'
        _write_yaml(d / name, _config(d, optim=optim, optim_conf=conf))
        whole = _port_train(_train_args(d, d / f'{optim}_whole', name))
        _port_train(_train_args(d, d / f'{optim}_part', name) + [
            '--override_config', 'max_epoch 1'])
        resumed = _port_train(_train_args(d, d / f'{optim}_part', name) + [
            '--checkpoint', str(d / f'{optim}_part' / 'epoch_0.pt')])
        steps[optim] = ([s for s in whole[0][0] if s[0] == 1],
                        resumed[0][0])
    whole, resumed = steps['sgd']
    assert [s[:2] for s in resumed] == [s[:2] for s in whole] and resumed
    for (_, _, g), (_, _, w) in zip(resumed, whole):
        np.testing.assert_allclose(g['loss'], w['loss'], rtol=1e-6)
    whole, resumed = steps['adam']
    np.testing.assert_allclose(resumed[0][2]['loss'], whole[0][2]['loss'],
                               rtol=1e-6)
    assert [s[2]['lr'] for s in resumed] == [s[2]['lr'] for s in whole]


ACCUM = 4
OPTAX_CONFIGS = {'optim': 'adam', 'optim_conf': {'lr': 0.002},
                 'scheduler': 'warmuplr',
                 'scheduler_conf': {'warmup_steps': 3}, 'grad_clip': 5,
                 'accum_grad': ACCUM}


@pytest.fixture(scope='module')
def jax_tiny():
    """The tiny conformer's JAX variables, and optax's MultiSteps(Adam)
    of OPTAX_CONFIGS with its schedule and a jitted update."""
    import jax
    import optax
    from torch_port_utils import jax_model, tiny_config
    from wenet_tpu.utils.train_utils import (init_optimizer_and_scheduler
                                             as jax_init)
    _, variables = jax_model(tiny_config(), seed=51)
    tx, schedule = jax_init(OPTAX_CONFIGS)

    def update(g, st, p):
        updates, st = tx.update(g, st, p)
        return optax.apply_updates(p, updates), st

    return variables, tx, schedule, jax.jit(update)


@pytest.mark.parametrize('resume_step', [5, 8])
def test_resume_mid_window_matches_optax(jax_tiny, resume_step):
    """Resumed at `resume_step` with accum_grad 4 (5: inside a window):
    the port's `restore_optimizer_step` + `apply_gradients` against the
    JAX package's + optax MultiSteps fed the same micro-step gradients:
    the same lr at every update, params within 1e-6."""
    import jax
    from torch_port_utils import tiny_config, torch_model
    from wenet_tpu.utils.train_utils import create_train_state
    from wenet_tpu.utils.train_utils import (
        restore_optimizer_step as jax_restore)
    from wenet_tpu_torch.utils.checkpoint import state_dict_from_jax
    from wenet_tpu_torch.utils.train_utils import (
        TrainState, apply_gradients, init_optimizer_and_scheduler,
        restore_optimizer_step)
    accum, configs = ACCUM, OPTAX_CONFIGS
    variables, tx, jschedule, update = jax_tiny
    jstate = jax_restore(create_train_state(variables, tx), resume_step,
                         accum)
    params, opt_state = jstate.params, jstate.opt_state
    tmodel = torch_model(tiny_config(), variables)
    opt, schedule = init_optimizer_and_scheduler(configs, tmodel)
    state = restore_optimizer_step(TrainState(tmodel, opt), resume_step,
                                   accum)
    rng = np.random.RandomState(52)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    named = dict(tmodel.named_parameters())
    updates = 0
    for micro in range(3 * accum):
        scale = [0.002, 0.04][micro % 2]
        g = jax.tree_util.tree_unflatten(treedef, [
            (scale * rng.randn(*np.shape(x))).astype(np.float32)
            for x in leaves])
        gradient_step = int(opt_state.gradient_step)
        params, opt_state = update(g, opt_state, params)
        for name, t in state_dict_from_jax({'params': g}).items():
            named[name].grad = t.clone()
        _, lr = apply_gradients(state, schedule, configs['grad_clip'],
                                accum)
        if int(opt_state.gradient_step) > gradient_step:  # JAX updated
            updates += 1
            # MultiSteps' inner schedule reads the update count
            np.testing.assert_allclose(lr, float(jschedule(gradient_step)),
                                       rtol=1e-6)
            assert state.micro == 0
        else:
            assert state.micro == int(opt_state.mini_step)
    assert updates == 3 and state.updates == resume_step // accum + 3
    assert state.step == resume_step + 3 * accum
    want = state_dict_from_jax({'params': params})
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-6, err_msg=name)


# ---------------------------------------------------------------------------
# average_model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('select', [['--val_best', '--num', '2'],
                                    ['--num', '2'],
                                    ['--num', '5', '--min_epoch', '1',
                                     '--max_epoch', '2']])
def test_average_model_matches_jax(jax_tiny, tmp_path, select):
    """Four epochs (cv losses out of epoch order) and a `final` alias in
    both layouts: the same checkpoints chosen, the same average."""
    from wenet_tpu.bin.average_model import main as jax_avg
    from wenet_tpu.utils.checkpoint import save_checkpoint as jax_save
    from wenet_tpu_torch.bin.average_model import main as port_avg
    from wenet_tpu_torch.utils.checkpoint import (link_final,
                                                  save_checkpoint,
                                                  state_dict_from_jax)
    import jax
    variables = jax_tiny[0]
    port_dir, jax_dir = tmp_path / 'port', tmp_path / 'jax'
    for epoch, cv_loss in enumerate([3.0, 1.0, 2.0, 4.0]):
        v = jax.tree_util.tree_map(lambda x: np.asarray(x) * (1 + epoch),
                                   variables)
        infos = {'epoch': epoch, 'cv_loss': cv_loss, 'tag': f'epoch_{epoch}'}
        save_checkpoint(state_dict_from_jax(v),
                        str(port_dir / f'epoch_{epoch}.pt'), infos)
        jax_save(v, str(jax_dir / f'epoch_{epoch}'), infos)
    link_final(str(port_dir), 'epoch_3')
    os.symlink('epoch_3', jax_dir / 'final')
    chosen = port_avg(['--src_path', str(port_dir), '--dst_model',
                       str(port_dir / 'avg.pt')] + select)
    old = sys.argv
    sys.argv = ['average_model.py', '--src_path', str(jax_dir),
                '--dst_model', str(jax_dir / 'avg')] + select
    try:
        jax_avg()
    finally:
        sys.argv = old
    want = _jax_weights(jax_dir / 'avg')
    got = torch.load(port_dir / 'avg.pt', weights_only=True)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    expect = {'--val_best': ['epoch_1', 'epoch_2'],
              '--num': ['epoch_3', 'epoch_2']}
    names = [os.path.basename(p)[:-3] for p in chosen]
    if len(select) == 2 or select[0] == '--val_best':
        assert names == expect[select[0]]
    else:
        assert sorted(names) == ['epoch_1', 'epoch_2']
    with open(port_dir / 'avg.yaml') as f:
        assert yaml.safe_load(f)['averaged_from'] == [n + '.pt'
                                                      for n in names]


@pytest.mark.parametrize('start,steps,want', [(1, 2, 'trace_step3.json'),
                                              (2, 100, 'trace_step4.json')])
def test_profile_window_writes_a_trace(recipe, tmp_path, start, steps, want):
    """--profile_dir traces steps [start, start + steps) of the first
    epoch; a window the data ends inside is written at the epoch's end.
    `on_step` gets each step's record; the epoch's totals sum them and
    keep the profiler's own seconds apart."""
    records = []
    _, summary = _port_train(_train_args(recipe, tmp_path / 'exp') + [
        '--checkpoint', str(recipe / 'init.pt'), '--override_config',
        'max_epoch 1', '--profile_dir', str(tmp_path / 'prof'),
        '--profile_start_step', str(start), '--profile_steps', str(steps)],
        on_step=records.append)
    assert summary['profile_trace'] == str(tmp_path / 'prof' / want)
    with open(summary['profile_trace']) as f:
        events = json.load(f)['traceEvents']
    assert any('aten::' in e.get('name', '') for e in events)
    assert [r['step'] for r in records] == [1, 2, 3, 4]
    assert all(r['batch'] == 3 and r['frames'] == 256 for r in records)
    assert all(r['data_wait'] >= 0 and r['step_time'] > 0 for r in records)
    (epoch,) = summary['epochs']
    assert epoch['steps'] == 4 and epoch['profile_seconds'] > 0
    np.testing.assert_allclose(epoch['data_wait_seconds'],
                               sum(r['data_wait'] for r in records))
    np.testing.assert_allclose(epoch['audio_seconds'], sum(
        r['audio_frames'] for r in records) / 100)
    assert epoch['train_seconds'] >= sum(r['step_time'] + r['data_wait']
                                         for r in records)


def test_bf16_autocast_trains(recipe, tmp_path):
    """`dtype: bf16` trains under bf16 autocast: finite losses near the
    fp32 run's first one."""
    fp32 = _port_train(_train_args(recipe, tmp_path / 'fp32') + [
        '--checkpoint', str(recipe / 'init.pt'), '--override_config',
        'max_epoch 1'])[0][0]
    bf16 = _port_train(_train_args(recipe, tmp_path / 'bf16') + [
        '--checkpoint', str(recipe / 'init.pt'), '--override_config',
        'max_epoch 1', '--override_config', 'dtype bf16'])[0][0]
    assert len(bf16) == 4
    assert all(np.isfinite(s[2]['loss']) for s in bf16)
    np.testing.assert_allclose(bf16[0][2]['loss'], fp32[0][2]['loss'],
                               rtol=0.05)


def test_recipe_runs_without_jax(recipe, tmp_path):
    """Stages 1, 4 and 5 of the recipe through the port in a fresh
    process: neither jax nor the JAX package is imported."""
    code = textwrap.dedent(f'''
        import sys
        from wenet_tpu_torch.bin import (average_model, compute_cmvn_stats,
                                         train)
        d, out = {str(recipe)!r}, {str(tmp_path)!r}
        compute_cmvn_stats.main(['--train_config', d + '/train.yaml',
                                 '--in_scp', d + '/wav.scp',
                                 '--out_cmvn', out + '/cmvn'])
        summary = train.main(['--config', d + '/train.yaml',
                              '--train_data', d + '/data.list',
                              '--cv_data', d + '/data.list',
                              '--model_dir', out + '/exp', '--device', 'cpu',
                              '--override_config',
                              'cmvn_conf.cmvn_file ' + out + '/cmvn'])
        assert [e['steps'] for e in summary['epochs']] == [4, 4]
        assert average_model.main(['--src_path', out + '/exp', '--num', '2',
                                   '--dst_model', out + '/exp/avg.pt'])
        bad = [m for m in sys.modules if m.split('.')[0] in ('jax',
                                                             'wenet_tpu')]
        assert not bad, bad
        print('ok')
    ''')
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join([REPO, env.get('PYTHONPATH', '')])
    res = subprocess.run([sys.executable, '-c', code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith('ok')
