"""The port's training entry point against the JAX package's, on the CPU, at
the tiny width of tests/torch_port_utils.py (one block each), on wavs, a
dict, a cmvn file and data lists the tests write.

- `bin/train.py`: the port's from the JAX initial weights (carried across
  with `state_dict_from_jax`) against the JAX trainer on the same data
  list, dropout 0 and no dynamic chunk (the random streams differ between
  the packages): per-step train losses and per-epoch cv losses within
  rtol 1e-4 over two epochs; each weight's change over the run within 1%
  (+1e-6) of the JAX trainer's.
- Resume from `epoch_0` with accum_grad 3, resumed at step 4 (not a
  multiple of 3): it equals the JAX trainer resumed from the same
  checkpoint, as both restart the accumulation window.
- `compute_cmvn_stats` against tools/compute_cmvn_stats.py, the cmvn
  stats loaded before the checkpoint, the trained model directory
  through the port's `decoder_main`, the cv pipeline, what raises.

tests/test_torch_train_main_paths.py holds the entry point's other
paths (resume without optimizer state, the resume against optax's
MultiSteps, `average_model`, the profiler window, bf16, a jax-free
subprocess), on this file's recipe; the two run on two workers.

The JAX trainer runs in subprocesses: it sets process-wide JAX state (the
PRNG implementation, the flash-attention switch)."""

import copy
import json
import logging
import os
import re
import subprocess
import sys
import textwrap
from contextlib import contextmanager

import numpy as np
import pytest
import torch
import yaml

from torch_port_utils import TINY_CONFIG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHARS = '你好世界天地人和'
N_UTTS = 12  # 4 static batches of 3: one padded shape per package
_TRAIN = re.compile(r'TRAIN \| epoch (\d+) step (\d+) \| (.*) \|')

# The JAX trainer in a process of its own, with the tier-1 CPU mesh of 8
# virtual devices; TensorBoard (which imports TensorFlow) is kept out.
_JAX_TRAIN = textwrap.dedent('''
    import logging, sys
    sys.modules['torch.utils.tensorboard'] = None
    import jax
    jax.config.update('jax_platforms', 'cpu')
    logging.basicConfig(level=logging.INFO, format='%(message)s')
    from wenet_tpu.bin.train import main
    sys.argv = ['train.py'] + sys.argv[1:]
    main()
''')


def _env():
    env = dict(os.environ, JAX_PLATFORMS='cpu',
               XLA_FLAGS='--xla_force_host_platform_device_count=8')
    env['PYTHONPATH'] = os.pathsep.join(
        [REPO, os.path.join(REPO, 'tests'), env.get('PYTHONPATH', '')])
    return env


def _parse(log: str):
    """-> ([(epoch, step, {metric: value})], [cv loss dict per epoch])."""
    steps = []
    for m in _TRAIN.finditer(log):
        kv = m.group(3).split()
        steps.append((int(m.group(1)), int(m.group(2)),
                      {k: float(v) for k, v in zip(kv[::2], kv[1::2])}))
    cvs = [eval(m.group(1), {}) for m in re.finditer(  # noqa: S307
        r'Epoch \d+ CV info (\{.*\})', log)]
    return steps, cvs


@contextmanager
def _captured():
    """Log records of the root logger, at INFO, as one string."""
    lines = []

    class Handler(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    root = logging.getLogger()
    handler, level = Handler(), root.level
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    try:
        yield lines
    finally:
        root.removeHandler(handler)
        root.setLevel(level)


def _port_train(argv, on_step=None):
    from wenet_tpu_torch.bin.train import main
    with _captured() as lines:
        summary = main(argv + ['--device', 'cpu'], on_step=on_step)
    return _parse('\n'.join(lines)), summary


def _speech(rng, seconds, rate=16000):
    n = int(seconds * rate)
    t = np.arange(n) / rate
    x = 0.1 * rng.randn(n) + 0.2 * np.sin(2 * np.pi * 440 * t) * (
        np.sin(2 * np.pi * 2 * t) > 0)
    return (np.round(np.clip(x, -1, 1) * 32767) / 32768).astype(np.float32)


def _config(d, **kw):
    cfg = copy.deepcopy(TINY_CONFIG)
    del cfg['input_dim'], cfg['output_dim']
    for conf in (cfg['encoder_conf'], cfg['decoder_conf']):
        for k in conf:
            if k.endswith('dropout_rate'):
                conf[k] = 0.0
    # one block each: the JAX trainer's compile time grows with depth
    cfg['encoder_conf'].update(use_dynamic_chunk=False, num_blocks=1)
    cfg['decoder_conf'].update(num_blocks=1, r_num_blocks=1)
    cfg['tokenizer'] = 'char'
    cfg['tokenizer_conf'].update(symbol_table_path=str(d / 'units.txt'),
                                 non_lang_syms_path=None)
    cfg['cmvn_conf'] = {'cmvn_file': str(d / 'global_cmvn'),
                        'is_json_cmvn': True}
    cfg['dataset_conf'] = {
        'filter_conf': {'max_length': 4000, 'min_length': 0,
                        'token_min_length': 1},
        'resample_conf': {'resample_rate': 16000},
        'fbank_conf': {'num_mel_bins': 40, 'dither': 0.0},
        'batch_conf': {'batch_type': 'static', 'batch_size': 3},
        'pad_conf': {'pad_to_multiple': 256, 'label_pad_to_multiple': 8},
        'shuffle': False, 'list_shuffle': False, 'sort': True,
        'spec_aug': False}
    # Adam's eps is 1e-3, not 1e-8: a parameter whose true gradient is 0
    # (a key bias, which softmax cancels) gets rounding noise as its
    # gradient, and eps 1e-8 turns that into steps of +-lr, different in
    # each package
    cfg.update(grad_clip=5.0, accum_grad=1, max_epoch=2, log_interval=1,
               optim='adam', optim_conf={'lr': 0.002, 'eps': 1e-3},
               scheduler='warmuplr', scheduler_conf={'warmup_steps': 4})
    cfg.update(kw)
    return cfg


def _write_yaml(path, cfg):
    with open(path, 'w', encoding='utf-8') as f:
        yaml.safe_dump(cfg, f, allow_unicode=True)
    return str(path)


@pytest.fixture(scope='module')
def recipe(tmp_path_factory):
    """Wavs (one at 8 kHz), their data list and wav.scp, a dict, the cmvn
    stats, train.yaml and the JAX trainer's initial weights as a .pt."""
    from wenet_tpu_torch.bin.compute_cmvn_stats import main as cmvn_main
    from wenet_tpu_torch.dataset.audio import write_wav
    from wenet_tpu_torch.utils.checkpoint import state_dict_from_jax
    d = tmp_path_factory.mktemp('train_main')
    rng = np.random.RandomState(0)
    syms = ['<blank>', '<unk>', '<sos/eos>'] + list(CHARS)
    (d / 'units.txt').write_text(''.join(f'{s} {i}\n'
                                         for i, s in enumerate(syms)),
                                 encoding='utf-8')
    entries = []
    for i in range(N_UTTS):
        rate = 8000 if i == 5 else 16000
        path = d / f'u{i}.wav'
        write_wav(str(path), _speech(rng, 0.6 + 0.13 * i, rate), rate)
        txt = ''.join(rng.choice(list(CHARS), size=2 + i % 4))
        entries.append({'key': f'u{i}', 'wav': str(path), 'txt': txt})
    (d / 'data.list').write_text(''.join(
        json.dumps(e, ensure_ascii=False) + '\n' for e in entries),
        encoding='utf-8')
    (d / 'wav.scp').write_text(''.join(f'{e["key"]} {e["wav"]}\n'
                                       for e in entries))
    cfg = _config(d)
    _write_yaml(d / 'train.yaml', cfg)
    cmvn_main(['--train_config', str(d / 'train.yaml'), '--in_scp',
               str(d / 'wav.scp'), '--out_cmvn', str(d / 'global_cmvn')])
    _, _, variables = _jax_init(cfg)
    torch.save(state_dict_from_jax(variables), d / 'init.pt')
    return d


def _jax_init(cfg):
    """(model, configs, variables) of the JAX package for `cfg`, drawn as
    the JAX trainer draws them: PRNGKey(--seed) under its --prng_impl
    default."""
    import jax
    from wenet_tpu.utils.init_model import init_model, init_variables
    jcfg = dict(copy.deepcopy(cfg), input_dim=40, output_dim=3 + len(CHARS))
    model, jcfg = init_model(None, jcfg)
    impl = jax.config.jax_default_prng_impl
    jax.config.update('jax_default_prng_impl', 'unsafe_rbg')
    try:
        variables, _ = init_variables(model, jcfg, jax.random.PRNGKey(777))
    finally:
        jax.config.update('jax_default_prng_impl', impl)
    return model, jcfg, variables


def _train_args(d, model_dir, config='train.yaml'):
    return ['--config', str(d / config), '--train_data',
            str(d / 'data.list'), '--cv_data', str(d / 'data.list'),
            '--model_dir', str(model_dir)]


@pytest.fixture(scope='module')
def runs(recipe):
    """The JAX trainer, unbroken (accum 1) and resumed from the port's
    accum-3 epoch_0 (two processes at once), and the port's trainer for
    the same runs."""
    d = recipe
    _write_yaml(d / 'accum3.yaml', _config(d, accum_grad=3))
    port_a3 = d / 'port_a3'
    _port_train(_train_args(d, port_a3, 'accum3.yaml') + [
        '--checkpoint', str(d / 'init.pt'), '--override_config',
        'max_epoch 1'])
    jax_runs = {
        'unbroken': _train_args(d, d / 'jax_a1'),
        'resumed_a3': _train_args(d, d / 'jax_a3', 'accum3.yaml') + [
            '--checkpoint', str(port_a3 / 'epoch_0.pt')]}
    procs = {k: subprocess.Popen(
        [sys.executable, '-c', _JAX_TRAIN] + argv, env=_env(), cwd=str(d),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for k, argv in jax_runs.items()}
    out = {}
    for k, proc in procs.items():
        log, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, log[-3000:]
        out['jax_' + k] = (_parse(log), None)
    out['port_unbroken'] = _port_train(
        _train_args(d, d / 'port_a1') + ['--checkpoint',
                                         str(d / 'init.pt')])
    out['port_resumed_a3'] = _port_train(
        _train_args(d, port_a3, 'accum3.yaml') + [
            '--checkpoint', str(port_a3 / 'epoch_0.pt')])
    return out


def _assert_same_losses(got, want, keys=('loss', 'loss_att', 'loss_ctc',
                                         'lr')):
    (gsteps, gcv), (wsteps, wcv) = got, want
    assert [s[:2] for s in gsteps] == [s[:2] for s in wsteps]
    for (epoch, step, g), (_, _, w) in zip(gsteps, wsteps):
        for k in keys:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4,
                                       err_msg=f'epoch {epoch} step {step} '
                                               f'{k}')
    assert len(gcv) == len(wcv) > 0
    for g, w in zip(gcv, wcv):
        for k in keys:
            if k != 'lr':
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)


def test_train_matches_jax_per_step(runs):
    got, want = runs['port_unbroken'][0], runs['jax_unbroken'][0]
    assert [s[:2] for s in got[0]] == [(e, s) for e in (0, 1)
                                       for s in range(4 * e + 1, 4 * e + 5)]
    _assert_same_losses(got, want)


def _jax_weights(path):
    import orbax.checkpoint as ocp
    from wenet_tpu_torch.utils.checkpoint import state_dict_from_jax
    return state_dict_from_jax(ocp.PyTreeCheckpointer().restore(
        os.path.abspath(path)))


# Leaves held to a looser bar in test_epoch_weights_match_jax: the
# subsampling convs, whose Adam steps (eps 1e-3) carry their gradients'
# float32 rounding (test_step_gradients_are_float32_rounding) across; the
# worst read 1.43e-5 on a change of 9.9e-3 (`-s` prints every leaf).
ROUNDING_LEAVES = ('encoder.embed.conv.0.weight', 'encoder.embed.conv.0.bias',
                   'encoder.embed.conv.2.weight', 'encoder.embed.conv.2.bias')
ROUNDING_ATOL = 5e-5


@pytest.mark.parametrize('run', ['unbroken', 'resumed_a3'])
def test_epoch_weights_match_jax(recipe, runs, run):
    """epoch_1 after eight (accum 1) or four more (accum 3) micro-steps:
    every weight within 1e-6 of the JAX trainer's (the bar of
    tests/test_torch_train.py's optimizer test, fed identical gradients),
    but ROUNDING_LEAVES within ROUNDING_ATOL.  Prints each leaf's gap and
    the gap over the largest change of that leaf."""
    d = recipe / {'unbroken': 'a1', 'resumed_a3': 'a3'}[run]
    got = torch.load(str(d).replace('/a', '/port_a') + '/epoch_1.pt',
                     weights_only=True)
    want = _jax_weights(str(d).replace('/a', '/jax_a') + '/epoch_1')
    init = torch.load(recipe / 'init.pt', weights_only=True)
    gaps = {}
    for k, w in want.items():
        if k.endswith('num_batches_tracked'):
            continue
        gap = (got[k] - w).abs().max().item()
        gaps[k] = (gap, gap / max((w - init[k]).abs().max().item(), 1e-30))
    print(f'\n{run}: leaf, max |port - jax|, over max |jax change|')
    for k, (gap, rel) in sorted(gaps.items(), key=lambda kv: -kv[1][0]):
        print(f'  {k} {gap:.3e} {rel:.3e}')
    for k, w in want.items():
        if k in gaps:
            np.testing.assert_allclose(
                got[k].numpy(), w.numpy(), err_msg=k,
                atol=ROUNDING_ATOL if k in ROUNDING_LEAVES else 1e-6)


def test_step_gradients_are_float32_rounding(recipe):
    """The gap that ROUNDING_LEAVES carry is float32 rounding: on the
    first two batches of the recipe, from the initial weights, the JAX
    package's float32 gradient and the port's each lie within 2e-5 of the
    largest float64 gradient of every leaf, + 1e-7 for the leaves whose
    exact gradient is 0 (the port's model in float64 as the reference;
    read: 6.0e-6 of it at worst, 1.2e-8 on the key biases)."""
    import jax
    import jax.numpy as jnp
    from torch_port_utils import torch_model
    from wenet_tpu_torch.dataset.dataset import Dataset
    from wenet_tpu_torch.utils.checkpoint import state_dict_from_jax
    from wenet_tpu_torch.utils.init_tokenizer import init_tokenizer
    cfg = yaml.safe_load((recipe / 'train.yaml').read_text())
    model, jcfg, variables = _jax_init(cfg)
    keys = ('feats', 'feats_lengths', 'target', 'target_lengths')
    data = Dataset('raw', str(recipe / 'data.list'), init_tokenizer(cfg),
                   dict(cfg['dataset_conf'], prefetch=0), seed=777)
    grad = jax.jit(jax.grad(lambda params, *b: model.apply(
        {**variables, 'params': params}, *b, train=True)['loss']))
    models = {dt: torch_model(jcfg, variables).train().to(dt)
              for dt in (torch.float32, torch.float64)}
    worst = 0.0
    for _, batch in zip(range(2), data):
        jax_g = state_dict_from_jax({'params': grad(
            variables['params'], *(jnp.asarray(batch[k]) for k in keys))})
        port_g = {}
        for dt, m in models.items():
            m.zero_grad()
            b = [torch.as_tensor(np.asarray(batch[k])) for k in keys]
            m(b[0].to(dt), *b[1:])['loss'].backward()
            port_g[dt] = {n: p.grad.double()
                          for n, p in m.named_parameters()}
        for n, g64 in port_g[torch.float64].items():
            bar = 2e-5 * g64.abs().max().item() + 1e-7
            for who, g in (('port', port_g[torch.float32][n]),
                           ('jax', jax_g[n].double())):
                gap = (g - g64).abs().max().item()
                assert gap <= bar, (who, n, gap, bar)
                worst = max(worst, gap / bar)
    print(f'\nworst float32 gradient gap: {worst:.3f} of its bar')


def test_epoch_checkpoints_and_final_link(recipe, runs):
    from wenet_tpu_torch.utils.checkpoint import find_checkpoint
    d = recipe / 'port_a1'
    for epoch in (0, 1):
        with open(d / f'epoch_{epoch}.yaml') as f:
            infos = yaml.safe_load(f)
        assert sorted(infos) == ['cv_loss', 'epoch', 'save_time', 'step',
                                 'tag']
        assert (infos['epoch'], infos['step'], infos['tag']) == (
            epoch, 4 * epoch + 4, f'epoch_{epoch}')
        np.testing.assert_allclose(infos['cv_loss'],
                                   runs['port_unbroken'][0][1][epoch]['loss'])
    assert os.readlink(d / 'final.pt') == 'epoch_1.pt'
    assert os.readlink(d / 'final.yaml') == 'epoch_1.yaml'
    assert find_checkpoint(str(d)) == str(d / 'final.pt')
    with open(d / 'train.yaml') as f:
        saved = yaml.safe_load(f)
    assert (saved['input_dim'], saved['output_dim']) == (40, 3 + len(CHARS))


def test_resume_mid_window_matches_jax_trainer(runs):
    """accum_grad 3, resumed at step 4: the port's epoch 1 equals the JAX
    trainer's resumed from the same epoch_0.pt (losses, cv; the weights in
    test_epoch_weights_match_jax).  The window restarts at step 4, so the
    update at step 7 still uses schedule(4 // 3), the lr the port logs;
    the JAX trainer logs schedule(step // 3) there, not the lr it
    applies."""
    from wenet_tpu_torch.utils.scheduler import warmup_lr
    got, want = runs['port_resumed_a3'][0], runs['jax_resumed_a3'][0]
    assert [s[:2] for s in got[0]] == [(1, s) for s in range(5, 9)]
    _assert_same_losses(got, want, keys=('loss', 'loss_att', 'loss_ctc'))
    schedule = warmup_lr(0.002, 4)
    assert [s[2]['lr'] for s in got[0]] == [
        round(schedule(u), 6) for u in (1, 1, 1, 2)]


def test_compute_cmvn_stats_matches_tool(recipe, tmp_path):
    """The same JSON as tools/compute_cmvn_stats.py on the same wav.scp
    (an 8 kHz wav among them); load_cmvn of it loads in the model."""
    sys.path.insert(0, os.path.join(REPO, 'tools'))
    try:
        import compute_cmvn_stats as tool
    finally:
        sys.path.pop(0)
    old = sys.argv
    sys.argv = ['compute_cmvn_stats.py', '--train_config',
                str(recipe / 'train.yaml'), '--in_scp',
                str(recipe / 'wav.scp'), '--out_cmvn',
                str(tmp_path / 'jax_cmvn')]
    try:
        tool.main()
    finally:
        sys.argv = old
    with open(tmp_path / 'jax_cmvn') as f:
        want = json.load(f)
    with open(recipe / 'global_cmvn') as f:
        got = json.load(f)
    assert got['frame_num'] == want['frame_num'] > 0
    for k in ('mean_stat', 'var_stat'):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9, err_msg=k)


def test_cmvn_stats_load_before_the_checkpoint(recipe, runs):
    """The trainer writes the cmvn file's stats into the model, and a
    --checkpoint loaded after them wins."""
    from wenet_tpu_torch.utils.cmvn import load_cmvn
    mean, istd = load_cmvn(str(recipe / 'global_cmvn'), True)
    init = torch.load(recipe / 'init.pt', weights_only=True)
    trained = torch.load(recipe / 'port_a1' / 'epoch_0.pt',
                         weights_only=True)
    for key, want in (('mean', mean), ('istd', istd)):
        got = trained[f'encoder.global_cmvn.{key}'].numpy()
        np.testing.assert_array_equal(
            got, init[f'encoder.global_cmvn.{key}'].numpy())
        np.testing.assert_allclose(got, want, rtol=1e-6)
    fresh = _port_train(_train_args(recipe, recipe / 'no_ckpt') + [
        '--override_config', 'max_epoch 1'])[1]
    assert fresh['epochs'][0]['steps'] == 4
    state = torch.load(recipe / 'no_ckpt' / 'epoch_0.pt', weights_only=True)
    np.testing.assert_array_equal(
        state['encoder.global_cmvn.istd'].numpy(), istd)


def test_decoder_main_on_the_trained_model_dir(recipe, runs, tmp_path):
    """The trained directory (train.yaml, the dict it names, final.pt)
    decodes through the port's decoder_main on the CPU; a FLAC copy of a
    wav decodes to the wav's text."""
    from test_flac import encode_flac
    from wenet_tpu_torch.bin.decoder_main import main as decoder_main
    from wenet_tpu_torch.dataset.audio import read_wav
    wav = str(recipe / 'u3.wav')
    pcm = np.round(read_wav(wav)[0][0] * 32768).astype(np.int64)
    flac = tmp_path / 'u3.flac'
    flac.write_bytes(encode_flac([list(pcm)], frame_plan=[
        (4096, 'verbatim'), (len(pcm) - 4096, 'fixed2')]))
    scp = tmp_path / 'wav.scp'
    scp.write_text(f'u3 {wav}\nu3f {flac}\nu7 {recipe / "u7.wav"}\n')
    result = tmp_path / 'text'
    decoder_main(['--model_dir', str(recipe / 'port_a1'), '--wav_scp',
                  str(scp), '--result_file', str(result), '--device', 'cpu'])
    lines = result.read_text(encoding='utf-8').splitlines()
    assert [line.split(' ')[0] for line in lines] == ['u3', 'u3f', 'u7']
    assert lines[0].split(' ', 1)[1:] == lines[1].split(' ', 1)[1:]


# ---------------------------------------------------------------------------
# the entry point's other paths
# ---------------------------------------------------------------------------
def test_cv_pipeline_turns_augmentation_off(recipe):
    import types
    from wenet_tpu_torch.bin.train import datasets
    from wenet_tpu_torch.utils.init_tokenizer import init_tokenizer
    cfg = _config(recipe)
    cfg['dataset_conf'].update(speed_perturb=True, spec_aug=True,
                               spec_sub=True, spec_trim=True, shuffle=True,
                               list_shuffle=True, cycle=2)
    args = types.SimpleNamespace(prefetch=3, data_type='raw', seed=9,
                                 train_data=str(recipe / 'data.list'),
                                 cv_data=str(recipe / 'data.list'))
    train, cv = datasets(args, cfg, init_tokenizer(cfg))
    cv_batches = list(cv)
    assert len(cv_batches) == 4 and train.seed == cv.seed == 9
    assert sum(len(b['keys']) for b in train) == 2 * N_UTTS
    want = [b['feats'] for b in cv_batches]
    again = [b['feats'] for b in cv]
    for g, w in zip(again, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize('case', ['mesh', 'sharding_conf', 'world_size'])
def test_train_raises_for_what_is_not_ported(recipe, tmp_path, monkeypatch,
                                             case):
    """A mesh that does not span WORLD_SIZE, a sharding_conf key that is no
    layout and a multi-rank environment that torchrun did not set up
    raise (the layouts themselves: tests/test_torch_parallel.py)."""
    argv = _train_args(recipe, tmp_path / 'exp')
    for k in ('WORLD_SIZE', 'RANK', 'LOCAL_RANK', 'MASTER_ADDR',
              'MASTER_PORT'):
        monkeypatch.delenv(k, raising=False)
    if case == 'mesh':
        argv += ['--mesh', 'data=2']
        match = 'WORLD_SIZE is 1'
    elif case == 'sharding_conf':
        argv += ['--override_config', 'sharding_conf.fsdp true']
        match = 'fsdp'
    else:
        monkeypatch.setenv('WORLD_SIZE', '4')
        match = 'torchrun'
    with pytest.raises(ValueError, match=match):
        _port_train(argv)

