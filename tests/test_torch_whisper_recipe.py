"""Whisper large-v3's recipe (examples/aishell/whisper/conf/
finetune_whisper_largev3.yaml) and a BPE yaml (examples/librispeech/s0/
conf/train_conformer_bpe.yaml) through the port's entry points against
the JAX package's, on the CPU, at a tiny width (2 + 2 blocks of 64, LoRA
as the yaml sets it) on wavs, a rank file, a piece list and data lists
the tests write.

The whisper yaml runs neither package's entry points as written: it sets
no `feats_type` (so both make a 23-bin fbank for a 128-bin input), its
log-mel conf names `frame_shift` and `frame_length`, which
`compute_log_mel_spectrogram` does not take, and it has no
`ctc_conf.ctc_blank_id` (which `get_blank_id` asserts).  The tests run
it with whisper's log-mel front end (n_fft 400, hop 160, 128 bins) and
blank id as models/whisper/convert.py `build_config` writes them, and set
the tokenizer's special tokens in `tokenizer_conf` (a small rank file
does not have large-v3's 50257 text ranks).

- `bin/recognize.main --modes attention`, with and without
  `--timestamps`: text and segments files identical to the JAX package's.
- `bin/train.py`, two epochs of one step from one `--checkpoint` (both
  trainers load it), then `average_model`: per-step and cv losses within
  rtol 1e-4, each epoch's weights within 1e-6 of the JAX trainer's (the
  bars of tests/test_torch_train_main.py), the average the mean of the
  epochs, loading strictly into the LoRA model; a resume from epoch_0
  continues at step 2 with the unbroken run's loss; a checkpoint without
  LoRA factors (models/whisper/convert.py's) starts training.
- The BPE yaml, shrunk as tests/test_torch_example_configs.py shrinks it,
  with a stub `sentencepiece` in both packages: one `bin/train.py` step
  against the JAX trainer, then `bin/recognize.main` on its checkpoint.

The JAX trainers run in subprocesses (they set process-wide JAX state)."""

import copy
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import yaml

from test_torch_train_main import (_assert_same_losses, _captured, _env,
                                   _jax_weights, _parse, _speech)
from chip_smoke import EN_WORDS, learn_byte_ranks, zh_en_lines
from torch_port_utils import stub_sentencepiece_module, write_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WHISPER_YAML = os.path.join(
    REPO, 'examples/aishell/whisper/conf/finetune_whisper_largev3.yaml')
BPE_YAML = os.path.join(REPO,
                        'examples/librispeech/s0/conf/train_conformer_bpe.yaml')
N_UTTS = 4
TINY = dict(output_size=64, attention_heads=2, linear_units=128,
            num_blocks=2)
WEIGHT_ATOL = 1e-6
JAX_TRAINERS = {}  # name: the JAX trainer's process, started by `recipe`
EOT_BIAS = 12.0  # ends some beams of the shaped random decoder

_JAX_TRAIN = textwrap.dedent('''
    import logging, sys
    sys.modules['torch.utils.tensorboard'] = None
    import torch_port_utils
    sys.modules['sentencepiece'] = torch_port_utils.stub_sentencepiece_module()
    import jax
    jax.config.update('jax_platforms', 'cpu')
    logging.basicConfig(level=logging.INFO, format='%(message)s')
    from wenet_tpu.bin.train import main
    sys.argv = ['train.py'] + sys.argv[1:]
    main()
''')


def _load(path):
    with open(path, encoding='utf-8') as f:
        return yaml.safe_load(f)


def _write_yaml(path, cfg):
    with open(path, 'w', encoding='utf-8') as f:
        yaml.safe_dump(cfg, f, allow_unicode=True)
    return str(path)


def _data_conf(cfg, batch_size):
    """The yaml's dataset_conf without its random stages, in static
    batches."""
    dc = cfg['dataset_conf']
    dc.update(spec_aug=False, speed_perturb=False, shuffle=False,
              list_shuffle=False,
              batch_conf={'batch_type': 'static', 'batch_size': batch_size})
    dc.get('fbank_conf', {})['dither'] = 0.0


def whisper_yaml(d, tokenizer):
    """The finetune yaml at the tiny width with `build_config`'s front end
    and blank."""
    cfg = _load(WHISPER_YAML)
    cfg['encoder_conf'].update(TINY)
    cfg['decoder_conf'].update({k: v for k, v in TINY.items()
                                if k != 'output_size'})
    cfg['tokenizer_conf'].update(vocab_path=str(d / 'multilingual.tiktoken'),
                                 special_tokens=tokenizer.special_tokens)
    cfg['ctc_conf'] = {'ctc_blank_id': tokenizer.special_tokens['no_speech']}
    cfg['dataset_conf'].update(
        feats_type='log_mel_spectrogram',
        log_mel_spectrogram_conf={'n_fft': 400, 'hop_length': 160,
                                  'num_mel_bins': 128, 'padding': 0})
    _data_conf(cfg, N_UTTS)
    # Adam's eps 1e-3 as tests/test_torch_train_main.py sets it: rounding
    # noise on a gradient that is 0 stays far below a step
    cfg.update(accum_grad=1, max_epoch=2, log_interval=1,
               optim_conf={'lr': 0.002, 'eps': 1e-3},
               scheduler_conf={'warmup_steps': 4})
    return cfg


@pytest.fixture(scope='module')
def recipe(tmp_path_factory):
    """The whisper and the BPE recipe's files (`write_whisper`,
    `write_bpe`), with the JAX trainers started on both at once in the
    background (collected by `runs`)."""
    d = tmp_path_factory.mktemp('whisper_recipe')
    write_whisper(d)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, 'sentencepiece', stub_sentencepiece_module())
        write_bpe(d)
    procs = _start_jax_trainers({
        'whisper': _train_args(d, 'train.yaml', 'data.list', d / 'jax') +
        ['--checkpoint', str(d / 'init.pt')],
        'bpe': _train_args(d, 'bpe.yaml', 'bpe.list', d / 'bpe_jax') +
        ['--checkpoint', str(d / 'bpe_init.pt')]}, d)
    JAX_TRAINERS.update(procs)
    yield d
    for proc in procs.values():
        proc.kill()
        proc.communicate()


def write_whisper(d):
    """The rank file, wavs of 2-2.5 s with zh/en transcripts and their
    data list, the tiny whisper yaml, its JAX initial weights (lora_B drawn
    N(0, 0.05) so that LoRA shows) as init.pt and, with the decoder shaped
    and eot's bias raised, decode.pt."""
    import jax
    from wenet_tpu.utils.checkpoint import save_torch_checkpoint
    from wenet_tpu.utils.init_model import init_model, init_variables
    from wenet_tpu_torch.dataset.audio import write_wav
    from wenet_tpu_torch.text.whisper_tokenizer import WhisperTokenizer
    rng = np.random.RandomState(0)
    lines = zh_en_lines(rng, 120)
    write_ranks(d / 'multilingual.tiktoken', learn_byte_ranks(lines, 200))
    tokenizer = WhisperTokenizer(vocab_path=str(d / 'multilingual.tiktoken'))
    entries = []
    for i in range(N_UTTS):
        path = d / f'w{i}.wav'
        write_wav(str(path), _speech(rng, 2.0 + 0.15 * i), 16000)
        entries.append({'key': f'w{i}', 'wav': str(path), 'txt': lines[i]})
    (d / 'data.list').write_text(''.join(
        json.dumps(e, ensure_ascii=False) + '\n' for e in entries),
        encoding='utf-8')
    cfg = whisper_yaml(d, tokenizer)
    _write_yaml(d / 'train.yaml', cfg)
    jcfg = dict(copy.deepcopy(cfg), input_dim=128,
                output_dim=tokenizer.vocab_size())
    model, jcfg = init_model(None, jcfg)
    variables, _ = init_variables(model, jcfg, jax.random.PRNGKey(3))
    draw = np.random.RandomState(4)

    def lora_b(path, leaf):
        if path[-1].key == 'lora_B':
            return (0.05 * draw.randn(*np.shape(leaf))).astype(np.float32)
        return np.asarray(leaf)

    variables = jax.tree_util.tree_map_with_path(lora_b, variables)
    save_torch_checkpoint(variables, str(d / 'init.pt'))
    # random tied N(0, 1) embeddings repeat one token: embeddings N(0,
    # 0.02), learned positions N(0, 1) and an output of ~7 logits' spread
    # (chip_smoke.py `shape_decoder_weights`), and eot raised so that
    # some beams end
    dec = variables['params']['decoder']
    dec['embed']['embedding'] = (0.02 * draw.randn(
        *dec['embed']['embedding'].shape)).astype(np.float32)
    dec['pos_enc']['pe'] = draw.randn(*dec['pos_enc']['pe'].shape).astype(
        np.float32)
    dec['after_norm']['scale'] = np.full_like(
        dec['after_norm']['scale'], 7.0 / (0.02 * TINY['output_size'] ** 0.5))
    bias = np.array(dec['output_layer']['bias'])
    bias[tokenizer.special_tokens['eot']] += EOT_BIAS
    dec['output_layer']['bias'] = bias
    save_torch_checkpoint(variables, str(d / 'decode.pt'))


def _jax_recognize(monkeypatch, argv):
    from wenet_tpu.bin import recognize
    monkeypatch.setattr(sys, 'argv', ['recognize.py'] + argv)
    recognize.main()


def _files(result_dir, mode, names):
    return {n: open(os.path.join(result_dir, mode, n),
                    encoding='utf8').read() for n in names}


@pytest.mark.parametrize('timestamps', [False, True])
def test_whisper_recognize_matches_jax(recipe, tmp_path, monkeypatch,
                                       timestamps):
    from wenet_tpu_torch.bin import recognize
    monkeypatch.setenv('WENET_TPU_NO_COMPILE_CACHE', '1')
    d = recipe
    argv = ['--config', str(d / 'train.yaml'), '--test_data',
            str(d / 'data.list'), '--checkpoint', str(d / 'decode.pt'),
            '--batch_size', '4', '--beam_size', '3', '--modes', 'attention']
    argv += ['--timestamps'] if timestamps else []
    names = ['text', 'segments'] if timestamps else ['text']
    summary = recognize.main(argv + ['--result_dir', str(tmp_path / 'port'),
                                     '--device', 'cpu'])
    assert summary['lines'] == {'attention': N_UTTS}
    _jax_recognize(monkeypatch, argv + ['--result_dir',
                                        str(tmp_path / 'jax')])
    got = _files(tmp_path / 'port', 'attention', names)
    want = _files(tmp_path / 'jax', 'attention', names)
    assert got == want
    # '\n' only: a decoded token may be another line boundary
    texts = [line.split(' ', 1) for line in got['text'].split('\n')[:-1]]
    assert len(texts) == N_UTTS and sum(len(t[1]) > 0 for t in texts) >= 2
    if timestamps:
        assert got['segments'].count('\n') >= N_UTTS


def _start_jax_trainers(runs, cwd):
    """{name: argv} through the JAX trainer, all at once -> {name:
    Popen}."""
    # one device, as the port: on the 8 virtual devices tests/conftest.py
    # sets, the JAX trainer pads a batch to 8 rows, and whisper's loss
    # divides by the rows
    env = dict(_env(), XLA_FLAGS='--xla_force_host_platform_device_count=1')
    return {k: subprocess.Popen(
        [sys.executable, '-c', _JAX_TRAIN] + argv, env=env, cwd=str(cwd),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for k, argv in runs.items()}


def _port_train(argv):
    from wenet_tpu_torch.bin.train import main
    with _captured() as lines:
        summary = main(argv + ['--device', 'cpu'])
    return _parse('\n'.join(lines)), summary


def _train_args(d, config, data, model_dir):
    return ['--config', str(d / config), '--train_data', str(d / data),
            '--cv_data', str(d / data), '--model_dir', str(model_dir)]


def write_bpe(d):
    """units.txt and a piece list for the stub, the librispeech s0 yaml
    shrunk (2 blocks, 64 linear units, no cmvn) on the whisper recipe's
    wavs with English transcripts, and the initial weights the port draws
    for it as bpe_init.pt."""
    from wenet_tpu_torch.bin import train
    from wenet_tpu_torch.utils.checkpoint import save_checkpoint
    pieces = ['<unk>', '▁'] + sorted({w.upper() for w in EN_WORDS}) + \
        [f'▁{w.upper()}' for w in EN_WORDS[:6]] + \
        list('ABCDEFGHIJKLMNOPRSTUVWY')
    (d / 'bpe.model').write_text('\n'.join(pieces) + '\n', encoding='utf-8')
    # the yaml's special_tokens put <sos> and <eos> at 2
    syms = ['<blank>', '<unk>', '<sos/eos>'] + pieces[1:]
    (d / 'units.txt').write_text(''.join(f'{s} {i}\n'
                                         for i, s in enumerate(syms)),
                                 encoding='utf-8')
    rng = np.random.RandomState(5)
    entries = [json.loads(line) for line in
               (d / 'data.list').read_text(encoding='utf-8').splitlines()]
    for e in entries:
        e['txt'] = ' '.join(rng.choice(EN_WORDS, size=3))
    (d / 'bpe.list').write_text(''.join(json.dumps(e) + '\n'
                                        for e in entries))
    cfg = _load(BPE_YAML)
    for conf in (cfg['encoder_conf'], cfg['decoder_conf']):
        conf.update({k: v for k, v in (('num_blocks', 2), ('r_num_blocks', 1),
                                       ('linear_units', 64)) if k in conf})
        for k in conf:
            if k.endswith('dropout_rate'):
                conf[k] = 0.0
    cfg['encoder_conf']['cnn_module_kernel'] = 7
    cfg['tokenizer_conf'].update(symbol_table_path=str(d / 'units.txt'),
                                 bpe_path=str(d / 'bpe.model'))
    cfg['cmvn'] = None
    _data_conf(cfg, N_UTTS)
    cfg['dataset_conf']['pad_conf'] = {'pad_to_multiple': 256}
    cfg.update(accum_grad=1, max_epoch=1, log_interval=1,
               optim_conf={'lr': 0.002, 'eps': 1e-3},
               scheduler_conf={'warmup_steps': 4})
    cfg['encoder_conf']['use_dynamic_chunk'] = False
    _write_yaml(d / 'bpe.yaml', cfg)
    args = train.get_parser().parse_args(
        _train_args(d, 'bpe.yaml', 'bpe.list', d / 'bpe_port') +
        ['--device', 'cpu'])
    save_checkpoint(train.build(args).model, str(d / 'bpe_init.pt'))


@pytest.fixture(scope='module')
def runs(recipe):
    """The port's trainer on the whisper yaml (two epochs from init.pt),
    resumed from its epoch_0, and on the BPE yaml (one step from
    bpe_init.pt); then the JAX trainers' logs for the same runs."""
    d = recipe
    port = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, 'sentencepiece', stub_sentencepiece_module())
        port['whisper'] = _port_train(
            _train_args(d, 'train.yaml', 'data.list', d / 'port') +
            ['--checkpoint', str(d / 'init.pt')])
        port['resumed'] = _port_train(
            _train_args(d, 'train.yaml', 'data.list', d / 'port_resumed') +
            ['--checkpoint', str(d / 'port' / 'epoch_0.pt')])
        port['bpe'] = _port_train(
            _train_args(d, 'bpe.yaml', 'bpe.list', d / 'bpe_port') +
            ['--checkpoint', str(d / 'bpe_init.pt')])
    jax_runs = {}
    for k, proc in JAX_TRAINERS.items():
        log, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, log[-3000:]
        jax_runs[k] = _parse(log)
    return port, jax_runs


def test_whisper_train_matches_jax_per_step(runs):
    port, jax_runs = runs
    got, want = port['whisper'][0], jax_runs['whisper']
    assert [s[:2] for s in got[0]] == [(0, 1), (1, 2)]
    _assert_same_losses(got, want, keys=('loss', 'loss_att', 'lr'))


def _assert_weights(got_path, want, init):
    """Each weight within 1% of the JAX trainer's largest change of it
    over the run, + 1e-6 (tests/test_torch_train_main.py's bar): Adam (eps
    1e-3) steps carry the gradients' float32 rounding across, up to 1.4e-6
    on a change of 2e-3 here."""
    got = torch.load(got_path, weights_only=True)
    assert set(got) == set(want)
    moved = 0
    for k, w in want.items():
        if k.endswith('num_batches_tracked'):  # the JAX package has none
            continue
        change = (w - init[k]).abs().max().item()
        np.testing.assert_allclose(got[k].numpy(), w.numpy(),
                                   atol=WEIGHT_ATOL + 0.01 * change, rtol=0,
                                   err_msg=k)
        moved += change > 0
    assert moved > len(want) // 2


@pytest.mark.parametrize('epoch', [0, 1])
def test_whisper_epoch_weights_match_jax(recipe, runs, epoch):
    d = recipe
    init = torch.load(d / 'init.pt', weights_only=True)
    _assert_weights(d / 'port' / f'epoch_{epoch}.pt',
                    _jax_weights(d / 'jax' / f'epoch_{epoch}'), init)


def test_whisper_average_loads_strictly(recipe, runs):
    """average_model of the two epochs: the mean of the JAX trainer's
    epochs within the weight bar, every LoRA factor in it, and a strict
    load into the yaml's LoRA model."""
    from wenet_tpu_torch.bin import average_model
    from wenet_tpu_torch.utils.checkpoint import load_model
    from wenet_tpu_torch.utils.config import load_config
    d = recipe
    chosen = average_model.main(['--src_path', str(d / 'port'), '--dst_model',
                                 str(d / 'avg.pt'), '--num', '2'])
    assert len(chosen) == 2
    avg = torch.load(d / 'avg.pt', weights_only=True)
    e0, e1 = (_jax_weights(d / 'jax' / f'epoch_{e}') for e in (0, 1))
    for k, v in avg.items():
        np.testing.assert_allclose(v.numpy(), ((e0[k] + e1[k]) / 2).numpy(),
                                   atol=WEIGHT_ATOL, rtol=0, err_msg=k)
    lora = [k for k in avg if k.endswith(('.lora_A', '.lora_B'))]
    assert len(lora) == 2 * 4 * 2  # q, k, v, o of the 2 encoder blocks
    configs = load_config(str(d / 'port' / 'train.yaml'))
    model = load_model(configs, str(d / 'avg.pt'), 'cpu')
    assert set(model.state_dict()) == set(avg)


def test_whisper_resume_continues_the_run(runs):
    """From epoch_0 the port trains epoch 1 at step 2, its first loss the
    unbroken run's (the weights are the same; Adam's moments are not
    saved, as in the JAX trainer)."""
    port, _ = runs
    (steps, _), _ = port['resumed']
    (unbroken, _), _ = port['whisper']
    assert [s[:2] for s in steps] == [(1, 2)]
    np.testing.assert_allclose(steps[0][2]['loss'], unbroken[1][2]['loss'],
                               rtol=1e-6)


def test_whisper_train_from_a_checkpoint_without_lora(recipe, tmp_path):
    """A checkpoint written before LoRA (the layout models/whisper/
    convert.py writes) starts the LoRA yaml: its LoRA factors keep their
    initial values, every other weight is loaded."""
    from wenet_tpu_torch.bin import train
    d = recipe
    init = torch.load(d / 'init.pt', weights_only=True)
    plain = {k: v for k, v in init.items()
             if not k.endswith(('.lora_A', '.lora_B'))}
    torch.save(plain, tmp_path / 'converted.pt')
    args = train.get_parser().parse_args(
        _train_args(d, 'train.yaml', 'data.list', tmp_path / 'exp') +
        ['--checkpoint', str(tmp_path / 'converted.pt'), '--device', 'cpu'])
    run = train.build(args)
    own = run.model.state_dict()
    for k, v in plain.items():
        assert torch.equal(own[k], v), k
    lora_b = [v for k, v in own.items() if k.endswith('.lora_B')]
    assert lora_b and all(not v.any() for v in lora_b)


def test_bpe_yaml_trains_and_recognizes_as_jax(recipe, runs, tmp_path,
                                               monkeypatch):
    port, jax_runs = runs
    d = recipe
    _assert_same_losses(port['bpe'][0], jax_runs['bpe'])
    init = torch.load(d / 'bpe_init.pt', weights_only=True)
    _assert_weights(d / 'bpe_port' / 'epoch_0.pt',
                    _jax_weights(d / 'bpe_jax' / 'epoch_0'), init)
    # the trained checkpoint with the CTC blank lowered, so that the
    # prefix beam's hypotheses hold pieces for the tokenizer to join
    state = torch.load(d / 'bpe_port' / 'epoch_0.pt', weights_only=True)
    state['ctc.ctc_lo.bias'][0] -= 20.0
    torch.save(state, tmp_path / 'decode.pt')
    from wenet_tpu_torch.bin import recognize
    monkeypatch.setitem(sys.modules, 'sentencepiece',
                        stub_sentencepiece_module())
    monkeypatch.setenv('WENET_TPU_NO_COMPILE_CACHE', '1')
    argv = ['--config', str(d / 'bpe_port' / 'train.yaml'), '--test_data',
            str(d / 'bpe.list'), '--checkpoint', str(tmp_path / 'decode.pt'),
            '--batch_size', '4', '--beam_size', '3', '--ctc_weight', '0.3',
            '--modes', 'attention_rescoring']
    recognize.main(argv + ['--result_dir', str(tmp_path / 'port'),
                           '--device', 'cpu'])
    _jax_recognize(monkeypatch, argv + ['--result_dir',
                                        str(tmp_path / 'jax')])
    got = _files(tmp_path / 'port', 'attention_rescoring', ['text'])
    assert got == _files(tmp_path / 'jax', 'attention_rescoring', ['text'])
    texts = [line.split(' ', 1) for line in got['text'].split('\n')[:-1]]
    assert len(texts) == N_UTTS and all(len(t[1]) > 0 for t in texts)
