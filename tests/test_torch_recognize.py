"""The port's decode stage against the JAX package's at a tiny width, on
one set of weights (`convert_to_torch_state_dict`'s layout, written by the
JAX package's `save_torch_checkpoint`) and a data list of wavs the tests
write: `AsrRunner.decode` with a context graph, whisper-prompted
rescoring, `bin/recognize.py` in one mode (the JAX package's pipelined
branch) and what it raises for.  tests/test_torch_recognize_main.py holds
the rest of the decode stage on this file's recipe (several modes, a
context list, an ARPA LM, streaming, `bin/alignment.py`,
`bin/label_checker.py`, the cli and the servers' context and LM
options), so that the two run on two workers.

Bars: text files identical; hypotheses identical; scores within 2e-4 of
the JAX package's (the torch-import bar), the rescored ones within 2e-3
absolute / 1e-5 relative (as tests/test_torch_slice.py holds attention
rescoring)."""

import json
import os
import sys

import numpy as np
import pytest
import torch
import yaml

from test_torch_runtime import SYMS, _wave
from torch_port_utils import (IDIM, feats, jax_model, tiny_config,
                              torch_model, whisper_models)

MODES = ['ctc_greedy_search', 'ctc_prefix_beam_search',
         'attention_rescoring', 'attention']
DECODE = ['--batch_size', '3', '--beam_size', '4', '--ctc_weight', '0.3',
          '--reverse_weight', '0.3']
N_UTTS = 6


@pytest.fixture(autouse=True)
def jax_host_settings(request, monkeypatch):
    """No persistent compile cache from the JAX package's mains, and its
    streaming feature pipeline on the numpy fbank the port copies (not
    for the card's tests, which run where there is no JAX)."""
    if request.node.get_closest_marker('cuda'):
        return
    monkeypatch.setenv('WENET_TPU_NO_COMPILE_CACHE', '1')
    monkeypatch.setattr('wenet_tpu.runtime.native_fbank.available',
                        lambda: False)


@pytest.fixture(scope='module')
def recipe(tmp_path_factory):
    """units.txt, train.yaml, a JSON cmvn file, final.pt, six wavs of
    0.5-1.25 s with their data list (two batches of three), wav.scp and
    text, a context list of three phrases and a bigram ARPA LM over the
    chars."""
    from wenet_tpu.utils.checkpoint import save_torch_checkpoint
    from wenet_tpu_torch.dataset.audio import write_wav
    d = tmp_path_factory.mktemp('recognize')
    cfg = tiny_config()
    _, variables = jax_model(cfg, seed=31)
    save_torch_checkpoint(variables, str(d / 'final.pt'))
    (d / 'units.txt').write_text(''.join(f'{k} {v}\n'
                                         for k, v in SYMS.items()))
    (d / 'global_cmvn').write_text(json.dumps({
        'mean_stat': [3.0] * IDIM, 'var_stat': [40.0] * IDIM,
        'frame_num': 2}))
    for key in ('input_dim', 'output_dim'):
        del cfg[key]
    cfg.update({
        'tokenizer': 'char',
        'tokenizer_conf': dict(cfg['tokenizer_conf'],
                               symbol_table_path=str(d / 'units.txt'),
                               non_lang_syms_path=None,
                               split_with_space=False),
        'cmvn_conf': {'cmvn_file': str(d / 'global_cmvn'),
                      'is_json_cmvn': True},
        'dataset_conf': {
            'filter_conf': {'max_length': 4000, 'min_length': 0},
            'resample_conf': {'resample_rate': 16000},
            'fbank_conf': {'num_mel_bins': IDIM, 'frame_shift': 10,
                           'frame_length': 25, 'dither': 1.0},
            'spec_aug': True, 'shuffle': True, 'sort': True,
            # one padded length: the JAX package compiles once a shape
            'pad_conf': {'pad_to_multiple': 256},
            'batch_conf': {'batch_type': 'dynamic',
                           'max_frames_in_batch': 3000}},
    })
    with open(d / 'train.yaml', 'w') as f:
        yaml.safe_dump(cfg, f)
    rng = np.random.RandomState(0)
    chars = [c for c, i in SYMS.items() if i >= 3]
    entries = []
    for i in range(N_UTTS):
        path = d / f'u{i}.wav'
        write_wav(path, _wave(40 + i, 0.5 + 0.15 * i), 16000)
        entries.append({'key': f'u{i}', 'wav': str(path),
                        'txt': ''.join(rng.choice(chars, size=2 + i % 4))})
    (d / 'data.list').write_text(''.join(json.dumps(e) + '\n'
                                         for e in entries))
    # the per-utterance runs (streaming, alignment) take two: the JAX
    # package compiles each utterance's shapes
    (d / 'small.list').write_text(''.join(json.dumps(e) + '\n'
                                          for e in entries[4:]))
    (d / 'wav.scp').write_text(''.join(f'{e["key"]} {e["wav"]}\n'
                                       for e in entries))
    (d / 'text').write_text(''.join(f'{e["key"]} {e["txt"]}\n'
                                    for e in entries))
    (d / 'context.txt').write_text('abc\nkq\nxyz\n')
    lines = ['\\data\\', f'ngram 1={len(chars) + 3}', 'ngram 2=4', '',
             '\\1-grams:', '-99\t<s>\t-0.4', '-1.5\t</s>',
             '-2.5\t<unk>\t-0.2']
    lines += [f'{-1.0 - 0.05 * i:.2f}\t{c}\t-0.3'
              for i, c in enumerate(chars)]
    lines += ['', '\\2-grams:', '-0.2\t<s> a', '-0.3\ta b', '-0.1\tb c',
              '-0.4\tz </s>', '', '\\end\\', '']
    (d / 'lm.arpa').write_text('\n'.join(lines))
    return d


def _texts(result_dir, modes):
    return {m: open(os.path.join(result_dir, m, 'text'),
                    encoding='utf8').read() for m in modes}


def _jax_recognize(monkeypatch, argv):
    from wenet_tpu.bin import recognize
    monkeypatch.setattr(sys, 'argv', ['recognize.py'] + argv)
    recognize.main()


def _recognize_pair(recipe, tmp_path, monkeypatch, name, extra, modes,
                    data='data.list'):
    """(port texts, JAX texts) of one recognize run, {mode: text}."""
    from wenet_tpu_torch.bin import recognize
    argv = ['--config', str(recipe / 'train.yaml'), '--test_data',
            str(recipe / data), '--checkpoint',
            str(recipe / 'final.pt'), *DECODE, '--modes', *modes, *extra]
    port_dir, jax_dir = tmp_path / f'port_{name}', tmp_path / f'jax_{name}'
    summary = recognize.main(argv + ['--result_dir', str(port_dir),
                                     '--device', 'cpu'])
    n = len((recipe / data).read_text().splitlines())
    assert summary['lines'] == dict.fromkeys(modes, n)
    assert summary['seconds'] > 0 and summary['audio_seconds'] > 0
    _jax_recognize(monkeypatch, argv + ['--result_dir', str(jax_dir)])
    return _texts(port_dir, modes), _texts(jax_dir, modes)


# --- AsrRunner.decode ----------------------------------------------------
@pytest.fixture(scope='module')
def pair():
    cfg = tiny_config()
    model, variables = jax_model(cfg, seed=5)
    return model, variables, torch_model(cfg, variables)


def _batches():
    return [feats(seed, B=3, T=T) for seed, T in ((0, 67), (1, 45),
                                                  (2, 80))]


def _same(got, want, what, atol=2e-4, rtol=0.0):
    assert [r.tokens for r in got] == [r.tokens for r in want], what
    np.testing.assert_allclose([r.score for r in got],
                               [r.score for r in want], atol=atol,
                               rtol=rtol, err_msg=what)


@pytest.mark.parametrize('mode,biased', [
    ('ctc_greedy_search', False), ('ctc_prefix_beam_search', False),
    ('ctc_prefix_beam_search', True), ('attention_rescoring', False),
    ('attention_rescoring', True), ('attention', False)])
def test_decode_matches_jax(pair, mode, biased):
    """`decode` batch by batch against the JAX runner's `decode`, the
    prefix beam biased by a context graph where `biased` (hypotheses
    equal, scores within the bars), and one mode alone equal to the same
    mode decoded beside the other three."""
    from wenet_tpu.models.runner import AsrRunner as JaxRunner
    from wenet_tpu.utils.context_graph import ContextGraph as JaxGraph
    from wenet_tpu_torch.models.runner import AsrRunner
    from wenet_tpu_torch.utils.context_graph import ContextGraph
    jmodel, variables, tmodel = pair
    runner, jrunner = AsrRunner(tmodel, 'cpu'), JaxRunner(jmodel, variables)
    kw = dict(beam_size=4, ctc_weight=0.3, reverse_weight=0.3)
    jkw = dict(kw)
    if biased:
        phrases = [[4, 5], [7, 8, 9]]
        kw['context_graph'] = ContextGraph('', {}, context_list=phrases)
        jkw['context_graph'] = JaxGraph('', {}, context_list=phrases)
    bar = (dict(atol=2e-3, rtol=1e-5) if mode == 'attention_rescoring'
           else {})
    for f, lens in _batches():
        got = runner.decode([mode], f, lens, **kw)[mode]
        want = jrunner.decode([mode], f, lens, **jkw)[mode]
        _same(got, want, f'{mode}: port vs JAX', **bar)
        if mode == 'ctc_prefix_beam_search':
            assert [r.nbest for r in got] == [r.nbest for r in want]
        together = runner.decode(MODES, f, lens, **kw)[mode]
        _same(got, together, f'{mode}: alone vs with the others', atol=0)


def test_whisper_rescoring_with_infos_matches_jax():
    """attention_rescoring behind whisper's [sot, lang, task,
    notimestamps] prompt from `infos`, on a tiny whisper: the winners,
    scores and confidences of the JAX package's."""
    from wenet_tpu.models.transformer.search import (
        DecodeResult as JaxResult, attention_rescoring as jax_rescoring)
    from wenet_tpu_torch.models.transformer.search import (
        DecodeResult, attention_rescoring)
    jmodel, variables, tmodel = whisper_models(seed=2)
    rng = np.random.RandomState(9)
    B, T, D = 3, 12, 32
    enc = rng.randn(B, T, D).astype(np.float32)
    lens = np.asarray([12, 9, 7])
    nbest = [[[3, 5, 9], [3, 5], [3]], [[7], [7, 8], [17, 2, 2, 4]],
             [[], [4], [4, 4]]]
    scores = [[-1.0, -2.0, -2.5], [-0.5, -1.5, -3.0], [-0.2, -0.9, -1.1]]
    infos = {'tasks': ['transcribe', 'translate', 'transcribe'],
             'langs': ['en', 'zh', 'de']}

    def results(cls):
        return [cls(tokens=n[0], nbest=n, nbest_scores=s,
                    nbest_times=[list(range(len(h))) for h in n])
                for n, s in zip(nbest, scores)]

    with torch.inference_mode():
        got = attention_rescoring(tmodel, results(DecodeResult),
                                  torch.from_numpy(enc),
                                  torch.from_numpy(lens), 0.3, 0.0, infos)
    want = jax_rescoring(jmodel, variables, results(JaxResult), enc, lens,
                         0.3, 0.0, infos)
    _same(got, want, 'whisper rescoring', atol=2e-3, rtol=1e-5)
    for g, w in zip(got, want):
        assert g.times == w.times
        np.testing.assert_allclose(g.tokens_confidence, w.tokens_confidence,
                                   atol=2e-4)
        np.testing.assert_allclose(g.confidence, w.confidence, atol=2e-4)
    # the prompt is in use: a bare [sot] prefix scores otherwise
    with torch.inference_mode():
        bare = attention_rescoring(tmodel, results(DecodeResult),
                                   torch.from_numpy(enc),
                                   torch.from_numpy(lens), 0.3, 0.0,
                                   {'tasks': ['translate'] * B,
                                    'langs': ['fr'] * B})
    assert [r.score for r in bare] != [r.score for r in got]


# --- bin/recognize.py -----------------------------------------------------
@pytest.mark.parametrize('mode', MODES)
def test_recognize_pipelined_matches_jax(recipe, tmp_path, monkeypatch,
                                         mode):
    """One mode: the JAX package's pipelined branch against the port's
    one loop over `decode`."""
    port, jax = _recognize_pair(recipe, tmp_path, monkeypatch, mode, [],
                                [mode])
    assert port == jax
    assert len(port[mode].splitlines()) == N_UTTS


def test_recognize_raises_for_what_is_not_ported(recipe, tmp_path,
                                                 monkeypatch):
    from wenet_tpu_torch.bin import recognize
    base = ['--config', str(recipe / 'train.yaml'), '--test_data',
            str(recipe / 'data.list'), '--checkpoint',
            str(recipe / 'final.pt'), '--result_dir', str(tmp_path),
            '--device', 'cpu']
    # the hlg modes are ported, and need their graph and words
    with pytest.raises(ValueError, match='needs --hlg and --word'):
        recognize.main(base + ['--modes', 'hlg_onebest'])
    # the rnnt and paraformer modes are ported, and need their models
    with pytest.raises(ValueError, match='need a transducer'):
        recognize.main(base + ['--modes', 'rnnt_beam_search'])
    with pytest.raises(ValueError, match='need a paraformer'):
        recognize.main(base + ['--modes', 'paraformer_greedy_search'])
    # --timestamps is ported: a model without timestamp tokens exits as
    # the JAX package's recognize does
    with pytest.raises(SystemExit) as got:
        recognize.main(base + ['--timestamps'])
    with pytest.raises(SystemExit) as want:
        _jax_recognize(monkeypatch, [a for a in base if a != 'cpu' and
                                     a != '--device'] + ['--timestamps'])
    assert str(got.value) == str(want.value) and 'whisper' in str(got.value)
    # the hlg modes' own options are accepted
    args = recognize.get_parser().parse_args(base + [
        '--hlg', 'HLG.txt', '--word', 'words.txt', '--lm_scale', '0.7'])
    assert (args.hlg, args.word, args.lm_scale) == ('HLG.txt', 'words.txt',
                                                    0.7)
    with pytest.raises(ValueError, match='batch_size 1'):
        recognize.main(base + ['--simulate_streaming',
                               '--decoding_chunk_size', '4'])


# --- on the card ---------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device to run the Hopper kernel')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False  # the subsampling convs


@pytest.mark.cuda
@pytest.mark.parametrize('mode', MODES)
def test_cuda_decode_matches_cpu(cuda, mode):
    """`decode` on the card against the CPU (hypotheses equal, scores
    within the bars above), with K1 launched once per encoder block and
    batch."""
    import copy
    from wenet_tpu_torch.models.runner import AsrRunner
    from wenet_tpu_torch.ops import flash_attention as fa
    from wenet_tpu_torch.utils.init_model import init_model
    cfg = tiny_config()
    model = init_model(cfg, torch.Generator().manual_seed(3), device='cpu')
    kw = dict(beam_size=4, ctc_weight=0.3, reverse_weight=0.3)
    batches = _batches()
    cpu, card = AsrRunner(model, 'cpu'), AsrRunner(copy.deepcopy(model),
                                                   'cuda')
    want = [cpu.decode([mode], f, lens, **kw)[mode] for f, lens in batches]
    fa.reset_launches()
    got = [card.decode([mode], f, lens, **kw)[mode] for f, lens in batches]
    assert fa.LAUNCHES['relpos_attention_fwd'] == \
        cfg['encoder_conf']['num_blocks'] * len(batches)
    bar = (dict(atol=2e-3, rtol=1e-5) if mode == 'attention_rescoring'
           else {})
    for g, w in zip(got, want):
        _same(g, w, f'{mode}: card vs cpu', **bar)
