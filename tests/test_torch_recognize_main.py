"""The port's decode stage against the JAX package's, the part that
tests/test_torch_recognize.py leaves to this file (on its recipe
fixture, built anew here, so that the two files run on two workers):
`bin/recognize.py` with several modes, a context list, an ARPA LM and
simulated streaming, each mode alone against all four, `bin/alignment.py`,
`bin/label_checker.py`, the cli (`transcribe`, `--align`), and the
servers' context and LM options.

Bars: text, alignment, TextGrid and report files identical; hypotheses
identical."""

import json
import sys

import numpy as np
import pytest

from test_torch_recognize import (  # noqa: F401 (two fixtures)
    DECODE, MODES, N_UTTS, _recognize_pair, _texts, jax_host_settings,
    recipe)
from test_torch_runtime import SYMS


@pytest.mark.parametrize('name,extra,modes', [
    ('sequential', [], MODES),
    ('context_pipelined', ['--context_list_path', 'context.txt',
                           '--context_graph_score', '3.0'],
     ['attention_rescoring']),
    ('context_sequential', ['--context_list_path', 'context.txt'],
     ['ctc_prefix_beam_search', 'attention_rescoring']),
    ('lm', ['--lm_path', 'lm.arpa', '--lm_weight', '0.7'],
     ['ctc_prefix_beam_search', 'attention_rescoring']),
    # unpadded: the JAX package streams a batch's padding too, the port
    # stops at the utterance's frames
    ('streaming', ['--simulate_streaming', '--decoding_chunk_size', '4',
                   '--batch_size', '1', '--override_config',
                   'dataset_conf.pad_conf.pad_to_multiple 1'],
     ['ctc_greedy_search', 'attention_rescoring']),
])
def test_recognize_matches_jax(recipe, tmp_path, monkeypatch, name, extra,
                               modes):
    """Several modes (the JAX package's sequential loop), a context list
    (the C++ biased beam, in the JAX package's pipelined branch and in its
    sequential loop), an LM (n-best rescoring) and
    simulated streaming: identical text files."""
    extra = [str(recipe / a) if a in ('context.txt', 'lm.arpa') else a
             for a in extra]
    port, jax = _recognize_pair(
        recipe, tmp_path, monkeypatch, name, extra, modes,
        'small.list' if name == 'streaming' else 'data.list')
    assert port == jax


def test_recognize_one_mode_equals_all_modes(recipe, tmp_path):
    """The port alone: each mode's text decoded alone equals its text
    decoded beside the other three, and most hypotheses are non-empty."""
    from wenet_tpu_torch.bin import recognize
    base = ['--config', str(recipe / 'train.yaml'), '--test_data',
            str(recipe / 'data.list'), '--checkpoint',
            str(recipe / 'final.pt'), *DECODE, '--device', 'cpu']
    recognize.main(base + ['--modes', *MODES, '--result_dir',
                           str(tmp_path / 'seq')])
    seq = _texts(tmp_path / 'seq', MODES)
    for mode in MODES:
        recognize.main(base + ['--modes', mode, '--result_dir',
                               str(tmp_path / mode)])
        assert _texts(tmp_path / mode, [mode]) == {mode: seq[mode]}
    nonempty = sum(len(line.split()) > 1 for t in seq.values()
                   for line in t.splitlines())
    assert nonempty >= 2 * N_UTTS


# --- alignment, label_checker, the cli ------------------------------------
def test_alignment_matches_jax(recipe, tmp_path, monkeypatch):
    """Alignment files and TextGrids identical; each alignment collapses
    to its label."""
    from wenet_tpu.bin import alignment as jax_alignment
    from wenet_tpu_torch.bin import alignment
    from wenet_tpu_torch.utils.ctc_utils import remove_duplicates_and_blank
    argv = ['--config', str(recipe / 'train.yaml'), '--input_file',
            str(recipe / 'small.list'), '--checkpoint',
            str(recipe / 'final.pt'), '--gen_praat']
    out = alignment.main(argv + ['--result_file', str(tmp_path / 'p.ali'),
                                 '--device', 'cpu'])
    monkeypatch.setattr(sys, 'argv', ['alignment.py'] + argv + [
        '--result_file', str(tmp_path / 'j.ali')])
    jax_alignment.main()
    assert (tmp_path / 'p.ali').read_text() == \
        (tmp_path / 'j.ali').read_text()
    assert len(out) == 2
    texts = dict(line.split() for line in
                 (recipe / 'text').read_text().splitlines())
    for key, ali in out.items():
        label = [SYMS[c] for c in texts[key]]
        assert remove_duplicates_and_blank(ali) == label
        grid = f'p.{key}.TextGrid'
        assert (tmp_path / grid).read_text() == \
            (tmp_path / f'j.{key}.TextGrid').read_text()


def _model_dir(recipe, tmp_path):
    """A model directory (train.yaml, units.txt, final.pt) of the recipe."""
    import shutil
    d = tmp_path / 'model'
    d.mkdir()
    for name in ('train.yaml', 'units.txt', 'final.pt', 'global_cmvn'):
        shutil.copy(recipe / name, d / name)
    return str(d)


def test_label_checker_matches_jax(recipe, tmp_path):
    from wenet_tpu.bin import label_checker as jax_checker
    from wenet_tpu_torch.bin import label_checker
    model_dir = _model_dir(recipe, tmp_path)
    text = tmp_path / 'text'
    # a wrong transcript and one too long for its frames
    lines = ['u4 zzzz', 'u5 ' + 'ab' * 40]
    text.write_text('\n'.join(lines) + '\n')
    argv = ['--model_dir', model_dir, '--wav_scp', str(recipe / 'wav.scp'),
            '--text', str(text)]
    got = label_checker.main(argv + ['--result_file', str(tmp_path / 'p'),
                                     '--device', 'cpu'])
    jax_checker.main(argv + ['--result_file', str(tmp_path / 'j')])
    want = (tmp_path / 'j').read_text().splitlines()
    assert (tmp_path / 'p').read_text().splitlines() == got
    assert len(got) == len(want) == 2
    assert 'TOO_SHORT' in got[1]
    for g, w in zip(got, want):
        gk, gs, gscore, grest = g.split(' ', 3)
        wk, ws, wscore, wrest = w.split(' ', 3)
        assert (gk, gs, grest) == (wk, ws, wrest)
        if gs != 'TOO_SHORT':
            assert abs(float(gscore[6:]) - float(wscore[6:])) <= 1.5e-3


def test_cli_transcribe_matches_jax(recipe, tmp_path, monkeypatch, capsys):
    """`transcribe` with tokens info, with a context file, and --align:
    the JAX package's result dicts (text and token times exactly,
    confidences to 1e-3 as printed)."""
    from wenet_tpu.cli import model as jax_cli
    from wenet_tpu_torch.cli import transcribe
    model_dir = _model_dir(recipe, tmp_path)
    wav = str(recipe / 'u5.wav')
    jmodel = jax_cli.load_model(model_dir=model_dir, beam=4)
    got = transcribe.main([wav, '-m', model_dir, '-t', '--beam', '4',
                           '--device', 'cpu'])
    want = jmodel.transcribe(wav, tokens_info=True)
    assert got['text'] == want['text'] and got['text']
    for g, w in zip(got['tokens'], want['tokens']):
        assert (g['token'], g['start']) == (w['token'], w['start'])
        assert abs(g['confidence'] - w['confidence']) <= 1e-3
    assert len(got['tokens']) == len(want['tokens'])
    assert str(got) in capsys.readouterr().out

    ctx = ['--context_path', str(recipe / 'context.txt'),
           '--context_score', '4.0']
    got = transcribe.main([wav, '-m', model_dir, '--beam', '4', *ctx,
                           '--device', 'cpu'])
    jctx = jax_cli.load_model(model_dir=model_dir, beam=4,
                              context_path=str(recipe / 'context.txt'),
                              context_score=4.0)
    assert got == jctx.transcribe(wav)

    label = (recipe / 'text').read_text().splitlines()[5].split()[1]
    got = transcribe.main([wav, '-m', model_dir, '--align', '--label',
                           label, '--device', 'cpu'])
    assert got == jmodel.align(wav, label)
    assert [t['token'] for t in got['tokens']] == list(label)


def test_cli_hub_and_punc_raise_as_jax(tmp_path, monkeypatch):
    """No download: a missing model name raises the JAX package's
    FileNotFoundError message; the punctuation model needs jieba."""
    import importlib.util
    from wenet_tpu_torch.cli import hub
    from wenet_tpu_torch.cli.model import load_model
    monkeypatch.setattr(hub, 'MODEL_HOME', str(tmp_path))
    with pytest.raises(FileNotFoundError, match='place the extracted'):
        load_model(model_dir='aishell', device='cpu')
    with pytest.raises(FileNotFoundError, match='wenetspeech'):
        load_model(language='chinese', device='cpu')
    if importlib.util.find_spec('jieba') is None:
        from wenet_tpu_torch.cli.punc_model import load_punc_model
        with pytest.raises(ImportError, match='jieba'):
            load_punc_model(str(tmp_path))


# --- the servers' context and LM ------------------------------------------
def test_decoder_main_lm_matches_jax(recipe, tmp_path):
    """decoder_main --lm_path (LM fusion in the C++ streaming beam)."""
    from wenet_tpu.bin import decoder_main as jax_main
    from wenet_tpu_torch.bin import decoder_main
    model_dir = _model_dir(recipe, tmp_path)
    args = ['--model_dir', model_dir, '--wav_scp', str(recipe / 'wav.scp'),
            '--chunk_size', '4', '--num_left_chunks', '2', '--beam_size',
            '3', '--lm_path', str(recipe / 'lm.arpa'), '--lm_weight', '0.8']
    jax_main.main(args + ['--result_file', str(tmp_path / 'jax.txt')])
    decoder_main.main(args + ['--result_file', str(tmp_path / 'port.txt'),
                              '--device', 'cpu'])
    want = (tmp_path / 'jax.txt').read_text(encoding='utf-8')
    assert (tmp_path / 'port.txt').read_text(encoding='utf-8') == want
    assert len(want.splitlines()) == N_UTTS


def test_recognizer_and_websocket_context_match_jax(recipe, tmp_path):
    """WenetRecognizer with add_context, and the websocket main's
    --context_path decoders, against the JAX package's."""
    from wenet_tpu.bin import websocket_server_main as jax_ws
    from wenet_tpu.runtime import api as jax_api
    from wenet_tpu_torch.bin import websocket_server_main
    from wenet_tpu_torch.dataset.audio import read_wav
    from wenet_tpu_torch.runtime import api
    model_dir = _model_dir(recipe, tmp_path)
    wav, _ = read_wav(str(recipe / 'u4.wav'))
    pcm = np.round(wav[0] * 32768).astype('<i2').tobytes()
    answers = []
    for rec in (api.wenet_init(model_dir, device='cpu'),
                jax_api.wenet_init(model_dir)):
        rec.set_nbest(3)
        rec.add_context('abc')
        rec.add_context('kq')
        rec.set_context_score(5.0)
        rec.reset()
        answers.append(rec.decode(pcm, last=1))
    assert answers[0] == answers[1]
    assert json.loads(answers[0])['nbest'][0]['sentence']

    argv = ['--model_dir', model_dir, '--context_path',
            str(recipe / 'context.txt'), '--context_score', '4.0',
            '--chunk_size', '4', '--beam_size', '3']
    factory, _ = websocket_server_main.build_factory(
        websocket_server_main.get_args(argv + ['--device', 'cpu']))
    jfactory = _jax_ws_factory(jax_ws, argv)
    finals = []
    for dec in (factory(), jfactory()):
        dec.accept_waveform(wav[0])
        dec.set_input_finished()
        dec.decode()
        dec.rescoring()
        finals.append([r.sentence for r in dec.result])
    assert finals[0] == finals[1]


def _jax_ws_factory(jax_ws, argv):
    """The JAX websocket main's decoder factory, captured from its
    WebSocketServer without serving."""
    import wenet_tpu.runtime.websocket.server as server
    captured = {}

    class Capture:
        def __init__(self, host, port, factory):
            captured['factory'] = factory

        def start(self):
            pass

    real = server.WebSocketServer
    server.WebSocketServer = Capture
    try:
        old = sys.argv
        sys.argv = ['websocket_server_main.py'] + argv
        try:
            jax_ws.main()
        finally:
            sys.argv = old
    finally:
        server.WebSocketServer = real
    return captured['factory']
