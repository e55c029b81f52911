"""The port's streaming runtime against the JAX package at a tiny width:
the feature pipeline, the CTC endpoint rules, the streaming C++ searcher,
the char tokenizer, `AsrDecoder` (partials after every `decode()` and
the final after `rescoring()`), the stdlib HTTP server's round trip, and
the port's independence from jax.

Bars: features within 1e-5 of the JAX pipeline's numpy path (the same
arithmetic); endpoint decisions, tokens and sentences identical; beam
scores within 2e-4 (the log-probs' torch-import bar); the rescored
final's score within 2e-3 absolute / 1e-5 relative (as
tests/test_torch_slice.py holds attention rescoring)."""

import json
import os
import subprocess
import sys
import textwrap
import threading
import urllib.request

import numpy as np
import pytest
import torch

from torch_port_utils import IDIM, VOCAB, jax_model, tiny_config, torch_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYMS = {'<blank>': 0, '<unk>': 1, '<sos/eos>': 2}
SYMS.update({chr(ord('a') + i): i + 3 for i in range(VOCAB - 3)})
OPTS = dict(chunk_size=4, num_left_chunks=2, beam_size=3)


def _wave(seed, seconds):
    """Noise with a few tones, quantized to int16 (a wav file's samples)."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    x = 0.15 * rng.randn(len(t))
    for f in rng.uniform(150, 3000, size=3):
        x += 0.1 * np.sin(2 * np.pi * f * t) * (np.sin(2 * np.pi * t) > 0)
    return np.round(np.clip(x, -1, 1) * 32767).astype(np.float32) / 32768


def test_feature_pipeline_matches_jax():
    from wenet_tpu.runtime.feature_pipeline import (
        FeaturePipeline as JaxPipeline, FeaturePipelineConfig as JaxConfig)
    from wenet_tpu_torch.runtime.feature_pipeline import (
        FeaturePipeline, FeaturePipelineConfig)
    wav = _wave(0, 1.3)
    jp = JaxPipeline(JaxConfig(num_mel_bins=IDIM), prefer_native=False)
    tp = FeaturePipeline(FeaturePipelineConfig(num_mel_bins=IDIM))
    for piece in (1000, 3200, 77, 5000):  # uneven pieces, int16 once
        lo = 0
        for p in (jp, tp):
            p.reset()
        while lo < len(wav):
            chunk = wav[lo:lo + piece]
            if piece == 77:
                chunk = np.round(chunk * 32768).astype(np.int16)
            want = jp.accept_waveform(chunk)
            got = tp.accept_waveform(chunk)
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
            lo += piece
        assert tp.num_frames == jp.num_frames > 0


def test_feature_pipeline_config_from_yaml():
    from wenet_tpu.runtime.feature_pipeline import (
        FeaturePipelineConfig as JaxConfig)
    from wenet_tpu_torch.runtime.feature_pipeline import (
        FeaturePipelineConfig)
    configs = {'input_dim': 80, 'dataset_conf': {
        'fbank_conf': {'num_mel_bins': 40, 'frame_length': 20,
                       'frame_shift': 10},
        'resample_conf': {'resample_rate': 8000}}}
    assert (vars(FeaturePipelineConfig.from_configs(configs)) ==
            vars(JaxConfig.from_configs(configs)))


def test_endpoint_matches_jax():
    from wenet_tpu.runtime.endpoint import CtcEndpoint as JaxEndpoint
    from wenet_tpu_torch.runtime.endpoint import CtcEndpoint
    rng = np.random.RandomState(1)
    je, te = JaxEndpoint(), CtcEndpoint()
    decisions = []
    for step in range(200):
        T = rng.randint(1, 8)
        logp = np.log(rng.dirichlet(np.ones(5), size=T)).astype(np.float32)
        if step % 40 > 10:  # long runs of confident blanks
            logp[:, 0] = np.log(0.95)
        decoded = bool(step % 3)
        want = je.is_endpoint(logp, decoded)
        assert te.is_endpoint(logp, decoded) == want
        decisions.append(want)
        if want:
            je.reset()
            te.reset()
    assert any(decisions) and not all(decisions)


def test_streaming_searcher():
    """Chunk by chunk equals one pass; reset starts over; after
    finalize_search the beam is closed."""
    from wenet_tpu_torch.runtime.native_beam import (batch_search_topk,
                                                     make_searcher)
    rng = np.random.RandomState(2)
    logits = rng.randn(40, 20).astype(np.float32) * 3
    logp = torch.log_softmax(torch.from_numpy(logits), -1)
    vals, ids = (t.numpy() for t in torch.topk(logp, 4, -1))
    want = batch_search_topk(vals[None], ids[None], np.array([40]), 4)[0]
    s = make_searcher(4)
    for _ in range(2):
        for lo, hi in ((0, 7), (7, 8), (8, 40)):
            s.search_topk(vals[lo:hi], ids[lo:hi])
        s.finalize_search()
        assert (s.hypotheses, s.times) == (want[0], want[1])
        np.testing.assert_array_equal(s.likelihood, want[2])
        with pytest.raises(RuntimeError):
            s.search_topk(vals[:1], ids[:1])
        s.reset()
        assert s.hypotheses == [[]]


def test_make_searcher_raises_for_context_and_lm():
    from wenet_tpu_torch.runtime.native_beam import make_searcher
    with pytest.raises(NotImplementedError):
        make_searcher(4, context_graph=object())
    with pytest.raises(NotImplementedError):
        make_searcher(4, lm=object())


def test_char_tokenizer_matches_jax(tmp_path):
    from wenet_tpu.text.char_tokenizer import CharTokenizer as JaxTokenizer
    from wenet_tpu_torch.text.char_tokenizer import CharTokenizer
    table = tmp_path / 'units.txt'
    table.write_text(''.join(f'{k} {v}\n' for k, v in
                             list(SYMS.items()) + [('▁', VOCAB),
                                                   ('[NOISE]', VOCAB + 1)]))
    syms = tmp_path / 'non_lang.txt'
    syms.write_text('[NOISE]\n')
    for kw in ({}, {'non_lang_syms': str(syms)},
               {'non_lang_syms': ['[NOISE]'], 'split_with_space': True}):
        j, t = (cls(str(table), **kw) for cls in (JaxTokenizer,
                                                  CharTokenizer))
        for line in ('abc de', 'a [noise] b', 'zzz?'):
            assert t.tokenize(line) == j.tokenize(line)
        ids = [3, 4, VOCAB, 5, VOCAB + 1]
        assert t.detokenize(ids) == j.detokenize(ids)
        assert t.vocab_size() == j.vocab_size()
        assert t.symbol_table == j.symbol_table
    bad = tmp_path / 'bad.txt'
    bad.write_text('NOISE\n')
    with pytest.raises(ValueError):
        CharTokenizer(str(table), non_lang_syms=str(bad))


@pytest.fixture(scope='module')
def pair():
    cfg = tiny_config()
    model, variables = jax_model(cfg, seed=21)
    return model, variables, torch_model(cfg, variables)


def _port_decoder(tmodel):
    from wenet_tpu_torch.runtime.asr_decoder import AsrDecoder, DecodeOptions
    from wenet_tpu_torch.runtime.feature_pipeline import FeaturePipelineConfig
    from wenet_tpu_torch.text.char_tokenizer import CharTokenizer
    return AsrDecoder(tmodel, CharTokenizer(SYMS), DecodeOptions(**OPTS),
                      FeaturePipelineConfig(num_mel_bins=IDIM), device='cpu')


def _stream(dec, wav, piece=3200):
    """Feed `wav` in pieces; -> (partials after every decode(), final)."""
    partials = []
    for lo in range(0, len(wav), piece):
        dec.accept_waveform(wav[lo:lo + piece])
        dec.decode()
        partials.append([(r.sentence, r.score) for r in dec.result])
    dec.set_input_finished()
    dec.decode()
    partials.append([(r.sentence, r.score) for r in dec.result])
    dec.rescoring()
    return partials, [(r.sentence, r.score) for r in dec.result]


def _same(got, want, atol=2e-4, rtol=0.0):
    assert [s for s, _ in got] == [s for s, _ in want]
    np.testing.assert_allclose([x for _, x in got], [x for _, x in want],
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize('seed,seconds', [(3, 1.6), (4, 2.3)])
def test_asr_decoder_matches_jax(pair, seed, seconds):
    from wenet_tpu.runtime.asr_decoder import (AsrDecoder as JaxDecoder,
                                               DecodeOptions as JaxOptions)
    from wenet_tpu.runtime.feature_pipeline import (
        FeaturePipeline as JaxPipeline, FeaturePipelineConfig as JaxConfig)
    from wenet_tpu.text.char_tokenizer import CharTokenizer as JaxTokenizer
    model, variables, tmodel = pair
    jd = JaxDecoder(model, variables, JaxTokenizer(SYMS), JaxOptions(**OPTS))
    # the numpy fbank, which the port's pipeline runs (not the C++ one)
    jd.feature_pipeline = JaxPipeline(JaxConfig(num_mel_bins=IDIM),
                                      prefer_native=False)
    jd.reset()
    td = _port_decoder(tmodel)
    wav = _wave(seed, seconds)
    want_partials, want_final = _stream(jd, wav)
    got_partials, got_final = _stream(td, wav)
    assert len(got_partials) == len(want_partials)
    for g, w in zip(got_partials, want_partials):
        _same(g, w)
    _same(got_final[1:], want_final[1:])
    _same(got_final[:1], want_final[:1], atol=2e-3, rtol=1e-5)
    assert got_final[0][0]  # something was decoded
    # the decoder starts over after reset
    td.reset()
    assert _stream(td, wav) == (got_partials, got_final)


def test_asr_decoder_endpoint_matches_jax(pair):
    """With a rule that fires on any decoded chunk, `decode()` stops at
    each endpoint as the JAX decoder does, and decoding continues after
    `reset_continuous_decoding`."""
    from wenet_tpu.runtime.asr_decoder import (AsrDecoder as JaxDecoder,
                                               DecodeOptions as JaxOptions)
    from wenet_tpu.runtime.endpoint import (
        CtcEndpointConfig as JaxEndpointConfig,
        CtcEndpointRule as JaxRule)
    from wenet_tpu.runtime.feature_pipeline import (
        FeaturePipeline as JaxPipeline, FeaturePipelineConfig as JaxConfig)
    from wenet_tpu.text.char_tokenizer import CharTokenizer as JaxTokenizer
    from wenet_tpu_torch.runtime.asr_decoder import AsrDecoder, DecodeOptions
    from wenet_tpu_torch.runtime.endpoint import (CtcEndpointConfig,
                                                  CtcEndpointRule)
    from wenet_tpu_torch.runtime.feature_pipeline import (
        FeaturePipelineConfig)
    from wenet_tpu_torch.text.char_tokenizer import CharTokenizer
    model, variables, tmodel = pair
    # rule1 fires once 120 ms are decoded; rules 2 and 3 never
    never = JaxRule(False, 10**6, 0)
    jd = JaxDecoder(model, variables, JaxTokenizer(SYMS), JaxOptions(**OPTS),
                    endpoint_config=JaxEndpointConfig(
                        rule1=JaxRule(False, 0, 120), rule2=never,
                        rule3=never))
    jd.feature_pipeline = JaxPipeline(JaxConfig(num_mel_bins=IDIM),
                                      prefer_native=False)
    jd.reset()
    never = CtcEndpointRule(False, 10**6, 0)
    td = AsrDecoder(tmodel, CharTokenizer(SYMS), DecodeOptions(**OPTS),
                    FeaturePipelineConfig(num_mel_bins=IDIM),
                    CtcEndpointConfig(rule1=CtcEndpointRule(False, 0, 120),
                                      rule2=never, rule3=never),
                    device='cpu')
    wav = _wave(7, 1.5)
    runs = []
    for dec in (jd, td):
        states = []
        dec.accept_waveform(wav)
        dec.set_input_finished()
        for _ in range(20):
            state = dec.decode()
            states.append((state.name, [r.sentence for r in dec.result],
                           dec.offset))
            if state.name != 'END_POINT':
                break
            dec.rescoring()
            dec.reset_continuous_decoding()
        runs.append(states)
    assert runs[1] == runs[0]
    assert [s for s, _, _ in runs[0]].count('END_POINT') >= 2


def test_asr_decoder_raises_for_what_is_not_ported(pair):
    from wenet_tpu_torch.runtime.asr_decoder import AsrDecoder
    from wenet_tpu_torch.text.char_tokenizer import CharTokenizer
    _, _, tmodel = pair
    for kw in ({'tlg_fst': 'TLG.fst'}, {'batch_runner': object()},
               {'lm': object()}, {'context_graph': object()}):
        with pytest.raises(NotImplementedError):
            AsrDecoder(tmodel, CharTokenizer(SYMS), device='cpu', **kw)


def test_http_round_trip(pair, tmp_path):
    """Two client threads POST a RIFF file and raw s16le samples; each
    answer's nbest is the decoder's final for the same audio."""
    from wenet_tpu_torch.bin.http_server_main import make_server
    from wenet_tpu_torch.dataset.audio import write_wav
    _, _, tmodel = pair
    waves = [_wave(5, 1.2), _wave(6, 1.7)]
    want = []
    for wav in waves:
        _, final = _stream(_port_decoder(tmodel), wav)
        want.append([{'sentence': s, 'score': x} for s, x in final])
    bodies = []
    for i, wav in enumerate(waves):
        write_wav(tmp_path / f'{i}.wav', wav, 16000)
        bodies.append(((tmp_path / f'{i}.wav').read_bytes(), want[i]))
    bodies.append(((np.round(waves[1] * 32768)).astype('<i2').tobytes(),
                   want[1]))
    server = make_server(lambda: _port_decoder(tmodel), 0, '127.0.0.1')
    serve = threading.Thread(target=server.serve_forever, daemon=True)
    serve.start()
    url = f'http://127.0.0.1:{server.server_address[1]}/'
    answers = {}

    def client(i):
        body = bodies[i][0]
        req = urllib.request.Request(url, data=body, method='POST')
        with urllib.request.urlopen(req, timeout=120) as resp:
            answers[i] = json.loads(resp.read())
    try:
        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(len(bodies))]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=120)
            assert not c.is_alive()
    finally:
        server.shutdown()
        server.server_close()
        serve.join(timeout=10)
    assert sorted(answers) == list(range(len(bodies)))
    for i, (_, nbest) in enumerate(bodies):
        ans = answers[i]
        assert ans['status'] == 'ok' and ans['type'] == 'final_result'
        assert [r['sentence'] for r in ans['nbest']] == \
            [r['sentence'] for r in nbest]
        np.testing.assert_allclose([r['score'] for r in ans['nbest']],
                                   [r['score'] for r in nbest], atol=1e-5)


def test_new_modules_import_without_jax():
    """A fresh interpreter imports every module of the streaming slice and
    streams one utterance through AsrDecoder on the CPU without jax or any
    wenet_tpu module."""
    code = textwrap.dedent('''
        import sys
        import numpy as np
        import torch
        import wenet_tpu_torch.bin.http_server_main
        import wenet_tpu_torch.dataset.audio
        import wenet_tpu_torch.models.runner
        import wenet_tpu_torch.models.transformer.streaming
        import wenet_tpu_torch.ops.fbank
        import wenet_tpu_torch.runtime.endpoint
        import wenet_tpu_torch.runtime.feature_pipeline
        import wenet_tpu_torch.text.char_tokenizer
        import wenet_tpu_torch.utils.file_utils
        from torch_port_utils import IDIM, TINY_CONFIG
        from wenet_tpu_torch.runtime.asr_decoder import (AsrDecoder,
                                                         DecodeOptions)
        from wenet_tpu_torch.runtime.feature_pipeline import (
            FeaturePipelineConfig)
        from wenet_tpu_torch.text.char_tokenizer import CharTokenizer
        from wenet_tpu_torch.utils.init_model import init_model
        model = init_model(TINY_CONFIG, torch.Generator().manual_seed(0),
                           device='cpu')
        dec = AsrDecoder(model, CharTokenizer({f'c{i}': i
                                               for i in range(30)}),
                         DecodeOptions(chunk_size=4), FeaturePipelineConfig(
                             num_mel_bins=IDIM), device='cpu')
        dec.accept_waveform(0.1 * np.random.RandomState(0).randn(16000))
        dec.set_input_finished()
        dec.decode()
        dec.rescoring()
        assert dec.result
        foreign = [m for m in sys.modules if m == 'jax' or
                   m.startswith(('jax.', 'wenet_tpu.')) or m == 'wenet_tpu']
        assert not foreign, foreign[:5]
        print('ok')
    ''')
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        [REPO, os.path.join(REPO, 'tests'), env.get('PYTHONPATH', '')])
    res = subprocess.run([sys.executable, '-c', code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith('ok')
