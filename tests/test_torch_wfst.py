"""The port's TLG / WFST decoding against the JAX package's: the graph
(lm/build_graph.py `build_tlg`), the plain Python searcher
(runtime/wfst_beam_search.py), the C++ lattice decoder
(runtime/native_wfst.py over csrc/wfst_lattice_decoder.cc) against the
port's Python searcher, `AsrDecoder(tlg_fst=)` and `decoder_main
--fst_path --dict_path`.

The JAX package's C++ decoder is never built here (its loader runs an
unlocked `make` into its source tree): the JAX side always runs its Python
searcher.  Bars: TLG.txt, tokens.txt and words.txt byte-identical;
the Python searchers' hypotheses and times identical and likelihoods
within 1e-6; the C++ one-best equal to the Python one's, likelihood within
1e-4 (float32 sums); decoders' sentences identical and scores within
2e-4 (the torch-import bar); decoder_main's result files identical."""

import json
import math
import os

import numpy as np
import pytest
import yaml

from test_torch_runtime import OPTS, SYMS, _same, _stream, _wave
from torch_port_utils import IDIM, jax_model, tiny_config, torch_model

TOY_ARPA = """
\\data\\
ngram 1=5
ngram 2=4

\\1-grams:
-0.7\t<s>\t-0.3
-0.9\t</s>
-0.5\taa\t-0.2
-0.6\tbb\t-0.1
-1.2\t<unk>

\\2-grams:
-0.1\t<s> aa
-0.2\taa bb
-0.3\tbb </s>
-1.5\taa aa

\\end\\
"""
CHARS = [s for s in SYMS if len(s) == 1]  # the tiny model's units a..z
PY_OPTS = ('word_table', 'beam_size', 'max_active', 'acoustic_scale',
           'blank_skip_thresh', 'blank_id')


def write_arpa(path, sentences, order=3, discount=0.5):
    """A back-off ARPA n-gram from counts over `sentences` (lists of
    words): absolute discounting, the discounted mass as each context's
    back-off weight."""
    counts = [dict() for _ in range(order)]
    for words in sentences:
        seq = ['<s>'] + list(words) + ['</s>']
        for n in range(1, order + 1):
            for i in range(len(seq) - n + 1):
                gram = tuple(seq[i:i + n])
                counts[n - 1][gram] = counts[n - 1].get(gram, 0) + 1
    total = sum(c for g, c in counts[0].items() if g != ('<s>',))
    ctx_total, ctx_types = {}, {}
    for n in range(1, order):
        for gram, c in counts[n].items():
            ctx_total[gram[:-1]] = ctx_total.get(gram[:-1], 0) + c
            ctx_types[gram[:-1]] = ctx_types.get(gram[:-1], 0) + 1
    lines = ['\\data\\'] + [f'ngram {n + 1}={len(counts[n])}'
                            for n in range(order)]
    for n in range(order):
        lines += ['', f'\\{n + 1}-grams:']
        for gram, c in sorted(counts[n].items()):
            if n == 0:
                p = -99.0 if gram == ('<s>',) else math.log10(c / total)
            else:
                p = math.log10((c - discount) / ctx_total[gram[:-1]])
            row = f'{p:.6f}\t{" ".join(gram)}'
            if n < order - 1 and gram in ctx_total:
                bo = discount * ctx_types[gram] / ctx_total[gram]
                row += f'\t{math.log10(bo):.6f}'
            lines.append(row)
    lines += ['', '\\end\\', '']
    with open(path, 'w', encoding='utf-8') as f:
        f.write('\n'.join(lines))


def seeded_lang(d, seed=0, n_words=200, n_sentences=300):
    """units.txt (the tiny model's symbol table), a lexicon of `n_words`
    words of 1-4 of its chars, and a 3-gram over seeded sentences of
    them."""
    rng = np.random.RandomState(seed)
    (d / 'units.txt').write_text(''.join(f'{k} {v}\n'
                                         for k, v in SYMS.items()))
    words = set()
    while len(words) < n_words:
        words.add(''.join(rng.choice(CHARS, rng.randint(1, 5))))
    words = sorted(words)
    (d / 'lexicon.txt').write_text(''.join(f'{w} {" ".join(w)}\n'
                                           for w in words))
    sentences = [[words[i] for i in rng.randint(0, n_words,
                                                 rng.randint(1, 8))]
                 for _ in range(n_sentences)]
    write_arpa(d / 'lm.arpa', sentences)


def toy_lang(d):
    (d / 'units.txt').write_text('a 1\nb 2\n')
    (d / 'lexicon.txt').write_text('aa a a\nbb b b\n')
    (d / 'lm.arpa').write_text(TOY_ARPA)


def _build(build_tlg, d, out):
    return build_tlg(str(d / 'units.txt'), str(d / 'lexicon.txt'),
                     str(d / 'lm.arpa'), str(d / out))


@pytest.fixture(scope='module')
def lang(tmp_path_factory):
    """A seeded 40-word language, its TLG built by the port (small: the
    Python searcher runs over it)."""
    from wenet_tpu_torch.lm.build_graph import build_tlg
    d = tmp_path_factory.mktemp('lang')
    seeded_lang(d, n_words=40, n_sentences=80)
    _build(build_tlg, d, 'port')
    return d


@pytest.mark.parametrize('kind', ['toy', 'seeded'])
def test_build_tlg_matches_jax(kind, tmp_path):
    from wenet_tpu.lm.build_graph import build_tlg as jax_build_tlg
    from wenet_tpu_torch.lm.build_graph import build_tlg
    (toy_lang if kind == 'toy' else seeded_lang)(tmp_path)
    fst = _build(build_tlg, tmp_path, 'port')
    _build(jax_build_tlg, tmp_path, 'jax')
    for name in ('TLG.txt', 'tokens.txt', 'words.txt'):
        got = (tmp_path / 'port' / name).read_bytes()
        assert got == (tmp_path / 'jax' / name).read_bytes(), name
    assert fst.finals and fst.arcs


def posteriors(seed, T=24, V=len(SYMS), blank_frames=0.5):
    """(T, V) log-probs: peaked random logits, blank strong on about
    `blank_frames` of the frames (so blank skipping has work)."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(T, V).astype(np.float32) * 2.5
    logits[rng.rand(T) < blank_frames, 0] += 8.0
    logits -= np.log(np.exp(logits).sum(-1, keepdims=True))
    return logits.astype(np.float32)


def top_k_rows(logp, k=10):
    """`logp` with every entry but each frame's top-k and the blank at
    -1e4: the candidates the Python searcher advances (`top_k`), which
    the C++ decoder, with no top-k of its own, then prunes by its beam."""
    out = np.full_like(logp, -1e4)
    idx = np.argpartition(-logp, k - 1, axis=1)[:, :k]
    np.put_along_axis(out, idx, np.take_along_axis(logp, idx, 1), 1)
    out[:, 0] = logp[:, 0]
    return out


def _run(searcher, logp, pieces=(0, 7, 19, 24)):
    """Search in pieces; -> (partial best after each, n-best, likelihoods,
    times)."""
    partials = []
    for lo, hi in zip(pieces[:-1], pieces[1:]):
        searcher.search(logp[lo:hi])
        hyps = searcher.hypotheses
        partials.append(list(hyps[0]) if hyps else [])
    searcher.finalize_search()
    return (partials, searcher.hypotheses, searcher.likelihood,
            searcher.times)


@pytest.mark.parametrize('skip', [0.98, 1.1])
def test_python_searcher_matches_jax(lang, skip):
    """Five seeded posteriors over the seeded TLG: hypotheses, partials
    and times identical, likelihoods within 1e-6."""
    from wenet_tpu.lm.fst import TextFst as JaxFst
    from wenet_tpu.runtime.wfst_beam_search import (
        CtcWfstBeamSearch as JaxSearch)
    from wenet_tpu_torch.lm.fst import TextFst
    from wenet_tpu_torch.runtime.wfst_beam_search import CtcWfstBeamSearch
    path = str(lang / 'port' / 'TLG.txt')
    fst, jfst = TextFst.read(path), JaxFst.read(path)
    skipped = 0
    for seed in range(5):
        logp = posteriors(seed)
        skipped += int((np.exp(logp[:, 0]) > skip).sum())
        got = _run(CtcWfstBeamSearch(fst, beam_size=5,
                                     blank_skip_thresh=skip), logp)
        want = _run(JaxSearch(jfst, beam_size=5, blank_skip_thresh=skip),
                    logp)
        assert got[0] == want[0] and got[1] == want[1]
        assert got[3] == want[3]
        np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-6)
        assert got[1][0]  # words were decoded
    assert (skipped > 0) == (skip < 1.0)


def _native(path, **kw):
    from wenet_tpu_torch.runtime.native_wfst import NativeCtcWfstBeamSearch
    return NativeCtcWfstBeamSearch(path, **kw)


@pytest.mark.parametrize('skip', [0.98, 1.1])
def test_native_one_best_matches_python(lang, skip):
    """One-best words, times and likelihood of the C++ decoder against the
    Python searcher's, on rows that hold the Python searcher's candidates
    only, so that both search the same paths; partials too."""
    from wenet_tpu_torch.lm.fst import TextFst
    from wenet_tpu_torch.runtime.wfst_beam_search import CtcWfstBeamSearch
    path = str(lang / 'port' / 'TLG.txt')
    fst = TextFst.read(path)
    for seed in range(5):
        logp = top_k_rows(posteriors(seed + 10))
        py = _run(CtcWfstBeamSearch(fst, beam_size=5,
                                    blank_skip_thresh=skip), logp)
        cc = _run(_native(path, beam_size=5, blank_skip_thresh=skip), logp)
        assert cc[0] == py[0], seed
        assert cc[1][0] == py[1][0], seed
        assert cc[3][0] == py[3][0], seed
        np.testing.assert_allclose(cc[2][0], py[2][0], rtol=0, atol=1e-4)


def test_native_nbest_distinct_ordered_and_incremental(lang):
    path = str(lang / 'port' / 'TLG.txt')
    logp = posteriors(3, blank_frames=0.2)
    one = _native(path, beam_size=5, blank_skip_thresh=1.1)
    one.search(logp)
    one.finalize_search()
    hyps, lik = one.hypotheses, one.likelihood
    assert len(hyps) >= 2
    assert len({tuple(h) for h in hyps}) == len(hyps)
    assert all(lik[i] >= lik[i + 1] - 1e-6 for i in range(len(lik) - 1))
    for (gc, ac), like in zip(one.split_costs(), lik):
        assert math.isclose(-(gc + ac), like, rel_tol=1e-5, abs_tol=1e-5)
    inc = _native(path, beam_size=5, blank_skip_thresh=1.1)
    for t in range(logp.shape[0]):
        inc.search(logp[t:t + 1])
    inc.finalize_search()
    assert inc.hypotheses == hyps
    np.testing.assert_allclose(inc.likelihood, lik, rtol=1e-5)
    # reset starts over
    inc.reset()
    inc.search(logp)
    inc.finalize_search()
    assert inc.hypotheses == hyps


def test_make_wfst_searcher_from_a_graph_and_a_path(lang, tmp_path,
                                                    monkeypatch):
    """A TextFst is written to a temporary file that is gone once the
    decoder has parsed it; the two searchers decode alike."""
    from wenet_tpu_torch.lm.fst import TextFst
    from wenet_tpu_torch.runtime.native_wfst import (NativeCtcWfstBeamSearch,
                                                     make_wfst_searcher)
    monkeypatch.setenv('TMPDIR', str(tmp_path))
    import tempfile
    monkeypatch.setattr(tempfile, 'tempdir', None)
    path = str(lang / 'port' / 'TLG.txt')
    a = make_wfst_searcher(None, fst_path=path, beam_size=3)
    b = make_wfst_searcher(TextFst.read(path), beam_size=3)
    assert isinstance(b, NativeCtcWfstBeamSearch)
    assert os.listdir(tmp_path) == []
    logp = posteriors(7)
    assert _run(a, logp) == _run(b, logp)


def test_make_wfst_searcher_raises_when_the_library_cannot_build(
        lang, tmp_path, monkeypatch):
    """No Python fallback: a compiler that fails makes the searcher
    raise."""
    from wenet_tpu_torch.runtime import native_wfst
    monkeypatch.setattr('wenet_tpu_torch.utils.native.BUILD_DIR',
                        tmp_path / 'build')
    monkeypatch.setattr(native_wfst, '_lib', None)
    monkeypatch.setenv('CXX', 'false')
    with pytest.raises(RuntimeError, match='g\\+\\+ failed'):
        native_wfst.make_wfst_searcher(
            None, fst_path=str(lang / 'port' / 'TLG.txt'))


# --- the streaming decoder and decoder_main over a TLG of the tiny model


@pytest.fixture(scope='module')
def pair():
    cfg = tiny_config()
    model, variables = jax_model(cfg, seed=21)
    return model, variables, torch_model(cfg, variables)


@pytest.fixture(autouse=True)
def jax_python_searchers(monkeypatch):
    """The JAX package's numpy fbank (the one the port copies) and its
    Python WFST searcher in place of its C++ one."""
    from wenet_tpu.lm.fst import TextFst as JaxFst
    from wenet_tpu.runtime.wfst_beam_search import (
        CtcWfstBeamSearch as JaxSearch)

    def python_searcher(tlg_fst, fst_path=None, **kw):
        fst = JaxFst.read(fst_path) if tlg_fst is None else tlg_fst
        return JaxSearch(fst, **{k: v for k, v in kw.items()
                                 if k in PY_OPTS})
    monkeypatch.setattr('wenet_tpu.runtime.native_fbank.available',
                        lambda: False)
    monkeypatch.setattr('wenet_tpu.runtime.native_wfst.make_wfst_searcher',
                        python_searcher)


def _port_python_searcher(monkeypatch):
    from wenet_tpu_torch.lm.fst import TextFst
    from wenet_tpu_torch.runtime.wfst_beam_search import CtcWfstBeamSearch

    def python_searcher(tlg_fst, fst_path=None, **kw):
        fst = TextFst.read(fst_path) if tlg_fst is None else tlg_fst
        return CtcWfstBeamSearch(fst, **{k: v for k, v in kw.items()
                                         if k in PY_OPTS})
    monkeypatch.setattr(
        'wenet_tpu_torch.runtime.native_wfst.make_wfst_searcher',
        python_searcher)


def _finals_with_pieces(dec):
    return [(r.sentence, [(p.word, p.start, p.end) for p in r.word_pieces])
            for r in dec.result]


@pytest.mark.parametrize('seed,seconds', [(3, 1.6), (4, 2.3)])
def test_asr_decoder_tlg_matches_jax(pair, lang, seed, seconds,
                                     monkeypatch):
    """Partials and the final (words, word pieces and times) against the
    JAX decoder's, both on the Python searcher; the port's C++ searcher
    gives the same best words."""
    from wenet_tpu.lm.fst import read_symbol_table as jax_words
    from wenet_tpu.runtime.asr_decoder import (AsrDecoder as JaxDecoder,
                                               DecodeOptions as JaxOptions)
    from wenet_tpu.runtime.feature_pipeline import (
        FeaturePipelineConfig as JaxFeatures)
    from wenet_tpu.text.char_tokenizer import CharTokenizer as JaxTokenizer
    from wenet_tpu_torch.lm.fst import read_symbol_table
    from wenet_tpu_torch.runtime.asr_decoder import AsrDecoder, DecodeOptions
    from wenet_tpu_torch.runtime.feature_pipeline import FeaturePipelineConfig
    from wenet_tpu_torch.runtime.native_wfst import NativeCtcWfstBeamSearch
    from wenet_tpu_torch.text.char_tokenizer import CharTokenizer
    model, variables, tmodel = pair
    tlg = str(lang / 'port' / 'TLG.txt')
    words = str(lang / 'port' / 'words.txt')
    wav = _wave(seed, seconds)

    def port():
        return AsrDecoder(tmodel, CharTokenizer(SYMS), DecodeOptions(**OPTS),
                          FeaturePipelineConfig(num_mel_bins=IDIM),
                          tlg_fst=tlg, word_table=read_symbol_table(words),
                          device='cpu')
    native = port()
    assert isinstance(native.searcher, NativeCtcWfstBeamSearch)
    native_partials, native_final = _stream(native, wav)
    jd = JaxDecoder(model, variables, JaxTokenizer(SYMS), JaxOptions(**OPTS),
                    JaxFeatures(num_mel_bins=IDIM), tlg_fst=tlg,
                    word_table=jax_words(words))
    want_partials, want_final = _stream(jd, wav)
    _port_python_searcher(monkeypatch)
    td = port()
    got_partials, got_final = _stream(td, wav)
    assert len(got_partials) == len(want_partials)
    for g, w in zip(got_partials, want_partials):
        _same(g, w)
    _same(got_final, want_final)
    assert _finals_with_pieces(td) == _finals_with_pieces(jd)
    assert native_final[0][0] == got_final[0][0]
    assert [p[0][0] for p in native_partials] == [
        p[0][0] for p in got_partials]
    assert got_final[0][0]  # words were decoded


def test_asr_decoder_tlg_over_a_batch_runner_raises(pair, lang):
    """A WFST decoder over a batch runner that steps another streaming
    config, top-k or blank raises, as a beam decoder does (WFST streams
    over a matching runner: tests/test_torch_batch_wfst.py)."""
    from wenet_tpu_torch.models.transformer.streaming import StreamingConfig
    from wenet_tpu_torch.runtime.asr_decoder import AsrDecoder, DecodeOptions
    from wenet_tpu_torch.runtime.batch_runner import BatchedChunkRunner
    from wenet_tpu_torch.text.char_tokenizer import CharTokenizer
    enc = pair[2].encoder
    runner = BatchedChunkRunner(
        pair[2], StreamingConfig(OPTS['chunk_size'], OPTS['num_left_chunks'],
                                 enc.subsampling_rate, enc.right_context),
        beam_size=OPTS.get('beam_size', 10) + 1, device='cpu')
    try:
        with pytest.raises(ValueError, match='batch runner steps'):
            AsrDecoder(pair[2], CharTokenizer(SYMS), DecodeOptions(**OPTS),
                       device='cpu', tlg_fst=str(lang / 'port' / 'TLG.txt'),
                       batch_runner=runner)
    finally:
        runner.close()


def test_decoder_main_tlg_matches_jax(pair, lang, tmp_path):
    """`decoder_main --fst_path --dict_path` on a model directory the test
    writes (the port on its C++ searcher, JAX on its Python one): the
    result files are identical."""
    from wenet_tpu.bin import decoder_main as jax_main
    from wenet_tpu.utils.checkpoint import save_torch_checkpoint
    from wenet_tpu_torch.bin import decoder_main
    from wenet_tpu_torch.dataset.audio import write_wav
    _, variables, _ = pair
    d = tmp_path / 'model'
    d.mkdir()
    cfg = tiny_config()
    save_torch_checkpoint(variables, str(d / 'final.pt'))
    (d / 'units.txt').write_text((lang / 'units.txt').read_text())
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
        'dataset_conf': {'fbank_conf': {'num_mel_bins': IDIM,
                                        'frame_shift': 10,
                                        'frame_length': 25, 'dither': 0.0}},
    })
    # the checkpoint's cmvn stats win over the file's (both packages)
    (d / 'global_cmvn').write_text(json.dumps({
        'mean_stat': [3.0] * IDIM, 'var_stat': [40.0] * IDIM,
        'frame_num': 2}))
    with open(d / 'train.yaml', 'w') as f:
        yaml.safe_dump(cfg, f)
    lines = []
    for i, (seed, seconds) in enumerate(((5, 1.3), (6, 2.1))):
        write_wav(tmp_path / f'utt{i}.wav', _wave(seed, seconds), 16000)
        lines.append(f'utt{i} {tmp_path / f"utt{i}.wav"}\n')
    (tmp_path / 'wav.scp').write_text(''.join(lines))
    args = ['--model_dir', str(d), '--wav_scp', str(tmp_path / 'wav.scp'),
            '--chunk_size', '4', '--num_left_chunks', '2', '--beam_size',
            '3', '--fst_path', str(lang / 'port' / 'TLG.txt'),
            '--dict_path', str(lang / 'port' / 'words.txt')]
    jax_main.main(args + ['--result_file', str(tmp_path / 'jax.txt')])
    decoder_main.main(args + ['--result_file', str(tmp_path / 'port.txt'),
                              '--device', 'cpu'])
    want = (tmp_path / 'jax.txt').read_text(encoding='utf-8')
    assert (tmp_path / 'port.txt').read_text(encoding='utf-8') == want
    assert all(len(line.split()) == 2 for line in want.splitlines())
