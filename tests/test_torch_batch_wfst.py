"""WFST sessions over the batch runner, and data-parallel decode over a
list of devices, at the tiny width of tests/torch_port_utils.py (the JAX
package's weights), on the CPU.

- `BatchedChunkRunner` hands a session that asks for them its whole
  (chunk_out, V) CTC log-prob rows (`whole_rows`), the others their
  top-k and blank column, from one step.
- `AsrDecoder(tlg_fst=..., batch_runner=...)`: WFST and prefix-beam
  streams mixed in one runner, each equal to itself decoded alone:
  sentences equal, scores within 2e-4 (the batched step's bar, 9f's)
  plus what the rows explain.  A WFST score sums a path's log-probs over
  every frame, so the batched step's float32 differences from the step
  alone add up along it: the bar adds the rows' summed per-frame
  differences and 1e-5 of the score (chip_smoke 13b's float32 tie).
- `AsrRunner(mesh=['cpu', 'cpu'])` and `BatchedChunkRunner(mesh=['cpu',
  'cpu'])`: ragged batches split over two replicas decode the hypotheses
  of one device."""

import concurrent.futures as cf

import numpy as np
import pytest
import torch

from test_torch_runtime import OPTS, SYMS, _same, _stream, _wave
from test_torch_wfst import _build, seeded_lang
from torch_port_utils import IDIM, feats, jax_model, tiny_config, torch_model

MODES = ['ctc_greedy_search', 'ctc_prefix_beam_search',
         'attention_rescoring', 'attention']


@pytest.fixture(scope='module')
def tmodel():
    cfg = tiny_config()
    _, variables = jax_model(cfg, seed=21)
    return torch_model(cfg, variables)


@pytest.fixture(scope='module')
def lang(tmp_path_factory):
    """A seeded 40-word language and its TLG (the port's build)."""
    from wenet_tpu_torch.lm.build_graph import build_tlg
    d = tmp_path_factory.mktemp('batch_wfst_lang')
    seeded_lang(d, n_words=40, n_sentences=80)
    _build(build_tlg, d, 'port')
    return d


def _runner(tmodel, mesh=None, max_batch=4, flush_ms=30.0):
    from wenet_tpu_torch.models.transformer.streaming import StreamingConfig
    from wenet_tpu_torch.runtime.batch_runner import BatchedChunkRunner
    enc = tmodel.encoder
    cfg = StreamingConfig(OPTS['chunk_size'], OPTS['num_left_chunks'],
                          enc.subsampling_rate, enc.right_context)
    return BatchedChunkRunner(tmodel, cfg, max_batch=max_batch,
                              flush_ms=flush_ms, mesh=mesh,
                              beam_size=OPTS['beam_size'], device='cpu')


def _decoder(tmodel, lang=None, runner=None, rows=None):
    from wenet_tpu_torch.lm.fst import read_symbol_table
    from wenet_tpu_torch.runtime.asr_decoder import AsrDecoder, DecodeOptions
    from wenet_tpu_torch.runtime.feature_pipeline import FeaturePipelineConfig
    from wenet_tpu_torch.text.char_tokenizer import CharTokenizer
    kw = {}
    if lang is not None:
        kw = dict(tlg_fst=str(lang / 'port' / 'TLG.txt'),
                  word_table=read_symbol_table(
                      str(lang / 'port' / 'words.txt')))
    dec = AsrDecoder(tmodel, CharTokenizer(SYMS), DecodeOptions(**OPTS),
                     FeaturePipelineConfig(num_mel_bins=IDIM),
                     batch_runner=runner, device='cpu', **kw)
    if rows is not None:  # keep the host rows the search reads
        search = dec._search

        def recorded(host):
            rows.append(np.array(host, copy=True))
            return search(host)
        dec._search = recorded
    return dec


def _row_gap(rows, other, k=OPTS['beam_size']):
    """The summed per-frame differences of two runs' host rows (the
    values a search adds: a WFST row whole, a prefix-beam row's top-k
    values and blank)."""
    assert len(rows) == len(other)
    gap = 0.0
    for a, b in zip(rows, other):
        if a.shape[-1] == 2 * k + 1:
            assert np.array_equal(a[:, k:2 * k], b[:, k:2 * k])  # the ids
            a, b = np.delete(a, np.s_[k:2 * k], -1), np.delete(
                b, np.s_[k:2 * k], -1)
        gap += float(np.abs(a - b).max(axis=-1).sum())
    return gap


def _same_stream(got, want, rows, other):
    """Partials and the final equal: sentences identical, scores within
    2e-4 plus the rows' differences and 1e-5 of the score."""
    (gp, gf), (wp, wf) = got, want
    assert len(gp) == len(wp)
    gap = _row_gap(rows, other)
    for g, w in zip(gp + [gf], wp + [wf]):
        _same(g, w, atol=2e-4 + gap, rtol=1e-5)


def test_whole_rows_are_the_ctc_log_probs(tmodel):
    """One step of two sessions, one asking for whole rows: it gets the
    step's (chunk frames, V) CTC log-probs, the other the top-k rows of the
    same log-probs."""
    from wenet_tpu_torch.utils.ctc_utils import topk_host_rows
    runner = _runner(tmodel, max_batch=2, flush_ms=200.0)
    try:
        rng = np.random.RandomState(0)
        chunks = [rng.randn(runner.cfg.decoding_window, IDIM).astype(
            np.float32) for _ in range(2)]
        futs = [runner.submit(c, runner.zero_cache(), 0, 0,
                              runner.chunk_base, whole_rows=w)
                for c, w in zip(chunks, (True, False))]
        (ys0, whole, _), (ys1, top, _) = (f.result(timeout=60)
                                          for f in futs)
    finally:
        runner.close()
    assert dict(runner.batch_sizes) == {2: 1}
    with torch.inference_mode():
        logp = tmodel.ctc_activation(torch.cat([ys0, ys1]))
    assert whole.shape == (runner.chunk_base, len(SYMS))
    np.testing.assert_array_equal(whole, logp[0].numpy())
    np.testing.assert_array_equal(
        top, topk_host_rows(logp[1], OPTS['beam_size'], 0).numpy())


@pytest.mark.parametrize('kinds', ['wfst', 'mixed'])
def test_wfst_streams_over_the_runner_equal_themselves_alone(tmodel, lang,
                                                             kinds):
    """Four streams at once over one runner (all WFST, or WFST and
    prefix-beam streams mixed), each against itself decoded alone:
    partials and the final equal (scores within 2e-4 beyond the rows'
    differences); with `mixed`, one step at least holds both kinds of
    rows."""
    wfst = [True] * 4 if kinds == 'wfst' else [True, False, True, False]
    waves = [_wave(20 + i, 1.2 + 0.35 * i) for i in range(4)]
    rows = {'alone': [[] for _ in waves], 'batched': [[] for _ in waves]}
    alone = [_stream(_decoder(tmodel, lang if w else None,
                              rows=rows['alone'][i]), wav)
             for i, (w, wav) in enumerate(zip(wfst, waves))]
    # a long flush window: the four streams share steps however slowly
    # the host runs their threads
    runner = _runner(tmodel, flush_ms=200.0)
    kinds_per_step = []
    step = runner._step

    def record(dev, model, batch):
        kinds_per_step.append({r.whole_rows for r in batch})
        return step(dev, model, batch)

    runner._step = record
    try:
        decoders = [_decoder(tmodel, lang if w else None, runner,
                             rows['batched'][i])
                    for i, w in enumerate(wfst)]
        with cf.ThreadPoolExecutor(4) as ex:
            got = list(ex.map(_stream, decoders, waves))
    finally:
        runner.close()
    assert max(runner.batch_sizes) > 1
    if kinds == 'mixed':
        assert {True, False} in kinds_per_step
    for i, (g, w) in enumerate(zip(got, alone)):
        _same_stream(g, w, rows['batched'][i], rows['alone'][i])
    assert any(f[0][0] for (_, f), w in zip(got, wfst) if w)


@pytest.mark.parametrize('B', [1, 4, 5])
def test_data_parallel_runner_matches_one_device(tmodel, B):
    """AsrRunner over ['cpu', 'cpu'] (B=5 and B=1 ragged: the last row
    repeated, then trimmed) decodes the hypotheses and scores of one
    device in every mode."""
    from wenet_tpu_torch.models.runner import AsrRunner
    x, lens = feats(seed=50 + B, B=B, T=90)
    one = AsrRunner(tmodel, 'cpu')
    two = AsrRunner(tmodel, mesh=['cpu', 'cpu'])
    assert len(two._replicas) == 2 and two._replicas[0] is two._replicas[1]
    want = one.decode(MODES, x, lens, beam_size=3)
    got = two.decode(MODES, x, lens, beam_size=3)
    for m in MODES:
        assert len(got[m]) == B
        assert [list(r.tokens) for r in got[m]] == \
            [list(r.tokens) for r in want[m]], m
        np.testing.assert_allclose([r.score for r in got[m]],
                                   [r.score for r in want[m]], atol=2e-4)


def test_data_parallel_quantized_runner_matches_one_device(tmodel):
    from wenet_tpu_torch.models.runner import AsrRunner
    import copy
    x, lens = feats(seed=60, B=3, T=90)
    one = AsrRunner(copy.deepcopy(tmodel), 'cpu', quantize=True)
    two = AsrRunner(copy.deepcopy(tmodel), quantize=True,
                    mesh=['cpu', 'cpu'])
    want = one.decode(MODES[:2], x, lens, beam_size=3)
    got = two.decode(MODES[:2], x, lens, beam_size=3)
    for m in MODES[:2]:
        assert [list(r.tokens) for r in got[m]] == \
            [list(r.tokens) for r in want[m]], m


def test_data_parallel_batch_runner_matches_one_device(tmodel, lang):
    """Three streams (one WFST) over a runner split over ['cpu', 'cpu']:
    ragged steps (the final row repeated up to two shards) give every
    partial and final of the one-device runner."""
    waves = [_wave(30 + i, 1.3 + 0.4 * i) for i in range(3)]
    langs = [lang, None, None]
    out, rows = {}, {}
    for mesh in (None, ['cpu', 'cpu']):
        runner = _runner(tmodel, mesh=mesh, max_batch=3)
        rows[mesh is None] = [[] for _ in waves]
        try:
            decoders = [_decoder(tmodel, g, runner, rows[mesh is None][i])
                        for i, g in enumerate(langs)]
            with cf.ThreadPoolExecutor(3) as ex:
                out[mesh is None] = list(ex.map(_stream, decoders, waves))
        finally:
            runner.close()
        if mesh is not None:
            assert any(b % 2 for b in runner.batch_sizes)
    for i, (g, w) in enumerate(zip(out[False], out[True])):
        _same_stream(g, w, rows[False][i], rows[True][i])
