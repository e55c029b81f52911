"""The port's CTC utilities, CTC decode heads, ARPA LM, context graph and
the C++ searcher's context and LM paths against the JAX package, at a
tiny size, on inputs made with numpy from a seed.

Bars: forced alignments, ids, hypotheses, times and graph states
identical; head values within 5e-6 of the JAX package's (the bar of
tests/test_ctc_chunked.py: XLA and torch sum the head's GEMM in another
order, a few float32 ulps at log-probs near -5); ARPA scores within
1e-6; the port's C++ scores within 1e-5 + 1e-6 relative of the JAX
package's C++ searcher (the same float32 code built with -O2 and -O3:
one ulp at scores near -150) and of the port's Python plain version
(which sums in float64)."""

import gzip
import math

import numpy as np
import pytest
import torch

LOG10 = math.log(10)
V = 12
SYMTAB = {i: str(i) for i in range(V)}
PHRASES = [[3, 4, 5], [4, 2], [3, 4], [7, 7, 8]]
ARPA = """
\\data\\
ngram 1=9
ngram 2=6
ngram 3=2

\\1-grams:
-99\t<s>\t-0.5
-2.0\t</s>
-1.0\t3\t-0.3
-1.2\t4\t-0.2
-0.8\t5\t-0.1
-1.5\t2\t-0.4
-1.1\t7\t-0.25
-1.3\t8
-3.0\t<unk>

\\2-grams:
-0.5\t<s> 3\t-0.1
-0.4\t3 4\t-0.2
-0.3\t4 5
-0.6\t5 </s>
-0.7\t7 8
-0.9\t8 </s>

\\3-grams:
-0.2\t<s> 3 4
-0.1\t3 4 5

\\end\\
"""


def _logp(T, V, seed=0, scale=2.0):
    rng = np.random.RandomState(seed)
    logits = rng.randn(T, V).astype(np.float32) * scale
    return logits - np.log(np.exp(logits).sum(-1, keepdims=True))


def _topk(logp, k):
    ids = np.argsort(-logp, axis=-1, kind='stable')[..., :k].astype(np.int32)
    vals = np.take_along_axis(logp, ids, axis=-1).astype(np.float32)
    return vals, ids


@pytest.fixture(scope='module')
def arpa_path(tmp_path_factory):
    d = tmp_path_factory.mktemp('arpa')
    (d / 'lm.arpa').write_text(ARPA)
    with gzip.open(d / 'lm.arpa.gz', 'wt') as f:
        f.write(ARPA)
    return d


# --- forced alignment ------------------------------------------------------
@pytest.mark.parametrize('T,label,seed', [
    (30, [3, 5, 7], 0),
    (40, [4, 4, 9, 4, 4], 1),      # repeats: no skip between them
    (11, [2, 6, 2, 8, 1], 2),      # T = 2L + 1, the tightest lattice
    (25, [7], 3),
])
def test_force_align_matches_jax(T, label, seed):
    from wenet_tpu.utils.ctc_utils import force_align as jax_align
    from wenet_tpu_torch.utils.ctc_utils import force_align
    logp = _logp(T, V, seed)
    want = jax_align(logp, np.asarray(label))
    got = force_align(torch.from_numpy(logp), label)
    assert got == want
    assert len(got) == T
    from wenet_tpu_torch.utils.ctc_utils import remove_duplicates_and_blank
    assert remove_duplicates_and_blank(got) == label


def test_ctc_utils_match_jax():
    from wenet_tpu.utils import ctc_utils as jax_utils
    from wenet_tpu_torch.utils import ctc_utils
    rng = np.random.RandomState(4)
    for _ in range(5):
        hyp = [int(x) for x in rng.randint(0, 4, size=30)]
        for name in ('remove_duplicates_and_blank',
                     'replace_duplicates_with_blank', 'gen_ctc_peak_time'):
            assert getattr(ctc_utils, name)(hyp) == \
                getattr(jax_utils, name)(hyp), name
        peaks = ctc_utils.gen_ctc_peak_time(hyp)
        assert ctc_utils.gen_timestamps_from_peak(peaks, 1.2) == \
            jax_utils.gen_timestamps_from_peak(peaks, 1.2)
    np.testing.assert_array_equal(ctc_utils.insert_blank([3, 4], 0),
                                  jax_utils.insert_blank([3, 4], 0))
    for table, conf in (({'<blank>': 0, 'a': 1}, {}),
                        ({'a': 1}, {'ctc_conf': {'ctc_blank_id': 5}})):
        assert ctc_utils.get_blank_id(dict(conf), table) == \
            jax_utils.get_blank_id(dict(conf), table)


# --- the CTC decode heads ------------------------------------------------
@pytest.fixture(scope='module')
def heads():
    """The port's CTC head and the JAX package's on one set of weights,
    with encoder outputs (3, 230, 64)."""
    from wenet_tpu.models.transformer.ctc import CTC as JaxCTC
    from wenet_tpu_torch.models.transformer.ctc import CTC
    rng = np.random.RandomState(7)
    kernel = (rng.randn(64, 97) * 0.3).astype(np.float32)
    bias = (rng.randn(97) * 0.1).astype(np.float32)
    head = CTC(97, 64)
    with torch.no_grad():
        head.ctc_lo.weight.copy_(torch.from_numpy(kernel.T.copy()))
        head.ctc_lo.bias.copy_(torch.from_numpy(bias))
    jhead = JaxCTC(97, 64)
    jvars = {'params': {'ctc_lo': {'kernel': kernel, 'bias': bias}}}
    hs = rng.randn(3, 230, 64).astype(np.float32)
    return head.eval(), jhead, jvars, hs


@pytest.mark.parametrize('blank_penalty', [0.0, 0.5])
@pytest.mark.parametrize('blank_id', [0, 5])
def test_argmax_matches_jax(heads, blank_penalty, blank_id):
    """The greedy ids, the blank penalty on the logits, equal to the JAX
    package's head (dense and T-chunked, which agree)."""
    head, jhead, jvars, hs = heads
    with torch.no_grad():
        got = head.argmax(torch.from_numpy(hs), blank_penalty, blank_id)
    for method, extra in ((jhead.argmax, ()), (jhead.argmax_chunked, (16,))):
        want = jhead.apply(jvars, hs, blank_penalty, blank_id, *extra,
                           method=method)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('blank_penalty', [0.0, 0.5])
@pytest.mark.parametrize('k', [1, 10])
def test_topk_matches_jax(heads, blank_penalty, k):
    """The per-frame top-k ids equal and log-probs within 5e-6 of the JAX
    package's head (dense and T-chunked)."""
    head, jhead, jvars, hs = heads
    with torch.no_grad():
        vals, ids = head.topk(torch.from_numpy(hs), k, blank_penalty, 0)
    for method, extra in ((jhead.topk, ()), (jhead.topk_chunked, (16,))):
        jv, ji = jhead.apply(jvars, hs, k, blank_penalty, 0, *extra,
                             method=method)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
        np.testing.assert_allclose(vals.numpy(), np.asarray(jv), atol=5e-6,
                                   rtol=0)


# --- the ARPA LM ---------------------------------------------------------
@pytest.mark.parametrize('name', ['lm.arpa', 'lm.arpa.gz'])
def test_read_arpa_matches_jax(arpa_path, name):
    from wenet_tpu.lm.arpa import read_arpa as jax_read
    from wenet_tpu_torch.lm.arpa import read_arpa
    lm, jlm = read_arpa(str(arpa_path / name)), jax_read(str(arpa_path /
                                                             name))
    assert (lm.order, lm.vocab) == (jlm.order, jlm.vocab)
    assert lm.ngrams == jlm.ngrams
    rng = np.random.RandomState(5)
    words = ['3', '4', '5', '2', '7', '8', '</s>', 'zz']
    for _ in range(50):
        ctx = ['<s>'] + list(rng.choice(words[:6], size=rng.randint(0, 4)))
        w = str(rng.choice(words))
        assert abs(lm.score_word(ctx, w) - jlm.score_word(ctx, w)) <= 1e-6
        seq = list(rng.choice(words[:6], size=rng.randint(0, 6)))
        assert abs(lm.score_sequence(seq) - jlm.score_sequence(seq)) <= 1e-6
    # a trigram hit, a bigram back-off, and an unknown word
    assert lm.score_word(['<s>', '3'], '4') == pytest.approx(-0.2 * LOG10)
    assert lm.score_word(['5'], '3') == pytest.approx((-0.1 - 1.0) * LOG10)
    assert lm.score_word([], 'zz') == pytest.approx(-3.0 * LOG10)


# --- the context graph ---------------------------------------------------
def _graph_states(graph):
    out = {}
    stack = [graph.root]
    while stack:
        n = stack.pop()
        out[n.id] = (n.token, n.token_score, n.node_score, n.output_score,
                     n.is_end, n.fail.id, n.output and n.output.id,
                     sorted((t, c.id) for t, c in n.next.items()))
        stack.extend(n.next.values())
    return out


def test_context_graph_matches_jax(tmp_path):
    from wenet_tpu.utils.context_graph import ContextGraph as JaxGraph
    from wenet_tpu_torch.utils.context_graph import ContextGraph, tokenize
    table = {'<blank>': 0, '<unk>': 1, '▁': 2}
    table.update({c: i + 3 for i, c in enumerate('abcdefgh')})
    (tmp_path / 'ctx.txt').write_text('abc\nbd\nab\nzg g\n\n')
    graph = ContextGraph(str(tmp_path / 'ctx.txt'), table, context_score=3.0)
    jgraph = JaxGraph(str(tmp_path / 'ctx.txt'), table, context_score=3.0)
    assert graph.context_list == jgraph.context_list == [
        [3, 4, 5], [4, 6], [3, 4], [1, 9, 2, 9]]
    assert tokenize(str(tmp_path / 'ctx.txt'), table) == graph.context_list
    assert _graph_states(graph) == _graph_states(jgraph)
    rng = np.random.RandomState(6)
    state, jstate = graph.root, jgraph.root
    for tok in rng.randint(1, 8, size=200):
        score, state = graph.forward_one_step(state, int(tok))
        jscore, jstate = jgraph.forward_one_step(jstate, int(tok))
        assert (score, state.id) == (jscore, jstate.id)
    assert graph.finalize(state)[0] == jgraph.finalize(jstate)[0]


def test_plain_search_with_context_matches_jax():
    """The port's Python plain version against the JAX package's
    (context only, which is all the JAX function takes)."""
    from wenet_tpu.utils.context_graph import (
        ContextGraph as JaxGraph,
        ctc_prefix_beam_search_with_context as jax_search)
    from wenet_tpu_torch.utils.context_graph import (
        ContextGraph, ctc_prefix_beam_search_with_context)
    logp = np.stack([_logp(40, V, 20 + b) for b in range(3)])
    lens = np.asarray([40, 33, 25])
    got = ctc_prefix_beam_search_with_context(
        logp, lens, 5, ContextGraph('', {}, context_list=PHRASES))
    want = jax_search(logp, lens, 5, JaxGraph('', {}, context_list=PHRASES))
    for g, w in zip(got, want):
        assert (g.nbest, g.nbest_times) == (w.nbest, w.nbest_times)
        assert g.nbest_scores == w.nbest_scores


def test_plain_search_with_lm_matches_jax(arpa_path):
    """The plain version's LM fusion against the JAX package's Python
    streaming searcher with the same LM."""
    from wenet_tpu.lm.arpa import read_arpa as jax_read
    from wenet_tpu.runtime.ctc_prefix_beam_search import CtcPrefixBeamSearch
    from wenet_tpu_torch.lm.arpa import read_arpa
    from wenet_tpu_torch.utils.context_graph import (
        ctc_prefix_beam_search_with_context)
    lm, jlm = (f(str(arpa_path / 'lm.arpa')) for f in (read_arpa, jax_read))
    for seed in (0, 7):
        logp = _logp(50, V, seed)
        got = ctc_prefix_beam_search_with_context(
            logp[None], [50], 5, None, lm=lm, lm_weight=0.4,
            symbol_table=SYMTAB)[0]
        js = CtcPrefixBeamSearch(5, lm=jlm, lm_weight=0.4,
                                 symbol_table=SYMTAB)
        js.search(logp)
        js.finalize_search()
        assert got.nbest == js.hypotheses
        assert got.nbest_times == js.times
        np.testing.assert_allclose(got.nbest_scores, js.likelihood,
                                   rtol=1e-12)


# --- the C++ searcher's context and LM paths ------------------------------
def _fusion(mode, lm, jlm):
    """(the port's kwargs, the JAX package's) for one fusion mode."""
    from wenet_tpu.utils.context_graph import ContextGraph as JaxGraph
    from wenet_tpu_torch.utils.context_graph import ContextGraph
    kw, jkw = {}, {}
    if 'ctx' in mode:
        kw['context_graph'] = ContextGraph('', {}, context_list=PHRASES,
                                           context_score=3.0)
        jkw['context_graph'] = JaxGraph('', {}, context_list=PHRASES,
                                        context_score=3.0)
    if 'lm' in mode:
        kw.update(lm=lm, lm_weight=0.4, symbol_table=SYMTAB)
        jkw.update(lm=jlm, lm_weight=0.4, symbol_table=SYMTAB)
    return kw, jkw


@pytest.mark.parametrize('mode', ['plain', 'ctx', 'lm', 'ctx_lm'])
@pytest.mark.parametrize('seed', [0, 7])
def test_native_search_matches_jax_and_plain(arpa_path, mode, seed):
    """batch_search_topk over three utterances: hypotheses and times equal
    to the JAX package's C++ searcher and to the Python plain version;
    scores within 1e-5 + 1e-6 relative of both."""
    from wenet_tpu.lm.arpa import read_arpa as jax_read
    from wenet_tpu.runtime import native_beam as jax_beam
    from wenet_tpu_torch.lm.arpa import read_arpa
    from wenet_tpu_torch.runtime import native_beam
    from wenet_tpu_torch.utils.context_graph import (
        ctc_prefix_beam_search_with_context)
    kw, jkw = _fusion(mode, read_arpa(str(arpa_path / 'lm.arpa')),
                      jax_read(str(arpa_path / 'lm.arpa')))
    logp = np.stack([_logp(60, V, seed + b) for b in range(3)])
    lens = np.asarray([60, 51, 38])
    vals, ids = _topk(logp, 5)
    got = native_beam.batch_search_topk(vals, ids, lens, 5, finalize=True,
                                        **kw)
    want = jax_beam.batch_search_topk(vals, ids, lens, 5, finalize=True,
                                      **jkw)
    plain = ctc_prefix_beam_search_with_context(
        logp, lens, 5, kw.get('context_graph'), lm=kw.get('lm'),
        lm_weight=0.4, symbol_table=SYMTAB)
    for (hyps, times, scores), (jh, jt, js), p in zip(got, want, plain):
        assert (hyps, times) == (jh, jt) == (p.nbest, p.nbest_times)
        np.testing.assert_allclose(scores, js, atol=1e-5, rtol=1e-6)
        np.testing.assert_allclose(scores, p.nbest_scores, atol=1e-5,
                                   rtol=1e-6)


def test_native_incremental_matches_full(arpa_path):
    """Chunk by chunk equals one search (context and LM on), and a reset
    searcher repeats it."""
    from wenet_tpu_torch.lm.arpa import read_arpa
    from wenet_tpu_torch.runtime.native_beam import (
        NativeCtcPrefixBeamSearch, NativeLm)
    kw, _ = _fusion('ctx_lm', read_arpa(str(arpa_path / 'lm.arpa')), None)
    vals, ids = _topk(_logp(48, V, 3), 5)
    full = NativeCtcPrefixBeamSearch(5, 0, **kw)
    full.search_topk(vals, ids)
    full.finalize_search()
    chunked = NativeCtcPrefixBeamSearch(5, 0, **kw)
    for _ in range(2):
        for s in range(0, 48, 13):
            chunked.search_topk(vals[s:s + 13], ids[s:s + 13])
        chunked.finalize_search()
        assert (chunked.hypotheses, chunked.times) == (full.hypotheses,
                                                       full.times)
        assert chunked.likelihood == full.likelihood
        with pytest.raises(RuntimeError):
            chunked.search_topk(vals[:1], ids[:1])
        chunked.reset()
    # one flattened LM serves every searcher of that LM and table
    assert NativeLm.get(kw['lm'], SYMTAB) is NativeLm.get(kw['lm'], SYMTAB)


# --- on the card ---------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
def test_cuda_force_align_matches_cpu(cuda):
    """The Viterbi's frame loop on the card: the CPU's alignments (max and
    add are exact in float32 on both)."""
    from wenet_tpu_torch.utils.ctc_utils import force_align
    for T, label, seed in ((300, [3, 5, 7, 7, 2] * 8, 0), (11, [2, 6, 2, 8, 1],
                                                           2)):
        logp = torch.from_numpy(_logp(T, V, seed))
        assert force_align(logp.cuda(), label) == force_align(logp, label)
