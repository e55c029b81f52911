"""The transducer of the PyTorch port against the JAX package's, on the
CPU, from numpy seeds: the RNN-T loss (value and gradient with respect to
the logits, ragged T and U, U = 0, T = 1, the three reductions, and a
brute-force enumeration), the three predictors, the joint (plain and
HAT), a tiny transducer's loss dict and every parameter's gradient, the
greedy and beam searches (a prefix-hash collision included),
`AsrRunner.decode` in all six modes, `AsrDecoder` streaming over a
transducer, and the recipe's entry points: `bin/recognize.py` and two
steps a epoch of `bin/train.py` against the JAX package's, then the
port's resume, `average_model` and `decoder_main` on the trained model
directory.

Bars, each stated where it is held: the loss within rtol 1e-5 of the
JAX package's (1e-4 of the brute force, whose sums run in float64 over
float32 log-probs), its gradient within 1e-6; module outputs within
1e-5; the model's losses within rtol 1e-5 and its gradients within 1e-5
+ 1e-4 of each tensor's largest; hypotheses identical and scores within
2e-4 (the torch-import bar; 2e-3 absolute / 1e-5 relative for attention
rescoring, as tests/test_torch_recognize.py holds it); the entry points'
text files identical and train losses within rtol 1e-4, the bars of
tests/test_torch_recognize.py and tests/test_torch_train_main.py.

The JAX trainer runs in a subprocess (it sets process-wide JAX state),
started when the recipe is written so that it overlaps the other tests,
on one CPU device: on a mesh of several, the JAX executor pads a batch
with zero-length rows, which the JAX transducer's losses do not leave
out (the port's do, as its ASRModel's)."""

import copy
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_torch_runtime import OPTS, SYMS, _stream, _wave
from test_torch_runtime import _same as _same_results
from test_torch_train_main import _JAX_TRAIN, _captured, _parse
from torch_port_utils import (IDIM, TINY_CONFIG, VOCAB, feats, jax_model,
                              torch_model)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ['ctc_greedy_search', 'ctc_prefix_beam_search',
         'attention_rescoring', 'attention', 'rnnt_greedy_search',
         'rnnt_beam_search']
RNNT_MODES = ['rnnt_greedy_search', 'rnnt_beam_search',
              'attention_rescoring']
DECODE = ['--batch_size', '3', '--beam_size', '4', '--ctc_weight', '0.3',
          '--reverse_weight', '0.3']
N_UTTS = 6  # two static batches of three
LOSS_RTOL = 1e-5
GRAD_ATOL = 1e-6
SCORE_ATOL = 2e-4


def transducer_config(dropout=0.1):
    """TINY_CONFIG as the aishell rnnt yaml shapes it (LSTM predictor of
    two layers, join_dim = the encoder's width, the yaml's loss
    weights), narrow, with decoder 1 + 1 blocks."""
    cfg = copy.deepcopy(TINY_CONFIG)
    cfg['decoder_conf'].update(num_blocks=1, r_num_blocks=1)
    cfg['model'] = 'transducer'
    cfg['model_conf'] = {'transducer_weight': 0.75, 'ctc_weight': 0.1,
                         'attention_weight': 0.15, 'lsm_weight': 0.1,
                         'reverse_weight': 0.3}
    cfg['predictor'] = 'rnn'
    cfg['predictor_conf'] = {
        'embed_size': 32, 'output_size': 32, 'embed_dropout': dropout,
        'hidden_size': 32, 'num_layers': 2, 'bias': True,
        'rnn_type': 'lstm', 'dropout': dropout}
    cfg['joint'] = 'transducer_joint'
    cfg['joint_conf'] = {'join_dim': 64, 'prejoin_linear': True,
                         'postjoin_linear': False, 'joint_mode': 'add',
                         'activation': 'tanh'}
    return cfg


@pytest.fixture(scope='module')
def pair():
    """(JAX model, variables, the port's model) of the tiny transducer;
    the port's strict-loads the JAX weights."""
    cfg = transducer_config()
    model, variables = jax_model(cfg, seed=7)
    return model, variables, torch_model(cfg, variables)


@pytest.fixture(scope='module')
def encoded(pair):
    """Both packages' encoder outputs and lengths of one seeded batch
    (B = 3, T = 67), which the searches read."""
    model, variables, tmodel = pair
    x, lens = feats(13, B=3, T=67)
    enc, mask = model.apply(variables, jnp.asarray(x), jnp.asarray(lens),
                            method=model.forward_encoder)
    with torch.no_grad():
        tenc, tmask = tmodel.forward_encoder(torch.from_numpy(x),
                                             torch.from_numpy(lens))
    return (enc, jnp.sum(mask[:, 0, :], -1)), (tenc, tmask[:, 0].sum(-1))


# --- the loss -------------------------------------------------------------
def brute_force_rnnt(log_probs, labels, blank=0):
    """-log P(labels) over every monotonic alignment, by recursion in
    float64 (copied from tests/test_transducer.py).  log_probs:
    (T, U+1, V)."""
    import math
    from functools import lru_cache
    T = log_probs.shape[0]
    U = len(labels)

    @lru_cache(maxsize=None)
    def ll(t, u):
        if t == T - 1 and u == U:
            return float(log_probs[t, u, blank])
        cands = []
        if t < T - 1:
            cands.append(float(log_probs[t, u, blank]) + ll(t + 1, u))
        if u < U:
            cands.append(float(log_probs[t, u, labels[u]]) + ll(t, u + 1))
        if not cands:
            return -1e30
        m = max(cands)
        return m + math.log(sum(math.exp(c - m) for c in cands))

    return -ll(0, 0)


def _loss_case(seed, B, T, U, V, Ts, Us):
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, T, U + 1, V).astype(np.float32)
    labels = rng.randint(1, V, (B, U)).astype(np.int32)
    return (logits, labels, np.asarray(Ts, np.int32),
            np.asarray(Us, np.int32))


LOSS_CASES = {
    # ragged T and U, a row with U = 0 and one with T = 1
    'ragged': (0, 4, 9, 5, 7, [9, 1, 5, 3], [5, 3, 0, 2]),
    'all_u0': (1, 3, 6, 2, 5, [6, 4, 1], [0, 0, 0]),
    'all_t1': (2, 3, 1, 3, 6, [1, 1, 1], [3, 1, 0]),
}
# labels of width 0, which the JAX loss's gather cannot take: the port's
# is held to the enumeration alone
ZERO_WIDTH = {'zero_width': (1, 3, 6, 0, 5, [6, 4, 1], [0, 0, 0])}


def _losses(case, reduction):
    """The JAX and the port's loss and gradient with respect to the
    logits (of the sum of a reduction 'none')."""
    from wenet_tpu.ops.rnnt_loss import rnnt_loss_logits as jax_loss
    from wenet_tpu_torch.ops.rnnt_loss import rnnt_loss_logits
    logits, labels, Ts, Us = _loss_case(*LOSS_CASES[case])

    def f(x):
        out = jax_loss(x, jnp.asarray(labels), jnp.asarray(Ts),
                       jnp.asarray(Us), reduction=reduction)
        return jnp.sum(out), out

    (_, want), want_grad = jax.value_and_grad(f, has_aux=True)(
        jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    got = rnnt_loss_logits(x, torch.from_numpy(labels), torch.from_numpy(Ts),
                           torch.from_numpy(Us), reduction=reduction)
    got.sum().backward()
    return (got.detach().numpy(), x.grad.numpy(), np.asarray(want),
            np.asarray(want_grad))


@pytest.mark.parametrize('case', list(LOSS_CASES))
@pytest.mark.parametrize('reduction', ['mean', 'sum', 'none'])
def test_rnnt_loss_matches_jax(case, reduction):
    """Value within rtol LOSS_RTOL, gradient with respect to the logits
    within GRAD_ATOL, of `rnnt_loss_logits` and `jax.grad` of it."""
    got, got_grad, want, want_grad = _losses(case, reduction)
    assert np.all(np.isfinite(got)) and np.all(np.isfinite(got_grad))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got_grad, want_grad, atol=GRAD_ATOL, rtol=0)


@pytest.mark.parametrize('case', list(LOSS_CASES) + list(ZERO_WIDTH))
def test_rnnt_loss_matches_brute_force(case):
    """Each utterance's loss within 1e-4 of the float64 enumeration of
    its alignments (the bar of tests/test_transducer.py)."""
    import torch.nn.functional as F
    from wenet_tpu_torch.ops.rnnt_loss import rnnt_loss_logits
    logits, labels, Ts, Us = _loss_case(*{**LOSS_CASES, **ZERO_WIDTH}[case])
    got = rnnt_loss_logits(torch.from_numpy(logits), torch.from_numpy(labels),
                           torch.from_numpy(Ts), torch.from_numpy(Us),
                           reduction='none').numpy()
    logp = F.log_softmax(torch.from_numpy(logits), -1).numpy()
    for b in range(len(Ts)):
        want = brute_force_rnnt(logp[b, :Ts[b]], list(labels[b, :Us[b]]))
        assert abs(got[b] - want) < 1e-4, (b, got[b], want)


# --- predictors and joint -------------------------------------------------
def _noisy(variables, seed):
    """Every leaf moved by seeded noise: zero biases hide no slip."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.randn(*np.shape(a)).astype(
            np.float32), variables)


PREDICTORS = {
    'rnn': dict(embed_size=16, output_size=16, embed_dropout=0.0,
                hidden_size=24, num_layers=2),
    'embedding': dict(embed_size=16, output_size=16, embed_dropout=0.0,
                      n_head=4, history_size=2),
    'conv': dict(embed_size=16, output_size=16, embed_dropout=0.0,
                 history_size=2, bias=True),
}


@pytest.mark.parametrize('kind', list(PREDICTORS))
def test_predictor_matches_jax(kind):
    """forward over (B, U) labels and a chain of forward_step (rows
    padded on some steps) within 1e-5 of the JAX predictor's, states
    too; the port's strict-loads the JAX weights."""
    from wenet_tpu.models.transducer.predictor import (
        PREDICTOR_CLASSES as JAX_PREDICTORS)
    from wenet_tpu_torch.models.transducer.predictor import (
        PREDICTOR_CLASSES)
    from wenet_tpu_torch.utils.checkpoint import state_dict_from_jax
    V, B, L = 20, 3, 6
    jpred = JAX_PREDICTORS[kind](voca_size=V, **PREDICTORS[kind])
    rng = np.random.RandomState(3)
    tokens = rng.randint(0, V, (B, L)).astype(np.int32)
    variables = _noisy(jpred.init(jax.random.PRNGKey(0),
                                  jnp.asarray(tokens)), 4)
    pred = PREDICTOR_CLASSES[kind](voca_size=V, **PREDICTORS[kind]).eval()
    pred.load_state_dict(state_dict_from_jax(variables), strict=True)
    want = np.asarray(jax.jit(jpred.apply)(variables, jnp.asarray(tokens)))
    jstep = jax.jit(lambda v, x, pad, st: jpred.apply(
        v, x, pad, st, method=jpred.forward_step))
    with torch.no_grad():
        got = pred(torch.from_numpy(tokens).long()).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    pad = (rng.rand(L, B, 1) < 0.3).astype(np.float32)
    jstate = jpred.apply(variables, B, method=jpred.init_state)
    state = pred.init_state(B)
    for i in range(L):
        jout, jstate = jstep(variables, jnp.asarray(tokens[:, i:i + 1]),
                             jnp.asarray(pad[i]), jstate)
        with torch.no_grad():
            out, state = pred.forward_step(
                torch.from_numpy(tokens[:, i:i + 1]).long(),
                torch.from_numpy(pad[i]), state)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5,
                                   rtol=0, err_msg=f'step {i}')
        for s, js in zip(state, jstate):
            np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-5,
                                       rtol=0, err_msg=f'state {i}')


@pytest.mark.parametrize('hat', [False, True])
def test_joint_matches_jax(hat):
    """The joint of (B, T, E) frames and (B, U, P) predictor outputs
    within 1e-5 of the JAX joint's: plain (pre-join linears, tanh), and
    HAT with a post-join linear (the reference's `blank_pred.2` /
    `token_pred.2` keys)."""
    from wenet_tpu.models.transducer.joint import TransducerJoint as JaxJoint
    from wenet_tpu_torch.models.transducer.joint import TransducerJoint
    from wenet_tpu_torch.utils.checkpoint import state_dict_from_jax
    kw = dict(vocab_size=20, enc_output_size=16, pred_output_size=12,
              join_dim=24, hat_joint=hat, postjoin_linear=hat)
    rng = np.random.RandomState(5)
    enc = rng.randn(2, 7, 16).astype(np.float32)
    pred = rng.randn(2, 4, 12).astype(np.float32)
    jjoint = JaxJoint(**kw)
    variables = _noisy(jjoint.init(jax.random.PRNGKey(1), jnp.asarray(enc),
                                   jnp.asarray(pred)), 6)
    joint = TransducerJoint(**kw).eval()
    state = state_dict_from_jax(variables)
    assert hat == ('blank_pred.2.weight' in state)
    joint.load_state_dict(state, strict=True)
    want = np.asarray(jjoint.apply(variables, jnp.asarray(enc),
                                   jnp.asarray(pred)))
    with torch.no_grad():
        got = joint(torch.from_numpy(enc), torch.from_numpy(pred)).numpy()
    assert got.shape == (2, 7, 4, 20)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# --- the model --------------------------------------------------------------
def _labels(seed, B=3, L=6):
    rng = np.random.RandomState(seed)
    tl = np.asarray([L, 3, 0][:B], np.int64)
    tgt = rng.randint(3, VOCAB, (B, L))
    tgt[np.arange(L)[None] >= tl[:, None]] = -1
    return tgt, tl


def test_transducer_loss_and_grads_match_jax(pair):
    """The loss dict (loss, loss_rnnt, loss_ctc, loss_att, th_accuracy)
    within rtol LOSS_RTOL (an utterance with no label among them), and
    every parameter's gradient within 1e-5 + 1e-4 of the tensor's largest
    of `jax.grad`'s, carried across by `state_dict_from_jax`."""
    from wenet_tpu_torch.utils.checkpoint import state_dict_from_jax
    model, variables, tmodel = pair
    x, lens = feats(11, B=3, T=67)
    tgt, tl = _labels(12)
    args = (jnp.asarray(x), jnp.asarray(lens), jnp.asarray(tgt),
            jnp.asarray(tl))

    def loss_fn(params):
        out = model.apply(dict(variables, params=params), *args)
        return out['loss'], out

    (_, want), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables['params'])
    tmodel.zero_grad()
    got = tmodel(torch.from_numpy(x), torch.from_numpy(lens),
                 torch.from_numpy(tgt), torch.from_numpy(tl))
    got['loss'].backward()
    for k in ('loss', 'loss_rnnt', 'loss_ctc', 'loss_att', 'th_accuracy'):
        np.testing.assert_allclose(got[k].item(), float(want[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    want_grads = state_dict_from_jax({'params': grads})
    params = dict(tmodel.named_parameters())
    assert set(want_grads) == set(params)
    for name, g in want_grads.items():
        g = g.numpy()
        np.testing.assert_allclose(
            params[name].grad.numpy(), g, rtol=0,
            atol=1e-5 + 1e-4 * np.abs(g).max(), err_msg=name)
    tmodel.zero_grad()


@pytest.mark.parametrize('n_steps', [1, 64])
def test_greedy_matches_jax(pair, encoded, n_steps):
    """The (B, 2T) token matrix and the emitted counts identical."""
    model, variables, tmodel = pair
    (enc, lens), (tenc, tlens) = encoded
    want, want_n = model.apply(variables, enc, lens, n_steps,
                               method=model.greedy_search)
    with torch.no_grad():
        got, got_n = tmodel.greedy_search(tenc, tlens, n_steps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    assert got_n.min() > 0


def test_beam_matches_jax(pair, encoded):
    """Beam 4 with the default CTC fusion: tokens and lengths identical,
    scores within SCORE_ATOL, best first."""
    model, variables, tmodel = pair
    (enc, lens), (tenc, tlens) = encoded
    want = model.apply(variables, enc, lens, 4, method=model.beam_search)
    with torch.no_grad():
        got = tmodel.beam_search(tenc, tlens, 4)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               atol=SCORE_ATOL, rtol=0)
    assert np.all(np.diff(got[2].numpy(), axis=1) <= 0)


def _rolling_hash(seqs):
    """The beam's uint32 prefix hash of each row of `seqs` (n, L)."""
    h = np.ones(len(seqs), np.uint64)
    for col in seqs.T:
        h = (h * 1000003 + col.astype(np.uint64) + 1) & 0xFFFFFFFF
    return h


# a uint32 collision of the rolling hash: two 26-unit prefixes that
# differ by DELTA at COLLIDE_AT (and agree elsewhere) hash alike, since
# the hash of a prefix is M**L + sum (unit + 1) * M**(L - 1 - i) mod 2**32
COLLIDE_LEN = 26
COLLIDE_AT = (0, 16, 24, 25)
DELTA = (-12, 11, -15, 16)


def test_beam_hash_collision_matches_jax(pair):
    """Two prefixes whose uint32 hashes collide are merged into one, as
    in the JAX package.  The joint is set so that frame i gives its unit
    of p probability ~1 where p and q agree, p_i and q_i half each where
    they differ, whatever the predictor says, and a last frame blank: the
    sixteen prefixes tie at 0.5**4 but for p and q, merged into the
    first at twice that.  Beam 16 without CTC fusion: tokens and lengths
    identical to the JAX search, scores within SCORE_ATOL, the best ahead
    of the next by log 2."""
    from wenet_tpu_torch.utils.checkpoint import state_dict_from_jax
    model, variables, tmodel = pair
    p = np.full(COLLIDE_LEN, 5)
    q = p.copy()
    for i, delta in zip(COLLIDE_AT, DELTA):
        p[i] = 5 if delta > 0 else 20
        q[i] = p[i] + delta
    assert _rolling_hash(p[None])[0] == _rolling_hash(q[None])[0]
    assert min(p.min(), q.min()) >= 3 and max(p.max(), q.max()) < VOCAB
    D, T = 64, COLLIDE_LEN + 1
    params = jax.tree_util.tree_map(np.asarray, variables['params'])
    joint = params['joint']
    joint['enc_ffn'] = {'kernel': np.eye(D, dtype=np.float32),
                        'bias': np.zeros(D, np.float32)}
    joint['pred_ffn'] = jax.tree_util.tree_map(np.zeros_like,
                                               joint['pred_ffn'])
    out = np.zeros((D, VOCAB), np.float32)
    out[np.arange(VOCAB), np.arange(VOCAB)] = 20.0
    joint['ffn_out'] = {'kernel': out, 'bias': np.zeros(VOCAB, np.float32)}
    new_vars = dict(variables, params=params)
    enc = np.zeros((1, T, D), np.float32)
    enc[0, :, :VOCAB] = -3.0
    for i in range(COLLIDE_LEN):
        enc[0, i, [p[i], q[i]]] = 3.0
    enc[0, COLLIDE_LEN, 0] = 3.0
    lens = np.asarray([T])
    want = model.apply(new_vars, jnp.asarray(enc), jnp.asarray(lens), 16,
                       0.0, 1.0, 32, method=model.beam_search)
    tmodel = copy.deepcopy(tmodel)
    tmodel.load_state_dict(state_dict_from_jax(new_vars), strict=True)
    with torch.no_grad():
        got = tmodel.beam_search(torch.from_numpy(enc),
                                 torch.from_numpy(lens), 16, 0.0, 1.0, 32)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               atol=SCORE_ATOL, rtol=0)
    best = list(got[0][0, 0, :COLLIDE_LEN].numpy())
    assert best in (list(p), list(q))
    assert int(got[1][0, 0]) == COLLIDE_LEN
    gap = float(got[2][0, 0] - got[2][0, 1])
    assert abs(gap - np.log(2)) < 1e-3, gap


def _same(got, want, what, atol=SCORE_ATOL, rtol=0.0):
    assert [r.tokens for r in got] == [list(r.tokens) for r in want], what
    np.testing.assert_allclose([r.score for r in got],
                               [r.score for r in want], atol=atol,
                               rtol=rtol, err_msg=what)


def test_runner_all_modes_match_jax(pair):
    """`AsrRunner.decode` in the six modes on one transducer: the CTC and
    attention modes through the inherited heads, the rnnt modes through
    the searches; hypotheses identical, scores within the bars, the beam's
    n-best too."""
    from wenet_tpu.models.runner import AsrRunner as JaxRunner
    from wenet_tpu_torch.models.runner import AsrRunner
    model, variables, tmodel = pair
    x, lens = feats(15, B=3, T=67)
    kw = dict(beam_size=4, ctc_weight=0.3, reverse_weight=0.3)
    want = JaxRunner(model, variables).decode(MODES, x, lens, **kw)
    got = AsrRunner(tmodel, 'cpu').decode(MODES, x, lens, **kw)
    assert set(got) == set(MODES)
    for mode in MODES:
        bar = (dict(atol=2e-3, rtol=1e-5) if mode == 'attention_rescoring'
               else {})
        _same(got[mode], want[mode], mode, **bar)
    for g, w in zip(got['rnnt_beam_search'], want['rnnt_beam_search']):
        assert g.nbest == w.nbest
        np.testing.assert_allclose(g.nbest_scores, w.nbest_scores,
                                   atol=SCORE_ATOL, rtol=0)
    assert all(len(r.tokens) > 0 for r in got['rnnt_greedy_search'])


@pytest.mark.parametrize('seed,seconds', [(3, 1.6)])
def test_asr_decoder_matches_jax(pair, seed, seconds):
    """The model directory's streaming decoder over a transducer, as the
    JAX package's: CTC prefix beam on the inherited chunk step and
    `ctc_activation`, then attention rescoring; every partial and the
    final equal (scores within SCORE_ATOL)."""
    from wenet_tpu.runtime.asr_decoder import (AsrDecoder as JaxDecoder,
                                               DecodeOptions as JaxOptions)
    from wenet_tpu.runtime.feature_pipeline import (
        FeaturePipeline as JaxPipeline, FeaturePipelineConfig as JaxConfig)
    from wenet_tpu.text.char_tokenizer import CharTokenizer as JaxTokenizer
    from wenet_tpu_torch.runtime.asr_decoder import AsrDecoder, DecodeOptions
    from wenet_tpu_torch.runtime.feature_pipeline import FeaturePipelineConfig
    from wenet_tpu_torch.text.char_tokenizer import CharTokenizer
    model, variables, tmodel = pair
    jd = JaxDecoder(model, variables, JaxTokenizer(SYMS), JaxOptions(**OPTS))
    jd.feature_pipeline = JaxPipeline(JaxConfig(num_mel_bins=IDIM),
                                      prefer_native=False)
    jd.reset()
    td = AsrDecoder(tmodel, CharTokenizer(SYMS), DecodeOptions(**OPTS),
                    FeaturePipelineConfig(num_mel_bins=IDIM), device='cpu')
    wav = _wave(seed, seconds)
    want_partials, want_final = _stream(jd, wav)
    got_partials, got_final = _stream(td, wav)
    assert len(got_partials) == len(want_partials)
    for g, w in zip(got_partials, want_partials):
        _same_results(g, w)
    _same_results(got_final, want_final)
    assert got_final and got_final[0][0]


# --- the recipe's entry points ----------------------------------------------
def _speech(rng, seconds, rate=16000):
    t = np.arange(int(seconds * rate)) / rate
    x = 0.1 * rng.randn(len(t)) + 0.2 * np.sin(2 * np.pi * 440 * t) * (
        np.sin(2 * np.pi * 2 * t) > 0)
    return (np.round(np.clip(x, -1, 1) * 32767) / 32768).astype(np.float32)


def _recipe_config(d):
    """The tiny transducer as a train.yaml: one encoder block, dropouts
    0 (the packages' random streams differ), full context, the char
    dict, the cmvn file, static batches of three and the Adam of
    tests/test_torch_train_main.py."""
    cfg = transducer_config(dropout=0.0)
    del cfg['input_dim'], cfg['output_dim']
    for conf in (cfg['encoder_conf'], cfg['decoder_conf']):
        for k in conf:
            if k.endswith('dropout_rate'):
                conf[k] = 0.0
    cfg['encoder_conf'].update(use_dynamic_chunk=False, num_blocks=1)
    cfg['tokenizer'] = 'char'
    cfg['tokenizer_conf'].update(symbol_table_path=str(d / 'units.txt'),
                                 non_lang_syms_path=None,
                                 split_with_space=False)
    cfg['cmvn_conf'] = {'cmvn_file': str(d / 'global_cmvn'),
                        'is_json_cmvn': True}
    cfg['dataset_conf'] = {
        'filter_conf': {'max_length': 4000, 'min_length': 0,
                        'token_min_length': 1},
        'resample_conf': {'resample_rate': 16000},
        'fbank_conf': {'num_mel_bins': IDIM, 'frame_shift': 10,
                       'frame_length': 25, 'dither': 0.0},
        'batch_conf': {'batch_type': 'static', 'batch_size': 3},
        'pad_conf': {'pad_to_multiple': 256, 'label_pad_to_multiple': 8},
        'shuffle': False, 'list_shuffle': False, 'sort': True,
        'spec_aug': False}
    cfg.update(grad_clip=5.0, accum_grad=1, max_epoch=2, log_interval=1,
               optim='adam', optim_conf={'lr': 0.002, 'eps': 1e-3},
               scheduler='warmuplr', scheduler_conf={'warmup_steps': 4})
    return cfg


def _jax_env():
    env = dict(os.environ, JAX_PLATFORMS='cpu',
               XLA_FLAGS='--xla_force_host_platform_device_count=1')
    env['PYTHONPATH'] = os.pathsep.join(
        [REPO, os.path.join(REPO, 'tests'), env.get('PYTHONPATH', '')])
    return env


@pytest.fixture(scope='module')
def recipe(tmp_path_factory):
    """units.txt, six wavs and their data list and wav.scp, the cmvn
    stats, train.yaml, the JAX trainer's initial weights (init.pt, the
    reference layout) and the JAX trainer started on them: two epochs of
    two steps, in a subprocess that runs beside the tests until
    `jax_train` reads it."""
    from wenet_tpu.utils.init_model import init_model, init_variables
    from wenet_tpu_torch.bin.compute_cmvn_stats import main as cmvn_main
    from wenet_tpu_torch.dataset.audio import write_wav
    from wenet_tpu_torch.utils.checkpoint import state_dict_from_jax
    d = tmp_path_factory.mktemp('transducer_recipe')
    (d / 'units.txt').write_text(''.join(f'{k} {v}\n'
                                         for k, v in SYMS.items()))
    rng = np.random.RandomState(0)
    chars = [c for c, i in SYMS.items() if i >= 3]
    entries = []
    for i in range(N_UTTS):
        path = d / f'u{i}.wav'
        write_wav(str(path), _speech(rng, 0.6 + 0.15 * i), 16000)
        entries.append({'key': f'u{i}', 'wav': str(path),
                        'txt': ''.join(rng.choice(chars, size=2 + i % 4))})
    (d / 'data.list').write_text(''.join(json.dumps(e) + '\n'
                                         for e in entries))
    (d / 'wav.scp').write_text(''.join(f'{e["key"]} {e["wav"]}\n'
                                       for e in entries))
    cfg = _recipe_config(d)
    with open(d / 'train.yaml', 'w') as f:
        yaml.safe_dump(cfg, f)
    cmvn_main(['--train_config', str(d / 'train.yaml'), '--in_scp',
               str(d / 'wav.scp'), '--out_cmvn', str(d / 'global_cmvn')])
    jcfg = dict(copy.deepcopy(cfg), input_dim=IDIM, output_dim=VOCAB)
    jmodel, jcfg = init_model(None, jcfg)
    impl = jax.config.jax_default_prng_impl
    jax.config.update('jax_default_prng_impl', 'unsafe_rbg')
    try:  # the JAX trainer's draw: PRNGKey(--seed) under --prng_impl
        variables, _ = init_variables(jmodel, jcfg, jax.random.PRNGKey(777))
    finally:
        jax.config.update('jax_default_prng_impl', impl)
    torch.save(state_dict_from_jax(variables), d / 'init.pt')
    proc = subprocess.Popen(
        [sys.executable, '-c', _JAX_TRAIN, '--config', str(d / 'train.yaml'),
         '--train_data', str(d / 'data.list'), '--cv_data',
         str(d / 'data.list'), '--model_dir', str(d / 'jax_exp')],
        env=_jax_env(), cwd=str(d), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    yield d, proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope='module', autouse=True)
def start_jax_trainer(recipe):
    """Write the recipe, and so start the JAX trainer, before the first
    test: it runs beside all of them."""


@pytest.fixture(autouse=True)
def jax_host_settings(monkeypatch):
    """No persistent compile cache from the JAX package's mains, and its
    feature pipeline on the numpy fbank the port copies."""
    monkeypatch.setenv('WENET_TPU_NO_COMPILE_CACHE', '1')
    monkeypatch.setattr('wenet_tpu.runtime.native_fbank.available',
                        lambda: False)


def _texts(result_dir, modes):
    return {m: open(os.path.join(result_dir, m, 'text'),
                    encoding='utf8').read() for m in modes}


@pytest.mark.parametrize('modes', [['rnnt_greedy_search'], RNNT_MODES],
                         ids=['greedy_alone', 'three_modes'])
def test_recognize_matches_jax(recipe, tmp_path, monkeypatch, modes):
    """bin/recognize.py on the JAX initial weights: the rnnt greedy mode
    alone (the JAX package's pipelined branch) and beside the beam and
    attention rescoring (its sequential loop): identical text files."""
    from wenet_tpu.bin import recognize as jax_recognize
    from wenet_tpu_torch.bin import recognize
    d, _ = recipe
    argv = ['--config', str(d / 'train.yaml'), '--test_data',
            str(d / 'data.list'), '--checkpoint', str(d / 'init.pt'),
            *DECODE, '--modes', *modes]
    summary = recognize.main(argv + ['--result_dir', str(tmp_path / 'port'),
                                     '--device', 'cpu'])
    assert summary['lines'] == dict.fromkeys(modes, N_UTTS)
    monkeypatch.setattr(sys, 'argv', ['recognize.py'] + argv + [
        '--result_dir', str(tmp_path / 'jax')])
    jax_recognize.main()
    got, want = _texts(tmp_path / 'port', modes), _texts(tmp_path / 'jax',
                                                         modes)
    assert got == want
    assert all(len(line.split()) == 2 for line in
               got['rnnt_greedy_search'].splitlines())


@pytest.fixture(scope='module')
def jax_train(recipe):
    """The JAX trainer's log, parsed: ([(epoch, step, metrics)], cv)."""
    _, proc = recipe
    log, _ = proc.communicate(timeout=900)
    assert proc.returncode == 0, log[-3000:]
    return _parse(log)


@pytest.fixture(scope='module')
def port_train(recipe):
    """The port's bin/train.py over the same data from init.pt."""
    from wenet_tpu_torch.bin.train import main
    d, _ = recipe
    argv = ['--config', str(d / 'train.yaml'), '--train_data',
            str(d / 'data.list'), '--cv_data', str(d / 'data.list'),
            '--model_dir', str(d / 'port_exp'), '--checkpoint',
            str(d / 'init.pt'), '--device', 'cpu']
    with _captured() as lines:
        summary = main(argv)
    return _parse('\n'.join(lines)), summary


def test_train_matches_jax(port_train, jax_train):
    """Two epochs of two steps: per-step loss, loss_att, loss_ctc and lr
    (what the JAX trainer logs) within rtol 1e-4, each epoch's cv losses
    (loss_rnnt too) within rtol 1e-4; the port also logs loss_rnnt each
    step."""
    (steps, cvs), summary = port_train
    want_steps, want_cvs = jax_train
    assert [s[:2] for s in steps] == [(0, 1), (0, 2), (1, 3), (1, 4)]
    assert [s[:2] for s in steps] == [s[:2] for s in want_steps]
    for (epoch, step, g), (_, _, w) in zip(steps, want_steps):
        assert np.isfinite(g['loss_rnnt'])
        for k in ('loss', 'loss_att', 'loss_ctc', 'lr'):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4,
                                       err_msg=f'epoch {epoch} step {step} '
                                               f'{k}')
    assert len(cvs) == len(want_cvs) == 2
    for g, w in zip(cvs, want_cvs):
        for k in ('loss', 'loss_att', 'loss_ctc', 'loss_rnnt'):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
    assert [e['steps'] for e in summary['epochs']] == [2, 2]


def test_train_resumes_averages_and_decodes(recipe, port_train, tmp_path):
    """The port alone: resumed from epoch_0, the second epoch starts at
    step 3; average_model of the two epochs loads into the transducer
    (strict); decoder_main on a model directory of the average writes a
    line for every wav, as AsrDecoder on the loaded model does."""
    from wenet_tpu_torch.bin.average_model import main as average
    from wenet_tpu_torch.bin.decoder_main import main as decoder_main
    from wenet_tpu_torch.bin.train import main as train
    from wenet_tpu_torch.utils.checkpoint import load_model_dir
    d, _ = recipe
    exp = d / 'port_exp'
    resumed = tmp_path / 'resumed'
    resumed.mkdir()
    for name in ('epoch_0.pt', 'epoch_0.yaml'):
        (resumed / name).write_bytes((exp / name).read_bytes())
    records = []
    train(['--config', str(d / 'train.yaml'), '--train_data',
           str(d / 'data.list'), '--cv_data', str(d / 'data.list'),
           '--model_dir', str(resumed), '--checkpoint',
           str(resumed / 'epoch_0.pt'), '--device', 'cpu'],
          on_step=records.append)
    assert [(r['epoch'], r['step']) for r in records] == [(1, 3), (1, 4)]
    model_dir = tmp_path / 'model'
    model_dir.mkdir()
    average(['--src_path', str(exp), '--dst_model',
             str(model_dir / 'final.pt'), '--num', '2', '--val_best'])
    (model_dir / 'train.yaml').write_text((exp / 'train.yaml').read_text())
    (model_dir / 'units.txt').write_text((d / 'units.txt').read_text())
    model, _, tokenizer = load_model_dir(str(model_dir), 'cpu')
    assert type(model).__name__ == 'Transducer'
    result = tmp_path / 'text'
    decoder_main(['--model_dir', str(model_dir), '--wav_scp',
                  str(d / 'wav.scp'), '--result_file', str(result),
                  '--device', 'cpu'])
    lines = result.read_text(encoding='utf-8').splitlines()
    assert [line.split(' ')[0] for line in lines] == [
        f'u{i}' for i in range(N_UTTS)]
