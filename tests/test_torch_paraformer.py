"""Paraformer in the PyTorch port against the JAX package's, on the CPU,
at a tiny width (2 + 2 blocks of 32, 2 heads), from numpy seeds, on one
set of weights carried across with `state_dict_from_jax`: low frame rate
stacking on ragged lengths; the CIF recurrence (fire positions and
acoustic embeddings, T = 2000 too) and its timestamp trace; the SAN-M
encoder and decoder; the predictor with its timestamp branch; the loss
and every parameter's gradient, with the glancing sampler off and held
to the JAX `_sampler` on identical scores; `forward_paraformer`; the
greedy and beam searches with their peak timestamps through
`AsrRunner.decode`; the tokenizer; the FunASR converters; and the
recipe's entry points on a shrunk copy of
examples/aishell/paraformer/conf/train_paraformer.yaml.

Bars: module outputs within 2e-4 (the torch-import bar); fire positions
and token counts identical; losses within rtol 1e-4 and gradients within
1e-5 + 1e-4 of each tensor's largest; hypotheses and peak timestamps
identical, confidences and scores within 2e-4; the entry points' text
files identical, per-step train losses within rtol 1e-4 and each weight
within 1e-6 + 1% of its largest change (tests/test_torch_train_main.py's
bars).

Where the CIF alphas are scaled to integrate to the label count (the
training path), the last token fires or not on the float32 rounding of
that total: the two packages' alphas differ in their last bits, so the
loss tests run the predictor at threshold 0.9999, which puts that fire
1e-4 clear of the rounding (ROADMAP.md queue 3).  The decode path has no
such tie: its token count is ⌊sum of alphas + tail⌋, held equal where
the sum lies further than 1e-4 from an integer.

The cuda-marked tests hold the SAN-M attention's flash kernels at head
dim 128 (K4 at the decode shape, K4-train, K5 and K6 at the long-form
train shape) against their plain versions on the card."""

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
                                   _parse, _speech)
from torch_port_utils import jax_model, torch_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAFORMER_YAML = os.path.join(
    REPO, 'examples/aishell/paraformer/conf/train_paraformer.yaml')
MEL = 40
VOCAB = 50
TOL = 2e-4
LOSS_RTOL = 1e-4
CHARS = '你好世界天地人和大小'
EN_WORDS = ['hello', 'world', 'paraformer']
N_UTTS = 8  # two static batches of four
JAX_TRAINERS = {}  # started by `recipe`, collected by `runs`

_JAX_TRAIN = textwrap.dedent('''
    import logging, os, sys
    sys.modules['torch.utils.tensorboard'] = None
    import jax
    jax.config.update('jax_platforms', 'cpu')
    import wenet_tpu.runtime.native_fbank as native_fbank
    native_fbank.available = lambda: False
    logging.basicConfig(level=logging.INFO, format='%(message)s')
    from wenet_tpu.bin.train import main
    sys.argv = ['train.py'] + sys.argv[1:]
    main()
''')


def paraformer_config(threshold=1.0, ctc_weight=0.3):
    """The yaml's structure at a tiny width, no dropout."""
    return {
        'input_dim': MEL * 7, 'output_dim': VOCAB,
        'lfr_conf': {'lfr_m': 7, 'lfr_n': 6},
        'encoder': 'sanm_encoder',
        'encoder_conf': {'output_size': 32, 'attention_heads': 2,
                         'linear_units': 64, 'num_blocks': 2,
                         'kernel_size': 7, 'sanm_shfit': 0,
                         'dropout_rate': 0.0,
                         'positional_dropout_rate': 0.0,
                         'attention_dropout_rate': 0.0,
                         'input_layer': 'paraformer_dummy'},
        'decoder': 'sanm_decoder',
        'decoder_conf': {'attention_heads': 2, 'linear_units': 64,
                         'num_blocks': 2, 'att_layer_num': 2,
                         'kernel_size': 7, 'dropout_rate': 0.0,
                         'self_attention_dropout_rate': 0.0,
                         'src_attention_dropout_rate': 0.0},
        'predictor_conf': {'threshold': threshold, 'dropout': 0.0},
        'model': 'paraformer',
        'model_conf': {'ctc_weight': ctc_weight, 'lsm_weight': 0.1,
                       'length_normalized_loss': True,
                       'sampling_ratio': 0.75},
        'cmvn': 'global_cmvn',
        'ctc_conf': {'ctc_blank_id': 0},
        'tokenizer_conf': {'special_tokens': {'<blank>': 0, '<unk>': 1,
                                              '<sos>': 2, '<eos>': 2}},
    }


@pytest.fixture(scope='module')
def pair():
    """{threshold: (JAX model, variables, port model)} on one set of
    weights: 1.0 (the yaml's) and 0.9999 (the loss tests')."""
    model, variables = jax_model(paraformer_config(), seed=3)
    out = {1.0: (model, variables, torch_model(paraformer_config(),
                                               variables))}
    cfg = paraformer_config(threshold=0.9999)
    from wenet_tpu.utils.init_model import init_model
    out[0.9999] = (init_model(None, copy.deepcopy(cfg))[0], variables,
                   torch_model(cfg, variables))
    return out


@pytest.fixture(autouse=True)
def start_jax_trainer(request):
    """Write the recipe, which starts the JAX trainer, at the file's first
    test, so that it trains while the other tests run (not for the card's
    tests, which run where there is no JAX)."""
    if not request.node.get_closest_marker('cuda'):
        request.getfixturevalue('recipe')


def _inputs(seed=0, B=3, T=67, L=6):
    rng = np.random.RandomState(seed)
    feats = rng.randn(B, T, MEL).astype(np.float32)
    lens = np.asarray([T] + list(rng.randint(T // 3, T, size=B - 1)))
    tl = np.asarray([L] + list(rng.randint(1, L, size=B - 1)))
    tgt = rng.randint(3, VOCAB, (B, L))
    tgt = np.where(np.arange(L)[None] < tl[:, None], tgt, -1)
    return feats, lens, tgt, tl


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _close(got, want, tol=TOL, msg=''):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=tol,
                               rtol=0, err_msg=msg)


# --- lfr and cif -----------------------------------------------------------
@pytest.mark.parametrize('T,lens', [(13, [13, 10, 1]), (67, [67, 40, 6]),
                                    (60, [60, 59, 55])])
def test_lfr_matches_jax(T, lens):
    import jax.numpy as jnp
    from wenet_tpu.models.paraformer.layers import lfr as jax_lfr
    from wenet_tpu_torch.models.paraformer.layers import lfr
    x = np.random.RandomState(T).randn(3, T, 5).astype(np.float32)
    want, want_len = jax_lfr(jnp.asarray(x), jnp.asarray(lens))
    got, got_len = lfr(*_t(x, np.asarray(lens)))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))


@pytest.mark.parametrize('B,T,cap,scaled', [(3, 40, 30, False),
                                            (3, 40, 12, True),
                                            (2, 2000, 1200, False)])
def test_cif_matches_jax(B, T, cap, scaled):
    """Identical alphas: the fires bit for bit (the sequential float32
    recurrence of both), the fired token count and the acoustic
    embeddings within 2e-4; `scaled` alphas integrate to an integer, as
    in training; T = 2000 is long-form."""
    import jax.numpy as jnp
    from wenet_tpu.models.paraformer.cif import cif as jax_cif
    from wenet_tpu_torch.models.paraformer.cif import cif
    rng = np.random.RandomState(T + cap)
    hidden = rng.randn(B, T, 8).astype(np.float32)
    alphas = rng.uniform(0.0, 0.9, (B, T)).astype(np.float32)
    alphas[1, T // 2:] = 0.0  # a padded tail
    if scaled:
        alphas *= (np.asarray([9, 4, 7], np.float32)[:B] /
                   alphas.sum(1))[:, None]
    want_frames, want_fires = jax_cif(jnp.asarray(hidden),
                                      jnp.asarray(alphas), 1.0, cap)
    frames, fires = cif(*_t(hidden, alphas), 1.0, cap)
    np.testing.assert_array_equal(fires.numpy(), np.asarray(want_fires))
    assert frames.shape == (B, cap, 8)
    _close(frames.numpy(), want_frames)


def test_cif_without_hidden_matches_jax():
    import jax.numpy as jnp
    from wenet_tpu.models.paraformer.cif import (
        cif_without_hidden as jax_trace)
    from wenet_tpu_torch.models.paraformer.cif import cif_without_hidden
    alphas = np.random.RandomState(1).uniform(0, 0.6, (2, 2000)).astype(
        np.float32)
    want = np.asarray(jax_trace(jnp.asarray(alphas), 0.9999))
    got = cif_without_hidden(torch.as_tensor(alphas), 0.9999).numpy()
    np.testing.assert_array_equal(got, want)
    # the fires that timestamps read
    assert ((got > 1 - 1e-4) == (want > 1 - 1e-4)).all()


@pytest.mark.parametrize('normalize_length', [False, True])
def test_mae_loss_matches_jax(normalize_length):
    import jax.numpy as jnp
    from wenet_tpu.models.paraformer.cif import mae_loss as jax_mae
    from wenet_tpu_torch.models.paraformer.cif import mae_loss
    lens = np.asarray([7, 3, 5])
    pred = np.asarray([6.4, 3.2, 5.9], np.float32)
    want = jax_mae(jnp.asarray(lens), jnp.asarray(pred), normalize_length)
    got = mae_loss(*_t(lens, pred), normalize_length)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# --- modules ---------------------------------------------------------------
def _jax_apply(model, variables, fn, *args):
    """`model.apply(variables, *args, method=fn)`, jitted (None args
    stay static)."""
    import jax
    import jax.numpy as jnp
    given = [i for i, a in enumerate(args) if a is not None]

    def run(v, *arrays):
        full = list(args)
        for i, a in zip(given, arrays):
            full[i] = a
        return model.apply(v, *full, method=fn)
    out = jax.jit(run)(variables, *[jnp.asarray(args[i]) for i in given])
    return jax.tree_util.tree_map(np.asarray, out)


def test_sanm_encoder_and_decoder_match_jax(pair):
    """The encoder (LFR inputs, cmvn, the paraformer position encoding,
    encoders0 at the LFR width, the SAN-M blocks) and the decoder (FSMN
    blocks with cross attention, decoders3, the output layer) on the same
    inputs."""
    from wenet_tpu_torch.models.paraformer.layers import lfr
    model, variables, port = pair[1.0]
    feats, lens, _, _ = _inputs(1)
    xs, xs_lens = lfr(*_t(feats, lens))
    enc, enc_mask = _jax_apply(model, variables,
                               lambda m, x, l: m.encoder(x, l),
                               xs.numpy(), xs_lens.numpy())
    with torch.no_grad():
        got, mask = port.encoder(xs, xs_lens)
    np.testing.assert_array_equal(mask.numpy(), enc_mask)
    _close(got.numpy(), enc, msg='encoder')
    rng = np.random.RandomState(2)
    emb = rng.randn(3, 7, 32).astype(np.float32)
    ys_lens = np.asarray([7, 4, 1])
    want = _jax_apply(model, variables,
                      lambda m, e, k, s, n: m.decoder(e, k, s, n)[0],
                      enc, enc_mask, emb, ys_lens)
    with torch.no_grad():
        got = port.decoder(*_t(enc, enc_mask, emb, ys_lens))
    _close(got.numpy(), want, msg='decoder')


@pytest.mark.parametrize('with_targets', [False, True])
def test_predictor_matches_jax(pair, with_targets):
    """Cif and the timestamp branch (transposed conv, BLSTM over padded
    frames, head): without targets (decode: the tail slot, a static cap),
    and with them (training, threshold 0.9999)."""
    model, variables, port = pair[0.9999 if with_targets else 1.0]
    rng = np.random.RandomState(4)
    hidden = rng.randn(3, 12, 32).astype(np.float32)
    mask = (np.arange(12)[None] < np.asarray([12, 8, 3])[:, None])[:, None]
    targets = np.asarray([7, 5, 2]) if with_targets else None
    cap = 7 if with_targets else 12

    def fn(m, h, k, t):
        return m.predictor(h, t, k, max_out_len=cap)
    want = _jax_apply(model, variables, fn, hidden, mask,
                      targets if with_targets else None)
    with torch.no_grad():
        got = port.predictor(*_t(hidden), None if targets is None else
                             torch.as_tensor(targets), torch.as_tensor(mask),
                             max_out_len=cap)
    names = ['acoustic_embeds', 'token_num', 'alphas', 'fires', 'tp_alphas',
             'tp_token_num', 'tp_mask']
    for name, g, w in zip(names, got, want):
        assert tuple(g.shape) == np.shape(w), name
        _close(g.numpy(), w, msg=name)
    # fire positions identical
    threshold = port.predictor.predictor.threshold
    np.testing.assert_array_equal(got[3].numpy() >= threshold,
                                  want[3] >= threshold)


def _grads(port):
    return {n: (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
            for n, p in port.named_parameters()}


def _assert_grads(got, want_params):
    from wenet_tpu_torch.utils.checkpoint import state_dict_from_jax
    want = state_dict_from_jax({'params': want_params})
    assert set(got) == set(want)
    for n, g in got.items():
        w = want[n].numpy()
        _close(g, w, 1e-5 + 1e-4 * np.abs(w).max(), msg=n)


def test_loss_and_gradients_match_jax(pair):
    """Eval mode (no sampler, as the JAX package's train=False): every
    loss of the dict, CTC included, and every parameter's gradient (the
    yaml's ctc_weight 0, without a CTC head, is held through the entry
    point in test_train_matches_jax)."""
    import jax
    import jax.numpy as jnp
    model, variables, port = pair[0.9999]
    batch = _inputs(5)
    jb = [jnp.asarray(a) for a in batch]
    want = jax.tree_util.tree_map(np.asarray, jax.jit(model.apply)(
        variables, *jb))
    grads = jax.jit(jax.grad(lambda p: model.apply(
        {**variables, 'params': p}, *jb)['loss']))(variables['params'])
    port.zero_grad()
    got = port(*_t(*batch))
    got['loss'].backward()
    for k, w in want.items():
        if w is None:
            assert got[k] is None, k
            continue
        np.testing.assert_allclose(float(got[k]), w, rtol=LOSS_RTOL,
                                   atol=1e-6, err_msg=k)
    _assert_grads(_grads(port), grads)


def test_sampler_matches_jax(pair):
    """`_sampler` on the same encoder output, acoustic embeddings and
    labels, the port given the uniform scores the JAX sampler draws:
    the same positions take their label embedding."""
    import jax
    model, variables, port = pair[1.0]
    rng = np.random.RandomState(6)
    B, T, U = 3, 12, 7
    enc = rng.randn(B, T, 32).astype(np.float32)
    mask = (np.arange(T)[None] < np.asarray([12, 9, 5])[:, None])[:, None]
    pre = rng.randn(B, U, 32).astype(np.float32)
    ys_lens = np.asarray([7, 5, 2])
    ys = np.where(np.arange(U)[None] < ys_lens[:, None],
                  rng.randint(3, VOCAB, (B, U)), -1)
    key = jax.random.PRNGKey(11)
    want = _jax_apply(model, variables,
                      lambda m, *a: m._sampler(*a, key), enc, mask, ys,
                      ys_lens, pre)
    scores = torch.as_tensor(np.asarray(jax.random.uniform(key, (B, U))))
    with torch.no_grad():
        got = port._sampler(*_t(enc, mask, ys, ys_lens, pre), scores)
    _close(got.numpy(), want)
    replaced = np.abs(got.numpy() - pre).max(-1) > 0
    assert replaced.sum() >= 3  # ⌊(len - right) * 0.75⌋ of each row


def test_training_loss_with_sampler_matches_jax(pair, monkeypatch):
    """Training mode: the JAX model with its sampler key, the port with
    the scores that key draws; losses and gradients."""
    import jax
    import jax.numpy as jnp
    from wenet_tpu_torch.models.paraformer.paraformer import Paraformer
    model, variables, port = pair[0.9999]
    batch = _inputs(7)
    jb = [jnp.asarray(a) for a in batch]
    key = jax.random.PRNGKey(5)

    def loss(p):
        return model.apply({**variables, 'params': p}, *jb, train=True,
                           chunk_rng=key,
                           rngs={'dropout': jax.random.PRNGKey(0)})
    want = jax.tree_util.tree_map(np.asarray,
                                  jax.jit(loss)(variables['params']))
    grads = jax.jit(jax.grad(lambda p: loss(p)['loss']))(
        variables['params'])
    U = batch[2].shape[1] + 1
    scores = torch.as_tensor(np.asarray(jax.random.uniform(key, (3, U))))
    monkeypatch.setattr(Paraformer, 'sampler_scores',
                        staticmethod(lambda shape, generator=None: scores))
    port.train()
    try:
        port.zero_grad()
        got = port(*_t(*batch))
        got['loss'].backward()
    finally:
        port.eval()
    for k, w in want.items():
        if w is not None:
            np.testing.assert_allclose(float(got[k]), w, rtol=LOSS_RTOL,
                                       atol=1e-6, err_msg=k)
    _assert_grads(_grads(port), grads)
    assert np.abs(_grads(port)['embed.weight']).max() > 0


def test_forward_paraformer_matches_jax(pair):
    model, variables, port = pair[1.0]
    feats, lens, _, _ = _inputs(8, B=4, T=95)
    want = _jax_apply(model, variables,
                      lambda m, f, l: m.forward_paraformer(f, l), feats,
                      lens)
    with torch.no_grad():
        got = port.forward_paraformer(*_t(feats, lens))
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == np.shape(w), k
        _close(got[k].numpy(), w, msg=k)
    np.testing.assert_array_equal(got['decoder_out_lens'].numpy(),
                                  want['decoder_out_lens'])


def _token_sums(model, variables, feats, lens):
    """The JAX package's unfloored token counts (alphas + tail)."""
    def fn(m, f, l):
        enc, mask = m._forward_encoder_lfr(f, l)
        alphas = m.predictor.predictor.compute_alphas(enc, mask)
        return m.predictor.predictor.tail_process_fn(enc, alphas, mask)[1]
    return _jax_apply(model, variables, fn, feats, lens).sum(-1)


@pytest.mark.parametrize('modes', [
    ['paraformer_greedy_search', 'paraformer_beam_search'],
    ['ctc_greedy_search', 'ctc_prefix_beam_search']])
def test_decode_matches_jax(pair, modes):
    """`AsrRunner.decode`: hypotheses and the greedy search's peak times
    identical, confidences and scores within 2e-4.  Rows whose summed
    alphas lie within 1e-4 of an integer (where float32 noise may move
    ⌊token_num⌋) are not held to equal lengths; they are counted."""
    from wenet_tpu.models.runner import AsrRunner as JaxRunner
    from wenet_tpu_torch.models.runner import AsrRunner
    model, variables, port = pair[1.0]
    feats, lens, _, _ = _inputs(9, B=5, T=130)
    want = JaxRunner(model, variables).decode(modes, feats, lens,
                                              beam_size=4)
    got = AsrRunner(port, 'cpu').decode(modes, feats, lens, beam_size=4)
    sums = _token_sums(model, variables, feats, lens)
    band = np.abs(sums - np.round(sums)) <= 1e-4
    print(f'\nrows within 1e-4 of an integer token count: {band.sum()} of '
          f'{len(band)}')
    for mode in modes:
        assert len(got[mode]) == len(want[mode]) == 5
        for b, (g, w) in enumerate(zip(got[mode], want[mode])):
            if band[b] and mode.startswith('paraformer_'):
                continue
            assert list(g.tokens) == list(w.tokens), (mode, b)
            assert len(g.tokens) > 0
            _close(g.score, w.score, msg=mode)
            _close(g.confidence, w.confidence, msg=mode)
            if mode == 'paraformer_greedy_search':
                assert list(g.times) == list(w.times)
                _close(g.tokens_confidence, w.tokens_confidence)


def test_decode_modes_a_paraformer_does_not_have_raise(pair):
    from wenet_tpu_torch.models.runner import AsrRunner
    feats, lens, _, _ = _inputs(1)
    with pytest.raises(ValueError, match='not paraformer decode modes'):
        AsrRunner(pair[1.0][2], 'cpu').decode(['attention'], feats, lens)


def test_beautify_result_matches_jax():
    from wenet_tpu.models.paraformer.search import (
        paraformer_beautify_result as jax_beautify)
    from wenet_tpu_torch.models.paraformer.search import (
        paraformer_beautify_result)
    for tokens in (['你', '好', 'hel@@', 'lo', 'world', '<s>', '天'],
                   ['</s>', 'para@@', 'for@@', 'mer', '大'], ['<unk>'], []):
        assert paraformer_beautify_result(tokens) == jax_beautify(tokens)


# --- the tokenizer and the converters -------------------------------------
def _write_dicts(d):
    syms = (['<blank>', '<unk>', '<sos/eos>'] + list(CHARS) +
            ['he@@', 'llo', 'wor@@', 'ld', 'para@@', 'for@@', 'mer'])
    (d / 'lang_char.txt').write_text(''.join(
        f'{s} {i}\n' for i, s in enumerate(syms)), encoding='utf-8')
    (d / 'seg_dict').write_text(
        'hello\the@@ llo\nworld\twor@@ ld\nparaformer\tpara@@ for@@ mer\n',
        encoding='utf-8')
    return str(d / 'lang_char.txt'), str(d / 'seg_dict')


def test_tokenizer_matches_jax(tmp_path):
    from wenet_tpu.utils.init_tokenizer import init_tokenizer as jax_init
    from wenet_tpu_torch.utils.init_tokenizer import init_tokenizer
    units, seg = _write_dicts(tmp_path)
    cfg = {'tokenizer': 'paraformer', 'tokenizer_conf': {
        'symbol_table_path': units, 'seg_dict_path': seg}}
    port, want = init_tokenizer(cfg), jax_init(cfg)
    assert type(port).__name__ == type(want).__name__ == 'ParaformerTokenizer'
    for line in ('你好 hello world', '天地 paraformer 人和', 'hello unknown 大',
                 ' 世界 '):
        assert port.tokenize(line) == want.tokenize(line)
        tokens, ids = port.tokenize(line)
        assert port.detokenize(ids) == want.detokenize(ids)
    assert port.vocab_size() == want.vocab_size()


def _funasr_names(state):
    """The port's keys under FunASR's module names (the converter's
    inverse)."""
    out = {}
    for k, v in state.items():
        if k.startswith('predictor.tp_output.'):
            k = k.replace('predictor.tp_output.', 'predictor.cif_output2.')
        elif k.startswith('predictor.predictor.cif'):
            k = k.replace('predictor.predictor.cif', 'predictor.cif')
        elif k.startswith('predictor.tp_'):
            k = k.replace('predictor.tp_', 'predictor.')
        elif k == 'embed.weight':
            k = 'decoder.embed.0.weight'
        out[k] = v
    return out


def test_paraformer_converter_matches_jax(pair, tmp_path):
    """`convert_state_dict` (a FunASR-named state dict loads strictly into
    the port and gives its outputs), `build_config` and
    `convert_funasr_cmvn` (am.mvn text and JSON stats) as the JAX
    package's."""
    from wenet_tpu.models.paraformer import convert as jax_convert
    from wenet_tpu_torch.models.paraformer import convert
    _, _, port = pair[1.0]
    state = port.state_dict()
    funasr = _funasr_names(state)
    assert set(funasr) != set(state)
    got = convert.convert_state_dict(funasr)
    assert got.keys() == jax_convert.convert_state_dict(funasr).keys()
    from wenet_tpu_torch.utils.init_model import init_model
    other = init_model(paraformer_config(), device='cpu')
    other.load_state_dict(got, strict=True)
    feats, lens, _, _ = _inputs(2)
    with torch.no_grad():
        a = other.eval().forward_paraformer(*_t(feats, lens))
        b = port.forward_paraformer(*_t(feats, lens))
    torch.testing.assert_close(a['decoder_out'], b['decoder_out'])
    fconf = {'encoder_conf': {'output_size': 512, 'pos_enc_class': 'x',
                              'selfattention_layer_type': 'y'},
             'decoder_conf': {'num_blocks': 16},
             'predictor_conf': {'upsample_type': 'cnn', 'idim': 512,
                                'use_cif1_cnn': True}}
    args = (fconf, 'units.txt', 'seg_dict', 'global_cmvn', 8404)
    assert convert.build_config(*args) == jax_convert.build_config(*args)
    rng = np.random.RandomState(0)
    neg_mean = rng.randn(560)
    inv_std = rng.uniform(0.5, 2.0, 560)

    def vec(v):
        return '[ ' + ' '.join(f'{x:.6f}' for x in v) + ' ]'
    (tmp_path / 'am.mvn').write_text(
        '<Nnet>\n<Splice> 560 560\n[ 0 ]\n<AddShift> 560 560\n'
        f'<LearnRateCoef> 0 {vec(neg_mean)}\n<Rescale> 560 560\n'
        f'<LearnRateCoef> 0 {vec(inv_std)}\n</Nnet>\n')
    (tmp_path / 'stats.json').write_text(json.dumps(
        {'mean_stat': [1.0, 2.0], 'var_stat': [5.0, 9.0], 'frame_num': 2}))
    for src in ('am.mvn', 'stats.json'):
        convert.convert_funasr_cmvn(str(tmp_path / src),
                                    str(tmp_path / 'port'))
        jax_convert.convert_funasr_cmvn(str(tmp_path / src),
                                        str(tmp_path / 'jax'))
        assert (tmp_path / 'port').read_text() == \
            (tmp_path / 'jax').read_text()


# --- the recipe's entry points ---------------------------------------------
def shrunk_yaml(d):
    """examples/aishell/paraformer/conf/train_paraformer.yaml at 2 + 2
    blocks of 64 (2 heads), its dicts and cmvn the recipe's files, no
    dropout, no random data stage, static batches of four; the sampler
    ratio 0 and the predictor threshold 0.9999 (the packages' random
    draws differ, and the training CIF's last fire sits on the float32
    rounding at 1.0: see the module docstring)."""
    with open(PARAFORMER_YAML, encoding='utf-8') as f:
        cfg = yaml.safe_load(f)
    cfg['encoder_conf'].update(output_size=64, attention_heads=2,
                               linear_units=64, num_blocks=2)
    cfg['decoder_conf'].update(attention_heads=2, linear_units=64,
                               num_blocks=2, att_layer_num=2)
    for conf in (cfg['encoder_conf'], cfg['decoder_conf']):
        for k in conf:
            if k.endswith('dropout_rate'):
                conf[k] = 0.0
    del cfg['cif_predictor_conf']
    cfg['predictor_conf'] = {'threshold': 0.9999, 'dropout': 0.0}
    cfg['model_conf']['sampling_ratio'] = 0.0
    cfg['tokenizer_conf'].update(symbol_table_path=str(d / 'lang_char.txt'),
                                 seg_dict_path=str(d / 'seg_dict'))
    cfg['cmvn_conf']['cmvn_file'] = str(d / 'global_cmvn')
    dc = cfg['dataset_conf']
    dc.update(spec_aug=False, shuffle=False, list_shuffle=False, sort=False,
              batch_conf={'batch_type': 'static', 'batch_size': 4})
    dc['fbank_conf']['dither'] = 0.0
    cfg.update(max_epoch=1, log_interval=1,
               optim_conf={'lr': 0.002, 'eps': 1e-3},
               scheduler_conf={'warmup_steps': 4})
    return cfg


@pytest.fixture(scope='module')
def recipe(tmp_path_factory):
    """Wavs of 1-2.2 s with Chinese / English transcripts and their data
    list, lang_char.txt and seg_dict, a 560-dim cmvn written by the
    converter from an am.mvn, the shrunk yaml, its JAX initial weights as
    init.pt; the JAX trainer started on them in the background."""
    from wenet_tpu.utils.checkpoint import save_torch_checkpoint
    from wenet_tpu_torch.dataset.audio import write_wav
    from wenet_tpu_torch.models.paraformer.convert import (
        convert_funasr_cmvn)
    d = tmp_path_factory.mktemp('paraformer_recipe')
    _write_dicts(d)
    rng = np.random.RandomState(0)
    entries = []
    for i in range(N_UTTS):
        path = d / f'p{i}.wav'
        write_wav(str(path), _speech(rng, 1.0 + 0.17 * i), 16000)
        txt = ''.join(rng.choice(list(CHARS), size=2 + i % 3))
        txt += ' ' + EN_WORDS[i % 3] + ' ' + CHARS[i]
        entries.append({'key': f'p{i}', 'wav': str(path), 'txt': txt})
    (d / 'data.list').write_text(''.join(
        json.dumps(e, ensure_ascii=False) + '\n' for e in entries),
        encoding='utf-8')
    mvn = ['<Nnet>', '<AddShift> 560 560', '<LearnRateCoef> 0 [ ' +
           ' '.join(['-8.0'] * 560) + ' ]', '<Rescale> 560 560',
           '<LearnRateCoef> 0 [ ' + ' '.join(['0.25'] * 560) + ' ]',
           '</Nnet>']
    (d / 'am.mvn').write_text('\n'.join(mvn) + '\n')
    convert_funasr_cmvn(str(d / 'am.mvn'), str(d / 'global_cmvn'))
    cfg = shrunk_yaml(d)
    with open(d / 'train.yaml', 'w', encoding='utf-8') as f:
        yaml.safe_dump(cfg, f, allow_unicode=True)
    n_syms = len((d / 'lang_char.txt').read_text().splitlines())
    _, variables = jax_model(dict(copy.deepcopy(cfg), input_dim=560,
                                  output_dim=n_syms), seed=8)
    save_torch_checkpoint(variables, str(d / 'init.pt'))
    env = dict(_env(), XLA_FLAGS='--xla_force_host_platform_device_count=1',
               WENET_TPU_NO_COMPILE_CACHE='1')
    JAX_TRAINERS['unbroken'] = subprocess.Popen(
        [sys.executable, '-c', _JAX_TRAIN] + _train_args(d, d / 'jax'),
        env=env, cwd=str(d), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    yield d
    for proc in JAX_TRAINERS.values():
        proc.kill()
        proc.communicate()


def _train_args(d, model_dir):
    return ['--config', str(d / 'train.yaml'), '--train_data',
            str(d / 'data.list'), '--cv_data', str(d / 'data.list'),
            '--model_dir', str(model_dir), '--checkpoint',
            str(d / 'init.pt')]


@pytest.fixture(scope='module')
def runs(recipe):
    from wenet_tpu_torch.bin.train import main
    with _captured() as lines:
        main(_train_args(recipe, recipe / 'port') + ['--device', 'cpu'])
    port = _parse('\n'.join(lines))
    log, _ = JAX_TRAINERS['unbroken'].communicate(timeout=900)
    assert JAX_TRAINERS['unbroken'].returncode == 0, log[-3000:]
    return port, _parse(log)


def test_train_matches_jax(recipe, runs):
    """One epoch of `bin/train.py` from the same init.pt: per-step and cv
    losses within rtol 1e-4; the epoch's weights within 1e-6 + 1% of
    each tensor's largest change."""
    from test_torch_train_main import _jax_weights
    port, want = runs
    assert [s[:2] for s in port[0]] == [(0, 1), (0, 2)]
    # the JAX trainer logs loss, grad_norm, lr and accuracy of a step
    _assert_same_losses(port, want, keys=('loss', 'lr'))
    for k in ('loss_decoder', 'loss_quantity', 'loss_quantity_tp'):
        np.testing.assert_allclose(port[1][0][k], want[1][0][k],
                                   rtol=LOSS_RTOL, err_msg=k)
    got = torch.load(recipe / 'port' / 'epoch_0.pt', weights_only=True)
    jax_w = _jax_weights(recipe / 'jax' / 'epoch_0')
    init = torch.load(recipe / 'init.pt', weights_only=True)
    assert set(got) == set(jax_w)
    assert not any(k.startswith('ctc.') for k in got)  # ctc_weight 0
    for k, w in jax_w.items():
        change = (w - init[k]).abs().max().item()
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                   atol=1e-6 + 0.01 * change, err_msg=k)
    with open(recipe / 'port' / 'train.yaml') as f:
        assert yaml.safe_load(f)['input_dim'] == 560


@pytest.mark.parametrize('modes', [['paraformer_greedy_search'],
                                   ['paraformer_greedy_search',
                                    'paraformer_beam_search']])
def test_recognize_matches_jax(recipe, runs, tmp_path, monkeypatch, modes):
    """`bin/recognize.py` on the trained checkpoint: the text files equal
    the JAX package's (its one-mode run takes its pipelined branch)."""
    from wenet_tpu.bin import recognize as jax_recognize
    from wenet_tpu_torch.bin import recognize
    monkeypatch.setenv('WENET_TPU_NO_COMPILE_CACHE', '1')
    monkeypatch.setattr('wenet_tpu.runtime.native_fbank.available',
                        lambda: False)
    argv = ['--config', str(recipe / 'train.yaml'), '--test_data',
            str(recipe / 'data.list'), '--checkpoint',
            str(recipe / 'port' / 'epoch_0.pt'), '--batch_size', '3',
            '--modes', *modes]
    summary = recognize.main(argv + ['--result_dir', str(tmp_path / 'port'),
                                     '--device', 'cpu'])
    assert summary['lines'] == dict.fromkeys(modes, N_UTTS)
    monkeypatch.setattr(sys, 'argv', ['recognize.py'] + argv + [
        '--result_dir', str(tmp_path / 'jax')])
    jax_recognize.main()
    for mode in modes:
        got = (tmp_path / 'port' / mode / 'text').read_text(encoding='utf8')
        want = (tmp_path / 'jax' / mode / 'text').read_text(encoding='utf8')
        assert got == want
        assert sum(bool(line.partition(' ')[2])
                   for line in got.splitlines()) >= N_UTTS // 2


# --- the kernels at head dim 128, on the card -----------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device to run the Hopper kernels')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# the bars of tests/test_torch_flash_attention_train.py (FWD_TOL, TOL):
# fp32 summation order; bf16 inputs rounded, the reference in fp32
FLASH_TOL = {torch.float32: dict(atol=2e-5, rtol=1e-5),
             torch.bfloat16: dict(atol=1e-3, rtol=8e-3)}
TRAIN_TOL = {torch.float32: dict(atol=2e-4, rtol=1e-4),
             torch.bfloat16: dict(atol=5e-2, rtol=2e-2)}


def _sanm_qkv(B, T, lens, dtype, seed):
    """q, k, v as the SAN-M attention hands them: (B, h, T, 128) views of
    one fused (B, T, 3·512) projection, and its key-pad mask."""
    g = torch.Generator(device='cuda').manual_seed(seed)
    qkv = torch.randn(B, T, 3 * 512, device='cuda', generator=g).to(dtype)
    q, k, v = (t.view(B, T, 4, 128).transpose(1, 2)
               for t in qkv.chunk(3, dim=-1))
    mask = (torch.arange(T, device='cuda')[None] <
            torch.as_tensor(lens, device='cuda')[:, None])[:, None, None]
    return q, k, v, mask


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_cuda_k4_at_paraformer_decode_shape(cuda, dtype):
    """K4 at (32, 4, 500, 500, 128) with ragged key lengths (the decode of
    B=32 x 30 s), against its plain version in fp32 on the same inputs."""
    from wenet_tpu_torch.ops import flash_attention as fa
    lens = [500] + list(np.random.RandomState(0).randint(100, 500, 31))
    q, k, v, mask = _sanm_qkv(32, 500, lens, dtype, 0)
    before = fa.LAUNCHES['flash_attention_fwd']
    out = fa.flash_attention(q, k, v, mask, None, 128 ** -0.5)
    want = fa.flash_fwd_reference(q.float(), k.float(), v.float(), mask,
                                  None, 128 ** -0.5)[0]
    assert fa.LAUNCHES['flash_attention_fwd'] == before + 1
    torch.testing.assert_close(out.float(), want, **FLASH_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_cuda_train_kernels_at_paraformer_train_shape(cuda, dtype):
    """K4-train, K5 and K6 through the `FlashAttention` Function at (2, 4,
    534, 534, 128) (a long-form step of B=2 x 32 s), against the plain
    versions chained as the Function chains them, in fp32."""
    from wenet_tpu_torch.ops import flash_attention as fa
    q, k, v, mask = _sanm_qkv(2, 534, [534, 400], dtype, 1)
    do = torch.randn(q.shape, device='cuda').to(dtype)
    x = [t.detach().requires_grad_() for t in (q, k, v)]
    before = dict(fa.LAUNCHES)
    out = fa.flash_attention(*x, mask, None, 128 ** -0.5)
    out.backward(do)
    for name in ('flash_attention_fwd_train', 'flash_attention_bwd_dq',
                 'flash_attention_bwd_dkv'):
        assert fa.LAUNCHES[name] == before[name] + 1, name
    x32 = [t.detach().float() for t in (q, k, v)]
    want, lse = fa.flash_fwd_reference(*x32, mask, None, 128 ** -0.5, True)
    # in bf16 delta is taken from the output in its own type, as the
    # Function (and the JAX package) take it
    delta = (do.float() * want.to(dtype).float()).sum(-1)
    args = (mask, None, do.float(), lse, delta, 128 ** -0.5)
    dq = fa.flash_bwd_dq_reference(*x32, *args)[0]
    dk, dv = fa.flash_bwd_dkv_reference(*x32, *args)
    torch.testing.assert_close(out.float(), want, **FLASH_TOL[dtype])
    for name, g, w in (('dq', x[0].grad, dq), ('dk', x[1].grad, dk),
                       ('dv', x[2].grad, dv)):
        torch.testing.assert_close(g.float(), w, **TRAIN_TOL[dtype],
                                   msg=name)

