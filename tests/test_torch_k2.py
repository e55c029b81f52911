"""The k2 model of the PyTorch port against the JAX package's, on the CPU,
at a tiny width (a conformer of 2 blocks of 32, a bidirectional decoder
of 1 + 1, 10 units), from numpy seeds, on one set of weights carried
across with `state_dict_from_jax`: the dense FSA forward score
(`ops/fsa.py`) against the JAX `lax.scan` and a brute-force path sum,
with ragged lengths, an eps chain and an unreachable state; the graphs
(den.txt and HLG.txt byte for byte against the JAX package's
tools/k2/prepare_mmi.py and tools/k2/make_hlg.sh); the LF-MMI loss and
the k2 model's joint loss and gradients; `hlg_onebest` and `hlg_rescore`;
and the recipe's entry points: `bin/train.py` with `model: k2_model`
over a den.txt against the JAX trainer, then `bin/recognize.py` in both
hlg modes (and attention rescoring) against the JAX recognize.

Bars: scores within 1e-5 of the JAX package's (1e-4 of the float64
brute force over float32 log-probs) and their gradients within 1e-5;
graphs identical; losses within rtol 1e-4 and gradients within 1e-5 +
1e-4 of each tensor's largest; hypotheses identical; per-step train
losses within rtol 1e-4 and each weight within 1e-6 + 1% of its largest
change; the text files identical.

The cuda-marked test holds phase 17b's checks of chip_smoke.py on the
card and skips here."""

import copy
import importlib.util
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from test_torch_train_main import (_JAX_TRAIN, _assert_same_losses,
                                   _captured, _env, _parse, _speech)
from test_torch_wfst import write_arpa
from torch_port_utils import jax_model, torch_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEL = 40
SYMS = {'<blank>': 0, '<unk>': 1}
SYMS.update({c: i + 2 for i, c in enumerate('abcdefg')})
SYMS['<sos/eos>'] = 9
VOCAB = len(SYMS)
CHARS = 'abcdefg'
LOSS_RTOL = 1e-4
SCORE_ATOL = 1e-5
N_UTTS = 8  # two static batches of four
JAX_TRAINERS = {}


def k2_config(lfmmi_dir=''):
    """The flagship's layout, narrow and without dropout or dynamic chunk,
    as `model: k2_model`."""
    drop = dict(dropout_rate=0.0, positional_dropout_rate=0.0)
    return {
        'input_dim': MEL, 'output_dim': VOCAB,
        'encoder': 'conformer',
        'encoder_conf': dict(
            output_size=32, attention_heads=2, linear_units=64,
            num_blocks=2, attention_dropout_rate=0.0, input_layer='conv2d',
            pos_enc_layer_type='rel_pos',
            selfattention_layer_type='rel_selfattn', cnn_module_kernel=7,
            cnn_module_norm='layer_norm', activation_type='swish',
            causal=True, use_dynamic_chunk=False, **drop),
        'decoder': 'bitransformer',
        'decoder_conf': dict(attention_heads=2, linear_units=64,
                             num_blocks=1, r_num_blocks=1,
                             self_attention_dropout_rate=0.0,
                             src_attention_dropout_rate=0.0, **drop),
        'tokenizer_conf': {'special_tokens': {'<blank>': 0, '<unk>': 1,
                                              '<sos>': 9, '<eos>': 9}},
        'ctc_conf': {'ctc_blank_id': 0},
        'cmvn': 'global_cmvn',
        'model': 'k2_model',
        'model_conf': {'ctc_weight': 0.5, 'lsm_weight': 0.1,
                       'length_normalized_loss': False,
                       'reverse_weight': 0.3, 'lfmmi_dir': lfmmi_dir}}


def transcripts(rng, n):
    return [''.join(rng.choice(list(CHARS), size=2 + i % 4))
            for i in range(n)]


def unit_seqs(texts):
    return [[SYMS[c] for c in t] for t in texts]


def log_softmax(x):
    return x - np.log(np.exp(x).sum(-1, keepdims=True))


# --- the dense FSA forward score -----------------------------------------
def brute_force_score(fst, logp, T):
    """logsumexp over every accepting path with exactly T emit arcs (eps
    arcs free, acyclic), in float64 (tests/test_k2.py's oracle)."""
    totals = []

    def walk(state, t, w):
        if t == T:
            fc = fst.final_cost(state)
            if fc != float('inf'):
                totals.append(w - fc)
        for arc in fst.state_arcs(state):
            if arc.ilabel == 0:
                walk(arc.nextstate, t, w - arc.weight)
            elif t < T:
                walk(arc.nextstate, t + 1,
                     w - arc.weight + float(logp[t, arc.ilabel - 1]))

    walk(fst.start, 0, 0.0)
    m = max(totals)
    return m + math.log(sum(math.exp(x - m) for x in totals))


def eps_chain_fst(lm_fst):
    """A TextFst with an eps chain of depth 3 (start -> 1 -> 2 -> 3, each
    with emit arcs), a final state, and state 9 that no path reaches but
    whose arcs lead into the graph."""
    from wenet_tpu_torch.lm.fst import Arc
    fst = lm_fst()
    arcs = {0: [Arc(0, 0, 0.3, 1), Arc(2, 0, 0.1, 0), Arc(3, 0, 0.7, 2)],
            1: [Arc(0, 0, 0.2, 2), Arc(1, 0, 0.4, 1), Arc(2, 0, 0.9, 3)],
            2: [Arc(0, 0, 0.5, 3), Arc(3, 0, 0.2, 2), Arc(1, 0, 1.1, 0)],
            3: [Arc(1, 0, 0.6, 3), Arc(2, 0, 0.3, 0)],
            9: [Arc(1, 0, 0.1, 3), Arc(2, 0, 0.2, 0)]}
    fst.arcs = arcs
    fst.finals = {3: 0.25, 0: 1.5}
    fst.start = 0
    return fst


def _graphs():
    """{name: (port TextFst, JAX TextFst)} of the den graph and the eps
    chain."""
    from wenet_tpu.lm.build_graph import build_den_graph as jax_den
    from wenet_tpu.lm.fst import TextFst as JaxFst
    from wenet_tpu_torch.lm.build_graph import build_den_graph
    from wenet_tpu_torch.lm.fst import TextFst
    seqs = [[1, 2, 1], [2, 1], [1, 1, 2], [3, 2]]
    return {'den': (build_den_graph(seqs, 3), jax_den(seqs, 3)),
            'eps_chain': (eps_chain_fst(TextFst), eps_chain_fst(JaxFst))}


@pytest.mark.parametrize('graph', ['den', 'eps_chain'])
def test_fsa_forward_score_matches_jax_and_brute_force(graph):
    """Rows of 5, 3 (shorter than T) and 1 frames in one batch: each score
    within 1e-5 of the JAX package's vmapped scan and within 1e-4 of the
    brute-force path sum; the gradients with respect to the log-probs
    within 1e-5 of JAX's and finite, a state no path reaches included
    (the eps chain's state 9)."""
    import jax
    import jax.numpy as jnp
    from wenet_tpu.ops.fsa import fsa_forward_score as jax_score
    from wenet_tpu.ops.fsa import fst_to_dense_arcs as jax_arcs
    from wenet_tpu_torch.ops.fsa import fsa_forward_score, fst_to_dense_arcs
    fst, jfst = _graphs()[graph]
    fsa = fst_to_dense_arcs(fst)
    jfsa = jax_arcs(jfst)
    assert fsa.eps_depth == jfsa.eps_depth == (3 if graph == 'eps_chain'
                                                else 1)
    rng = np.random.RandomState(0)
    T, V = 5, 4
    logp = log_softmax(rng.randn(3, T, V)).astype(np.float32)
    lens = np.asarray([5, 3, 1], np.int32)

    def jax_scores(x):
        return jax.vmap(jax_score, in_axes=(0, 0, None))(
            x, jnp.asarray(lens), jfsa)

    want = np.asarray(jax.jit(jax_scores)(jnp.asarray(logp)))
    want_grad = np.asarray(jax.jit(jax.grad(
        lambda x: jnp.sum(jax_scores(x) * jnp.asarray([1.0, 0.5, 2.0]))))(
            jnp.asarray(logp)))
    x = torch.from_numpy(logp).requires_grad_()
    got = fsa_forward_score(x, torch.from_numpy(lens), fsa)
    (got * torch.tensor([1.0, 0.5, 2.0])).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=SCORE_ATOL)
    for b in range(3):
        assert abs(got[b].item() - brute_force_score(
            fst, logp[b], int(lens[b]))) < 1e-4
    assert torch.isfinite(x.grad).all()
    np.testing.assert_allclose(x.grad.numpy(), want_grad, rtol=0,
                               atol=SCORE_ATOL)
    assert (x.grad[1, 3:] == 0).all() and (x.grad[2, 1:] == 0).all()


def test_eps_cycle_raises():
    from wenet_tpu_torch.lm.fst import Arc, TextFst
    from wenet_tpu_torch.ops.fsa import fst_to_dense_arcs
    fst = TextFst()
    fst.arcs = {0: [Arc(0, 0, 0.1, 1)], 1: [Arc(0, 0, 0.1, 0)]}
    fst.finals = {1: 0.0}
    with pytest.raises(ValueError, match='epsilon cycle'):
        fst_to_dense_arcs(fst)


# --- the graphs against the JAX package's tools --------------------------
def write_lang(d, rng, n_words=30, n_sentences=60):
    """units.txt, a lexicon of `n_words` words of 1-3 chars and a 3-gram
    ARPA over seeded sentences of them."""
    (d / 'units.txt').write_text(''.join(f'{k} {v}\n'
                                         for k, v in SYMS.items()))
    words = set()
    while len(words) < n_words:
        words.add(''.join(rng.choice(list(CHARS), rng.randint(1, 4))))
    words = sorted(words)
    (d / 'lexicon.txt').write_text(''.join(f'{w} {" ".join(w)}\n'
                                           for w in words))
    write_arpa(d / 'lm.arpa', [[words[i] for i in rng.randint(
        0, n_words, rng.randint(1, 6))] for _ in range(n_sentences)])


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, 'tools', 'k2', f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_den_and_hlg_files_equal_the_jax_tools(tmp_path):
    """den.txt from the port's build_den_graph equals what
    tools/k2/prepare_mmi.py writes from the same transcripts; HLG.txt,
    words.txt and tokens.txt from tools/k2/make_hlg.sh equal the port's
    build_hlg output (its TLG.txt), byte for byte, and load in the port."""
    from wenet_tpu_torch.lm.build_graph import build_den_graph, build_hlg
    from wenet_tpu_torch.lm.fst import TextFst
    from wenet_tpu_torch.ops.fsa import fst_to_dense_arcs
    rng = np.random.RandomState(1)
    write_lang(tmp_path, rng)
    texts = transcripts(rng, 20)
    (tmp_path / 'text').write_text(''.join(f'u{i} {t}\n' for i, t in
                                           enumerate(texts)) + 'empty\n')
    _tool('prepare_mmi').main(str(tmp_path / 'units.txt'),
                              str(tmp_path / 'text'), str(tmp_path / 'jax'))
    build_den_graph(unit_seqs(texts), max(SYMS.values()),
                    outdir=str(tmp_path / 'port'))
    want = (tmp_path / 'jax' / 'den.txt').read_bytes()
    assert (tmp_path / 'port' / 'den.txt').read_bytes() == want
    assert fst_to_dense_arcs(TextFst.read(str(tmp_path / 'jax' /
                                              'den.txt'))).num_states > 1
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS='cpu')
    subprocess.run(['bash', os.path.join(REPO, 'tools/k2/make_hlg.sh'),
                    str(tmp_path), str(tmp_path / 'lm.arpa'),
                    str(tmp_path / 'jax_hlg')], check=True, env=env,
                   capture_output=True)
    build_hlg(str(tmp_path / 'units.txt'), str(tmp_path / 'lexicon.txt'),
              str(tmp_path / 'lm.arpa'), str(tmp_path / 'port_hlg'))
    assert (tmp_path / 'port_hlg' / 'TLG.txt').read_bytes() == (
        tmp_path / 'jax_hlg' / 'HLG.txt').read_bytes()
    for name in ('words.txt', 'tokens.txt'):
        assert (tmp_path / 'port_hlg' / name).read_bytes() == (
            tmp_path / 'jax_hlg' / name).read_bytes()


# --- the loss ---------------------------------------------------------------
@pytest.fixture(scope='module')
def lfmmi_dir(tmp_path_factory):
    from wenet_tpu_torch.lm.build_graph import build_den_graph
    d = tmp_path_factory.mktemp('lfmmi')
    build_den_graph(unit_seqs(transcripts(np.random.RandomState(2), 30)),
                    VOCAB - 1, outdir=str(d))
    return str(d)


@pytest.fixture(scope='module')
def pair(lfmmi_dir):
    cfg = k2_config(lfmmi_dir)
    model, variables = jax_model(cfg, seed=4)
    return cfg, model, variables, torch_model(cfg, variables)


def _batch(seed, B=3, T=80, L=6, zero_row=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, MEL).astype(np.float32)
    lens = np.asarray([T] + list(rng.randint(T // 2, T, size=B - 1)),
                      np.int32)
    if zero_row:
        lens[-1] = 0
    tl = np.asarray([L] + list(rng.randint(1, L, size=B - 1)), np.int32)
    tgt = rng.randint(2, 9, (B, L))
    return x, lens, np.where(np.arange(L)[None] < tl[:, None], tgt, -1), tl


def _jax_loss(model, variables, batch):
    import jax
    import jax.numpy as jnp

    def loss_fn(params):
        out = model.apply(dict(variables, params=params),
                          *map(jnp.asarray, batch))
        return out['loss'], out

    (_, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables['params'])
    return out, grads


@pytest.mark.parametrize('zero_row', [False, True])
def test_k2_loss_and_gradients_match_jax(pair, zero_row):
    """The joint loss (LF-MMI as loss_ctc, the attention loss beside it)
    within rtol 1e-4 of the JAX K2Model's, a zero-length row left out;
    every parameter's gradient within 1e-5 + 1e-4 of its largest."""
    from wenet_tpu_torch.utils.checkpoint import state_dict_from_jax
    cfg, model, variables, tmodel = pair
    batch = _batch(3, zero_row=zero_row)
    out, grads = _jax_loss(model, variables, batch)
    tmodel.zero_grad(set_to_none=True)
    got = tmodel(*map(torch.from_numpy, batch))
    for k in ('loss', 'loss_ctc', 'loss_att', 'th_accuracy'):
        np.testing.assert_allclose(got[k].item(), float(out[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    got['loss'].backward()
    params = dict(tmodel.named_parameters())
    for k, w in state_dict_from_jax({'params': grads}).items():
        g = params[k].grad
        assert g is not None and torch.isfinite(g).all(), k
        np.testing.assert_allclose(
            g.numpy(), w.numpy(), rtol=0,
            atol=1e-5 + 1e-4 * w.abs().max().item(), err_msg=k)


def test_lfmmi_terms_match_jax(pair):
    """The LF-MMI loss alone (num - den_scale x den over the den graph)
    against the JAX `_calc_lfmmi_loss` on the same encoder output, at
    den_scale 0.7."""
    import jax
    import jax.numpy as jnp
    cfg, model, variables, tmodel = pair
    x, lens, tgt, tl = _batch(5)
    enc, mask = jax.jit(lambda v, x, n: model.apply(
        v, x, n, method=model.forward_encoder))(
            variables, jnp.asarray(x), jnp.asarray(lens))
    enc_lens = jnp.sum(mask[:, 0, :], -1)
    jmodel = model.clone(den_scale=0.7)
    want, _ = jax.jit(lambda v, *a: jmodel.apply(
        v, *a, method=jmodel._calc_lfmmi_loss))(
            variables, enc, enc_lens, jnp.asarray(tgt), jnp.asarray(tl))
    tmodel.den_scale = 0.7
    try:
        with torch.no_grad():
            got = tmodel.lfmmi_loss(
                torch.from_numpy(np.asarray(enc)),
                torch.from_numpy(np.asarray(enc_lens)),
                torch.from_numpy(tgt), torch.from_numpy(tl),
                torch.ones(len(lens), dtype=torch.bool))
    finally:
        tmodel.den_scale = 1.0
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)


def test_k2_without_lfmmi_dir_is_asr_model(pair):
    """With no lfmmi_dir the k2 model's loss dict is ASRModel's, as the
    JAX package's is."""
    from wenet_tpu_torch.models.transformer.asr_model import ASRModel
    cfg, model, variables, _ = pair
    plain_cfg = k2_config('')
    tmodel = torch_model(plain_cfg, variables)
    batch = [torch.from_numpy(a) for a in _batch(6)]
    got = tmodel(*batch)
    want = ASRModel.forward(tmodel, *batch)
    for k in ('loss', 'loss_ctc', 'loss_att'):
        assert got[k].item() == want[k].item(), k
    import jax
    import jax.numpy as jnp
    from wenet_tpu.utils.init_model import init_model as jax_init_model
    jax_plain, _ = jax_init_model(None, copy.deepcopy(plain_cfg))
    jout = jax.jit(jax_plain.apply)(variables, *[jnp.asarray(b.numpy())
                                                 for b in batch])
    np.testing.assert_allclose(got['loss'].item(), float(jout['loss']),
                               rtol=LOSS_RTOL)


# --- HLG decoding ---------------------------------------------------------
def sharpen_ctc(variables, scale=4.0):
    """Scale the CTC head so that random posteriors are peaked, and the
    searches keep few paths (chip_smoke's shape_ctc_head does the same)."""
    import jax
    v = jax.tree_util.tree_map(np.asarray, variables)
    ctc = dict(v['params']['ctc']['ctc_lo'])
    ctc['kernel'] = ctc['kernel'] * scale
    ctc['bias'] = ctc['bias'] + np.eye(1, VOCAB, 0)[0] * 3.0
    v['params'] = dict(v['params'], ctc=dict(ctc_lo=ctc))
    return v


@pytest.fixture(scope='module')
def lang(tmp_path_factory):
    from wenet_tpu_torch.lm.build_graph import build_hlg
    d = tmp_path_factory.mktemp('hlg')
    write_lang(d, np.random.RandomState(7), n_words=15, n_sentences=30)
    build_hlg(str(d / 'units.txt'), str(d / 'lexicon.txt'),
              str(d / 'lm.arpa'), str(d))
    os.rename(d / 'TLG.txt', d / 'HLG.txt')
    return d


def test_hlg_decodes_match_jax(pair, lang):
    """hlg_onebest and hlg_rescore (lm, decoder and right-decoder scales
    0.7, 0.1, 0.7) give the JAX package's hypotheses on the same weights
    and HLG."""
    import jax.numpy as jnp
    from wenet_tpu.models.k2 import model as jax_k2
    from wenet_tpu_torch.models.k2 import model as k2
    cfg, model, variables, _ = pair
    variables = sharpen_ctc(variables)
    tmodel = torch_model(cfg, variables)
    x, lens, _, _ = _batch(8, B=2, T=100)
    hlg, word = str(lang / 'HLG.txt'), str(lang / 'words.txt')
    scales = dict(lm_scale=0.7, decoder_scale=0.1, r_decoder_scale=0.7)
    want1 = jax_k2.hlg_onebest(model, variables, jnp.asarray(x),
                               jnp.asarray(lens), hlg=hlg, word=word,
                               symbol_table=SYMS)
    want2 = jax_k2.hlg_rescore(model, variables, jnp.asarray(x),
                               jnp.asarray(lens), hlg=hlg, word=word,
                               symbol_table=SYMS, **scales)
    tx, tl = torch.from_numpy(x), torch.from_numpy(lens)
    assert k2.hlg_onebest(tmodel, tx, tl, hlg, word, SYMS) == want1
    assert k2.hlg_rescore(tmodel, tx, tl, hlg, word, SYMS,
                          **scales) == want2
    assert sum(map(len, want1)) > 0


# --- the recipe's entry points --------------------------------------------
@pytest.fixture(scope='module')
def recipe(tmp_path_factory):
    """Wavs with transcripts and their data list, units.txt, a cmvn file,
    den.txt from the transcripts, the HLG, train.yaml (model: k2_model)
    and the JAX initial weights as init.pt; the JAX trainer started on
    them in the background (one CPU device)."""
    from wenet_tpu.utils.checkpoint import save_torch_checkpoint
    from wenet_tpu_torch.dataset.audio import write_wav
    from wenet_tpu_torch.lm.build_graph import build_den_graph, build_hlg
    d = tmp_path_factory.mktemp('k2_recipe')
    rng = np.random.RandomState(0)
    write_lang(d, rng, n_words=15, n_sentences=30)
    texts = transcripts(rng, N_UTTS)
    entries = []
    for i, txt in enumerate(texts):
        path = d / f'k{i}.wav'
        write_wav(str(path), _speech(rng, 0.8 + 0.1 * i), 16000)
        entries.append({'key': f'k{i}', 'wav': str(path), 'txt': txt})
    (d / 'data.list').write_text(''.join(json.dumps(e) + '\n'
                                         for e in entries))
    build_den_graph(unit_seqs(texts), VOCAB - 1, outdir=str(d / 'lfmmi'))
    build_hlg(str(d / 'units.txt'), str(d / 'lexicon.txt'),
              str(d / 'lm.arpa'), str(d / 'hlg'))
    os.rename(d / 'hlg' / 'TLG.txt', d / 'hlg' / 'HLG.txt')
    (d / 'global_cmvn').write_text(json.dumps({
        'mean_stat': [3.0] * MEL, 'var_stat': [40.0] * MEL,
        'frame_num': 2}))
    cfg = k2_config(str(d / 'lfmmi'))
    del cfg['input_dim'], cfg['output_dim']
    cfg.update({
        'tokenizer': 'char',
        'tokenizer_conf': dict(cfg['tokenizer_conf'],
                               symbol_table_path=str(d / 'units.txt'),
                               non_lang_syms_path=None,
                               split_with_space=False),
        'cmvn_conf': {'cmvn_file': str(d / 'global_cmvn'),
                      'is_json_cmvn': True},
        'dataset_conf': {
            'filter_conf': {'max_length': 4000, 'min_length': 0,
                            'token_min_length': 1},
            'fbank_conf': {'num_mel_bins': MEL, 'dither': 0.0},
            'batch_conf': {'batch_type': 'static', 'batch_size': 4},
            'pad_conf': {'pad_to_multiple': 64},
            'shuffle': False, 'list_shuffle': False, 'sort': False,
            'spec_aug': False},
        'grad_clip': 5.0, 'accum_grad': 1, 'max_epoch': 1,
        'log_interval': 1, 'optim': 'adam',
        'optim_conf': {'lr': 0.002, 'eps': 1e-3},
        'scheduler': 'warmuplr', 'scheduler_conf': {'warmup_steps': 4}})
    with open(d / 'train.yaml', 'w') as f:
        yaml.safe_dump(cfg, f)
    _, variables = jax_model(dict(copy.deepcopy(cfg), input_dim=MEL,
                                  output_dim=VOCAB), seed=9)
    save_torch_checkpoint(sharpen_ctc(variables), str(d / 'init.pt'))
    env = dict(_env(), XLA_FLAGS='--xla_force_host_platform_device_count=1',
               WENET_TPU_NO_COMPILE_CACHE='1')
    JAX_TRAINERS['k2'] = subprocess.Popen(
        [sys.executable, '-c', _JAX_TRAIN] + _train_args(d, d / 'jax'),
        env=env, cwd=str(d), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    yield d
    for proc in JAX_TRAINERS.values():
        proc.kill()
        proc.communicate()


@pytest.fixture(autouse=True)
def start_jax_trainer(request):
    """Start the JAX trainer at the file's first test, so that it trains
    while the others run (not for the card's tests: no JAX there)."""
    if not request.node.get_closest_marker('cuda'):
        request.getfixturevalue('recipe')


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
    log, _ = JAX_TRAINERS['k2'].communicate(timeout=900)
    assert JAX_TRAINERS['k2'].returncode == 0, log[-3000:]
    return _parse('\n'.join(lines)), _parse(log)


def test_train_matches_jax_trainer(recipe, runs):
    """One epoch of two steps from the same init.pt over den.txt: per-step
    losses (LF-MMI as loss_ctc) and the cv losses within rtol 1e-4 of the
    JAX trainer's; the epoch's weights within 1e-6 + 1% of each tensor's
    largest change."""
    from test_torch_train_main import _jax_weights
    port, want = runs
    assert [s[:2] for s in port[0]] == [(0, 1), (0, 2)]
    _assert_same_losses(port, want)
    got = torch.load(recipe / 'port' / 'epoch_0.pt', weights_only=True)
    jax_w = _jax_weights(recipe / 'jax' / 'epoch_0')
    init = torch.load(recipe / 'init.pt', weights_only=True)
    assert set(got) == set(jax_w)
    for k, w in jax_w.items():
        if k.endswith('num_batches_tracked'):
            continue
        change = (w - init[k]).abs().max().item()
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                   atol=1e-6 + 0.01 * change, err_msg=k)


def test_recognize_hlg_matches_jax(recipe, runs, tmp_path, monkeypatch):
    """bin/recognize.py in hlg_onebest, hlg_rescore and attention_rescoring
    on the trained checkpoint: each text file equals the JAX recognize's,
    and the hlg modes write as many lines as utterances."""
    from wenet_tpu.bin import recognize as jax_recognize
    from wenet_tpu_torch.bin import recognize
    monkeypatch.setenv('WENET_TPU_NO_COMPILE_CACHE', '1')
    modes = ['hlg_onebest', 'hlg_rescore', 'attention_rescoring']
    argv = ['--config', str(recipe / 'train.yaml'), '--test_data',
            str(recipe / 'data.list'), '--checkpoint',
            str(recipe / 'port' / 'epoch_0.pt'), '--batch_size', '8',
            '--beam_size', '4', '--hlg', str(recipe / 'hlg' / 'HLG.txt'),
            '--word', str(recipe / 'hlg' / 'words.txt'), '--lm_scale',
            '0.7', '--decoder_scale', '0.1', '--r_decoder_scale', '0.7',
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
        assert got == want, mode


# --- phase 17b's checks on the card ---------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device to run the Hopper kernels')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.cuda
def test_cuda_den_score_matches_cpu_and_float64(cuda, tmp_path):
    """The den score of the flagship's vocabulary (4233 units, a den graph
    from 200 seeded transcripts) at B=2 x 120 frames: card, CPU and
    float64 within rtol 1e-5, gradients finite."""
    sys.path.insert(0, REPO)
    import chip_smoke as c
    fsa, graph = c.build_den(str(tmp_path), n_texts=200)
    assert graph['eps_depth'] >= 1
    rng = np.random.RandomState(0)
    logp = torch.log_softmax(torch.from_numpy(
        3 * rng.randn(2, 120, 4233).astype(np.float32)), -1)
    readings = c.den_scores(fsa, logp, torch.tensor([120, 77]))
    assert readings['card_cpu_rtol'] <= 1e-5
    assert readings['card_f64_rtol'] <= 1e-5
