"""SenseVoice-small and FireRed in the PyTorch port against the JAX
package's, on the CPU, at a tiny width (2 blocks of 32, 2 heads; one tp
block, one decoder block), from numpy seeds, on one set of weights
carried across with `state_dict_from_jax`: FireRed's relative position
encoding and legacy shift, its encoder, loss dict and gradients, and its
attention beam search; SenseVoice's encoder behind its context tokens,
loss dict and gradients, and CTC greedy search; both converters.

Bars: encoder outputs within 2e-4 (the torch-import bar); losses within
rtol 1e-4 and gradients within 1e-5 + 1e-4 of each tensor's largest;
hypotheses identical and scores within 2e-4."""

import copy

import numpy as np
import pytest
import torch

from torch_port_utils import jax_model, torch_model

MEL = 40
TOL = 2e-4
LOSS_RTOL = 1e-4
FIRERED_VOCAB = 40
SENSEVOICE_VOCAB = 60


def firered_config():
    return {
        'input_dim': MEL, 'output_dim': FIRERED_VOCAB,
        'encoder': 'firered_conformer',
        'encoder_conf': {'output_size': 32, 'attention_heads': 2,
                         'linear_units': 64, 'num_blocks': 2,
                         'cnn_module_kernel': 7, 'dropout_rate': 0.0,
                         'positional_dropout_rate': 0.0,
                         'attention_dropout_rate': 0.0},
        'decoder': 'transformer',
        'decoder_conf': {'attention_heads': 2, 'linear_units': 64,
                         'num_blocks': 1, 'dropout_rate': 0.0,
                         'positional_dropout_rate': 0.0,
                         'self_attention_dropout_rate': 0.0,
                         'src_attention_dropout_rate': 0.0},
        'model': 'firered',
        'model_conf': {'ctc_weight': 0.3, 'lsm_weight': 0.1},
        'cmvn': 'global_cmvn',
        'tokenizer_conf': {'special_tokens': {'sos': FIRERED_VOCAB - 2,
                                              'eos': FIRERED_VOCAB - 1}},
    }


def sensevoice_config():
    return {
        'input_dim': MEL * 7, 'output_dim': SENSEVOICE_VOCAB,
        'lfr_conf': {'lfr_m': 7, 'lfr_n': 6},
        'encoder': 'sanm_encoder_with_tp',
        'encoder_conf': {'output_size': 32, 'attention_heads': 2,
                         'linear_units': 64, 'num_blocks': 2,
                         'tp_blocks': 1, 'kernel_size': 7,
                         'dropout_rate': 0.0, 'attention_dropout_rate': 0.0,
                         'input_layer': 'paraformer_dummy',
                         'pos_enc_layer_type': 'abs_pos_paraformer'},
        'decoder': None,
        'model': 'sensevoice_small',
        'model_conf': {'ctc_weight': 1.0, 'lsm_weight': 0.1,
                       'length_normalized_loss': False},
        'cmvn': 'global_cmvn',
        'ctc_conf': {'ctc_blank_id': 0},
        'tokenizer_conf': {'special_tokens': {'<blank>': 0, '<unk>': 0,
                                              '<s>': 1, '</s>': 2}},
    }


@pytest.fixture(scope='module')
def firered():
    cfg = firered_config()
    model, variables = jax_model(cfg, seed=5)
    return model, variables, torch_model(cfg, variables)


@pytest.fixture(scope='module')
def sensevoice():
    cfg = sensevoice_config()
    model, variables = jax_model(cfg, seed=6)
    return model, variables, torch_model(cfg, variables)


def _feats(seed, B, T):
    rng = np.random.RandomState(seed)
    feats = rng.randn(B, T, MEL).astype(np.float32)
    lens = np.asarray([T] + list(rng.randint(T // 2, T, size=B - 1)))
    return feats, lens


def _firered_batch(seed=0):
    feats, lens = _feats(seed, 3, 64)
    rng = np.random.RandomState(seed + 1)
    tl = np.asarray([5, 3, 4])
    tgt = rng.randint(1, FIRERED_VOCAB - 2, (3, 5))
    return feats, lens, np.where(np.arange(5)[None] < tl[:, None], tgt,
                                 -1), tl


def _sensevoice_batch(seed=0):
    """target = [lid, event, emo, itn, text...] (the JAX tests' layout)."""
    feats, lens = _feats(seed, 3, 62)
    rng = np.random.RandomState(seed + 1)
    text = rng.randint(16, SENSEVOICE_VOCAB - 2, (3, 6))
    ctx = np.asarray([[3, 1, 2, 15], [4, 1, 2, 14], [0, 1, 2, 15]])
    tl = np.asarray([10, 8, 6])
    tgt = np.concatenate([ctx, text], axis=1)
    return feats, lens, np.where(np.arange(10)[None] < tl[:, None], tgt,
                                 -1), tl


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _close(got, want, tol=TOL, msg=''):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=tol,
                               rtol=0, err_msg=msg)


def _jit_apply(model, variables, *args, method=None):
    import jax
    import jax.numpy as jnp
    out = jax.jit(lambda v, *a: model.apply(v, *a, method=method))(
        variables, *[jnp.asarray(a) for a in args])
    return jax.tree_util.tree_map(np.asarray, out)


def _assert_loss_and_grads(model, variables, port, batch):
    """Every loss of the dict and every parameter's gradient (eval mode,
    as the JAX package's train=False)."""
    import jax
    import jax.numpy as jnp
    from wenet_tpu_torch.utils.checkpoint import state_dict_from_jax
    jb = [jnp.asarray(a) for a in batch]
    want = _jit_apply(model, variables, *batch)
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
    want_g = state_dict_from_jax({'params': grads})
    got_g = {n: (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
             for n, p in port.named_parameters()}
    assert set(got_g) == set(want_g)
    for n, g in got_g.items():
        w = want_g[n].numpy()
        _close(g, w, 1e-5 + 1e-4 * np.abs(w).max(), msg=n)


# --- FireRed ---------------------------------------------------------------
@pytest.mark.parametrize('T', [1, 5, 16])
def test_firered_rel_pos_emb_and_shift_match_jax(T):
    import jax.numpy as jnp
    from wenet_tpu.models.firered import model as jax_firered
    from wenet_tpu_torch.models.firered.model import (firered_rel_pos_emb,
                                                      firered_rel_shift)
    np.testing.assert_allclose(firered_rel_pos_emb(T, 32).numpy(),
                               np.asarray(jax_firered.firered_rel_pos_emb(
                                   T, 32)), atol=1e-6)
    x = np.random.RandomState(T).randn(2, 3, T, 2 * T - 1).astype(np.float32)
    np.testing.assert_array_equal(
        firered_rel_shift(torch.as_tensor(x)).numpy(),
        np.asarray(jax_firered.firered_rel_shift(jnp.asarray(x))))


def test_firered_encoder_matches_jax(firered):
    """The subsampling (right context padded), the rel-pos encoding and
    the conformer blocks with the q/k/v-normed attention."""
    model, variables, port = firered
    feats, lens = _feats(2, 3, 71)
    want, want_mask = _jit_apply(model, variables, feats, lens,
                                 method=model.forward_encoder)
    with torch.no_grad():
        got, mask = port.forward_encoder(*_t(feats, lens))
    np.testing.assert_array_equal(mask.numpy(), want_mask)
    _close(got.numpy(), want)


def test_firered_loss_and_gradients_match_jax(firered):
    _assert_loss_and_grads(*firered, _firered_batch(3))


@pytest.mark.parametrize('modes', [['attention'],
                                   ['ctc_greedy_search',
                                    'attention_rescoring']])
def test_firered_decode_matches_jax(firered, modes):
    """`AsrRunner.decode`: the attention beam search (the model's default
    mode, sos and eos its own special tokens), CTC and rescoring."""
    from wenet_tpu.models.runner import AsrRunner as JaxRunner
    from wenet_tpu_torch.models.runner import AsrRunner
    model, variables, port = firered
    feats, lens = _feats(4, 3, 64)
    want = JaxRunner(model, variables).decode(modes, feats, lens,
                                              beam_size=3, ctc_weight=0.3)
    got = AsrRunner(port, 'cpu').decode(modes, feats, lens, beam_size=3,
                                        ctc_weight=0.3)
    for mode in modes:
        for g, w in zip(got[mode], want[mode]):
            assert list(g.tokens) == list(w.tokens), mode
            _close(g.score, w.score, msg=mode)
    assert port.default_decode_method == 'attention'


def test_firered_converter_matches_jax(firered):
    """FireRed's names -> the reference keys, as the JAX package's
    converter maps them; every mapped key is one of the port model's."""
    from wenet_tpu.models.firered.convert import (
        convert_state_dict as jax_convert)
    from wenet_tpu_torch.models.firered.convert import convert_state_dict
    names = ['encoder.input_preprocessor.conv.0.weight',
             'encoder.input_preprocessor.out.weight',
             'encoder.layer_stack.1.mhsa.w_qs.weight',
             'encoder.layer_stack.1.mhsa.fc.bias',
             'encoder.layer_stack.1.mhsa.pos_bias_u',
             'encoder.layer_stack.1.mhsa.linear_pos.weight',
             'encoder.layer_stack.1.mhsa.layer_norm_q.weight',
             'encoder.layer_stack.1.ffn1.net.0.weight',
             'encoder.layer_stack.1.ffn1.net.1.weight',
             'encoder.layer_stack.1.ffn2.net.4.bias',
             'encoder.layer_stack.1.ffn2.net.0.bias',
             'encoder.layer_stack.1.conv.pre_layer_norm.weight',
             'encoder.layer_stack.1.conv.depthwise_conv.weight',
             'encoder.layer_stack.1.conv.batch_norm.running_var',
             'encoder.layer_stack.1.layer_norm.weight',
             'decoder.token_embedding.weight',
             'decoder.layer_stack.0.self_attn.w_ks.weight',
             'decoder.layer_stack.0.cross_attn.w_vs.bias',
             'decoder.layer_stack.0.self_attn_norm.weight',
             'decoder.layer_stack.0.cross_attn_norm.bias',
             'decoder.layer_stack.0.mlp_norm.weight',
             'decoder.layer_stack.0.mlp.w_1.weight']
    sd = {n: i for i, n in enumerate(names)}
    got = convert_state_dict(sd)
    assert got == jax_convert(sd)
    own = set(firered[2].state_dict())
    assert set(got) <= own, set(got) - own


# --- SenseVoice ------------------------------------------------------------
def test_sensevoice_encoder_matches_jax(sensevoice):
    """LFR, the model's cmvn, the four context embeddings (lid zh, itn
    withitn), the SAN-M and tp blocks."""
    model, variables, port = sensevoice
    feats, lens = _feats(7, 3, 62)

    def enc(m, f, l):
        return m.forward_encoder(f, l, lid='zh', itn='withitn')
    want, want_mask = _jit_apply(model, variables, feats, lens, method=enc)
    with torch.no_grad():
        got, mask = port.forward_encoder(*_t(feats, lens), lid='zh',
                                         itn='withitn')
    np.testing.assert_array_equal(mask.numpy(), want_mask)
    _close(got.numpy(), want)


def test_sensevoice_loss_and_gradients_match_jax(sensevoice):
    _assert_loss_and_grads(*sensevoice, _sensevoice_batch(8))


def test_sensevoice_ctc_greedy_matches_jax(sensevoice):
    from wenet_tpu.models.runner import AsrRunner as JaxRunner
    from wenet_tpu_torch.models.runner import AsrRunner
    model, variables, port = sensevoice
    feats, lens = _feats(9, 4, 80)
    want = JaxRunner(model, variables).decode(['ctc_greedy_search'], feats,
                                              lens)['ctc_greedy_search']
    got = AsrRunner(port, 'cpu').decode(['ctc_greedy_search'], feats,
                                        lens)['ctc_greedy_search']
    assert [list(r.tokens) for r in got] == [list(r.tokens) for r in want]
    assert any(len(r.tokens) > 0 for r in got)
    assert port.default_decode_method == 'ctc_greedy_search'


def test_sensevoice_converter_matches_jax(sensevoice):
    """`build_config` as the JAX package's, and the pass-through state
    dict (step counts dropped) loads strictly into the port."""
    from wenet_tpu.models.sensevoice import convert as jax_convert
    from wenet_tpu_torch.models.sensevoice import convert
    fconf = {'encoder_conf': {'output_size': 512, 'pos_enc_class': 'x',
                              'selfattention_layer_type': 'y',
                              'tp_blocks': 20}}
    assert convert.build_config(copy.deepcopy(fconf), 'bpe.model') == \
        jax_convert.build_config(copy.deepcopy(fconf), 'bpe.model')
    state = dict(sensevoice[2].state_dict(),
                 **{'encoder.bn.num_batches_tracked': torch.tensor(3)})
    got = convert.convert_state_dict(state)
    assert got.keys() == jax_convert.convert_state_dict(state).keys()
    sensevoice[2].load_state_dict(got, strict=True)
