"""The zoo's encoder and decoder options of
tests/test_torch_zoo_options.py (its helpers and bar) in a file of their
own, so that the tier-1 command's workers run the two halves side by
side: the rest of the encoder options, `static_chunk_size`, post-norm
encoders and decoders, the `linear`, `embed`, `conv2d2` and
`stack_n_frames` front ends, each against the JAX package within
2e-4."""

import numpy as np
import pytest
import torch

from test_torch_zoo_options import _close, _np, _perturbed
from torch_port_utils import IDIM, feats, jax_model, tiny_config, \
    torch_model


def _enc_pair(encoder='conformer', seed=30, cmvn=True, **over):
    cfg = tiny_config()
    if not cmvn:
        cfg.pop('cmvn')
    if encoder == 'transformer':
        for key in ('cnn_module_kernel', 'use_cnn_module', 'causal',
                    'cnn_module_norm', 'activation_type'):
            cfg['encoder_conf'].pop(key)
        cfg['encoder_conf'].update(pos_enc_layer_type='abs_pos',
                                   selfattention_layer_type='selfattn')
    cfg['encoder'] = encoder
    cfg['encoder_conf'].update(num_blocks=1, **over)
    dec = {k: over[k] for k in ('n_kv_head', 'mlp_type', 'mlp_bias',
                                'layer_norm_type', 'normalize_before')
           if k in over}
    cfg['decoder_conf'].update(num_blocks=1, r_num_blocks=1, **dec)
    if over.get('input_layer') == 'embed':
        model, variables = _jax_on_ids(cfg, seed)
    else:
        model, variables = jax_model(cfg, seed=seed)
    return cfg, model, variables, torch_model(cfg, variables)


def _jax_on_ids(cfg, seed):
    """The JAX model of an `embed` front end, its variables drawn on token
    ids (`init_variables` draws them on features, which an embedding
    refuses), biases and norm scales perturbed."""
    import copy
    import jax
    import jax.numpy as jnp
    from wenet_tpu.utils.init_model import init_model
    model, _ = init_model(None, copy.deepcopy(cfg))
    ids = jnp.zeros((1, 16), jnp.int32)
    variables = model.init(jax.random.PRNGKey(seed), ids,
                           jnp.asarray([16]), jnp.asarray([[3, 4]]),
                           jnp.asarray([2]))
    return model, _perturbed(variables, seed)


def _same_encoder(model, variables, tmodel, x, lens, chunk=0):
    import jax.numpy as jnp
    jeo, jem = model.apply(variables, jnp.asarray(x), jnp.asarray(lens),
                           chunk, -1, method=model.forward_encoder)
    with torch.no_grad():
        teo, tem = tmodel.forward_encoder(torch.from_numpy(x),
                                          torch.from_numpy(lens), chunk, -1)
    np.testing.assert_array_equal(tem.numpy(), np.asarray(jem))
    _close(teo, jeo)
    return teo


ENCODER_OPTIONS = {  # name: (encoder, options)
    'static_chunk': ('conformer', dict(static_chunk_size=4,
                                       use_dynamic_chunk=False)),
    'static_chunk_left': ('transformer', dict(static_chunk_size=3)),
    'post_norm_conformer': ('conformer', dict(normalize_before=False)),
    'post_norm_transformer': ('transformer', dict(normalize_before=False)),
    'rms_norm': ('conformer', dict(layer_norm_type='rms_norm',
                                   cnn_module_norm='rms_norm')),
    'no_final_norm': ('transformer', dict(final_norm=False)),
    'cmvn_mean_only': ('conformer', dict(cmvn_norm_var=False)),
    'no_pos_shaw_conformer': ('conformer', dict(
        pos_enc_layer_type='no_pos',
        selfattention_layer_type='shaw_rel_selfattn')),
    'rope_conformer': ('conformer', dict(
        pos_enc_layer_type='rope_pos',
        selfattention_layer_type='rope_abs_selfattn', n_kv_head=1)),
    'head_dim': ('transformer', dict(attention_heads=4, head_dim=8,
                                     n_kv_head=2)),
    'plain_attention_conformer': ('conformer', dict(
        pos_enc_layer_type='abs_pos', selfattention_layer_type='selfattn',
        query_bias=False, key_bias=False, value_bias=False)),
}


@pytest.mark.parametrize('name', sorted(ENCODER_OPTIONS))
def test_encoder_option_matches_jax(name):
    """The encoder output (and its mask) over a padded batch, at the
    decoding chunk the option reads (static chunks apply at any)."""
    encoder, over = ENCODER_OPTIONS[name]
    _, model, variables, tmodel = _enc_pair(encoder, **over)
    x, lens = feats(18, B=3, T=67)
    _same_encoder(model, variables, tmodel, x, lens)
    if name == 'static_chunk_left':
        # the static chunk with a left-chunk count
        import jax.numpy as jnp
        jeo, _ = model.apply(variables, jnp.asarray(x), jnp.asarray(lens),
                             0, 1, method=model.forward_encoder)
        with torch.no_grad():
            teo, _ = tmodel.forward_encoder(torch.from_numpy(x),
                                            torch.from_numpy(lens), 0, 1)
        _close(teo, jeo)
    if name in ('post_norm_conformer', 'post_norm_transformer',
                'no_final_norm'):
        assert tmodel.encoder.after_norm is None


@pytest.mark.parametrize('name', ['post_norm', 'rms_moe_gqa'])
def test_decoder_options_match_jax(name):
    """The attention decoders' scores of a hypothesis batch (left and
    right), post-norm or RMSNorm + MoE + 2 kv heads of 4."""
    import jax.numpy as jnp
    over = dict(normalize_before=False) if name == 'post_norm' else dict(
        layer_norm_type='rms_norm', mlp_type='moe', n_kv_head=1)
    _, model, variables, tmodel = _enc_pair('conformer', seed=31, **over)
    if name == 'post_norm':
        assert tmodel.decoder.left_decoder.after_norm is None
    mem = _np((1, 9, 64), 19)
    hyps = np.asarray([[2, 5, 6, 7, 2], [2, 9, 4, 2, 2]], np.int64)
    lens = np.asarray([5, 4], np.int64)
    want = model.apply(variables, jnp.asarray(hyps), jnp.asarray(lens),
                       jnp.asarray(mem), 0.3,
                       method=model.forward_attention_decoder)
    with torch.no_grad():
        got = tmodel.forward_attention_decoder(
            torch.from_numpy(hyps), torch.from_numpy(lens),
            torch.from_numpy(mem), 0.3)
    for g, w in zip(got, want):
        _close(g, w)


INPUT_LAYERS = ['linear', 'embed', 'conv2d2', 'stack_n_frames']


@pytest.mark.parametrize('layer', INPUT_LAYERS)
def test_input_layer_matches_jax(layer):
    """A transformer with each front end (stack_n_frames at output_size
    = 2 x the input dim, abs_pos: the width its encoding needs; embed on
    token ids), against the JAX one, with its subsampling rate and right
    context."""
    over = dict(input_layer=layer)
    if layer == 'stack_n_frames':
        over.update(output_size=2 * IDIM, attention_heads=2)
    _, model, variables, tmodel = _enc_pair('transformer', seed=32,
                                            cmvn=layer != 'embed', **over)
    if layer == 'embed':
        rng = np.random.RandomState(20)
        x = rng.randint(0, IDIM, size=(3, 23)).astype(np.int64)
        lens = np.asarray([23, 17, 9], np.int64)
    else:
        x, lens = feats(20, B=3, T=45)
    _same_encoder(model, variables, tmodel, x, lens)
    rate, right = {'linear': (1, 0), 'embed': (1, 0), 'conv2d2': (2, 2),
                   'stack_n_frames': (2, 0)}[layer]
    assert (tmodel.encoder.subsampling_rate,
            tmodel.encoder.right_context) == (rate, right)


@pytest.mark.parametrize('pos', ['abs_pos', 'rel_pos'])
def test_stack_n_frames_width_rule(pos):
    """Positions added to the stacked frames need output_size = 2 x the
    input dim: abs_pos raises a ValueError that says so (the JAX package
    fails there on a broadcast); rel_pos keeps its encoding apart and
    builds at any width, as the JAX one does."""
    from wenet_tpu_torch.utils.init_model import init_model
    cfg = tiny_config()
    cfg['encoder'] = 'transformer'
    cfg['encoder_conf'] = dict(output_size=64, attention_heads=2,
                               linear_units=64, num_blocks=1,
                               input_layer='stack_n_frames',
                               pos_enc_layer_type=pos)
    if pos == 'abs_pos':
        with pytest.raises(ValueError, match='output_size'):
            init_model(cfg, device='meta')
    else:
        init_model(cfg, device='meta')
