"""The encoder and attention zoo's options in the PyTorch port against the
JAX package, module by module at tiny width: RMSNorm (with and without
its unit offset), the MoE FFN (a router tie included), the gated MLP and
FFNs without biases, GQA (2 kv heads of 4) and MQA in plain, rel-pos,
cross and Shaw attention and the decoder's `decode_step`, RoPE (both
styles, at an offset and at a per-row offset vector), Shaw in full and
chunked calls, `no_pos`, the `linear`, `embed`, `conv2d2` and
`stack_n_frames` front ends, `static_chunk_size`, post-norm encoders and
decoders, and the rest of the encoder options (the last four in
tests/test_torch_zoo_options_encoders.py).

The port's modules carry the JAX modules' variables
(`state_dict_from_jax`, strict), biases and norm scales perturbed off
their init, on numpy inputs made from a seed.  Every forward agrees
within 2e-4, the repo's per-layer bar."""

import numpy as np
import pytest
import torch

ATOL = 2e-4
B, T, D, H = 2, 11, 64, 4


def _perturbed(variables, seed):
    """Variables with biases and norm scales moved off zeros and ones."""
    import jax
    rng = np.random.RandomState(seed)

    def perturb(path, leaf):
        leaf = np.asarray(leaf)
        name = path[-1].key
        if name == 'scale':
            return (0.2 * rng.randn(*leaf.shape)).astype(leaf.dtype)
        if 'bias' in name or name.startswith('experts_b'):
            return (leaf + 0.1 * rng.randn(*leaf.shape)).astype(leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(perturb, variables)


def pair(jax_module, port_module, *init_args, seed=0, **init_kw):
    """(JAX variables, the port's module carrying them)."""
    import jax
    from wenet_tpu_torch.utils.checkpoint import state_dict_from_jax
    variables = _perturbed(jax_module.init(jax.random.PRNGKey(seed),
                                           *init_args, **init_kw), seed)
    port_module.load_state_dict(state_dict_from_jax(variables), strict=True)
    return variables, port_module.eval()


def _np(x, seed, dtype=np.float32):
    return np.random.RandomState(seed).randn(*x).astype(dtype)


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


# -- norms and FFNs ---------------------------------------------------------
@pytest.mark.parametrize('offset', [True, False])
def test_rms_norm_matches_jax(offset):
    from wenet_tpu.models.transformer.norm import RMSNorm as JaxRMSNorm
    from wenet_tpu_torch.models.transformer.norm import RMSNorm
    x = _np((B, T, D), 1) * 3.0
    variables, m = pair(JaxRMSNorm(D, 1e-6, offset), RMSNorm(D, 1e-6, offset),
                        x)
    want = JaxRMSNorm(D, 1e-6, offset).apply(variables, x)
    _close(m(torch.from_numpy(x)), want)


MLPS = {  # name: (mlp_type, bias, activation)
    'moe': ('moe', True, 'swish'),
    'moe_no_bias': ('moe', False, 'relu'),
    'gated': ('gated', True, 'gelu'),
    'gated_no_bias': ('gated', False, 'swish'),
    'ffn_no_bias': ('position_wise_feed_forward', False, 'relu'),
}


def _mlps(name, n_expert=4, k=2):
    from wenet_tpu.models.transformer.positionwise_feed_forward import (
        MLP_CLASSES as JAX_MLPS)
    from wenet_tpu_torch.models.transformer.positionwise_feed_forward import (
        make_mlp)
    kind, bias, act = MLPS[name]
    kw = dict(n_expert=n_expert, n_expert_activated=k) if kind == 'moe' \
        else {}
    jm = JAX_MLPS[kind](idim=D, hidden_units=48, activation=act, bias=bias,
                        **kw)
    return jm, make_mlp(kind, D, 48, 0.0, act, bias, n_expert, k)


@pytest.mark.parametrize('name', sorted(MLPS))
def test_mlp_matches_jax(name):
    jm, m = _mlps(name)
    x = _np((B, T, D), 2)
    variables, m = pair(jm, m, x)
    _close(m(torch.from_numpy(x)), jm.apply(variables, x))
    keys = set(m.state_dict())
    if name.startswith('moe'):
        # the JAX package's torch export names, not upstream wenet's
        assert {'gate.weight', 'experts_w1', 'experts_w2'} <= keys
        assert tuple(m.experts_w1.shape) == (4, D, 48)
        assert ('experts_b1' in keys) == MLPS[name][1]


def test_moe_router_tie_breaks_lowest_index_first():
    """Experts 0, 2 and 3 share a router row, so every token's logits tie
    among them: the top 2 are 0 and 2 (jax.lax.top_k's order), and the
    layer equals the JAX one.  `torch.topk` promises no order there."""
    import jax
    from wenet_tpu_torch.models.transformer.positionwise_feed_forward import (
        top_k_lowest_index_first)
    jm, m = _mlps('moe', n_expert=5)
    x = np.abs(_np((B, T, D), 3))
    variables, _ = pair(jm, m, x)
    kernel = np.array(variables['params']['gate']['kernel'])
    kernel[:, [2, 3]] = kernel[:, [0]]
    kernel[:, 1] = kernel[:, 0] - 1.0  # below the tie on positive x
    kernel[:, 4] = kernel[:, 0] - 1.0
    variables['params']['gate']['kernel'] = kernel
    from wenet_tpu_torch.utils.checkpoint import state_dict_from_jax
    m.load_state_dict(state_dict_from_jax(variables), strict=True)
    logits = m.gate(torch.from_numpy(x)).detach()
    _, got = top_k_lowest_index_first(logits, 2)
    _, want = jax.lax.top_k(logits.numpy(), 2)
    assert (got[..., 0] == 0).all() and (got[..., 1] == 2).all()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _close(m(torch.from_numpy(x)), jm.apply(variables, x))


# -- attention --------------------------------------------------------------
KINDS = ['selfattn', 'rel_selfattn', 'shaw_rel_selfattn', 'rope_abs_selfattn']
HEADS = {'mha': None, 'gqa': 2, 'mqa': 1}


def _attention(kind, n_kv_head, bias=True):
    from wenet_tpu.models.transformer.attention import (
        ATTENTION_CLASSES as JAX_ATTENTION)
    from wenet_tpu_torch.models.transformer.attention import (
        make_self_attention)
    kw = dict(query_bias=bias, key_bias=bias, value_bias=bias)
    jm = JAX_ATTENTION[kind](n_head=H, n_feat=D, n_kv_head=n_kv_head, **kw)
    return jm, make_self_attention(kind, H, D, 0.0, None, n_kv_head, **kw)


def _pos_emb(kind, offset, size, batch=1):
    """The pos_emb each attention reads over `size` keys from `offset` (an
    int, or one per row)."""
    from wenet_tpu.models.transformer.embedding import (
        rope_freqs, sinusoidal_position_encoding)
    if kind == 'rope_abs_selfattn':
        return np.asarray(rope_freqs(offset, size, D // H))
    pe = np.asarray(sinusoidal_position_encoding(offset, size, D))
    return np.broadcast_to(pe, (batch,) + pe.shape[1:]) if batch > 1 else pe


@pytest.mark.parametrize('heads', sorted(HEADS))
@pytest.mark.parametrize('kind', KINDS)
def test_self_attention_matches_jax(kind, heads):
    """The full call, over a padded batch, each head count."""
    jm, m = _attention(kind, HEADS[heads])
    x = _np((B, T, D), 4)
    mask = np.ones((B, 1, T), bool)
    mask[1, :, T - 3:] = False
    pos = _pos_emb(kind, 0, T)
    variables, m = pair(jm, m, x, x, x, mask, pos)
    want, _ = jm.apply(variables, x, x, x, mask, pos)
    got, _ = m.forward_self(torch.from_numpy(x), torch.from_numpy(mask),
                            torch.from_numpy(np.ascontiguousarray(pos)))
    _close(got, want)
    if HEADS[heads] is not None:
        assert m.linear_k.out_features == HEADS[heads] * (D // H)


@pytest.mark.parametrize('heads', ['gqa', 'mqa'])
@pytest.mark.parametrize('kind', KINDS)
@pytest.mark.parametrize('offsets', ['int', 'per_row'])
def test_chunk_step_with_cache_matches_jax(kind, heads, offsets):
    """A streaming chunk step: 8 cached keys of h_kv heads, the first 3
    slots invalid, then a chunk of 4 (Shaw's clipped positions over cache
    + chunk; RoPE's angles of the keys' positions, per row or shared)."""
    jm, m = _attention(kind, HEADS[heads])
    h_kv = HEADS[heads]
    cache_t, chunk = 8, 4
    x = _np((B, chunk, D), 5)
    kc, vc = _np((B, h_kv, cache_t, D // H), 6), _np((B, h_kv, cache_t,
                                                      D // H), 7)
    mask = np.ones((B, 1, cache_t + chunk), bool)
    mask[:, :, :3] = False
    offset = np.asarray([12, 20]) if offsets == 'per_row' else 12
    pos = _pos_emb(kind, offset - cache_t, cache_t + chunk, B)
    variables, m = pair(jm, m, x, x, x, mask, pos, (kc, vc))
    want, (wk, wv) = jm.apply(variables, x, x, x, mask, pos, (kc, vc))
    got, (gk, gv) = m.forward_self(
        torch.from_numpy(x), torch.from_numpy(mask),
        torch.from_numpy(np.ascontiguousarray(pos)),
        cache=(torch.from_numpy(kc), torch.from_numpy(vc)))
    _close(got, want)
    assert tuple(gk.shape) == (B, h_kv, cache_t + chunk, D // H)
    _close(gk, wk)
    _close(gv, wv)


@pytest.mark.parametrize('bias', [True, False])
def test_attention_without_qkv_bias(bias):
    """query/key/value_bias false: no bias tensors, the same forward."""
    jm, m = _attention('rel_selfattn', 2, bias)
    x = _np((B, T, D), 8)
    pos = _pos_emb('rel_selfattn', 0, T)
    variables, m = pair(jm, m, x, x, x, None, pos)
    assert ('linear_q.bias' in m.state_dict()) == bias
    want, _ = jm.apply(variables, x, x, x, None, pos)
    got, _ = m.forward_self(torch.from_numpy(x), None, torch.from_numpy(pos))
    _close(got, want)


def test_repeat_kv_reads_kv_head_h_over_n_rep():
    """Query head i reads kv head i // n_rep (jnp.repeat on axis 1):
    with 2 kv heads of 4, heads 0, 1 read kv head 0."""
    import jax.numpy as jnp
    from wenet_tpu.models.transformer.attention import repeat_kv as jrep
    from wenet_tpu_torch.models.transformer.attention import repeat_kv
    x = _np((B, 2, 3, 5), 9)
    got = repeat_kv(torch.from_numpy(x), 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jrep(
        jnp.asarray(x), 2)))
    np.testing.assert_array_equal(got[:, 1].numpy(), x[:, 0])


@pytest.mark.parametrize('heads', ['gqa', 'mqa'])
def test_decode_step_matches_jax(heads):
    """Three decoder steps into (B, h_kv, L_max, d) buffers."""
    import jax.numpy as jnp
    from wenet_tpu.models.transformer.attention import (
        MultiHeadedAttention as JaxMHA)
    from wenet_tpu_torch.models.transformer.attention import (
        MultiHeadedAttention)
    h_kv = HEADS[heads]
    jm = JaxMHA(n_head=H, n_feat=D, n_kv_head=h_kv)
    x = _np((B, 1, D), 10)
    variables, m = pair(jm, MultiHeadedAttention(H, D, n_kv_head=h_kv),
                        x, x, x)
    shape = (B, h_kv, 6, D // H)
    jcache = (jnp.zeros(shape), jnp.zeros(shape))
    tcache = (torch.zeros(shape), torch.zeros(shape))
    for step in range(3):
        x = _np((B, 1, D), 11 + step)
        want, jcache = jm.apply(variables, x, jcache, step,
                                method=jm.decode_step)
        got = m.decode_step(torch.from_numpy(x), tcache, step)
        _close(got, want)
    _close(tcache[0], jcache[0])


@pytest.mark.parametrize('heads', ['gqa', 'mqa'])
def test_cross_attention_beam_folded_matches_jax(heads):
    """Queries of B·N beams against the encoder's (k, v) of B rows and
    h_kv heads, a padded key tail."""
    from wenet_tpu.models.transformer.attention import (
        MultiHeadedCrossAttention as JaxCross)
    from wenet_tpu_torch.models.transformer.attention import (
        MultiHeadedCrossAttention)
    h_kv, N = HEADS[heads], 3
    jm = JaxCross(n_head=H, n_feat=D, n_kv_head=h_kv)
    q = _np((B * N, 2, D), 14)
    mem = _np((B, T, D), 15)
    mask = np.ones((B, 1, T), bool)
    mask[0, :, T - 4:] = False
    variables, m = pair(jm, MultiHeadedCrossAttention(H, D, n_kv_head=h_kv),
                        q[:B], mem, mem, mask)
    kv = jm.apply(variables, mem, mem, method=jm.project_kv)
    want, _ = jm.apply(variables, q, q, q, mask, cache=kv)
    tkv = m.project_kv(torch.from_numpy(mem), torch.from_numpy(mem))
    assert tuple(tkv[0].shape) == (B, h_kv, T, D // H)
    got = m(torch.from_numpy(q), None, None, torch.from_numpy(mask),
            cache=tkv)
    _close(got, want)


@pytest.mark.parametrize('style', ['google', 'llama'])
def test_apply_rotary_emb_matches_jax(style):
    from wenet_tpu.models.transformer.attention import (
        apply_rotary_emb as japply)
    from wenet_tpu.models.transformer.embedding import rope_freqs as jfreqs
    from wenet_tpu_torch.models.transformer.attention import apply_rotary_emb
    from wenet_tpu_torch.models.transformer.embedding import rope_freqs
    x = _np((B, T, H, 16), 16)
    offsets = np.asarray([3, 40])
    ang = rope_freqs(torch.from_numpy(offsets), T, 16)
    _close(ang, jfreqs(offsets, T, 16), 1e-5)
    _close(apply_rotary_emb(torch.from_numpy(x), ang, style),
           japply(x, np.asarray(jfreqs(offsets, T, 16)), style))


@pytest.mark.parametrize('offset', [0, 7, 'per_row'])
@pytest.mark.parametrize('kind', ['rope_pos', 'no_pos'])
def test_position_encodings_match_jax(kind, offset):
    """The encoder's `make_pos_enc`: x scaled by sqrt(d) and RoPE angles
    of head_dim = output_size // heads at an offset (or a vector of
    them), or x as it is and a zero pos_emb."""
    import jax
    from wenet_tpu.models.transformer.encoder import make_pos_enc as jmake
    from wenet_tpu_torch.models.transformer.embedding import make_pos_enc
    jm, m = jmake(kind, D, 0.0, H), make_pos_enc(kind, D, 0.0, H)
    x = _np((B, T, D), 17)
    off = np.asarray([2, 9]) if offset == 'per_row' else offset
    variables = jm.init(jax.random.PRNGKey(0), x)
    wx, wpos = jm.apply(variables, x, off)
    gx, gpos = m(torch.from_numpy(x), torch.from_numpy(off)
                 if isinstance(off, np.ndarray) else off)
    _close(gx, wx)
    _close(gpos, wpos)
    _close(m.position_encoding(torch.from_numpy(np.asarray([off]).ravel())
                               if offset == 'per_row' else off, T),
           jm.position_encoding(off, T))


# -- encoders and decoders --------------------------------------------------
