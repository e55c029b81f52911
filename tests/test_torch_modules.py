"""Module parity of the PyTorch port against the JAX package at a tiny
width (d=64, 2 heads, 2 blocks, FFN 128, causal conv kernel 8, vocab 30),
and the weight conversion.

Both packages hold the same weights (JAX init with perturbed norms and
cmvn, converted with `state_dict_from_jax`) and get the same numpy
inputs; every module output agrees within the repo's torch-import bar of
2e-4.  The port runs on the CPU, so rel-pos attention takes the plain
version of its kernel."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_utils import (feats, jax_model, tiny_config, torch_model,
                             zoo_config)

ATOL = 2e-4


@pytest.fixture(scope='module', params=['layer_norm', 'batch_norm'])
def pair(request):
    cfg = tiny_config(cnn_module_norm=request.param)
    model, variables = jax_model(cfg, seed=3)
    return (model.bind(variables), variables,
            torch_model(cfg, variables), request.param)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL)


def _hidden(seed, B=3, T=17, D=64):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, D).astype(np.float32)
    lens = np.asarray([T, T - 5, T - 9])
    pad = np.arange(T)[None, :] < lens[:, None]
    chunk = np.arange(T)[None, :] < (np.arange(T)[:, None] // 4 + 1) * 4
    return x, pad[:, None, :], pad[:, None, :] & chunk[None]


def test_state_dict_matches_jax_export(pair):
    """state_dict_from_jax == convert_to_torch_state_dict, key for key
    and value for value (plus BatchNorm's step counters), and loads
    strictly (torch_model loads it with strict=True)."""
    from wenet_tpu.utils.checkpoint import convert_to_torch_state_dict
    from wenet_tpu_torch.utils.checkpoint import state_dict_from_jax
    _, variables, tmodel, norm = pair
    got = state_dict_from_jax(variables)
    want = convert_to_torch_state_dict(variables)
    extra = set(got) - set(want)
    assert all(k.endswith('.num_batches_tracked') for k in extra)
    assert bool(extra) == (norm == 'batch_norm')
    assert set(want) <= set(got)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert set(got) == set(tmodel.state_dict())


def test_subsampling(pair):
    jm, _, tm, _ = pair
    x, lens = feats(seed=1)
    mask = np.arange(x.shape[1])[None, None, :] < lens[:, None, None]
    jx, jpos, jmask = jm.encoder.embed(jnp.asarray(x), jnp.asarray(mask))
    tx, tpos, tmask = tm.encoder.embed(torch.from_numpy(x),
                                       torch.from_numpy(mask))
    _close(tx, jx)
    _close(tpos, jpos)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))


@pytest.mark.parametrize('mask_kind', ['pad', 'chunk'])
def test_relpos_attention(pair, mask_kind):
    from wenet_tpu_torch.models.transformer.embedding import (
        sinusoidal_position_encoding)
    jm, _, tm, _ = pair
    x, pad, chunk = _hidden(2)
    mask = pad if mask_kind == 'pad' else chunk
    pos = sinusoidal_position_encoding(x.shape[1], x.shape[2])
    jx, _ = jm.encoder.encoders[1].self_attn(
        jnp.asarray(x), jnp.asarray(x), jnp.asarray(x), jnp.asarray(mask),
        jnp.asarray(pos.numpy()))
    t = torch.from_numpy(x)
    tx, _ = tm.encoder.encoders[1].self_attn(t, t, t,
                                             torch.from_numpy(mask), pos)
    _close(tx, jx)


def test_conv_module(pair):
    jm, _, tm, _ = pair
    x, pad, _ = _hidden(3)
    jx, _ = jm.encoder.encoders[0].conv_module(jnp.asarray(x),
                                               jnp.asarray(pad))
    tx, _ = tm.encoder.encoders[0].conv_module(torch.from_numpy(x),
                                               torch.from_numpy(pad))
    _close(tx, jx)


def test_conformer_layer(pair):
    from wenet_tpu_torch.models.transformer.embedding import (
        sinusoidal_position_encoding)
    jm, _, tm, _ = pair
    x, pad, chunk = _hidden(4)
    pos = sinusoidal_position_encoding(x.shape[1], x.shape[2])
    jx = jm.encoder.encoders[0](jnp.asarray(x), jnp.asarray(chunk),
                                jnp.asarray(pos.numpy()), jnp.asarray(pad))[0]
    tx = tm.encoder.encoders[0](torch.from_numpy(x), torch.from_numpy(chunk),
                                pos, torch.from_numpy(pad))[0]
    _close(tx, jx)


@pytest.mark.parametrize('chunk', [-1, 4])
def test_encoder_and_ctc(pair, chunk):
    jm, _, tm, _ = pair
    x, lens = feats(seed=5)
    jeo, jem = jm.forward_encoder(jnp.asarray(x), jnp.asarray(lens), chunk)
    teo, tem = tm.forward_encoder(torch.from_numpy(x),
                                  torch.from_numpy(lens), chunk)
    _close(teo, jeo)
    np.testing.assert_array_equal(tem.numpy(), np.asarray(jem))
    _close(tm.ctc_logprobs(teo, 0.5, 0), jm.ctc_logprobs(jeo, 0.5, 0))
    np.testing.assert_array_equal(tm.ctc_argmax(teo, 0.5, 0).numpy(),
                                  np.asarray(jm.ctc_argmax(jeo, 0.5, 0)))
    tvals, tids = tm.ctc_topk(teo, 4, 0.5, 0)
    jvals, jids = jm.ctc_topk(jeo, 4, 0.5, 0)
    _close(tvals, jvals)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))


def test_decoder(pair):
    jm, _, tm, _ = pair
    rng = np.random.RandomState(6)
    n, L, T = 4, 6, 11
    memory = rng.randn(n, T, 64).astype(np.float32)
    mem_mask = (np.arange(T)[None, :] < np.asarray([11, 9, 7, 5])[:, None])
    hyps = rng.randint(3, 30, size=(n, L))
    hyps[:, 0] = 2  # <sos>
    hyps_lens = np.asarray([6, 4, 3, 1])
    jl, jr = jm.forward_attention_decoder(
        jnp.asarray(hyps), jnp.asarray(hyps_lens), jnp.asarray(memory), 0.3,
        jnp.asarray(mem_mask[:, None, :]))
    tl, tr = tm.forward_attention_decoder(
        torch.from_numpy(hyps), torch.from_numpy(hyps_lens),
        torch.from_numpy(memory), 0.3, torch.from_numpy(mem_mask[:, None, :]))
    _close(tl, jl)
    _close(tr, jr)


def test_cross_attention_beam_expansion(pair):
    """(B*N) queries against B keys equal the queries against keys
    repeated N times."""
    _, _, tm, _ = pair
    attn = tm.decoder.left_decoder.decoders[0].src_attn
    rng = np.random.RandomState(7)
    q = torch.from_numpy(rng.randn(6, 5, 64).astype(np.float32))
    mem = torch.from_numpy(rng.randn(2, 9, 64).astype(np.float32))
    mask = torch.from_numpy(np.arange(9)[None, None, :] <
                            np.asarray([9, 6])[:, None, None])
    got = attn(q, mem, mem, mask)
    want = attn(q, mem.repeat_interleave(3, 0), mem.repeat_interleave(3, 0),
                mask.repeat_interleave(3, 0))
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize('zoo,section,key,value,why', [
    # the conformer's options under a transformer, which takes none of them
    # (the case's id as before the conformer's own options were ported)
    pytest.param(None, None, 'encoder', 'transformer', 'not ported',
                 id='None-encoder-transformer'),
    # what the JAX encoders have no field for, or never read
    ('squeezeformer', 'encoder_conf', 'time_reduction_layer_type', 'stream',
     'squeezeformer/encoder.py:247'),
    ('squeezeformer', 'encoder_conf', 'final_norm', False,
     'squeezeformer/encoder.py:361-390'),
    ('efficient_conformer', 'encoder_conf', 'layer_norm_type', 'rms_norm',
     'efficient_conformer/encoder.py:284-312'),
    ('e_branchformer', 'encoder_conf', 'stochastic_depth_rate', 0.1,
     'e_branchformer/encoder.py:40'),
])
def test_init_model_rejects_unported_options(zoo, section, key, value, why):
    from wenet_tpu_torch.utils.init_model import init_model
    cfg = tiny_config() if zoo is None else zoo_config(zoo)
    (cfg if section is None else cfg[section])[key] = value
    with pytest.raises(NotImplementedError, match=why):
        init_model(cfg, device='cpu')
