"""The options of the JAX encoders and decoders that the PyTorch port
refused until now, against the JAX package at tiny width: the conformer
without its macaron FFN (with relu), without its conv module, with
bias-free convs four times as wide inside; the decoders post-norm
without cross attention, without an output layer, and with the `no_pos`
input layer; Branchformer with `static_chunk_size`, RMSNorm, no q/k/v or
MLP biases and `cmvn_norm_var: false`, and post-norm; E-Branchformer
with gated bias-free FFNs and no final norm; Squeezeformer pre-norm with
static chunks; the efficient conformer post-norm with static chunks, and
without positions or conv modules in its plain layers (with relu).

Same weights (`state_dict_from_jax`, and the reference layout the JAX
package writes, loaded strict), same numpy inputs, every dropout 0.
Bars: encoder output and CTC log-probs within 2e-4 (the torch-import
bar); the losses within rtol 1e-4 and every gradient within 12c's bar
(1e-3 + 2e-4 of the tensor's largest); hypotheses of attention
of every decode mode identical; streaming equal to
the full forward under the chunk mask within 1e-4 where the encoder
streams so, else to the JAX package's chunk loop within 2e-4; the
exported programs equal eager within 1e-5."""

import copy

import numpy as np
import pytest
import torch

from torch_port_utils import (IDIM, TINY_CONFIG, VOCAB, feats, jax_model,
                              torch_model, zoo_config)

ATOL = 2e-4
FULL_ATOL = 1e-4
GRAD_SHARE = 2e-4  # 12c's bar: 1e-3 + this share of the largest gradient
# name: (ZOO_ENCODERS entry or None for the tiny conformer, encoder_conf
# and decoder_conf overrides, how it streams: 'full' equal to the full
# forward under the chunk mask, 'jax' equal to the JAX chunk loop, None
# for a decoder option, whose encoder is the tiny conformer)
FAMILIES = {
    'conformer_no_macaron_relu': (
        None, dict(macaron_style=False, activation_type='relu'), {}, 'full'),
    'conformer_no_cnn_module': (None, dict(use_cnn_module=False), {},
                                'full'),
    'conformer_conv_bias_inner': (
        None, dict(conv_bias=False, conv_inner_factor=4,
                   cnn_module_norm='batch_norm'), {}, 'full'),
    'decoder_post_norm_no_src': (
        None, {}, dict(normalize_before=False, src_attention=False), None),
    'decoder_no_output_layer': (None, {}, dict(use_output_layer=False),
                                None),
    'branchformer_base_options': (
        'branchformer_concat', dict(causal=True, static_chunk_size=4,
                                    layer_norm_type='rms_norm',
                                    cmvn_norm_var=False, query_bias=False,
                                    key_bias=False, mlp_bias=False), {},
        'full'),
    'branchformer_post_norm': (
        'branchformer_fixed_ave', dict(causal=True, use_dynamic_chunk=True,
                                       normalize_before=False), {}, 'full'),
    'e_branchformer_gated_mlp': (
        'e_branchformer', dict(mlp_type='gated', mlp_bias=False,
                               final_norm=False, causal=True,
                               use_dynamic_chunk=True, merge_conv_kernel=1),
        {}, 'full'),
    'squeezeformer_pre_norm_static': (
        'squeezeformer', dict(normalize_before=True, static_chunk_size=4,
                              cmvn_norm_var=False, causal=True,
                              cnn_norm_type='batch_norm'), {}, 'jax'),
    'efficient_post_norm_static': (
        'efficient_conformer', dict(normalize_before=False,
                                    static_chunk_size=4,
                                    use_dynamic_chunk=False), {}, 'jax'),
    # relu also in the grouped layers' conv modules
    'efficient_no_pos_no_cnn': (
        'efficient_conformer', dict(pos_enc_layer_type='no_pos',
                                    use_cnn_module=False,
                                    activation_type='relu'), {}, 'jax'),
}
_MODELS = {}


def family_config(name):
    entry, enc, dec, _ = FAMILIES[name]
    cfg = copy.deepcopy(TINY_CONFIG) if entry is None else zoo_config(entry)
    cfg['encoder_conf'].update(enc)
    cfg['decoder_conf'].update(dec)
    for conf in (cfg['encoder_conf'], cfg['decoder_conf']):
        for k in conf:
            if k.endswith('dropout_rate') or k == 'dropout':
                conf[k] = 0.0
    return cfg


def models(name):
    if name not in _MODELS:
        cfg = family_config(name)
        model, variables = jax_model(cfg, seed=len(_MODELS) + 90)
        _MODELS[name] = (cfg, model, variables, torch_model(cfg, variables))
    return _MODELS[name]


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


def batch(seed, B=3, T=71):
    x, lens = feats(seed, B, T)
    rng = np.random.RandomState(seed + 100)
    tl = rng.randint(2, 8, size=B)
    tgt = np.full((B, 7), -1, np.int64)
    for i, n in enumerate(tl):
        tgt[i, :n] = rng.randint(3, VOCAB, size=n)
    return x, lens, tgt, tl


@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_modules_match_jax(name):
    """The encoder and the CTC head within 2e-4 of the JAX package's; the
    layers have what the JAX layers have (the strict load)."""
    import jax.numpy as jnp
    _, model, variables, tmodel = models(name)
    x, lens, _, _ = batch(1)
    jeo, jem = model.apply(variables, jnp.asarray(x), jnp.asarray(lens),
                           method=model.forward_encoder)
    jlogp = model.apply(variables, jeo, method=model.ctc_logprobs)
    with torch.no_grad():
        teo, tem = tmodel.forward_encoder(torch.from_numpy(x),
                                          torch.from_numpy(lens))
        tlogp = tmodel.ctc_logprobs(teo)
    np.testing.assert_array_equal(tem.numpy(), np.asarray(jem))
    _close(teo, jeo)
    _close(tlogp, jlogp)


@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_loss_and_grads_match_jax(name):
    import jax
    import jax.numpy as jnp
    from wenet_tpu_torch.utils.checkpoint import state_dict_from_jax
    cfg, model, variables, _ = models(name)
    tmodel = torch_model(cfg, variables).train()
    x, lens, tgt, tl = batch(2)

    def loss_fn(params):
        out = model.apply({**variables, 'params': params},
                          *(jnp.asarray(a) for a in (x, lens, tgt, tl)),
                          train=True, rngs={'dropout': jax.random.PRNGKey(0)},
                          mutable=['batch_stats'])[0]
        return out['loss'], out

    (_, want), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables['params'])
    got = tmodel(*(torch.from_numpy(np.asarray(a)) for a in (x, lens, tgt,
                                                              tl)))
    got['loss'].backward()
    for k in ('loss', 'loss_att', 'loss_ctc'):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4,
                                   err_msg=k)
    want_grads = state_dict_from_jax({'params': grads})
    assert set(want_grads) == {n for n, _ in tmodel.named_parameters()}
    for pname, p in tmodel.named_parameters():
        w = want_grads[pname].numpy()
        np.testing.assert_allclose(
            p.grad.numpy(), w, rtol=0, err_msg=pname,
            atol=1e-3 + GRAD_SHARE * float(np.abs(w).max()))


DECODERS = ['decoder_no_output_layer', 'decoder_post_norm_no_src']
MODES = ['ctc_greedy_search', 'ctc_prefix_beam_search',
         'attention_rescoring', 'attention']


@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_decode_matches_jax(name):
    """Every decode mode (for the decoder families: attention rescoring
    and the attention beam search, the incremental step, with the
    beam-folded cross attention where there is one) gives the JAX
    package's hypotheses.  Without an output layer the decoder's log-probs
    are over its D = 64 hidden units, not the 30 tokens, so the beam
    search picks ids past the vocabulary, which the JAX package's
    embedding clamps and the port's refuses (IndexError): there the
    attention beam search is not held."""
    from wenet_tpu.models.runner import AsrRunner as JaxRunner
    from wenet_tpu_torch.models.runner import AsrRunner
    cfg, model, variables, tmodel = models(name)
    x, lens, _, _ = batch(3, B=4, T=91)
    modes = [m for m in MODES
             if not (name == 'decoder_no_output_layer' and m == 'attention')]
    kw = dict(beam_size=3, ctc_weight=0.3,
              reverse_weight=cfg['model_conf']['reverse_weight'])
    want = JaxRunner(model, variables).decode(modes, x, lens, **kw)
    got = AsrRunner(tmodel, 'cpu').decode(modes, x, lens, **kw)
    for mode in modes:
        assert [r.tokens for r in got[mode]] == \
            [r.tokens for r in want[mode]], mode


def test_no_pos_decoder_matches_jax():
    """The `no_pos` decoder takes (B, L, D) embeddings, as the JAX one
    does: its forward and two incremental steps on the same float inputs
    within 2e-4; token ids raise, as they fail in the JAX package's
    model."""
    import jax
    import jax.numpy as jnp
    from wenet_tpu.models.transformer.decoder import (
        TransformerDecoder as JaxDecoder)
    from wenet_tpu_torch.models.transformer.decoder import TransformerDecoder
    from wenet_tpu_torch.utils.checkpoint import state_dict_from_jax
    from wenet_tpu_torch.utils.init_model import init_model
    conf = dict(attention_heads=2, linear_units=128, num_blocks=2,
                dropout_rate=0.0, positional_dropout_rate=0.0,
                input_layer='no_pos')
    rng = np.random.RandomState(6)
    mem = rng.randn(2, 9, 64).astype(np.float32)
    mem_mask = np.arange(9)[None, None, :] < np.asarray([9, 6])[:, None,
                                                                None]
    tgt = rng.randn(2, 5, 64).astype(np.float32)
    lens = np.asarray([5, 3])
    jd = JaxDecoder(vocab_size=VOCAB, encoder_output_size=64, **conf)
    variables = jd.init(jax.random.PRNGKey(3), jnp.asarray(mem),
                        jnp.asarray(mem_mask), jnp.asarray(tgt),
                        jnp.asarray(lens))
    td = TransformerDecoder(VOCAB, 64, **conf).eval()
    td.load_state_dict(state_dict_from_jax(variables), strict=True)
    want = jd.apply(variables, jnp.asarray(mem), jnp.asarray(mem_mask),
                    jnp.asarray(tgt), jnp.asarray(lens))[0]
    with torch.no_grad():
        got, _ = td(torch.from_numpy(mem), torch.from_numpy(mem_mask),
                    torch.from_numpy(tgt), torch.from_numpy(lens))
    _close(got, want)
    jstate = jd.apply(variables, jnp.asarray(mem), 4,
                      method=jd.init_state)
    with torch.no_grad():
        tstate = td.init_state(torch.from_numpy(mem), 4)
        for step in range(2):
            tok = tgt[:, step:step + 1]
            jlogp, jstate = jd.apply(variables, jnp.asarray(tok), step,
                                     jstate, jnp.asarray(mem_mask),
                                     method=jd.forward_step)
            tlogp, tstate = td.forward_step(torch.from_numpy(tok), step,
                                            tstate,
                                            torch.from_numpy(mem_mask))
            _close(tlogp, jlogp)
    cfg = copy.deepcopy(TINY_CONFIG)
    cfg['decoder_conf']['input_layer'] = 'no_pos'
    with pytest.raises(ValueError, match='decoder.py:129'):
        tmodel = init_model(cfg, device='cpu')
        x, xl, t, tl = batch(4)
        tmodel(*(torch.from_numpy(np.asarray(a)) for a in (x, xl, t, tl)))
    with pytest.raises(ValueError):  # the JAX model fails on the ids too
        jax_model(cfg)


@pytest.mark.parametrize('name', sorted(n for n, f in FAMILIES.items()
                                         if f[3] is not None))
def test_streaming(name):
    """Chunk 4 over a padded tail: the chunk loop equals the full forward
    under the chunk mask (1e-4), or where the encoder does not stream so
    (Squeezeformer's time reduction, the efficient conformer's strides)
    the JAX package's chunk loop (2e-4)."""
    import jax.numpy as jnp
    from wenet_tpu.models.transformer.streaming import (
        StreamingConfig as JaxConfig, forward_chunk_by_chunk as jax_fcc)
    from wenet_tpu_torch.models.transformer.streaming import (
        StreamingConfig, forward_chunk_by_chunk)
    _, model, variables, tmodel = models(name)
    how = FAMILIES[name][3]
    frames = 143
    x = np.random.RandomState(5).randn(1, frames, IDIM).astype(np.float32)
    with torch.inference_mode():
        ty, _ = forward_chunk_by_chunk(tmodel, torch.from_numpy(x),
                                       StreamingConfig(4, -1))
        if how == 'full':
            want, _ = tmodel.forward_encoder(torch.from_numpy(x),
                                             torch.tensor([frames]), 4, -1)
            assert ty.shape == want.shape
            _close(ty, want.numpy(), FULL_ATOL)
            return
    jy, _ = jax_fcc(model, variables, jnp.asarray(x), JaxConfig(4, -1))
    assert tuple(ty.shape) == jy.shape
    _close(ty, jy)


EXPORTED = ['conformer_no_cnn_module', 'conformer_conv_bias_inner',
            'decoder_no_output_layer', 'decoder_post_norm_no_src',
            'efficient_post_norm_static']


@pytest.mark.parametrize('name', EXPORTED)
def test_export_equals_eager(name):
    """bin/export_model's programs (the chunk step, the full encoder, the
    rescoring decoder) equal eager within 1e-5; a decoder option's
    encoder is the tiny conformer, whose programs
    tests/test_torch_export.py holds, so only its decoder is exported."""
    from wenet_tpu_torch.bin import export_model as E
    from wenet_tpu_torch.models.transformer.streaming import StreamingConfig
    _, _, _, tmodel = models(name)
    enc = tmodel.encoder
    outs, wants = [], []
    if name not in DECODERS:
        cfg = StreamingConfig(4, 2, enc.subsampling_rate, enc.right_context)
        prog, args = E.export_encoder_chunk(tmodel, cfg, IDIM, device='cpu')
        args = list(args)
        args[1] = torch.tensor([6])
        args[2] = torch.randn(args[2].shape, generator=torch.Generator()
                              .manual_seed(1))
        x, lens = (torch.from_numpy(a) for a in feats(9, B=3, T=4 * 20 + 7))
        full, _ = E.export_encoder_full(tmodel, IDIM, device='cpu')
        outs += [prog.module()(*args), full.module()(x, lens)]
        with torch.no_grad():
            wants += [E._ChunkStep(tmodel)(*args),
                      E._FullEncoder(tmodel)(x, lens)]
    dec = E.export_decoder(tmodel, 3, 8, enc.output_size(), 0.3, 'cpu')
    hyps = torch.tensor([[2, 5, 6, 2, 2, 2, 2, 2]] * 3)
    dec_args = (hyps, torch.tensor([3, 4, 1]), torch.randn(1, 13, 64))
    outs.append(dec.module()(*dec_args))
    with torch.no_grad():
        wants.append(E._Rescore(tmodel, 0.3)(*dec_args))
    for got, want in zip(outs, wants):
        for g, w in zip(got, want):
            if w is not None:
                torch.testing.assert_close(g, w, atol=1e-5, rtol=0)


@pytest.mark.parametrize('name', ['conformer_conv_bias_inner',
                                  'conformer_no_macaron_relu',
                                  'decoder_no_output_layer',
                                  'branchformer_post_norm',
                                  'efficient_no_pos_no_cnn'])
def test_jax_torch_checkpoint_loads_strict(tmp_path, name):
    """The reference-layout .pt that the JAX package writes
    (`save_torch_checkpoint`) loads strict into the port's model and gives
    its outputs: no key missing or extra without the macaron FFN, the
    conv bias, the output layer or the after_norm."""
    from wenet_tpu.utils.checkpoint import save_torch_checkpoint
    from wenet_tpu_torch.utils.checkpoint import load_checkpoint
    from wenet_tpu_torch.utils.init_model import init_model
    cfg, _, variables, tmodel = models(name)
    path = str(tmp_path / 'final.pt')
    save_torch_checkpoint(variables, path)
    loaded = init_model(copy.deepcopy(cfg), device='cpu')
    load_checkpoint(loaded, path)
    loaded.eval()
    x, lens, _, _ = batch(5)
    with torch.no_grad():
        got = loaded.forward_encoder(torch.from_numpy(x),
                                     torch.from_numpy(lens))[0]
        want = tmodel.forward_encoder(torch.from_numpy(x),
                                      torch.from_numpy(lens))[0]
    torch.testing.assert_close(got, want, atol=0, rtol=0)


# --- on the card ---------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device to run the Hopper kernels')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['conformer_no_cnn_module',
                                  'conformer_conv_bias_inner',
                                  'branchformer_base_options',
                                  'efficient_post_norm_static'])
def test_cuda_step_matches_cpu(cuda, name):
    """A train step on the card (K1-train, K2, K3 once per rel-pos block)
    against the CPU: the loss within rtol 1e-4, every gradient within
    12c's bar."""
    from wenet_tpu_torch.ops.flash_attention import LAUNCHES
    from wenet_tpu_torch.utils.init_model import init_model
    cfg = family_config(name)
    cpu = init_model(cfg, torch.Generator().manual_seed(0), device='cpu')
    card = copy.deepcopy(cpu).cuda()
    x, lens, tgt, tl = (torch.from_numpy(np.asarray(a)) for a in batch(7))
    want = cpu.train()(x, lens, tgt, tl)
    want['loss'].backward()
    before = LAUNCHES['relpos_attention_bwd_dq']
    got = card.train()(*(a.cuda() for a in (x, lens, tgt, tl)))
    got['loss'].backward()
    torch.cuda.synchronize()
    assert LAUNCHES['relpos_attention_bwd_dq'] > before
    np.testing.assert_allclose(got['loss'].item(), want['loss'].item(),
                               rtol=1e-4)
    cpu_grads = dict(cpu.named_parameters())
    for pname, p in card.named_parameters():
        w = cpu_grads[pname].grad
        np.testing.assert_allclose(
            p.grad.cpu().numpy(), w.numpy(), rtol=0, err_msg=pname,
            atol=1e-3 + GRAD_SHARE * float(w.abs().max()))
